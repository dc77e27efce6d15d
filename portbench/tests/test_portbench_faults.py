"""``correct`` comes out false with the control or a fault under the window,
and true with the program, on tiny cells on the CPU: the whole run is
driven, only the look for a card is skipped (``device="cpu"``).  On the
card, ``portbench/calibrate.py`` reads the same stand-ins at each cell's
own size."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from portbench import cellspec, checks, loops, run
from portbench.tests.tiny import make_root


@pytest.fixture(autouse=True)
def no_jax_check(monkeypatch):
    """The test process may hold JAX from the repository's other tests."""
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("tiny"))


def correct(root, cell, stand_in, seed):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                       "0.2"], root=root, device="cpu", stand_in=stand_in)
    assert rc == 0
    return json.loads(out.getvalue().splitlines()[-1])["correct"]


@pytest.mark.parametrize("cell, stand_in", [
    ("tiny-dense.prefill", "program"),
    ("tiny-dense.prefill", "control"),
    ("tiny-dense.prefill", "answer_altered"),
    ("tiny-dense.prefill", "half_batch"),
    ("tiny-moe.prefill", "program"),
    ("tiny-moe.prefill", "control"),
    ("tiny-moe.prefill", "answer_altered"),
    ("tiny-moe.prefill", "half_batch"),
    ("tiny-dense.train", "program"),
    ("tiny-dense.train", "unchanged"),
    ("tiny-dense.train", "half_batch"),
    ("tiny-dense.train", "answer_altered"),
])
def test_only_the_program_is_correct(root, cell, stand_in):
    assert correct(root, cell, stand_in, seed=2**32 + 17) is (
        stand_in == "program")


def test_the_train_control_fails_a_number(root):
    cell = cellspec.find_cell(root, "tiny-dense.train")
    r = loops.Run(kind="train", model=cell.model, traffic=cell.traffic,
                  seed=5, device=torch.device("cpu"), t0=0.0,
                  ref=cell.reference)
    ok, judged = checks.judge(cell.kind.control_numbers(r), cell.limits)
    assert not ok, judged
