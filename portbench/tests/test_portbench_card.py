"""The tiny cells through the whole run on the card (their K2 launches
included): the program is correct and the fp8 control is not.  Skips
where this process has no CUDA device."""

import io
import json
from contextlib import redirect_stdout

import pytest
import torch

from portbench import run
from portbench.tests.tiny import make_root

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def no_jax_check(monkeypatch):
    """The test process may hold JAX from the repository's other tests."""
    monkeypatch.setattr(run, "forbidden_modules", lambda: [])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", ["tiny-dense.prefill", "tiny-moe.prefill"])
def test_program_correct_and_control_not_on_the_card(card, tmp_path, cell):
    root = make_root(tmp_path)
    seen = {}
    for stand_in in ("program", "control"):
        out = io.StringIO()
        with redirect_stdout(out):
            rc = run.main(["--workload", cell, "--seed", "2147483659",
                           "--seconds", "0.5"], root=root, device=card,
                          stand_in=stand_in)
        assert rc == 0
        seen[stand_in] = json.loads(out.getvalue().splitlines()[-1])
    assert seen["program"]["correct"] is True, seen["program"]["checks"]
    assert seen["control"]["correct"] is False
    assert seen["program"]["device"]["kind"] == torch.cuda.get_device_name()
