"""The port's discrete-event path (repro_torch.core, repro_torch.scenarios)
against the reference's (repro.core, repro.scenarios): the golden-trace
contract of tests/conformance.py.

* GOLDEN_SEEDS x {hfsp, hfsp-kill, srpt, las, psbs}: the port with the
  torch virtual cluster on the CPU (the plain versions of the water-fill
  and of the projection kernel) against the reference's numpy run; the
  summaries must pass ``conformance.assert_traces_equal``, floats
  included;
* fifo and fair through the port (they have no virtual cluster), and one
  hfsp run whose "auto" clusters latch to torch at 5 live jobs;
* ``run_scenario(paper_fb_base().quick(), device="cpu")`` equal to the
  reference's report apart from the wall time, and its trace replay;
* the device rule: ``run_scenario`` on "cuda" raises without CUDA.

The reference's jax backend is not the yardstick: it calls
``jax.experimental.enable_x64``, which the installed jax lacks.  The
reference's runs go through one child process, which streams each
summary as it finishes while this process runs the port's (the two halves
take about as long, so the file takes about half the time).
"""

import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from conformance import GOLDEN_SEEDS, assert_traces_equal
from repro_torch.core import (
    FairScheduler,
    FIFOScheduler,
    HFSPConfig,
    HFSPScheduler,
    Phase,
    Preemption,
    SchedulerConfig,
    Simulator,
    disciplines,
)
from repro_torch.scenarios.presets import paper_fb_base
from repro_torch.scenarios.runner import build_workload, run_scenario
from repro_torch.workload import fb_cluster, fb_dataset

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"

GOLDEN = [(name, seed) for name in ("hfsp", "hfsp-kill", "srpt", "las", "psbs")
          for seed in GOLDEN_SEEDS]
PLAIN = [("fifo", 0), ("fair", 0)]


def port_trace(name: str, seed: int, *, vc_backend: str | None = None,
               vc_auto_threshold: int | None = None, num_jobs: int = 30,
               num_machines: int = 20) -> tuple[dict, object]:
    """``conformance.run_trace`` over the port (its default arguments),
    with the virtual cluster on the CPU; returns (summary, scheduler)."""
    cluster = fb_cluster(num_machines=num_machines)
    jobs, _ = fb_dataset(seed=seed, num_jobs=num_jobs)
    if name in ("fifo", "fair"):
        cfg = SchedulerConfig()
        if name == "fifo":
            sch = FIFOScheduler(cluster, cfg)
        else:
            sch = FairScheduler(cluster, cfg)
    else:
        cfg = HFSPConfig(vc_backend=vc_backend, vc_device="cpu")
        if vc_auto_threshold is not None:
            cfg.vc_auto_threshold = vc_auto_threshold
        if name == "hfsp-kill":
            cfg.preemption = Preemption.KILL
        if name in ("hfsp", "hfsp-kill"):
            sch = HFSPScheduler(cluster, cfg)
        else:
            sch = disciplines.build_scheduler(name, cluster, config=cfg)
    res = Simulator(cluster, sch, jobs).run()
    st = res.stats
    return {
        "completion": dict(res.completion),
        "locality": (res.locality_hits, res.locality_misses),
        "preemption": (st.suspensions, st.resumes, st.kills, st.waits),
        "delay": st.delay_sched_waits,
        "training": st.training_tasks,
        "passes": res.passes,
    }, sch


#: The reference's side, run in the child in the order the tests ask.
_REFERENCE = """
import pickle, sys
sys.path[:0] = [{tests!r}, {src!r}]
from conformance import run_trace
from repro.scenarios.presets import paper_fb_base
from repro.scenarios.runner import run_scenario
out = sys.stdout.buffer
for name, seed in {cases!r}:
    pickle.dump(((name, seed), run_trace(name, seed, vc_backend="numpy")), out)
    out.flush()
report = run_scenario(paper_fb_base().quick())
report.pop("wall_s")
pickle.dump((("run_scenario", 0), report), out)
out.flush()
"""


class _Reference:
    """Summaries from the child process, read as they arrive."""

    def __init__(self):
        code = _REFERENCE.format(tests=str(TESTS), src=str(SRC),
                                 cases=GOLDEN + PLAIN)
        self.proc = subprocess.Popen([sys.executable, "-c", code],
                                     stdout=subprocess.PIPE)
        self.got: dict = {}

    def __getitem__(self, key):
        while key not in self.got:
            try:
                k, v = pickle.load(self.proc.stdout)
            except EOFError:
                self.proc.wait()
                raise RuntimeError(f"reference child ended without {key} "
                                   f"(rc {self.proc.returncode})") from None
            self.got[k] = v
        return self.got[key]

    def close(self):
        self.proc.stdout.close()
        self.proc.kill()
        self.proc.wait()


@pytest.fixture(scope="module")
def reference():
    ref = _Reference()
    yield ref
    ref.close()


@pytest.mark.parametrize("name,seed", GOLDEN)
def test_golden_trace_torch_vcluster_matches_reference(reference, name, seed):
    got, sch = port_trace(name, seed, vc_backend="torch")
    assert {vc.backend for vc in sch.vc.values()} == {"torch"}
    assert_traces_equal(got, reference[(name, seed)])


@pytest.mark.parametrize("name,seed", PLAIN)
def test_fifo_and_fair_match_reference(reference, name, seed):
    got, _ = port_trace(name, seed)
    assert_traces_equal(got, reference[(name, seed)])


def test_auto_backend_latches_and_matches_reference(reference):
    got, sch = port_trace("hfsp", 0, vc_backend="auto", vc_auto_threshold=5)
    assert sch.vc[Phase.MAP].backend == "torch"
    assert_traces_equal(got, reference[("hfsp", 0)])


@pytest.fixture(scope="module")
def quick_report():
    report = run_scenario(paper_fb_base().quick(), device="cpu")
    assert report.pop("wall_s") >= 0.0
    return report


def test_run_scenario_matches_reference_report(reference, quick_report):
    assert quick_report == reference[("run_scenario", 0)]
    assert quick_report["jobs_completed"] == 30


def test_trace_replay_equals_direct_run(tmp_path, quick_report):
    from repro_torch.scenarios.trace import export_trace

    base = paper_fb_base().quick()
    jobs, class_of = build_workload(base)
    path = export_trace(tmp_path / "golden.jsonl", jobs, class_of,
                        {"generator": "fb", "seed": 0})
    replay = run_scenario(base.override(**{
        "workload.kind": "trace", "workload.trace_path": str(path),
    }), device="cpu")
    assert replay["completion_fingerprint"] == \
        quick_report["completion_fingerprint"]


def test_run_scenario_on_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = paper_fb_base().quick().override(**{"scheduler.policy": "fifo"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HFSPScheduler(fb_cluster(20), HFSPConfig(vc_backend="torch"))
