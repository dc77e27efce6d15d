"""The port's virtual-cluster kernels (repro_torch.core.vcluster_torch and
repro_torch.core.projection) against the reference (repro.core.vcluster's
numpy loops and repro.core.vcluster_jax).

* ``water_fill`` and ``project_finish_times`` on ``device="cpu"`` (the
  plain versions of K1 and of the projection kernel) against the numpy
  ``_water_fill`` / ``_project_array`` at ``rtol=1e-9``, on the cases of
  tests/test_vcluster_jax.py and its randomized sweeps, and against
  ``vcluster_jax`` on the water-fill's cases and sweep and on a
  projection sweep of rows up to 16 jobs;
* the fixed-shape contract: batch rows equal single calls bitwise,
  padding is bitwise neutral, and the segmented projection (``floor`` >
  0 with host compaction) equals one unsegmented call at width 2048;
* ``projection.project_segmented_reference``, the plain version that the
  kernel's one-launch segmented route is held to on the card, equals the
  host's segment loop (``project_finish_times(device="cpu")``) bitwise
  and the numpy ``_project_array`` at ``rtol=1e-9``, on rows of 1025 and
  2048 jobs and on B = 2 rows (each its own segment loop);
* ``VirtualCluster(backend="torch")``: what-if batches price exactly like
  ``set_remaining`` / ``set_size``, the "auto" latch, and the device
  rule (a CUDA request without CUDA raises; the kernel wrapper refuses
  CPU tensors).

The reference calls ``jax.experimental.enable_x64``, which the installed
jax no longer has; a module-scoped shim restores it as
``jax.enable_x64(True)`` for these tests only.
"""

import math

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import vcluster_jax
from repro.core.vcluster import _project_array, _water_fill
from repro_torch.core import Phase, projection, vcluster_torch
from repro_torch.core.vcluster import VirtualCluster, resolve_backend


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _bits(x: np.ndarray) -> bytes:
    return np.ascontiguousarray(x, np.float64).tobytes()


# ---------------------------------------------------------------------------
# water_fill
# ---------------------------------------------------------------------------
WATER_FILL_CASES = [
    ([], [], 10.0),
    ([7.0], [1.0], 10.0),
    ([7.0], [1.0], 3.0),
    ([3.0, 5.0], [0.0, 0.0], 8.0),
    ([3.0, 5.0, 2.0], [0.0, 1.0, 2.0], 8.0),
    ([1.0, 2.0, 3.0], [1.0, 1.0, 1.0], 100.0),
    ([0.0, 0.0], [1.0, 1.0], 5.0),
    ([10.0, 10.0, 10.0, 10.0], [1.0, 1.0, 1.0, 1.0], 8.0),
    ([1.0, 100.0], [1.0, 1.0], 10.0),
    ([4.0, 4.0], [1.0, 3.0], 6.0),
    ([5.0, 5.0], [1.0, 1.0], 0.0),
]


@pytest.mark.parametrize("caps,ws,slots", WATER_FILL_CASES)
def test_water_fill_matches_numpy_and_jax(caps, ws, slots):
    caps = np.asarray(caps, dtype=np.float64)
    ws = np.asarray(ws, dtype=np.float64)
    out = vcluster_torch.water_fill(caps, ws, slots, device="cpu")
    np.testing.assert_allclose(out, _water_fill(caps, ws, slots),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(out, vcluster_jax.water_fill(caps, ws, slots),
                               rtol=1e-9, atol=1e-9)


def test_water_fill_randomized_equivalence():
    rng = np.random.default_rng(7)
    for _ in range(100):
        n = int(rng.integers(0, 50))
        caps = rng.integers(0, 40, size=n).astype(np.float64)
        ws = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(0.1, 5.0, n))
        slots = float(rng.integers(0, 120))
        out = vcluster_torch.water_fill(caps, ws, slots, device="cpu")
        np.testing.assert_allclose(out, _water_fill(caps, ws, slots),
                                   rtol=1e-9, atol=1e-8)
        np.testing.assert_allclose(
            out, vcluster_jax.water_fill(caps, ws, slots), rtol=1e-9,
            atol=1e-8)
        assert (out <= caps + 1e-9).all()
        assert out.sum() <= slots + 1e-6


def test_water_fill_batch_rows_equal_single_calls():
    rng = np.random.default_rng(2)
    caps = rng.integers(0, 30, (4, 21)).astype(np.float64)
    ws = rng.uniform(0.5, 2.0, (4, 21))
    slots = np.array([10.0, 40.0, 0.0, 300.0])
    batch = vcluster_torch.water_fill_batch(caps, ws, slots, device="cpu")
    for i in range(4):
        single = vcluster_torch.water_fill(caps[i], ws[i], slots[i],
                                           device="cpu")
        assert _bits(batch[i]) == _bits(single)


# ---------------------------------------------------------------------------
# The projection
# ---------------------------------------------------------------------------
def _projection_cases(seed, count, max_n):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        n = int(rng.integers(1, max_n))
        rem = np.where(rng.random(n) < 0.15, np.inf,
                       rng.uniform(0.0, 400.0, n))
        caps = rng.integers(0, 15, size=n).astype(np.float64)
        ws = rng.uniform(0.5, 2.0, n)
        yield rem, caps, ws, float(rng.integers(1, 30)), \
            float(rng.uniform(0.0, 1e4))


def _assert_finish_close(out, ref):
    finite = np.isfinite(ref)
    assert (finite == np.isfinite(out)).all()
    np.testing.assert_allclose(out[finite], ref[finite], rtol=1e-9, atol=1e-9)


def test_projection_matches_numpy_reference():
    for rem, caps, ws, slots, now in _projection_cases(11, 60, 30):
        out = vcluster_torch.project_finish_times(rem, caps, ws, slots, now,
                                                  device="cpu")
        _assert_finish_close(out, _project_array(rem.copy(), caps, ws,
                                                 slots, now))


def test_projection_matches_jax_reference():
    """Rows up to 16 jobs (two of the reference's jit buckets), with
    zero weights mixed in."""
    rng = np.random.default_rng(4)
    for rem, caps, ws, slots, now in _projection_cases(13, 12, 16):
        ws = np.where(rng.random(len(ws)) < 0.2, 0.0, ws)
        out = vcluster_torch.project_finish_times(rem, caps, ws, slots, now,
                                                  device="cpu")
        _assert_finish_close(out, vcluster_jax.project_finish_times(
            rem, caps, ws, slots, now))


def test_projection_batch_rows_match_single_calls():
    rng = np.random.default_rng(3)
    b, n = 5, 12
    rem_b = rng.uniform(1.0, 300.0, (b, n))
    caps_b = rng.integers(1, 9, (b, n)).astype(np.float64)
    ws_b = rng.uniform(0.5, 2.0, (b, n))
    slots = np.array([4.0, 8.0, 16.0, 5.0, 7.0])
    now = np.array([0.0, 10.0, 0.0, 3.5, 100.0])
    batch = vcluster_torch.project_finish_times_batch(
        rem_b, caps_b, ws_b, slots, now, device="cpu")
    for i in range(b):
        single = vcluster_torch.project_finish_times(
            rem_b[i], caps_b[i], ws_b[i], float(slots[i]), float(now[i]),
            device="cpu")
        assert _bits(batch[i]) == _bits(single)


def test_padding_bucket_is_bitwise_neutral():
    """The same live prefix in a wider row (a bigger bucket, with
    ``n_valid``) gives bit-identical finish times."""
    rng = np.random.default_rng(5)
    n = 6
    rem = rng.uniform(1.0, 100.0, n)
    caps = rng.integers(1, 6, n).astype(np.float64)
    ws = np.ones(n)
    single = vcluster_torch.project_finish_times(rem, caps, ws, 5.0, 1.0,
                                                 device="cpu")
    wide, wide_caps, wide_ws = (np.zeros((2, 40)) for _ in range(3))
    wide[:, :n] = rem
    wide_caps[:, :n] = caps
    wide_ws[:, :n] = ws
    batch = vcluster_torch.project_finish_times_batch(
        wide, wide_caps, wide_ws, 5.0, 1.0, n_valid=np.array([n, n]),
        device="cpu")
    assert _bits(batch[0, :n]) == _bits(single)
    assert _bits(batch[1, :n]) == _bits(single)
    fill = vcluster_torch.water_fill(caps, ws, 5.0, device="cpu")
    fill_wide = vcluster_torch.water_fill_batch(
        wide_caps[:, :n], wide_ws[:, :n], 5.0, device="cpu")
    assert _bits(fill_wide[0]) == _bits(fill)


def test_segmented_projection_equals_one_call_at_width_2048():
    """Segments (the kernel stops at half the width, the host compacts the
    survivors and resumes with the carried clock and level) against one
    unsegmented call on the same row, to 1e-12."""
    rng = np.random.default_rng(9)
    n = 2000
    rem = rng.uniform(1.0, 500.0, n)
    rem[rng.random(n) < 0.02] = np.inf
    caps = rng.integers(1, 20, n).astype(np.float64)
    ws = rng.uniform(0.5, 2.0, n)
    before = vcluster_torch.calls["project"]
    seg = vcluster_torch.project_finish_times(rem, caps, ws, 700.0, 3.0,
                                              device="cpu")
    assert vcluster_torch.calls["project"] - before >= 3  # 2048, 1024, ...
    t = lambda x, dt=torch.float64: torch.as_tensor(x, dtype=dt)[None]
    one = projection.project_reference(
        t(rem), t(caps), t(ws), torch.ones(1, n, dtype=torch.bool),
        torch.tensor([700.0], dtype=torch.float64),
        torch.tensor([3.0], dtype=torch.float64),
        torch.zeros(1, dtype=torch.float64), 0)[2][0].numpy()
    finite = np.isfinite(one)
    assert (finite == np.isfinite(seg)).all() and finite.sum() > 1900
    np.testing.assert_allclose(seg[finite], one[finite], rtol=1e-12)


def _segment_row(rng, n):
    """A row of n jobs with infinite-size jobs, dead lanes (cap 0) and
    zero weights."""
    rem = rng.uniform(1.0, 500.0, n)
    rem[rng.random(n) < 0.05] = np.inf
    caps = rng.integers(0, 20, n).astype(np.float64)
    ws = rng.uniform(0.5, 2.0, n)
    ws[rng.random(n) < 0.05] = 0.0
    return rem, caps, ws


def _row_tensors(rem, caps, ws, slots, now):
    t = lambda x: torch.as_tensor(np.atleast_2d(x), dtype=torch.float64)
    b = t(rem).shape[0]
    return (t(rem), t(caps), t(ws), torch.ones(t(rem).shape, dtype=torch.bool),
            torch.full((b,), slots, dtype=torch.float64),
            torch.full((b,), now, dtype=torch.float64),
            torch.zeros(b, dtype=torch.float64))


@pytest.mark.parametrize("n", [1025, 2048])
def test_segmented_reference_equals_host_segments(n):
    rng = np.random.default_rng(n)
    rem, caps, ws = _segment_row(rng, n)
    slots, now = float(n // 3), 5.0
    before = vcluster_torch.calls["project"]
    host = vcluster_torch.project_finish_times(rem, caps, ws, slots, now,
                                               device="cpu")
    assert vcluster_torch.calls["project"] - before >= 2  # in segments
    args = _row_tensors(rem, caps, ws, slots, now)
    carry = projection.project_segmented_reference(*args)
    assert _bits(carry[2][0].numpy()) == _bits(host)
    assert int(carry[5][0]) == int(np.isinf(host).sum()) - int(
        ((caps == 0) & np.isinf(host)).sum())  # the infinite-size jobs left
    again = projection.project(*args, 0, segmented=True)
    for g, w in zip(again, carry):
        assert torch.equal(g, w)
    _assert_finish_close(host, _project_array(rem.copy(), caps, ws, slots,
                                              now))


def test_segmented_reference_rows_are_independent():
    """B = 2 rows of different live counts (one with lanes not present):
    each row's carry equals that row's own segmented projection."""
    rng = np.random.default_rng(3)
    rows = [_segment_row(rng, 1100) for _ in range(2)]
    args = list(_row_tensors(*(np.stack(x) for x in zip(*rows)), 400.0, 2.0))
    args[3][1, 600:] = False
    carry = projection.project_segmented_reference(*args)
    for i in range(2):
        one = projection.project_segmented_reference(
            *[x[i:i + 1] for x in args])
        for g, w in zip(carry, one):
            assert torch.equal(g[i:i + 1], w)
    assert not carry[3][1, 600:].any()
    assert (carry[2][1, 600:] == 2.0).all()  # not present: fin = now


def test_projection_carry_and_floor():
    """A row stopped at its floor reports the survivors and ``run``; one
    that runs on stops with only its infinite-size job left.  Seven live
    jobs of cap 1 on 7 slots finish at now + rem; the eighth has no
    work."""
    n = 8
    rem = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0, math.inf, 0.0]],
                       dtype=torch.float64)
    caps = torch.ones(1, n, dtype=torch.float64)
    ws = torch.tensor([[1.0] * 7 + [0.0]], dtype=torch.float64)
    args = (rem, caps, ws, torch.ones(1, n, dtype=torch.bool),
            torch.tensor([7.0], dtype=torch.float64),
            torch.tensor([10.0], dtype=torch.float64),
            torch.zeros(1, dtype=torch.float64))
    t, rem2, fin, live, lam, n_live, run = projection.project_reference(
        *args, 4)
    assert int(n_live[0]) == 4 and bool(run[0])
    assert live[0].tolist() == [False, False, False, True, True, True, True,
                                False]
    assert fin[0, :3].tolist() == [11.0, 12.0, 13.0] and fin[0, 7] == 10.0
    # Every job takes its one slot, so the level rose past every cap.
    assert float(t[0]) == 13.0 and math.isinf(float(lam[0]))
    t, rem2, fin, live, lam, n_live, run = projection.project_reference(
        *args, 0)
    assert int(n_live[0]) == 1 and not bool(run[0])
    assert math.isinf(fin[0, 6]) and float(t[0]) == 16.0


# ---------------------------------------------------------------------------
# VirtualCluster on the torch backend
# ---------------------------------------------------------------------------
def _make_vc(backend, slots=10, jobs=6):
    vc = VirtualCluster(Phase.MAP, slots=slots, backend=backend, device="cpu")
    for j in range(jobs):
        vc.add_job(j, 40.0 + 17.0 * j, 4 + j)
    return vc


def test_projected_finish_batch_matches_set_remaining():
    vc = _make_vc("torch")
    scenarios = [{}, {2: 10.0}, {0: math.inf}, {4: 1.0, 5: 500.0}]
    outs = vc.projected_finish_batch(scenarios, now=2.0)
    assert outs[0] == vc.projected_finish(2.0)
    for scenario, out in zip(scenarios[1:], outs[1:]):
        ref = _make_vc("torch")
        for j, r in scenario.items():
            ref.set_remaining(j, r)
        assert out == ref.projected_finish(2.0)


def test_projected_finish_batch_size_mode_matches_set_size():
    vc = _make_vc("torch")
    vc.age(3.0)
    vc.allocation()
    scenarios = [{2: 15.0}, {0: 400.0}, {4: 9.0, 5: 700.0}]
    outs = vc.projected_finish_batch(scenarios, now=5.0, as_sizes=True)
    for scenario, out in zip(scenarios, outs):
        ref = _make_vc("torch")
        ref.age(3.0)
        ref.allocation()
        for j, size in scenario.items():
            ref.set_size(j, size)
        assert out == ref.projected_finish(5.0)
    numpy_outs = _make_vc("numpy")
    numpy_outs.age(3.0)
    numpy_outs.allocation()
    for got, want in zip(outs, numpy_outs.projected_finish_batch(
            scenarios, now=5.0, as_sizes=True)):
        assert got.keys() == want.keys()
        for j in got:
            assert got[j] == pytest.approx(want[j], rel=1e-9)


def test_auto_backend_latches_at_threshold():
    vc = VirtualCluster(Phase.MAP, slots=10, backend="auto",
                        auto_threshold=5, device="cpu")
    for j in range(4):
        vc.add_job(j, 50.0, 2)
    assert vc.backend == "numpy"
    vc.add_job(4, 50.0, 2)
    assert vc.backend == "torch"
    before = dict(vcluster_torch.calls)
    vc.allocation()
    vc.projected_finish(0.0)
    assert vcluster_torch.calls == {k: v + 1 for k, v in before.items()}
    vc.remove_job(0)
    vc.remove_job(1)
    assert vc.backend == "torch"  # latched


def test_resolve_backend_env(monkeypatch):
    monkeypatch.delenv("REPRO_VC_BACKEND", raising=False)
    assert resolve_backend(None) == "auto"
    monkeypatch.setenv("REPRO_VC_BACKEND", "torch")
    assert resolve_backend(None) == "torch"
    assert resolve_backend("numpy") == "numpy"
    with pytest.raises(ValueError):
        resolve_backend("jax")


def test_cuda_requests_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("torch", "auto"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            VirtualCluster(Phase.MAP, slots=4, backend=backend)
    assert VirtualCluster(Phase.MAP, slots=4, backend="numpy").backend \
        == "numpy"
    one = np.ones(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vcluster_torch.water_fill(one, one, 2.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vcluster_torch.project_finish_times(one, one, one, 2.0, 0.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vcluster_torch.project_finish_times_batch(one[None], one[None],
                                                  one[None], 2.0, 0.0)
    rows = torch.ones(1, 8, dtype=torch.float64)
    scal = torch.ones(1, dtype=torch.float64)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        projection.project_cuda(rows, rows, rows,
                                torch.ones(1, 8, dtype=torch.bool), scal,
                                scal, scal)
