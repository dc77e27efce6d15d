"""The port's water-fill (repro_torch.accel.waterfill) against the JAX
reference (repro.accel.waterfill_pallas / vcluster_jax).

* the plain PyTorch version vs the ``lax`` reference
  (``water_fill_lax``, and ``water_fill_host(impl="lax")``) on the rows
  of tests/test_accel.py, at ``rtol=1e-12``, ``atol=1e-12 *
  max(1, slots)``: XLA sums in another order than the port's fixed tree,
  so the last bits may differ;
* the plain version's summation order is the kernel's (checked against a
  numpy transcription of the kernel's warp butterflies), padding is
  bitwise neutral, batch rows equal single-row calls bitwise, and the
  pair form (both phases of a cell step) equals two single calls;
* the dispatch rule: CPU tensors take the plain version, the CUDA
  wrappers refuse CPU tensors.

The kernel against the plain version on a card is in
tests/test_torch_cuda.py, which imports no JAX and so runs on a GPU host.

The reference calls ``jax.experimental.enable_x64``, which the installed
jax no longer has; a module-scoped shim restores it as
``jax.enable_x64(True)`` for these tests only.
"""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.accel.waterfill_pallas import water_fill_host, water_fill_lax
from repro_torch.accel import waterfill as wf


@pytest.fixture(scope="module", autouse=True)
def _x64_shim():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64",
                   lambda: jax.enable_x64(True), raising=False)
        yield


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int64)


def _t(x, dtype=torch.float64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _port_row(caps, ws, slots, live):
    return wf.water_fill_reference(
        _t(caps)[None], _t(ws)[None], _t([slots]), _t(live, torch.bool)[None]
    )[0].numpy()


def _random_rows():
    """The 25 rows of tests/test_accel.py's Pallas-vs-lax check."""
    rng = np.random.default_rng(7)
    rows = []
    for _ in range(25):
        width = int(rng.integers(1, 65))
        caps = rng.uniform(0.0, 30.0, width)
        caps[rng.random(width) < 0.2] = 0.0
        ws = rng.uniform(0.5, 2.0, width)
        live = rng.random(width) < 0.7
        slots = float(rng.uniform(0.0, caps.sum() * 1.2 + 1.0))
        rows.append((caps, ws, slots, live))
    return rows


def test_reference_matches_lax_random_rows():
    """All 25 rows in one call of the jitted, vmapped lax reference
    (``water_fill_host`` retraces the while-loop on every call), each
    padded with inert lanes to the widest row."""
    rows = _random_rows()
    width = max(len(r[0]) for r in rows)

    def padded(i, fill):
        out = np.full((len(rows), width), fill)
        for r, row in enumerate(rows):
            out[r, : len(row[i])] = row[i]
        return out

    caps, ws, live = padded(0, 0.0), padded(1, 0.0), padded(3, False)
    slots = np.array([r[2] for r in rows])
    with jax.enable_x64(True):
        ref = np.asarray(jax.jit(jax.vmap(water_fill_lax))(
            jax.numpy.asarray(caps), jax.numpy.asarray(ws),
            jax.numpy.asarray(slots), jax.numpy.asarray(live),
        ))
    got = wf.water_fill_reference(
        _t(caps), _t(ws), _t(slots), _t(live, torch.bool)
    ).numpy()
    for trial, (_, _, s, _) in enumerate(rows):
        np.testing.assert_allclose(
            got[trial], ref[trial], rtol=1e-12, atol=1e-12 * max(1.0, s),
            err_msg=f"trial {trial}",
        )


@pytest.mark.parametrize("slots,live", [
    (10.0, np.zeros(8, bool)),   # no live entries
    (0.0, np.ones(8, bool)),     # no free slots
    (1e6, np.ones(8, bool)),     # slots exceed total caps
], ids=["no-live", "no-slots", "excess-slots"])
def test_reference_matches_lax_degenerate_rows(slots, live):
    caps, ws = np.arange(8.0), np.ones(8)
    ref = water_fill_host(caps, ws, slots, live, impl="lax")
    got = _port_row(caps, ws, slots, live)
    np.testing.assert_allclose(got, ref, rtol=1e-12,
                               atol=1e-12 * max(1.0, slots))


def _butterfly(v: list) -> list:
    """A warp's ``__shfl_xor_sync`` butterfly: at each offset, lane i
    adds its value and lane i ^ offset's (all lanes at once)."""
    off = 16
    while off:
        v = [v[i] + v[i ^ off] for i in range(32)]
        off //= 2
    return v


@pytest.mark.parametrize("width", [8, 128, 1024, 3072])
def test_tree_sum_is_the_kernel_order(width):
    """``_tree_sum`` transcribes csrc/waterfill.cu's order.  A row is cut
    into 256-lane segments, one warp each (a row of <= 256 lanes is one
    warp): thread t of segment s sums lanes 256s + t + 32j, j = 0..7, in
    order from +0.0 (+0.0 past the row), the warp butterflies its 32
    sums, and lane i of every warp reads segment i's sum (+0.0 past the
    last segment) and butterflies them again.  Every lane ends with the
    same bits."""
    rng = np.random.default_rng(width)
    x = rng.standard_normal((3, width)) * 10.0 ** rng.integers(-8, 8, (3, width))
    segments = -(-width // 256)
    assert segments <= 32
    want = []
    for row in x:
        sums = []
        for seg in range(segments):
            part = []
            for t in range(32):
                acc = 0.0
                for j in range(8):
                    lane = 256 * seg + t + 32 * j
                    acc = acc + (float(row[lane]) if lane < width else 0.0)
                part.append(acc)
            v = _butterfly(part)
            assert len(set(v)) == 1
            sums.append(v[0])
        if segments == 1:
            want.append(sums[0])
            continue
        total = _butterfly(sums + [0.0] * (32 - segments))
        assert len(set(total)) == 1
        want.append(total[0])
    got = wf._tree_sum(torch.as_tensor(x)).numpy()
    assert got.tobytes() == np.asarray(want).tobytes()


def test_reference_padding_neutral_and_rowwise_bitwise():
    """Padding a row to a wider bucket (one and three lanes per thread)
    and batching rows together move no bit of any allocation."""
    rows = _random_rows()
    width = max(len(r[0]) for r in rows)
    singles = [_port_row(*r) for r in rows]
    for wide in (width, 1024, 3072):
        caps = np.zeros((len(rows), wide))
        ws = np.zeros((len(rows), wide))
        live = np.zeros((len(rows), wide), bool)
        slots = np.array([r[2] for r in rows])
        for i, (c, w, _, lv) in enumerate(rows):
            caps[i, : len(c)], ws[i, : len(w)], live[i, : len(lv)] = c, w, lv
        out = wf.water_fill_reference(
            _t(caps), _t(ws), _t(slots), _t(live, torch.bool)
        ).numpy()
        for i, single in enumerate(singles):
            assert out[i, : len(single)].tobytes() == single.tobytes(), (wide, i)
            assert not out[i, len(single):].any()


@pytest.mark.parametrize("width", [8, 128, 1024])
def test_pair_equals_two_single_calls_bitwise(width):
    """``water_fill_pair`` (both phases of a cell step, sharing the
    weights) is bitwise two ``water_fill`` calls, rows whose guard is
    false at entry (no live lane, no free slot) included."""
    rng = np.random.default_rng(100 + width)
    b = 6
    ws = rng.uniform(0.5, 2.0, (b, width))
    phases = []
    for _ in range(2):
        caps = rng.integers(0, 50, (b, width)).astype(np.float64)
        live = rng.random((b, width)) < 0.3
        slots = rng.uniform(0.0, caps.sum(1) * 1.2 + 1.0)
        phases.append((caps, slots, live))
    live_m = phases[0][2]
    live_m[0] = False
    phases[1][1][1] = 0.0
    (cm, sm, lm), (cr, sr, lr) = phases
    got = wf.water_fill_pair(_t(cm), _t(cr), _t(ws), _t(sm), _t(sr),
                             _t(lm, torch.bool), _t(lr, torch.bool))
    for alloc, (caps, slots, live) in zip(got, phases):
        want = wf.water_fill(_t(caps), _t(ws), _t(slots), _t(live, torch.bool))
        assert alloc.shape == (b, width)
        assert torch.equal(_bits(alloc), _bits(want))
    assert not got[0][0].any()


def test_dispatch_cpu_takes_plain_version_and_cuda_wrapper_refuses_cpu():
    caps, ws, slots, live = _random_rows()[0]
    args = (_t(caps)[None], _t(ws)[None], _t([slots]),
            _t(live, torch.bool)[None])
    before = wf.launches
    assert torch.equal(_bits(wf.water_fill(*args)),
                       _bits(wf.water_fill_reference(*args)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wf.water_fill_cuda(*args)
    pair = (args[0], args[0], args[1], args[2], args[2], args[3], args[3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        wf.water_fill_pair_cuda(*pair)
    with pytest.raises(ValueError, match="CUDA tensors"):
        wf.check_batch(args[1], args[2], args[2])
    assert wf.launches == before


def test_wrapper_validates_inputs():
    caps = torch.zeros(2, 8, dtype=torch.float64)
    live = torch.zeros(2, 8, dtype=torch.bool)
    slots = torch.ones(2, dtype=torch.float64)
    with pytest.raises(TypeError):
        wf.water_fill(caps.float(), caps, slots, live)
    with pytest.raises(TypeError):
        wf.water_fill(caps, caps, slots, live.double())
    with pytest.raises(ValueError):
        wf.water_fill(caps, caps, slots[:1], live)
