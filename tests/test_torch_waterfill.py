"""The port's water-fill (repro_torch.accel.waterfill) against the JAX
reference (repro.accel.waterfill_pallas / vcluster_jax).

* the plain PyTorch version vs the ``lax`` reference
  (``water_fill_lax``, and ``water_fill_host(impl="lax")``) on the rows
  of tests/test_accel.py, at ``rtol=1e-12``, ``atol=1e-12 *
  max(1, slots)``: XLA sums in another order than the port's fixed tree,
  so the last bits may differ;
* the plain version's summation order is the kernel's (checked against a
  numpy transcription of the kernel's thread/tree order), padding is
  bitwise neutral, and batch rows equal single-row calls bitwise;
* the dispatch rule: CPU tensors take the plain version, the CUDA
  wrapper refuses CPU tensors;
* on a card (marker ``cuda``): the kernel equals the plain version
  bitwise, reruns are bitwise equal, and the launch counter advances.

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


@pytest.mark.parametrize("width", [8, 128, 3072])
def test_tree_sum_is_the_kernel_order(width):
    """``_tree_sum`` transcribes csrc/waterfill.cu's order: thread t of
    min(width, 1024) sums lanes t, t+L, ... from +0.0, then the
    stride-halving shared-memory tree."""
    rng = np.random.default_rng(width)
    x = rng.standard_normal((3, width)) * 10.0 ** rng.integers(-8, 8, (3, width))
    nt = min(width, 1024)
    want = []
    for row in x:
        sh = [0.0] * nt
        for t in range(nt):
            acc = 0.0
            for lane in range(t, width, nt):
                acc = acc + float(row[lane])
            sh[t] = acc
        s = nt // 2
        while s > 0:
            for t in range(s):
                sh[t] = sh[t] + sh[t + s]
            s //= 2
        want.append(sh[0])
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


def test_dispatch_cpu_takes_plain_version_and_cuda_wrapper_refuses_cpu():
    caps, ws, slots, live = _random_rows()[0]
    args = (_t(caps)[None], _t(ws)[None], _t([slots]),
            _t(live, torch.bool)[None])
    before = wf.launches
    assert torch.equal(_bits(wf.water_fill(*args)),
                       _bits(wf.water_fill_reference(*args)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        wf.water_fill_cuda(*args)
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


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 32, 128, 1024, 3072, 5120])
def test_kernel_matches_plain_version_on_card(width):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernel runs only on a GPU")
    rng = np.random.default_rng(width)
    b = 64
    caps = rng.integers(0, 50, (b, width)).astype(np.float64)
    ws = rng.uniform(0.5, 2.0, (b, width))
    live = rng.random((b, width)) < 0.7
    slots = rng.uniform(0.0, caps.sum(1) * 1.2 + 1.0)
    dev = torch.device("cuda")
    args = (_t(caps).to(dev), _t(ws).to(dev), _t(slots).to(dev),
            _t(live, torch.bool).to(dev))
    before = wf.launches
    got = wf.water_fill_cuda(*args)
    again = wf.water_fill_cuda(*args)
    want = wf.water_fill_reference(*args)
    torch.cuda.synchronize()
    assert wf.launches == before + 2
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(again))
