"""The RWKV6 WKV scan in the port (repro_torch.kernels.rwkv6, the kernel K3
beside its plain version, and the scans of repro_torch.models.rwkv)
against the JAX reference (repro.kernels.rwkv6, repro.models.rwkv).

Inputs are drawn with numpy as tests/test_kernels.py draws them: normal
r, k, v; decays w = exp(-exp(N(-sharpness, 1))); u and s0 at 0.1 N.

* The plain version against the reference's Pallas kernel in interpret
  mode on shapes of tests/test_kernels.py (the ragged t = 65 included),
  f32 at atol = rtol = 2e-5 (products summed in another order than
  XLA's); both against the oracle at atol = rtol 1e-3 for the output and
  atol 1e-4 for the state (the reference's own tolerances, the chunked
  form against the sequential scan).
* bf16 r/k/v with f32 w: the output is bf16 and agrees with the Pallas
  kernel's within one bf16 rounding (rtol 1e-2, atol 2e-2).
* Two chunked calls carrying the state equal one long call.
* Strong but stable decays (sharpness 0, chunk 16): held to the Pallas
  kernel at atol = rtol = 1e-4 and to the oracle as above; at chunk 64
  the same decays break the chunked form, and the plain version breaks
  as the Pallas kernel does.
* The model-layout adapter, the port's ``rwkv_scan_chunked`` and
  ``rwkv_scan_ref`` against the reference's.
* The dispatch and the refusals (mixed devices, shapes).
* ``chip_smoke.py``'s emulated faults of a chunk-parallel kernel
  (``wrong_rwkv6``: a late chunk's entering state zeroed, one channel of
  the state missing a chunk's decay, a chunk's bonus diagonal dropped)
  each fail the card's output tolerance (``RWKV_TOL``), f32 and bf16, at
  test_kernels.py's decays and at the model's, while the plain version
  carried across the same split of chunks stays within it.

The kernel itself is held to the plain version on a card by
tests/test_torch_cuda.py (marker ``cuda``) and by ``chip_smoke.py``.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.kernel import rwkv6_chunked_bhtd as jax_bhtd
from repro.kernels.rwkv6.ops import rwkv6_chunked as jax_chunked
from repro.kernels.rwkv6.ref import rwkv6_ref as jax_ref
from repro.models import rwkv as jax_rwkv
from repro_torch.kernels.rwkv6 import kernel as K
from repro_torch.kernels.rwkv6.ops import rwkv6_chunked
from repro_torch.kernels.rwkv6.ref import rwkv6_ref
from repro_torch.models import rwkv as R

SHAPES = {  # b, h, t, d, chunk  (tests/test_kernels.py)
    "tiny": (1, 1, 32, 8, 16),
    "one-chunk": (1, 2, 64, 32, 64),
    "ragged-t65": (2, 2, 65, 16, 32),
}


def _inputs(seed, b, h, t, d, sharpness=2.0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, h, t, d)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, h, t, d)) - sharpness))
    u = 0.1 * rng.standard_normal((h, d))
    s0 = 0.1 * rng.standard_normal((b, h, d, d))
    return (r, k, v, w.astype(np.float32), u.astype(np.float32),
            s0.astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close_to_oracle(o, s, args):
    o_r, s_r = rwkv6_ref(*_t(*args))
    np.testing.assert_allclose(np.asarray(o), o_r.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(s), s_r.numpy(), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_matches_jax_kernel_and_oracle(name):
    b, h, t, d, chunk = SHAPES[name]
    args = _inputs(0, b, h, t, d)
    want_o, want_s = jax_bhtd(*args, chunk=chunk, interpret=True)
    got_o, got_s = K.rwkv6_chunked_bhtd(*_t(*args), chunk=chunk)
    assert got_o.shape == (b, h, t, d) and got_o.dtype == torch.float32
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=2e-5, rtol=2e-5)
    _close_to_oracle(got_o, got_s, args)
    _close_to_oracle(want_o, want_s, args)


def test_strong_decays_match_jax_kernel_and_oracle():
    """Decays down to ~1e-16 at chunk 16: the cumulative decay of a chunk
    stays above the 1e-30 clamp, so the ratio form holds.  Against the
    Pallas kernel at atol = rtol = 1e-4: the scores multiply r scaled by
    the cumulative decay with k scaled by its inverse (up to ~1e10 here),
    so a different summation order shows more than at weak decays."""
    args = _inputs(1, 1, 2, 128, 16, sharpness=0.0)
    assert args[3].min() < 1e-8
    want_o, want_s = jax_bhtd(*args, chunk=16, interpret=True)
    got_o, got_s = K.rwkv6_plain(*_t(*args), chunk=16)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=1e-4, rtol=1e-4)
    _close_to_oracle(got_o, got_s, args)


def test_keeps_the_reference_failure_past_the_clamp():
    """A behaviour of the reference that the port keeps, not a fix: at
    sharpness 0 a chunk of 64 takes the cumulative decay below the 1e-30
    clamp of ``k / max(a_pre w, 1e-30)``, and the chunked form leaves the
    oracle by more than 1 (ROADMAP Queue 3).  The plain version fails the
    same way, within 1e-3 of the Pallas kernel."""
    args = _inputs(1, 1, 2, 128, 16, sharpness=0.0)
    want_o, _ = jax_bhtd(*args, chunk=64, interpret=True)
    got_o, _ = K.rwkv6_plain(*_t(*args), chunk=64)
    o_r, _ = rwkv6_ref(*_t(*args))
    assert float(np.abs(np.asarray(want_o) - o_r.numpy()).max()) > 1.0
    assert float((got_o - o_r).abs().max()) > 1.0
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=1e-3, rtol=1e-3)


def test_bf16_rkv_with_f32_decays():
    b, h, t, d, chunk = SHAPES["ragged-t65"]
    r, k, v, w, u, s0 = _inputs(2, b, h, t, d)
    want_o, want_s = jax_bhtd(*(jnp.asarray(x, jnp.bfloat16) for x in (r, k, v)),
                              w, u, s0, chunk=chunk, interpret=True)
    rt, kt, vt = (x.to(torch.bfloat16) for x in _t(r, k, v))
    got_o, got_s = K.rwkv6_chunked_bhtd(rt, kt, vt, *_t(w, u, s0), chunk=chunk)
    assert got_o.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_o.float().numpy(),
                               np.asarray(want_o.astype(jnp.float32)),
                               atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=2e-5, rtol=2e-5)
    # The same as f32 inputs holding the bf16 values (cast inside).
    f_o, f_s = K.rwkv6_plain(rt.float(), kt.float(), vt.float(),
                             *_t(w, u, s0), chunk=chunk)
    assert torch.equal(got_o, f_o.to(torch.bfloat16)) and torch.equal(got_s, f_s)


def test_state_carries_across_calls():
    """Two chunked calls == one long call (streaming parity)."""
    r, k, v, w, u, s0 = _t(*_inputs(3, 1, 2, 96, 16))
    full, s_full = K.rwkv6_plain(r, k, v, w, u, s0, chunk=16)
    half = 48
    o1, s1 = K.rwkv6_plain(*(x[:, :, :half] for x in (r, k, v, w)), u, s0,
                           chunk=16)
    o2, s2 = K.rwkv6_plain(*(x[:, :, half:] for x in (r, k, v, w)), u, s1,
                           chunk=16)
    torch.testing.assert_close(torch.cat([o1, o2], dim=2), full,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s2, s_full, atol=1e-5, rtol=1e-5)


def test_adapter_and_oracle_match_jax():
    args = _inputs(4, 2, 3, 40, 16)
    r, k, v, w = (x.transpose(0, 2, 1, 3) for x in args[:4])   # (b, t, h, d)
    u, s0 = args[4:]
    want_o, want_s = jax_chunked(r, k, v, w, u, s0, chunk=16, interpret=True)
    got_o, got_s = rwkv6_chunked(*_t(r, k, v, w, u, s0), chunk=16)
    assert got_o.shape == (2, 40, 3, 16)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=2e-5, rtol=2e-5)
    ref_o, ref_s = jax_ref(*args)
    o, s = rwkv6_ref(*_t(*args))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("t,chunk", [(50, 16), (64, 64)])
def test_model_scans_match_jax(t, chunk):
    """rwkv_scan_chunked (ragged t padded with w = 1) and rwkv_scan_ref in
    the model layout against the reference's."""
    args = _inputs(5, 2, 2, t, 16)
    r, k, v, w = (x.transpose(0, 2, 1, 3) for x in args[:4])
    u, s0 = args[4:]
    want_o, want_s = jax_rwkv.rwkv_scan_chunked(r, k, v, w, u, s0, chunk=chunk)
    got_o, got_s = R.rwkv_scan_chunked(*_t(r, k, v, w, u, s0), chunk=chunk)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=2e-5, rtol=2e-5)
    ref_o, ref_s = jax_rwkv.rwkv_scan_ref(r, k, v, w, u, s0)
    o, s = R.rwkv_scan_ref(*_t(r, k, v, w, u, s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), atol=2e-5, rtol=2e-5)


def test_dispatch_and_refusals():
    args = _t(*_inputs(6, 1, 2, 20, 8))
    before = K.launches
    o, _ = K.rwkv6_chunked_bhtd(*args)
    assert o.device.type == "cpu" and K.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.rwkv6_cuda(*args)
    r, k, v, w, u, s0 = args
    with pytest.raises(ValueError, match="different devices"):
        K.rwkv6_chunked_bhtd(r, k.to("meta"), v, w, u, s0)
    with pytest.raises(ValueError, match="do not fit r"):
        K.rwkv6_chunked_bhtd(r, k[:, :, :10], v, w, u, s0)
    with pytest.raises(ValueError, match="do not fit"):
        K.rwkv6_chunked_bhtd(r, k, v, w, u[:1], s0)
    with pytest.raises(ValueError, match="4-D"):
        K.rwkv6_chunked_bhtd(r[0], k, v, w, u, s0)
    with pytest.raises(ValueError, match="chunk >= 1"):
        K.rwkv6_chunked_bhtd(r, k, v, w, u, s0, chunk=0)
    # The kernel's chunk tiles: a single short chunk takes the smallest
    # tile that holds it; longer sequences need a tile length.
    assert [K._tile(c, t) for c, t in ((64, 100), (16, 16), (10, 10),
                                       (20, 20), (40, 40))] == [64, 16, 16,
                                                                 32, 64]
    with pytest.raises(ValueError, match="chunk length 48"):
        K._tile(48, 100)


@functools.lru_cache(maxsize=1)
def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only numpy and torch)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("sharpness", [2.0, 6.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_emulated_faults_fail_the_card_tolerance(dtype, sharpness):
    """What chip_smoke.py checks at rwkv6-1.6b's shape, at a small one (20
    chunks of 16, 4 x 12 heads of 16): each faulty output leaves the
    tolerance the kernel is held to, and the plain version carried across
    the same split of chunks stays within it."""
    cs = _chip_smoke()
    atol, rtol = cs.RWKV_TOL[dtype]
    r, k, v, w, u, s0 = _t(*_inputs(21, 4, 12, 320, 16, sharpness))
    args = (r.to(dtype), k.to(dtype), v.to(dtype), w, u, s0)
    want_o, want_s = K.rwkv6_plain(*args, chunk=16)
    split = 16 * 16
    o1, s1 = K.rwkv6_plain(*(x[:, :, :split] for x in args[:4]), u, s0,
                           chunk=16)
    o2, s2 = K.rwkv6_plain(*(x[:, :, split:] for x in args[:4]), u, s1,
                           chunk=16)
    assert cs.tol_ratio(torch.cat([o1, o2], dim=2), want_o,
                        [(atol, rtol)]) <= 1.0
    assert cs.tol_ratio(s2, want_s, [(1e-4, 1e-4)]) <= 1.0
    wrong = cs.wrong_rwkv6(K, args, 16)
    assert len(wrong) == 3
    for what, (bad_o, bad_s) in wrong.items():
        assert bad_o.dtype == dtype and bad_o.shape == want_o.shape, what
        assert cs.tol_ratio(bad_o, want_o, [(atol, rtol)]) > 1.0, what
