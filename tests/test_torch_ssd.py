"""The Mamba2 SSD scan in the port (repro_torch.kernels.ssd, the kernel K4
beside its plain version, and the scans of repro_torch.models.ssd)
against the JAX reference (repro.kernels.ssd, repro.models.ssd).

Inputs are drawn with numpy as tests/test_kernels.py draws them: normal
x, B, C; dt = softplus(N); decays a = exp(-exp(N - 1 + sharpen) dt); s0
at 0.1 N.

* The plain version against the reference's Pallas kernel in interpret
  mode on the four shapes of tests/test_kernels.py (the ragged t = 70 and
  t = 100 included), f32 at atol = rtol = 2e-5 (products summed in
  another order than XLA's); both against the oracle at the reference's
  own tolerances (atol = rtol = 1e-3 for y, atol 1e-4 and rtol 1e-3 for
  the state).
* Slices of p through either gives the slices of the whole call: the
  columns of p are independent, the property the kernel's split rests on.
* Strong decays (a down to ~1e-27 within a chunk) at chunk 16, against
  the Pallas kernel and the oracle at the same tolerances; decays of 0
  stay finite and near the oracle.
* bf16 x/B/C with f32 dt/a: y is bf16 and agrees with the Pallas
  kernel's within one bf16 rounding (atol = rtol = 2e-2).
* Two chunked calls carrying the state equal one long call; f64 inputs
  are computed in f64.
* The model-layout adapter, the port's ``ssd_scan_chunked`` and
  ``ssd_scan_ref`` against the reference's.
* The dispatch and the refusals.

The kernel itself is held to the plain version on a card by
tests/test_torch_cuda.py (marker ``cuda``) and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.kernel import ssd_chunked_bhtp as jax_bhtp
from repro.kernels.ssd.ops import ssd_chunked as jax_chunked
from repro.kernels.ssd.ref import ssd_ref as jax_ref
from repro.models import ssd as jax_ssd
from repro_torch.kernels.ssd import kernel as K
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.kernels.ssd.ref import ssd_ref
from repro_torch.models import ssd as M

SHAPES = {  # b, h, t, p, n, chunk  (tests/test_kernels.py)
    "tiny": (1, 1, 32, 8, 8, 16),
    "3-chunk-t100": (2, 3, 100, 16, 8, 32),
    "one-chunk": (1, 2, 64, 32, 16, 64),
    "ragged-t70": (1, 2, 70, 16, 8, 32),
}


def _softplus(v):
    return np.maximum(v, 0) + np.log1p(np.exp(-np.abs(v)))


def _inputs(seed, b, h, t, p, n, sharpen=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, t, p))
    dt = _softplus(rng.standard_normal((b, h, t)))
    a = np.exp(-np.exp(rng.standard_normal((b, h, t)) - 1.0 + sharpen) * dt)
    B = rng.standard_normal((b, t, n))
    C = rng.standard_normal((b, t, n))
    s0 = 0.1 * rng.standard_normal((b, h, p, n))
    return tuple(v.astype(np.float32) for v in (x, dt, a, B, C, s0))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(v)) for v in arrays]


def _close_to_oracle(y, s, args):
    y_r, s_r = ssd_ref(*_t(*args))
    np.testing.assert_allclose(np.asarray(y), y_r.numpy(), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(np.asarray(s), s_r.numpy(), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("name", list(SHAPES))
def test_plain_matches_jax_kernel_and_oracle(name):
    b, h, t, p, n, chunk = SHAPES[name]
    args = _inputs(0, b, h, t, p, n)
    want_y, want_s = jax_bhtp(*args, chunk=chunk, interpret=True)
    got_y, got_s = K.ssd_chunked_bhtp(*_t(*args), chunk=chunk)
    assert got_y.shape == (b, h, t, p) and got_y.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=2e-5, rtol=2e-5)
    _close_to_oracle(got_y, got_s, args)
    _close_to_oracle(want_y, want_s, args)


def test_p_slices_are_independent():
    """The property K4's split rests on: column pp of y and row pp of the
    state depend only on column pp of x and row pp of s0.  Each 16-column
    slice of x and s0, through the reference's Pallas kernel and through
    the plain version, gives that slice of the whole call (ragged t = 70
    over three chunks)."""
    b, h, t, p, n, chunk = 1, 2, 70, 32, 8, 32
    x, dt, a, B, C, s0 = _inputs(10, b, h, t, p, n)
    routes = {
        "pallas": lambda x, s0: tuple(np.asarray(v) for v in jax_bhtp(
            x, dt, a, B, C, s0, chunk=chunk, interpret=True)),
        "plain": lambda x, s0: tuple(v.numpy() for v in K.ssd_plain(
            *_t(x, dt, a, B, C, s0), chunk=chunk)),
    }
    whole = {name: route(x, s0) for name, route in routes.items()}
    for name, route in routes.items():
        parts = [route(x[..., c:c + 16], s0[:, :, c:c + 16])
                 for c in range(0, p, 16)]
        y = np.concatenate([part[0] for part in parts], axis=3)
        s = np.concatenate([part[1] for part in parts], axis=2)
        for want_y, want_s in whole.values():
            np.testing.assert_allclose(y, want_y, atol=2e-5, rtol=2e-5)
            np.testing.assert_allclose(s, want_s, atol=2e-5, rtol=2e-5)


def test_strong_decays_match_jax_kernel_and_oracle():
    """Decays down to ~1e-27 at chunk 16 (above the 1e-38 clamp): above the
    diagonal the ratio exp(cum_i - cum_j) overflows to inf in f32, so the
    mask must select, not multiply (inf * 0 is NaN)."""
    args = _inputs(1, 1, 2, 128, 16, 8, sharpen=1.5)
    assert 1e-38 < args[2].min() < 1e-20
    want_y, want_s = jax_bhtp(*args, chunk=16, interpret=True)
    got_y, got_s = K.ssd_plain(*_t(*args), chunk=16)
    assert bool(torch.isfinite(got_y).all()) and bool(torch.isfinite(got_s).all())
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=2e-5, rtol=2e-5)
    _close_to_oracle(got_y, got_s, args)


def test_decays_below_the_clamp_stay_finite():
    """Decays of 0 and subnormals (a < 1e-38): the plain version keeps the
    subnormal clamp (log 1e-38 = -87.5) and stays finite and within the
    oracle's tolerance.  The reference's Pallas kernel on the CPU gives
    NaN here, because XLA flushes the clamp to zero (log 0 = -inf and
    -inf - -inf); ROADMAP Queue 3."""
    args = _inputs(1, 1, 2, 128, 16, 8, sharpen=2.5)
    assert args[2].min() == 0.0
    got_y, got_s = K.ssd_plain(*_t(*args), chunk=16)
    assert bool(torch.isfinite(got_y).all()) and bool(torch.isfinite(got_s).all())
    _close_to_oracle(got_y, got_s, args)


def test_bf16_xbc_with_f32_decays():
    b, h, t, p, n, chunk = SHAPES["ragged-t70"]
    x, dt, a, B, C, s0 = _inputs(2, b, h, t, p, n)
    bf = lambda v: jnp.asarray(v, jnp.bfloat16)
    want_y, want_s = jax_bhtp(bf(x), dt, a, bf(B), bf(C), s0, chunk=chunk,
                              interpret=True)
    xt, Bt, Ct = (v.to(torch.bfloat16) for v in _t(x, B, C))
    got_y, got_s = K.ssd_chunked_bhtp(xt, *_t(dt, a), Bt, Ct, *_t(s0),
                                      chunk=chunk)
    assert got_y.dtype == torch.bfloat16 and got_s.dtype == torch.float32
    np.testing.assert_allclose(got_y.float().numpy(),
                               np.asarray(want_y.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=2e-5, rtol=2e-5)
    # The same as f32 inputs holding the bf16 values (cast inside).
    f_y, f_s = K.ssd_plain(xt.float(), *_t(dt, a), Bt.float(), Ct.float(),
                           *_t(s0), chunk=chunk)
    assert torch.equal(got_y, f_y.to(torch.bfloat16)) and torch.equal(got_s, f_s)


def test_state_carries_across_calls():
    """Two chunked calls == one long call (streaming parity)."""
    x, dt, a, B, C, s0 = _t(*_inputs(3, 1, 2, 96, 16, 8))
    full, s_full = K.ssd_plain(x, dt, a, B, C, s0, chunk=16)
    half = 48
    y1, s1 = K.ssd_plain(x[:, :, :half], dt[:, :, :half], a[:, :, :half],
                         B[:, :half], C[:, :half], s0, chunk=16)
    y2, s2 = K.ssd_plain(x[:, :, half:], dt[:, :, half:], a[:, :, half:],
                         B[:, half:], C[:, half:], s1, chunk=16)
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), full,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(s2, s_full, atol=1e-5, rtol=1e-5)


def test_plain_computes_f64_inputs_in_f64():
    """The f64 yardstick chip_smoke.py holds the f32 sums to: f64 in, f64
    out, and the f32 result within its rounding."""
    args = _t(*_inputs(9, 1, 2, 70, 16, 8))
    y32, s32 = K.ssd_plain(*args, chunk=32)
    y64, s64 = K.ssd_plain(*(v.double() for v in args), chunk=32)
    assert y64.dtype == s64.dtype == torch.float64
    torch.testing.assert_close(y32, y64.float(), atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(s32, s64.float(), atol=1e-5, rtol=1e-5)


def test_adapter_and_oracle_match_jax():
    args = _inputs(4, 2, 3, 40, 16, 8)
    x = args[0].transpose(0, 2, 1, 3)                    # (b, t, h, p)
    dt, a = (v.transpose(0, 2, 1) for v in args[1:3])    # (b, t, h)
    B, C, s0 = args[3:]
    want_y, want_s = jax_chunked(x, dt, a, B, C, s0, chunk=16, interpret=True)
    got_y, got_s = ssd_chunked(*_t(x, dt, a, B, C, s0), chunk=16)
    assert got_y.shape == (2, 40, 3, 16)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=2e-5, rtol=2e-5)
    ref_y, ref_s = jax_ref(*args)
    y, s = ssd_ref(*_t(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("t,chunk", [(50, 16), (64, 64)])
def test_model_scans_match_jax(t, chunk):
    """ssd_scan_chunked (ragged t padded with a = 1) and ssd_scan_ref in
    the model layout against the reference's."""
    args = _inputs(5, 2, 2, t, 16, 8)
    x = args[0].transpose(0, 2, 1, 3)
    dt, a = (v.transpose(0, 2, 1) for v in args[1:3])
    B, C, s0 = args[3:]
    want_y, want_s = jax_ssd.ssd_scan_chunked(x, dt, a, B, C, s0, chunk=chunk)
    got_y, got_s = M.ssd_scan_chunked(*_t(x, dt, a, B, C, s0), chunk=chunk)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s),
                               atol=2e-5, rtol=2e-5)
    ref_y, ref_s = jax_ssd.ssd_scan_ref(x, dt, a, B, C, s0)
    y, s = M.ssd_scan_ref(*_t(x, dt, a, B, C, s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(ref_s), atol=2e-5, rtol=2e-5)


def test_softplus_and_conv_match_jax():
    """softplus by jax.nn.softplus's formula: within 2 ulp (exp and log1p
    differ in their last bit between XLA and ATen)."""
    import jax

    v = np.linspace(-30.0, 30.0, 241, dtype=np.float32)
    np.testing.assert_allclose(M.softplus(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.nn.softplus(v)), rtol=2.4e-7,
                               atol=0)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    w = rng.standard_normal((M.CONV_K, 6)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, M.CONV_K - 1, 6)).astype(np.float32)
    want_y, want_s = jax_ssd.causal_conv(x, w, bias, st)
    got_y, got_s = M.causal_conv(*_t(x, w, bias, st))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-6)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))


def test_kernel_reads_aligned_inputs_in_place_and_copies_the_rest():
    """The kernel's 16-byte loads need 16-byte aligned rows: the wrapper
    passes such a tensor as it is and gives it a contiguous copy
    otherwise."""
    x = torch.zeros(2, 3, 40, 16, dtype=torch.bfloat16)
    view = x.transpose(1, 2).transpose(1, 2)        # the same strides
    assert K._aligned(view) is view
    shifted = x.reshape(-1)[1:1 + 2 * 3 * 40 * 8].view(2, 3, 40, 8)
    rows24 = torch.zeros(2, 3, 40, 12, dtype=torch.bfloat16)[..., :8]
    for v in (shifted, rows24):
        got = K._aligned(v)
        assert got is not v and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, v)


def test_dispatch_and_refusals():
    args = _t(*_inputs(6, 1, 2, 20, 8, 8))
    before = K.launches
    y, _ = K.ssd_chunked_bhtp(*args)
    assert y.device.type == "cpu" and K.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.ssd_cuda(*args)
    x, dt, a, B, C, s0 = args
    with pytest.raises(ValueError, match="different devices"):
        K.ssd_chunked_bhtp(x, dt.to("meta"), a, B, C, s0)
    with pytest.raises(ValueError, match="do not fit x"):
        K.ssd_chunked_bhtp(x, dt[:, :, :10], a, B, C, s0)
    with pytest.raises(ValueError, match="do not fit"):
        K.ssd_chunked_bhtp(x, dt, a, B[:, :5], C, s0)
    with pytest.raises(ValueError, match="s0"):
        K.ssd_chunked_bhtp(x, dt, a, B, C, s0[:, :1])
    with pytest.raises(ValueError, match="4-D"):
        K.ssd_chunked_bhtp(x[0], dt, a, B, C, s0)
    with pytest.raises(ValueError, match="chunk >= 1"):
        K.ssd_chunked_bhtp(x, dt, a, B, C, s0, chunk=0)
