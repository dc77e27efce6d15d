"""Flash attention in the port (repro_torch.kernels.flash_attention, the
kernel K2 beside its plain version) against the JAX reference
(repro.kernels.flash_attention).

* on the CPU: the plain version against the reference's Pallas kernel in
  interpret mode on shapes of tests/test_kernels.py (MHA, GQA 2:1, MQA,
  3 blocks, ragged q), head dim 80 (zamba2's) and a window, f32 at
  atol=rtol=2e-5 (the sums run in another order than XLA's; the
  reference's own tests hold its kernel to its oracle at the same
  tolerance), one bf16 case at atol 2e-2 (one bf16
  rounding of the output); a causal call with more queries than keys
  (80 against 48, ragged: the reference's zero-padded keys count); the
  ported oracle against the reference's;
  the model-layout adapter; the dispatch and the refusals;
* the build table lists every CUDA source of the package.

The kernel itself is held to the plain version on a card by
tests/test_torch_cuda.py (marker ``cuda``) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_bhsd as jax_bhsd
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro_torch import _build
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention.ops import (
    flash_attention,
    flash_attention_reference,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

SHAPES = {  # b, h, kvh, s, hd, block_q, block_kv  (tests/test_kernels.py)
    "mha": (1, 2, 2, 64, 32, 32, 32),
    "gqa": (2, 4, 2, 128, 64, 64, 32),
    "mqa": (1, 8, 1, 128, 32, 32, 64),
    "3-block": (2, 2, 2, 96, 32, 32, 32),
    "ragged-q": (1, 2, 2, 80, 32, 32, 32),
    "hd80": (1, 4, 2, 96, 80, 32, 32),   # zamba2's head dim (2560 / 32)
}


def _qkv(seed, b, h, kvh, s, hd, skv=None, dtype=np.float32):
    rng = np.random.default_rng(seed)
    skv = skv or s
    return (rng.standard_normal((b, h, s, hd)).astype(dtype),
            rng.standard_normal((b, kvh, skv, hd)).astype(dtype),
            rng.standard_normal((b, kvh, skv, hd)).astype(dtype))


def _t(*arrays, device="cpu", dtype=torch.float32):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


@pytest.mark.parametrize("name", ["mha", "gqa", "mqa", "3-block", "ragged-q",
                                  "hd80"])
def test_plain_matches_jax_kernel(name):
    b, h, kvh, s, hd, bq, bkv = SHAPES[name]
    q, k, v = _qkv(0, b, h, kvh, s, hd)
    want = np.asarray(jax_bhsd(q, k, v, scale=hd**-0.5, block_q=bq,
                               block_kv=bkv, interpret=True))
    got = K.flash_attention_bhsd(*_t(q, k, v), scale=hd**-0.5, block_q=bq,
                                 block_kv=bkv)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_plain_matches_jax_kernel_sliding_window():
    q, k, v = _qkv(1, 1, 2, 2, 128, 32)
    want = np.asarray(jax_bhsd(q, k, v, scale=32**-0.5, window=48,
                               block_q=32, block_kv=32, interpret=True))
    got = K.flash_attention_plain(*_t(q, k, v), scale=32**-0.5, window=48,
                                  block_q=32, block_kv=32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_plain_matches_jax_kernel_more_queries_than_keys():
    q, k, v = _qkv(9, 1, 4, 2, 80, 32, skv=48)
    want = np.asarray(jax_bhsd(q, k, v, scale=32**-0.5, block_q=32,
                               block_kv=32, interpret=True))
    got = K.flash_attention_plain(*_t(q, k, v), scale=32**-0.5, block_q=32,
                                  block_kv=32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_plain_matches_jax_kernel_bf16():
    import jax.numpy as jnp

    q, k, v = _qkv(2, 1, 2, 2, 64, 32)
    want = jax_bhsd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                    scale=32**-0.5, block_q=32, block_kv=32, interpret=True)
    got = K.flash_attention_plain(*_t(q, k, v, dtype=torch.bfloat16),
                                  scale=32**-0.5, block_q=32, block_kv=32)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=2e-2)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None), (False, 40)])
def test_ported_oracle_matches_jax_oracle(causal, window):
    q, k, v = _qkv(3, 2, 4, 2, 48, 16)
    want = np.asarray(jax_ref(q, k, v, scale=0.3, causal=causal, window=window))
    got = attention_ref(*_t(q, k, v), scale=0.3, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None), (False, 40)])
def test_plain_matches_ported_oracle(causal, window):
    """Multi-block, non-causal and windowed calls the reference's kernel
    tests do not make, held to the oracle."""
    q, k, v = _qkv(4, 2, 4, 2, 64, 32)
    args = _t(q, k, v)
    want = attention_ref(*args, scale=0.2, causal=causal, window=window)
    got = K.flash_attention_plain(*args, scale=0.2, causal=causal,
                                  window=window, block_q=16, block_kv=32)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


def test_adapter_matches_jax_adapter():
    q, k, v = (x.transpose(0, 2, 1, 3) for x in _qkv(5, 2, 4, 2, 40, 32))
    want = np.asarray(jax_flash(q, k, v, scale=0.25, block_q=16, block_kv=16,
                                interpret=True))
    got = flash_attention(*_t(q, k, v), scale=0.25, block_q=16, block_kv=16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)
    ref = flash_attention_reference(*_t(q, k, v), scale=0.25)
    torch.testing.assert_close(got, ref, atol=2e-5, rtol=2e-5)


def test_dispatch_and_refusals():
    q, k, v = _t(*_qkv(6, 1, 2, 2, 40, 32))
    before = K.launches
    out = K.flash_attention_bhsd(q, k, v, scale=0.1, block_q=16, block_kv=16)
    assert out.device.type == "cpu" and K.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.flash_attention_cuda(q, k, v, scale=0.1)
    with pytest.raises(ValueError, match="non-causal padding"):
        K.flash_attention_bhsd(q, k, v, scale=0.1, causal=False, block_kv=16)
    with pytest.raises(ValueError, match="multiple of"):
        K.flash_attention_bhsd(q, k[:, :1].expand(1, 3, 40, 32).contiguous(),
                               v[:, :1].expand(1, 3, 40, 32).contiguous(),
                               scale=0.1)
    with pytest.raises(ValueError, match="window"):
        K.flash_attention_bhsd(q, k, v, scale=0.1, window=0)


def test_build_table_lists_every_cuda_source():
    listed = {(_build.PKG / rel).resolve() for rel, _ in _build.KERNELS.values()}
    on_disk = {p.resolve() for p in _build.PKG.rglob("csrc/*.cu")}
    assert listed == on_disk
    assert _build.KERNELS["waterfill"][1] == ("-fmad=false",)
    paths = {_build.lib_path(name) for name in _build.KERNELS}
    assert len(paths) == len(_build.KERNELS)
    assert all(p.parent == _build.BUILD_DIR for p in paths)
