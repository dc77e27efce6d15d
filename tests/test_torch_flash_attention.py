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
* the bf16 route's numerics before any card: a copy of the plain loop
  that rounds P to bf16 before P V, as the tensor-core kernel does (its
  128 x 128 tiles, l summed from the f32 P), against the reference's
  Pallas kernel (interpret mode) on bf16 inputs at the bf16 tolerances
  the kernel is held to on the card: atol 2e-2, and atol 4e-3 with rtol
  1.6e-2 (two bf16 steps);
* the routes by dtype (bf16 to the tensor-core kernel, f32 to the
  CUDA-core one), and the TMA layout checker: it takes the model
  layout's views at every head dim and refuses a stride or base address
  that is not a multiple of 16 bytes;
* the build table lists every CUDA source of the package, and a
  library's name follows the headers beside its source.

The kernel itself is held to the plain version on a card by
tests/test_torch_cuda.py (marker ``cuda``) and by ``chip_smoke.py``.
"""

import shutil

import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _plain_bf16_p(q, k, v, *, scale, causal=True, window=None, block_kv=512,
                  tile=128):
    """The plain loop as the tensor-core kernel computes it: 128 x 128
    tiles, P rounded to bf16 before P V, l summed from the f32 P."""
    b, h, kvh, sq, skv, hd, skv_pad = K._check(q, k, v, causal, window,
                                               block_kv)
    groups = h // kvh
    kf = F.pad(k.float(), (0, 0, 0, skv_pad - skv)).repeat_interleave(groups, 1)
    vf = F.pad(v.float(), (0, 0, 0, skv_pad - skv)).repeat_interleave(groups, 1)
    outs = []
    for q0 in range(0, sq, tile):
        q_blk = q[:, :, q0:q0 + tile].float()
        q_pos = q0 + torch.arange(q_blk.shape[2])[:, None]
        m = torch.full((b, h, q_blk.shape[2], 1), K.NEG_INF)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, q_blk.shape[2], hd))
        for k0 in range(0, skv_pad, tile):
            k_blk, v_blk = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
            k_pos = k0 + torch.arange(k_blk.shape[2])[None, :]
            mask = torch.ones((q_blk.shape[2], k_blk.shape[2]), dtype=torch.bool)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= (q_pos - k_pos) < window
            if not mask.any():
                continue  # a tile the kernel does not visit
            s = torch.where(mask, q_blk @ k_blk.transpose(-1, -2) * scale,
                            K.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(torch.bfloat16).float() @ v_blk
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30))
    return torch.cat(outs, dim=2).to(q.dtype)


@pytest.mark.parametrize("name", ["mha", "gqa", "mqa", "3-block", "ragged-q",
                                  "hd80", "window48"])
def test_bf16_p_rounding_within_tolerance_of_jax_kernel(name):
    """The one new rounding of the bf16 route (P to bf16 before P V) keeps
    it within the bf16 tolerances of the reference."""
    import jax.numpy as jnp

    window = None
    if name == "window48":
        name, window = "3-block", 48
    b, h, kvh, s, hd, bq, bkv = SHAPES[name]
    q, k, v = _qkv(10, b, h, kvh, s, hd)
    want = jax_bhsd(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                    scale=hd**-0.5, window=window, block_q=bq, block_kv=bkv,
                    interpret=True)
    got = _plain_bf16_p(*_t(q, k, v, dtype=torch.bfloat16), scale=hd**-0.5,
                        window=window, block_kv=bkv)
    assert got.dtype == torch.bfloat16
    for atol, rtol in ((2e-2, 0), (4e-3, 1.6e-2)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=atol, rtol=rtol)


def test_routes_by_dtype():
    assert K.ROUTES == {torch.bfloat16: "flash_attention_tc",
                        torch.float32: "flash_attention"}
    assert set(K.ROUTES.values()) <= set(_build.KERNELS)


@pytest.mark.parametrize("hd", K.HEAD_DIMS)
@pytest.mark.parametrize("h,kvh", [(16, 16), (24, 2), (8, 1)])
def test_tma_layout_takes_model_layout_views(hd, h, kvh):
    """The views ops.py passes: (b, h, s, hd) transposes of (b, s, h, hd)
    storage, dims ordered by stride (hd, h, s, b), none copied."""
    b, s = 2, 300
    for heads in (h, kvh):
        x = torch.zeros((b, s, heads, hd), dtype=torch.bfloat16).transpose(1, 2)
        axes, sizes, strides = (K.tma_layout(x, "q")[i:i + 3]
                                for i in (0, 3, 6))
        if heads > 1:
            assert axes == [1, 2, 0]  # head, seq, batch
            assert strides == [2 * hd, 2 * heads * hd, 2 * s * heads * hd]
        else:  # a single head is never stepped: its stride goes last
            assert axes == [2, 0, 1] and strides[:2] == [2 * hd, 2 * s * hd]
        assert sorted(zip(axes, sizes)) == [(0, b), (1, heads), (2, s)]
        assert all(st % 16 == 0 for st in strides)
    contiguous = torch.zeros((b, h, s, hd), dtype=torch.bfloat16)
    assert K.tma_layout(contiguous, "k")[:3] == [2, 1, 0]


def test_tma_layout_refuses_misaligned_strides_and_bases():
    # A seq stride of 68 bf16 (136 bytes): rows of two heads of 32 and 4
    # elements of padding.
    x = torch.zeros((1, 64, 68), dtype=torch.bfloat16)[..., :64]
    x = x.unflatten(-1, (2, 32)).transpose(1, 2)
    with pytest.raises(ValueError, match=r"q: seq stride 68 elements \(136 "
                                         r"bytes\) is not a multiple of 16"):
        K.tma_layout(x, "q")
    y = torch.zeros(1 + 2 * 64 * 32, dtype=torch.bfloat16)[1:].view(1, 2, 64, 32)
    with pytest.raises(ValueError, match="k: base address .* not a multiple "
                                         "of 16 bytes"):
        K.tma_layout(y, "k")


def test_lib_path_follows_headers_beside_the_source(tmp_path, monkeypatch):
    """An edited header rebuilds: the library's name hashes the headers in
    the kernel's csrc/ directory, but not the other sources there, which
    are libraries of their own (a copy here; the tree is not touched)."""
    rel = "kernels/flash_attention/csrc"
    shutil.copytree(_build.PKG / rel, tmp_path / rel)
    monkeypatch.setattr(_build, "PKG", tmp_path)
    tc, f32 = _build.lib_path("flash_attention_tc"), _build.lib_path(
        "flash_attention")
    assert tc == _build.lib_path("flash_attention_tc")
    sibling = tmp_path / rel / "flash_attention.cu"
    sibling.write_text(sibling.read_text() + "\n// edited\n")
    assert _build.lib_path("flash_attention_tc") == tc
    assert _build.lib_path("flash_attention") != f32
    header = tmp_path / rel / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.lib_path("flash_attention_tc") != tc
