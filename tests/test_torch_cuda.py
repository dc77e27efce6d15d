"""The port's kernels on a card (marker ``cuda``; every test skips
without a CUDA device).

This file imports neither JAX nor the reference, so it runs on a GPU host
that has only the port's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

* K2 (flash attention) against its plain version on the shapes of
  tests/test_kernels.py, f32 (the CUDA-core kernel) at atol=rtol=2e-5
  and bf16 (the tensor-core kernel) at atol 2e-2 and at atol 4e-3 with
  rtol 1.6e-2 (two bf16 steps; the plain version is held to the
  reference on the CPU in tests/test_torch_flash_attention.py), with
  bitwise-equal reruns and the launch counters (``launches`` for both
  routes, ``launches_tc`` for the bf16 one); windows 16/48/100 over one
  128-row kv tile and 300 over eight, with strided (transposed) inputs,
  f32 and bf16; non-causal calls with ragged queries; a causal call with
  more queries than keys; head dim 64 with 24 -> 8 heads at
  granite-moe-3b's (4, 24, 4096, 64); besides the elementwise bounds, the
  relative error of every output row of every head within chip_smoke.py's
  ``FLASH_ROW_REL`` (1e-4 f32, 1.6e-2 bf16); a bf16 tensor whose seq
  stride is not a multiple of 16 bytes is refused, with no copy and no
  other route;
* the serving prefill with K2 against the non-flash path, f32, 1e-4;
* the MoE layer (granite's routing: 40 experts, top-8; llama4's: top-1
  with a shared expert) on the card against the same call on the CPU,
  f32: the same experts and kept set, outputs within 1e-5;
* K3 (the RWKV6 WKV scan) against its plain version on the shapes of
  tests/test_kernels.py, strong decays at chunk 16, a ragged 16-chunk scan
  over 16 (batch, head) rows (each chunk's state handed from block to
  block 15 times) and rwkv6-1.6b's (4, 32, 4096, 64) with the model's
  decays (sharpness 6, w ~ 0.9975), f32 output and
  state at atol = rtol = 1e-4 and bf16 r/k/v at atol = rtol = 2e-2 (one
  bf16 rounding of the output is relative; the plain
  version is held to the reference on the CPU in
  tests/test_torch_rwkv6.py), with bitwise-equal reruns and the launch
  counter; the model layout's strided views; the refusals;
* the rwkv6 SMOKE prefill with K3 against the chunked-scan route, f32,
  1e-4;
* K2 at head dim 80 (zamba2's shared attention), at a small shape and at
  zamba2's (4, 32, 4096, 80);
* K4 (the Mamba2 SSD scan) against its plain version on the shapes of
  tests/test_kernels.py, strong decays at chunk 16, a short single chunk,
  p = n = 64, a ragged scan over 33 chunks with 5 heads (each chunk's
  state handed from block to block 32 times), and p = 8 at n = 64, f32 y
  and state at atol = rtol = 1e-4 and bf16 x/B/C at atol = rtol = 2e-2
  (the plain version is held to the reference on the CPU in
  tests/test_torch_ssd.py); the 33-chunk case, whose y reaches ~170, holds
  y at 1e-4 of max |y| as chip_smoke.py does at the model shapes, and its
  f32 error against the plain version in f64 to twice the plain version's
  own; bitwise-equal reruns and the launch counter; the model layout's
  strided views; the refusals;
* the zamba2 SMOKE prefill (head dim 32, so that K2 takes it) with K4
  and K2 against the plain routes, f32, 1e-4;
* K1 (the water-fill) against its plain version, bitwise: single calls
  and pairs (both phases of a cell step in one launch, through the
  checked entry and through ``launch_pair``) at widths 8 ... 5120 (the
  warp route up to 256 lanes, the block route above), B = 1 rows at 8,
  128 and 1024, and rows whose guard is false at entry (no live lane, no
  free slot); bitwise reruns and one launch per call or pair (the plain
  version is held to the reference on the CPU in
  tests/test_torch_waterfill.py);
* the projection kernel (the processor-sharing finish-time projection of
  the discrete-event path's virtual cluster) against its plain version,
  bitwise, on ``chip_smoke.py``'s cases (``project_cases``: B = 1 at
  widths 8, 256, 1024 and 5120, the last in segments with host
  compaction; batches with ``n_valid``; rows of only infinite-size jobs,
  of zero weights and resumed at a level; a width that is not a bucket
  width; rows stopped at a floor; a row of only infinite-size jobs, a
  row whose jobs all finish in one event, ragged widths 33, 257 and
  1025, B = 3 rows of different live counts, rows with lanes not
  present, of no work and of zero weight), with bitwise reruns and one
  launch per call; its one-launch segmented route against the
  host-segmented plain path (``project_segmented_cases``: widths 1024,
  2048 and 5120, B = 2 rows), every output bitwise, and
  ``vcluster_torch.project_finish_times`` on the card at 1024, 2048 and
  5120 jobs: one call, one launch, the bits of its host segment loop on
  the CPU (the plain versions are held to the reference on the CPU in
  tests/test_torch_vcluster.py);
* one accel batch of the sweep worker (``run_worker(compute="accel")``)
  on the card: one K1 launch per step of the hfsp batch, and the stored
  reports equal (wall aside) to a direct run with K1's plain version;
* the model kernels' wrappers (K2, K3, K4) refuse inputs that require
  grad while grad mode is on (``KernelInputError``: they have no
  backward) and run under ``torch.no_grad()``, launching once;
* a train step of the olmo, rwkv6, zamba2, granite-moe and whisper
  SMOKE configs on the card launches
  no model kernel, and two steps from one state give the same bits.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.accel import waterfill as wf
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.rwkv6 import kernel as K3
from repro_torch.kernels.rwkv6.ops import rwkv6_chunked
from repro_torch.kernels.ssd import kernel as K4
from repro_torch.kernels.ssd.ops import ssd_chunked
from repro_torch.models import init_model
from repro_torch.serve import make_prefill_step

SHAPES = {  # b, h, kvh, sq, skv, hd, block_q, block_kv
    "mha": (1, 2, 2, 64, 64, 32, 32, 32),
    "gqa": (2, 4, 2, 128, 128, 64, 64, 32),
    "mqa": (1, 8, 1, 128, 128, 32, 32, 64),
    "3-block": (2, 2, 2, 96, 96, 32, 32, 32),
    "ragged-q": (1, 2, 2, 80, 80, 32, 32, 32),
    "sq>skv": (1, 4, 2, 80, 48, 128, 32, 32),
    "hd80": (1, 4, 2, 96, 96, 80, 32, 32),
    "zamba2-hd80": (4, 32, 32, 4096, 4096, 80, 512, 512),
    "granite-hd64-gqa3": (4, 24, 8, 4096, 4096, 64, 512, 512),
}


#: dtype -> the (atol, rtol) pairs K2 must meet against its plain version
#: (as chip_smoke.py's FLASH_TOL): bf16 rounds P before P V and rounds
#: the output once.
TOLS = {torch.float32: ((2e-5, 2e-5),),
        torch.bfloat16: ((2e-2, 0.0), (4e-3, 1.6e-2))}


def _assert_within(got, want):
    for atol, rtol in TOLS[want.dtype]:
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    rel = SMOKE.FLASH_ROW_REL[want.dtype]
    ratio, where = SMOKE.row_rel_ratio(got, want, rel)
    assert ratio <= 1.0, (f"a row of (batch, head) {where} is {ratio} of "
                          f"the relative bound {rel}")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _qkv(seed, b, h, kvh, sq, skv, hd, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(device=device, dtype=dtype)
            for shape in ((b, h, sq, hd), (b, kvh, skv, hd), (b, kvh, skv, hd))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_plain_version_on_card(cuda, name, dtype, atol):
    """``atol`` names the case; :data:`TOLS` holds every bound."""
    b, h, kvh, sq, skv, hd, bq, bkv = SHAPES[name]
    q, k, v = _qkv(7, b, h, kvh, sq, skv, hd, cuda, dtype)
    kw = dict(scale=hd**-0.5, block_q=bq, block_kv=bkv)
    before, before_tc = K.launches, K.launches_tc
    got = K.flash_attention_cuda(q, k, v, **kw)
    again = K.flash_attention_cuda(q, k, v, **kw)
    want = K.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K.launches == before + 2
    assert K.launches_tc == before_tc + (2 if dtype == torch.bfloat16 else 0)
    assert torch.equal(got, again)
    _assert_within(got, want)


#: window -> (seq length, block): windows inside one 128-row kv tile of
#: the tensor-core kernel, and one over eight tiles, whose q tiles skip
#: the whole tiles before their window.
WINDOWS = {16: (128, 32), 48: (128, 32), 100: (128, 32), 300: (1024, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_kernel_window_and_strided_inputs_on_card(cuda, window, dtype, atol):
    s, block = WINDOWS[window]
    q, k, v = _qkv(8, 2, 4, 2, s, s, 64, cuda, dtype)
    kw = dict(scale=0.125, window=window, block_q=block, block_kv=block)
    want = K.flash_attention_plain(q, k, v, **kw)
    got = K.flash_attention_cuda(q, k, v, **kw)
    # The same tensors as transposed views of (b, s, h, hd) storage.
    qs, ks, vs = (x.transpose(1, 2).contiguous().transpose(1, 2)
                  for x in (q, k, v))
    strided = K.flash_attention_cuda(qs, ks, vs, **kw)
    torch.cuda.synchronize()
    _assert_within(got, want)
    assert torch.equal(got, strided)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,skv", [(384, 384), (200, 384)])
def test_kernel_non_causal_on_card(cuda, dtype, sq, skv):
    """Every key for every query, over three 128-row kv tiles; 200 queries
    leave the last q tile ragged."""
    q, k, v = _qkv(13, 1, 4, 2, sq, skv, 64, cuda, dtype)
    kw = dict(scale=0.125, causal=False, block_q=128, block_kv=128)
    before, before_tc = K.launches, K.launches_tc
    got = K.flash_attention_cuda(q, k, v, **kw)
    want = K.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    assert K.launches_tc == before_tc + (dtype == torch.bfloat16)
    _assert_within(got, want)


@pytest.mark.cuda
def test_kernel_refuses_bf16_stride_tma_cannot_read(cuda):
    q, k, v = _qkv(12, 1, 2, 2, 64, 64, 32, cuda, torch.bfloat16)
    # k as a view of (b, s, h * hd + 4) storage: a seq stride of 68
    # elements, 136 bytes.
    padded = torch.zeros((1, 64, 68), dtype=torch.bfloat16, device=cuda)
    padded[..., :64] = k.transpose(1, 2).flatten(-2)
    k_view = padded[..., :64].unflatten(-1, (2, 32)).transpose(1, 2)
    assert torch.equal(k_view, k)
    before, before_tc = K.launches, K.launches_tc
    with pytest.raises(ValueError, match=r"k: seq stride 68 elements \(136 "
                                         r"bytes\) is not a multiple of 16"):
        K.flash_attention_cuda(q, k_view, v, scale=0.1)
    assert (K.launches, K.launches_tc) == (before, before_tc)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(9, 1, 2, 2, 64, 64, 48, cuda)
    with pytest.raises(ValueError, match="head dim 48"):
        K.flash_attention_cuda(q, k, v, scale=0.1)
    q, k, v = _qkv(9, 1, 2, 2, 64, 64, 32, cuda, torch.float16)
    with pytest.raises(TypeError, match="f32 or bf16"):
        K.flash_attention_cuda(q, k, v, scale=0.1)


@pytest.mark.cuda
def test_prefill_with_kernel_matches_plain_on_card(cuda):
    cfg = dataclasses.replace(configs.get_smoke("olmo_1b"), dtype="float32",
                              head_dim=32)
    params = init_model(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    tok = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 80))).to(cuda)
    before = K.launches
    got = make_prefill_step(cfg, use_flash=True)(params, {"tokens": tok})
    assert K.launches == before + cfg.num_layers
    want = make_prefill_step(cfg)(params, {"tokens": tok})
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


#: (case, SMOKE config, overrides): granite's routing at SMOKE width,
#: llama4's (top-1, shared expert), and a capacity factor that drops.
MOE_CASES = {
    "granite-top8": ("granite_moe_3b", dict(num_experts=40, top_k=8)),
    "llama4-top1-shared": ("llama4_scout_17b", {}),
    "granite-cf0.25": ("granite_moe_3b", dict(num_experts=8, top_k=2,
                                              capacity_factor=0.25)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_on_card_matches_cpu(cuda, case):
    from repro_torch.models.moe import init_moe, moe_ffn, route

    name, extra = MOE_CASES[case]
    cfg = dataclasses.replace(configs.get_smoke(name), dtype="float32",
                              **extra)
    p = init_moe(cfg, torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32))
    p_card = {k: (v.to(cuda) if isinstance(v, torch.Tensor)
                  else {n: t.to(cuda) for n, t in v.items()})
              for k, v in p.items()}
    with torch.no_grad():
        got, aux = moe_ffn(cfg, p_card, x.to(cuda))
        want, want_aux = moe_ffn(cfg, p, x)
        r, r_cpu = route(cfg, p_card, x.to(cuda)), route(cfg, p, x)
    assert torch.equal(r.idx.cpu(), r_cpu.idx)
    assert torch.equal(r.keep.cpu(), r_cpu.keep)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=0)


RWKV_SHAPES = {  # b, h, t, d, chunk, decay sharpness
    "tiny": (1, 1, 32, 8, 16, 2.0),
    "3-chunk": (2, 3, 100, 16, 32, 2.0),
    "one-chunk": (1, 2, 64, 32, 64, 2.0),
    "ragged-t65": (2, 2, 65, 16, 32, 2.0),
    "strong-decay": (1, 2, 128, 16, 16, 0.0),
    "short-t10": (1, 2, 10, 64, 64, 2.0),
    "ring-t1000": (2, 8, 1000, 64, 64, 2.0),
    "rwkv6-1.6b-model-decays": (4, 32, 4096, 64, 64, 6.0),
}


def _rwkv(seed, b, h, t, d, sharpness, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    r, k, v = (torch.from_numpy(rng.standard_normal((b, h, t, d))
                                .astype(np.float32)).to(device, dtype)
               for _ in range(3))
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    w = f32(np.exp(-np.exp(rng.standard_normal((b, h, t, d)) - sharpness)))
    return r, k, v, w, f32(0.1 * rng.standard_normal((h, d))), \
        f32(0.1 * rng.standard_normal((b, h, d, d)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", list(RWKV_SHAPES))
def test_rwkv6_kernel_matches_plain_version_on_card(cuda, name, dtype, tol):
    b, h, t, d, chunk, sharp = RWKV_SHAPES[name]
    args = _rwkv(10, b, h, t, d, sharp, cuda, dtype)
    before = K3.launches
    got_o, got_s = K3.rwkv6_cuda(*args, chunk=chunk)
    again_o, again_s = K3.rwkv6_cuda(*args, chunk=chunk)
    want_o, want_s = K3.rwkv6_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert K3.launches == before + 2
    assert torch.equal(got_o, again_o) and torch.equal(got_s, again_s)
    assert got_o.dtype == dtype and got_s.dtype == torch.float32
    torch.testing.assert_close(got_o.float(), want_o.float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_rwkv6_kernel_reads_model_layout_views_on_card(cuda):
    """The adapter's (b, h, t, d) views of (b, t, h, d) storage: the same
    bits as contiguous inputs, output in (b, t, h, d)."""
    r, k, v, w, u, s0 = _rwkv(11, 2, 4, 70, 64, 2.0, cuda)
    want_o, want_s = K3.rwkv6_cuda(r, k, v, w, u, s0)
    bthd = [x.transpose(1, 2).contiguous() for x in (r, k, v, w)]
    got_o, got_s = rwkv6_chunked(*bthd, u, s0)
    torch.cuda.synchronize()
    assert got_o.is_contiguous() and got_o.shape == (2, 70, 4, 64)
    assert torch.equal(got_o, want_o.transpose(1, 2)) and torch.equal(got_s, want_s)


@pytest.mark.cuda
def test_rwkv6_kernel_refuses_what_it_does_not_take(cuda):
    args = _rwkv(12, 1, 2, 40, 48, 2.0, cuda)
    with pytest.raises(ValueError, match="dk = dv"):
        K3.rwkv6_cuda(*args)
    r, k, v, w, u, s0 = _rwkv(12, 1, 2, 100, 16, 2.0, cuda)
    with pytest.raises(ValueError, match="chunk length 48"):
        K3.rwkv6_cuda(r, k, v, w, u, s0, chunk=48)
    with pytest.raises(TypeError, match="f32 w"):
        K3.rwkv6_cuda(r, k, v, w.to(torch.bfloat16), u, s0)
    with pytest.raises(TypeError, match="f32 or bf16"):
        K3.rwkv6_cuda(*(x.half() for x in (r, k, v)), w, u, s0)
    with pytest.raises(ValueError, match="different devices"):
        K3.rwkv6_chunked_bhtd(r, k.cpu(), v, w, u, s0)


@pytest.mark.cuda
def test_rwkv_prefill_with_kernel_matches_chunked_route_on_card(cuda):
    cfg = dataclasses.replace(configs.get_smoke("rwkv6_1b6"), dtype="float32")
    params = init_model(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    tok = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 150))).to(cuda)
    before = K3.launches
    got = make_prefill_step(cfg, use_scan_kernel=True)(params, {"tokens": tok})
    assert K3.launches == before + cfg.num_layers
    want = make_prefill_step(cfg)(params, {"tokens": tok})
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


SSD_SHAPES = {  # b, h, t, p, n, chunk, decay sharpening, at y's scale
    "tiny": (1, 1, 32, 8, 8, 16, 0.0, False),
    "3-chunk-t100": (2, 3, 100, 16, 8, 32, 0.0, False),
    "one-chunk": (1, 2, 64, 32, 16, 64, 0.0, False),
    "ragged-t70": (1, 2, 70, 16, 8, 32, 0.0, False),
    "strong-decay": (1, 2, 128, 16, 8, 16, 1.5, False),
    "short-t10": (1, 2, 10, 64, 64, 64, 0.0, False),
    "p64-n64": (2, 4, 200, 64, 64, 64, 0.0, False),
    "ragged-33-chunks": (2, 5, 2085, 64, 64, 64, 0.0, True),
    "p8-n64": (2, 3, 150, 8, 64, 64, 0.0, False),
}


def _ssd(seed, b, h, t, p, n, sharpen, device, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)
    x = f32(rng.standard_normal((b, h, t, p))).to(dtype)
    raw = rng.standard_normal((b, h, t))
    dt = np.maximum(raw, 0) + np.log1p(np.exp(-np.abs(raw)))
    a = np.exp(-np.exp(rng.standard_normal((b, h, t)) - 1.0 + sharpen) * dt)
    B = f32(rng.standard_normal((b, t, n))).to(dtype)
    C = f32(rng.standard_normal((b, t, n))).to(dtype)
    return x, f32(dt), f32(a), B, C, f32(0.1 * rng.standard_normal((b, h, p, n)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("name", list(SSD_SHAPES))
def test_ssd_kernel_matches_plain_version_on_card(cuda, name, dtype, tol):
    b, h, t, p, n, chunk, sharpen, of_scale = SSD_SHAPES[name]
    args = _ssd(13, b, h, t, p, n, sharpen, cuda, dtype)
    before = K4.launches
    got_y, got_s = K4.ssd_cuda(*args, chunk=chunk)
    again_y, again_s = K4.ssd_cuda(*args, chunk=chunk)
    want_y, want_s = K4.ssd_plain(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert K4.launches == before + 2
    assert torch.equal(got_y, again_y) and torch.equal(got_s, again_s)
    assert got_y.dtype == dtype and got_s.dtype == torch.float32
    y_atol = tol
    if of_scale:
        # As chip_smoke.py's SSD_CASES at the model shapes: y's terms reach
        # ~170 and their f32 sums cancel in small outputs to errors of
        # ~4e-4 in the kernel and the plain version alike, so atol is 1e-4
        # of max |y|; in f32 the kernel must also stay within twice the
        # plain version's own error against the plain version in f64.
        y_atol = max(tol, 1e-4 * want_y.float().abs().max().item())
        if dtype == torch.float32:
            y64, _ = K4.ssd_plain(*(v.double() for v in args), chunk=chunk)
            err_got = (got_y.double() - y64).abs().max().item()
            err_want = (want_y.double() - y64).abs().max().item()
            assert err_got <= 2 * err_want, (err_got, err_want)
    torch.testing.assert_close(got_y.float(), want_y.float(), atol=y_atol,
                               rtol=tol)
    torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_ssd_kernel_reads_model_layout_views_on_card(cuda):
    """The adapter's (b, h, t, *) views of (b, t, h, *) storage: the same
    bits as contiguous inputs, y in (b, t, h, p)."""
    x, dt, a, B, C, s0 = _ssd(14, 2, 4, 70, 64, 64, 0.0, cuda)
    want_y, want_s = K4.ssd_cuda(x, dt, a, B, C, s0)
    to_bt = lambda v: v.transpose(1, 2).contiguous()
    got_y, got_s = ssd_chunked(to_bt(x), to_bt(dt), to_bt(a), B, C, s0)
    torch.cuda.synchronize()
    assert got_y.is_contiguous() and got_y.shape == (2, 70, 4, 64)
    assert torch.equal(got_y, want_y.transpose(1, 2)) and torch.equal(got_s, want_s)


@pytest.mark.cuda
def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    args = _ssd(15, 1, 2, 40, 48, 16, 0.0, cuda)
    with pytest.raises(ValueError, match="p=48"):
        K4.ssd_cuda(*args)
    x, dt, a, B, C, s0 = _ssd(15, 1, 2, 100, 16, 8, 0.0, cuda)
    with pytest.raises(ValueError, match="chunk length 48"):
        K4.ssd_cuda(x, dt, a, B, C, s0, chunk=48)
    with pytest.raises(TypeError, match="f32 dt"):
        K4.ssd_cuda(x, dt.to(torch.bfloat16), a, B, C, s0)
    with pytest.raises(TypeError, match="f32 or bf16"):
        K4.ssd_cuda(x.half(), dt, a, B.half(), C.half(), s0)
    with pytest.raises(ValueError, match="different devices"):
        K4.ssd_chunked_bhtp(x, dt.cpu(), a, B, C, s0)


@pytest.mark.cuda
def test_zamba_prefill_with_kernels_matches_plain_routes_on_card(cuda):
    cfg = dataclasses.replace(configs.get_smoke("zamba2_2b7"), dtype="float32",
                              head_dim=32)
    params = init_model(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    tok = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 150))).to(cuda)
    k2, k4 = K.launches, K4.launches
    got = make_prefill_step(cfg, use_flash=True, use_scan_kernel=True)(
        params, {"tokens": tok})
    assert K4.launches == k4 + cfg.num_layers
    assert K.launches == k2 + cfg.num_layers // cfg.shared_attn_period
    want = make_prefill_step(cfg)(params, {"tokens": tok})
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


# ---------------------------------------------------------------------------
# K1: the water-fill
# ---------------------------------------------------------------------------
def _wf_phase(rng, b, width, guard, device):
    """One phase's caps, slots and live mask; with ``guard``, row 0's
    guard is false at entry (no live lane or no free slot)."""
    caps = rng.integers(0, 50, (b, width)).astype(np.float64)
    caps[rng.random((b, width)) < 0.2] = 0.0
    live = rng.random((b, width)) < 0.7
    slots = rng.uniform(0.0, caps.sum(1) * 1.2 + 1.0)
    if guard == "no-live":
        live[0] = False
    elif guard == "no-slots":
        slots[0] = 0.0
    return (torch.from_numpy(caps).to(device),
            torch.from_numpy(slots).to(device),
            torch.from_numpy(live).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("b,width,guard", [
    (64, 8, "no-live"), (64, 32, "no-slots"), (64, 128, "no-live"),
    (64, 256, "no-slots"), (64, 1024, "no-live"), (64, 3072, "no-slots"),
    (64, 5120, None), (1, 8, None), (1, 128, None), (1, 1024, None),
    (1, 8, "no-live"), (1, 128, "no-slots"), (1, 1024, "no-slots"),
])
def test_waterfill_kernel_matches_plain_version_on_card(cuda, b, width, guard):
    rng = np.random.default_rng(width + b)
    ws = torch.from_numpy(rng.uniform(0.5, 2.0, (b, width))).to(cuda)
    caps_m, slots_m, live_m = _wf_phase(rng, b, width, guard, cuda)
    caps_r, slots_r, live_r = _wf_phase(rng, b, width,
                                        "no-slots" if guard else None, cuda)
    pair = (caps_m, caps_r, ws, slots_m, slots_r, live_m, live_r)
    before = wf.launches
    single = wf.water_fill_cuda(caps_m, ws, slots_m, live_m)
    got = wf.water_fill_pair_cuda(*pair)
    wf.check_batch(ws, slots_m, slots_r)
    again = wf.launch_pair(*pair)
    want = wf.water_fill_pair_reference(*pair)
    torch.cuda.synchronize()
    assert wf.launches == before + 3

    def bits(x):
        return x.contiguous().view(torch.int64)

    assert torch.equal(bits(single), bits(want[0]))
    for g, a, w in zip(got, again, want):
        assert torch.equal(bits(g), bits(w))
        assert torch.equal(bits(a), bits(g))
    if guard == "no-live":
        assert not got[0][0].any()


# ---------------------------------------------------------------------------
# The projection kernel
# ---------------------------------------------------------------------------
def _chip_smoke():
    """``chip_smoke.py`` as a module (it imports only numpy and torch)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SMOKE = _chip_smoke()
PROJECT_CASES = {name: (rows, floor)
                 for name, rows, floor in SMOKE.project_cases()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PROJECT_CASES))
def test_projection_kernel_matches_plain_version_on_card(cuda, name):
    from repro_torch.core import projection as pj

    rows, floor = PROJECT_CASES[name]
    args = SMOKE.project_tensors(rows, cuda)
    if floor is None:  # in segments, each checked inside
        assert len(SMOKE.project_segments(pj, args)) >= 3
        return
    before = pj.launches
    got = pj.project_cuda(*args, floor)
    again = pj.project_cuda(*args, floor)
    want = pj.project_reference(*args, floor)
    torch.cuda.synchronize()
    assert pj.launches == before + 2
    assert SMOKE.carry_equal(got, want)
    assert SMOKE.carry_equal(again, got)


PROJECT_SEGMENTED_CASES = dict(SMOKE.project_segmented_cases())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(PROJECT_SEGMENTED_CASES))
def test_projection_segmented_route_matches_host_segments_on_card(cuda, name):
    from repro_torch.core import projection as pj

    args = SMOKE.project_tensors(PROJECT_SEGMENTED_CASES[name], cuda)
    SMOKE.project_segmented_check(pj, args)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 2048, 5120])
def test_project_finish_times_is_one_launch_on_card(cuda, n):
    from repro_torch.core import projection as pj
    from repro_torch.core import vcluster_torch as vt

    rem, caps, ws, _, slots, now, _ = SMOKE.project_rows(
        np.random.default_rng(n), 1, n)
    one = (rem[0], caps[0], ws[0], float(slots[0]), float(now[0]))
    calls, launches = vt.calls["project"], pj.launches
    got = vt.project_finish_times(*one, device="cuda")
    assert (vt.calls["project"] - calls, pj.launches - launches) == (1, 1)
    want = vt.project_finish_times(*one, device="cpu")
    assert got.tobytes() == want.tobytes()


@pytest.mark.cuda
def test_worker_accel_batch_runs_on_card(cuda, tmp_path):
    """One accel batch through ``run_worker(compute="accel")`` on the card:
    both cells in one batch, one K1 launch per step of the hfsp batch
    (whole chunks of 512), and each stored report equal (wall aside) to a
    direct ``run_cells_accel`` with the plain water-fill on the card."""
    from repro_torch.accel import run_cells_accel
    from repro_torch.scenarios.presets import paper_fb_base, quick_sweep
    from repro_torch.scenarios.spec import SweepSpec
    from repro_torch.scenarios.store import open_store
    from repro_torch.scenarios.worker import run_worker

    sweep = quick_sweep(SweepSpec(
        name="fifo-hfsp", base=paper_fb_base(),
        grids=(SweepSpec.grid(**{"scheduler.policy": ("fifo", "hfsp")}),)))
    path = tmp_path / "w.sqlite"
    before = wf.launches
    summary = run_worker(sweep, path, compute="accel", device="cuda")
    launches = wf.launches - before
    assert (summary["accel_batches"], summary["accel_cells"]) == (1, 2)
    stored = {cid: r for (cid, _), r in open_store(path).load().items()}
    steps = stored["scheduler.policy=hfsp"]["accel_steps"]
    assert launches == -(-steps // 512) * 512 > 0
    cells = sweep.expand()
    plain = run_cells_accel([s for _, s in cells], device="cuda",
                            impl="torch")
    for (cid, _), want in zip(cells, plain):
        want = json.loads(json.dumps(want))  # as the store holds it
        got = {k: v for k, v in stored[cid].items() if k != "wall_s"}
        assert got == {k: v for k, v in want.items() if k != "wall_s"}


# ---------------------------------------------------------------------------
# Training: the kernels refuse gradients; the train step on the card
# ---------------------------------------------------------------------------
def _kernel_call(name, device):
    """(the wrapper's module, a call of the wrapper on inputs of which
    the first requires grad) for model kernel ``name``."""
    if name == "flash_attention":
        q, k, v = _qkv(0, 1, 2, 2, 128, 128, 64, device, torch.bfloat16)
        q.requires_grad_(True)
        return K, lambda: K.flash_attention_cuda(q, k, v, scale=0.125)
    if name == "rwkv6":
        r, k, v, w, u, s0 = _rwkv(0, 1, 2, 128, 64, 2.0, device)
        r.requires_grad_(True)
        return K3, lambda: K3.rwkv6_cuda(r, k, v, w, u, s0)
    x, dt, a, B, C, s0 = _ssd(0, 1, 2, 128, 64, 64, 0.0, device)
    x.requires_grad_(True)
    return K4, lambda: K4.ssd_cuda(x, dt, a, B, C, s0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["flash_attention", "rwkv6", "ssd"])
def test_kernel_wrappers_refuse_grad_on_card(cuda, name):
    from repro_torch import KernelInputError

    mod, call = _kernel_call(name, cuda)
    before = mod.launches
    with pytest.raises(KernelInputError, match="no backward"):
        call()
    assert mod.launches == before
    with torch.no_grad():
        out = call()
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    first = out[0] if isinstance(out, tuple) else out
    assert not first.requires_grad and bool(torch.isfinite(first).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["olmo_1b", "rwkv6_1b6", "zamba2_2b7",
                                  "granite_moe_3b", "whisper_base"])
def test_train_step_on_card(cuda, name):
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models.params import tree_flatten
    from repro_torch.train import (OptimizerConfig, TrainConfig,
                                   init_train_state, make_train_step)

    cfg = configs.get_smoke(name)
    state = init_train_state(cfg, torch.Generator(device=cuda).manual_seed(0),
                             device=cuda)
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=50),
                           TrainConfig(remat="block"))
    batch = {k: torch.from_numpy(v).to(cuda) for k, v in SyntheticLM(
        cfg, DataConfig(seq_len=96, global_batch=4)).batch(0).items()}
    before = (K.launches, K3.launches, K4.launches)
    a, metrics = step(state, batch)
    b, _ = step(state, batch)
    torch.cuda.synchronize()
    assert (K.launches, K3.launches, K4.launches) == before
    assert np.isfinite(float(metrics["loss"]))
    assert all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[1],
                                                 tree_flatten(b)[1]))
