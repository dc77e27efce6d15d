"""RWKV6 chunked WKV scan: a CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/rwkv6/kernel.py::_rwkv6_kernel``
(reached through ``rwkv6_chunked_bhtd``): the WKV recurrence

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,  o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

evaluated chunk by chunk, with the (dk x dv) f32 state carried across
chunks.  Per chunk of length c, in f32:

    cum      = cumsum(log max(w, 1e-38))   # inclusive, per channel
    a_pre    = exp(cum - log w)            # decay before each token
    o        = (r a_pre) @ S                               (inter-chunk)
             + tril_{-1}((r a_pre) @ (k / max(a_pre w, 1e-30))^T) @ v
             + (sum r u k) v                               (bonus diagonal)
    S        = exp(total) S + (k exp(total - cum))^T @ v

* :func:`rwkv6_cuda` launches ``csrc/rwkv6.cu`` (``rwkv6_scan``: one
  thread block per (chunk, head, batch), all chunks at once; each block
  adds its chunk's term to the state the block of the chunk before
  published in a two-slot ring per (batch, head), publishes the sum for
  the next, and computes its chunk's output; the four products as f32
  FMAs) on r/k/v in f32 or bf16 with w, u and s0 in f32, dk = dv in
  {8, 16, 32, 64} and chunks of 16, 32 or 64.  The wrapper allocates the
  ring and the tickets.  It reads its inputs through their strides, so
  the model-layout adapter (:mod:`.ops`) passes transposed views without
  copies, and it writes the output straight into the ``(b, t, h, dv)``
  layout.
* :func:`rwkv6_plain` is the plain PyTorch version: the TPU kernel's
  per-chunk algorithm (kernel.py:42-78) written out, its elementwise
  steps and intra-chunk products batched over chunks and a loop over
  chunks for the state.
* :func:`rwkv6_chunked_bhtd` dispatches on where the tensors lie: the
  kernel for CUDA tensors, the plain version for CPU tensors.  There is
  no fallback from one to the other.

Both keep the reference's ragged handling: ``chunk = min(chunk, t)`` and
a ragged ``t`` padded to the chunk with r = k = v = 0 and w = 1 (the
kernel masks those rows instead of copying).  They also keep its clamps,
so they keep its behaviour under strong decays: once the cumulative decay
of a chunk falls below 1e-30 the ratio ``k / max(a_pre w, 1e-30)`` is
wrong (ROADMAP Queue 3).  At w = 0 the reference on the CPU gives NaN,
because XLA flushes the subnormal 1e-38 to zero; both versions here keep
the subnormal and give finite values that are as wrong.  The model's
decays (``wd_bias = -6``, w ~ 0.9975) are far from that.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch import KernelError
from repro_torch.kernels import refuse_grad
from repro_torch.kernels import aligned as _aligned
from repro_torch.kernels import chunk_tile as _tile

#: Kernel launches made by :func:`rwkv6_cuda` (one per call).
launches = 0

#: The kernel's name in a profile.
KERNEL_NAME = "rwkv6_scan"

HEAD_DIMS = (8, 16, 32, 64)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(r, k, v, w, u, s0, chunk: int):
    """Validate a call; returns ``(b, h, t, dk, dv, c)`` with ``c`` the
    chunk length the reference uses, ``min(chunk, t)``."""
    if any(x.dim() != 4 for x in (r, k, v, w, s0)) or u.dim() != 2:
        raise ValueError("r, k, v, w and s0 must be 4-D (b, h, t, d) / "
                         "(b, h, dk, dv), u 2-D (h, dk)")
    b, h, t, dk = r.shape
    dv = v.shape[-1]
    if k.shape != r.shape or w.shape != r.shape or v.shape[:3] != (b, h, t):
        raise ValueError(f"k {tuple(k.shape)}, v {tuple(v.shape)}, w "
                         f"{tuple(w.shape)} do not fit r {tuple(r.shape)}")
    if tuple(u.shape) != (h, dk) or tuple(s0.shape) != (b, h, dk, dv):
        raise ValueError(f"u {tuple(u.shape)} / s0 {tuple(s0.shape)} do not "
                         f"fit (h, dk) = {(h, dk)}, (b, h, dk, dv) = "
                         f"{(b, h, dk, dv)}")
    if t < 1 or chunk < 1:
        raise ValueError(f"need t >= 1 and chunk >= 1, got t={t}, "
                         f"chunk={chunk}")
    if len({x.device for x in (r, k, v, w, u, s0)}) != 1:
        raise ValueError("r, k, v, w, u and s0 lie on different devices")
    return b, h, t, dk, dv, min(chunk, t)


def rwkv6_plain(r, k, v, w, u, s0, *, chunk: int = 64):
    """Plain PyTorch version of the kernel, any device.  Mirrors the TPU
    kernel's chunk step (``_rwkv6_kernel``), not ``rwkv_scan_chunked``:
    r, k, v and w are cast to f32 here, so bf16 r/k/v are taken as they
    come.  Returns (o in r's dtype, final state in f32)."""
    b, h, t, dk, dv, c = _check(r, k, v, w, u, s0, chunk)
    pad = (-t) % c
    rf, kf, vf = (F.pad(x.float(), (0, 0, 0, pad)) for x in (r, k, v))
    wf = F.pad(w.float(), (0, 0, 0, pad), value=1.0)
    nc = rf.shape[2] // c
    rf, kf, wf = (x.reshape(b, h, nc, c, dk) for x in (rf, kf, wf))
    vf = vf.reshape(b, h, nc, c, dv)

    logw = torch.log(torch.clamp(wf, min=1e-38))
    cum = torch.cumsum(logw, dim=3)                  # inclusive
    total = cum[:, :, :, -1:, :]                     # (b,h,nc,1,dk)
    a_pre = torch.exp(cum - logw)                    # prod_{i<t} w_i
    r_dec = rf * a_pre
    inv_k = kf / torch.clamp(a_pre * wf, min=1e-30)
    scores = r_dec @ inv_k.transpose(-1, -2)         # (b,h,nc,c,c)
    row = torch.arange(c, device=r.device)
    scores = torch.where(row[None, :] < row[:, None], scores, 0.0)
    o_intra = scores @ vf
    diag = torch.sum(rf * u.float()[None, :, None, None, :] * kf, dim=-1,
                     keepdim=True)
    o_diag = diag * vf
    kv_end = (kf * torch.exp(total - cum)).transpose(-1, -2) @ vf
    decay = torch.exp(total).transpose(-1, -2)       # (b,h,nc,dk,1)

    S = s0.float()
    o = torch.empty_like(vf)
    for i in range(nc):
        o[:, :, i] = r_dec[:, :, i] @ S + o_intra[:, :, i] + o_diag[:, :, i]
        S = decay[:, :, i] * S + kv_end[:, :, i]
    o = o.reshape(b, h, nc * c, dv)[:, :, :t]
    return o.to(r.dtype), S


@functools.lru_cache(maxsize=1)
def _kernel():
    """The C entry point of ``csrc/rwkv6.cu``, built on first use."""
    from repro_torch import _build

    fn = _build.load("rwkv6").repro_rwkv6
    # r, k, v, w, u, s0, o, s_out, st, sync, strides, b, h, t, d, chunk,
    # dtype, stream
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rwkv6_cuda(r, k, v, w, u, s0, *, chunk: int = 64):
    """Launch the CUDA kernel on tensors that lie on a CUDA device (same
    arguments as :func:`rwkv6_plain`).  Returns ``(o, state)``: ``o`` is a
    ``(b, h, t, dv)`` view of a ``(b, t, h, dv)`` tensor in r's dtype."""
    global launches
    refuse_grad("rwkv6_cuda", r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_cuda needs CUDA tensors, got {r.device}; "
                         "the plain version is rwkv6_plain")
    b, h, t, dk, dv, c = _check(r, k, v, w, u, s0, chunk)
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"the kernel takes f32 or bf16 r, k, v of one dtype; "
                        f"got {r.dtype}, {k.dtype}, {v.dtype}")
    if any(x.dtype != torch.float32 for x in (w, u, s0)):
        raise TypeError(f"the kernel takes f32 w, u and s0; got {w.dtype}, "
                        f"{u.dtype}, {s0.dtype}")
    if dk != dv or dk not in HEAD_DIMS:
        raise ValueError(f"head dims dk={dk}, dv={dv}: the kernel takes "
                         f"dk = dv in {HEAD_DIMS}")
    tile = _tile(c, t)
    r, k, v, w = (_aligned(x) for x in (r, k, v, w))
    u, s0 = u.contiguous(), _aligned(s0.contiguous())
    nc = -(-t // tile)
    st = torch.empty((b, h, 2, dk, dv), dtype=torch.float32,
                     device=r.device)   # ring of entering states
    sync = torch.empty(1 + b * h * nc, dtype=torch.int32, device=r.device)
    out = torch.empty((b, t, h, dv), dtype=r.dtype, device=r.device)
    o = out.transpose(1, 2)
    s_out = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    strides = (ctypes.c_int64 * 15)(*(
        s for x in (r, k, v, w, o) for s in x.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 u.data_ptr(), s0.data_ptr(), out.data_ptr(), s_out.data_ptr(),
                 st.data_ptr(), sync.data_ptr(), ctypes.addressof(strides),
                 b, h, t, dk, tile, _DTYPE_CODES[r.dtype], stream)
    if err != 0:
        raise KernelError(f"rwkv6 kernel launch failed: error {err} "
                           f"(r {tuple(r.shape)}, {r.dtype}, chunk {tile})")
    launches += 1
    return o, s_out


def rwkv6_chunked_bhtd(r, k, v, w, u, s0, *, chunk: int = 64):
    """The kernel for CUDA tensors, the plain version for CPU tensors
    (each checks that all six lie on one device)."""
    if r.device.type == "cuda":
        return rwkv6_cuda(r, k, v, w, u, s0, chunk=chunk)
    if r.device.type == "cpu":
        return rwkv6_plain(r, k, v, w, u, s0, chunk=chunk)
    raise ValueError(f"unsupported device {r.device}")
