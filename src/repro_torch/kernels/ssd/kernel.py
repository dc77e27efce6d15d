"""Mamba2 SSD chunked scan: a CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/ssd/kernel.py::_ssd_kernel``
(reached through ``ssd_chunked_bhtp``): the recurrence

    S_t = a_t S_{t-1} + dt_t x_t B_t^T,   y_t = S_t C_t

with a scalar decay ``a`` and step ``dt`` per (head, token), B and C
shared across heads, evaluated chunk by chunk with the (p x n) f32 state
carried across chunks.  Per chunk of length c, in f32:

    cum     = cumsum(log max(a, 1e-38))                       # inclusive
    scores  = where(j <= i, exp(cum_i - cum_j) * (C B^T)_ij * dt_j, 0)
    y       = scores @ x  +  exp(cum) * (C @ S^T)
    S       = exp(total) * S + (x * dt * exp(total - cum))^T @ B

* :func:`ssd_cuda` launches ``csrc/ssd.cu`` on x, B, C in f32 or bf16
  with dt, a and s0 in f32, p and n in {8, 16, 32, 64} and chunks of 16,
  32 or 64: ``ssd_cb`` forms C B^T once per (batch, chunk), then
  ``ssd_scan`` runs one block per (chunk, head, batch), all chunks at
  once: each block adds its chunk's term to the state the block of the
  chunk before published, publishes the sum for the next, and computes
  its chunk's y.  The wrapper allocates the scratch.  It reads its inputs through their strides, so the model-layout
  adapter (:mod:`.ops`) passes transposed views without copies, and it
  writes ``y`` straight into the ``(b, t, h, p)`` layout.
* :func:`ssd_plain` is the plain PyTorch version: the TPU kernel's
  per-chunk algorithm (kernel.py:39-70) written out, its elementwise
  steps and intra-chunk products batched over chunks and a loop over
  chunks for the state.
* :func:`ssd_chunked_bhtp` dispatches on where the tensors lie: the
  kernel for CUDA tensors, the plain version for CPU tensors.  There is
  no fallback from one to the other.

Both keep the reference's ragged handling: ``chunk = min(chunk, t)`` and
a ragged ``t`` padded to the chunk with a = 1 and x = dt = B = C = 0 (the
kernel masks those rows instead of copying).
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

#: Calls of :func:`ssd_cuda` that launched the kernels (one per call: each
#: launches the two kernels of :data:`KERNEL_NAMES` once).
launches = 0

#: The kernels one call launches, in order, by their names in a profile.
KERNEL_NAMES = ("ssd_cb", "ssd_scan")
HEAD_DIMS = (8, 16, 32, 64)    # p
STATE_DIMS = (8, 16, 32, 64)   # n
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(x, dt, a, B, C, s0, chunk: int):
    """Validate a call; returns ``(b, h, t, p, n, c)`` with ``c`` the
    chunk length the reference uses, ``min(chunk, t)``."""
    if x.dim() != 4 or s0.dim() != 4 or any(v.dim() != 3
                                            for v in (dt, a, B, C)):
        raise ValueError("x and s0 must be 4-D (b, h, t, p) / (b, h, p, n); "
                         "dt, a 3-D (b, h, t); B, C 3-D (b, t, n)")
    b, h, t, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, h, t) or a.shape != (b, h, t):
        raise ValueError(f"dt {tuple(dt.shape)} / a {tuple(a.shape)} do not "
                         f"fit x {tuple(x.shape)}")
    if B.shape != (b, t, n) or C.shape != (b, t, n):
        raise ValueError(f"B {tuple(B.shape)} / C {tuple(C.shape)} do not "
                         f"fit (b, t) = {(b, t)}")
    if s0.shape != (b, h, p, n):
        raise ValueError(f"s0 {tuple(s0.shape)} does not fit (b, h, p, n) = "
                         f"{(b, h, p, n)}")
    if t < 1 or chunk < 1:
        raise ValueError(f"need t >= 1 and chunk >= 1, got t={t}, "
                         f"chunk={chunk}")
    if len({v.device for v in (x, dt, a, B, C, s0)}) != 1:
        raise ValueError("x, dt, a, B, C and s0 lie on different devices")
    return b, h, t, p, n, min(chunk, t)


def ssd_plain(x, dt, a, B, C, s0, *, chunk: int = 64):
    """Plain PyTorch version of the kernel, any device.  Mirrors the TPU
    kernel's chunk step (``_ssd_kernel``), not ``ssd_scan_chunked``: every
    input is cast to f32 here, so bf16 x/B/C are taken as they come (f64
    inputs are computed in f64, the yardstick ``chip_smoke.py`` holds the
    f32 sums of both versions to).  Returns (y in x's dtype, final state
    in f32, or f64 for f64 x)."""
    b, h, t, p, n, c = _check(x, dt, a, B, C, s0, chunk)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    pad = (-t) % c
    xf = F.pad(x.to(acc), (0, 0, 0, pad))
    dtf = F.pad(dt.to(acc), (0, pad))
    af = F.pad(a.to(acc), (0, pad), value=1.0)
    Bf, Cf = (F.pad(v.to(acc), (0, 0, 0, pad)) for v in (B, C))
    nc = xf.shape[2] // c
    xf = xf.reshape(b, h, nc, c, p)
    dtf, af = dtf.reshape(b, h, nc, c), af.reshape(b, h, nc, c)
    Bf, Cf = Bf.reshape(b, nc, c, n), Cf.reshape(b, nc, c, n)

    cum = torch.cumsum(torch.log(torch.clamp(af, min=1e-38)), dim=3)
    total = cum[..., -1:]                              # (b,h,nc,1)
    cb = Cf @ Bf.transpose(-1, -2)                     # (b,nc,c_i,c_j)
    ratio = torch.exp(cum[..., :, None] - cum[..., None, :])
    row = torch.arange(c, device=x.device)
    tri = row[None, :] <= row[:, None]                 # j <= i
    # A select, not a multiply: above the diagonal exp may overflow.
    scores = torch.where(tri, ratio * cb[:, None] * dtf[..., None, :], 0.0)
    y_intra = scores @ xf                              # (b,h,nc,c,p)
    xw = xf * (dtf * torch.exp(total - cum))[..., None]
    s_new = xw.transpose(-1, -2) @ Bf[:, None]         # (b,h,nc,p,n)
    decay = torch.exp(total)[..., None]                # (b,h,nc,1,1)
    e_cum = torch.exp(cum)[..., None]                  # (b,h,nc,c,1)

    S = s0.to(acc)
    y = torch.empty_like(xf)
    for i in range(nc):
        y[:, :, i] = y_intra[:, :, i] + e_cum[:, :, i] * (
            Cf[:, None, i] @ S.transpose(-1, -2))
        S = decay[:, :, i] * S + s_new[:, :, i]
    y = y.reshape(b, h, nc * c, p)[:, :, :t]
    return y.to(x.dtype), S


@functools.lru_cache(maxsize=1)
def _kernel():
    """The C entry point of ``csrc/ssd.cu``, built on first use."""
    from repro_torch import _build

    fn = _build.load("ssd").repro_ssd
    # x, dt, a, B, C, s0, y, s_out, cb, st, sync, strides, b, h, t, p, n,
    # chunk, dtype, stream
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssd_cuda(x, dt, a, B, C, s0, *, chunk: int = 64):
    """Launch the CUDA kernel on tensors that lie on a CUDA device (same
    arguments as :func:`ssd_plain`).  Returns ``(y, state)``: ``y`` is a
    ``(b, h, t, p)`` view of a ``(b, t, h, p)`` tensor in x's dtype."""
    global launches
    refuse_grad("ssd_cuda", x, dt, a, B, C, s0)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_cuda needs CUDA tensors, got {x.device}; the "
                         "plain version is ssd_plain")
    b, h, t, p, n, c = _check(x, dt, a, B, C, s0, chunk)
    if x.dtype not in _DTYPE_CODES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"the kernel takes f32 or bf16 x, B, C of one dtype; "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if any(v.dtype != torch.float32 for v in (dt, a, s0)):
        raise TypeError(f"the kernel takes f32 dt, a and s0; got {dt.dtype}, "
                        f"{a.dtype}, {s0.dtype}")
    if p not in HEAD_DIMS or n not in STATE_DIMS:
        raise ValueError(f"head dim p={p}, state dim n={n}: the kernel takes "
                         f"p in {HEAD_DIMS} and n in {STATE_DIMS}")
    tile = _tile(c, t)
    x, B, C = (_aligned(v) for v in (x, B, C))
    s0 = s0.contiguous()
    nc = -(-t // tile)
    f32 = dict(dtype=torch.float32, device=x.device)
    cb = torch.empty((b, nc, tile, tile), **f32)   # C B^T per chunk
    st = torch.empty((b, h, 2, n, p), **f32)       # ring of entering states
    sync = torch.empty(1 + b * h * nc, dtype=torch.int32, device=x.device)
    out = torch.empty((b, t, h, p), dtype=x.dtype, device=x.device)
    y = out.transpose(1, 2)
    s_out = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    strides = (ctypes.c_int64 * 16)(
        *x.stride()[:3], *dt.stride(), *a.stride(), *B.stride()[:2],
        *C.stride()[:2], *y.stride()[:3])
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), a.data_ptr(), B.data_ptr(),
                 C.data_ptr(), s0.data_ptr(), out.data_ptr(),
                 s_out.data_ptr(), cb.data_ptr(), st.data_ptr(),
                 sync.data_ptr(), ctypes.addressof(strides), b, h, t, p, n,
                 tile, _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise KernelError(f"ssd kernels' launch failed: error {err} "
                           f"(x {tuple(x.shape)}, n {n}, {x.dtype}, "
                           f"chunk {tile})")
    launches += 1
    return y, s_out


def ssd_chunked_bhtp(x, dt, a, B, C, s0, *, chunk: int = 64):
    """The kernel for CUDA tensors, the plain version for CPU tensors
    (each checks that all six lie on one device)."""
    if x.device.type == "cuda":
        return ssd_cuda(x, dt, a, B, C, s0, chunk=chunk)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, a, B, C, s0, chunk=chunk)
    raise ValueError(f"unsupported device {x.device}")
