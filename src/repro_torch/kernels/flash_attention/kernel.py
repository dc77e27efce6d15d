"""Blockwise (flash) attention: a CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py::
_flash_kernel`` (reached through ``flash_attention_bhsd``): online-softmax
attention of q ``(b, h, sq, hd)`` against k/v ``(b, kvh, skv, hd)``, GQA
by ``kv_head = q_head // (h // kvh)``, causal and sliding-window masks,
kv blocks that are wholly masked skipped.  Max, sum and accumulator are
f32; the output is in the input dtype.

* :func:`flash_attention_cuda` launches ``csrc/flash_attention.cu`` (one
  thread block per 64-row q tile, head and batch; K and V tiles staged in
  shared memory; f32 CUDA-core arithmetic) on f32 or bf16 tensors with
  ``hd`` in {32, 64, 80, 128}.  It reads the inputs through their
  strides, so the model-layout adapter (:mod:`.ops`) passes transposed
  views without copies, and it writes its output straight into the
  ``(b, sq, h, hd)`` layout.
* :func:`flash_attention_plain` is the plain PyTorch version: the TPU
  kernel's grid written out as loops over q and kv blocks, with its block
  skips, its ``NEG_INF = -1e30`` and its ``max(l, 1e-30)``.
* :func:`flash_attention_bhsd` dispatches on where the tensors lie: the
  kernel for CUDA tensors, the plain version for CPU tensors.  There is
  no fallback from one to the other.

Both equal the reference's zero-padded result: q and kv are padded to
multiples of ``block_q``/``block_kv`` (each capped at its length); padded
kv rows sit beyond every real query under the causal mask, and a
non-causal call needs ``skv`` to be a multiple of ``block_kv``.  The
kernel uses its own 64-row tiles and takes ``block_kv`` only for the
padded kv length; skipping a wholly masked block is exact, so the tiles
change nothing but rounding.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

#: Kernel launches made by :func:`flash_attention_cuda` (one per call).
launches = 0

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, causal: bool, window: int | None, block_kv: int):
    """Validate the shapes of a call; returns ``(b, h, kvh, sq, skv, hd,
    skv_pad)`` with ``skv_pad`` the reference's padded kv length."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D (b, h, s, hd)")
    b, h, sq, hd = q.shape
    _, kvh, skv, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if skv < 1:
        raise ValueError("k and v hold no positions")
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} query heads are not a multiple of {kvh} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    block_kv = min(block_kv, skv)
    skv_pad = -(-skv // block_kv) * block_kv
    if not causal and skv_pad != skv:
        # The reference asserts the same (kernel.py): padded kv columns
        # would win the softmax without the causal mask.
        raise ValueError("non-causal padding unsupported: skv must be a "
                         "multiple of block_kv")
    return b, h, kvh, sq, skv, hd, skv_pad


def flash_attention_plain(q, k, v, *, scale: float, causal: bool = True,
                          window: int | None = None, block_q: int = 512,
                          block_kv: int = 512) -> torch.Tensor:
    """Plain PyTorch version of the kernel, any device: the reference's
    blockwise online softmax, one (q block, kv block) pair at a time."""
    b, h, kvh, sq, skv, hd, _ = _check(q, k, v, causal, window, block_kv)
    bq, bkv = min(block_q, sq), min(block_kv, skv)
    groups = h // kvh
    qf = F.pad(q.float(), (0, 0, 0, (-sq) % bq))
    kf = F.pad(k.float(), (0, 0, 0, (-skv) % bkv)).repeat_interleave(groups, 1)
    vf = F.pad(v.float(), (0, 0, 0, (-skv) % bkv)).repeat_interleave(groups, 1)
    nq, nkv = qf.shape[2] // bq, kf.shape[2] // bkv
    out = torch.empty_like(qf)
    dev = q.device
    for qi in range(nq):
        q_blk = qf[:, :, qi * bq:(qi + 1) * bq]
        q_pos = qi * bq + torch.arange(bq, device=dev)[:, None]
        m = torch.full((b, h, bq, 1), NEG_INF, device=dev)
        l = torch.zeros((b, h, bq, 1), device=dev)
        acc = torch.zeros((b, h, bq, hd), device=dev)
        for ki in range(nkv):
            # Block-level skip, the TPU kernel's predicates.
            if causal and not ki * bkv <= qi * bq + bq - 1:
                continue
            if window is not None and not (
                    qi * bq - (ki * bkv + bkv - 1) < window):
                continue
            rows = slice(ki * bkv, (ki + 1) * bkv)
            s = (q_blk @ kf[:, :, rows].transpose(-1, -2)) * scale
            k_pos = ki * bkv + torch.arange(bkv, device=dev)[None, :]
            mask = torch.ones((bq, bkv), dtype=torch.bool, device=dev)
            if causal:
                mask &= k_pos <= q_pos
            if window is not None:
                mask &= (q_pos - k_pos) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.where(mask, torch.exp(s - m_new), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vf[:, :, rows]
            m = m_new
        out[:, :, qi * bq:(qi + 1) * bq] = acc / torch.clamp(l, min=1e-30)
    return out[:, :, :sq].to(q.dtype)


@functools.lru_cache(maxsize=1)
def _kernel():
    """The C entry point of ``csrc/flash_attention.cu``, built on first use."""
    from repro_torch import _build

    fn = _build.load("flash_attention").repro_flash_attention_fwd
    # q, k, v, o, strides, b, h, kvh, sq, skv, skv_pad, hd, dtype, scale,
    # causal, window, stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool = True,
                         window: int | None = None, block_q: int = 512,
                         block_kv: int = 512) -> torch.Tensor:
    """Launch the CUDA kernel on tensors that lie on a CUDA device (same
    arguments as :func:`flash_attention_plain`).  Returns ``(b, h, sq,
    hd)``, a view of a ``(b, sq, h, hd)`` tensor."""
    global launches
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_cuda needs CUDA tensors, got {q.device}; the "
            "plain version is flash_attention_plain"
        )
    b, h, kvh, sq, skv, hd, skv_pad = _check(q, k, v, causal, window, block_kv)
    if {k.device, v.device} != {q.device}:
        raise ValueError("q, k and v lie on different devices")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes f32 or bf16 q, k, v of one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    out_bhsd = out.transpose(1, 2)
    if sq == 0:
        return out_bhsd
    strides = (ctypes.c_int64 * 12)(*(
        s for x in (q, k, v, out_bhsd) for s in x.stride()[:3]))
    fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 ctypes.addressof(strides), b, h, kvh, sq, skv, skv_pad, hd,
                 _DTYPE_CODES[q.dtype], scale, int(causal), window or 0,
                 stream)
    if err != 0:
        raise RuntimeError(
            f"flash attention kernel launch failed: error {err} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})"
        )
    launches += 1
    return out_bhsd


def flash_attention_bhsd(q, k, v, *, scale: float, causal: bool = True,
                         window: int | None = None, block_q: int = 512,
                         block_kv: int = 512) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    kw = dict(scale=scale, causal=causal, window=window, block_q=block_q,
              block_kv=block_kv)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, **kw)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    raise ValueError(f"unsupported device {q.device}")
