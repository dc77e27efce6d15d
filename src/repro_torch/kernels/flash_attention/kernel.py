"""Blockwise (flash) attention: a CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py::
_flash_kernel`` (reached through ``flash_attention_bhsd``): online-softmax
attention of q ``(b, h, sq, hd)`` against k/v ``(b, kvh, skv, hd)``, GQA
by ``kv_head = q_head // (h // kvh)``, causal and sliding-window masks,
kv blocks that are wholly masked skipped.  Max, sum and accumulator are
f32; the output is in the input dtype.

* :func:`flash_attention_cuda` launches one of two kernels by dtype, with
  no fallback from one to the other, on tensors with ``hd`` in {32, 64,
  80, 128}:

  - bf16: ``csrc/flash_attention_tc.cu``, both products on Hopper's
    tensor cores (``wgmma``), K and V tiles brought by TMA through a
    two-stage ring; P is rounded to bf16 before P V.  TMA reads the
    inputs through their strides, which must be multiples of 16 bytes
    (:func:`tma_layout` checks and raises);
  - f32: ``csrc/flash_attention.cu`` (one thread block per 64-row q tile,
    head and batch; K and V tiles staged in shared memory; f32 CUDA-core
    arithmetic: the tensor cores would need TF32 for f32).

  Both read the model-layout adapter's (:mod:`.ops`) transposed views
  without copies and write their output straight into the ``(b, sq, h,
  hd)`` layout.
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
kernels use their own tiles and take ``block_kv`` only for the padded kv
length; skipping a wholly masked block is exact, so the tiles change
nothing but rounding.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch import KernelError
from repro_torch.kernels import refuse_grad

#: Kernel launches made by :func:`flash_attention_cuda` (one per call),
#: on either route.
launches = 0
#: Of those, the launches of the tensor-core kernel (the bf16 route).
launches_tc = 0

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 80, 128)
#: dtype -> the kernel (its name in ``_build.KERNELS``) that takes it.
ROUTES = {torch.bfloat16: "flash_attention_tc",
          torch.float32: "flash_attention"}
_AXES = ("batch", "head", "seq")


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


def tma_layout(x: torch.Tensor, name: str) -> list[int]:
    """How a TMA tensor map reads the ``(b, h, s, hd)`` tensor ``x`` as
    it lies: 9 values, the three outer axes (0 batch, 1 head, 2 seq) in
    the order of their strides, their sizes and their byte strides, the
    head dim innermost.  Ordered by stride, the dims are monotonic both
    for the model layout's views (seq stride ``h * hd``) and for
    contiguous tensors.  A size-1 axis is never stepped and gets the
    tensor's span as its stride.  Raises ``ValueError`` naming the stride
    or base address that TMA cannot take: not a multiple of 16 bytes."""
    esize = x.element_size()
    if x.stride(3) != 1:
        raise ValueError(f"{name}: the head dim must be contiguous, got "
                         f"stride {x.stride(3)}")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: base address {x.data_ptr():#x} is not a "
                         "multiple of 16 bytes, as TMA needs")
    span = esize * (1 + sum((n - 1) * st for n, st in zip(x.shape, x.stride())))
    outer = []
    for axis in range(3):
        size, stride = x.shape[axis], x.stride(axis) * esize
        if size == 1:
            stride = -(-span // 16) * 16
        elif stride % 16:
            raise ValueError(
                f"{name}: {_AXES[axis]} stride {x.stride(axis)} elements "
                f"({stride} bytes) is not a multiple of 16 bytes, as TMA "
                "needs")
        outer.append((stride, axis, size))
    outer.sort()
    return ([axis for _, axis, _ in outer] + [size for _, _, size in outer]
            + [stride for stride, _, _ in outer])


@functools.lru_cache(maxsize=1)
def _kernel():
    """The C entry point of ``csrc/flash_attention.cu`` (the f32 route),
    built on first use."""
    from repro_torch import _build

    fn = _build.load("flash_attention").repro_flash_attention_fwd
    # q, k, v, o, strides, b, h, kvh, sq, skv, skv_pad, hd, scale, causal,
    # window, stream
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1)
def _kernel_tc():
    """The C entry point of ``csrc/flash_attention_tc.cu`` (the bf16
    route), built on first use."""
    from repro_torch import _build

    fn = _build.load("flash_attention_tc").repro_flash_attention_tc_fwd
    # q, k, v, o, layouts, o_strides, b, h, kvh, sq, skv_pad, hd, scale,
    # causal, window, stream
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool = True,
                         window: int | None = None, block_q: int = 512,
                         block_kv: int = 512) -> torch.Tensor:
    """Launch a CUDA kernel on tensors that lie on a CUDA device (same
    arguments as :func:`flash_attention_plain`): the tensor-core kernel
    for bf16, the CUDA-core kernel for f32.  Returns ``(b, h, sq, hd)``,
    a view of a ``(b, sq, h, hd)`` tensor."""
    global launches, launches_tc
    refuse_grad("flash_attention_cuda", q, k, v)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_cuda needs CUDA tensors, got {q.device}; the "
            "plain version is flash_attention_plain"
        )
    b, h, kvh, sq, skv, hd, skv_pad = _check(q, k, v, causal, window, block_kv)
    if {k.device, v.device} != {q.device}:
        raise ValueError("q, k and v lie on different devices")
    if q.dtype not in ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the kernel takes f32 or bf16 q, k, v of one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=q.device)
    out_bhsd = out.transpose(1, 2)
    if sq == 0:
        return out_bhsd
    tc = ROUTES[q.dtype] == "flash_attention_tc"
    if tc:
        layouts = (ctypes.c_int64 * 27)(*(
            n for x, name in ((q, "q"), (k, "k"), (v, "v"))
            for n in tma_layout(x, name)))
        o_strides = (ctypes.c_int64 * 3)(*out_bhsd.stride()[:3])
    else:
        strides = (ctypes.c_int64 * 12)(*(
            s for x in (q, k, v, out_bhsd) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if tc:
            err = _kernel_tc()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ctypes.addressof(layouts), ctypes.addressof(o_strides), b, h,
                kvh, sq, skv_pad, hd, scale, int(causal), window or 0, stream)
        else:
            err = _kernel()(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                ctypes.addressof(strides), b, h, kvh, sq, skv, skv_pad, hd,
                scale, int(causal), window or 0, stream)
    if err != 0:
        what = (f"tensor map refused, CUresult {err - 10000}" if err >= 10000
                else "no cuTensorMapEncodeTiled in the driver" if err == -2
                else f"error {err}")
        raise KernelError(
            f"flash attention kernel launch failed: {what} "
            f"(q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype})"
        )
    launches += 1
    launches_tc += tc
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
