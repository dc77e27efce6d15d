"""The weighted max-min water-fill: a CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/accel/waterfill_pallas.py::_pallas_fill``
(the Pallas kernel behind ``water_fill_pallas``), which the accel cell
step runs twice per hfsp step: once for the MAP virtual cluster and once
for the REDUCE one.  Per row: fill the free slots in proportion to
weight, clamp at each entry's cap, hand the overflow back, repeat until
nobody is capped (at most ``width + 1`` guarded rounds; every round after
the guard goes False is an exact no-op).

* :func:`water_fill_cuda` launches ``csrc/waterfill.cu`` (one thread
  block per row, the row held in registers across rounds, early exit on
  the block-uniform guard).
* :func:`water_fill_reference` is the plain PyTorch version.  It sums in
  the kernel's fixed order — each of ``L = min(width, 1024)`` threads
  sums its lanes ``t, t+L, ...`` in order, then a stride-halving tree —
  so the two agree bitwise, and reruns are bitwise equal.
* :func:`water_fill` dispatches on where the tensors lie: the kernel for
  CUDA tensors, the plain version for CPU tensors.  There is no fallback
  from one to the other.

Bound on the card: a row moves ``width * (8 + 8 + 1 + 8) + 8`` bytes and
does a few f64 operations per lane per round, so at the main path's
shapes (tens of rows of width 128, a handful of rounds) one launch is
latency-bound: far below both the memory and the f64 rate.  The design
keeps the whole fixpoint in one launch per call; fusing the entire cell
step into one kernel (or capturing a chunk in a CUDA graph) is the next
lever, see ROADMAP.md.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: Kernel launches made by :func:`water_fill_cuda` (one per call).
launches = 0

_MAX_THREADS = 1024
_MAX_WIDTH = 32 * _MAX_THREADS  # the largest KMAX the kernel instantiates
_EPS = 1e-12


def _bucket(n: int) -> int:
    """The padded width quantization of the accel cell (pow2 to 1024,
    then 1024 multiples); the kernel takes exactly these widths."""
    if n <= 8:
        return 8
    if n <= 1024:
        return 1 << (n - 1).bit_length()
    return -(-n // 1024) * 1024


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a ``(B, W)`` bucket-width tensor in the kernel's order:
    thread ``t < L`` sums lanes ``t, t+L, ...`` in order from +0.0, then
    ``acc[t] = acc[t] + acc[t+s]`` for ``s = L/2 ... 1``."""
    b, w = x.shape
    lanes = min(w, _MAX_THREADS)
    chunks = x.reshape(b, w // lanes, lanes)
    acc = torch.zeros(b, lanes, dtype=x.dtype, device=x.device)
    for c in range(chunks.shape[1]):
        acc = acc + chunks[:, c, :]
    while lanes > 1:
        lanes //= 2
        acc = acc[:, :lanes] + acc[:, lanes:]
    return acc[:, 0]


def _fill_rounds(caps, ws, slots, live) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version on bucket-width rows; returns ``(alloc, rounds)``
    where ``rounds[b]`` counts the rounds row ``b`` ran with its guard
    True (the work the kernel does for that row)."""
    w = torch.where(live, ws, 0.0)
    c = torch.where(live, caps, 0.0)
    alloc = torch.zeros_like(caps)
    active = live & (c > 0.0)
    free = slots.clone()
    rounds = torch.zeros(caps.shape[0], dtype=torch.int64, device=caps.device)
    for _ in range(caps.shape[-1] + 1):
        # The reference loop's cond, carried as a per-row guard; the loop
        # ends once no row continues (a host sync per round).
        go = (free > _EPS) & active.any(dim=-1)
        if not bool(go.any()):
            break
        rounds += go.to(torch.int64)
        w_act = torch.where(active, w, 0.0)
        total_w = _tree_sum(w_act)
        w_ok = total_w > 0.0
        denom = torch.where(w_ok, total_w, 1.0)
        share = torch.where(active, free[:, None] * w_act / denom[:, None], 0.0)
        headroom = c - alloc
        capped = active & (share >= headroom - _EPS)
        cont = w_ok & capped.any(dim=-1)
        grant_capped = torch.where(capped, headroom, 0.0)
        grant = torch.where(
            cont[:, None], grant_capped,
            torch.where(w_ok[:, None], share, 0.0),
        )
        alloc2 = alloc + grant
        free2 = torch.where(cont, free - _tree_sum(grant_capped), free)
        active2 = cont[:, None] & active & ~capped
        alloc = torch.where(go[:, None], alloc2, alloc)
        active = torch.where(go[:, None], active2, active)
        free = torch.where(go, free2, free)
    return alloc, rounds


def _padded(caps, ws, slots, live):
    """Validate ``(B, W)`` rows and pad them to the bucket width with
    inert lanes (cap 0, weight 0, not live)."""
    if caps.dim() != 2:
        raise ValueError(f"caps must be (B, W), got shape {tuple(caps.shape)}")
    b, w = caps.shape
    for name, x in (("ws", ws), ("live", live)):
        if x.shape != caps.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != caps {(b, w)}")
    if slots.shape != (b,):
        raise ValueError(f"slots must be (B,) = ({b},), got {tuple(slots.shape)}")
    if caps.dtype != torch.float64 or ws.dtype != torch.float64 \
            or slots.dtype != torch.float64:
        raise TypeError("caps, ws and slots must be float64")
    if live.dtype != torch.bool:
        raise TypeError(f"live must be bool, got {live.dtype}")
    devs = {caps.device, ws.device, slots.device, live.device}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on different devices: {devs}")
    wp = _bucket(w)
    if wp > _MAX_WIDTH:
        raise ValueError(f"width {w} pads to {wp} > {_MAX_WIDTH}")
    if wp != w:
        pad = wp - w

        def ext(x, fill):
            tail = torch.full((b, pad), fill, dtype=x.dtype, device=x.device)
            return torch.cat([x, tail], dim=1)

        caps, ws, live = ext(caps, 0.0), ext(ws, 0.0), ext(live, False)
    return caps.contiguous(), ws.contiguous(), slots.contiguous(), \
        live.contiguous(), w


def water_fill_reference(caps, ws, slots, live) -> torch.Tensor:
    """Plain PyTorch water-fill over ``(B, W)`` rows, any device.

    ``caps``/``ws`` f64 ``(B, W)``, ``slots`` f64 ``(B,)``, ``live`` bool
    ``(B, W)``; returns the f64 ``(B, W)`` allocation."""
    caps, ws, slots, live, w = _padded(caps, ws, slots, live)
    return _fill_rounds(caps, ws, slots, live)[0][:, :w]


@functools.lru_cache(maxsize=1)
def _kernel():
    """The C entry point of ``csrc/waterfill.cu``, built on first use."""
    from repro_torch import _build

    fn = _build.load("waterfill").repro_waterfill_f64
    # caps, ws, slots, live, out, rows, width, stream
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def water_fill_cuda(caps, ws, slots, live) -> torch.Tensor:
    """Launch the CUDA kernel on ``(B, W)`` rows that lie on a CUDA device
    (same arguments as :func:`water_fill_reference`)."""
    global launches
    if caps.device.type != "cuda":
        raise ValueError(
            f"water_fill_cuda needs CUDA tensors, got {caps.device}; the "
            "plain version is water_fill_reference"
        )
    caps, ws, slots, live, w = _padded(caps, ws, slots, live)
    b, wp = caps.shape
    out = torch.empty_like(caps)
    if b == 0:
        return out[:, :w]
    fn = _kernel()
    with torch.cuda.device(caps.device):
        stream = torch.cuda.current_stream(caps.device).cuda_stream
        err = fn(caps.data_ptr(), ws.data_ptr(), slots.data_ptr(),
                 live.data_ptr(), out.data_ptr(), b, wp, stream)
    if err != 0:
        raise RuntimeError(
            f"waterfill kernel launch failed: cudaError {err} "
            f"(rows={b}, width={wp})"
        )
    launches += 1
    return out[:, :w]


def water_fill(caps, ws, slots, live) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if caps.device.type == "cuda":
        return water_fill_cuda(caps, ws, slots, live)
    if caps.device.type == "cpu":
        return water_fill_reference(caps, ws, slots, live)
    raise ValueError(f"unsupported device {caps.device}")
