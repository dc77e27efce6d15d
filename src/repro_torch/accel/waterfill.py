"""The weighted max-min water-fill: a CUDA kernel and its plain version.

Replaces the TPU kernel ``repro/accel/waterfill_pallas.py::_pallas_fill``
(the Pallas kernel behind ``water_fill_pallas``), which the accel cell
step runs for both of an hfsp step's virtual clusters: the MAP one and
the REDUCE one.  Per row: fill the free slots in proportion to weight,
clamp at each entry's cap, hand the overflow back, repeat until nobody
is capped (at most ``width + 1`` guarded rounds; every round after the
guard goes False is an exact no-op).

* :func:`water_fill_cuda` launches ``csrc/waterfill.cu`` on one set of
  rows; :func:`water_fill_pair_cuda` launches it once on both phases of
  a cell step, which share the weights (rows of width <= 256: a warp per
  row, shuffle reductions; wider rows: a block per row).  Both check
  their arguments; :func:`launch_pair` is the same launch without the
  checks, for a batch that :func:`check_batch` has vouched for once.
* :func:`water_fill_reference` is the plain PyTorch version, and
  :func:`water_fill_pair_reference` its pair form (one call on the
  stacked rows; rows are independent).  It sums in the kernel's fixed
  order (:func:`_tree_sum`), so the two agree bitwise, and reruns are
  bitwise equal.
* :func:`water_fill` and :func:`water_fill_pair` dispatch on where the
  tensors lie: the kernel for CUDA tensors, the plain version for CPU
  tensors.  There is no fallback from one to the other.

Bound on the card: a row moves ``width * (8 + 8 + 1 + 8) + 8`` bytes and
does a few f64 operations per lane per round, so at the main path's
shapes (32 rows of width 128 per pair, a handful of rounds) a launch is
latency-bound: far below both the memory and the f64 rate.  The kernel
keeps the whole fixpoint of both phases in one launch per step; fusing
the entire cell step into one kernel (or capturing a chunk in a CUDA
graph) is the next lever, see ROADMAP.md.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import KernelError, KernelInputError

#: Kernel launches made by :func:`water_fill_cuda`,
#: :func:`water_fill_pair_cuda` and :func:`launch_pair` (one per call; a
#: pair is one launch).
launches = 0

_WARP = 32
_SEGMENT = 8 * _WARP  # lanes a warp sums before the cross-segment tree
_MAX_WIDTH = 32 * 1024  # the widest row the kernel takes
_EPS = 1e-12


def _bucket(n: int) -> int:
    """The padded width quantization of the accel cell (pow2 to 1024,
    then 1024 multiples); the kernel takes exactly these widths."""
    if n <= 8:
        return 8
    if n <= 1024:
        return 1 << (n - 1).bit_length()
    return -(-n // 1024) * 1024


def _halve(x: torch.Tensor) -> torch.Tensor:
    """``(..., n) -> (...)`` for a power of two ``n``: the stride-halving
    tree, ``x[i] + x[i + n/2]`` first.  Over 32 it is what lane 0 ends a
    warp's ``__shfl_xor_sync`` butterfly with (the step at offset ``s``
    adds ``x[i] + x[i ^ s]``, which for ``i < s`` is ``x[i] + x[i + s]``)."""
    n = x.shape[-1]
    while n > 1:
        n //= 2
        x = x[..., :n] + x[..., n:2 * n]
    return x[..., 0]


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of a ``(B, W)`` tensor in the kernel's order: lane ``i`` is
    slot ``(i % 256) // 32`` of thread ``i % 32`` of segment ``i // 256``;
    each thread sums its slots of a segment in order from +0.0, each
    segment's 32 thread sums go through the warp butterfly, and the
    segment sums, padded with +0.0 to a power of two >= 32, through the
    stride-halving tree.  Lanes, slots and segments past the row are
    +0.0 and no partial is -0.0, so they move no bit: they are left out
    here where that saves work."""
    b, w = x.shape
    segs = -(-w // _SEGMENT)
    slots = _SEGMENT // _WARP if segs > 1 else max(1, -(-w // _WARP))
    pad = segs * slots * _WARP - w
    if pad:
        x = torch.cat([x, x.new_zeros(b, pad)], dim=1)
    chunks = x.reshape(b, segs, slots, _WARP).unbind(2)
    acc = chunks[0]  # +0.0 + x is x
    for j in range(1, slots):
        acc = acc + chunks[j]
    part = _halve(acc)
    if segs == 1:
        return part[:, 0]
    n = max(_WARP, 1 << (segs - 1).bit_length())
    return _halve(torch.cat([part, part.new_zeros(b, n - segs)], dim=1))


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
        rounds += go
        w_act = torch.where(active, w, 0.0)
        total_w = _tree_sum(w_act)
        w_ok = total_w > 0.0
        # A lane that is not active has w_act +0.0, and a row that goes
        # has free > 0, so its share is +0.0, as the kernel's; with w_ok
        # False every share is +0.0, the kernel's grant.
        share = free[:, None] * w_act / torch.where(w_ok, total_w, 1.0)[:, None]
        headroom = c - alloc
        capped = active & (share >= headroom - _EPS)
        cont = w_ok & capped.any(dim=-1)
        grant_capped = torch.where(capped, headroom, 0.0)
        grant = torch.where(cont[:, None], grant_capped, share)
        free2 = torch.where(cont, free - _tree_sum(grant_capped), free)
        alloc = torch.where(go[:, None], alloc + grant, alloc)
        active = torch.where(go[:, None], cont[:, None] & active & ~capped,
                             active)
        free = torch.where(go, free2, free)
    return alloc, rounds


def _padded(caps, ws, slots, live):
    """Validate ``(B, W)`` rows and pad them to the bucket width with
    inert lanes (cap 0, weight 0, not live)."""
    if caps.dim() != 2:
        raise KernelInputError(
            f"caps must be (B, W), got shape {tuple(caps.shape)}")
    b, w = caps.shape
    for name, x in (("ws", ws), ("live", live)):
        if x.shape != caps.shape:
            raise KernelInputError(
                f"{name} shape {tuple(x.shape)} != caps {(b, w)}")
    if slots.shape != (b,):
        raise KernelInputError(
            f"slots must be (B,) = ({b},), got {tuple(slots.shape)}")
    if caps.dtype != torch.float64 or ws.dtype != torch.float64 \
            or slots.dtype != torch.float64:
        raise KernelInputError("caps, ws and slots must be float64")
    if live.dtype != torch.bool:
        raise KernelInputError(f"live must be bool, got {live.dtype}")
    devs = {caps.device, ws.device, slots.device, live.device}
    if len(devs) != 1:
        raise KernelInputError(f"inputs lie on different devices: {devs}")
    wp = _bucket(w)
    if wp > _MAX_WIDTH:
        raise KernelInputError(f"width {w} pads to {wp} > {_MAX_WIDTH}")
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


def _check_pair(caps_m, caps_r, slots_m, slots_r, live_m, live_r):
    """The two phases of a pair have one shape (they share ``ws``)."""
    for name, m, r in (("caps", caps_m, caps_r), ("slots", slots_m, slots_r),
                       ("live", live_m, live_r)):
        if m.shape != r.shape:
            raise KernelInputError(f"{name}_m shape {tuple(m.shape)} != "
                                   f"{name}_r {tuple(r.shape)}")


def water_fill_pair_reference(caps_m, caps_r, ws, slots_m, slots_r, live_m,
                              live_r) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch water-fill of both phases of a cell step, which share
    the weights ``ws``: one call of :func:`water_fill_reference` on the
    stacked rows (bitwise two calls: rows are independent)."""
    _check_pair(caps_m, caps_r, slots_m, slots_r, live_m, live_r)
    out = water_fill_reference(
        torch.cat([caps_m, caps_r]), torch.cat([ws, ws]),
        torch.cat([slots_m, slots_r]), torch.cat([live_m, live_r]))
    return out[:caps_m.shape[0]], out[caps_m.shape[0]:]


@functools.lru_cache(maxsize=1)
def _kernel():
    """The C entry point of ``csrc/waterfill.cu``, built on first use."""
    from repro_torch import _build

    fn = _build.load("waterfill").repro_waterfill_f64
    # caps_m, caps_r, ws, slots_m, slots_r, live_m, live_r, out_m, out_r,
    # rows, phases, width, stream
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(caps_m, caps_r, ws, slots_m, slots_r, live_m, live_r, out_m,
            out_r, rows: int, phases: int) -> None:
    """One launch on PyTorch's current stream of the tensors' device; no
    checks (the callers make them).  ``out_m``/``out_r`` are pointers."""
    global launches
    fn = _kernel()
    width = ws.shape[1]
    args = (caps_m.data_ptr(), caps_r.data_ptr(), ws.data_ptr(),
            slots_m.data_ptr(), slots_r.data_ptr(), live_m.data_ptr(),
            live_r.data_ptr(), out_m, out_r, rows, phases, width)
    # The raw handle of the device's current stream: the public
    # torch.cuda.current_stream() builds a Stream object on every call,
    # which costs more host time than the rest of this function.
    idx = ws.device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch.cuda.current_device():
        err = fn(*args, stream)
    else:
        with torch.cuda.device(idx):
            err = fn(*args, stream)
    if err != 0:
        raise KernelError(
            f"waterfill kernel launch failed: cudaError {err} "
            f"(rows={rows}, phases={phases}, width={width})"
        )
    launches += 1


def _require_cuda(x: torch.Tensor, fn: str) -> None:
    if x.device.type != "cuda":
        raise KernelInputError(
            f"{fn} needs CUDA tensors, got {x.device}; the plain version "
            "takes CPU tensors"
        )


def water_fill_cuda(caps, ws, slots, live) -> torch.Tensor:
    """Launch the CUDA kernel on ``(B, W)`` rows that lie on a CUDA device
    (same arguments as :func:`water_fill_reference`)."""
    _require_cuda(caps, "water_fill_cuda")
    caps, ws, slots, live, w = _padded(caps, ws, slots, live)
    b = caps.shape[0]
    out = torch.empty_like(caps)
    if b:
        _launch(caps, caps, ws, slots, slots, live, live, out.data_ptr(),
                out.data_ptr(), b, 1)
    return out[:, :w]


def check_batch(ws, slots_m, slots_r) -> None:
    """Check once what every step of a cell batch hands :func:`launch_pair`:
    ``ws`` a contiguous f64 ``(B, W)`` tensor on a CUDA device at a bucket
    width the kernel takes, the slots contiguous f64 ``(B,)`` on the same
    device.  The cell step derives each step's caps (f64) and live masks
    (bool) elementwise from the same batch, so they share its shape and
    device and are contiguous."""
    _require_cuda(ws, "launch_pair")
    if ws.dim() != 2 or ws.dtype != torch.float64 or not ws.is_contiguous():
        raise KernelInputError(
            "ws must be a contiguous f64 (B, W) tensor, got "
            f"{ws.dtype} {tuple(ws.shape)}")
    b, w = ws.shape
    if _bucket(w) != w or w > _MAX_WIDTH:
        raise KernelInputError(
            f"width {w} is not a bucket width <= {_MAX_WIDTH}")
    for slots in (slots_m, slots_r):
        if slots.shape != (b,) or slots.dtype != torch.float64 \
                or slots.device != ws.device or not slots.is_contiguous():
            raise KernelInputError(
                f"slots must be contiguous f64 ({b},) on {ws.device}, got "
                f"{slots.dtype} {tuple(slots.shape)} on {slots.device}")


def launch_pair(caps_m, caps_r, ws, slots_m, slots_r, live_m,
                live_r) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch for both phases of a cell step, without checks: the
    caller vouches for its tensors (:func:`check_batch` once per batch).
    Returns ``(alloc_m, alloc_r)``."""
    b, w = ws.shape
    out = torch.empty((2, b, w), dtype=torch.float64, device=ws.device)
    if b:
        ptr = out.data_ptr()
        _launch(caps_m, caps_r, ws, slots_m, slots_r, live_m, live_r, ptr,
                ptr + b * w * out.element_size(), b, 2)
    return out.unbind(0)


def water_fill_pair_cuda(caps_m, caps_r, ws, slots_m, slots_r, live_m,
                         live_r) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel once on both phases of a cell step: the MAP
    rows ``(caps_m, slots_m, live_m)`` and the REDUCE rows ``(caps_r,
    slots_r, live_r)``, each ``(B, W)`` as :func:`water_fill_reference`
    takes them, sharing the weights ``ws``.  Returns ``(alloc_m,
    alloc_r)``."""
    _require_cuda(caps_m, "water_fill_pair_cuda")
    _check_pair(caps_m, caps_r, slots_m, slots_r, live_m, live_r)
    caps_m, wsp, slots_m, live_m, w = _padded(caps_m, ws, slots_m, live_m)
    caps_r, _, slots_r, live_r, _ = _padded(caps_r, ws, slots_r, live_r)
    alloc_m, alloc_r = launch_pair(caps_m, caps_r, wsp, slots_m, slots_r,
                                   live_m, live_r)
    return alloc_m[:, :w], alloc_r[:, :w]


def water_fill(caps, ws, slots, live) -> torch.Tensor:
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if caps.device.type == "cuda":
        return water_fill_cuda(caps, ws, slots, live)
    if caps.device.type == "cpu":
        return water_fill_reference(caps, ws, slots, live)
    raise KernelInputError(f"unsupported device {caps.device}")


def water_fill_pair(caps_m, caps_r, ws, slots_m, slots_r, live_m,
                    live_r) -> tuple[torch.Tensor, torch.Tensor]:
    """Both phases of a cell step: the kernel (one launch) for CUDA
    tensors, the plain version for CPU tensors."""
    args = (caps_m, caps_r, ws, slots_m, slots_r, live_m, live_r)
    if caps_m.device.type == "cuda":
        return water_fill_pair_cuda(*args)
    if caps_m.device.type == "cpu":
        return water_fill_pair_reference(*args)
    raise KernelInputError(f"unsupported device {caps_m.device}")
