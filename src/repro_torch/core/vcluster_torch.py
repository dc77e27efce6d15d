"""Torch backend for the virtual cluster's numeric kernels.

The port of ``repro.core.vcluster_jax``: padded fixed-shape replacements
for the two hot loops of :mod:`repro_torch.core.vcluster`, numpy in and
numpy out, on a torch device.

* :func:`water_fill` / :func:`water_fill_batch` — the weighted max-min
  allocation, through the water-fill K1 (:mod:`repro_torch.accel.waterfill`:
  the CUDA kernel for a CUDA device, its plain version on the CPU);
* :func:`project_finish_times` — the processor-sharing forward
  simulation behind HFSP's schedule order, through the projection kernel
  (:mod:`repro_torch.core.projection`) with a warm-started water level,
  in segments that compact the survivors into shrinking buckets: on a
  CUDA device inside one launch (the kernel's segmented route), on the
  CPU in :func:`segments`, one plain call each;
* :func:`project_finish_times_batch` — B projections in one launch.

Shape contract: inputs are padded to :func:`_bucket` widths (pow2 from 8
to 1024, then 1024 multiples) with inert lanes (``present`` / ``live``
False, zeros), and padding is bitwise neutral: padded lanes add +0.0 to
every sum and never finish.  Everything runs in float64.

``device`` defaults to ``"cuda"`` and is resolved by
:func:`repro_torch.resolve_device`: without CUDA a CUDA request raises.
:data:`calls` counts the kernel calls these entry points make, so that a
run can hold the kernels' own launch counters to them.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import KernelInputError, resolve_device
from repro_torch.accel import waterfill
from repro_torch.core import projection

__all__ = [
    "water_fill",
    "water_fill_batch",
    "project_finish_times",
    "project_finish_times_batch",
    "segments",
]

#: Calls of the water-fill (``"water_fill"``) and the projection
#: (``"project"``) made by the entry points below, one per kernel call.
calls = {"water_fill": 0, "project": 0}


#: Padded buffer width for ``n`` live jobs: next power of two up to 1024,
#: then the next multiple of 1024 (floor 8) — K1's widths.
_bucket = waterfill._bucket


def _to(dev: torch.device, arr: np.ndarray) -> torch.Tensor:
    """One host-to-device copy (none on the CPU)."""
    return torch.from_numpy(arr).to(dev)


@torch.inference_mode()
def _fill(caps_p: np.ndarray, ws_p: np.ndarray, slots_b: np.ndarray,
          live: np.ndarray, dev: torch.device) -> np.ndarray:
    """K1 on padded ``(B, W)`` rows; returns the ``(B, W)`` allocation."""
    b, w = caps_p.shape
    packed = _to(dev, np.concatenate([caps_p.ravel(), ws_p.ravel(), slots_b]))
    live_t = _to(dev, live)
    calls["water_fill"] += 1
    out = waterfill.water_fill(
        packed[:b * w].view(b, w), packed[b * w:2 * b * w].view(b, w),
        packed[2 * b * w:], live_t)
    return out.cpu().numpy()


def water_fill(caps: np.ndarray, ws: np.ndarray, slots: float,
               device="cuda") -> np.ndarray:
    """Weighted max-min allocation; drop-in for ``vcluster._water_fill``."""
    dev = resolve_device(device)
    n = len(caps)
    if n == 0:
        return np.zeros(0)
    width = _bucket(n)
    caps_p = np.zeros((1, width))
    ws_p = np.zeros((1, width))
    caps_p[0, :n] = caps
    ws_p[0, :n] = ws
    live = np.zeros((1, width), dtype=bool)
    live[0, :n] = True
    return _fill(caps_p, ws_p, np.array([float(slots)]), live, dev)[0, :n]


def water_fill_batch(caps_b: np.ndarray, ws_b: np.ndarray, slots,
                     device="cuda") -> np.ndarray:
    """B water-fills in one launch: ``caps_b``/``ws_b`` are (B, N), and
    ``slots`` a scalar or a (B,) vector."""
    dev = resolve_device(device)
    caps_b = np.asarray(caps_b, np.float64)
    if caps_b.ndim != 2:
        raise KernelInputError("caps_b must be (B, N)")
    b, n = caps_b.shape
    if b == 0 or n == 0:
        return np.zeros((b, n))
    width = _bucket(n)
    pad = ((0, 0), (0, width - n))
    live = np.zeros((b, width), dtype=bool)
    live[:, :n] = True
    slots_b = np.broadcast_to(np.asarray(slots, np.float64), (b,)).copy()
    out = _fill(np.pad(caps_b, pad), np.pad(np.asarray(ws_b, np.float64), pad),
                slots_b, live, dev)
    return out[:, :n]


@torch.inference_mode()
def _project_args(rem_p, caps_p, ws_p, present, slots_b, now_b, lam_b, dev):
    """Padded numpy ``(B, W)`` rows as the projection's device tensors,
    the f64 ones in one host-to-device copy."""
    b, w = rem_p.shape
    packed = _to(dev, np.concatenate([
        rem_p.ravel(), caps_p.ravel(), ws_p.ravel(), slots_b, now_b, lam_b]))
    bw = b * w
    rows = [packed[k * bw:(k + 1) * bw].view(b, w) for k in range(3)]
    scal = [packed[3 * bw + k * b:3 * bw + (k + 1) * b] for k in range(3)]
    return [*rows, _to(dev, present), *scal]


@torch.inference_mode()
def _project(args, floor, segmented=False):
    """One projection kernel call on device tensors; returns the carry."""
    calls["project"] += 1
    return projection.project(*args, floor, segmented=segmented)


def segments(args):
    """Run one row of the projection (device tensors ``rem, caps, ws,
    present, slots, now, lam0`` of shape ``(1, W)`` and ``(1,)``) in
    :func:`~repro_torch.core.projection.segments`, one call each: at
    bucket widths of 1024 and more a call stops when the live count falls
    to half the width, the host compacts the survivors into a narrower
    row, and the next call resumes with the carried clock and water
    level.  Yields ``(lanes, args, floor, carry)`` per segment, where
    ``lanes`` gives each lane's index in the first row."""
    return projection.segments(args, _project)


def project_finish_times(rem: np.ndarray, caps: np.ndarray, ws: np.ndarray,
                         slots: float, now: float,
                         device="cuda") -> np.ndarray:
    """PS finish times; drop-in for ``vcluster.project_finish_times``
    (array-shaped: callers keep their own id <-> index mapping).  Rows of
    1024 jobs and more shrink in segments as their jobs finish: on a CUDA
    device in one launch, on the CPU in :func:`segments`."""
    dev = resolve_device(device)
    n = len(rem)
    if n == 0:
        return np.zeros(0)
    width = _bucket(n)
    pad = (0, width - n)
    present = np.zeros((1, width), dtype=bool)
    present[0, :n] = True
    args = _project_args(
        np.pad(np.asarray(rem, np.float64), pad)[None],
        np.pad(np.asarray(caps, np.float64), pad)[None],
        np.pad(np.asarray(ws, np.float64), pad)[None], present,
        np.array([float(slots)]), np.array([float(now)]), np.zeros(1), dev)
    if dev.type == "cuda":
        return _project(args, 0, segmented=True)[2][0, :n].cpu().numpy()
    fin_out = np.empty(width)
    for lanes, _, _, carry in segments(args):
        fin_out[lanes.cpu().numpy()] = carry[2][0].cpu().numpy()
    return fin_out[:n]


def project_finish_times_batch(rem_b: np.ndarray, caps_b: np.ndarray,
                               ws_b: np.ndarray, slots, now, n_valid=None,
                               device="cuda") -> np.ndarray:
    """Batched what-if projections: one launch for B scenarios.

    ``rem_b``/``caps_b``/``ws_b`` are (B, N) scenario matrices; ``slots``
    and ``now`` are scalars or (B,) vectors.  ``n_valid`` optionally gives
    the per-row live-prefix length (defaults to N for every row).  Returns
    a (B, N) matrix of absolute finish times; entries beyond a row's
    ``n_valid`` are meaningless."""
    dev = resolve_device(device)
    rem_b = np.asarray(rem_b, np.float64)
    if rem_b.ndim != 2:
        raise KernelInputError("rem_b must be (B, N)")
    b, n = rem_b.shape
    if b == 0 or n == 0:
        return np.zeros((b, n))
    width = _bucket(n)
    pad = ((0, 0), (0, width - n))
    present = np.zeros((b, width), dtype=bool)
    if n_valid is None:
        present[:, :n] = True
    else:
        for i, nv in enumerate(np.broadcast_to(n_valid, (b,))):
            present[i, : int(nv)] = True
    slots_b = np.broadcast_to(np.asarray(slots, np.float64), (b,)).copy()
    now_b = np.broadcast_to(np.asarray(now, np.float64), (b,)).copy()
    state = _project(_project_args(
        np.pad(rem_b, pad), np.pad(np.asarray(caps_b, np.float64), pad),
        np.pad(np.asarray(ws_b, np.float64), pad), present, slots_b, now_b,
        np.zeros(b), dev), 0)
    return state[2][:, :n].cpu().numpy()
