"""The processor-sharing finish-time projection: a CUDA kernel and its
plain version.

The counterpart of ``repro/core/vcluster_jax.py::_project_kernel`` (an
XLA ``lax.while_loop``, not a Pallas kernel), behind HFSP's schedule
order: per row, forward-simulate weighted max-min processor sharing.  At
each event the water level ``lam`` (a job's allocation is ``min(cap, lam
* w)``) is raised from its carried value until no uncapped job lies below
it, the jobs with the least remaining / allocation finish, and the rest
age.  A row stops when no job is left, when only infinite-size jobs are
left, or once its live count falls to ``floor`` (so that the host can
compact the survivors into a narrower row and resume).

* :func:`project_cuda` launches ``csrc/project.cu`` (one block per row,
  the whole event loop on the device).
  With ``segmented=True`` a row of 1024 lanes or more also runs its
  :func:`segments` on the device: one launch a projection at any width.
* :func:`project_reference` is the plain PyTorch version.  It sums in the
  kernel's order (K1's :func:`~repro_torch.accel.waterfill._tree_sum`),
  so the two agree bitwise.  :func:`project_segmented_reference` runs it
  in :func:`segments` (host compaction between calls), the plain version
  of the segmented route.
* :func:`project` dispatches on where the tensors lie: the kernel for
  CUDA tensors, the plain version for CPU tensors, with no fallback from
  one to the other.

All of them take ``rem``, ``caps``, ``ws`` (f64 ``(B, W)``), ``present``
(bool ``(B, W)``), ``slots``, ``now``, ``lam0`` (f64 ``(B,)``) and an int
``floor`` >= 0, and return the carry ``(t, rem, fin, live, lam, n_live,
run)``: ``t``, ``lam`` f64 ``(B,)``; ``rem``, ``fin`` f64 ``(B, W)``;
``live`` bool ``(B, W)``; ``n_live`` int64 ``(B,)``; ``run`` bool
``(B,)``, True where a row stopped at its floor with jobs still to run.
On the segmented route (floor 0) each lane's ``rem``, ``fin`` and
``live`` are those of the last segment it was in, at its input lane.

Bound on the card: a call moves ~42 bytes a lane and a few f64
operations per lane and event, so at the discrete-event path's widths
(8 ... 1024) it is latency-bound: the time of a call is the events it
runs times the latency of one event's chain of row reductions (the note
in ``csrc/project.cu``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import KernelError, KernelInputError
from repro_torch.accel.waterfill import _bucket, _tree_sum

#: Kernel launches made by :func:`project_cuda` (one per call).
launches = 0

_MAX_WIDTH = 32 * 1024  # the widest row the kernel takes
_EPS = 1e-12
_INF = float("inf")
#: The least bucket width that a segmented row compacts.
SEGMENT_FROM = 1024
#: What the ``project_clocks`` build writes per row into ``clocks``: the
#: events and level steps the row ran, then thread 0's cycles in each
#: phase of its events (the level steps, the event times with their
#: divisions, the least event time's round, the commit), in its
#: compactions, and in the whole kernel.
CLOCK_FIELDS = ("events", "level_steps", "level", "divide", "least_time",
                "commit", "compact", "total")


def _check(rem, caps, ws, present, slots, now, lam0, floor) -> int:
    """Validate the arguments; returns the padded width."""
    if rem.dim() != 2:
        raise KernelInputError(
            f"rem must be (B, W), got shape {tuple(rem.shape)}")
    b, w = rem.shape
    for name, x in (("caps", caps), ("ws", ws), ("present", present)):
        if x.shape != rem.shape:
            raise KernelInputError(
                f"{name} shape {tuple(x.shape)} != rem {(b, w)}")
    for name, x in (("slots", slots), ("now", now), ("lam0", lam0)):
        if x.shape != (b,):
            raise KernelInputError(
                f"{name} must be ({b},), got {tuple(x.shape)}")
    for name, x in (("rem", rem), ("caps", caps), ("ws", ws),
                    ("slots", slots), ("now", now), ("lam0", lam0)):
        if x.dtype != torch.float64:
            raise KernelInputError(f"{name} must be float64, got {x.dtype}")
    if present.dtype != torch.bool:
        raise KernelInputError(f"present must be bool, got {present.dtype}")
    devs = {x.device for x in (rem, caps, ws, present, slots, now, lam0)}
    if len(devs) != 1:
        raise KernelInputError(f"inputs lie on different devices: {devs}")
    if int(floor) < 0:
        raise KernelInputError(f"floor must be >= 0, got {floor}")
    wp = _bucket(w)
    if wp > _MAX_WIDTH:
        raise KernelInputError(f"width {w} pads to {wp} > {_MAX_WIDTH}")
    return wp


def _pad(x: torch.Tensor, width: int, fill) -> torch.Tensor:
    """``x`` widened to ``width`` lanes with ``fill`` (inert lanes)."""
    b, w = x.shape
    if w == width:
        return x.contiguous()
    tail = torch.full((b, width - w), fill, dtype=x.dtype, device=x.device)
    return torch.cat([x, tail], dim=1)


def _level(lam, capped, part, caps, ws, slots) -> torch.Tensor:
    """One level step: the level at which the uncapped part lanes take the
    slots the capped ones leave, never below ``lam``."""
    cap_sum = _tree_sum(torch.where(capped, caps, 0.0))
    w_unc = _tree_sum(torch.where(part & ~capped, ws, 0.0))
    ok = w_unc > 0.0
    lam2 = torch.where(ok, (slots - cap_sum) / torch.where(ok, w_unc, 1.0),
                       _INF)
    return torch.maximum(lam2, lam)


def _below(lam, part, caps, ws) -> torch.Tensor:
    """Part lanes whose cap lies below level ``lam``."""
    return part & (caps <= lam[:, None] * ws + _EPS)


def _project_rows(rem, caps, ws, present, slots, now, lam0, floor,
                  counts=None):
    """The plain version on bucket-width rows.  Every row runs its own
    event loop: a row whose loop has ended is carried unchanged (a host
    sync per event and per level round).  With a dict ``counts``, adds the
    lanes the rows' work touches: the part lanes (live, weight > 0) of
    every level step (``"level_lanes"``) and of every event
    (``"event_part_lanes"``), and the live lanes of every event
    (``"event_live_lanes"``)."""
    live = present & (rem > 0.0) & (caps > 0.0)
    pos = ws > 0.0
    fin = torch.where(live, _INF, now[:, None])
    n_live = live.sum(dim=-1)
    lam = lam0.clone()
    capped = _below(lam, live & pos, caps, ws)
    t = now.clone()
    run = n_live > 0
    while True:
        go = run & (n_live > floor)
        if not bool(go.any()):
            break
        part = live & pos
        lam_c = _level(lam, capped, part, caps, ws, slots)
        cap_c = capped
        more = go & (_below(lam_c, part, caps, ws) & ~cap_c).any(dim=-1)
        if counts is not None:
            n_part = int((part & go[:, None]).sum())
            for key, n in (("level_lanes", n_part), ("event_part_lanes", n_part),
                           ("event_live_lanes", int((live & go[:, None]).sum()))):
                counts[key] = counts.get(key, 0) + n
        while bool(more.any()):
            if counts is not None:
                counts["level_lanes"] += int((part & more[:, None]).sum())
            cap2 = cap_c | _below(lam_c, part, caps, ws)
            lam2 = _level(lam_c, cap2, part, caps, ws, slots)
            more2 = (_below(lam2, part, caps, ws) & ~cap2).any(dim=-1)
            cap_c = torch.where(more[:, None], cap2, cap_c)
            lam_c = torch.where(more, lam2, lam_c)
            more = more & more2
        alloc = torch.where(
            part, torch.where(cap_c, caps,
                              torch.minimum(caps, lam_c[:, None] * ws)), 0.0)
        dt = torch.where(live & (alloc > 0.0), rem / alloc, _INF)
        dt_min = dt.amin(dim=-1)
        commit = go & torch.isfinite(dt_min)
        t2 = t + dt_min
        rem2 = torch.where(
            live, (rem - alloc * dt_min[:, None]).clamp_min(0.0), rem)
        done = live & (dt <= (dt_min + _EPS)[:, None])
        live2 = live & ~done
        n2 = n_live - done.sum(dim=-1)
        c = commit[:, None]
        t = torch.where(commit, t2, t)
        rem = torch.where(c, rem2, rem)
        fin = torch.where(c & done, t2[:, None], fin)
        live = torch.where(c, live2, live)
        lam = torch.where(commit, lam_c, lam)
        capped = torch.where(c, cap_c & live2, capped)
        n_live = torch.where(commit, n2, n_live)
        # A row whose least event time is infinite (only infinite-size
        # jobs left) stops with nothing committed.
        run = torch.where(go, commit & (n2 > 0), run)
    return t, rem, fin, live, lam, n_live, run


def _padded(rem, caps, ws, present, slots, now, lam0, floor):
    """Validated arguments, rows padded to the bucket width with inert
    lanes; returns them and the width they had."""
    wp = _check(rem, caps, ws, present, slots, now, lam0, floor)
    return (_pad(rem, wp, 0.0), _pad(caps, wp, 0.0), _pad(ws, wp, 0.0),
            _pad(present, wp, False), slots.contiguous(), now.contiguous(),
            lam0.contiguous(), int(floor)), rem.shape[1]


def project_reference(rem, caps, ws, present, slots, now, lam0, floor=0,
                      counts=None):
    """Plain PyTorch projection over ``(B, W)`` rows, any device (with a
    dict ``counts``, adds the lanes its work touches, as
    :func:`_project_rows` does)."""
    args, w = _padded(rem, caps, ws, present, slots, now, lam0, floor)
    t, rem2, fin, live, lam, n_live, run = _project_rows(*args, counts=counts)
    return t, rem2[:, :w], fin[:, :w], live[:, :w], lam, n_live, run


def segment_floor(width: int) -> int:
    """The live count at which a row of bucket width ``width`` stops so
    that its survivors can be compacted: half the width from
    :data:`SEGMENT_FROM` lanes, else 0 (run to the end)."""
    return width // 2 if width >= SEGMENT_FROM else 0


def segments(args, call):
    """Run one row of the projection (tensors ``rem, caps, ws, present,
    slots, now, lam0`` of shape ``(1, W)`` and ``(1,)``) in segments:
    ``call(args, floor)`` projects until the live count falls to
    :func:`segment_floor` of the row's bucket width, the survivors are
    compacted in lane order into a narrower row, and the simulation
    resumes with the carried clock and water level.  Yields ``(lanes,
    args, floor, carry)`` per segment, where ``lanes`` (an int64 tensor on
    the row's device) gives each lane's index in the first row."""
    lanes = torch.arange(args[0].shape[1], device=args[0].device)
    while True:
        floor = segment_floor(_bucket(args[0].shape[1]))
        carry = call(args, floor)
        yield lanes, args, floor, carry
        t, rem, _, live, lam, n_live, run = carry
        if floor == 0 or int(n_live[0]) == 0 or not bool(run[0]):
            return
        alive = torch.nonzero(live[0]).flatten()
        lanes = lanes[alive]
        args = [rem[:, alive], args[1][:, alive], args[2][:, alive],
                args[3][:, alive], args[4], t, lam]


def project_segmented_reference(rem, caps, ws, present, slots, now, lam0,
                                counts=None):
    """The plain version of the segmented route: each row in
    :func:`segments` of :func:`project_reference` calls, every lane's
    ``rem``, ``fin`` and ``live`` taken from the last segment it was in
    and put back at its input lane; ``t``, ``lam``, ``n_live`` and ``run``
    are the last segment's.  ``counts`` as for :func:`project_reference`."""
    _check(rem, caps, ws, present, slots, now, lam0, 0)
    rem_out, fin = rem.clone(), torch.empty_like(rem)
    live = torch.zeros_like(present)
    t, lam = now.clone(), lam0.clone()
    n_live = torch.zeros(rem.shape[0], dtype=torch.int64, device=rem.device)
    run = torch.zeros(rem.shape[0], dtype=torch.bool, device=rem.device)

    def call(args, floor):
        return project_reference(*args, floor, counts=counts)

    for i in range(rem.shape[0]):
        row = [x[i:i + 1] for x in (rem, caps, ws, present, slots, now, lam0)]
        for lanes, _, _, carry in segments(row, call):
            rem_out[i, lanes] = carry[1][0]
            fin[i, lanes] = carry[2][0]
            live[i, lanes] = carry[3][0]
        t[i], lam[i] = carry[0][0], carry[4][0]
        n_live[i], run[i] = carry[5][0], carry[6][0]
    return t, rem_out, fin, live, lam, n_live, run


@functools.lru_cache(maxsize=2)
def _kernel(name: str = "project"):
    """The C entry point of ``csrc/project.cu`` in build ``name``
    (``project``, or ``project_clocks`` with the phase stamps), built on
    first use."""
    from repro_torch import _build

    fn = _build.load(name).repro_project_f64
    # rem, caps, ws, present, slots, now, lam0, t, rem_out, fin, live, lam,
    # n_live, run, rows, width, floor, segmented, work, clocks, stream
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return fn


def project_cuda(rem, caps, ws, present, slots, now, lam0, floor=0, *,
                 segmented=False, clocks=None):
    """Launch the CUDA kernel on ``(B, W)`` rows that lie on a CUDA device
    (same arguments and results as :func:`project_reference`; with
    ``segmented``, as :func:`project_segmented_reference`, in one launch).
    ``clocks``, an int64 ``(B, len(CLOCK_FIELDS))`` CUDA tensor, selects
    the ``project_clocks`` build, which writes each row's phase cycles
    there (timing only)."""
    global launches
    if rem.device.type != "cuda":
        raise KernelInputError(
            f"project_cuda needs CUDA tensors, got {rem.device}; the plain "
            "version takes CPU tensors"
        )
    if segmented and int(floor) != 0:
        raise KernelInputError(
            f"the segmented route runs to the end (floor 0), got {floor}")
    (rem_p, caps_p, ws_p, present_p, slots, now, lam0, floor), w = _padded(
        rem, caps, ws, present, slots, now, lam0, floor)
    b, wp = rem_p.shape
    dev = rem.device
    if clocks is not None and (
            clocks.device != dev or clocks.dtype != torch.int64
            or tuple(clocks.shape) != (b, len(CLOCK_FIELDS))
            or not clocks.is_contiguous()):
        raise KernelInputError(
            f"clocks must be a contiguous int64 ({b}, {len(CLOCK_FIELDS)}) "
            f"tensor on {dev}")
    # The segmented route's scratch rows: rem, caps, ws and lane indices.
    work = (torch.empty(b * wp * 4, dtype=torch.float64, device=dev)
            if segmented and wp >= SEGMENT_FROM else None)
    # Two buffers hold the f64 and the byte results.
    fbuf = torch.empty(2 * b + 2 * b * wp, dtype=torch.float64, device=dev)
    ubuf = torch.empty(b + b * wp, dtype=torch.uint8, device=dev)
    n_live = torch.empty(b, dtype=torch.int64, device=dev)
    t, lam = fbuf[:b], fbuf[b:2 * b]
    rem_out = fbuf[2 * b:2 * b + b * wp].view(b, wp)
    fin = fbuf[2 * b + b * wp:].view(b, wp)
    live, run = ubuf[:b * wp].view(b, wp), ubuf[b * wp:]
    if b:
        fn = _kernel("project" if clocks is None else "project_clocks")
        args = (rem_p.data_ptr(), caps_p.data_ptr(), ws_p.data_ptr(),
                present_p.data_ptr(), slots.data_ptr(), now.data_ptr(),
                lam0.data_ptr(), t.data_ptr(), rem_out.data_ptr(),
                fin.data_ptr(), live.data_ptr(), lam.data_ptr(),
                n_live.data_ptr(), run.data_ptr(), b, wp, floor,
                int(bool(segmented)),
                None if work is None else work.data_ptr(),
                None if clocks is None else clocks.data_ptr())
        idx = dev.index
        stream = torch._C._cuda_getCurrentRawStream(idx)
        if idx == torch.cuda.current_device():
            err = fn(*args, stream)
        else:
            with torch.cuda.device(idx):
                err = fn(*args, stream)
        if err != 0:
            raise KernelError(
                f"projection kernel launch failed: cudaError {err} "
                f"(rows={b}, width={wp}, floor={floor}, "
                f"segmented={bool(segmented)})"
            )
        launches += 1
    return (t, rem_out[:, :w], fin[:, :w], live.view(torch.bool)[:, :w],
            lam, n_live, run.view(torch.bool))


def project(rem, caps, ws, present, slots, now, lam0, floor=0, *,
            segmented=False):
    """The kernel for CUDA tensors, the plain version for CPU tensors
    (:func:`project_segmented_reference` with ``segmented``, which takes
    floor 0 only)."""
    if rem.device.type == "cuda":
        return project_cuda(rem, caps, ws, present, slots, now, lam0, floor,
                            segmented=segmented)
    if rem.device.type == "cpu":
        if not segmented:
            return project_reference(rem, caps, ws, present, slots, now,
                                     lam0, floor)
        if int(floor) != 0:
            raise KernelInputError(
                f"the segmented route runs to the end (floor 0), got {floor}")
        return project_segmented_reference(rem, caps, ws, present, slots,
                                           now, lam0)
    raise KernelInputError(f"unsupported device {rem.device}")
