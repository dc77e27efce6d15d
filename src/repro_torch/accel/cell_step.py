"""Fixed-shape simulation cell (the accel fluid model), batched in torch.

Port of ``repro.accel.cell_step``.  One *cell* = one scenario (workload
seed × policy × error model) run to completion as a fluid approximation
with a fully static shape, so a whole sweep matrix advances as one
``(B, J)`` batch:

* **Padded event window.**  A cell is synthesized host-side into flat
  ``(J,)`` arrays padded to a bucket width; padding rows have
  ``present=0`` / ``arrival=inf`` and are inert (bitwise: the padding
  neutrality test re-packs at a wider width).
* **Fluid service.**  Per phase the cell tracks remaining serialized
  work; a job's real-cluster parallelism cap is its phase task count
  while work remains.  REDUCE unlocks when MAP's fluid remaining hits
  zero (``reduce_slowstart=1.0``, the fb default).
* **Event-stepped loop.**  Each step advances to the next arrival-window
  close or phase completion, capped at one ``heartbeat`` for
  rank-evolving policies (srpt/las/hfsp).  Steps after a cell completes
  are exact no-ops (the ``go`` guard), so one fixed-length chunk serves
  every cell in the batch.
* **Policies as data.**  The policy is a per-cell code (fifo=0, hfsp=1,
  srpt=2, las=3); every step computes all four priority keys and selects
  by code.  hfsp's key comes from twin per-phase virtual clusters: a
  weighted water-fill over live jobs' caps (THE kernel site,
  :mod:`repro_torch.accel.waterfill`; both phases in one call) drains
  each job's virtual size.

Where JAX has ``jit(vmap(scan(step)))``, the port writes the batch out as
the leading dimension of every tensor and runs ``t_chunk`` steps as a
Python loop; PyTorch's asynchronous launches keep the device fed, and
only the ``(B,)`` done mask crosses to the host between chunks.

The water-fill ``impl`` seam hands the step a pair function, which
fills both phases' virtual clusters: ``"cuda"`` (the kernel, one launch
per step; CUDA tensors only), ``"torch"`` (the plain version, any
device) or ``"none"`` (batches with no hfsp cell never read the virtual
allocations).  The default is ``"cuda"`` on a CUDA device and
``"torch"`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import KernelInputError, resolve_device
from repro_torch.accel import waterfill as wf
from repro_torch.accel.waterfill import _bucket  # the widths the kernel takes

#: Policy name -> cell code (per-cell data, so mixed-policy batches run
#: as one batch).
POLICY_CODES = {"fifo": 0, "hfsp": 1, "srpt": 2, "las": 3}

#: Fluid remainders below this many serialized seconds snap to zero
#: (floating-point completion residue; keeps effective caps and dt
#: selection away from denormal-scale steps).
_SNAP = 1e-6

_PARAM_KEYS = (
    "arrival", "m_work", "m_dur", "m_tasks", "r_work", "r_dur",
    "r_tasks", "est_m", "est_r", "weight", "present",
    "policy", "map_slots", "red_slots", "dt_cap", "eps",
)

IMPLS = ("cuda", "torch", "none")


class ChunkBudgetError(RuntimeError):
    """A batch did not drain within ``max_chunks`` chunks of ``t_chunk``
    steps.  A property of the cells and the budget, not of the device: the
    sweep worker demotes such a batch's cells to the discrete-event path,
    where a kernel or device failure ends the run."""


# ---------------------------------------------------------------------------
# Host-side packing (numpy, identical to the reference)
# ---------------------------------------------------------------------------
def init_state(params: dict) -> dict:
    """Initial state (numpy f64) for one packed cell batch."""
    m_work = np.asarray(params["m_work"], np.float64)
    b = m_work.shape[:-1]
    return {
        "t": np.zeros(b, np.float64),
        "m_rem": m_work.copy(),
        "r_rem": np.asarray(params["r_work"], np.float64).copy(),
        "vm_rem": np.asarray(params["est_m"], np.float64).copy(),
        "vr_rem": np.asarray(params["est_r"], np.float64).copy(),
        "comp": np.zeros_like(m_work),
        "done": np.asarray(params["present"], np.float64) < 0.5,
        "steps": np.zeros(b, np.int64),
    }


def pack_cells(cells: list[dict], width: int | None = None) -> dict:
    """Stack per-cell param dicts (flat ``(J_i,)`` arrays + scalars)
    into one ``(B, J)`` batch, padding every cell to a common bucket
    width.  Padding rows: ``present=0``, ``arrival=inf``, durations 1
    (any positive value — they never activate)."""
    jmax = max(len(c["arrival"]) for c in cells)
    width = _bucket(jmax) if width is None else width
    if width < jmax:
        raise ValueError(f"width {width} < widest cell {jmax}")
    out: dict = {}
    fills = {"arrival": np.inf, "m_dur": 1.0, "r_dur": 1.0}
    for key in _PARAM_KEYS:
        vals = [np.asarray(c[key]) for c in cells]
        if vals[0].ndim == 0:
            dt = np.int32 if key == "policy" else np.float64
            out[key] = np.stack(vals).astype(dt)
            continue
        fill = fills.get(key, 0.0)
        rows = np.full((len(cells), width), fill, np.float64)
        for i, v in enumerate(vals):
            rows[i, : len(v)] = v
        out[key] = rows
    return out


def params_from_numpy(packed: dict, device="cuda") -> dict:
    """A packed batch (numpy, as :func:`pack_cells` or the reference's
    ``pack_cells`` returns it) as tensors on ``device``: f64 everywhere,
    int32 ``policy``."""
    dev = resolve_device(device)
    out = {}
    for key in _PARAM_KEYS:
        arr = np.asarray(packed[key])
        dt = torch.int32 if key == "policy" else torch.float64
        out[key] = torch.as_tensor(arr).to(device=dev, dtype=dt)
    return out


def _to_tensors(state: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(device) for k, v in state.items()}


# ---------------------------------------------------------------------------
# The step, batched over cells (leading dimension B)
# ---------------------------------------------------------------------------
def _greedy_alloc(key, caps, slots):
    """Priority-ordered greedy slot allocation per row: serve jobs in
    ascending key order, each up to its cap, until slots run out.

    Rank-free: ``cum[b, i]`` = total caps of jobs at or ahead of job i
    (strictly smaller key, or equal key and lower-or-equal index — the
    simulator's job-id tiebreak) through a ``(B, J, J)`` comparison.
    Caps are whole task counts, so the sum is exact in any order."""
    j = torch.arange(key.shape[-1], device=key.device)
    kl, kr = key[:, :, None], key[:, None, :]
    ahead = (kl < kr) | ((kl == kr) & (j[:, None] <= j[None, :]))
    cum = torch.where(ahead, caps[:, :, None], 0.0).sum(dim=1)
    x = torch.clamp(slots[:, None] - (cum - caps), min=0.0)
    return torch.minimum(x, caps)


def _clip(x, lo: float, hi):
    return torch.minimum(torch.clamp(x, min=lo), hi)


def _cell_step(params, state, water_fill_pair):
    """Advance every cell of the batch by one event window; an exact
    no-op (bitwise) for cells already done."""
    t = state["t"]
    present = params["present"] > 0.5
    arrived = present & (params["arrival"] <= t[:, None])
    live = arrived & ~state["done"]

    # Real-cluster parallelism cap = the phase's task count while fluid
    # work remains (tasks started together hold their slots to the end).
    m_active = live & (state["m_rem"] > 0.0)
    m_cap = torch.where(m_active, params["m_tasks"], 0.0)
    r_active = live & (state["m_rem"] <= 0.0) & (state["r_rem"] > 0.0)
    r_cap = torch.where(r_active, params["r_tasks"], 0.0)

    # --- priority keys, per phase; all policies computed, one selected.
    att_m = params["m_work"] - state["m_rem"]
    att_r = params["r_work"] - state["r_rem"]
    fifo_key = params["arrival"]
    srpt_m = torch.clamp(params["est_m"] - att_m, min=0.0)
    srpt_r = torch.clamp(params["est_r"] - att_r, min=0.0)
    # hfsp: twin per-phase virtual clusters, each fair-sharing its own
    # slot pool over the phase-live jobs (the water-fill kernel site);
    # the rank is the job's remaining virtual phase size.  "Late" jobs
    # (virtual size exhausted, real work left) rank 0: HFSP's aging.
    vm_live = m_active & (state["vm_rem"] > 0.0)
    vm_cap = torch.where(
        vm_live,
        _clip(torch.ceil(state["vm_rem"] / params["m_dur"] - 1e-9), 1.0,
              params["m_tasks"]),
        0.0,
    )
    vr_live = r_active & (state["vr_rem"] > 0.0)
    vr_cap = torch.where(
        vr_live,
        _clip(torch.ceil(state["vr_rem"] / params["r_dur"] - 1e-9), 1.0,
              params["r_tasks"]),
        0.0,
    )
    vm_alloc, vr_alloc = water_fill_pair(
        vm_cap, vr_cap, params["weight"], params["map_slots"],
        params["red_slots"], vm_live, vr_live,
    )

    p = params["policy"][:, None]

    def select_key(srpt_key, las_key, hfsp_key):
        return torch.where(
            p == POLICY_CODES["fifo"], fifo_key,
            torch.where(
                p == POLICY_CODES["srpt"], srpt_key,
                torch.where(p == POLICY_CODES["las"], las_key, hfsp_key),
            ),
        )

    key_m = select_key(srpt_m, att_m, state["vm_rem"])
    key_r = select_key(srpt_r, att_r, state["vr_rem"])
    m_alloc = _greedy_alloc(key_m, m_cap, params["map_slots"])
    r_alloc = _greedy_alloc(key_r, r_cap, params["red_slots"])

    # --- dt: next arrival-window close, phase completion, or heartbeat.
    inf = torch.inf
    pending = present & ~arrived
    next_arr = torch.where(pending, params["arrival"], inf).amin(dim=-1)
    dt_arr = next_arr + params["eps"] - t  # window closes eps after open
    m_fin = torch.where(m_alloc > 0.0, state["m_rem"] / m_alloc, inf)
    r_fin = torch.where(r_alloc > 0.0, state["r_rem"] / r_alloc, inf)
    # The heartbeat cap re-ranks while jobs compete; with at most one
    # live job the cell jumps straight to the next completion/arrival.
    n_live = live.to(t.dtype).sum(dim=-1)
    dt_cap = torch.where(n_live > 1.0, params["dt_cap"], inf)
    dt = torch.minimum(
        torch.minimum(dt_arr, dt_cap),
        torch.minimum(m_fin.amin(dim=-1), r_fin.amin(dim=-1)),
    )
    go = live.any(dim=-1) | pending.any(dim=-1)
    dt = torch.where(torch.isfinite(dt), dt, 0.0)

    # --- integrate ---
    dtc = dt[:, None]
    t2 = t + dt

    def drain(rem, alloc):
        rem2 = rem - alloc * dtc
        return torch.where(rem2 <= _SNAP, 0.0, rem2)

    m_rem2 = drain(state["m_rem"], m_alloc)
    r_rem2 = drain(state["r_rem"], r_alloc)
    vm_rem2 = drain(state["vm_rem"], vm_alloc)
    vr_rem2 = drain(state["vr_rem"], vr_alloc)
    newly_done = live & (m_rem2 <= 0.0) & (r_rem2 <= 0.0)

    gor = go[:, None]

    def sel(new, old):
        return torch.where(gor, new, old)

    return {
        "t": torch.where(go, t2, t),
        "m_rem": sel(m_rem2, state["m_rem"]),
        "r_rem": sel(r_rem2, state["r_rem"]),
        "vm_rem": sel(vm_rem2, state["vm_rem"]),
        "vr_rem": sel(vr_rem2, state["vr_rem"]),
        "comp": sel(torch.where(newly_done, t2[:, None], state["comp"]),
                    state["comp"]),
        "done": sel(state["done"] | newly_done, state["done"]),
        "steps": state["steps"] + go.to(state["steps"].dtype),
    }


def _zero_fill_pair(caps_m, caps_r, *_):
    # Batches with no hfsp cell never read the virtual allocations.
    return caps_m * 0.0, caps_r * 0.0


def _resolve_impl(impl: str | None, params: dict):
    """The pair function of ``impl`` for the batch ``params``; the
    kernel's batch checks run here, once."""
    device = params["arrival"].device
    if impl is None:
        impl = "cuda" if device.type == "cuda" else "torch"
    if impl == "cuda":
        if device.type != "cuda":
            raise KernelInputError(
                f"water-fill impl 'cuda' needs CUDA tensors, got {device}"
            )
        wf.check_batch(params["weight"], params["map_slots"],
                       params["red_slots"])
        return wf.launch_pair
    if impl == "torch":
        return wf.water_fill_pair_reference
    if impl == "none":
        return _zero_fill_pair
    raise ValueError(f"unknown water-fill impl {impl!r}; expected {IMPLS}")


def run_packed(
    params: dict,
    *,
    t_chunk: int = 512,
    max_chunks: int = 256,
    impl: str | None = None,
    on_chunk=None,
    run_chunk=None,
) -> dict:
    """Run a packed ``(B, J)`` cell batch (tensors from
    :func:`params_from_numpy`) to completion on the device they lie on.

    Runs ``t_chunk`` steps per chunk; after each chunk only the ``(B,)``
    done mask crosses back to the host, and finished cells no-op inside
    later chunks.  ``on_chunk(chunks_done, cells_done, cells_total)``
    runs between chunks.  ``run_chunk(chunk, state)`` runs each chunk and
    returns the state after it, where ``chunk(state)`` runs its
    ``t_chunk`` steps (an instrument can wrap the call; by default the
    chunk just runs).  Raises if ``max_chunks`` chunks don't drain
    the batch (:class:`ChunkBudgetError`: a liveness bug, not a tuning
    knob).  Returns the final
    state as numpy arrays."""
    device = params["arrival"].device
    water_fill_pair = _resolve_impl(impl, params)
    state = _to_tensors(init_state({
        k: params[k].cpu().numpy() for k in ("m_work", "r_work", "est_m",
                                             "est_r", "present")
    }), device)
    b = state["t"].shape[0]
    absent = params["present"] < 0.5

    def steps(state):
        for _ in range(int(t_chunk)):
            state = _cell_step(params, state, water_fill_pair)
        return state

    with torch.no_grad():
        for chunk in range(max_chunks):
            state = (steps(state) if run_chunk is None
                     else run_chunk(steps, state))
            cell_done = (state["done"] | absent).all(dim=-1).cpu().numpy()
            if on_chunk is not None:
                on_chunk(chunk + 1, int(cell_done.sum()), b)
            if cell_done.all():
                break
        else:
            raise ChunkBudgetError(
                f"accel cell batch did not converge in {max_chunks} "
                f"chunks of {t_chunk} steps"
            )
    return {k: v.cpu().numpy() for k, v in state.items()}


def summarize(params: dict, final: dict) -> list[dict]:
    """Per-cell summary dicts (the scenario-report subset the sweep
    store, worker CLI and matrix report consume) from the numpy batch
    and the final state."""
    present = np.asarray(params["present"]) > 0.5
    arrival = np.asarray(params["arrival"])
    comp = np.asarray(final["comp"])
    out = []
    for i in range(present.shape[0]):
        m = present[i]
        soj = comp[i, m] - arrival[i, m]
        out.append({
            "jobs_completed": int(m.sum()),
            "jobs_lost": 0,
            "makespan_s": float(comp[i, m].max()) if m.any() else 0.0,
            "mean_sojourn_s": float(soj.mean()) if m.any() else 0.0,
            "accel_steps": int(np.asarray(final["steps"])[i]),
        })
    return out
