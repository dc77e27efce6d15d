"""The gang runtime — the paper's "Amazon cluster" analogue (the port's
copy of ``repro/runtime/gang.py``).

Executes REAL training jobs of the assigned architectures (every family:
dense, vlm, moe, ssm, hybrid and encdec), as eager torch steps on one
device, under any :class:`repro_torch.core.Scheduler`, mapping the
paper's primitives to device mechanisms (DESIGN.md §2):

* machine  = host with a gang of chips; slot = gang slot;
* task     = step quantum (a fixed budget of train/serve steps);
* EAGER    = device->host offload of (params, opt, step) via the
  checkpoint store (the "swap partition"): the job's device state is
  dropped, so the memory it held is freed; RESUME = restore onto the
  device, gradients on — on the SAME host, per the paper's locality rule;
* KILL     = discard quantum progress, restart from the last durable
  snapshot;
* WAIT     = let the in-flight quantum drain;
* straggler mitigation = speculative re-execution of a quantum that runs
  longer than ``straggler_factor`` x the job's median quantum time;
* fault tolerance = simulated gang failures re-queue the quantum (KILL
  semantics) and restore from the snapshot;
* elastic scaling  = a job suspended on gang A resumes on gang B of a
  different size: the serialized size (total step quanta) is
  width-independent, exactly the paper's trick.

The runtime drives the scheduler with the same event API as the simulator
(`on_job_arrival` / `on_task_complete` / `schedule`), so HFSP/FIFO/FAIR run
UNMODIFIED on real work.  Wall-clock time stands in for sim time.

Where the reference jits each job's step, the port runs
:func:`repro_torch.train.make_train_step`'s eager step on ``device``
(default ``"cuda"``; a missing card raises
:class:`repro_torch.DeviceError`).  HFSP's virtual clusters run where the
scheduler's ``HFSPConfig.vc_device`` says.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.faults import FirstFinisherWins
from repro_torch.core.scheduler import Kill, Resume, Scheduler, Start, Suspend
from repro_torch.core.types import (
    ClusterSpec,
    JobSpec,
    Phase,
    SlotKey,
    TaskAttempt,
    TaskSpec,
    TaskState,
)
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.train import (
    OptimizerConfig,
    TrainConfig,
    init_train_state,
    make_train_step,
    train_state_to_device,
)


@dataclass
class MLJob:
    """One ML job: a training run chopped into step quanta."""

    job_id: int
    cfg: object                    # ModelConfig (SMOKE widths on the CPU)
    total_steps: int
    steps_per_quantum: int
    arrival_time: float
    seq_len: int = 64
    global_batch: int = 8
    name: str = ""
    seed: int = 0

    @property
    def num_quanta(self) -> int:
        return -(-self.total_steps // self.steps_per_quantum)

    def to_jobspec(self, est_quantum_seconds: float = 1.0) -> JobSpec:
        tasks = tuple(
            TaskSpec(
                job_id=self.job_id,
                phase=Phase.MAP,
                index=i,
                duration=est_quantum_seconds,
                state_bytes=0,
            )
            for i in range(self.num_quanta)
        )
        return JobSpec(
            job_id=self.job_id,
            arrival_time=self.arrival_time,
            map_tasks=tasks,
            reduce_tasks=(),
            name=self.name or f"job{self.job_id}",
        )


@dataclass
class _JobRuntime:
    job: MLJob
    state: dict | None = None          # live train state (params+opt)
    step_fn: Callable | None = None
    data: SyntheticLM | None = None
    steps_done: int = 0
    quantum_times: list = field(default_factory=list)
    suspended_host: int | None = None  # EAGER locality
    losses: list = field(default_factory=list)


class GangRuntime:
    """Synchronous gang executor: each scheduler pass runs the quanta that
    were granted slots, one slot-quantum at a time (one process — gangs
    time-share the device, which preserves the scheduling semantics while
    keeping the runtime exact)."""

    def __init__(
        self,
        cluster: ClusterSpec,
        scheduler: Scheduler,
        jobs: list[MLJob],
        store: CheckpointStore,
        *,
        straggler_factor: float = 3.0,
        fail_quantum_prob: float = 0.0,
        rng_seed: int = 0,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.spec = cluster
        self.scheduler = scheduler
        self.store = store
        self.straggler_factor = straggler_factor
        self.fail_quantum_prob = fail_quantum_prob
        self.rng = np.random.default_rng(rng_seed)
        self.jobs = {j.job_id: j for j in jobs}
        self.rt: dict[int, _JobRuntime] = {}
        self._pending_arrivals = sorted(jobs, key=lambda j: j.arrival_time)
        self._free: dict[Phase, list[SlotKey]] = {
            Phase.MAP: [
                SlotKey(m, Phase.MAP, i)
                for m in range(cluster.num_machines)
                for i in range(cluster.map_slots_per_machine)
            ],
            Phase.REDUCE: [],
        }
        self._occupied: dict[SlotKey, TaskAttempt] = {}
        self._slot_by_task: dict[tuple, SlotKey] = {}
        self._susp_bytes: dict[int, int] = {}
        self._t0 = time.time()
        self.completions: dict[int, float] = {}
        self.arrivals: dict[int, float] = {}
        self.events: list[tuple[float, str, str]] = []
        self.stats = {"speculative": 0, "spec_wins": 0, "spec_losses": 0,
                      "failures": 0, "offloads": 0, "restores": 0, "kills": 0}
        self._ffw = FirstFinisherWins()

    # -- ClusterView protocol -------------------------------------------------
    def free_slots(self, phase: Phase) -> list[SlotKey]:
        return list(self._free[phase])

    def slot_occupant(self, slot: SlotKey) -> TaskAttempt | None:
        return self._occupied.get(slot)

    def occupied_slots(self, phase: Phase) -> dict[SlotKey, TaskAttempt]:
        return {s: a for s, a in self._occupied.items() if s.phase is phase}

    def machine_suspended_count(self, machine: int) -> int:
        return 0

    def machine_suspended_bytes(self, machine: int) -> int:
        return self._susp_bytes.get(machine, 0)

    def total_suspended_bytes(self) -> int:
        return sum(self._susp_bytes.values())

    # -- time -----------------------------------------------------------------
    def now(self) -> float:
        return time.time() - self._t0

    # -- job lifecycle -----------------------------------------------------------
    def _materialize(self, jid: int) -> _JobRuntime:
        rt = self.rt.get(jid)
        if rt is None:
            job = self.jobs[jid]
            rt = _JobRuntime(job=job)
            rt.data = SyntheticLM(
                job.cfg,
                DataConfig(seq_len=job.seq_len, global_batch=job.global_batch,
                           seed=job.seed),
            )
            step = make_train_step(
                job.cfg, OptimizerConfig(warmup_steps=5, total_steps=job.total_steps),
                TrainConfig(remat="none"),
            )
            rt.step_fn = step
            rt.state = init_train_state(
                job.cfg,
                torch.Generator(device=self.device).manual_seed(job.seed),
                device=self.device,
            )
            self.rt[jid] = rt
        return rt

    def _offload(self, jid: int, host: int) -> None:
        """EAGER suspend: device -> host store ("swap")."""
        rt = self.rt[jid]
        if rt.state is not None:
            self.store.save(f"job{jid}", rt.steps_done, rt.state)
            rt.state = None            # the last reference: frees its memory
            rt.suspended_host = host
            self.stats["offloads"] += 1

    def _restore(self, jid: int) -> None:
        rt = self._materialize(jid)
        if rt.state is None:
            found = self.store.restore(f"job{jid}")
            assert found is not None, f"no snapshot for job {jid}"
            step, tree = found
            rt.state = train_state_to_device(tree, self.device)
            rt.steps_done = step
            rt.suspended_host = None
            self.stats["restores"] += 1

    # -- quantum execution ------------------------------------------------------
    def _run_quantum(self, att: TaskAttempt) -> None:
        jid = att.spec.job_id
        rt = self._materialize(jid)
        if rt.state is None:
            self._restore(jid)
        job = rt.job
        t0 = time.time()
        # Simulated gang failure: lose the quantum, KILL semantics.
        if self.fail_quantum_prob and self.rng.random() < self.fail_quantum_prob:
            self.stats["failures"] += 1
            found = self.store.restore(f"job{jid}")
            if found is not None:
                rt.state = train_state_to_device(found[1], self.device)
                rt.steps_done = found[0]
            self.events.append((self.now(), "failure", f"job{jid}"))
            return  # quantum must be re-run (task not completed)
        # Pre-quantum snapshot references: the step functions are pure, so
        # the tree rt.state points at now survives the quantum unchanged —
        # a speculative re-execution restarts from exactly here.
        pre_state, pre_steps = rt.state, rt.steps_done
        for s in range(job.steps_per_quantum):
            step_idx = rt.steps_done + s
            if step_idx >= job.total_steps:
                break
            batch = self._batch(rt, step_idx)
            rt.state, metrics = rt.step_fn(rt.state, batch)
        rt.losses.append(float(metrics["loss"]))
        rt.steps_done = min(rt.steps_done + job.steps_per_quantum, job.total_steps)
        dt = time.time() - t0
        rt.quantum_times.append(dt)
        # Straggler mitigation: a quantum way beyond the median is
        # speculatively re-executed on a spare gang from the pre-quantum
        # snapshot; the first finisher wins and the loser's gang-time is
        # discarded.  (Synchronous runtime: the race is decided by the
        # two attempts' measured wall times.)
        med = float(np.median(rt.quantum_times))
        if len(rt.quantum_times) >= 3 and dt > self.straggler_factor * med:
            spare = self._spare_slot(exclude_machine=att.machine)
            if spare is not None:
                self.stats["speculative"] += 1
                self.events.append((
                    self.now(), "speculative",
                    f"job{jid} gang{att.machine}->gang{spare.machine}",
                ))
                rt.state = self._race_speculative(
                    rt, pre_state, pre_steps, dt, rt.state
                )
        # Durable snapshot at quantum boundary (fault tolerance).
        self.store.save(f"job{jid}", rt.steps_done, rt.state)

    def _batch(self, rt: _JobRuntime, step_idx: int) -> dict:
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in rt.data.batch(step_idx).items()}

    def _spare_slot(self, exclude_machine: int | None) -> SlotKey | None:
        """A free gang for a speculative copy, preferably elsewhere (the
        straggling gang is the suspect)."""
        free = self._free[Phase.MAP]
        for s in free:
            if s.machine != exclude_machine:
                return s
        return free[0] if free else None

    def _race_speculative(
        self, rt: _JobRuntime, pre_state, pre_steps: int, primary_dt: float,
        primary_state,
    ):
        """Re-run the quantum from the pre-quantum snapshot on the spare
        gang and race it against the straggling primary: whichever attempt
        finished faster wins (FirstFinisherWins), the loser is discarded.
        Deterministic data makes the race safe — both attempts compute the
        same state, only the accounting differs."""
        job = rt.job
        t0 = time.time()
        state = pre_state
        for s in range(job.steps_per_quantum):
            step_idx = pre_steps + s
            if step_idx >= job.total_steps:
                break
            batch = self._batch(rt, step_idx)
            state, _ = rt.step_fn(state, batch)
        shadow_dt = time.time() - t0
        key = (job.job_id, pre_steps)
        self._ffw.reset(key)
        for name, d in sorted(
            (("primary", primary_dt), ("shadow", shadow_dt)),
            key=lambda x: x[1],
        ):
            self._ffw.finish(key, name)
        if self._ffw.winner(key) == "shadow":
            self.stats["spec_wins"] += 1
            return state
        self.stats["spec_losses"] += 1
        return primary_state

    # -- action application -------------------------------------------------------
    def _apply(self, action) -> bool:
        """Apply one scheduler action; returns True if a quantum ran."""
        js_of = self.scheduler.jobs
        if isinstance(action, Start):
            att, slot = action.attempt, action.slot
            self._free[slot.phase].remove(slot)
            js_of[att.spec.job_id].transition(att, TaskState.RUNNING)
            att.machine = slot.machine
            att.attempts += 1
            self._occupied[slot] = att
            self._slot_by_task[att.spec.key] = slot
            self.scheduler.on_task_started(att, slot)
            return True
        if isinstance(action, Resume):
            att, slot = action.attempt, action.slot
            self._free[slot.phase].remove(slot)
            self._restore(att.spec.job_id)
            m = att.machine if att.machine is not None else -1
            self._susp_bytes[m] = 0
            js_of[att.spec.job_id].transition(att, TaskState.RUNNING)
            self._occupied[slot] = att
            self._slot_by_task[att.spec.key] = slot
            self.scheduler.on_task_resumed(att, slot)
            return True
        if isinstance(action, Suspend):
            att = action.attempt
            slot = self._slot_by_task.pop(att.spec.key)
            del self._occupied[slot]
            self._free[slot.phase].append(slot)
            js_of[att.spec.job_id].transition(att, TaskState.SUSPENDED)
            self._offload(att.spec.job_id, slot.machine)
            self._susp_bytes[slot.machine] = (
                self._susp_bytes.get(slot.machine, 0) + 1
            )
            self.scheduler.on_task_suspended(att)
            return False
        if isinstance(action, Kill):
            att = action.attempt
            slot = self._slot_by_task.pop(att.spec.key)
            del self._occupied[slot]
            self._free[slot.phase].append(slot)
            js_of[att.spec.job_id].transition(att, TaskState.PENDING)
            att.machine = None
            self.stats["kills"] += 1
            self.scheduler.on_task_killed(att)
            return False
        raise TypeError(action)

    # -- main loop ------------------------------------------------------------------
    def run(self, *, max_wall_s: float = 600.0) -> dict:
        """Drive scheduler + quanta to completion (or the wall limit)."""
        while time.time() - self._t0 < max_wall_s:
            now = self.now()
            # Admit arrived jobs.
            while self._pending_arrivals and (
                self._pending_arrivals[0].arrival_time <= now
            ):
                job = self._pending_arrivals.pop(0)
                self.arrivals[job.job_id] = now
                self.scheduler.on_job_arrival(
                    job.to_jobspec(est_quantum_seconds=1.0), now
                )
                self.events.append((now, "arrival", job.name))
            # Let the scheduler assign slots.
            for action in self.scheduler.schedule(self, now):
                self._apply(action)
            # Run one in-flight quantum per pass (round-robin over slots).
            ran = False
            for slot, att in list(self._occupied.items()):
                self._run_quantum(att)
                ran = True
                # Completion bookkeeping.
                del self._occupied[slot]
                self._slot_by_task.pop(att.spec.key, None)
                self._free[slot.phase].append(slot)
                rt = self.rt[att.spec.job_id]
                js = self.scheduler.jobs[att.spec.job_id]
                if rt.steps_done >= rt.job.total_steps:
                    # Finish every remaining task of the job.
                    for other in js.attempts(Phase.MAP):
                        if other.state is not TaskState.DONE:
                            js.transition(other, TaskState.DONE)
                            self.scheduler.on_task_complete(
                                att.spec.job_id, other.spec.key, self.now()
                            )
                else:
                    js.transition(att, TaskState.DONE)
                    self.scheduler.on_task_complete(
                        att.spec.job_id, att.spec.key, self.now()
                    )
                if js.is_done() and js.completion_time is None:
                    js.completion_time = self.now()
                    self.completions[att.spec.job_id] = self.now()
                    self.scheduler.on_job_complete(att.spec.job_id, self.now())
                    self.events.append((self.now(), "complete", rt.job.name))
                break  # one quantum per pass keeps scheduling responsive
            if not ran:
                if not self._pending_arrivals and not any(
                    js.completion_time is None
                    for js in self.scheduler.jobs.values()
                ):
                    break
                time.sleep(0.01)
        return self.report()

    def report(self) -> dict:
        sojourn = {
            j: self.completions[j] - self.arrivals[j]
            for j in self.completions
        }
        return {
            "sojourn": sojourn,
            "mean_sojourn": (
                sum(sojourn.values()) / len(sojourn) if sojourn else 0.0
            ),
            "losses": {j: rt.losses[-1] if rt.losses else None
                       for j, rt in self.rt.items()},
            "stats": dict(self.stats),
            "events": list(self.events),
        }
