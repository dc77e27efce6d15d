"""SWIM-style workload synthesis (Sect. 4.1).

The paper uses SWIM [9] to synthesize a 100-job workload from Facebook
production traces (the *FB-dataset*):

* 53 *small* jobs — 75% with a single MAP task, 25% with 2 MAP tasks;
* 41 *medium* jobs — 5..500 MAP tasks; half with no REDUCE tasks, the rest
  with 2..100 REDUCE tasks;
* 6 *large* jobs — 2 with ~3000 MAP tasks and no REDUCE tasks, 3 with
  700..1500 MAP and 150..250 REDUCE tasks, 1 with 200 MAP and 1000 REDUCE
  tasks;
* Poisson arrivals: exponential inter-arrival times with mean 13 s
  (submission schedule ~22 min).

Task runtimes: the paper's experiments use I/O-bound jobs with *no skew in
task size distributions* (Sect. 4.1 "Individual jobs") — MAP tasks are
"generally stable and short" [31, 9].  We draw a per-job mean MAP task time
and apply a small configurable jitter; REDUCE tasks are longer (they carry
shuffle+sort+reduce work for a whole partition).

This is a copy of ``repro.workload.fb`` (the port imports nothing of
``repro``): the same generators draw the same numpy RNG stream, so a seed
gives the reference's jobs exactly.  ``ml_dataset`` arrives with the ML
substrate slice of the port.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.types import ClusterSpec, JobSpec, Phase, TaskSpec

FB_CLASSES = ("small", "medium", "large")

# The paper's FB-dataset composition (Sect. 4.1), shared by fb_dataset and
# fb_scaled_dataset so the stress workload can never drift from the
# fidelity workload's class mix.
FB_CLASS_COUNTS = {"small": 53, "medium": 41, "large": 6}  # per 100 jobs
FB_LARGE_TEMPLATES = (
    (3000, 0), (3000, 0), (700, 150), (1100, 200), (1500, 250), (200, 1000),
)


def _fb_class_sizes(num_jobs: int) -> tuple[int, int, int]:
    """(n_small, n_medium, n_large) for a scaled FB-dataset."""
    scale = num_jobs / 100.0
    return (
        max(1, round(FB_CLASS_COUNTS["small"] * scale)),
        max(1, round(FB_CLASS_COUNTS["medium"] * scale)),
        max(1, round(FB_CLASS_COUNTS["large"] * scale)),
    )


@dataclass
class WorkloadSpec:
    """Knobs for the synthetic FB-dataset."""

    num_machines: int = 100
    replication: int = 3           # HDFS replication factor (Sect. 4.1)
    mean_interarrival: float = 13.0
    map_time_lo: float = 15.0      # per-job mean MAP task runtime range (s)
    map_time_hi: float = 60.0
    # REDUCE runtimes: the paper gives none; these keep reduce phases
    # within ~2-3x of map phases ("I/O-intensive only", no pathological
    # serialized-size inversions between map-count classes).
    reduce_time_lo: float = 30.0   # per-job mean REDUCE task runtime range (s)
    reduce_time_hi: float = 150.0
    task_jitter: float = 0.0       # intra-job task-time skew (0 = none, paper)
    map_state_bytes: int = 256 << 20    # working set per task (preemption cost)
    reduce_state_bytes: int = 1 << 30
    reduce_slowstart: float = 1.0


def job_class(num_map: int) -> str:
    """The paper's size classes (Sect. 4.1)."""
    if num_map <= 2:
        return "small"
    if num_map <= 500:
        return "medium"
    return "large"


def _mk_tasks(
    rng: np.random.Generator,
    job_id: int,
    phase: Phase,
    n: int,
    mean_time: float,
    jitter: float,
    state_bytes: int,
    num_machines: int,
    replication: int,
) -> tuple[TaskSpec, ...]:
    if n == 0:
        return ()
    if jitter > 0:
        times = mean_time * rng.lognormal(0.0, jitter, size=n)
    else:
        times = np.full(n, mean_time)
    tasks = []
    for i in range(n):
        hosts = tuple(
            int(h)
            for h in rng.choice(
                num_machines, size=min(replication, num_machines), replace=False
            )
        )
        tasks.append(
            TaskSpec(
                job_id=job_id,
                phase=phase,
                index=i,
                duration=float(max(times[i], 1.0)),
                input_hosts=hosts if phase is Phase.MAP else (),
                state_bytes=state_bytes,
            )
        )
    return tuple(tasks)


def fb_dataset(
    seed: int = 0,
    spec: WorkloadSpec | None = None,
    num_jobs: int = 100,
) -> tuple[list[JobSpec], dict[int, str]]:
    """Generate the FB-dataset-like workload.  Returns (jobs, class_of)."""
    spec = spec or WorkloadSpec()
    rng = np.random.default_rng(seed)
    n_small, n_medium, n_large = _fb_class_sizes(num_jobs)

    shapes: list[tuple[int, int]] = []  # (num_map, num_reduce)
    for i in range(n_small):
        shapes.append((1 if rng.random() < 0.75 else 2, 0))
    for i in range(n_medium):
        n_map = int(rng.integers(5, 501))
        n_red = 0 if rng.random() < 0.5 else int(rng.integers(2, 101))
        shapes.append((n_map, n_red))
    # Large class mirrors the paper's exact composition, scaled.
    for i in range(n_large):
        shapes.append(FB_LARGE_TEMPLATES[i % len(FB_LARGE_TEMPLATES)])
    rng.shuffle(shapes)

    jobs: list[JobSpec] = []
    class_of: dict[int, str] = {}
    t = 0.0
    for job_id, (n_map, n_red) in enumerate(shapes):
        t += float(rng.exponential(spec.mean_interarrival))
        map_mu = float(rng.uniform(spec.map_time_lo, spec.map_time_hi))
        red_mu = float(rng.uniform(spec.reduce_time_lo, spec.reduce_time_hi))
        job = JobSpec(
            job_id=job_id,
            arrival_time=t,
            map_tasks=_mk_tasks(
                rng, job_id, Phase.MAP, n_map, map_mu, spec.task_jitter,
                spec.map_state_bytes, spec.num_machines, spec.replication,
            ),
            reduce_tasks=_mk_tasks(
                rng, job_id, Phase.REDUCE, n_red, red_mu, spec.task_jitter,
                spec.reduce_state_bytes, spec.num_machines, spec.replication,
            ),
            name=f"fb-{job_class(n_map)}-{job_id}",
            reduce_slowstart=spec.reduce_slowstart,
        )
        jobs.append(job)
        class_of[job_id] = job_class(n_map)
    return jobs, class_of


# ---------------------------------------------------------------------------
# Scheduler-stress scenario: the FB-dataset mix at trace scale
# ---------------------------------------------------------------------------
def _mk_tasks_fast(
    rng: np.random.Generator,
    job_id: int,
    phase: Phase,
    n: int,
    mean_time: float,
    jitter: float,
    state_bytes: int,
    num_machines: int,
    replication: int,
) -> tuple[TaskSpec, ...]:
    """Vectorized task synthesis for trace-scale workloads (millions of
    tasks).  Input hosts are drawn WITH replacement (duplicate replicas
    are harmless: the locality index is keyed by host and idempotent) —
    a deliberate, documented deviation from ``_mk_tasks``'s exact
    without-replacement HDFS placement, trading a hair of placement
    fidelity for ~20x faster generation."""
    if n == 0:
        return ()
    if jitter > 0:
        times = mean_time * rng.lognormal(0.0, jitter, size=n)
    else:
        times = np.full(n, mean_time)
    times = np.maximum(times, 1.0)
    r = min(replication, num_machines)
    if phase is Phase.MAP:
        hosts = rng.integers(0, num_machines, size=(n, r))
        host_tuples = [tuple(int(h) for h in row) for row in hosts]
    else:
        host_tuples = [()] * n
    return tuple(
        TaskSpec(
            job_id=job_id,
            phase=phase,
            index=i,
            duration=float(times[i]),
            input_hosts=host_tuples[i],
            state_bytes=state_bytes,
        )
        for i in range(n)
    )


def fb_scaled_dataset(
    seed: int = 0,
    num_jobs: int = 10_000,
    num_machines: int = 100,
    spec: WorkloadSpec | None = None,
) -> tuple[list[JobSpec], dict[int, str]]:
    """Trace-scale FB-dataset: the paper's class mix at ``num_jobs`` scale.

    The submission window is held at the paper's ~22 min regardless of
    ``num_jobs`` (mean inter-arrival shrinks as 13 s x 100/num_jobs), so
    scheduler load — concurrent live jobs — grows with the job count.
    This is the scheduler-overhead stress scenario used by
    ``benchmarks/bench_sched_overhead.py``; task synthesis is vectorized
    (see :func:`_mk_tasks_fast`) so generating ~10k jobs / ~1M tasks stays
    in seconds.
    """
    spec = spec or WorkloadSpec()
    spec = dataclasses.replace(
        spec,
        num_machines=num_machines,
        mean_interarrival=13.0 * 100.0 / max(num_jobs, 1),
    )
    rng = np.random.default_rng(seed)
    n_small, n_medium, n_large = _fb_class_sizes(num_jobs)

    shapes: list[tuple[int, int]] = []
    small_two = rng.random(n_small) >= 0.75
    for i in range(n_small):
        shapes.append((2 if small_two[i] else 1, 0))
    med_maps = rng.integers(5, 501, size=n_medium)
    med_has_red = rng.random(n_medium) >= 0.5
    med_reds = rng.integers(2, 101, size=n_medium)
    for i in range(n_medium):
        shapes.append((int(med_maps[i]), int(med_reds[i]) if med_has_red[i] else 0))
    for i in range(n_large):
        shapes.append(FB_LARGE_TEMPLATES[i % len(FB_LARGE_TEMPLATES)])
    rng.shuffle(shapes)

    interarrivals = rng.exponential(spec.mean_interarrival, size=len(shapes))
    arrivals = np.cumsum(interarrivals)
    map_mus = rng.uniform(spec.map_time_lo, spec.map_time_hi, size=len(shapes))
    red_mus = rng.uniform(spec.reduce_time_lo, spec.reduce_time_hi, size=len(shapes))

    jobs: list[JobSpec] = []
    class_of: dict[int, str] = {}
    for job_id, (n_map, n_red) in enumerate(shapes):
        job = JobSpec(
            job_id=job_id,
            arrival_time=float(arrivals[job_id]),
            map_tasks=_mk_tasks_fast(
                rng, job_id, Phase.MAP, n_map, float(map_mus[job_id]),
                spec.task_jitter, spec.map_state_bytes, spec.num_machines,
                spec.replication,
            ),
            reduce_tasks=_mk_tasks_fast(
                rng, job_id, Phase.REDUCE, n_red, float(red_mus[job_id]),
                spec.task_jitter, spec.reduce_state_bytes, spec.num_machines,
                spec.replication,
            ),
            name=f"fb-{job_class(n_map)}-{job_id}",
            reduce_slowstart=spec.reduce_slowstart,
        )
        jobs.append(job)
        class_of[job_id] = job_class(n_map)
    return jobs, class_of


# ---------------------------------------------------------------------------
# TPU-adaptation workload: jobs are ML train/serve runs (DESIGN.md §2)
# ---------------------------------------------------------------------------
#: (arch, kind, quanta, seconds-per-quantum, state_GB) — step times derived
#: from the §Roofline compute terms of the assigned architectures (see
#: EXPERIMENTS.md); state bytes = params + optimizer (train) or KV (serve).
ML_JOB_TEMPLATES = [
    ("olmo-1b", "train", 200, 2.1, 14.6),
    ("olmo-1b", "serve", 30, 1.2, 3.0),
    ("gemma2-2b", "train", 150, 3.9, 29.3),
    ("starcoder2-3b", "train", 120, 5.6, 44.0),
    ("rwkv6-1.6b", "train", 100, 2.5, 23.0),
    ("granite-moe-3b-a800m", "train", 150, 1.9, 38.0),
    ("zamba2-2.7b", "train", 100, 4.3, 39.0),
    ("whisper-base", "train", 60, 0.6, 1.0),
    ("command-r-35b", "train", 400, 38.0, 420.0),
    ("llama4-scout-17b-a16e", "train", 300, 19.0, 1290.0),
    ("llava-next-34b", "serve", 80, 7.3, 80.0),
    ("command-r-35b", "serve", 60, 9.0, 90.0),
]


def ml_dataset(
    seed: int = 0,
    num_jobs: int = 40,
    mean_interarrival: float = 30.0,
    gang_slots: int = 16,
) -> tuple[list[JobSpec], dict[int, str]]:
    """Jobs = ML runs; tasks = step quanta executable on any gang slot.

    A job's MAP phase holds its step quanta (size = quanta x sec/quantum,
    cluster-width independent); there is no REDUCE phase.  ``state_bytes``
    drives the EAGER-preemption (HBM->host offload) cost model.
    """
    rng = np.random.default_rng(seed)
    jobs: list[JobSpec] = []
    class_of: dict[int, str] = {}
    t = 0.0
    for job_id in range(num_jobs):
        arch, kind, quanta, sec, state_gb = ML_JOB_TEMPLATES[
            int(rng.integers(len(ML_JOB_TEMPLATES)))
        ]
        t += float(rng.exponential(mean_interarrival))
        quanta = max(1, int(quanta * rng.uniform(0.5, 1.5)))
        tasks = tuple(
            TaskSpec(
                job_id=job_id,
                phase=Phase.MAP,
                index=i,
                duration=float(sec),
                input_hosts=(),
                state_bytes=int(state_gb * (1 << 30) / gang_slots),
            )
            for i in range(quanta)
        )
        jobs.append(
            JobSpec(
                job_id=job_id,
                arrival_time=t,
                map_tasks=tasks,
                reduce_tasks=(),
                name=f"{arch}-{kind}-{job_id}",
            )
        )
        total = quanta * sec
        class_of[job_id] = (
            "small" if total < 300 else "medium" if total < 3000 else "large"
        )
    return jobs, class_of


def fb_cluster(num_machines: int = 100) -> ClusterSpec:
    """The paper's Amazon cluster: 4 MAP + 2 REDUCE slots per node."""
    return ClusterSpec(
        num_machines=num_machines,
        map_slots_per_machine=4,
        reduce_slots_per_machine=2,
    )
