"""Named scenario presets — the paper's evaluation matrix (Sect. 4).

A copy of ``repro.scenarios.presets``: the same presets with the same
cell ids and spec hashes.  Each preset is a
:class:`~repro_torch.scenarios.spec.SweepSpec` factory; the registry maps
the name you pass to ``python -m repro_torch.scenarios run`` to the sweep
it expands into.

Register project-specific presets with :func:`register_preset`::

    @register_preset("my-experiment")
    def _my_experiment() -> SweepSpec:
        ...
"""

from __future__ import annotations

from typing import Callable

from repro_torch.scenarios.spec import (
    ClusterAxis,
    ScenarioSpec,
    SchedulerAxis,
    SweepSpec,
    WorkloadAxis,
)

_PRESETS: dict[str, Callable[[], SweepSpec]] = {}


def register_preset(name: str):
    """Decorator: register a SweepSpec factory under ``name``."""

    def deco(fn: Callable[[], SweepSpec]):
        _PRESETS[name] = fn
        return fn

    return deco


def list_presets() -> list[str]:
    return sorted(_PRESETS)


def get_preset(name: str) -> SweepSpec:
    try:
        factory = _PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {', '.join(list_presets())}"
        ) from None
    return factory()


def quick_sweep(sweep: SweepSpec) -> SweepSpec:
    """Reduced-scale variant of a sweep (same matrix, smaller trace)."""
    return SweepSpec(
        name=sweep.name + "@quick", base=sweep.base.quick(), grids=sweep.grids
    )


#: The paper's FB-dataset base cell: 100 SWIM-synthesized jobs on the
#: 100-machine Amazon cluster (Sect. 4.1), HFSP with paper defaults.
def paper_fb_base(seed: int = 0) -> ScenarioSpec:
    return ScenarioSpec(
        name="paper-fb",
        workload=WorkloadAxis(kind="fb", seed=seed, num_jobs=100),
        cluster=ClusterAxis(num_machines=100),
        scheduler=SchedulerAxis(policy="hfsp"),
    )


@register_preset("paper-fb")
def _paper_fb() -> SweepSpec:
    """Sect. 4.2 / Fig. 3: FIFO vs FAIR vs HFSP sojourn on the FB trace."""
    return SweepSpec(
        name="paper-fb",
        base=paper_fb_base(),
        grids=(
            SweepSpec.grid(**{"scheduler.policy": ("fifo", "fair", "hfsp")}),
        ),
    )


@register_preset("paper-cluster-size")
def _paper_cluster_size() -> SweepSpec:
    """Fig. 5: mean sojourn vs cluster size (10..100 machines), FAIR vs
    HFSP — scarcity grows HFSP's advantage."""
    return SweepSpec(
        name="paper-cluster-size",
        # num_hosts pinned: the SAME workload (placement + RNG stream) at
        # every swept cluster size — only scarcity varies.
        base=paper_fb_base().override(**{"workload.num_hosts": 100}),
        grids=(
            SweepSpec.grid(**{
                "cluster.num_machines": (10, 20, 30, 50, 70, 100),
                "scheduler.policy": ("fair", "hfsp"),
            }),
        ),
    )


@register_preset("paper-estimation-error")
def _paper_estimation_error() -> SweepSpec:
    """Fig. 6: HFSP robustness to size-estimation error on the MAP-only FB
    variant (Sect. 4.3), alpha x error-seed grid + an error-independent
    FAIR reference cell (non-rectangular: two grids)."""
    base = paper_fb_base().override(**{"workload.map_only": True})
    return SweepSpec(
        name="paper-estimation-error",
        base=base,
        grids=(
            SweepSpec.grid(**{
                "scheduler.error_alpha": (0.0, 0.1, 0.25, 0.5, 0.75, 1.0),
                "scheduler.error_seed": (0, 1, 2, 3, 4),
            }),
            SweepSpec.grid(**{"scheduler.policy": ("fair",)}),
        ),
    )


@register_preset("paper-estimation-error-disciplines")
def _paper_estimation_error_disciplines() -> SweepSpec:
    """Beyond-paper: the headline comparison of "Revisiting Size-Based
    Scheduling with Estimated Job Sizes" / PSBS (Dell'Amico et al.) —
    discipline x estimation-error on the MAP-only FB variant.  SRPT
    ranks by raw estimated remaining size and degrades as error grows
    (underestimated jobs clamp to zero remaining and camp at the head of
    the order); the FSP family (hfsp, psbs) absorbs error through the
    virtual cluster's relative progression; LAS never looks at sizes and
    is the error-independent reference (single cell, second grid).  All
    four resolve through the discipline registry — add a registered
    discipline to the grid and it sweeps identically."""
    base = paper_fb_base().override(**{"workload.map_only": True})
    return SweepSpec(
        name="paper-estimation-error-disciplines",
        base=base,
        grids=(
            SweepSpec.grid(**{
                "scheduler.policy": ("hfsp", "srpt", "psbs"),
                "scheduler.error_alpha": (0.0, 0.5, 1.0),
            }),
            SweepSpec.grid(**{"scheduler.policy": ("las",)}),
        ),
    )


@register_preset("paper-psbs-calibration")
def _paper_psbs_calibration() -> SweepSpec:
    """Beyond-paper: calibrate PSBS's two knobs under estimation error
    *heavier* than the Fig. 6 sweep ever applies (alpha 1.5 / 2.0 vs the
    FB sweep's max of 1.0 — at alpha > 1 the multiplicative error can
    drive estimates to (almost) zero, the regime PSBS was designed for).
    Grid 1 sweeps ``late_factor`` (how aggressively the virtual cluster
    ages jobs whose real progress outruns their estimate) x
    ``max_spread`` (rank-stability hysteresis window: 0 = re-rank on any
    verdict flip, 3 = tolerate small spreads before preempting) x error
    alpha.  Grid 2 runs hfsp and las at the same alphas as references —
    hfsp shares the virtual-cluster machinery without late aging, las
    never reads sizes at all.  Each cell's ``whatif`` block reports the
    swept knob values (``late_factor`` / ``max_spread``), so the report
    matrix is self-describing."""
    base = paper_fb_base().override(**{
        "workload.map_only": True,
        "scheduler.policy": "psbs",
        "name": "paper-psbs-calibration",
    })
    return SweepSpec(
        name="paper-psbs-calibration",
        base=base,
        grids=(
            SweepSpec.grid(**{
                "scheduler.psbs_late_factor": (0.5, 1.0, 2.0),
                "scheduler.psbs_max_spread": (0, 3),
                "scheduler.error_alpha": (1.5, 2.0),
            }),
            SweepSpec.grid(**{
                "scheduler.policy": ("hfsp", "las"),
                "scheduler.error_alpha": (1.5, 2.0),
            }),
        ),
    )


@register_preset("paper-fb-eps")
def _paper_fb_eps() -> SweepSpec:
    """Beyond-paper: the Fig. 3 comparison under epsilon-window event
    coalescing (arXiv 1306.6023's batching design) — policy x epsilon
    grid reporting the sojourn-vs-scheduler-overhead tradeoff per cell
    (each report carries ``scheduler_passes`` / ``passes_per_event``;
    eps=0 cells are bit-identical to the legacy pass-per-event loop).
    This preset is what justified flipping the spec-level default to
    ``"auto"``: sojourn movement across the eps grid is negligible
    next to the pass-count cut."""
    return SweepSpec(
        name="paper-fb-eps",
        base=paper_fb_base(),
        grids=(
            SweepSpec.grid(**{
                "scheduler.policy": ("fifo", "fair", "hfsp"),
                "event_epsilon": (0.0, 0.5, 2.0),
            }),
        ),
    )


@register_preset("paper-preemption")
def _paper_preemption() -> SweepSpec:
    """Sect. 4.4 axis on the FB trace: HFSP under EAGER / WAIT / KILL."""
    return SweepSpec(
        name="paper-preemption",
        base=paper_fb_base(),
        grids=(
            SweepSpec.grid(**{
                "scheduler.preemption": ("eager", "wait", "kill"),
            }),
        ),
    )


@register_preset("seed-robustness")
def _seed_robustness() -> SweepSpec:
    """Beyond-paper: the Fig. 3 comparison across workload seeds 0-5 —
    is the HFSP win an artifact of one synthesized trace?"""
    return SweepSpec(
        name="seed-robustness",
        base=paper_fb_base(),
        grids=(
            SweepSpec.grid(**{
                "scheduler.policy": ("fifo", "fair", "hfsp"),
                "workload.seed": (0, 1, 2, 3, 4, 5),
            }),
        ),
    )


@register_preset("paper-faults")
def _paper_faults() -> SweepSpec:
    """Beyond-paper robustness matrix: scheduling under machine churn,
    task failures, stragglers, and estimation-sample loss (see
    docs/faults.md).  Grid 1 sweeps failure intensity x policy — does the
    HFSP win survive a hostile cluster, and at what goodput?  Grid 2
    holds a mid-intensity fault bundle fixed and sweeps the preemption
    primitive (KILL discards progress a failure-heavy regime already
    taxes; EAGER's suspended state dies with crashed machines).  Every
    cell is bit-reproducible: the fault trace derives from
    ``faults.seed``, never from global RNG state."""
    base = paper_fb_base().override(**{
        "faults.seed": 7,
        "faults.machine_mtbf": 3000.0,
        "faults.machine_mttr": 120.0,
        "faults.straggler_prob": 0.05,
        "faults.straggler_factor": 4.0,
        "faults.sample_loss_rate": 0.1,
        "name": "paper-faults",
    })
    return SweepSpec(
        name="paper-faults",
        base=base,
        grids=(
            SweepSpec.grid(**{
                "faults.task_fail_rate": (0.02, 0.1),
                "scheduler.policy": ("hfsp", "fifo", "fair", "srpt", "psbs"),
            }),
            SweepSpec.grid(**{
                "faults.task_fail_rate": (0.05,),
                "scheduler.preemption": ("eager", "wait", "kill"),
            }),
        ),
    )


@register_preset("ml-workload")
def _ml_workload() -> SweepSpec:
    """Beyond-paper: the ML-job workload under all policies."""
    return SweepSpec(
        name="ml-workload",
        base=ScenarioSpec(
            name="ml-workload",
            workload=WorkloadAxis(kind="ml", num_jobs=40),
            cluster=ClusterAxis(
                num_machines=8, map_slots=2, reduce_slots=1,
                dma_bandwidth=60e9,
            ),
        ),
        grids=(
            SweepSpec.grid(**{"scheduler.policy": ("fifo", "fair", "hfsp")}),
        ),
    )
