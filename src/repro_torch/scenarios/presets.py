"""Named scenario presets (the subset of ``repro.scenarios.presets`` this
slice of the port runs: the paper's FB base cell and its Fig. 3 sweep).

Each preset is a :class:`~repro_torch.scenarios.spec.SweepSpec` factory;
the registry maps a name to the sweep it expands into.
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
