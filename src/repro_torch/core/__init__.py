"""The paper's primary contribution: size-based scheduling (HFSP) with
online size estimation, a virtual PS cluster, and preemption primitives,
plus the FIFO/FAIR baselines and the discrete-event simulator."""

from repro_torch.core import disciplines
from repro_torch.core.disciplines import Discipline, DisciplineRegistry
from repro_torch.core.estimator import (
    DistributionFitEstimator,
    FirstOrderEstimator,
    TrainingModule,
)
from repro_torch.core.fair import FairScheduler
from repro_torch.core.faults import FaultInjector, FaultModel, FirstFinisherWins
from repro_torch.core.fifo import FIFOScheduler
from repro_torch.core.hfsp import HFSPConfig, HFSPScheduler
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.core.simulator import SimConfig, SimResult, Simulator
from repro_torch.core.types import (
    ClusterSpec,
    JobSpec,
    JobState,
    Phase,
    Preemption,
    TaskSpec,
)
from repro_torch.core.vcluster import VirtualCluster, max_min_allocation, project_finish_times

__all__ = [
    "ClusterSpec",
    "Discipline",
    "DisciplineRegistry",
    "DistributionFitEstimator",
    "disciplines",
    "FIFOScheduler",
    "FairScheduler",
    "FaultInjector",
    "FaultModel",
    "FirstFinisherWins",
    "FirstOrderEstimator",
    "HFSPConfig",
    "HFSPScheduler",
    "JobSpec",
    "JobState",
    "Phase",
    "Preemption",
    "Scheduler",
    "SchedulerConfig",
    "SimConfig",
    "SimResult",
    "Simulator",
    "TaskSpec",
    "TrainingModule",
    "VirtualCluster",
    "max_min_allocation",
    "project_finish_times",
]
