from repro_torch.workload.fb import (
    FB_CLASSES,
    WorkloadSpec,
    fb_cluster,
    fb_dataset,
    fb_scaled_dataset,
    job_class,
    ml_dataset,
)

__all__ = [
    "FB_CLASSES",
    "WorkloadSpec",
    "fb_cluster",
    "fb_dataset",
    "fb_scaled_dataset",
    "job_class",
    "ml_dataset",
]
