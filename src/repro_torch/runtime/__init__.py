from repro_torch.runtime.gang import GangRuntime, MLJob

__all__ = ["GangRuntime", "MLJob"]
