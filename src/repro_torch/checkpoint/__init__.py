from repro_torch.checkpoint.store import CheckpointStore

__all__ = ["CheckpointStore"]
