from repro_torch.checkpoint.manager import CheckpointManager, latest_step

__all__ = ["CheckpointManager", "latest_step"]
