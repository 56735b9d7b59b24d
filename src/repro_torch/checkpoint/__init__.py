from repro_torch.checkpoint.store import CheckpointManager, load_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "load_checkpoint", "save_checkpoint"]
