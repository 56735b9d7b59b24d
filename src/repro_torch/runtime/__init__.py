from repro_torch.runtime.trainer import TrainConfig, Trainer

__all__ = ["Trainer", "TrainConfig"]
