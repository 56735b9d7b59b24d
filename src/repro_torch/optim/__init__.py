from repro_torch.optim.adamw import AdamW, OptState, clip_by_global_norm, cosine_schedule

__all__ = ["AdamW", "OptState", "cosine_schedule", "clip_by_global_norm"]
