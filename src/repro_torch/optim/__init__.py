"""Optimizers."""
from repro_torch.optim.adamw import (AdamWConfig, OptState, global_norm,
                                     init, schedule, update)

__all__ = ["AdamWConfig", "OptState", "global_norm", "init", "schedule",
           "update"]
