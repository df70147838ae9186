"""Optimizer: AdamW / factored moments, the schedule, clipping."""
from repro_torch.optim.adamw import (OptimizerConfig, apply_updates,
                                     global_norm, init_opt_state,
                                     lr_schedule, param_leaves)

__all__ = ["OptimizerConfig", "apply_updates", "global_norm",
           "init_opt_state", "lr_schedule", "param_leaves"]
