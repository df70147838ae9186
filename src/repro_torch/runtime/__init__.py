"""The fault-tolerant training runtime."""
from repro_torch.runtime.trainer import Trainer, TrainerConfig

__all__ = ["Trainer", "TrainerConfig"]
