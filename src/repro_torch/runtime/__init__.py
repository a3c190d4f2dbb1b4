"""The fault-tolerant training loop (port of repro/runtime)."""

from repro_torch.runtime.supervisor import Supervisor, TrainLoopConfig

__all__ = ["Supervisor", "TrainLoopConfig"]
