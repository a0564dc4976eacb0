from .checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from .logging import MetricsLogger

__all__ = ["latest_checkpoint", "load_checkpoint", "save_checkpoint", "MetricsLogger"]
