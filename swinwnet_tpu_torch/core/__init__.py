from .config import GEOMETRY, DetectorGeometry, ModelConfig, TrainConfig
from .device import full_fp32, resolve_device, resolve_dtype

__all__ = ["GEOMETRY", "DetectorGeometry", "ModelConfig", "TrainConfig", "full_fp32", "resolve_device", "resolve_dtype"]
