from .config import GEOMETRY, DetectorGeometry, ModelConfig
from .device import full_fp32, resolve_device, resolve_dtype

__all__ = ["GEOMETRY", "DetectorGeometry", "ModelConfig", "full_fp32", "resolve_device", "resolve_dtype"]
