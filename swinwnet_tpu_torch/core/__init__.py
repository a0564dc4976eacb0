from .config import GEOMETRY, DetectorGeometry, ModelConfig
from .device import resolve_device, resolve_dtype

__all__ = ["GEOMETRY", "DetectorGeometry", "ModelConfig", "resolve_device", "resolve_dtype"]
