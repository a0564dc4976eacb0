from .inference import STAGE_NAMES, SwinWNetInference, inference_stages

__all__ = ["STAGE_NAMES", "SwinWNetInference", "inference_stages"]
