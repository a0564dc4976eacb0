from .inference import STAGE_NAMES, SwinWNetInference, inference_stages
from .rl_inference import RLInference, rl_inference_stages

__all__ = ["STAGE_NAMES", "SwinWNetInference", "inference_stages", "RLInference", "rl_inference_stages"]
