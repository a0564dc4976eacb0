from .inference import STAGE_NAMES, SwinWNetInference, inference_stages
from .rl_inference import RLInference, rl_inference_stages
from .simple import make_segmentation_fn, make_sr_fn
from .split import make_split_inference_fn

__all__ = ["STAGE_NAMES", "SwinWNetInference", "inference_stages", "RLInference", "rl_inference_stages",
           "make_segmentation_fn", "make_sr_fn", "make_split_inference_fn"]
