from .inference import STAGE_NAMES, SwinWNetInference, inference_stages, make_inference_fn
from .rl_inference import RLInference, make_rl_inference_fn, rl_inference_stages
from .simple import make_segmentation_fn, make_sr_fn
from .split import make_split_inference_fn

__all__ = ["STAGE_NAMES", "SwinWNetInference", "inference_stages", "make_inference_fn", "RLInference",
           "make_rl_inference_fn", "rl_inference_stages", "make_segmentation_fn", "make_sr_fn",
           "make_split_inference_fn"]
