"""The user's entry points: the headless viewer CLI and its state model, the
labeling core and its state model, and the optional Qt shells over both
(ports of the JAX package's `apps/`)."""

from .labeler import compute_d_map, intervals_to_mask, make_fixed_centers
from .viewer import ViewerSession, export_stage_csv, load_model_any

__all__ = [
    "compute_d_map",
    "make_fixed_centers",
    "intervals_to_mask",
    "ViewerSession",
    "export_stage_csv",
    "load_model_any",
]
