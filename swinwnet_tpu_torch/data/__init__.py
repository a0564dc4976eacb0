"""The data feed: seeded synthetic patterns, the evaluation noise and the
training augmentations, the numpy batcher and the C++ prefetching batcher,
the real reference patterns and the renderer's calibration against them,
and the McStas instrument (ports of the JAX package's `data/` modules)."""

from .calibration import (
    detect_table,
    detect_union_table,
    extract_crystal_spec,
    fit_width_model,
    mask_d_bands,
    pulse_width_for_duration,
    real_crystal_library,
    refine_crystal_spec,
    render_calibrated,
    stats_scale,
)
from .generation import McStasRenderer, sample_d_list, synthesize_dataset, synthesize_pattern
from .loaders import ArrayLoader, load_crystal_npy, load_dataset_pickle, load_segmentation_maps
from .native_loader import NativeBatcher
from .noise import add_eval_noise, make_theta_flip_augment, make_train_noise_augment
from .real import (
    REAL_PATTERN_CRYSTALS,
    load_real_eval_set,
    load_real_masks,
    load_real_patterns,
    reference_available,
)

__all__ = [
    "ArrayLoader",
    "NativeBatcher",
    "load_crystal_npy",
    "load_segmentation_maps",
    "load_dataset_pickle",
    "add_eval_noise",
    "make_train_noise_augment",
    "make_theta_flip_augment",
    "McStasRenderer",
    "sample_d_list",
    "synthesize_dataset",
    "synthesize_pattern",
    "REAL_PATTERN_CRYSTALS",
    "load_real_eval_set",
    "load_real_masks",
    "load_real_patterns",
    "reference_available",
    "detect_table",
    "detect_union_table",
    "extract_crystal_spec",
    "fit_width_model",
    "mask_d_bands",
    "pulse_width_for_duration",
    "real_crystal_library",
    "refine_crystal_spec",
    "render_calibrated",
    "stats_scale",
]
