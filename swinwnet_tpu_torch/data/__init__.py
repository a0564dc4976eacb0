"""The data feed: seeded synthetic patterns, the evaluation noise and the
training augmentations, and the numpy batcher (copies of the JAX package's
`data/generation.py`, `noise.py` and `loaders.py`)."""

from .generation import sample_d_list, synthesize_dataset, synthesize_pattern
from .loaders import ArrayLoader, load_crystal_npy, load_dataset_pickle, load_segmentation_maps
from .noise import add_eval_noise, make_theta_flip_augment, make_train_noise_augment

__all__ = [
    "ArrayLoader",
    "load_crystal_npy",
    "load_segmentation_maps",
    "load_dataset_pickle",
    "add_eval_noise",
    "make_train_noise_augment",
    "make_theta_flip_augment",
    "sample_d_list",
    "synthesize_dataset",
    "synthesize_pattern",
]
