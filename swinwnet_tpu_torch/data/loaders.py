"""Dataset loading + batching (a copy of `swinwnet_tpu/data/loaders.py`;
numpy only: the port's trainers and harness take numpy batches through
`torch.as_tensor`).

The reference consumes torch DataLoaders over pandas pickles
(`dataset.pkl` with columns {Matrix, Crystal, Stats, Pulce duration} —
support_files/Diffraction_render_script.py:31-46; `segmentation_maps.pkl`
with {Crystal, Stats, Mask}) and raw `[250, 480]` float32 `.npy` crystal
patterns (datasets/*.npy). `ArrayLoader` is the minimal deterministic batcher
our trainers iterate over — host-side numpy, feeding static-shape batches.
"""

from __future__ import annotations

import pickle
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

# 6 held-out evaluation crystals (SWT survey §4; RL notebook cell 8)
EVAL_CRYSTALS = ("Al2O3_sapphire", "C_graphite", "Na2Ca3Al2F14", "Rb", "Si", "UO2")


def load_crystal_npy(path: str) -> np.ndarray:
    """Load one [250, 480] float32 detector pattern (datasets/*.npy), or a
    dict payload with an array under common keys (the viewer GUI accepts both
    — swinwnet_viewer_gui.py:598-664)."""
    obj = np.load(path, allow_pickle=True)
    if obj.dtype == object:
        obj = obj.item()
        if isinstance(obj, dict):
            for key in ("image", "images", "diffraction", "data", "matrix"):
                if key in obj:
                    obj = obj[key]
                    break
            else:
                obj = next(iter(obj.values()))
    arr = np.asarray(obj, dtype=np.float32)
    return arr


def load_segmentation_maps(path: str):
    """segmentation_maps.pkl: pandas DataFrame rows {Crystal, Stats, Mask}.
    Returns (images_or_None, masks, metadata dicts). Works without pandas if
    the pickle is a plain list of dicts."""
    with open(path, "rb") as f:
        df = pickle.load(f)
    rows = df.to_dict("records") if hasattr(df, "to_dict") else list(df)
    masks = np.stack([np.asarray(r["Mask"], dtype=np.float32) for r in rows])
    meta = [{k: r.get(k) for k in ("Crystal", "Stats", "Pulce duration")} for r in rows]
    return masks, meta


def load_dataset_pickle(path: str, crystals: Optional[Sequence[str]] = None):
    """dataset.pkl-style pandas pickle -> (images [N,250,480], masks or None,
    metadata). Filter by crystal names (the test_data.pkl recipe filters the
    6 held-out crystals at max stats — SURVEY.md §4)."""
    with open(path, "rb") as f:
        df = pickle.load(f)
    rows = df.to_dict("records") if hasattr(df, "to_dict") else list(df)
    if crystals is not None:
        rows = [r for r in rows if r.get("Crystal") in set(crystals)]
    images = np.stack([np.asarray(r["Matrix"], dtype=np.float32) for r in rows])
    masks = None
    if rows and "Mask" in rows[0] and rows[0]["Mask"] is not None:
        masks = np.stack([np.asarray(r["Mask"], dtype=np.float32) for r in rows])
    meta = [{k: r.get(k) for k in ("Crystal", "Stats", "Pulce duration")} for r in rows]
    return images, masks, meta


class ArrayLoader:
    """Deterministic batcher over in-memory arrays.

    Yields (images [B,1,H,W], masks [B,H,W]) numpy batches; drops no samples
    (last batch may be smaller unless `drop_last`). Shuffling reseeds per
    epoch from a counter so runs are reproducible.
    """

    def __init__(
        self,
        images: np.ndarray,
        masks: Optional[np.ndarray] = None,
        batch_size: int = 8,
        shuffle: bool = False,
        drop_last: bool = False,
        seed: int = 0,
        augment=None,
        joint_augment=None,
    ):
        self.images = np.asarray(images, dtype=np.float32)
        if self.images.ndim == 3:
            self.images = self.images[:, None]  # [N,1,H,W]
        self.masks = None if masks is None else np.asarray(masks, dtype=np.float32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        # optional per-batch image augmentation: augment(rng, images) ->
        # images, with an rng derived from (seed, epoch, batch start) so
        # epochs see fresh noise but runs stay reproducible
        self.augment = augment
        # optional geometric augmentation that must transform images and
        # masks together: joint_augment(rng, images, masks) -> (images,
        # masks); applied before the image-only augment
        self.joint_augment = joint_augment
        self._epoch = 0

    @property
    def n_samples(self) -> int:
        return len(self.images)

    def __len__(self) -> int:
        n = self.n_samples
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[np.ndarray, Optional[np.ndarray]]]:
        idx = np.arange(self.n_samples)
        # the epoch counter advances unconditionally so augmentation noise is
        # fresh every epoch even for non-shuffled loaders (ADVICE r03)
        epoch = self._epoch
        self._epoch += 1
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch)
            rng.shuffle(idx)
        for start in range(0, len(self) * self.batch_size, self.batch_size):
            batch_idx = idx[start : start + self.batch_size]
            if len(batch_idx) == 0:
                break
            images = self.images[batch_idx]
            masks = None if self.masks is None else self.masks[batch_idx]
            if self.joint_augment is not None or self.augment is not None:
                aug_rng = np.random.default_rng((self.seed, epoch, start))
                if self.joint_augment is not None:
                    images, masks = self.joint_augment(aug_rng, images, masks)
                if self.augment is not None:
                    images = self.augment(aug_rng, images)
            yield images, masks
