"""Real reference data (a copy of `swinwnet_tpu/data/real.py`, numpy only):
the six McStas detector patterns and the 30-crystal labeled mask table of the
upstream repository.

They serve three roles: a small real evaluation set (the six crystals are
the published held-out test crystals), calibration targets for the
synthetic renderer (`data.calibration`), and ground truth for the classical
baselines.

Files under the root: datasets/{name}_diffraction.npy ([250,480] float32
counts) and datasets/segmentation_maps.pkl (pandas DataFrame, 30 rows
{Matrix(NaN), Crystal, Stats=5e8, Mask [250,480] uint8}). The root is the
`root=` argument, else the SWINWNET_REFERENCE_ROOT variable, else
`~/reference`.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .loaders import load_crystal_npy, load_segmentation_maps

REFERENCE_ROOT = os.environ.get("SWINWNET_REFERENCE_ROOT", os.path.join(os.path.expanduser("~"), "reference"))

#: the six crystals with both a real pattern and a labeled mask: the
#: published held-out evaluation set
REAL_PATTERN_CRYSTALS = (
    "Al2O3_sapphire",
    "C_graphite",
    "Na2Ca3Al2F14",
    "Rb",
    "Si",
    "UO2",
)


def reference_available(root: str = REFERENCE_ROOT) -> bool:
    return os.path.isdir(os.path.join(root, "datasets"))


def load_real_patterns(
    names: Sequence[str] = REAL_PATTERN_CRYSTALS, root: str = REFERENCE_ROOT
) -> np.ndarray:
    """[N, 250, 480] float32 stack of the real detector patterns."""
    return np.stack(
        [load_crystal_npy(os.path.join(root, "datasets", f"{n}_diffraction.npy")) for n in names]
    )


def load_real_masks(
    names: Optional[Sequence[str]] = None, root: str = REFERENCE_ROOT
) -> Dict[str, np.ndarray]:
    """{crystal: [250, 480] float32 binary mask} from segmentation_maps.pkl.

    Covers 30 crystals (all at max statistics 5e8); only the six
    REAL_PATTERN_CRYSTALS also have pattern images.
    """
    masks, meta = load_segmentation_maps(os.path.join(root, "datasets", "segmentation_maps.pkl"))
    out = {}
    for mask, m in zip(masks, meta):
        if names is None or m["Crystal"] in names:
            out[m["Crystal"]] = mask
    return out


def load_real_eval_set(
    root: str = REFERENCE_ROOT,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """(images [6,250,480], masks [6,250,480], names) for the held-out six."""
    names = list(REAL_PATTERN_CRYSTALS)
    images = load_real_patterns(names, root)
    mask_map = load_real_masks(names, root)
    masks = np.stack([mask_map[n] for n in names])
    return images, masks, names
