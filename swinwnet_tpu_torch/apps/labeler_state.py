"""Toolkit-agnostic state/controller of the interactive diffraction labeler
(port of `swinwnet_tpu/apps/labeler_state.py`; reference:
DiffractionLabeler/diffraction_labeling_gui/diff_labeling_gui.py:141-696).

The labeling workflow — SpanSelector intervals on the 1D I(d) profile,
right-click undo, prev/next navigation, mask/label view modes, d-interval ->
2D mask projection, non-empty-only save — lives here as plain methods over
numpy state; the Qt shell (`apps.gui`) only forwards widget events. The
projection math itself is `apps.labeler` (compute_d_map / intervals_to_mask).
The I(d) profile is rebinned by the port's `physics.Qwrapper` on `device`
(None: the card; "cpu" on request).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import GEOMETRY
from ..physics.qwrapper import Qwrapper
from .labeler import compute_d_map, make_fixed_centers


def is_mask_array(arr: np.ndarray) -> bool:
    """Binary-mask heuristic (diff_labeling_gui.py:93-101)."""
    if not isinstance(arr, np.ndarray) or arr.ndim < 2:
        return False
    if arr.dtype == np.bool_:
        return True
    if np.issubdtype(arr.dtype, np.integer):
        u = np.unique(arr.reshape(-1)[: min(arr.size, 200000)])
        return u.size <= 3 and bool(np.all(np.isin(u, [0, 1])))
    return False


def normalize_to_stack(arr: np.ndarray) -> np.ndarray:
    """2D -> [1,H,W]; 3D passthrough (diff_labeling_gui.py:104-109)."""
    if arr.ndim == 2:
        return arr[None, ...]
    if arr.ndim == 3:
        return arr
    raise ValueError(f"Unsupported array shape {arr.shape}, expected 2D or 3D.")


@dataclass
class LabelerModel:
    """Interactive labeling session state."""

    theta_range: Tuple[float, float] = GEOMETRY.theta_range
    lambda_range: Tuple[float, float] = GEOMETRY.lambda_range
    fixed_centers: np.ndarray = field(
        default_factory=lambda: np.linspace(0.05318052, 7.49710258, 1241).astype(np.float32)
    )
    device: Optional[Union[str, torch.device]] = None

    def __post_init__(self):
        self.diffractions: Optional[np.ndarray] = None
        self.base_masks: Optional[np.ndarray] = None
        self.intervals: List[List[Tuple[float, float]]] = []
        self.idx = 0
        self.mode_view = False
        self.status = "No data loaded"
        self._qw: Optional[Qwrapper] = None
        self._d_map: Optional[np.ndarray] = None
        self._profile: Optional[Tuple[np.ndarray, np.ndarray]] = None

    # ---------- geometry / d-grid ----------

    @property
    def qw(self) -> Qwrapper:
        if self._qw is None:
            self._qw = Qwrapper(
                self.theta_range, self.lambda_range, fixed_centers=self.fixed_centers,
                device=self.device,
            )
        return self._qw

    def apply_d_grid(self, d_min: float, d_max: float, n: int):
        self.fixed_centers = make_fixed_centers(d_min, d_max, n)
        self._qw = None
        self._profile = None

    def set_geometry(self, theta_range, lambda_range):
        self.theta_range = (float(theta_range[0]), float(theta_range[1]))
        self.lambda_range = (float(lambda_range[0]), float(lambda_range[1]))
        self._qw = None
        self._d_map = None
        self._profile = None

    # ---------- loading (diff_labeling_gui.py:332-360) ----------

    def _ensure_sizes(self, N: int, H: int, W: int):
        if self.base_masks is None or self.base_masks.shape != (N, H, W):
            self.base_masks = np.zeros((N, H, W), dtype=np.uint8)
        if not self.intervals or len(self.intervals) != N:
            self.intervals = [[] for _ in range(N)]

    def load_npy(self, path: str):
        arr = np.load(path, allow_pickle=False)
        stack = normalize_to_stack(arr)
        if is_mask_array(stack):
            self.base_masks = stack.astype(np.uint8)
            if self.diffractions is not None and self.diffractions.shape == stack.shape:
                self._ensure_sizes(*stack.shape)
            self.mode_view = self.diffractions is None
            self.status = f"Masks loaded: {stack.shape}"
        else:
            self.diffractions = stack.astype(np.float32)
            self._ensure_sizes(*stack.shape)
            self.mode_view = False
            self.status = f"Diffractions loaded: {stack.shape}"
        self.idx = 0
        self._d_map = None
        self._profile = None

    # ---------- interval editing (diff_labeling_gui.py:296-324) ----------

    def add_interval(self, xmin: float, xmax: float) -> bool:
        """SpanSelector onselect: record [min, max] on the current image."""
        if self.mode_view or self.diffractions is None:
            return False
        if self.idx >= self.diffractions.shape[0]:
            return False
        a, b = (xmin, xmax) if xmin <= xmax else (xmax, xmin)
        self.intervals[self.idx].append((float(a), float(b)))
        return True

    def pop_interval(self) -> bool:
        """Right-click undo of the last interval on the current image."""
        if self.mode_view or self.diffractions is None:
            return False
        if self.idx >= self.diffractions.shape[0] or not self.intervals[self.idx]:
            return False
        self.intervals[self.idx].pop()
        return True

    def clear_intervals_current(self):
        if self.intervals and 0 <= self.idx < len(self.intervals):
            self.intervals[self.idx] = []

    # ---------- navigation (diff_labeling_gui.py:431-462) ----------

    def n_items(self) -> Optional[int]:
        if self.mode_view:
            return None if self.base_masks is None else self.base_masks.shape[0]
        return None if self.diffractions is None else self.diffractions.shape[0]

    def prev_item(self):
        if self.idx > 0:
            self.idx -= 1
            self._profile = None

    def next_item(self):
        """Advancing past the last image parks at idx == N ('all done')."""
        N = self.n_items()
        if N is None:
            return
        self.idx = min(self.idx + 1, N)
        self._profile = None

    def toggle_mode(self) -> bool:
        self.mode_view = not self.mode_view
        if self.mode_view and self.base_masks is None and self.diffractions is None:
            self.mode_view = False
        return self.mode_view

    def done(self) -> bool:
        N = self.n_items()
        return N is not None and self.idx >= N

    # ---------- derived views ----------

    def d_map(self) -> Optional[np.ndarray]:
        if self.diffractions is None:
            return None
        if self._d_map is None:
            H, W = self.diffractions.shape[1:]
            self._d_map = compute_d_map(self.theta_range, self.lambda_range, H, W)
        return self._d_map

    def profile(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(d, I) of the current diffraction (diff_labeling_gui.py:486-500)."""
        if self.diffractions is None or self.done():
            return None
        if self._profile is None:
            img = self.diffractions[self.idx].astype(np.float32)[None, None]
            out = self.qw.tensor_to_d(img)[0]
            self._profile = (out["d"], out["I"])
        return self._profile

    def current_final_mask(self) -> Optional[np.ndarray]:
        """Base mask OR the projection of the current intervals
        (diff_labeling_gui.py:502-528)."""
        N = self.n_items()
        if N is None or self.idx >= N:
            return None
        if self.diffractions is not None:
            H, W = self.diffractions[self.idx].shape
        else:
            H, W = self.base_masks[self.idx].shape

        base = (
            self.base_masks[self.idx].astype(bool)
            if self.base_masks is not None and self.idx < self.base_masks.shape[0]
            else np.zeros((H, W), dtype=bool)
        )
        dm = self.d_map()
        if self.intervals and self.idx < len(self.intervals) and dm is not None:
            m = np.zeros((H, W), dtype=bool)
            for a, b in self.intervals[self.idx]:
                with np.errstate(invalid="ignore"):
                    m |= (dm >= a) & (dm <= b)
            return (base | m).astype(np.uint8)
        return base.astype(np.uint8)

    # ---------- save (diff_labeling_gui.py:389-429) ----------

    def masks_stack(self) -> Optional[np.ndarray]:
        """Base masks OR-ed with every image's interval projections."""
        if self.base_masks is None:
            return None
        if self.diffractions is None:
            return self.base_masks.copy()
        N, H, W = self.diffractions.shape
        out = self.base_masks.copy()
        dm = compute_d_map(self.theta_range, self.lambda_range, H, W)
        for i in range(min(N, len(self.intervals))):
            m = np.zeros((H, W), dtype=bool)
            for a, b in self.intervals[i]:
                with np.errstate(invalid="ignore"):
                    m |= (dm >= a) & (dm <= b)
            out[i] = (out[i].astype(bool) | m).astype(np.uint8)
        return out

    def save_masks(self, path: str) -> int:
        """Write non-empty masks + their indices (reference format: masks to
        `path`, indices to `path` with `_indices` suffix). Returns the count
        of saved masks; 0 = nothing to save."""
        masks = self.masks_stack()
        if masks is None:
            return 0
        non_empty = np.where(masks.reshape(masks.shape[0], -1).any(axis=1))[0]
        if non_empty.size == 0:
            return 0
        np.save(path, masks[non_empty].astype(np.uint8))
        np.save(path.replace(".npy", "_indices.npy"), non_empty.astype(np.int32))
        return int(non_empty.size)

    def status_text(self) -> str:
        N = self.n_items()
        if N is None:
            return self.status
        if self.done():
            return f"All {N} items visited | mode={'view' if self.mode_view else 'label'}"
        k = len(self.intervals[self.idx]) if self.idx < len(self.intervals) else 0
        return (
            f"item {self.idx + 1}/{N} | intervals={k} | "
            f"mode={'view' if self.mode_view else 'label'}"
        )
