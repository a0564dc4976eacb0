"""Toolkit-agnostic state/controller of the interactive inference viewer
(port of `swinwnet_tpu/apps/viewer_state.py`; reference:
inference_gui/swinwnet_viewer_gui.py:347-1100).

Every piece of GUI behavior that is not literally a Qt widget lives here —
stage browsing, tile composition, I(d) curves with error bands, legend
visibility toggling, editable d-grid and detector geometry, CSV export —
so it is unit-testable headless and shared by both frontends (the Qt shell in
`apps.gui` and the CLI in `apps.viewer`). The Qt layer is reduced to wiring
widgets to these methods and drawing the returned plain-data descriptors.
The model and the I(d) rebinner run on `device` (None: the card; "cpu" on
request).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.config import GEOMETRY
from ..physics.qwrapper import Qwrapper, d_centers_hr
from ..pipelines.inference import SwinWNetInference
from .labeler import make_fixed_centers
from .viewer import load_model_any, stage_arrays

# preferred stage display order (swinwnet_viewer_gui.py:568-578)
PREFERRED_STAGES = (
    "images",
    "seg_map_lr",
    "images_masked_lr",
    "norm",
    "upscaled_norm",
    "upscaled_denorm",
    "seg_map_hr",
    "images_masked_hr",
)


def is_seg_mask_stage(stage: str) -> bool:
    """swinwnet_viewer_gui.py:77-80."""
    s = stage.lower()
    return s in ("seg_map_lr", "seg_map_hr") or s.startswith("seg_map")


def sorted_stage_names(names: Sequence[str]) -> List[str]:
    """Preferred pipeline order first, then alphabetical extras
    (swinwnet_viewer_gui.py:567-588)."""
    out, used = [], set()
    for p in PREFERRED_STAGES:
        if p in names and p not in used:
            out.append(p)
            used.add(p)
    for n in sorted(names):
        if n not in used:
            out.append(n)
    return out


def as_4d(x: np.ndarray) -> np.ndarray:
    """[H,W] / [B,H,W] / [B,C,H,W] -> [B,C,H,W] (swinwnet_viewer_gui.py:115-126)."""
    x = np.asarray(x)
    if x.ndim == 2:
        return x[None, None]
    if x.ndim == 3:
        return x[:, None]
    if x.ndim == 4:
        return x
    raise ValueError(f"expected 2-4D array, got shape {x.shape}")


@dataclass
class TileData:
    """One rendered tile: images + captions, ready for any canvas."""

    title: str
    left: np.ndarray
    right: Optional[np.ndarray]
    left_title: str
    right_title: str
    is_mask: bool
    log2d: bool


@dataclass
class CurveData:
    """One I(d) curve (+ optional error band) for the 1D plot."""

    stage: str
    d: np.ndarray
    I: np.ndarray
    err: Optional[np.ndarray]
    line_visible: bool
    band_visible: bool


@dataclass
class ViewerModel:
    """The viewer's full interactive state."""

    theta_range: Tuple[float, float] = GEOMETRY.theta_range
    lambda_range: Tuple[float, float] = GEOMETRY.lambda_range
    fixed_centers: np.ndarray = field(default_factory=lambda: d_centers_hr.astype(np.float32))
    device: Optional[Union[str, torch.device]] = None

    # view options (reference widget defaults)
    sample_idx: int = 0
    tiles_per_stage: int = 1
    norm_1d: bool = False
    log_2d: bool = False
    auto_ylim: bool = True
    ymin: float = -1.0
    ymax: float = 1.0

    def __post_init__(self):
        self.data: Dict[str, np.ndarray] = {}
        self.stage_order: List[str] = []
        self.selected_stages: List[str] = []
        self.stage_visible: Dict[str, bool] = {}
        self.band_visible: Dict[str, bool] = {}
        self.current_images: Optional[np.ndarray] = None
        self.model = None
        self.infer = None
        self.error_matrix: Optional[bool] = None
        self.status = "Drop a .npy or open file."
        self._qw: Optional[Qwrapper] = None

    # ---------- geometry / d-grid (swinwnet_viewer_gui.py:806-822) ----------

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

    def set_geometry(self, theta_range: Tuple[float, float], lambda_range: Tuple[float, float]):
        self.theta_range = (float(theta_range[0]), float(theta_range[1]))
        self.lambda_range = (float(lambda_range[0]), float(lambda_range[1]))
        self._qw = None

    # ---------- loading (swinwnet_viewer_gui.py:598-664, 714-751) ----------

    def load_npy(self, path: str) -> bool:
        """Raw arrays become the 'images' input; dict payloads may carry
        precomputed stages. Returns True if anything usable loaded."""
        obj = np.load(path, allow_pickle=True)
        item = obj.item() if getattr(obj, "shape", None) == () else obj
        payload = item if isinstance(item, dict) else {"images": item}

        self.data = {}
        self.stage_order = []
        self.selected_stages = []
        self.stage_visible = {}
        self.band_visible = {}
        self.current_images = None

        if "images" in payload:
            x = np.asarray(payload["images"])
            if x.ndim in (2, 3, 4):
                self.current_images = as_4d(x).astype(np.float32)

        for k, v in payload.items():
            if v is None:
                continue
            vv = np.asarray(v)
            if vv.ndim in (2, 3, 4):
                self.data[str(k)] = vv

        if not self.data and self.current_images is None:
            self.status = "No 2D/3D/4D arrays found in file."
            return False

        if self.data:
            self.stage_order = sorted_stage_names(list(self.data.keys()))
            for st in self.stage_order:
                self.stage_visible.setdefault(st, True)
                self.band_visible.setdefault(st, False)
        self.status = f"Loaded {path} | stages={len(self.stage_order)}"
        return True

    def load_weights(self, path: str):
        """Build the model from a .pth on `device` (unwrap/module-strip/
        multimodality sniffing handled by apps.viewer.load_model_any)."""
        self.model, self.error_matrix = load_model_any(path, self.device)
        self.infer = SwinWNetInference(self.model)
        self.status = f"Weights loaded (error_matrix={self.error_matrix})"

    # ---------- inference (swinwnet_viewer_gui.py:753-803) ----------

    def run_inference(self) -> bool:
        if self.infer is None:
            self.status = "Load weights first."
            return False
        if self.current_images is None:
            self.status = "Load images (.npy) first (array or dict with key 'images')."
            return False

        self.infer(self.current_images)
        self.data = stage_arrays(self.infer)
        self.stage_order = sorted_stage_names(list(self.data.keys()))
        self.selected_stages = []
        self.stage_visible = {st: True for st in self.stage_order}
        self.band_visible = {st: False for st in self.stage_order}  # default off
        self.sample_idx = 0
        self.status = f"Inference done | stages={len(self.stage_order)}"
        return True

    def batch_size(self) -> int:
        b = 1
        for n in self.stage_order:
            x = np.asarray(self.data[n])
            if x.ndim in (3, 4):
                b = max(b, x.shape[0])
        return b

    # ---------- selection / visibility ----------

    def toggle_stage_selected(self, stage: str, on: bool):
        if on and stage not in self.selected_stages:
            self.selected_stages.append(stage)
            self.selected_stages = [s for s in self.stage_order if s in self.selected_stages]
        elif not on and stage in self.selected_stages:
            self.selected_stages.remove(stage)

    def toggle_line(self, stage: str) -> bool:
        """Legend click on a line label (swinwnet_viewer_gui.py:1005-1034)."""
        vis = not self.stage_visible.get(stage, True)
        self.stage_visible[stage] = vis
        return vis

    def toggle_band(self, stage: str) -> bool:
        vis = not self.band_visible.get(stage, False)
        self.band_visible[stage] = vis
        return vis

    # ---------- render data ----------

    def tiles(self) -> List[TileData]:
        """Tile descriptors for the selected stages
        (swinwnet_viewer_gui.py:828-890)."""
        out = []
        for stage in self.selected_stages:
            x = as_4d(self.data[stage])
            B, C = x.shape[:2]
            start = max(0, min(self.sample_idx, B - 1))
            end = min(B, start + self.tiles_per_stage)
            for b in range(start, end):
                is_seg = is_seg_mask_stage(stage)
                if C >= 2 and not is_seg:
                    out.append(
                        TileData(
                            f"{stage} | b={b}", x[b, 0], x[b, 1],
                            "Diffraction", "Error", is_seg, self.log_2d,
                        )
                    )
                else:
                    out.append(
                        TileData(
                            f"{stage} | b={b}", x[b, 0], None,
                            "Mask" if is_seg else "Diffraction", "", is_seg, self.log_2d,
                        )
                    )
        return out

    def curves(self) -> List[CurveData]:
        """I(d) curve descriptors for the selected stages, with the
        +-error band from channel 1 when present
        (swinwnet_viewer_gui.py:892-1003)."""
        out = []
        for stage in self.selected_stages:
            x4 = as_4d(self.data[stage]).astype(np.float32, copy=False)
            B, C = x4.shape[:2]
            b = max(0, min(self.sample_idx, B - 1))

            pack = self.qw.tensor_to_d(x4[b : b + 1, 0:1])[0]
            d = pack["d"]
            I = np.nan_to_num(pack["I"])

            err = None
            if C >= 2:
                epack = self.qw.tensor_to_d(x4[b : b + 1, 1:2])[0]
                err = np.abs(np.nan_to_num(epack["I"]))

            if self.norm_1d:
                m = float(np.max(I)) if I.size else 0.0
                if m > 0:
                    I = I / m
                    if err is not None:
                        err = err / m

            out.append(
                CurveData(
                    stage, d, I, err,
                    self.stage_visible.get(stage, True),
                    self.band_visible.get(stage, False) and self.stage_visible.get(stage, True),
                )
            )
        return out

    def ylim(self) -> Optional[Tuple[float, float]]:
        """None = autoscale; else the manual (ymin, ymax) with the reference's
        degenerate-range guard (swinwnet_viewer_gui.py:988-1003)."""
        if self.norm_1d:
            return (0.0, 1.5)
        if self.auto_ylim:
            return None
        ymax = self.ymax if self.ymax > self.ymin else self.ymin + 1e-6
        return (self.ymin, ymax)

    # ---------- export (swinwnet_viewer_gui.py:1055-1088) ----------

    def export_csv(self, path: str) -> int:
        """Visible curves -> CSV (d + I_<stage> columns). Returns the number
        of exported series; 0 = nothing visible."""
        import csv

        series = [(c.stage, c.d, c.I) for c in self.curves() if c.line_visible]
        if not series:
            return 0
        dref = series[0][1]
        with open(path, "w", newline="", encoding="utf-8") as f:
            w = csv.writer(f)
            w.writerow(["d"] + [f"I_{name}" for name, _, _ in series])
            for i in range(len(dref)):
                row = [float(dref[i])]
                for _, _, y in series:
                    row.append(float(y[i]) if i < len(y) else "")
                w.writerow(row)
        return len(series)
