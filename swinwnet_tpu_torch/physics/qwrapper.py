"""2D detector pattern -> 1D I(d) rebinning on the device (port of
`swinwnet_tpu/physics/qwrapper.py`).

The detector geometry is static: the interplanar-distance map
``d(lambda, theta) = lambda / (2 sin(|theta|/2))`` and so the bin of every
pixel are computed once per image size in numpy. Pixels with d > d_max
(7.5 A) go to a dump bin n_bins that is never summed.

`rebin` is then a segment sum of `[B, H*W]` into the n_bins bins on the
input's device: the pixels are gathered in bin order (a stable sort of the
bin map, so within a bin they keep their pixel order) and each bin is summed
by `torch.segment_reduce`. That is a deterministic reduction, chosen over
`index_add_`'s atomics: the peak gates downstream are hard thresholds
(height, prominence, width, the 0.05 A matching tolerance), so a sum that
changed in its last bit from run to run could change the reward; summed in
pixel order, the card's spectra are those of a sequential sum, as the CPU's
are. The lengths are a bincount and the gathered pixels exactly those they
count, so they pass segment_reduce's check by construction; the reduction
runs `unsafe`, without it: the check reads the lengths back from the device
on every call, which a CUDA graph cannot capture.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core.config import GEOMETRY
from ..core.device import resolve_device

# Published evaluation d-grids (reference: tests.py:168-169, RL_finetuning_pipline.py:19)
d_centers_lr = np.linspace(0.0546658, 7.49180085, 832)
d_centers_hr = np.linspace(0.05318052, 7.49710258, 1241)


def make_d_grid(H, W, theta_range=GEOMETRY.theta_range, L_range=GEOMETRY.lambda_range):
    """Static interplanar-distance map of an HxW detector image: theta
    (degrees) spans the columns, lambda the rows, d = lambda / (2 sin(|theta|/2))."""
    theta_deg = np.linspace(theta_range[0], theta_range[1], W)
    L_vals = np.linspace(L_range[0], L_range[1], H)
    theta_rad = np.deg2rad(theta_deg)
    L_grid, theta_grid = np.meshgrid(L_vals, theta_rad, indexing="ij")
    return L_grid / (2.0 * np.sin(np.abs(theta_grid) * 0.5))


def centers_to_edges(centers: np.ndarray) -> np.ndarray:
    """Bin edges from fixed centers (Diffraction_metrics.py:29-33)."""
    centers = np.asarray(centers, dtype=np.float32)
    edges = np.zeros(len(centers) + 1, dtype=np.float32)
    edges[1:-1] = (centers[:-1] + centers[1:]) * 0.5
    edges[0] = centers[0] - (centers[1] - centers[0]) * 0.5
    edges[-1] = centers[-1] + (centers[-1] - centers[-2]) * 0.5
    return edges


def as_device_tensor(x, device: Optional[torch.device]) -> torch.Tensor:
    """A tensor stays on its own device; anything else goes to `device`
    (None: the card, which must exist)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


class Qwrapper:
    """d-space rebinner with a fixed-center d-grid.

    `rebin(batch)` takes `[B, 1, H, W]` (or `[B, H, W]`) and returns the
    `[B, n_bins]` fp32 spectra on the batch's device; a numpy batch goes to
    `device` (None: the card). `tensor_to_d(batch)` keeps the reference's
    API: a list of per-sample ``{"d", "I"}`` numpy dicts."""

    def __init__(
        self,
        theta_range=GEOMETRY.theta_range,
        L_range=GEOMETRY.lambda_range,
        fixed_centers=None,
        d_max: float = GEOMETRY.d_max,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if fixed_centers is None:
            raise ValueError("fixed_centers must be provided")
        self.theta_range = theta_range
        self.L_range = L_range
        self.d_max = float(d_max)
        self.centers = np.asarray(fixed_centers, dtype=np.float32)
        self.edges = centers_to_edges(self.centers)
        self.n_bins = len(self.centers)
        self.device = device
        self._index_cache: Dict[Tuple[int, int], np.ndarray] = {}
        self._segment_cache: Dict[Tuple[int, int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}
        self._centers_cache: Dict[torch.device, torch.Tensor] = {}

    def _indices_for(self, H: int, W: int) -> np.ndarray:
        """Per-pixel target bin (int64), masked pixels -> dump bin n_bins."""
        key = (H, W)
        if key not in self._index_cache:
            d_grid = make_d_grid(H, W, self.theta_range, self.L_range)
            # torch.bucketize(v, edges) with right=False == searchsorted side='right';
            # the reference then subtracts 1 and clamps to [0, n-1]
            # (Diffraction_metrics.py:61-63).
            idx = np.searchsorted(self.edges, d_grid.ravel(), side="right") - 1
            idx = np.clip(idx, 0, self.n_bins - 1)
            idx = np.where(d_grid.ravel() > self.d_max, self.n_bins, idx)  # dump bin
            self._index_cache[key] = idx.astype(np.int64)
        return self._index_cache[key]

    def _segments_for(self, H: int, W: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pixel order [P] int64, pixels per bin [n_bins] int64) on `device`:
        the kept pixels sorted by bin, pixel order kept within a bin."""
        key = (H, W, torch.device(device))
        if key not in self._segment_cache:
            idx = self._indices_for(H, W)
            order = np.argsort(idx, kind="stable")
            lengths = np.bincount(idx, minlength=self.n_bins + 1)[: self.n_bins]
            order = order[: int(lengths.sum())]  # the dump bin sorts last
            self._segment_cache[key] = (
                torch.from_numpy(order).to(device), torch.from_numpy(lengths).to(device)
            )
        return self._segment_cache[key]

    def rebin(self, batch) -> torch.Tensor:
        """[B, 1, H, W] (or [B, H, W]) -> [B, n_bins] fp32 I(d) on the batch's device."""
        batch = as_device_tensor(batch, self.device)
        if batch.dim() == 4:
            batch = batch[:, 0]
        B, H, W = batch.shape
        order, lengths = self._segments_for(H, W, batch.device)
        I_sorted = batch.reshape(B, H * W).float().index_select(1, order)
        return torch.segment_reduce(I_sorted, "sum", lengths=lengths.expand(B, -1), axis=1, unsafe=True)

    def centers_on(self, device) -> torch.Tensor:
        """The bin centers as an fp32 tensor on `device`, copied there once."""
        device = torch.device(device)
        if device not in self._centers_cache:
            self._centers_cache[device] = torch.from_numpy(self.centers).to(device)
        return self._centers_cache[device]

    def tensor_to_d(self, batch_tensor):
        """Reference-compatible API: list of per-sample {"d", "I"} numpy dicts."""
        batch_tensor = as_device_tensor(batch_tensor, self.device)
        if batch_tensor.dim() != 4:
            raise ValueError("Expected tensor [B,1,H,W]")
        I = self.rebin(batch_tensor).cpu().numpy()
        return [{"d": self.centers.copy(), "I": I[b]} for b in range(I.shape[0])]
