"""Window partition / reverse, the relative-position index and the pad mask
(port of `swinwnet_tpu/ops/window.py` and of `relative_position_index` /
`_window_pad_mask_np` in `swinwnet_tpu/models/layers.py`).

Grids are [B, H, W, C] as in the JAX package. A grid that does not tile by
the window is zero-padded at the bottom and right. Shift is always 0 in the
shipped checkpoints, so the shifted-window mask is not needed.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _pad_to_window(x: torch.Tensor, ws: int) -> Tuple[torch.Tensor, int, int]:
    B, H, W, C = x.shape
    pad_h, pad_w = (-H) % ws, (-W) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    return x, H + pad_h, W + pad_w


def window_partition(x: torch.Tensor, window_size: int):
    """[B, H, W, C] -> ([B * nW, ws*ws, C], (Hp, Wp)), token-major windows."""
    B, _, _, C = x.shape
    ws = window_size
    x, Hp, Wp = _pad_to_window(x, ws)
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
    return x, (Hp, Wp)


def window_reverse(windows: torch.Tensor, window_size: int, Hp: int, Wp: int) -> torch.Tensor:
    """[B * nW, ws*ws, C] -> [B, Hp, Wp, C]."""
    ws = window_size
    nW = (Hp // ws) * (Wp // ws)
    B = windows.shape[0] // nW
    C = windows.shape[-1]
    x = windows.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)


def window_partition_cmajor(x: torch.Tensor, window_size: int):
    """[B, H, W, C] -> ([C, ws*ws, B * nW], (Hp, Wp)), channels-major windows:
    the layout of the JAX package's `fused_swin_block_cst`."""
    B, _, _, C = x.shape
    ws = window_size
    x, Hp, Wp = _pad_to_window(x, ws)
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(5, 2, 4, 0, 1, 3).reshape(C, ws * ws, -1)
    return x, (Hp, Wp)


def window_reverse_cmajor(windows: torch.Tensor, window_size: int, Hp: int, Wp: int) -> torch.Tensor:
    """[C, ws*ws, B * nW] -> [B, Hp, Wp, C] (inverse of
    `window_partition_cmajor`)."""
    ws = window_size
    nW = (Hp // ws) * (Wp // ws)
    B = windows.shape[2] // nW
    C = windows.shape[0]
    x = windows.reshape(C, ws, ws, B, Hp // ws, Wp // ws)
    return x.permute(3, 4, 1, 5, 2, 0).reshape(B, Hp, Wp, C)


def window_partition_nmajor(x: torch.Tensor, window_size: int):
    """[B, H, W, C] -> ([ws*ws, B * nW, C], (Hp, Wp)), token-slot-major
    windows: the layout of `fused_swin_block_wide`."""
    B, _, _, C = x.shape
    ws = window_size
    x, Hp, Wp = _pad_to_window(x, ws)
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(2, 4, 0, 1, 3, 5).reshape(ws * ws, -1, C)
    return x, (Hp, Wp)


def window_reverse_nmajor(windows: torch.Tensor, window_size: int, Hp: int, Wp: int) -> torch.Tensor:
    """[ws*ws, B * nW, C] -> [B, Hp, Wp, C] (inverse of
    `window_partition_nmajor`)."""
    ws = window_size
    nW = (Hp // ws) * (Wp // ws)
    B = windows.shape[1] // nW
    C = windows.shape[-1]
    x = windows.reshape(ws, ws, B, Hp // ws, Wp // ws, C)
    return x.permute(2, 3, 0, 4, 1, 5).reshape(B, Hp, Wp, C)


@functools.lru_cache(maxsize=16)
def relative_position_index(window_size: int) -> np.ndarray:
    """Static [N, N] index into the (2w-1)^2 relative-position bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    rel = coords_flat[:, :, None] - coords_flat[:, None, :]  # 2, N, N
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def window_pad_mask_np(H: int, W: int, window_size: int) -> Optional[np.ndarray]:
    """[nW, N, 1] {0,1} mask of real (non-pad) token slots per window, or
    None when (H, W) tile exactly. The blocks zero pad slots after LN1 with
    it, as the reference's per-block pad-after-norm does."""
    ws = window_size
    if H % ws == 0 and W % ws == 0:
        return None
    grid = np.zeros((H + (-H) % ws, W + (-W) % ws, 1), np.float32)
    grid[:H, :W] = 1.0
    Hp, Wp = grid.shape[0], grid.shape[1]
    m = grid.reshape(Hp // ws, ws, Wp // ws, ws, 1).transpose(0, 2, 1, 3, 4)
    m = m.reshape(-1, ws * ws, 1)
    m.setflags(write=False)
    return m
