"""Building blocks of SwinWNet in PyTorch (port of
`swinwnet_tpu/models/layers.py`).

* Token grids travel as [B, H, W, C], as in the JAX package, so every
  module's input and output compares one to one with its counterpart.
* Parameters are fp32 and keep the upstream torch state-dict names
  (`layers.0.blocks.1.attn.qkv.weight`, `mlp.0`/`mlp.3`, `seg_head.0`/`.2`,
  `reconstruction.0`/`.2`, `attn.in_proj_weight`, ...), so upstream `.pth`
  files load as they are.
* `dtype` is the compute dtype. Products take their operands in it (in fp32
  at full fp32, under `core.device.full_fp32`, as the JAX package's
  `Precision.HIGHEST`), LayerNorm
  statistics and softmax are fp32, and a module's output is in it, with the
  JAX package's one exception: the cross-attention returns fp32
  (`q + gamma * out` with an fp32 gamma), so in bf16 the residual trunks of
  the levels it feeds (the bottleneck and the first decoder stage) are fp32.
* The models take only a dropout rate of 0 (every rate of the published
  recipe is 0; `SwinWNet` raises on any other), so a forward is
  deterministic in `train()` and in `eval()` alike, and both take the same
  route.
* `BasicLayer` sends a whole level to a fused block kernel
  (`ops/swin_block.py`, through its differentiable entry point) with the
  JAX package's gate: at least 128 windows; C <= 96 in bf16 or C <= 48 in
  fp32 goes to `fused_layout` ("cmajor", or "nmajor" where the grid tiles);
  wider levels up to C = 384 go to the row-major kernel when `fused_deep`.
  `fused_deep` and `fused_layout` stand for the JAX package's
  SWINWNET_FUSED_DEEP and SWINWNET_FUSED_LAYOUT environment variables.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.device import full_fp32
from ..ops.resize import bilinear_resize
from ..ops.swin_block import fused_block_autodiff, kernel_plan
from ..ops.window import (
    relative_position_index,
    window_pad_mask_np,
    window_partition,
    window_partition_nmajor,
    window_reverse,
    window_reverse_nmajor,
)


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """nn.Linear with operands, product and bias in the compute dtype (fp32
    at full fp32)."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    with full_fp32(dtype):
        return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with fp32 statistics (eps 1e-5), output in the compute dtype."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, 1e-5).to(dtype)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype, **kw) -> torch.Tensor:
    """A cuDNN convolution in the compute dtype (fp32 at full fp32)."""
    with full_fp32(dtype):
        return F.conv2d(x.to(dtype), conv.weight.to(dtype), conv.bias.to(dtype), **kw)


# ---------------------------------------------------------------------------
# Patch embedding
# ---------------------------------------------------------------------------


class ScaleAwarePatchEmbed(nn.Module):
    """One conv embeds the LR image (scale 1: stride p) and the SR output
    (scale 2: stride 2p, dilation 2, over 2H x 2W) onto the same token grid.
    Input NCHW; returns ([B, h, w, C] grid, (H_pad, W_pad))."""

    def __init__(self, patch_size: int, in_chans: int, embed_dim: int, dtype: torch.dtype):
        super().__init__()
        self.patch_size, self.in_chans, self.dtype = patch_size, in_chans, dtype
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(embed_dim)

    def forward(self, x: torch.Tensor, scale_factor: int = 1):
        p, s = self.patch_size, scale_factor
        B, C, H, W = x.shape
        if C != self.in_chans:
            raise ValueError(f"expected {self.in_chans} channels, got {C}")
        m = p * s
        pad_h, pad_w = (-H) % m, (-W) % m
        if pad_h or pad_w:
            x = F.pad(x, (0, pad_w, 0, pad_h))
        y = conv2d(x, self.proj, self.dtype, stride=m, dilation=s)
        y = layer_norm(y.permute(0, 2, 3, 1), self.norm, self.dtype)
        return y, (H + pad_h, W + pad_w)


# ---------------------------------------------------------------------------
# Window attention and the Swin block (windowed layout, shift 0)
# ---------------------------------------------------------------------------


class WindowAttention(nn.Module):
    """MSA within 5x5 windows with a learned relative-position bias. Input
    [num_windows, N, C]; scores, softmax and P.V in fp32 from operands in the
    compute dtype."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool, dtype: torch.dtype):
        super().__init__()
        self.dim, self.window_size, self.num_heads, self.dtype = dim, window_size, num_heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads)
        )
        self.register_buffer(
            "relative_position_index", torch.from_numpy(relative_position_index(window_size).copy())
        )

    def rel_bias(self) -> torch.Tensor:
        """[nH, N, N] fp32 bias gathered from the table."""
        N = self.window_size ** 2
        idx = self.relative_position_index.reshape(-1)
        return self.relative_position_bias_table[idx].reshape(N, N, -1).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        Bw, N, C = x.shape
        nH = self.num_heads
        hd = C // nH
        dt = self.dtype
        qkv = linear(x, self.qkv, dt).reshape(Bw, N, 3, nH, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * torch.tensor(hd ** -0.5, dtype=dt), qkv[1], qkv[2]
        with full_fp32(dt):
            attn = q.float() @ k.float().transpose(-1, -2) + self.rel_bias()
            attn = torch.softmax(attn, dim=-1).to(dt)
            out = (attn.float() @ v.float()).to(dt)  # [Bw, nH, N, hd]
        return linear(out.transpose(1, 2).reshape(Bw, N, C), self.proj, dt)


@functools.lru_cache(maxsize=64)
def _pad_mask_tensor(H: int, W: int, ws: int, B: int, layout: str, device: str) -> Optional[torch.Tensor]:
    """The pad mask on `device`: "windows" [nW, N, 1] for the unfused blocks,
    "cmajor" [N, B*nW] and "rowmajor" [B*nW*N, 1] for the fused kernels."""
    m = window_pad_mask_np(H, W, ws)
    if m is None:
        return None
    # a normal tensor even when first made under inference_mode: the cache
    # outlives the call, and a later autograd forward may save it
    with torch.inference_mode(False):
        if layout == "windows":
            return torch.from_numpy(m.copy()).to(device)
        tiled = torch.from_numpy(np.tile(m[:, :, 0], (B, 1))).to(device)  # [B*nW, N]
        return tiled.t() if layout == "cmajor" else tiled.reshape(-1, 1)


class SwinTransformerBlock(nn.Module):
    """Pre-LN W-MSA block on window tokens [B*nW, N, C], shift 0. Pad token
    slots are zeroed after LN1, which makes the windowed layout equal to the
    reference's per-block pad-after-norm."""

    def __init__(self, dim: int, num_heads: int, window_size: int, mlp_ratio: float,
                 qkv_bias: bool, dtype: torch.dtype):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, dtype)
        self.norm2 = nn.LayerNorm(dim)
        # indices 0 and 3 are the upstream checkpoint's fc1 / fc2
        self.mlp = nn.Sequential(
            nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0), nn.Linear(hidden, dim), nn.Dropout(0.0)
        )

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.dtype
        y = layer_norm(x, self.norm1, dt)
        if pad_mask is not None:  # [nW, N, 1]
            nW = pad_mask.shape[0]
            y = (y.reshape(-1, nW, *y.shape[1:]) * pad_mask.to(dt)).reshape(y.shape)
        x = x + self.attn(y)
        y = layer_norm(x, self.norm2, dt)
        y = linear(F.gelu(linear(y, self.mlp[0], dt)), self.mlp[3], dt)
        return x + y

    def forward_fused(self, x: torch.Tensor, layout: str,
                      pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The whole block as one call of the differentiable fused block on
        x in `layout`: "cmajor" [C, N, Wt] with pad_mask [N, Wt], "rowmajor"
        [Wt*N, C] with pad_mask [Wt*N, 1], "nmajor" [N, Wt, C]. The weights
        go in as views of the parameters (cast to the compute dtype in
        bf16): [in, out] is `weight.t()`, and the cmajor entry takes wqkv,
        w1 and w2 as [out, in]."""
        dt = self.dtype
        qkv_b = self.attn.qkv.bias
        if qkv_b is None:
            qkv_b = torch.zeros(3 * self.dim, device=x.device)
        in_out = lambda lin: lin.weight.to(dt).t()
        out_in = (lambda lin: lin.weight.to(dt)) if layout == "cmajor" else in_out
        return fused_block_autodiff(
            layout, self.num_heads, x.to(dt), pad_mask,
            self.norm1.weight, self.norm1.bias,
            out_in(self.attn.qkv), qkv_b,
            self.attn.rel_bias(),
            in_out(self.attn.proj), self.attn.proj.bias,
            self.norm2.weight, self.norm2.bias,
            out_in(self.mlp[0]), self.mlp[0].bias,
            out_in(self.mlp[3]), self.mlp[3].bias,
        )


class BasicLayer(nn.Module):
    """`depth` Swin blocks, shift 0. The grid is partitioned into windows once,
    every block runs on window tokens, and the windows are reversed once.
    `fused_deep` and `fused_layout` are the JAX package's
    SWINWNET_FUSED_DEEP=1 and SWINWNET_FUSED_LAYOUT."""

    # the JAX gate's least window count for a fused level (it lifts the rule
    # under its interpret switch; the CPU tests lower this attribute instead)
    min_windows = 128

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int = 5,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, fused_blocks: bool = False,
                 dtype: torch.dtype = torch.float32, fused_deep: bool = False,
                 fused_layout: str = "cmajor"):
        super().__init__()
        if fused_layout not in ("cmajor", "nmajor"):
            raise ValueError(f"fused_layout must be 'cmajor' or 'nmajor', got {fused_layout!r}")
        self.dim, self.window_size, self.fused_blocks, self.dtype = dim, window_size, fused_blocks, dtype
        self.fused_deep, self.fused_layout = fused_deep, fused_layout
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, window_size, mlp_ratio, qkv_bias, dtype)
            for _ in range(depth)
        )

    def fused_route(self, B: int, H: int, W: int) -> str:
        """The JAX package's fused-kernel gate (its TPU-backend test aside):
        the layout of the kernel this level goes to, or "" for the unfused
        blocks. At least 128 windows; C <= 96 in bf16 (48 in fp32) goes to
        `fused_layout`, where "nmajor" has no pad mask and falls back on a
        grid that does not tile; wider levels up to C = 384 go to
        "rowmajor" when `fused_deep`. A level the kernel has no plan for
        (`kernel_plan` raises, as at a head width that is not a multiple of
        4) stays on the unfused blocks, which compute the same block."""
        ws = self.window_size
        cap = 96 if self.dtype == torch.bfloat16 else 48
        n_windows = B * (-(-H // ws)) * (-(-W // ws))
        if not (self.fused_blocks and n_windows >= self.min_windows):
            return ""
        if self.dim <= cap:
            padded = H % ws != 0 or W % ws != 0
            route = "" if self.fused_layout == "nmajor" and padded else self.fused_layout
        else:
            route = "rowmajor" if self.fused_deep and self.dim <= 384 else ""
        return route if route and self._kernel_takes(route) else ""

    def _kernel_takes(self, route: str) -> bool:
        """Whether the kernel has a plan for this level's width, heads and
        dtype on `route` (the row-major entry keeps qkv fp32)."""
        try:
            kernel_plan(self.dim, self.blocks[0].num_heads, self.dtype, round_qkv=route != "rowmajor")
        except (ValueError, TypeError):
            return False
        return True

    def uses_kernel(self, B: int, H: int, W: int) -> bool:
        return self.fused_route(B, H, W) != ""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws = self.window_size
        dev = str(x.device)
        route = self.fused_route(B, H, W)
        if route == "nmajor":
            xw, (Hp, Wp) = window_partition_nmajor(x, ws)  # [N, Wt, C]
            for blk in self.blocks:
                xw = blk.forward_fused(xw, "nmajor")
            x = window_reverse_nmajor(xw, ws, Hp, Wp)
            return x[:, :H, :W, :] if (Hp, Wp) != (H, W) else x
        xw, (Hp, Wp) = window_partition(x, ws)  # [Wt, N, C]
        if route == "cmajor":
            # the kernel reads the token-major windows through a [C, N, Wt] view
            mask = _pad_mask_tensor(H, W, ws, B, "cmajor", dev)
            xc = xw.permute(2, 1, 0)
            for blk in self.blocks:
                xc = blk.forward_fused(xc, "cmajor", mask)
            xw = xc.permute(2, 1, 0)
        elif route == "rowmajor":
            mask = _pad_mask_tensor(H, W, ws, B, "rowmajor", dev)
            x2 = xw.reshape(-1, C)
            for blk in self.blocks:
                x2 = blk.forward_fused(x2, "rowmajor", mask)
            xw = x2.reshape(xw.shape)
        else:
            mask = _pad_mask_tensor(H, W, ws, B, "windows", dev)
            for blk in self.blocks:
                xw = blk(xw, mask)
        x = window_reverse(xw, ws, Hp, Wp)
        return x[:, :H, :W, :] if (Hp, Wp) != (H, W) else x


# ---------------------------------------------------------------------------
# Down / up sampling
# ---------------------------------------------------------------------------


class PatchMerging(nn.Module):
    """2x downsample: 2x2 neighbour concat -> LN -> Linear(4C -> 2C, no bias)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[1], x.shape[2]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat(
            [x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1
        )
        return linear(layer_norm(x, self.norm, self.dtype), self.reduction, self.dtype)


class PatchExpanding(nn.Module):
    """2x upsample: Linear(C -> 2C, no bias) -> pixel shuffle -> LN(C/2)."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        x = linear(x, self.expand, self.dtype).reshape(B, H, W, 2, 2, C // 2)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, C // 2)
        return layer_norm(x, self.norm, self.dtype)


# ---------------------------------------------------------------------------
# Encoder / bottleneck / decoder
# ---------------------------------------------------------------------------


class SwinEncoder(nn.Module):
    """(BasicLayer -> skip -> PatchMerging) per stage, then a last BasicLayer.
    Returns the skip grids; the last is the deepest feature map."""

    def __init__(self, embed_dim: int, depths: Sequence[int], num_heads: Sequence[int],
                 window_size: int, mlp_ratio: float, qkv_bias: bool, fused_blocks: bool,
                 dtype: torch.dtype, fused_deep: bool = False, fused_layout: str = "cmajor"):
        super().__init__()
        n = len(depths)
        dims = [embed_dim * 2 ** i for i in range(n)]
        self.layers = nn.ModuleList(
            BasicLayer(dims[i], depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias,
                       fused_blocks, dtype, fused_deep, fused_layout)
            for i in range(n)
        )
        self.downs = nn.ModuleList(PatchMerging(dims[i], dtype) for i in range(n - 1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        skips = []
        for i, layer in enumerate(self.layers):
            x = layer(x)
            skips.append(x)
            if i < len(self.downs):
                x = self.downs[i](x)
        return skips


class Bottleneck(nn.Module):
    """Depth-2 BasicLayer at 8C (default MLP ratio and qkv bias, as the
    reference)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, fused_blocks: bool,
                 dtype: torch.dtype, fused_deep: bool = False, fused_layout: str = "cmajor"):
        super().__init__()
        self.layer = BasicLayer(dim, 2, num_heads, window_size, fused_blocks=fused_blocks, dtype=dtype,
                                fused_deep=fused_deep, fused_layout=fused_layout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer(x)


class SwinDecoder(nn.Module):
    """Per stage: PatchExpanding -> crop to the skip -> concat -> BasicLayer ->
    Linear(2C -> C). Depths and heads are the encoder's reversed, without
    the deepest."""

    def __init__(self, embed_dim: int, depths: Sequence[int], num_heads: Sequence[int],
                 window_size: int, mlp_ratio: float, qkv_bias: bool, fused_blocks: bool,
                 dtype: torch.dtype, fused_deep: bool = False, fused_layout: str = "cmajor"):
        super().__init__()
        self.dtype = dtype
        dec_depths, dec_heads = tuple(depths[-2::-1]), tuple(num_heads[-2::-1])
        dims = [embed_dim * 8 // 2 ** i for i in range(len(depths) - 1)]
        self.ups = nn.ModuleList(PatchExpanding(d, dtype) for d in dims)
        self.swin_blocks = nn.ModuleList(
            BasicLayer(d, dec_depths[i], dec_heads[i], window_size, mlp_ratio, qkv_bias,
                       fused_blocks, dtype, fused_deep, fused_layout)
            for i, d in enumerate(dims)
        )
        self.linears = nn.ModuleList(nn.Linear(d, d // 2) for d in dims)

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor]) -> torch.Tensor:
        skips = list(skips)[-2::-1]
        for i, skip in enumerate(skips):
            x = self.ups[i](x)
            th, tw = skip.shape[1], skip.shape[2]
            x = x[:, :th, :tw, :]
            # a skip that went through the cross-attention is fp32: promote
            dt = torch.promote_types(x.dtype, skip.dtype)
            x = torch.cat([x.to(dt), skip.to(dt)], dim=-1)
            x = self.swin_blocks[i](x)
            x = linear(x, self.linears[i], self.dtype)
        return x


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------


class SegmentationHead(nn.Module):
    """Conv3x3 -> GELU -> Conv1x1 -> bilinear x(p*scale) -> crop; 1-channel
    fp32 logits, NCHW."""

    def __init__(self, embed_dim: int, patch_size: int, dtype: torch.dtype):
        super().__init__()
        self.patch_size, self.dtype = patch_size, dtype
        self.seg_head = nn.Sequential(
            nn.Conv2d(embed_dim, embed_dim // 2, 3, padding=1), nn.GELU(),
            nn.Conv2d(embed_dim // 2, 1, 1),
        )

    def forward(self, x: torch.Tensor, padded_res: Tuple[int, int], scale_factor: int = 1):
        H, W = padded_res
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)
        x = conv2d(F.gelu(conv2d(x, self.seg_head[0], dt, padding=1)), self.seg_head[2], dt)
        up = self.patch_size * scale_factor
        x = bilinear_resize(x.float(), x.shape[2] * up, x.shape[3] * up)
        return x[:, :, :H, :W]


class UpscalingHead(nn.Module):
    """2x (PatchExpanding + depth-2 BasicLayer) -> Conv3x3 -> GELU -> Conv1x1;
    2 output channels with the error matrix, else 1. NCHW out, 4x the token
    grid."""

    def __init__(self, error_matrix: bool, embed_dim: int, window_size: int, num_heads: int,
                 depth: int, mlp_ratio: float, qkv_bias: bool, fused_blocks: bool,
                 dtype: torch.dtype, fused_deep: bool = False, fused_layout: str = "cmajor"):
        super().__init__()
        self.dtype = dtype
        dims = [embed_dim, embed_dim // 2]
        self.ups = nn.ModuleList(PatchExpanding(d, dtype) for d in dims)
        self.swin_blocks = nn.ModuleList(
            BasicLayer(d // 2, depth, num_heads, window_size, mlp_ratio, qkv_bias, fused_blocks, dtype,
                       fused_deep, fused_layout)
            for d in dims
        )
        c = embed_dim // 4
        self.reconstruction = nn.Sequential(
            nn.Conv2d(c, c, 3, padding=1), nn.GELU(), nn.Conv2d(c, 2 if error_matrix else 1, 1)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for up, layer in zip(self.ups, self.swin_blocks):
            x = layer(up(x))
        dt = self.dtype
        x = x.permute(0, 3, 1, 2)
        x = conv2d(x, self.reconstruction[0], dt, padding=1)
        return conv2d(F.gelu(x), self.reconstruction[2], dt)


# ---------------------------------------------------------------------------
# Cross attention between towers
# ---------------------------------------------------------------------------


class _MultiheadAttentionParams(nn.Module):
    """The parameters of torch's nn.MultiheadAttention under its own names
    (packed `in_proj_weight` [3C, C], `in_proj_bias`, `out_proj`); the
    attention itself is written out in CrossAttentionBlock."""

    def __init__(self, dim: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


class CrossAttentionBlock(nn.Module):
    """LN(q), LN(kv) -> multi-head cross attention -> q + gamma * out, with
    nn.MultiheadAttention's numerics (packed in-projection, q scaled by
    hd^-0.5 after it) written as matmul + softmax. gamma starts at 0, so the
    towers start decoupled. Sequences [B, L, C]."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.norm_q = nn.LayerNorm(dim)
        self.norm_kv = nn.LayerNorm(dim)
        self.attn = _MultiheadAttentionParams(dim)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, q: torch.Tensor, kv: torch.Tensor) -> torch.Tensor:
        B, Lq, C = q.shape
        Lk = kv.shape[1]
        nH = self.num_heads
        hd = C // nH
        dt = self.dtype
        w, b = self.attn.in_proj_weight, self.attn.in_proj_bias
        qn = layer_norm(q, self.norm_q, dt)
        kvn = layer_norm(kv, self.norm_kv, dt)
        with full_fp32(dt):
            # bf16 products, fp32 bias: the projections come out fp32, as in JAX
            qp = F.linear(qn, w[:C].to(dt)).float() + b[:C]
            kp = F.linear(kvn, w[C:2 * C].to(dt)).float() + b[C:2 * C]
            vp = F.linear(kvn, w[2 * C:].to(dt)).float() + b[2 * C:]
            qp = qp.reshape(B, Lq, nH, hd).transpose(1, 2) * hd ** -0.5
            kp = kp.reshape(B, Lk, nH, hd).transpose(1, 2)
            vp = vp.reshape(B, Lk, nH, hd).transpose(1, 2)
            attn = torch.softmax(qp @ kp.transpose(-1, -2), dim=-1).to(dt)
            out = (attn.float() @ vp).transpose(1, 2).reshape(B, Lq, C).to(dt)
        out = linear(out, self.attn.out_proj, dt)
        # fp32 whatever the compute dtype: gamma is fp32, as in the JAX package
        return q.float() + self.gamma * out.float()


class MultiScaleCrossAttention(nn.Module):
    """CrossAttentionBlocks zipped over [B, H, W, C] skip grids."""

    def __init__(self, dims: Sequence[int], heads: Sequence[int], dtype: torch.dtype):
        super().__init__()
        self.blocks = nn.ModuleList(CrossAttentionBlock(d, h, dtype) for d, h in zip(dims, heads))

    def forward(self, targets: Sequence[torch.Tensor], sources: Sequence[torch.Tensor]):
        out = []
        for blk, t, s in zip(self.blocks, targets, sources):
            B, H, W, C = t.shape
            y = blk(t.reshape(B, H * W, C), s.reshape(B, -1, s.shape[-1]))
            out.append(y.reshape(B, H, W, C))
        return out
