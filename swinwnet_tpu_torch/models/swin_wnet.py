"""SwinWNet in PyTorch (port of `swinwnet_tpu/models/swin_wnet.py`).

Two SwinUNet towers, segmentator and upscaler, share one scale-aware patch
embedding and are coupled by gamma-gated cross-attention at the two deepest
skip levels (dims [4C, 8C], heads [3, 3]). The staged methods are the
reference API:

  segment_1(x)                 LR segmentation -> (logits, seg skips)
  upscale(x, skips_seg)        2x SR conditioned on seg skips -> (sr NCHW, skips)
  segment_2(x, skips_up)       HR segmentation of the SR output through the
                               shared embedding at scale_factor=2
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..core.device import resolve_device, resolve_dtype
from ..ops.window import relative_position_index
from .layers import (
    Bottleneck,
    CrossAttentionBlock,
    MultiScaleCrossAttention,
    ScaleAwarePatchEmbed,
    SegmentationHead,
    SwinDecoder,
    SwinEncoder,
    UpscalingHead,
    WindowAttention,
    _MultiheadAttentionParams,
)


class SwinWNet(nn.Module):
    """Built on `device` (default: the CUDA device; "cpu" only when asked)
    with torch-default initial weights drawn from `generator` (a CPU
    torch.Generator; None draws from a generator seeded with 0).

    `fused_blocks` sends the levels the gate admits to the fused block
    kernels (the JAX package's `use_pallas`); `fused_deep` adds the levels
    above the width cap through the row-major kernel (its
    SWINWNET_FUSED_DEEP=1) and `fused_layout` picks "cmajor" or "nmajor" for
    the levels under the cap (its SWINWNET_FUSED_LAYOUT). Both are carried
    down to every BasicLayer.

    `drop`, `attn_drop` and `drop_path` are the JAX model's dropout rates
    (every recipe in the repo sets them to 0). They act only in a call with
    `deterministic=False`, which draws from the `generator` passed to that
    call and routes every level to the unfused blocks; the bottlenecks take
    no rates, as in the JAX model. `remat` recomputes each unfused block in
    the backward; `attn_chunk` > 0 bounds the unfused attention to that many
    windows at a time."""

    def __init__(
        self,
        patch_size: int = 2,
        in_chans: int = 1,
        error_matrix: bool = False,
        embed_dim: int = 48,
        depths: Sequence[int] = (2, 2, 2, 2),
        num_heads: Sequence[int] = (3, 6, 12, 24),
        window_size: int = 5,
        mlp_ratio: float = 4.0,
        qkv_bias: bool = True,
        fused_blocks: bool = False,
        dtype: Union[str, torch.dtype] = "float32",
        device: Optional[Union[str, torch.device]] = None,
        generator: Optional[torch.Generator] = None,
        fused_deep: bool = False,
        fused_layout: str = "cmajor",
        drop: float = 0.0,
        attn_drop: float = 0.0,
        drop_path: float = 0.0,
        remat: bool = False,
        attn_chunk: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        dt = resolve_dtype(dtype)
        self.patch_size, self.error_matrix, self.dtype = patch_size, error_matrix, dt
        depths, num_heads = tuple(depths), tuple(num_heads)
        tower = dict(
            embed_dim=embed_dim, depths=depths, num_heads=num_heads, window_size=window_size,
            mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, fused_blocks=fused_blocks, dtype=dt,
            fused_deep=fused_deep, fused_layout=fused_layout, drop=drop, attn_drop=attn_drop,
            drop_path=drop_path, remat=remat, attn_chunk=attn_chunk,
        )
        level = dict(fused_deep=fused_deep, fused_layout=fused_layout, remat=remat, attn_chunk=attn_chunk)
        rates = dict(drop=drop, attn_drop=attn_drop, drop_path=drop_path)
        in_ch = in_chans + 1 if error_matrix else in_chans
        ca_dims = (embed_dim * 4, embed_dim * 8)
        with torch.device("meta"):  # shapes only; weights are drawn below
            self.patch_embed = ScaleAwarePatchEmbed(patch_size, in_ch, embed_dim, dt)
            self.segmentator_encoder = SwinEncoder(**tower)
            self.segmentator_bottleneck = Bottleneck(embed_dim * 8, num_heads[-1], window_size, fused_blocks, dt, **level)
            self.segmentator_decoder = SwinDecoder(**tower)
            self.segmentator_head = SegmentationHead(embed_dim, patch_size, dt)
            self.ca_seg_to_sr = MultiScaleCrossAttention(ca_dims, (3, 3), dt)
            self.ca_sr_to_seg = MultiScaleCrossAttention(ca_dims, (3, 3), dt)
            self.upscaler_encoder = SwinEncoder(**tower)
            self.upscaler_bottleneck = Bottleneck(embed_dim * 8, num_heads[-1], window_size, fused_blocks, dt, **level)
            self.upscaler_decoder = SwinDecoder(**tower)
            self.upscaler_head = UpscalingHead(
                error_matrix, embed_dim, window_size, 3, 2, mlp_ratio, qkv_bias, fused_blocks, dt, **level, **rates
            )
        self.to_empty(device="cpu")
        init_weights(self, generator)
        self.to(device)
        self.eval()

    def forward(self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """Full W pass (segment_1 -> upscale -> segment_2)."""
        seg, skips_seg = self.segment_1(x, deterministic, generator)
        up, skips_up = self.upscale(x, skips_seg, deterministic, generator)
        seg_hr, _ = self.segment_2(up, skips_up, deterministic, generator)
        return seg, up, seg_hr

    def segment_1(self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """LR segmentation."""
        tokens, padded_res = self.patch_embed(x, scale_factor=1)
        skips = self.segmentator_encoder(tokens, deterministic, generator)
        x_b = self.segmentator_bottleneck(skips[-1], deterministic, generator)
        x_dec = self.segmentator_decoder(x_b, skips, deterministic, generator)
        return self.segmentator_head(x_dec, padded_res), skips

    def upscale(self, x: torch.Tensor, skips_segmentator, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """2x super-resolution conditioned on segmentator skips."""
        result_H, result_W = x.shape[2] * 2, x.shape[3] * 2
        tokens, _ = self.patch_embed(x, scale_factor=1)
        skips_up = list(self.upscaler_encoder(tokens, deterministic, generator))
        skips_up[-2], skips_up[-1] = self.ca_seg_to_sr(
            [skips_up[-2], skips_up[-1]], [skips_segmentator[-2], skips_segmentator[-1]]
        )
        x_b = self.upscaler_bottleneck(skips_up[-1], deterministic, generator)
        x_dec = self.upscaler_decoder(x_b, skips_up, deterministic, generator)
        upscaled = self.upscaler_head(x_dec, deterministic, generator)
        return upscaled[:, :, :result_H, :result_W], skips_up

    def segment_2(self, x: torch.Tensor, skips_upscaler, deterministic: bool = True,
                  generator: Optional[torch.Generator] = None):
        """HR segmentation of the SR output through the shared embedding at
        scale_factor=2."""
        tokens, padded_res = self.patch_embed(x, scale_factor=2)
        skips = list(self.segmentator_encoder(tokens, deterministic, generator))
        skips[-2], skips[-1] = self.ca_sr_to_seg(
            [skips[-2], skips[-1]], [skips_upscaler[-2], skips_upscaler[-1]]
        )
        x_b = self.segmentator_bottleneck(skips[-1], deterministic, generator)
        x_dec = self.segmentator_decoder(x_b, skips, deterministic, generator)
        return self.segmentator_head(x_dec, padded_res, scale_factor=2), skips


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """torch's default initial weights, drawn in module order from
    `generator`: Linear/Conv U(+-1/sqrt(fan_in)) for weight and bias,
    LayerNorm (1, 0), relative-position tables N(0, 0.02), the packed MHA
    in-projection xavier-uniform with zero bias, gamma 0."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Conv2d)):
            fan_in = mod.weight[0].numel()
            bound = 1.0 / math.sqrt(fan_in)
            mod.weight.uniform_(-bound, bound, generator=generator)
            if mod.bias is not None:
                mod.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
        elif isinstance(mod, WindowAttention):
            mod.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)
            mod.relative_position_index.copy_(
                torch.from_numpy(relative_position_index(mod.window_size))
            )
        elif isinstance(mod, _MultiheadAttentionParams):
            out3, dim = mod.in_proj_weight.shape
            bound = math.sqrt(6.0 / (out3 + dim))
            mod.in_proj_weight.uniform_(-bound, bound, generator=generator)
            mod.in_proj_bias.zero_()
        elif isinstance(mod, CrossAttentionBlock):
            mod.gamma.zero_()
