"""The single-tower baselines in PyTorch (port of
`swinwnet_tpu/models/swin_unet.py`; reference: SwinWNet.py:533-592,
691-761): `SwinUNet` segments, `SwinUNetSR` super-resolves 2x.

Both take NCHW images and return NCHW outputs; inside, token grids are
[B, H, W, C] as everywhere in the port. The submodules carry the JAX trees'
names (`patch_embed`, `encoder`, `bottleneck`, `decoder`, `head`), so the
weight bridge maps them both ways, and the constructor contract is
`SwinWNet`'s.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
from torch import nn

from ..core.device import resolve_device, resolve_dtype
from .layers import Bottleneck, ScaleAwarePatchEmbed, SegmentationHead, SwinDecoder, SwinEncoder, UpscalingHead
from .swin_wnet import init_weights


class _SwinTower(nn.Module):
    """The trunk both baselines share: embedding, encoder, bottleneck and
    decoder, built on `device` (default: the CUDA device) with torch-default
    weights drawn from `generator` (None: a generator seeded with 0).
    `fused_blocks`, `fused_deep` and `fused_layout` route the levels, and
    the dropout rates, `remat` and `attn_chunk` act, as in `SwinWNet` (the
    bottleneck without rates)."""

    def __init__(
        self,
        patch_size: int,
        in_chans: int,
        embed_dim: int,
        depths: Sequence[int],
        num_heads: Sequence[int],
        window_size: int,
        mlp_ratio: float,
        qkv_bias: bool,
        fused_blocks: bool,
        dtype: Union[str, torch.dtype],
        device: Optional[Union[str, torch.device]],
        generator: Optional[torch.Generator],
        fused_deep: bool,
        fused_layout: str,
        drop: float,
        attn_drop: float,
        drop_path: float,
        sr_head: bool,
        remat: bool = False,
        attn_chunk: int = 0,
    ):
        super().__init__()
        device = resolve_device(device)
        dt = resolve_dtype(dtype)
        self.patch_size, self.dtype = patch_size, dt
        depths, num_heads = tuple(depths), tuple(num_heads)
        level = dict(fused_deep=fused_deep, fused_layout=fused_layout, remat=remat, attn_chunk=attn_chunk)
        rates = dict(drop=drop, attn_drop=attn_drop, drop_path=drop_path)
        tower = dict(embed_dim=embed_dim, depths=depths, num_heads=num_heads, window_size=window_size,
                     mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, fused_blocks=fused_blocks, dtype=dt, **level, **rates)
        with torch.device("meta"):  # shapes only; weights are drawn below
            self.patch_embed = ScaleAwarePatchEmbed(patch_size, in_chans, embed_dim, dt)
            self.encoder = SwinEncoder(**tower)
            self.bottleneck = Bottleneck(embed_dim * 8, num_heads[-1], window_size, fused_blocks, dt, **level)
            self.decoder = SwinDecoder(**tower)
            if sr_head:
                self.head = UpscalingHead(False, embed_dim, window_size, 3, 2, mlp_ratio, qkv_bias,
                                          fused_blocks, dt, **level, **rates)
            else:
                self.head = SegmentationHead(embed_dim, patch_size, dt)
        self.to_empty(device="cpu")
        init_weights(self, generator)
        self.to(device)
        self.eval()

    def trunk(self, x: torch.Tensor, deterministic: bool = True, generator: Optional[torch.Generator] = None):
        """Embedding to decoder output: ([B, h, w, C] grid, padded (H, W))."""
        tokens, padded_res = self.patch_embed(x, scale_factor=1)
        skips = self.encoder(tokens, deterministic, generator)
        x_b = self.bottleneck(skips[-1], deterministic, generator)
        return self.decoder(x_b, skips, deterministic, generator), padded_res


class SwinUNet(_SwinTower):
    """Segmentation tower: embed -> encoder -> bottleneck -> decoder -> seg
    head; [B, in_chans, H, W] -> [B, 1, H, W] fp32 logits. Weights checkpoint:
    models/SwinUnet_binary_segmentation_diffraction.pth (BASELINE config #1)."""

    def __init__(
        self,
        patch_size: int = 2,
        in_chans: int = 1,
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
        super().__init__(patch_size, in_chans, embed_dim, depths, num_heads, window_size, mlp_ratio, qkv_bias,
                         fused_blocks, dtype, device, generator, fused_deep, fused_layout, drop, attn_drop,
                         drop_path, sr_head=False, remat=remat, attn_chunk=attn_chunk)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x_dec, padded_res = self.trunk(x, deterministic, generator)
        return self.head(x_dec, padded_res)


class SwinUNetSR(_SwinTower):
    """SR tower: the same trunk and an UpscalingHead with one output channel;
    [B, in_chans, H, W] -> [B, 1, 2H, 2W], cropped (reference:
    SwinWNet.py:740-761). Weights checkpoint:
    models/SwinUnetSR_upscaler_for_segmented_diffraction.pth (BASELINE #2)."""

    def __init__(
        self,
        patch_size: int = 2,
        in_chans: int = 1,
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
        super().__init__(patch_size, in_chans, embed_dim, depths, num_heads, window_size, mlp_ratio, qkv_bias,
                         fused_blocks, dtype, device, generator, fused_deep, fused_layout, drop, attn_drop,
                         drop_path, sr_head=True, remat=remat, attn_chunk=attn_chunk)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        result_H, result_W = x.shape[2] * 2, x.shape[3] * 2
        x_dec, _ = self.trunk(x, deterministic, generator)
        return self.head(x_dec, deterministic, generator)[:, :, :result_H, :result_W]
