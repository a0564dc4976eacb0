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
* Dropout (`drop`, `attn_drop`, `drop_path`) acts only in a forward called
  with `deterministic=False`, as in the JAX package, whatever `train()` or
  `eval()` says; it draws from the `generator` the caller passes. The
  default `deterministic=True`, which every trainer, pipeline and app
  takes, computes the same as rates of 0 (the published recipe's).
  `drop_path` is element-wise dropout on each residual branch, the JAX
  package's simplification, not per-sample stochastic depth.
* A level with `shift_size > 0` runs every block on the grid: LN1, a
  cyclic roll, windows with the SW-MSA mask (`ops.window.compute_mask`) on
  the scores, the roll back. The shipped checkpoints never shift.
* `remat` recomputes each unfused block's activations in the backward
  (`torch.utils.checkpoint`); `attn_chunk` runs the unfused attention over
  that many windows at a time, bounding the live score tensor.
* `BasicLayer` sends a whole level to a fused block kernel
  (`ops/swin_block.py`, through its differentiable entry point) with the
  JAX package's gate: at least 128 windows; C <= 96 in bf16 or C <= 48 in
  fp32 goes to `fused_layout` ("cmajor", or "nmajor" where the grid tiles);
  wider levels up to C = 384 go to the row-major kernel when `fused_deep`.
  `fused_deep` and `fused_layout` stand for the JAX package's
  SWINWNET_FUSED_DEEP and SWINWNET_FUSED_LAYOUT environment variables. A
  shifted level, or a forward with `deterministic=False`, never fuses.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.device import full_fp32
from ..ops.conv import conv2d as det_conv2d
from ..ops.expand_norm import patch_expand_norm, patch_expand_norm_plain
from ..ops.resize import bilinear_resize
from ..ops.swin_block import fused_block_autodiff, kernel_plan
from ..ops.window_attention import takes as window_attention_takes, window_attention, window_attention_plain
from ..ops.window import (
    compute_mask,
    relative_position_index,
    window_pad_mask_np,
    window_partition,
    window_partition_nmajor,
    window_reverse,
    window_reverse_nmajor,
)
from ..utils.profiling import Counter


# What the levels launch, counted where it happens (and kept right under
# graph replay, `core.graphs`): `layer_norm`'s LayerNorms, and the casts
# that convert, of parameters (`linear`, `conv2d`, the fused blocks' and the
# cross-attention's weights) apart from those of activations (`linear`,
# `conv2d`, `layer_norm`, a fused block's input).
LAYER_NORMS = Counter("layer_norm")
WEIGHT_CASTS = Counter("weight_cast")
ACTIVATION_CASTS = Counter("activation_cast")


def _cast(t: torch.Tensor, dtype: torch.dtype, counter: Counter) -> torch.Tensor:
    """`t` in `dtype`; a cast that converts counts in `counter`."""
    if t.dtype == dtype:
        return t
    counter.launches += 1
    return t.to(dtype)


def linear(x: torch.Tensor, lin: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """nn.Linear with operands, product and bias in the compute dtype (fp32
    at full fp32)."""
    bias = None if lin.bias is None else _cast(lin.bias, dtype, WEIGHT_CASTS)
    with full_fp32(dtype):
        return F.linear(_cast(x, dtype, ACTIVATION_CASTS), _cast(lin.weight, dtype, WEIGHT_CASTS), bias)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm with fp32 statistics (eps 1e-5), output in the compute dtype."""
    LAYER_NORMS.launches += 1
    y = F.layer_norm(_cast(x, torch.float32, ACTIVATION_CASTS), ln.normalized_shape, ln.weight, ln.bias, 1e-5)
    return _cast(y, dtype, ACTIVATION_CASTS)


def conv2d(x: torch.Tensor, conv: nn.Conv2d, dtype: torch.dtype, **kw) -> torch.Tensor:
    """A cuDNN convolution in the compute dtype (fp32 at full fp32), its
    backward deterministic (`ops.conv`)."""
    with full_fp32(dtype):
        return det_conv2d(_cast(x, dtype, ACTIVATION_CASTS), _cast(conv.weight, dtype, WEIGHT_CASTS),
                          _cast(conv.bias, dtype, WEIGHT_CASTS), **kw)


def _refuse_capture(what: str) -> None:
    """A CUDA graph would replay the random draws it captured on every
    call: a forward that draws dropout is not captured."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} draws random numbers, which a CUDA graph would replay unchanged: run a "
                           "forward with deterministic=False eagerly (core.graphs.run_eagerly), not captured")


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's `nn.Dropout`: unless `deterministic` or `rate` is 0, keep each
    element where a uniform draw from `generator` (on x's device; None:
    the default generator) is below 1 - rate and scale it by 1 / (1 - rate);
    rate 1 gives zeros."""
    if deterministic or rate == 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    _refuse_capture("dropout")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


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
# Window attention and the Swin block
# ---------------------------------------------------------------------------


class WindowAttention(nn.Module):
    """MSA within 5x5 windows with a learned relative-position bias. Input
    [num_windows, N, C], and for shifted windows an additive mask [nW, N, N];
    scores, softmax and P.V in fp32 from operands in the compute dtype.
    `attn_drop` drops attention probabilities and `proj_drop` the output
    projection. `attn_chunk` > 0 computes the attention over that many
    windows at a time where JAX's `chunkable` holds (no mask, no active
    attention dropout, more windows than a chunk); the last chunk is ragged,
    since nothing here needs the static shapes JAX pads for. Where
    `kernel_route` holds (bf16 serving on the card), the attention is one
    launch of `ops.window_attention` a call, which makes no score tensor
    and so takes no chunks."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool, dtype: torch.dtype,
                 attn_drop: float = 0.0, proj_drop: float = 0.0, attn_chunk: int = 0):
        super().__init__()
        self.dim, self.window_size, self.num_heads, self.dtype = dim, window_size, num_heads, dtype
        self.attn_drop, self.proj_drop, self.attn_chunk = attn_drop, proj_drop, attn_chunk
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

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        Bw = x.shape[0]
        bias = self.rel_bias()
        K = self.attn_chunk
        if self.kernel_route(x, mask, deterministic):
            out = window_attention(linear(x, self.qkv, self.dtype), bias, self.num_heads, self.dtype)
        elif K > 0 and mask is None and (self.attn_drop == 0.0 or deterministic) and Bw > K:
            out = torch.cat([self._attend(c, bias, None, True, None) for c in x.split(K)])
        else:
            out = self._attend(x, bias, mask, deterministic, generator)
        return dropout(linear(out, self.proj, self.dtype), self.proj_drop, deterministic, generator)

    def kernel_route(self, x: torch.Tensor, mask: Optional[torch.Tensor], deterministic: bool) -> bool:
        """Whether the attention of windows x [Bw, N, C] goes to the kernel:
        x off the CPU, bf16, under `torch.inference_mode` (the serving
        programs; training, the RL and stage-2 steps' `no_grad` parts and the
        trainers' evals keep `_attend`), no mask, no attention dropout drawn,
        and a shape the kernel takes (head width 16 or 32, N <= 32)."""
        return (x.device.type != "cpu" and self.dtype == torch.bfloat16 and torch.is_inference_mode_enabled()
                and mask is None and (self.attn_drop == 0.0 or deterministic)
                and window_attention_takes(x.shape[2], self.num_heads, x.shape[1]))

    def _attend(self, x, bias, mask, deterministic, generator) -> torch.Tensor:
        """[k, N, C] windows -> the heads' outputs [k, N, C], before the
        output projection."""
        drop = lambda attn: dropout(attn, self.attn_drop, deterministic, generator)
        return window_attention_plain(linear(x, self.qkv, self.dtype), bias, self.num_heads, self.dtype, mask, drop)


@functools.lru_cache(maxsize=16)
def _shift_mask_tensor(H: int, W: int, ws: int, shift: int, device: str) -> torch.Tensor:
    """`compute_mask` on `device`, kept for later calls (see `_pad_mask_tensor`)."""
    with torch.inference_mode(False):
        return compute_mask(H, W, ws, shift, device)


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
    """Pre-LN W-MSA / SW-MSA block in one of two layouts, as the JAX
    package's:

    * window tokens [B*nW, N, C] (shift 0 only): pad token slots are zeroed
      after LN1 with `pad_mask` [nW, N, 1], which makes the windowed layout
      equal to the reference's per-block pad-after-norm;
    * a grid [B, H, W, C] (any shift): LN1, roll by -shift on the grid,
      partition (zero-padding after the LN), attention with the SW-MSA mask,
      reverse, roll by +shift on the padded grid, crop to (H, W).

    `drop` is the MLP's dropout and the attention's output dropout,
    `attn_drop` the attention probabilities', `drop_path` each residual
    branch's (element-wise); all act only when `deterministic` is False."""

    def __init__(self, dim: int, num_heads: int, window_size: int, mlp_ratio: float,
                 qkv_bias: bool, dtype: torch.dtype, shift_size: int = 0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0, attn_chunk: int = 0):
        super().__init__()
        self.dim, self.num_heads, self.dtype = dim, num_heads, dtype
        self.window_size, self.shift_size = window_size, shift_size
        self.drop, self.drop_path = drop, drop_path
        hidden = int(dim * mlp_ratio)
        self.norm1 = nn.LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, qkv_bias, dtype, attn_drop, drop, attn_chunk)
        self.norm2 = nn.LayerNorm(dim)
        # indices 0 and 3 are the upstream checkpoint's fc1 / fc2; forward
        # applies the dropout of slots 2 and 4 itself, from its generator
        self.mlp = nn.Sequential(
            nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0), nn.Linear(hidden, dim), nn.Dropout(0.0)
        )

    def forward(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor] = None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        if x.dim() == 4:
            y = self._attend_grid(x, deterministic, generator)
        else:
            if self.shift_size:
                raise ValueError("a shifted block takes a [B, H, W, C] grid, not window tokens")
            y = layer_norm(x, self.norm1, dt)
            if pad_mask is not None:  # [nW, N, 1]
                nW = pad_mask.shape[0]
                y = (y.reshape(-1, nW, *y.shape[1:]) * pad_mask.to(dt)).reshape(y.shape)
            y = self.attn(y, None, deterministic, generator)
        x = x + dropout(y, self.drop_path, deterministic, generator)
        y = layer_norm(x, self.norm2, dt)
        y = dropout(F.gelu(linear(y, self.mlp[0], dt)), self.drop, deterministic, generator)
        y = dropout(linear(y, self.mlp[3], dt), self.drop, deterministic, generator)
        return x + dropout(y, self.drop_path, deterministic, generator)

    def _attend_grid(self, x: torch.Tensor, deterministic: bool,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """The attention branch on a [B, H, W, C] grid."""
        B, H, W, C = x.shape
        ws, s = self.window_size, self.shift_size
        y = layer_norm(x, self.norm1, self.dtype)
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s), (1, 2))
            mask = _shift_mask_tensor(H, W, ws, s, str(x.device))
        yw, (Hp, Wp) = window_partition(y, ws)
        y = window_reverse(self.attn(yw, mask, deterministic, generator), ws, Hp, Wp)
        if s > 0:
            y = torch.roll(y, (s, s), (1, 2))
        return y[:, :H, :W]

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
        in_out = lambda lin: _cast(lin.weight, dt, WEIGHT_CASTS).t()
        out_in = (lambda lin: _cast(lin.weight, dt, WEIGHT_CASTS)) if layout == "cmajor" else in_out
        return fused_block_autodiff(
            layout, self.num_heads, _cast(x, dt, ACTIVATION_CASTS), pad_mask,
            self.norm1.weight, self.norm1.bias,
            out_in(self.attn.qkv), qkv_b,
            self.attn.rel_bias(),
            in_out(self.attn.proj), self.attn.proj.bias,
            self.norm2.weight, self.norm2.bias,
            out_in(self.mlp[0]), self.mlp[0].bias,
            out_in(self.mlp[3]), self.mlp[3].bias,
        )


def _block_seed(generator: Optional[torch.Generator]) -> int:
    """A seed for one block's dropout, drawn from `generator` (None: the
    default CPU generator)."""
    _refuse_capture("a block's dropout")
    dev = "cpu" if generator is None else generator.device
    return int(torch.randint(0, 2 ** 62, (), generator=generator, device=dev))


def _run_block(blk: SwinTransformerBlock, x: torch.Tensor, pad_mask: Optional[torch.Tensor],
               deterministic: bool, seed: Optional[int]) -> torch.Tensor:
    """One block, its dropout drawn from a generator on x's device seeded
    here with `seed`. `checkpoint` restores only the default generators, so
    a block under remat builds its own from the seed: the recompute in the
    backward then draws the forward's masks."""
    gen = None if seed is None else torch.Generator(device=x.device).manual_seed(seed)
    return blk(x, pad_mask, deterministic, gen)


class BasicLayer(nn.Module):
    """`depth` Swin blocks, each shifted by `shift_size` (the same for every
    block, as in the JAX package). At shift 0 the grid is partitioned into
    windows once, every block runs on window tokens, and the windows are
    reversed once; a shifted level runs every block on the grid and is
    never fused. `fused_deep` and `fused_layout` are the JAX package's
    SWINWNET_FUSED_DEEP=1 and SWINWNET_FUSED_LAYOUT. `drop`, `attn_drop`
    and `drop_path` are the blocks' dropout rates (see
    SwinTransformerBlock); `remat` checkpoints each unfused block, and
    `attn_chunk` chunks the unfused attention (see WindowAttention)."""

    # the JAX gate's least window count for a fused level (it lifts the rule
    # under its interpret switch; the CPU tests lower this attribute instead)
    min_windows = 128

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int = 5,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True, fused_blocks: bool = False,
                 dtype: torch.dtype = torch.float32, fused_deep: bool = False,
                 fused_layout: str = "cmajor", shift_size: int = 0, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0, remat: bool = False,
                 attn_chunk: int = 0):
        super().__init__()
        if fused_layout not in ("cmajor", "nmajor"):
            raise ValueError(f"fused_layout must be 'cmajor' or 'nmajor', got {fused_layout!r}")
        self.dim, self.window_size, self.fused_blocks, self.dtype = dim, window_size, fused_blocks, dtype
        self.fused_deep, self.fused_layout = fused_deep, fused_layout
        self.shift_size, self.remat = shift_size, remat
        self.has_dropout = max(drop, attn_drop, drop_path) > 0.0
        self.blocks = nn.ModuleList(
            SwinTransformerBlock(dim, num_heads, window_size, mlp_ratio, qkv_bias, dtype, shift_size,
                                 drop, attn_drop, drop_path, attn_chunk)
            for _ in range(depth)
        )

    def fused_route(self, B: int, H: int, W: int, deterministic: bool = True) -> str:
        """The JAX package's fused-kernel gate (its TPU-backend test aside):
        the layout of the kernel this level goes to, or "" for the unfused
        blocks. Only a deterministic forward of a level at shift 0 fuses.
        At least 128 windows; C <= 96 in bf16 (48 in fp32) goes to
        `fused_layout`, where "nmajor" has no pad mask and falls back on a
        grid that does not tile; wider levels up to C = 384 go to
        "rowmajor" when `fused_deep`. A level the kernel has no plan for
        (`kernel_plan` raises, as at a head width that is not a multiple of
        4) stays on the unfused blocks, which compute the same block."""
        ws = self.window_size
        cap = 96 if self.dtype == torch.bfloat16 else 48
        n_windows = B * (-(-H // ws)) * (-(-W // ws))
        if not (self.fused_blocks and deterministic and self.shift_size == 0 and n_windows >= self.min_windows):
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

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, H, W, C = x.shape
        ws = self.window_size
        if self.shift_size > 0:  # each block partitions, rolls and masks the grid itself
            return self._run_blocks(x, None, deterministic, generator)
        dev = str(x.device)
        route = self.fused_route(B, H, W, deterministic)
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
            xw = self._run_blocks(xw, mask, deterministic, generator)
        x = window_reverse(xw, ws, Hp, Wp)
        return x[:, :H, :W, :] if (Hp, Wp) != (H, W) else x

    def _run_blocks(self, x: torch.Tensor, pad_mask: Optional[torch.Tensor], deterministic: bool,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
        """The unfused blocks, each checkpointed under `remat` when autograd
        records; a block that drops gets its own seed from `generator`. Its
        dropout draws only from that block's own generator, so `checkpoint`
        has no default generator's state to keep: it reads none, which a
        CUDA-graph capture would refuse."""
        draws = not deterministic and self.has_dropout
        remat = self.remat and torch.is_grad_enabled()
        for blk in self.blocks:
            seed = _block_seed(generator) if draws else None
            if remat:
                x = checkpoint(_run_block, blk, x, pad_mask, deterministic, seed, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = _run_block(blk, x, pad_mask, deterministic, seed)
        return x


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
    """2x upsample: Linear(C -> 2C, no bias) -> pixel shuffle -> LN(C/2).
    Under `torch.inference_mode` (the serving programs) the shuffle and the
    LayerNorm go to `ops.expand_norm.patch_expand_norm`, one kernel on the
    card; everywhere else (training, the RL and stage-2 steps' `no_grad`
    parts, the trainers' evals) the shuffle's copy and `layer_norm`."""

    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = linear(x, self.expand, self.dtype)
        if torch.is_inference_mode_enabled():
            return patch_expand_norm(x, self.norm, self.dtype)
        return patch_expand_norm_plain(x, self.norm, self.dtype)


# ---------------------------------------------------------------------------
# Encoder / bottleneck / decoder
# ---------------------------------------------------------------------------


class SwinEncoder(nn.Module):
    """(BasicLayer -> skip -> PatchMerging) per stage, then a last BasicLayer.
    Returns the skip grids; the last is the deepest feature map. `drop`,
    `attn_drop`, `drop_path`, `remat` and `attn_chunk` go to every level."""

    def __init__(self, embed_dim: int, depths: Sequence[int], num_heads: Sequence[int],
                 window_size: int, mlp_ratio: float, qkv_bias: bool, fused_blocks: bool,
                 dtype: torch.dtype, fused_deep: bool = False, fused_layout: str = "cmajor",
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 remat: bool = False, attn_chunk: int = 0):
        super().__init__()
        n = len(depths)
        dims = [embed_dim * 2 ** i for i in range(n)]
        self.layers = nn.ModuleList(
            BasicLayer(dims[i], depths[i], num_heads[i], window_size, mlp_ratio, qkv_bias,
                       fused_blocks, dtype, fused_deep, fused_layout, drop=drop, attn_drop=attn_drop,
                       drop_path=drop_path, remat=remat, attn_chunk=attn_chunk)
            for i in range(n)
        )
        self.downs = nn.ModuleList(PatchMerging(dims[i], dtype) for i in range(n - 1))

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        skips = []
        for i, layer in enumerate(self.layers):
            x = layer(x, deterministic, generator)
            skips.append(x)
            if i < len(self.downs):
                x = self.downs[i](x)
        return skips


class Bottleneck(nn.Module):
    """Depth-2 BasicLayer at 8C (default MLP ratio and qkv bias, as the
    reference). The models build it with `remat` and `attn_chunk` but no
    dropout rates, as the JAX models do."""

    def __init__(self, dim: int, num_heads: int, window_size: int, fused_blocks: bool,
                 dtype: torch.dtype, fused_deep: bool = False, fused_layout: str = "cmajor",
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 remat: bool = False, attn_chunk: int = 0):
        super().__init__()
        self.layer = BasicLayer(dim, 2, num_heads, window_size, fused_blocks=fused_blocks, dtype=dtype,
                                fused_deep=fused_deep, fused_layout=fused_layout, drop=drop,
                                attn_drop=attn_drop, drop_path=drop_path, remat=remat, attn_chunk=attn_chunk)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.layer(x, deterministic, generator)


class SwinDecoder(nn.Module):
    """Per stage: PatchExpanding -> crop to the skip -> concat -> BasicLayer ->
    Linear(2C -> C). Depths and heads are the encoder's reversed, without
    the deepest."""

    def __init__(self, embed_dim: int, depths: Sequence[int], num_heads: Sequence[int],
                 window_size: int, mlp_ratio: float, qkv_bias: bool, fused_blocks: bool,
                 dtype: torch.dtype, fused_deep: bool = False, fused_layout: str = "cmajor",
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 remat: bool = False, attn_chunk: int = 0):
        super().__init__()
        self.dtype = dtype
        dec_depths, dec_heads = tuple(depths[-2::-1]), tuple(num_heads[-2::-1])
        dims = [embed_dim * 8 // 2 ** i for i in range(len(depths) - 1)]
        self.ups = nn.ModuleList(PatchExpanding(d, dtype) for d in dims)
        self.swin_blocks = nn.ModuleList(
            BasicLayer(d, dec_depths[i], dec_heads[i], window_size, mlp_ratio, qkv_bias,
                       fused_blocks, dtype, fused_deep, fused_layout, drop=drop, attn_drop=attn_drop,
                       drop_path=drop_path, remat=remat, attn_chunk=attn_chunk)
            for i, d in enumerate(dims)
        )
        self.linears = nn.ModuleList(nn.Linear(d, d // 2) for d in dims)

    def forward(self, x: torch.Tensor, skips: Sequence[torch.Tensor], deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        skips = list(skips)[-2::-1]
        for i, skip in enumerate(skips):
            x = self.ups[i](x)
            th, tw = skip.shape[1], skip.shape[2]
            x = x[:, :th, :tw, :]
            # a skip that went through the cross-attention is fp32: promote
            dt = torch.promote_types(x.dtype, skip.dtype)
            x = torch.cat([x.to(dt), skip.to(dt)], dim=-1)
            x = self.swin_blocks[i](x, deterministic, generator)
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
                 dtype: torch.dtype, fused_deep: bool = False, fused_layout: str = "cmajor",
                 drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
                 remat: bool = False, attn_chunk: int = 0):
        super().__init__()
        self.dtype = dtype
        dims = [embed_dim, embed_dim // 2]
        self.ups = nn.ModuleList(PatchExpanding(d, dtype) for d in dims)
        self.swin_blocks = nn.ModuleList(
            BasicLayer(d // 2, depth, num_heads, window_size, mlp_ratio, qkv_bias, fused_blocks, dtype,
                       fused_deep, fused_layout, drop=drop, attn_drop=attn_drop, drop_path=drop_path,
                       remat=remat, attn_chunk=attn_chunk)
            for d in dims
        )
        c = embed_dim // 4
        self.reconstruction = nn.Sequential(
            nn.Conv2d(c, c, 3, padding=1), nn.GELU(), nn.Conv2d(c, 2 if error_matrix else 1, 1)
        )

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for up, layer in zip(self.ups, self.swin_blocks):
            x = layer(up(x), deterministic, generator)
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
            qp = F.linear(qn, _cast(w[:C], dt, WEIGHT_CASTS)).float() + b[:C]
            kp = F.linear(kvn, _cast(w[C:2 * C], dt, WEIGHT_CASTS)).float() + b[C:2 * C]
            vp = F.linear(kvn, _cast(w[2 * C:], dt, WEIGHT_CASTS)).float() + b[2 * C:]
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
