"""The plain reference: SwinWNet and SwinUNet in float32 PyTorch, their
inference pipelines, the stage-3 losses and AdamW.

Written from the published architecture (upstream `SwinWNet.py`: Swin-UNet
towers of pre-LN window-attention blocks with a learned relative-position
bias, patch merging and expanding, a scale-aware patch embedding shared by
the LR image and the 2x output, gamma-gated cross-attention between the
towers at the two deepest skips). It imports nothing of the program under
test. The modules carry the program's state-dict names, so one state dict
drawn by the benchmark loads into both.

Every product goes through a `Products` object: float32 with TF32 off (the
reference), or with each operand rounded to float8 under a per-tensor scale
(the control: the reference computed one precision below the bfloat16 that
the configurations state; gradients round to e5m2 in the backward).
"""

from __future__ import annotations

import importlib
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

EPS_LN = 1e-5


def no_tf32() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _round_scaled(x: torch.Tensor, dtype: torch.dtype, fmax: float) -> torch.Tensor:
    """x rounded to `dtype` under one scale that maps its largest magnitude to
    `fmax`, returned in x's dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = fmax / amax
    return ((x * scale).to(dtype).to(x.dtype)) / scale


class _Fp8(torch.autograd.Function):
    """e4m3 on the way forward, e5m2 on the gradient, as fp8 training does."""

    @staticmethod
    def forward(ctx, x):
        return _round_scaled(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round_scaled(g, torch.float8_e5m2, 57344.0)


class Products:
    """The reference's products: float32, or (`fp8=True`) float8 operands
    with float32 accumulation."""

    def __init__(self, fp8: bool = False):
        self.fp8 = fp8

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8.apply(x) if self.fp8 else x

    def linear(self, x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
        return F.linear(self.q(x), self.q(lin.weight), lin.bias)

    def conv(self, x: torch.Tensor, conv: nn.Conv2d, **kw) -> torch.Tensor:
        return F.conv2d(self.q(x), self.q(conv.weight), conv.bias, **kw)

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, EPS_LN)


def rel_index(ws: int) -> torch.Tensor:
    """[N, N] index of each query-key offset into the (2ws-1)^2 bias table."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (ws - 1)
    return rel[..., 0] * (2 * ws - 1) + rel[..., 1]


class Attention(nn.Module):
    """Window multi-head self-attention with a relative-position bias."""

    def __init__(self, dim: int, ws: int, heads: int, prod: Products):
        super().__init__()
        self.heads, self.ws, self.prod = heads, ws, prod
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.empty((2 * ws - 1) ** 2, heads))
        self.register_buffer("index", rel_index(ws), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [Bw, N, C]
        Bw, N, C = x.shape
        h = self.heads
        qkv = self.prod.linear(x, self.qkv).reshape(Bw, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (C // h) ** -0.5, qkv[1], qkv[2]
        bias = self.relative_position_bias_table[self.index.reshape(-1)].reshape(N, N, h).permute(2, 0, 1)
        attn = torch.softmax(self.prod.matmul(q, k.transpose(-1, -2)) + bias, dim=-1)
        out = self.prod.matmul(attn, v).transpose(1, 2).reshape(Bw, N, C)
        return self.prod.linear(out, self.proj)


class Block(nn.Module):
    """Pre-LN Swin block, no shift: the attention branch pads the normed grid
    with zeros to whole windows, as the published model does."""

    def __init__(self, dim: int, heads: int, ws: int, mlp_ratio: float, prod: Products):
        super().__init__()
        self.ws, self.prod = ws, prod
        self.norm1 = nn.LayerNorm(dim)
        self.attn = Attention(dim, ws, heads, prod)
        self.norm2 = nn.LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(nn.Linear(dim, hidden), nn.GELU(), nn.Dropout(0.0), nn.Linear(hidden, dim),
                                 nn.Dropout(0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, H, W, C]
        B, H, W, C = x.shape
        ws = self.ws
        y = _ln(x, self.norm1)
        ph, pw = (-H) % ws, (-W) % ws
        y = F.pad(y, (0, 0, 0, pw, 0, ph))
        Hp, Wp = H + ph, W + pw
        y = y.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
        y = self.attn(y)
        y = y.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
        x = x + y[:, :H, :W]
        y = F.gelu(self.prod.linear(_ln(x, self.norm2), self.mlp[0]))
        return x + self.prod.linear(y, self.mlp[3])


class Level(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, ws: int, mlp_ratio: float, prod: Products):
        super().__init__()
        self.blocks = nn.ModuleList(Block(dim, heads, ws, mlp_ratio, prod) for _ in range(depth))

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return x


class Merge(nn.Module):
    """2x2 neighbours concatenated (zero-padded to even), LN, 4C -> 2C."""

    def __init__(self, dim: int, prod: Products):
        super().__init__()
        self.prod = prod
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        H, W = x.shape[1], x.shape[2]
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.prod.linear(_ln(x, self.norm), self.reduction)


class Expand(nn.Module):
    """C -> 2C, each token to a 2x2 patch of C/2, LN."""

    def __init__(self, dim: int, prod: Products):
        super().__init__()
        self.prod = prod
        self.expand = nn.Linear(dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(dim // 2)

    def forward(self, x):
        B, H, W, C = x.shape
        x = self.prod.linear(x, self.expand).reshape(B, H, W, 2, 2, C // 2)
        return _ln(x.permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, C // 2), self.norm)


class Embed(nn.Module):
    """Patch embedding: at scale s a p x p convolution with stride p*s and
    dilation s over the image zero-padded to multiples of p*s, then LN."""

    def __init__(self, p: int, cin: int, dim: int, prod: Products):
        super().__init__()
        self.p, self.prod = p, prod
        self.proj = nn.Conv2d(cin, dim, p, stride=p)
        self.norm = nn.LayerNorm(dim)

    def forward(self, x, s: int = 1):
        H, W = x.shape[2], x.shape[3]
        m = self.p * s
        x = F.pad(x, (0, (-W) % m, 0, (-H) % m))
        y = self.prod.conv(x, self.proj, stride=m, dilation=s)
        return _ln(y.permute(0, 2, 3, 1), self.norm), (H + (-H) % m, W + (-W) % m)


class Encoder(nn.Module):
    def __init__(self, C, depths, heads, ws, mlp, prod):
        super().__init__()
        n = len(depths)
        self.layers = nn.ModuleList(Level(C * 2 ** i, depths[i], heads[i], ws, mlp, prod) for i in range(n))
        self.downs = nn.ModuleList(Merge(C * 2 ** i, prod) for i in range(n - 1))

    def forward(self, x) -> List[torch.Tensor]:
        skips = []
        for i, layer in enumerate(self.layers):
            x = layer(x)
            skips.append(x)
            if i < len(self.downs):
                x = self.downs[i](x)
        return skips


class Bottleneck(nn.Module):
    def __init__(self, dim, heads, ws, prod):
        super().__init__()
        self.layer = Level(dim, 2, heads, ws, 4.0, prod)

    def forward(self, x):
        return self.layer(x)


class Decoder(nn.Module):
    """Per stage: expand, crop to the skip, concat, a level, 2C -> C."""

    def __init__(self, C, depths, heads, ws, mlp, prod):
        super().__init__()
        self.prod = prod
        dims = [C * 8 // 2 ** i for i in range(len(depths) - 1)]
        d_depths, d_heads = depths[-2::-1], heads[-2::-1]
        self.ups = nn.ModuleList(Expand(d, prod) for d in dims)
        self.swin_blocks = nn.ModuleList(Level(d, d_depths[i], d_heads[i], ws, mlp, prod) for i, d in enumerate(dims))
        self.linears = nn.ModuleList(nn.Linear(d, d // 2) for d in dims)

    def forward(self, x, skips):
        for i, skip in enumerate(list(skips)[-2::-1]):
            x = self.ups[i](x)[:, :skip.shape[1], :skip.shape[2]]
            x = self.swin_blocks[i](torch.cat([x, skip], dim=-1))
            x = self.prod.linear(x, self.linears[i])
        return x


class SegHead(nn.Module):
    """conv3x3, GELU, conv1x1 to one logit, bilinear up by p*s
    (align_corners=False), crop to the padded input."""

    def __init__(self, C, p, prod):
        super().__init__()
        self.p, self.prod = p, prod
        self.seg_head = nn.Sequential(nn.Conv2d(C, C // 2, 3, padding=1), nn.GELU(), nn.Conv2d(C // 2, 1, 1))

    def forward(self, x, padded, s: int = 1):
        x = x.permute(0, 3, 1, 2)
        x = self.prod.conv(F.gelu(self.prod.conv(x, self.seg_head[0], padding=1)), self.seg_head[2])
        up = self.p * s
        x = F.interpolate(x, size=(x.shape[2] * up, x.shape[3] * up), mode="bilinear", align_corners=False)
        return x[:, :, :padded[0], :padded[1]]


class UpHead(nn.Module):
    """Twice (expand, a depth-2 level), conv3x3, GELU, conv1x1."""

    def __init__(self, error_matrix, C, ws, heads, depth, mlp, prod):
        super().__init__()
        self.prod = prod
        dims = [C, C // 2]
        self.ups = nn.ModuleList(Expand(d, prod) for d in dims)
        self.swin_blocks = nn.ModuleList(Level(d // 2, depth, heads, ws, mlp, prod) for d in dims)
        c = C // 4
        self.reconstruction = nn.Sequential(nn.Conv2d(c, c, 3, padding=1), nn.GELU(),
                                            nn.Conv2d(c, 2 if error_matrix else 1, 1))

    def forward(self, x):
        for up, layer in zip(self.ups, self.swin_blocks):
            x = layer(up(x))
        x = self.prod.conv(x.permute(0, 3, 1, 2), self.reconstruction[0], padding=1)
        return self.prod.conv(F.gelu(x), self.reconstruction[2])


class _MHA(nn.Module):
    """nn.MultiheadAttention's parameters under its names."""

    def __init__(self, dim):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)


class CrossBlock(nn.Module):
    """q + gamma * MHA(LN(q), LN(kv)) over the whole skip grid."""

    def __init__(self, dim, heads, prod):
        super().__init__()
        self.heads, self.prod = heads, prod
        self.norm_q = nn.LayerNorm(dim)
        self.norm_kv = nn.LayerNorm(dim)
        self.attn = _MHA(dim)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, q, kv):  # [B, L, C]
        B, Lq, C = q.shape
        h, P = self.heads, self.prod
        w, b = self.attn.in_proj_weight, self.attn.in_proj_bias
        qn, kvn = _ln(q, self.norm_q), _ln(kv, self.norm_kv)
        qp = P.matmul(qn, w[:C].t()) + b[:C]
        kp = P.matmul(kvn, w[C:2 * C].t()) + b[C:2 * C]
        vp = P.matmul(kvn, w[2 * C:].t()) + b[2 * C:]
        split = lambda t: t.reshape(B, -1, h, C // h).transpose(1, 2)
        attn = torch.softmax(P.matmul(split(qp) * (C // h) ** -0.5, split(kp).transpose(-1, -2)), dim=-1)
        out = P.matmul(attn, split(vp)).transpose(1, 2).reshape(B, Lq, C)
        return q + self.gamma * P.linear(out, self.attn.out_proj)


class MultiCross(nn.Module):
    def __init__(self, dims, heads, prod):
        super().__init__()
        self.blocks = nn.ModuleList(CrossBlock(d, h, prod) for d, h in zip(dims, heads))

    def forward(self, targets, sources):
        out = []
        for blk, t, s in zip(self.blocks, targets, sources):
            B, H, W, C = t.shape
            out.append(blk(t.reshape(B, H * W, C), s.reshape(B, -1, s.shape[-1])).reshape(B, H, W, C))
        return out


def _arch(cfg: dict) -> Tuple:
    return (cfg["patch_size"], cfg["embed_dim"], tuple(cfg["depths"]), tuple(cfg["num_heads"]),
            cfg["window_size"], cfg["mlp_ratio"])


class RefSwinWNet(nn.Module):
    """The multimodal SwinWNet: segmentator and upscaler towers, one
    embedding, cross-attention at the two deepest skips (dims 4C, 8C; 3
    heads each)."""

    def __init__(self, cfg: dict, prod: Optional[Products] = None):
        super().__init__()
        prod = prod or Products()
        p, C, depths, heads, ws, mlp = _arch(cfg)
        cin = cfg["in_chans"] + (1 if cfg["error_matrix"] else 0)
        self.p = p
        self.patch_embed = Embed(p, cin, C, prod)
        self.segmentator_encoder = Encoder(C, depths, heads, ws, mlp, prod)
        self.segmentator_bottleneck = Bottleneck(C * 8, heads[-1], ws, prod)
        self.segmentator_decoder = Decoder(C, depths, heads, ws, mlp, prod)
        self.segmentator_head = SegHead(C, p, prod)
        self.ca_seg_to_sr = MultiCross((4 * C, 8 * C), (3, 3), prod)
        self.ca_sr_to_seg = MultiCross((4 * C, 8 * C), (3, 3), prod)
        self.upscaler_encoder = Encoder(C, depths, heads, ws, mlp, prod)
        self.upscaler_bottleneck = Bottleneck(C * 8, heads[-1], ws, prod)
        self.upscaler_decoder = Decoder(C, depths, heads, ws, mlp, prod)
        self.upscaler_head = UpHead(cfg["error_matrix"], C, ws, 3, 2, mlp, prod)

    def segment_1(self, x):
        t, padded = self.patch_embed(x, 1)
        skips = self.segmentator_encoder(t)
        y = self.segmentator_decoder(self.segmentator_bottleneck(skips[-1]), skips)
        return self.segmentator_head(y, padded), skips

    def upscale(self, x, skips_seg):
        t, _ = self.patch_embed(x, 1)
        skips = self.upscaler_encoder(t)
        skips[-2], skips[-1] = self.ca_seg_to_sr(skips[-2:], skips_seg[-2:])
        y = self.upscaler_decoder(self.upscaler_bottleneck(skips[-1]), skips)
        return self.upscaler_head(y)[:, :, :2 * x.shape[2], :2 * x.shape[3]], skips

    def segment_2(self, x, skips_up):
        t, padded = self.patch_embed(x, 2)
        skips = self.segmentator_encoder(t)
        skips[-2], skips[-1] = self.ca_sr_to_seg(skips[-2:], skips_up[-2:])
        y = self.segmentator_decoder(self.segmentator_bottleneck(skips[-1]), skips)
        return self.segmentator_head(y, padded, 2)

    def serve(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The 8-stage serving pipeline: segment, mask, normalize, upscale,
        denormalize, segment the 2x output, mask."""
        images = with_error_channel(images)
        seg, skips_seg = self.segment_1(images)
        seg_map_lr = torch.sigmoid(seg)
        norm, params = normalize(images * seg_map_lr)
        up, skips_up = self.upscale(norm, skips_seg)
        upscaled_denorm = denormalize(up, params)
        seg_map_hr = torch.sigmoid(self.segment_2(upscaled_denorm, skips_up))
        return {"seg_map_lr": seg_map_lr, "upscaled_denorm": upscaled_denorm, "seg_map_hr": seg_map_hr,
                "images_masked_hr": upscaled_denorm * seg_map_hr}


class RefSwinUNet(nn.Module):
    """The segmentation-only tower: embed, encoder, bottleneck, decoder, seg
    head; logits [B, 1, H, W]."""

    def __init__(self, cfg: dict, prod: Optional[Products] = None):
        super().__init__()
        prod = prod or Products()
        p, C, depths, heads, ws, mlp = _arch(cfg)
        self.patch_embed = Embed(p, cfg["in_chans"], C, prod)
        self.encoder = Encoder(C, depths, heads, ws, mlp, prod)
        self.bottleneck = Bottleneck(C * 8, heads[-1], ws, prod)
        self.decoder = Decoder(C, depths, heads, ws, mlp, prod)
        self.head = SegHead(C, p, prod)

    def forward(self, x):
        t, padded = self.patch_embed(x, 1)
        skips = self.encoder(t)
        return self.head(self.decoder(self.bottleneck(skips[-1]), skips), padded)

    def serve(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Segmentation: the sigmoid probability map."""
        return {"seg_map": torch.sigmoid(self(images))}


ARCHITECTURES = {"swinwnet": RefSwinWNet, "swinunet": RefSwinUNet}


def build(cfg: dict, device, fp8: bool = False) -> nn.Module:
    """The reference of `cfg["architecture"]` on `device`, its parameters
    uninitialised (the benchmark loads a drawn state dict). An architecture
    not defined here is the `Model` of `benchmark/yardstick/ref_<name>.py`."""
    arch = cfg["architecture"]
    cls = ARCHITECTURES.get(arch) or importlib.import_module(f"{__package__}.ref_{arch}").Model
    with torch.device("meta"):
        model = cls(cfg, Products(fp8))
    return model.to_empty(device=device).apply(_fill_index)


def _fill_index(m: nn.Module) -> None:
    if isinstance(m, Attention):
        m.index = rel_index(m.ws).to(m.index.device)


# ---------------------------------------------------------------------------
# Pipelines and losses
# ---------------------------------------------------------------------------


def with_error_channel(x: torch.Tensor) -> torch.Tensor:
    """[B, 1, H, W] -> [B, 2, H, W]: the Poisson error sqrt(|I|) appended."""
    return x if x.shape[1] == 2 else torch.cat([x, torch.sqrt(torch.abs(x))], dim=1)


def normalize(x: torch.Tensor, threshold: float = 0.01, eps: float = 1e-6):
    """Per-image min-max to [0, 1], log1p above `threshold`."""
    lo = torch.amin(x, dim=(2, 3), keepdim=True)
    hi = torch.amax(x, dim=(2, 3), keepdim=True)
    x01 = (x - lo) / (hi - lo + eps)
    return torch.where(x01 > threshold, torch.log1p(x01), x01), (lo, hi, threshold)


def denormalize(x: torch.Tensor, params, eps: float = 1e-6) -> torch.Tensor:
    lo, hi, threshold = params
    return torch.where(x > threshold, torch.expm1(x), x) * (hi - lo + eps) + lo


def bce_with_logits(logits, target):
    return (torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-torch.abs(logits)))).mean()


def dice_loss(logits, target, eps: float = 1e-6):
    p = torch.sigmoid(logits)
    inter = (p * target).sum(dim=(1, 2, 3))
    union = p.sum(dim=(1, 2, 3)) + target.sum(dim=(1, 2, 3))
    return 1.0 - ((2.0 * inter + eps) / (union + eps)).mean()


def seg_loss(logits, target):
    """BCE + Dice, each weighted 1 (the upstream CombinedLoss)."""
    return bce_with_logits(logits, target) + dice_loss(logits, target)


def smooth_l1(pred, target, beta: float = 1.0):
    d = torch.abs(pred - target)
    return torch.mean(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta))


def stage3_loss(model: RefSwinWNet, images: torch.Tensor, masks: torch.Tensor, even: bool) -> torch.Tensor:
    """The stage-3 objective, weights 1: even steps segment and reconstruct
    the masked input from its 0.5x average-pooled copy; odd steps segment,
    then segment the denormalized 2x output against 2x nearest-exact masks."""
    images = with_error_channel(images)
    masks = masks[:, None] if masks.dim() == 3 else masks
    seg, skips = model.segment_1(images)
    loss_lr = seg_loss(seg, masks)
    masked = images * torch.sigmoid(seg)
    if even:
        norm_lr, _ = normalize(F.avg_pool2d(masked, 2))
        norm_hr, _ = normalize(masked)
        sr, _ = model.upscale(norm_lr, skips)
        return loss_lr + smooth_l1(sr, norm_hr)
    norm_hr, params = normalize(masked)
    sr, skips_up = model.upscale(norm_hr, skips)
    seg_hr = model.segment_2(denormalize(sr, params), skips_up)
    masks_up = F.interpolate(masks, size=(masks.shape[-2] * 2, masks.shape[-1] * 2), mode="nearest-exact")
    return loss_lr + seg_loss(seg_hr, masks_up)


def warmup_cosine(base_lr: float, warmup_epochs: int, num_epochs: int, steps_per_epoch: int, step: int) -> float:
    """Linear warm-up by epoch, then cosine decay, held within an epoch."""
    epoch = step // max(steps_per_epoch, 1)
    if epoch < warmup_epochs:
        return base_lr * (epoch + 1.0) / max(warmup_epochs, 1)
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * (epoch - warmup_epochs) / max(num_epochs - warmup_epochs, 1)))


class RefAdamW:
    """AdamW with bias correction and decoupled decay scaled by the learning
    rate: p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)."""

    def __init__(self, params: Sequence[torch.Tensor], wd: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        self.wd, self.b1, self.b2, self.eps = wd, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(lr * ((m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p))
