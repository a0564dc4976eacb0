from .alpha_policy import AlphaPolicy, apply_action
from .layers import (
    BasicLayer,
    Bottleneck,
    CrossAttentionBlock,
    MultiScaleCrossAttention,
    PatchExpanding,
    PatchMerging,
    ScaleAwarePatchEmbed,
    SegmentationHead,
    SwinDecoder,
    SwinEncoder,
    SwinTransformerBlock,
    UpscalingHead,
    WindowAttention,
)
from .swin_unet import SwinUNet, SwinUNetSR
from .swin_wnet import SwinWNet, init_weights

__all__ = [
    "BasicLayer",
    "Bottleneck",
    "CrossAttentionBlock",
    "MultiScaleCrossAttention",
    "PatchExpanding",
    "PatchMerging",
    "ScaleAwarePatchEmbed",
    "SegmentationHead",
    "SwinDecoder",
    "SwinEncoder",
    "SwinTransformerBlock",
    "UpscalingHead",
    "WindowAttention",
    "SwinWNet",
    "SwinUNet",
    "SwinUNetSR",
    "init_weights",
    "AlphaPolicy",
    "apply_action",
]
