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
    "init_weights",
]
