from .norms import denormalize_piecewise, ensure_2ch, normalize_piecewise
from .resize import bilinear_resize
from .swin_block import fused_swin_block_cst, swin_block_plain
from .window import (
    relative_position_index,
    window_pad_mask_np,
    window_partition,
    window_partition_cmajor,
    window_reverse,
    window_reverse_cmajor,
)

__all__ = [
    "denormalize_piecewise",
    "ensure_2ch",
    "normalize_piecewise",
    "bilinear_resize",
    "fused_swin_block_cst",
    "swin_block_plain",
    "relative_position_index",
    "window_pad_mask_np",
    "window_partition",
    "window_partition_cmajor",
    "window_reverse",
    "window_reverse_cmajor",
]
