"""Serving entry: SwinUNet segmentation through
`swinwnet_tpu_torch.pipelines.make_segmentation_fn`.

A request is a host array [B, in_chans, H, W]; the answer fetched to the
host, and compared, is the sigmoid probability map [B, 1, H, W].
"""

from __future__ import annotations

from typing import Dict

import torch

from .wnet_inference import Control, load, reference_outputs  # noqa: F401 -- the entry's control and reference

OUTPUTS = ("seg_map",)
ANSWER = "seg_map"


def request_shape(config: dict, batch: int):
    return (batch, config["in_chans"], config["height"], config["width"])


class Program:
    def __init__(self, config: dict, traffic: dict, state_dict: Dict[str, torch.Tensor], device):
        from swinwnet_tpu_torch.models import SwinUNet
        from swinwnet_tpu_torch.pipelines import make_segmentation_fn

        model = SwinUNet(
            patch_size=config["patch_size"], in_chans=config["in_chans"], embed_dim=config["embed_dim"],
            depths=config["depths"], num_heads=config["num_heads"], window_size=config["window_size"],
            mlp_ratio=config["mlp_ratio"], dtype=config["dtype"], fused_blocks=config["fused_blocks"],
            attn_chunk=config["attn_chunk"], device=device)
        load(model, state_dict)
        self.fn = make_segmentation_fn(model)

    def __call__(self, x) -> Dict[str, torch.Tensor]:
        return {"seg_map": self.fn(x)}
