"""Configuration dataclasses of the PyTorch port.

A copy of `swinwnet_tpu/core/config.py` (`DetectorGeometry`, `ModelConfig`,
`TrainConfig`):
the port imports nothing of the JAX package, so it keeps its own. Published
checkpoints use depths=(2,2,2,2), embed_dim=48, heads=(3,6,12,24), window=5,
patch=2, which is the default here as there.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DetectorGeometry:
    """Fixed geometry of the position-sensitive detector: 480 scattering-angle
    bins over theta in [-170, 170] degrees x 250 wavelength bins over lambda
    in [0.1, 10] Angstrom."""

    height: int = 250  # wavelength (lambda) rows
    width: int = 480  # scattering angle (theta) columns
    theta_range: Tuple[float, float] = (-170.0, 170.0)  # degrees
    lambda_range: Tuple[float, float] = (0.1, 10.0)  # Angstrom
    d_max: float = 7.5  # interplanar distance cutoff


GEOMETRY = DetectorGeometry()


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of the SwinWNet model family."""

    patch_size: int = 2
    in_chans: int = 1
    error_matrix: bool = True  # multimodal [B,2,H,W] diffraction + Poisson error
    embed_dim: int = 48
    depths: Tuple[int, ...] = (2, 2, 2, 2)
    num_heads: Tuple[int, ...] = (3, 6, 12, 24)
    window_size: int = 5
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop: float = 0.0
    attn_drop: float = 0.0
    drop_path: float = 0.0
    # the JAX package's `use_pallas`: route eligible Swin levels through the
    # fused whole-block kernel (ops/swin_block.py)
    fused_blocks: bool = False
    compute_dtype: str = "float32"  # "bfloat16" for throughput mode

    @property
    def effective_in_chans(self) -> int:
        """Input channels of the shared patch embedding."""
        return self.in_chans + 1 if self.error_matrix else self.in_chans


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Supervised training hyperparameters, in the vocabulary of the
    reference trainers (Segmentator_pretrain.py:10-36, Upscaler_pretrain.py,
    FullModel_supervised_trainer.py, Supervised_train_full_pipline.py:7-25)."""

    loss: str = "CombinedLoss"  # seg loss registry key (train.losses)
    sr_loss: str = "SmoothL1Loss"
    num_epochs: int = 300
    warmup_epochs: int = 10
    lr: float = 2e-4
    weight_decay: float = 1e-4
    use_bf16: bool = False  # the trainers' compute_dtype="bfloat16"
    # stage-3 joint objective weights (FullModel_supervised_trainer.py)
    seg_weight_lr: float = 1.0
    seg_weight_hr: float = 1.0
    rec_weight: float = 1.0
    batch_size: int = 8
    seed: int = 0
