from .freeze import AdamW, apply_stage_freeze, masked_adamw, stage_trainable_names
from .losses import (
    bce_with_logits,
    combined_loss,
    dice_loss,
    focal_bce,
    focal_tversky_loss,
    get_segmentation_loss,
    get_upscaler_loss,
    l1_loss,
    mse_loss,
    smooth_l1_loss,
    smooth_l1_ssim_loss,
    ssim_loss,
    tversky_loss,
)
from .pipeline import SwinWNetTrainingPipeline
from .rl import RLTrainer, rl_step
from .schedule import warmup_cosine_schedule
from .trainers import FullModelTrainer, SegmentatorTrainer, UpscalerTrainer

__all__ = [
    "AdamW",
    "apply_stage_freeze",
    "masked_adamw",
    "stage_trainable_names",
    "bce_with_logits",
    "combined_loss",
    "dice_loss",
    "focal_bce",
    "focal_tversky_loss",
    "get_segmentation_loss",
    "get_upscaler_loss",
    "l1_loss",
    "mse_loss",
    "smooth_l1_loss",
    "smooth_l1_ssim_loss",
    "ssim_loss",
    "tversky_loss",
    "SwinWNetTrainingPipeline",
    "warmup_cosine_schedule",
    "FullModelTrainer",
    "SegmentatorTrainer",
    "UpscalerTrainer",
    "RLTrainer",
    "rl_step",
]
