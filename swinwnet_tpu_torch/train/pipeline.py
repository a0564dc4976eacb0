"""3-stage supervised training orchestrator (port of
`swinwnet_tpu/train/pipeline.py`).

Runs SegmentatorTrainer -> UpscalerTrainer -> FullModelTrainer in turn on
one model, in place, releasing the optimizer state between stages. Stage 2
receives `sr_epochs` and stage 3 receives `lr`, as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict

from ..models.swin_wnet import SwinWNet
from .trainers import FullModelTrainer, SegmentatorTrainer, UpscalerTrainer


class SwinWNetTrainingPipeline:
    def __init__(self, model: SwinWNet, train_loader, val_loader=None, seg_loss: str = "CombinedLoss",
                 sr_loss: str = "SmoothL1Loss", seg_epochs: int = 300, sr_epochs: int = 50,
                 full_epochs: int = 100, warmup_epochs: int = 10, lr: float = 2e-4,
                 weight_decay: float = 1e-4, seg_weight_lr: float = 1.0, seg_weight_hr: float = 1.0,
                 rec_weight: float = 1.0, compute_dtype=None, keep_best: bool = False,
                 verbose: bool = True):
        self.model = model
        self.train_loader, self.val_loader = train_loader, val_loader
        self.seg_loss, self.sr_loss = seg_loss, sr_loss
        self.epochs = dict(stage1=seg_epochs, stage2=sr_epochs, stage3=full_epochs)
        self.stage3_weights = dict(seg_weight_lr=seg_weight_lr, seg_weight_hr=seg_weight_hr,
                                   rec_weight=rec_weight)
        self.common = dict(warmup_epochs=warmup_epochs, lr=lr, weight_decay=weight_decay,
                           compute_dtype=compute_dtype, keep_best=keep_best, verbose=verbose)
        self.verbose = verbose
        self.histories: Dict[str, dict] = {}

    def run(self):
        """Returns (the trained model, the three stages' histories)."""
        stages = (
            ("stage1", "segmentator pretrain", SegmentatorTrainer, dict(loss=self.seg_loss)),
            ("stage2", "upscaler pretrain", UpscalerTrainer, dict(loss=self.sr_loss)),
            ("stage3", "joint fine-tune", FullModelTrainer,
             dict(segmentator_loss=self.seg_loss, upscaler_loss=self.sr_loss, **self.stage3_weights)),
        )
        for i, (name, title, cls, kw) in enumerate(stages, 1):
            if self.verbose:
                print(f"=== Stage {i}: {title} ===")
            trainer = cls(self.model, self.train_loader, self.val_loader,
                          num_epochs=self.epochs[name], **kw, **self.common)
            self.histories[name] = trainer.train()
            trainer.release_training_state()
        return self.model, self.histories
