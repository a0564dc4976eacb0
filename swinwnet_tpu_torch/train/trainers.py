"""Supervised trainers (port of `swinwnet_tpu/train/trainers.py`): step
functions and thin epoch loops.

* Stage 1 (`SegmentatorTrainer`): train the segmentation tower on
  `segment_1` logits against masks; upscaler and cross-attentions frozen.
* Stage 2 (`UpscalerTrainer`): frozen-segmentator preprocess under
  `torch.no_grad()` -> mask -> bilinear x0.5 -> piecewise-normalize LR and HR
  -> `upscale(norm_lr, skips)` against `norm_hr`.
* Stage 3 (`FullModelTrainer`): alternating objectives. Even batches: seg
  loss + SR reconstruction of the x0.5-downscaled masked input. Odd batches:
  seg loss + HR seg loss through SR -> denormalize -> `segment_2` against
  nearest-exact x2 masks. The mask/normalize path is differentiated through.

A step is forward, backward and one AdamW update on the model's own
parameters, in place. The forward goes through the fused block kernels when
the model was built with `fused_blocks=True`, in `train()` and `eval()` alike:
the trainers call the model with its default `deterministic=True`, as the
JAX trainers do, so a model's dropout rates never act in them.

Mixed precision: `compute_dtype=torch.bfloat16` runs the model's products
in bf16 while parameters, optimizer state and losses stay fp32 and the
gradients come out fp32 through the casts. bf16 has fp32's exponent range,
so there is no GradScaler.

`loader` is any iterable of (images, masks) numpy batches with `len()`.
Trainers run on the model's device; a model is built on the card unless
its caller asked for the CPU.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_dtype
from ..models.swin_wnet import SwinWNet
from ..ops.norms import denormalize_piecewise, ensure_2ch, normalize_piecewise
from ..ops.resize import bilinear_downscale_half, nearest_exact_resize
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..utils.logging import MetricsLogger
from .freeze import AdamW, masked_adamw
from .losses import get_segmentation_loss, get_upscaler_loss
from .schedule import warmup_cosine_schedule


@contextlib.contextmanager
def compute_dtype_of(model: SwinWNet, compute_dtype):
    """Run `model` with `compute_dtype` as its compute dtype (None keeps its
    own): every module carries the dtype it computes in, the parameters stay
    fp32. A model built with `remat` recomputes its blocks in the backward,
    so the backward too runs inside the context."""
    if compute_dtype is None:
        yield
        return
    dt = resolve_dtype(compute_dtype)
    mods = [m for m in model.modules() if isinstance(getattr(m, "dtype", None), torch.dtype)]
    old = [m.dtype for m in mods]
    for m in mods:
        m.dtype = dt
    try:
        yield
    finally:
        for m, d in zip(mods, old):
            m.dtype = d


def _batch(model: SwinWNet, images, masks=None):
    """numpy or tensor batch -> fp32 tensors on the model's device; images
    get the error channel, masks their channel axis."""
    dev = next(model.parameters()).device
    images = ensure_2ch(torch.as_tensor(images).to(device=dev, dtype=torch.float32))
    if masks is None:
        return images, None
    masks = torch.as_tensor(masks).to(device=dev, dtype=torch.float32)
    return images, masks[:, None] if masks.dim() == 3 else masks


def stage1_loss(model: SwinWNet, loss_fn, images, masks):
    seg, _ = model.segment_1(images)
    return loss_fn(seg.float(), masks)


def sr_preprocess(model: SwinWNet, hr):
    """Frozen-segmentator preprocess: no gradient flows through it."""
    with torch.no_grad():
        seg, skips = model.segment_1(hr)
        hr_masked = torch.sigmoid(seg.float()) * hr
        norm_lr, _ = normalize_piecewise(bilinear_downscale_half(hr_masked))
        norm_hr, _ = normalize_piecewise(hr_masked)
    return norm_lr, norm_hr, skips


def stage2_loss(model: SwinWNet, loss_fn, hr, _masks=None):
    norm_lr, norm_hr, skips = sr_preprocess(model, hr)
    pred, _ = model.upscale(norm_lr, skips)
    return loss_fn(pred.float(), norm_hr)


def stage3_even_loss(model, seg_loss_fn, sr_loss_fn, weights, images, masks):
    seg_weight_lr, _, rec_weight = weights
    seg, skips_seg = model.segment_1(images)
    seg = seg.float()
    loss_seg = seg_loss_fn(seg, masks)
    images_masked = images * torch.sigmoid(seg)
    norm_lr, _ = normalize_piecewise(bilinear_downscale_half(images_masked))
    norm_hr, _ = normalize_piecewise(images_masked)
    sr_out, _ = model.upscale(norm_lr, skips_seg)
    rec = sr_loss_fn(sr_out.float(), norm_hr)
    total = loss_seg * seg_weight_lr + rec * rec_weight
    zero = torch.zeros((), device=total.device)
    return total, {"loss": total, "seg_lr": loss_seg, "rec": rec, "seg_hr": zero}


def stage3_odd_loss(model, seg_loss_fn, sr_loss_fn, weights, images, masks, deterministic: bool = True,
                    generator: Optional[torch.Generator] = None):
    """The odd step's loss and aux terms. `hr_inter` and `hr_union` are the
    sums behind `iou_hr`: over a sharded batch their sums over the shards,
    not the shards' ratios, give the batch's IoU."""
    seg_weight_lr, seg_weight_hr, _ = weights
    seg, skips_seg = model.segment_1(images, deterministic, generator)
    seg = seg.float()
    loss_low = seg_loss_fn(seg, masks)
    images_masked = torch.sigmoid(seg) * images
    norm_hr, params_hr = normalize_piecewise(images_masked)
    sr_out, skips_sr = model.upscale(norm_hr, skips_seg, deterministic, generator)
    denorm_pred = denormalize_piecewise(sr_out.float(), params_hr)
    seg_high, _ = model.segment_2(denorm_pred, skips_sr, deterministic, generator)
    seg_high = seg_high.float()
    masks_up = nearest_exact_resize(masks.float(), masks.shape[-2] * 2, masks.shape[-1] * 2)
    loss_high = seg_loss_fn(seg_high, masks_up)
    total = loss_low * seg_weight_lr + loss_high * seg_weight_hr
    with torch.no_grad():  # HR IoU at 0.5: a diagnostic, not part of the loss
        pred_hr = (torch.sigmoid(seg_high) > 0.5).float()
        inter = torch.sum(pred_hr * masks_up)
        union = torch.sum(torch.maximum(pred_hr, masks_up))
        iou_hr = inter / torch.clamp(union, min=1.0)
    zero = torch.zeros((), device=total.device)
    return total, {"loss": total, "seg_lr": loss_low, "seg_hr": loss_high, "rec": zero, "iou_hr": iou_hr,
                   "hr_inter": inter, "hr_union": union}


class _BaseTrainer:
    """Shared plumbing: the optimizer step, best-validation selection,
    `save` / `resume`. `log_path` streams per-epoch JSONL metrics."""

    stage = "all"

    def __init__(self, model: SwinWNet, train_loader, val_loader, num_epochs, warmup_epochs, lr,
                 weight_decay, compute_dtype, verbose, log_path, keep_best):
        self.model = model
        self.train_loader, self.val_loader = train_loader, val_loader
        self.num_epochs = num_epochs
        self.compute_dtype = compute_dtype
        self.verbose = verbose
        self.logger = MetricsLogger(log_path)
        self.history_train, self.history_val = [], []
        schedule = warmup_cosine_schedule(lr, warmup_epochs, num_epochs, max(len(train_loader), 1))
        self.optimizer: Optional[AdamW] = masked_adamw(model, self.stage, schedule, weight_decay)
        # best-validation selection: keep a copy of the parameters of the
        # best-validation epoch on the device and restore it after the last
        self.keep_best = keep_best
        self._best_val = None
        self._best_params = None
        self.best_epoch = None
        self._released_at = 0

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return self.optimizer.count if self.optimizer is not None else self._released_at

    def _backward_and_update(self, loss: torch.Tensor) -> None:
        self.optimizer.zero_grad()
        with compute_dtype_of(self.model, self.compute_dtype):  # remat recomputes in the forward's dtype
            loss.backward()
        self.optimizer.step()

    def _track_best(self, val_loss: float):
        if not self.keep_best or val_loss != val_loss:  # disabled or NaN
            return
        if self._best_val is None or val_loss < self._best_val:
            self._best_val = val_loss
            self._best_params = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
            self.best_epoch = len(self.history_val)

    def _restore_best(self):
        if self.keep_best and self._best_params is not None:
            if self.verbose and self.best_epoch != len(self.history_val) - 1:
                print(f"restoring best-val params (epoch {self.best_epoch + 1}, val {self._best_val:.6f})")
            self.model.load_state_dict(self._best_params)
            self._best_params = None

    def _end_epoch(self, epoch, train_loss, val_loss):
        self._track_best(val_loss)
        self.history_train.append(train_loss)
        self.history_val.append(val_loss)
        self.logger.log(epoch, train_loss=train_loss, val_loss=val_loss)
        if self.verbose:
            print(f"Epoch [{epoch + 1}/{self.num_epochs}] Train Loss: {train_loss:.6f} Val Loss: {val_loss:.6f}")

    def release_training_state(self):
        """Drop the optimizer state so the next stage starts clean."""
        self._released_at = self.step
        self.optimizer = None

    def save(self, directory: str) -> str:
        """Checkpoint the full train state (parameters, optimizer, step)."""
        state = {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(), "step": self.step}
        return save_checkpoint(directory, state, step=self.step)

    def resume(self, directory: str) -> bool:
        """Restore the latest checkpoint in `directory` (False if none)."""
        path = latest_checkpoint(directory)
        if path is None:
            return False
        dev = next(self.model.parameters()).device
        state = load_checkpoint(path, map_location=dev)
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        return True


class SegmentatorTrainer(_BaseTrainer):
    stage = "stage1"

    def __init__(self, model: SwinWNet, train_loader, val_loader=None, loss: str = "CombinedLoss",
                 num_epochs: int = 300, warmup_epochs: int = 10, lr: float = 2e-4,
                 weight_decay: float = 1e-4, compute_dtype=None, verbose: bool = True,
                 log_path=None, keep_best: bool = False):
        super().__init__(model, train_loader, val_loader, num_epochs, warmup_epochs, lr, weight_decay,
                         compute_dtype, verbose, log_path, keep_best)
        self.loss_fn = get_segmentation_loss(loss)

    def train_step(self, images, masks) -> torch.Tensor:
        images, masks = _batch(self.model, images, masks)
        with compute_dtype_of(self.model, self.compute_dtype):
            loss = stage1_loss(self.model, self.loss_fn, images, masks)
        self._backward_and_update(loss)
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, images, masks) -> torch.Tensor:
        images, masks = _batch(self.model, images, masks)
        with compute_dtype_of(self.model, self.compute_dtype):
            return stage1_loss(self.model, self.loss_fn, images, masks)

    def train(self) -> Dict[str, list]:
        for epoch in range(self.num_epochs):
            total, n = 0.0, 0
            for images, masks in self.train_loader:
                b = len(images)
                total += float(self.train_step(images, masks)) * b
                n += b
            train_loss = total / max(n, 1)
            val_loss = float("nan")
            if self.val_loader is not None:
                vtotal, vn = 0.0, 0
                for images, masks in self.val_loader:
                    vtotal += float(self.eval_step(images, masks)) * len(images)
                    vn += len(images)
                val_loss = vtotal / max(vn, 1)
            self._end_epoch(epoch, train_loss, val_loss)
        self._restore_best()
        return {"train_loss": self.history_train, "val_loss": self.history_val}


class UpscalerTrainer(_BaseTrainer):
    stage = "stage2"

    def __init__(self, model: SwinWNet, train_loader, val_loader=None, loss: str = "SmoothL1Loss",
                 num_epochs: int = 50, warmup_epochs: int = 10, lr: float = 2e-4,
                 weight_decay: float = 1e-4, compute_dtype=None, verbose: bool = True,
                 log_path=None, keep_best: bool = False):
        super().__init__(model, train_loader, val_loader, num_epochs, warmup_epochs, lr, weight_decay,
                         compute_dtype, verbose, log_path, keep_best)
        self.loss_fn = get_upscaler_loss(loss)

    def train_step(self, hr, _masks=None) -> torch.Tensor:
        hr, _ = _batch(self.model, hr)
        with compute_dtype_of(self.model, self.compute_dtype):
            loss = stage2_loss(self.model, self.loss_fn, hr)
        self._backward_and_update(loss)
        return loss.detach()

    @torch.no_grad()
    def eval_step(self, hr, _masks=None) -> torch.Tensor:
        hr, _ = _batch(self.model, hr)
        with compute_dtype_of(self.model, self.compute_dtype):
            return stage2_loss(self.model, self.loss_fn, hr)

    def train(self) -> Dict[str, list]:
        for epoch in range(self.num_epochs):
            total = sum(float(self.train_step(hr)) for hr, _ in self.train_loader)
            train_loss = total / max(len(self.train_loader), 1)
            val_loss = float("nan")
            if self.val_loader is not None:
                vtotal = sum(float(self.eval_step(hr)) for hr, _ in self.val_loader)
                val_loss = vtotal / max(len(self.val_loader), 1)
            self._end_epoch(epoch, train_loss, val_loss)
        self._restore_best()
        return {"train_loss": self.history_train, "val_loss": self.history_val}


class FullModelTrainer(_BaseTrainer):
    stage = "stage3"

    def __init__(self, model: SwinWNet, train_loader, val_loader=None,
                 segmentator_loss: str = "CombinedLoss", upscaler_loss: str = "SmoothL1Loss",
                 num_epochs: int = 100, warmup_epochs: int = 10, lr: float = 2e-4,
                 weight_decay: float = 1e-4, seg_weight_lr: float = 1.0, seg_weight_hr: float = 1.0,
                 rec_weight: float = 1.0, compute_dtype=None, verbose: bool = True, log_path=None,
                 keep_best: bool = False):
        super().__init__(model, train_loader, val_loader, num_epochs, warmup_epochs, lr, weight_decay,
                         compute_dtype, verbose, log_path, keep_best)
        self.seg_fn = get_segmentation_loss(segmentator_loss)
        self.sr_fn = get_upscaler_loss(upscaler_loss)
        self.weights = (seg_weight_lr, seg_weight_hr, rec_weight)

    def _loss(self, even: bool, images, masks):
        images, masks = _batch(self.model, images, masks)
        fn = stage3_even_loss if even else stage3_odd_loss
        with compute_dtype_of(self.model, self.compute_dtype):
            return fn(self.model, self.seg_fn, self.sr_fn, self.weights, images, masks)

    def train_step(self, images, masks, even: bool) -> Dict[str, torch.Tensor]:
        """One even or odd step; returns the aux losses (detached)."""
        total, aux = self._loss(even, images, masks)
        self._backward_and_update(total)
        return {k: v.detach() for k, v in aux.items()}

    @torch.no_grad()
    def eval_step(self, images, masks, even: bool) -> Dict[str, torch.Tensor]:
        return self._loss(even, images, masks)[1]

    def _run_epoch(self, loader, train: bool) -> Dict[str, float]:
        tot = {"loss": 0.0, "seg_lr": 0.0, "seg_hr": 0.0, "rec": 0.0}
        iou_hr_sum, n_odd = 0.0, 0
        step = self.train_step if train else self.eval_step
        for batch_idx, (images, masks) in enumerate(loader):
            is_even = batch_idx % 2 == 0
            aux = step(images, masks, even=is_even)
            for k in tot:
                tot[k] += float(aux[k])
            if not is_even:
                iou_hr_sum += float(aux["iou_hr"])
                n_odd += 1
        n = max(len(loader), 1)
        out = {k: v / n for k, v in tot.items()}
        out["iou_hr"] = iou_hr_sum / max(n_odd, 1)
        return out

    def train(self) -> Dict[str, list]:
        for epoch in range(self.num_epochs):
            train_m = self._run_epoch(self.train_loader, train=True)
            val_m = (
                self._run_epoch(self.val_loader, train=False)
                if self.val_loader is not None
                else {k: float("nan") for k in ("loss", "seg_lr", "seg_hr", "rec")}
            )
            self._track_best(val_m["loss"])
            self.history_train.append(train_m)
            self.history_val.append(val_m)
            self.logger.log(epoch, **{f"train_{k}": v for k, v in train_m.items()})
            if self.verbose:
                print(
                    f"Epoch [{epoch + 1}/{self.num_epochs}] "
                    f"Train {train_m['loss']:.4f} (seg_lr {train_m['seg_lr']:.4f} "
                    f"seg_hr {train_m['seg_hr']:.4f} rec {train_m['rec']:.4f} "
                    f"iou_hr {train_m['iou_hr']:.3f}) Val {val_m['loss']:.4f}"
                )
        self._restore_best()
        return {"train": self.history_train, "val": self.history_val}
