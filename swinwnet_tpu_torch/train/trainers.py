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

The step factories are the JAX package's: `TrainState.create(model, tx)`,
then `make_stage1_step(model, tx, loss_fn)(state, images, masks) -> (state,
loss)`, `make_stage2_step`, `make_stage3_steps` (even and odd steps, `(state,
aux)`, and their evals) and the eval factories. Each step or eval is a
program (`core.graphs`): on the card a CUDA graph, captured once per batch
shape, that holds the forward, the backward and the update (the learning
rate and the bias corrections are read from the optimizer's count on the
device) and replays them with one host call, as the JAX package jit-compiles
them. A step updates the state in place and returns the same state. The
three trainers step through these factories. A step or eval is a
`train.step` span, its `_batch` a `train.batch` span inside it, and its
program is named after its loss (`stage3_even_loss.step`, ...;
`utils.profiling`).

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
import dataclasses
import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_dtype
from ..core.graphs import Program, name_of
from ..models.swin_wnet import SwinWNet
from ..ops.norms import denormalize_piecewise, ensure_2ch, normalize_piecewise
from ..ops.resize import bilinear_downscale_half, nearest_exact_resize
from ..utils.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..utils.logging import MetricsLogger
from ..utils.profiling import span
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


@dataclasses.dataclass(eq=False)
class TrainState:
    """The JAX `TrainState` over a module that owns its weights: `params`
    the trainable parameters by name (updated in place), `opt_state` the
    AdamW over them (its moments and count), `step` the steps taken, an
    int64 tensor on the parameters' device (the optimizer's count)."""

    params: Dict[str, torch.nn.Parameter]
    opt_state: Optional[AdamW]
    step: torch.Tensor

    @classmethod
    def create(cls, model: torch.nn.Module, tx: AdamW) -> "TrainState":
        trains = {id(p) for p in tx.params}
        params = {name: p for name, p in model.named_parameters() if id(p) in trains}
        return cls(params=params, opt_state=tx, step=tx.count)


def _state_tensors(state: TrainState, *_):
    """What a step reads and updates in place besides the model."""
    return state.opt_state.tensors()


def _step_program(model: SwinWNet, loss_of: Callable, compute_dtype, aux: bool = False) -> Callable:
    """`step(state, images, masks) -> (state, loss or aux)` from
    `loss_of(images, masks) -> loss` (or `(loss, aux)`), as a program."""

    def run(state: TrainState, images, masks):
        opt = state.opt_state
        # the backward too runs in the compute dtype: a model built with
        # remat recomputes its blocks there, in the forward's dtype
        with compute_dtype_of(model, compute_dtype):
            out = loss_of(images, masks)
            loss = out[0] if aux else out
            opt.zero_grad()
            loss.backward()
        opt.step()
        return {k: v.detach() for k, v in out[1].items()} if aux else loss.detach()

    run.__qualname__ = f"{name_of(loss_of)}.step"
    program = Program(run, modules=(model,), state=_state_tensors)

    def step(state: TrainState, images, masks=None):
        with span("train.step"):
            with span("train.batch"):
                images, masks = _batch(model, images, masks)
            return state, program(state, images, masks)

    return step


def _eval_program(model: SwinWNet, loss_of: Callable, compute_dtype, aux: bool = False) -> Callable:
    """`eval_step(images, masks) -> loss or aux`, under no_grad, as a
    program."""

    @torch.no_grad()
    def run(images, masks):
        with compute_dtype_of(model, compute_dtype):
            out = loss_of(images, masks)
        return out[1] if aux else out

    run.__qualname__ = f"{name_of(loss_of)}.eval"
    program = Program(run, modules=(model,))

    def eval_step(images, masks=None):
        with span("train.step"):
            with span("train.batch"):
                batch = _batch(model, images, masks)
            return program(*batch)

    return eval_step


def make_stage1_step(model: SwinWNet, tx: AdamW, loss_fn, compute_dtype=None) -> Callable:
    """Segmentation pretrain step: `step(state, images, masks) -> (state,
    loss)`. `tx` is the optimizer the state was created with (the update
    runs on `state.opt_state`); `compute_dtype` (None: the model's own) is
    the JAX `_with_compute_dtype`: the forward and the backward run in it."""
    return _step_program(model, functools.partial(stage1_loss, model, loss_fn), compute_dtype)


def make_stage1_eval(model: SwinWNet, loss_fn, compute_dtype=None) -> Callable:
    """`eval_step(images, masks) -> loss`. The model owns its weights, so
    there is no `params` argument (the JAX `eval_step(params, images,
    masks)`), as in `make_inference_fn`."""
    return _eval_program(model, functools.partial(stage1_loss, model, loss_fn), compute_dtype)


def make_stage2_step(model: SwinWNet, tx: AdamW, loss_fn, compute_dtype=None) -> Callable:
    """SR pretrain step: `step(state, hr, _masks=None) -> (state, loss)`."""
    return _step_program(model, functools.partial(stage2_loss, model, loss_fn), compute_dtype)


def make_stage2_eval(model: SwinWNet, loss_fn, compute_dtype=None) -> Callable:
    """`eval_step(hr, _masks=None) -> loss`."""
    return _eval_program(model, functools.partial(stage2_loss, model, loss_fn), compute_dtype)


def make_stage3_steps(model: SwinWNet, tx: AdamW, seg_loss_fn, sr_loss_fn, seg_weight_lr: float = 1.0,
                      seg_weight_hr: float = 1.0, rec_weight: float = 1.0, compute_dtype=None):
    """The joint even and odd steps, `step(state, images, masks) -> (state,
    aux)`, and their evals, `eval_step(images, masks) -> aux`: (even_step,
    odd_step, even_eval, odd_eval)."""
    weights = (seg_weight_lr, seg_weight_hr, rec_weight)
    even = functools.partial(stage3_even_loss, model, seg_loss_fn, sr_loss_fn, weights)
    odd = functools.partial(stage3_odd_loss, model, seg_loss_fn, sr_loss_fn, weights)
    return (_step_program(model, even, compute_dtype, aux=True), _step_program(model, odd, compute_dtype, aux=True),
            _eval_program(model, even, compute_dtype, aux=True), _eval_program(model, odd, compute_dtype, aux=True))


class _BaseTrainer:
    """Shared plumbing: the train state, best-validation selection,
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
        self.state = TrainState.create(model, masked_adamw(model, self.stage, schedule, weight_decay))
        # best-validation selection: keep a copy of the parameters of the
        # best-validation epoch on the device and restore it after the last
        self.keep_best = keep_best
        self._best_val = None
        self._best_params = None
        self.best_epoch = None

    @property
    def optimizer(self) -> Optional[AdamW]:
        """The state's AdamW (None once released)."""
        return self.state.opt_state

    @optimizer.setter
    def optimizer(self, tx: AdamW) -> None:
        self.state = TrainState.create(self.model, tx)

    @property
    def step(self) -> int:
        """Optimizer steps taken."""
        return int(self.state.step)

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
        self.state = TrainState(params=self.state.params, opt_state=None, step=self.state.step)

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
        self._step = make_stage1_step(model, self.optimizer, self.loss_fn, compute_dtype)
        self._eval = make_stage1_eval(model, self.loss_fn, compute_dtype)

    def train_step(self, images, masks) -> torch.Tensor:
        self.state, loss = self._step(self.state, images, masks)
        return loss

    def eval_step(self, images, masks) -> torch.Tensor:
        return self._eval(images, masks)

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
        self._step = make_stage2_step(model, self.optimizer, self.loss_fn, compute_dtype)
        self._eval = make_stage2_eval(model, self.loss_fn, compute_dtype)

    def train_step(self, hr, _masks=None) -> torch.Tensor:
        self.state, loss = self._step(self.state, hr)
        return loss

    def eval_step(self, hr, _masks=None) -> torch.Tensor:
        return self._eval(hr)

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
        self._even, self._odd, self._even_eval, self._odd_eval = make_stage3_steps(
            model, self.optimizer, self.seg_fn, self.sr_fn, *self.weights, compute_dtype=compute_dtype)

    def train_step(self, images, masks, even: bool) -> Dict[str, torch.Tensor]:
        """One even or odd step; returns the aux losses (detached)."""
        self.state, aux = (self._even if even else self._odd)(self.state, images, masks)
        return aux

    def eval_step(self, images, masks, even: bool) -> Dict[str, torch.Tensor]:
        return (self._even_eval if even else self._odd_eval)(images, masks)

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
