"""Headless inference viewer (port of `swinwnet_tpu/apps/viewer.py`;
reference: inference_gui/swinwnet_viewer_gui.py, the non-Qt parts).

* load `.npy` patterns -- raw arrays or dict payloads (:598-664);
* load `.pth` weights -- a raw state dict, a `{"state_dict": ...}` wrapper
  with `module.` prefixes, or a pickled `nn.Module` -- and sniff the
  multimodality from the patch-embed conv (:129-151);
* run the 8-stage inference pipeline and keep every stage tensor;
* rebin a stage to I(d) curves on the LR or HR d-grid;
* export the I(d) curves as CSV (:1055-1088).

    python -m swinwnet_tpu_torch.apps.viewer --weights m.pth --input p.npy --out dir/

runs it on the card (`--device cpu` for the CPU) and writes the 8 stage
arrays as `{stage}.npy`, `input_id_curves.csv` and `masked_hr_id_curves.csv`.
The model is the published SwinWNet (embed 48, depths 2-2-2-2, heads
3-6-12-24, window 5, patch 2) in fp32 with the fused Swin-block kernels.
"""

from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..compat.torch_import import load_pth, sniff_error_matrix
from ..core.config import GEOMETRY
from ..core.device import resolve_device
from ..data.loaders import load_crystal_npy
from ..models.swin_wnet import SwinWNet
from ..physics.qwrapper import Qwrapper, d_centers_hr, d_centers_lr
from ..pipelines.inference import STAGE_NAMES, SwinWNetInference


def load_model_any(path: str, device: Optional[Union[str, torch.device]] = None) -> Tuple[SwinWNet, bool]:
    """(the published SwinWNet in fp32 on `device` with the weights of the
    `.pth` at `path`, its `error_matrix`). The checkpoint is unpickled in
    full (`weights_only=False`), as the reference viewer does, so that a
    pickled module loads too; load only checkpoints you trust."""
    sd = load_pth(path, weights_only=False)
    error_matrix = sniff_error_matrix(sd)
    model = SwinWNet(
        in_chans=1, error_matrix=error_matrix, embed_dim=48, depths=(2, 2, 2, 2),
        num_heads=(3, 6, 12, 24), window_size=5, patch_size=2,
        fused_blocks=True, dtype="float32", device=resolve_device(device),
    )
    model.load_state_dict(sd, strict=True)
    return model.eval(), error_matrix


def stage_arrays(infer: SwinWNetInference) -> Dict[str, np.ndarray]:
    """The 8 stage tensors of the last call as C-contiguous host arrays, as
    the JAX viewer gives them. The 2x stages come out of the model
    channels-last; made contiguous on the device, they copy to the host in
    one piece, and `np.save` writes them whole instead of through its
    strided path, which took most of a CLI call on the card."""
    return {name: getattr(infer, name).contiguous().cpu().numpy() for name in STAGE_NAMES}


class ViewerSession:
    """Stateful session: model, geometry and the two rebinners, all on the
    model's device."""

    def __init__(
        self,
        model: SwinWNet,
        theta_range=GEOMETRY.theta_range,
        lambda_range=GEOMETRY.lambda_range,
        d_centers_low=d_centers_lr,
        d_centers_high=d_centers_hr,
        split: bool = False,
    ):
        self.infer = SwinWNetInference(model, split=split)
        self.theta_range = theta_range
        self.lambda_range = lambda_range
        dev = self.infer.device
        self.qw_lr = Qwrapper(theta_range, lambda_range, fixed_centers=d_centers_low, device=dev)
        self.qw_hr = Qwrapper(theta_range, lambda_range, fixed_centers=d_centers_high, device=dev)

    def run(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """images: [H,W], [N,H,W] or [N,1,H,W] -> dict of all stage arrays."""
        images = np.asarray(images, np.float32)
        if images.ndim == 2:
            images = images[None]
        if images.ndim == 3:
            images = images[:, None]
        self.infer(images)
        return stage_arrays(self.infer)

    def curves(self, stage_array: np.ndarray, high_res: bool = False):
        """Stage [N, C, H, W] -> list of {d, I} dicts (diffraction channel)."""
        qw = self.qw_hr if high_res else self.qw_lr
        return qw.tensor_to_d(stage_array[:, 0:1])


def export_stage_csv(path: str, curves, sample_names=None):
    """I(d) curves -> CSV with d + one intensity column per sample
    (swinwnet_viewer_gui.py:1055-1088)."""
    if not curves:
        raise ValueError("no curves to export")
    d = curves[0]["d"]
    names = sample_names or [f"I_{i}" for i in range(len(curves))]
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["d"] + list(names))
        for i in range(len(d)):
            writer.writerow([float(d[i])] + [float(c["I"][i]) for c in curves])


def main(argv=None):
    parser = argparse.ArgumentParser(description="SwinWNet headless inference viewer (PyTorch)")
    parser.add_argument("--weights", required=True, help=".pth checkpoint")
    parser.add_argument("--input", required=True, help=".npy pattern (raw or dict)")
    parser.add_argument("--out", required=True, help="output directory")
    parser.add_argument("--theta", nargs=2, type=float, default=GEOMETRY.theta_range)
    parser.add_argument("--lam", nargs=2, type=float, default=GEOMETRY.lambda_range)
    parser.add_argument("--split", action="store_true",
                        help="run the three towers as separate stages (pipelines/split.py)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)

    model, error_matrix = load_model_any(args.weights, args.device)
    print(f"loaded {args.weights} (error_matrix={error_matrix})")

    session = ViewerSession(model, tuple(args.theta), tuple(args.lam), split=args.split)
    stages = session.run(load_crystal_npy(args.input))

    os.makedirs(args.out, exist_ok=True)
    for name, arr in stages.items():
        np.save(os.path.join(args.out, f"{name}.npy"), arr)
    export_stage_csv(os.path.join(args.out, "input_id_curves.csv"), session.curves(stages["images"]))
    export_stage_csv(
        os.path.join(args.out, "masked_hr_id_curves.csv"),
        session.curves(stages["images_masked_hr"], high_res=True),
    )
    print(f"wrote {len(stages)} stage arrays + I(d) CSVs to {args.out}")


if __name__ == "__main__":
    main()
