"""Entry points (port of `__graft_entry__.py`): the flagship serving function
with its example arguments, and the multi-card dry run.

`entry()` returns `(fn, (model, x))`: the full 8-stage inference of the
published multimodal SwinWNet (diffraction + error matrix; embed 48, depths
2-2-2-2, heads 3-6-12-24, window 5) in fp32 with the fused blocks off, as
the JAX `entry()` builds it, and one [1, 2, 250, 480] image drawn as the JAX
one is. `fn(model, images)` returns `images_masked_hr`. `dryrun_multichip`
is `parallel.dryrun_multichip`.

    python -m swinwnet_tpu_torch.entry [--device cpu]

prints `entry ok: (1, 2, 500, 960)`.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from .core.device import resolve_device
from .models.swin_wnet import SwinWNet
from .parallel import dryrun_multichip
from .pipelines.split import inference_stages

__all__ = ["entry", "dryrun_multichip"]


def entry(device: Optional[Union[str, torch.device]] = None) -> Tuple[Callable, Tuple[SwinWNet, torch.Tensor]]:
    """(fn, (model, x)) on `device` (the card unless "cpu" is asked for);
    the weights are drawn from a generator seeded with 0."""
    dev = resolve_device(device)
    model = SwinWNet(in_chans=1, error_matrix=True, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                     window_size=5, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 100, (1, 2, 250, 480)).astype(np.float32)).to(dev)

    def fn(model: SwinWNet, images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return inference_stages(model, images)["images_masked_hr"]

    return fn, (model, x)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Run entry()'s function on its example arguments.")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry ok:", tuple(out.shape))


if __name__ == "__main__":
    main()
