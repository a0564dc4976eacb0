"""The three-stage split of the 8-stage pipeline (swinwnet_tpu_torch/
pipelines/split.py) and `SwinWNetInference(split=True)`: the split gives
the single route's stage tensors bit for bit (eagerly the two run the same
operations), and agrees with the JAX package's `make_split_inference_fn` on
the same numpy images and weights, at a tiny geometry (embed 12, depths
1-1-1-1, heads 3-6-12-24, window 5, 40x40, error matrix, live
cross-attention), fp32.

Tolerance against JAX: max absolute error at most 1e-5 of each stage's
max|JAX| for the low-resolution stages (observed 3.5e-7 on an x86 CPU); the
upscaler's stages carry the tiny SR head's conditioning (see
tests/test_torch_port_swin_unet.py: 1 ulp of input noise moves its output
by up to 2.6e-5 of its max) and are held at 1e-4 (observed 1.0e-5 to
1.2e-5)."""

import jax
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu.pipelines.split import make_split_inference_fn as jax_split_fn
from swinwnet_tpu_torch.compat import state_dict_from_jax
from swinwnet_tpu_torch.models import SwinWNet
from swinwnet_tpu_torch.pipelines import STAGE_NAMES, SwinWNetInference, inference_stages, make_split_inference_fn

torch.set_num_threads(1)

TINY = dict(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1),
            num_heads=(3, 6, 12, 24), window_size=5)
S = 40
LR_STAGES = ("images", "seg_map_lr", "images_masked_lr", "norm")


@pytest.fixture(scope="module")
def setup():
    params = h.draw_params(JaxSwinWNet(**TINY), (1, 2, S, S), seed=6)
    port = SwinWNet(**TINY, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    x = np.random.default_rng(6).uniform(0, 1e3, (2, 1, S, S)).astype(np.float32)
    return params, port, x


def test_split_equals_single_route_bit_for_bit(setup):
    _, port, x = setup
    fn = make_split_inference_fn(port)
    split, single = fn(torch.from_numpy(x)), inference_stages(port, torch.from_numpy(x))
    assert list(split) == list(STAGE_NAMES)
    for name in STAGE_NAMES:
        assert torch.equal(split[name], single[name]), name
    # stage_a alone is segmentation-only serving
    images, seg_map_lr, *_ = fn.stage_a(torch.from_numpy(x))
    assert torch.equal(seg_map_lr, single["seg_map_lr"]) and images.shape == (2, 2, S, S)


def test_split_matches_jax(setup):
    params, port, x = setup
    want = jax.device_get(jax_split_fn(JaxSwinWNet(**TINY))(params, x))
    got = make_split_inference_fn(port)(torch.from_numpy(x))
    for name in STAGE_NAMES:
        h.assert_close(got[name], want[name], tol=1e-5 if name in LR_STAGES else 1e-4, name=name)


def test_inference_wrapper_with_split_sets_every_stage(setup):
    _, port, x = setup
    single = SwinWNetInference(port)
    want = {name: getattr(single, name) for name in STAGE_NAMES} if single(x) is not None else None
    infer = SwinWNetInference(port, split=True)
    out = infer(x)
    assert out is infer.images_masked_hr and out.shape == (2, 2, 2 * S, 2 * S)
    for name in STAGE_NAMES:
        assert torch.equal(getattr(infer, name), want[name]), name
    assert infer.ensure_2ch(torch.ones(1, 1, 2, 2)).shape == (1, 2, 2, 2)
    norm, params = infer.normalize_piecewise(torch.rand(1, 2, 4, 4))
    assert infer.denormalize_piecewise(norm, params).shape == (1, 2, 4, 4)
