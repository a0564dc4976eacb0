"""The port's 8-stage pipeline (swinwnet_tpu_torch/pipelines/inference.py)
against the JAX package's `inference_stages`, stage by stage, on the same
images and the same weights (JAX params carried over by
`state_dict_from_jax`), at the small geometry of tests/_torch_port_helpers.py
in fp32.

Tolerance: max relative error 2e-4 for the low-resolution stages and 5e-4
from the upscaler on, those of tests/test_torch_parity.py (observed about
3e-6 on this CPU)."""

import jax
import numpy as np
import pytest
import torch

import _torch_port_helpers as h
from swinwnet_tpu.pipelines.inference import make_inference_fn
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.pipelines import STAGE_NAMES, SwinWNetInference

torch.set_num_threads(1)

HR_STAGES = ("upscaled_norm", "upscaled_denorm", "seg_map_hr", "images_masked_hr")


@pytest.fixture(scope="module")
def both():
    jmodel, params, port = h.models(seed=1)
    x = h.images(seed=1)
    want = jax.device_get(make_inference_fn(jmodel)(params, x))
    infer = SwinWNetInference(port)
    sb.reset_counts()
    out = infer(x)
    return want, infer, out, sb.fused_swin_block_cst.plain_calls


@pytest.mark.parametrize("stage", STAGE_NAMES)
def test_stage_matches_jax(both, stage):
    want, infer, _, _ = both
    got = getattr(infer, stage)
    assert got.device.type == "cpu"
    h.assert_close(got, want[stage], tol=5e-4 if stage in HR_STAGES else 2e-4, name=stage)


def test_wrapper_returns_last_stage_and_routes_levels(both):
    """The call returns images_masked_hr; in fp32 the L0 and SR levels go to
    the kernel wrapper, 2 blocks each: 2 in segment_1, 6 in upscale, 2 in
    segment_2 (on the CPU its plain version runs, and nothing launches)."""
    _, infer, out, plain_calls = both
    assert out is infer.images_masked_hr
    assert out.shape == (h.BATCH, 2, 2 * h.H, 2 * h.W)
    assert plain_calls == 10
    assert sb.fused_swin_block_cst.launches == 0
