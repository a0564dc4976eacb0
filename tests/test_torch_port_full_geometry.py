"""All 8 stages at the detector's full geometry, [1, 1, 250, 480] ->
[1, 2, 500, 960], the port against the JAX package with the same weights:
the counterpart of tests/test_pipeline.py's
`test_st_pipeline_parity_full_geometry`, with the port as its torch side. It
runs the real padding and cropping and the patch embedding's scale-2 branch
at full size, which the 50x60 tests cannot.

The port runs on the CPU twice: every level unfused (the JAX model's
`use_pallas=False`), and with `fused_blocks=True`, where the gate sends the
levels it admits to the kernel wrappers' plain versions. Tolerance: that
test's max relative error of 1e-3 a stage. Marked slow: the JAX pipeline's
compile at this size takes minutes on the CPU."""

import numpy as np
import pytest
import torch

from swinwnet_tpu.compat import convert_state_dict
from swinwnet_tpu.models import SwinWNet as JaxSwinWNet
from swinwnet_tpu.pipelines import SwinWNetInference as JaxInference
from swinwnet_tpu_torch.models import SwinWNet
from swinwnet_tpu_torch.pipelines import STAGE_NAMES, SwinWNetInference

torch.set_num_threads(4)

CFG = dict(patch_size=2, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=5)
TOL = 1e-3

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def both():
    port = SwinWNet(in_chans=1, error_matrix=True, **CFG, device="cpu", generator=torch.Generator().manual_seed(11))
    x = np.random.default_rng(11).uniform(0, 1e3, size=(1, 1, 250, 480)).astype(np.float32)
    jinfer = JaxInference(JaxSwinWNet(in_chans=1, error_matrix=True, **CFG),
                          {"params": convert_state_dict(port.state_dict())})
    jout = jinfer(x)
    assert np.asarray(jout).shape == (1, 2, 500, 960)
    want = {k: np.asarray(getattr(jinfer, k)) for k in STAGE_NAMES}
    got = {}
    for fused in (False, True):
        for m in port.modules():
            if hasattr(m, "fused_blocks"):
                m.fused_blocks = fused
        infer = SwinWNetInference(port)
        with torch.no_grad():
            out = infer(x)
        assert tuple(out.shape) == (1, 2, 500, 960)
        got[fused] = {k: getattr(infer, k).numpy() for k in STAGE_NAMES}
    return got, want


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_blocks"])
@pytest.mark.parametrize("stage", STAGE_NAMES)
def test_stage_matches_jax_at_full_geometry(both, fused, stage):
    got, want = both
    g, w = got[fused][stage], want[stage]
    assert g.shape == w.shape, stage
    err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-6)
    assert err < TOL, f"{stage}: rel err {err:.2e}"
