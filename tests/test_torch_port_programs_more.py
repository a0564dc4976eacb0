"""The port's last compiled functions besides the RL step: the baselines'
pipelines as programs (swinwnet_tpu_torch/pipelines/simple.py
`make_segmentation_fn`, `make_sr_fn`) and the dry run's odd step through
`make_stage3_steps` with the gradients' mean carried by the optimizer
(parallel/sharding.py `data_parallel`, train/freeze.py
`AdamW.grad_transform`), on the CPU.

* The two pipelines' programs against the JAX package's jitted functions
  on the same weights and inputs, the levels through the fused-block
  wrappers (their plain versions here, the 128-window rule lowered), at
  the tolerances of tests/test_torch_port_swin_unet.py: 1e-5 of
  max|JAX| for the segmentation map, 1e-4 for SwinUNetSR's output through
  its head.
* `AdamW.grad_transform` runs on the gradients before the update; a
  one-process gloo group's `data_parallel` step equals the plain step bit
  for bit (the mean over one rank).
* `dryrun_multichip(2, steps=2)` over gloo against the same two steps in
  one process on the full batch, through `make_stage3_steps`: the loss to
  1e-5 relative, the gradients to 1e-3 of each leaf's max (the limits of
  tests/test_torch_port_parallel.py), every parameter within 2 lr a step
  of the one-process run (the most AdamW moves one) and fewer than 1e-3 of
  the elements outside rtol 1e-5 / atol 1e-6.
* On the card (marked `cuda`): each pipeline's replay against the same
  call run eagerly, bit for bit, and its kernel launches."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swinwnet_tpu_torch.core import graphs
from swinwnet_tpu_torch.models import BasicLayer, SwinUNet, SwinUNetSR, SwinWNet
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.parallel import dryrun_multichip
from swinwnet_tpu_torch.parallel.dryrun import LR, WEIGHTS, dryrun_batch, free_port
from swinwnet_tpu_torch.pipelines import make_segmentation_fn, make_sr_fn
from swinwnet_tpu_torch.train import (
    AdamW,
    TrainState,
    combined_loss,
    make_stage3_steps,
    masked_adamw,
    smooth_l1_loss,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY = dict(patch_size=2, embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 6, 12, 24), window_size=5)
S = 40
TOL, SR_HEAD_TOL = 1e-5, 1e-4
# the dry run's tiny SwinWNet and geometry (tests/_torch_port_helpers.py's
# TINY and TINY_H x TINY_W; that module imports JAX, which the card's
# machine, running the `cuda` cases, does not have)
TINY_WNET = dict(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1),
                 num_heads=(3, 3, 3, 3), window_size=5)
HW = (20, 30)
SEED = 1
DP_STEPS = 2


def close(got, want, tol):
    got, want = got.detach().float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, f"max abs err {err:.3e} of max|want|"


@pytest.mark.parametrize("name", ["unet", "sr"])
def test_baseline_programs_match_jax(monkeypatch, name):
    from swinwnet_tpu.models.swin_unet import SwinUNet as JaxSwinUNet
    from swinwnet_tpu.models.swin_unet import SwinUNetSR as JaxSwinUNetSR
    from swinwnet_tpu.pipelines.simple import make_segmentation_fn as jax_seg_fn
    from swinwnet_tpu.pipelines.simple import make_sr_fn as jax_sr_fn
    from swinwnet_tpu_torch.compat import state_dict_from_jax

    import _torch_port_helpers as h

    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    sr = name == "sr"
    jcls, pcls, c = (JaxSwinUNetSR, SwinUNetSR, 1) if sr else (JaxSwinUNet, SwinUNet, 2)
    params = h.draw_params(jcls(in_chans=c, **TINY), (1, c, S, S), seed=4)
    port = pcls(in_chans=c, **TINY, fused_blocks=True, device="cpu")
    port.load_state_dict(state_dict_from_jax(params), strict=True)
    x = np.random.default_rng(4).uniform(0, 1e3, (2, c, S, S)).astype(np.float32)
    if sr:
        x *= np.random.default_rng(5).uniform(size=x.shape) > 0.7  # a masked pattern
    want = (jax_sr_fn if sr else jax_seg_fn)(jcls(in_chans=c, **TINY))(params, x)
    fn = (make_sr_fn if sr else make_segmentation_fn)(port)
    sb.reset_counts()
    got = fn(x)
    assert isinstance(fn.program, graphs.Program) and fn.program.num_graphs == 0  # the CPU runs it eagerly
    assert sb.fused_swin_block_cst.plain_calls > 0  # through the wrappers
    assert got.device.type == "cpu" and not got.requires_grad
    close(got, want, SR_HEAD_TOL if sr else TOL)


def test_grad_transform_runs_before_the_update():
    """A transform that doubles the gradients gives the step of doubled
    gradients, bit for bit."""
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 3)).astype(np.float32)
    g = torch.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    a, b = (torch.nn.Parameter(torch.from_numpy(p0.copy())) for _ in range(2))
    tx_a, tx_b = AdamW([a], 1e-2), AdamW([b], 1e-2)
    tx_a.grad_transform = lambda grads: [x.mul_(2.0) for x in grads]
    for _ in range(3):
        a.grad, b.grad = g.clone(), 2.0 * g
        tx_a.step()
        tx_b.step()
        assert torch.equal(a, b) and torch.equal(a.grad, b.grad)


DATA_PARALLEL_STEP = r"""
import sys, numpy as np, torch, torch.distributed as dist
from swinwnet_tpu_torch.models import SwinWNet
from swinwnet_tpu_torch.parallel import data_parallel, initialize_multihost, make_mesh
from swinwnet_tpu_torch.train import TrainState, combined_loss, make_stage1_step, masked_adamw
torch.set_num_threads(1)
initialize_multihost("localhost:" + sys.argv[1], num_processes=1, process_id=0, device="cpu")
mesh = make_mesh()
rng = np.random.default_rng(3)
images = rng.uniform(0, 1e3, (2, 2, 20, 30)).astype(np.float32)
masks = (rng.uniform(size=(2, 20, 30)) > 0.6).astype(np.float32)
runs = []
for parallel in (False, True):
    m = SwinWNet(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1),
                 num_heads=(3, 3, 3, 3), window_size=5, device="cpu", generator=torch.Generator().manual_seed(2))
    tx = masked_adamw(m, "stage1", 1e-3)
    if parallel:
        assert data_parallel(tx, mesh) is tx and tx.grad_transform is not None
    state, loss = make_stage1_step(m, tx, combined_loss)(TrainState.create(m, tx), images, masks)
    runs.append((float(loss), {k: p.detach().clone() for k, p in m.named_parameters()}))
assert runs[0][0] == runs[1][0]
assert all(torch.equal(runs[0][1][k], v) for k, v in runs[1][1].items())
dist.destroy_process_group()
print("DATA_PARALLEL_OK")
"""


def test_data_parallel_over_one_rank_is_the_plain_step():
    res = subprocess.run([sys.executable, "-c", DATA_PARALLEL_STEP, str(free_port())], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert "DATA_PARALLEL_OK" in res.stdout, res.stdout + res.stderr


@pytest.fixture(scope="module")
def dp_steps():
    """Two odd steps over two gloo ranks, and the same two steps in this
    process on the full batch."""
    sharded = dryrun_multichip(2, device="cpu", hw=HW, model_kw=TINY_WNET, seed=SEED, steps=DP_STEPS)
    model = SwinWNet(**TINY_WNET, device="cpu", generator=torch.Generator().manual_seed(SEED))
    tx = masked_adamw(model, "stage3", LR)
    state = TrainState.create(model, tx)
    _, odd_step, _, _ = make_stage3_steps(model, tx, combined_loss, smooth_l1_loss, *WEIGHTS)
    images, masks = dryrun_batch(2, HW)
    for _ in range(DP_STEPS):
        state, aux = odd_step(state, images, masks)
    grads = {k: p.grad for k, p in model.named_parameters() if p.grad is not None}
    return sharded, model, grads, {k: float(v) for k, v in aux.items()}


def test_two_steps_over_two_ranks_equal_one_process(dp_steps):
    sharded, model, grads, aux = dp_steps
    assert len(sharded["steps_ms"]) == DP_STEPS and sharded["step_ms"] == sharded["steps_ms"][-1]
    assert abs(sharded["loss"] - aux["loss"]) <= 1e-5 * abs(aux["loss"])
    assert abs(sharded["iou_hr"] - aux["iou_hr"]) <= 1e-6
    assert sharded["grads"].keys() == grads.keys() and len(grads) > 100
    off = n = 0
    for k, p in model.named_parameters():
        g = grads[k]
        assert (sharded["grads"][k] - g).abs().max() <= 1e-3 * g.abs().max(), k
        diff = (sharded["params"][k] - p.detach()).abs()
        assert bool((diff <= 2 * DP_STEPS * LR).all()), k
        off += int((diff > 1e-6 + 1e-5 * p.detach().abs()).sum())
        n += p.numel()
    assert off < 1e-3 * n


# ---- on the card ----


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", ["unet", "sr"])
def test_baseline_replays_equal_eager_calls(cuda, monkeypatch, name, dtype):
    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    sr = name == "sr"
    cls, c, factory = (SwinUNetSR, 1, make_sr_fn) if sr else (SwinUNet, 2, make_segmentation_fn)
    model = cls(in_chans=c, **TINY, fused_blocks=True, dtype=dtype, device="cuda",
                generator=torch.Generator().manual_seed(0))
    fn = factory(model)
    rng = np.random.default_rng(0)
    x1, x2 = (torch.from_numpy(rng.uniform(0, 1e3, (2, c, S, S)).astype(np.float32)).to(cuda) for _ in range(2))
    fn(x1)  # the warm-up and the capture
    before = [k.launches for k in sb.KERNELS]
    a = fn(x1)
    torch.cuda.synchronize()
    per_replay = [k.launches - b for k, b in zip(sb.KERNELS, before)]
    with graphs.run_eagerly():
        before = [k.launches for k in sb.KERNELS]
        eager = fn(x1)
        per_call = [k.launches - b for k, b in zip(sb.KERNELS, before)]
        eager2 = fn(x2)
    assert fn.program.num_graphs == 1 and per_replay == per_call and sum(per_replay) > 0
    assert torch.equal(a, eager) and torch.equal(fn(x2), eager2)
