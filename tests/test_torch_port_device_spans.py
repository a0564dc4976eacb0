"""Device spans (`utils.profiling.device_span`): run eagerly they are host
spans; captured in a program's graph they are pairs of CUDA events, and
each replay gives `device.<name>` records inside its `device.graph`. The
REINFORCE step's phases and the distance gate are such spans, and the
counters `rl_reward` and `distance_gate` count them. The cases marked
`cuda` capture and replay on the card (`python -m pytest --noconftest
tests/test_torch_port_device_spans.py -m cuda`)."""

import time

import numpy as np
import pytest
import torch

from swinwnet_tpu_torch.models import AlphaPolicy, SwinWNet
from swinwnet_tpu_torch.pipelines import make_inference_fn
from swinwnet_tpu_torch.train import RLTrainer
from swinwnet_tpu_torch.utils import profiling
from swinwnet_tpu_torch.utils.profiling import device_span, span, spans

torch.set_num_threads(1)

RL_PHASES = ["rl.preprocess", "rl.rollout", "rl.reward", "physics.distance_gate", "rl.policy_update", "rl.model_update"]
GRID = np.linspace(0.05318052, 7.49710258, 64)
H, W = 32, 64


def tiny(device="cpu"):
    return SwinWNet(patch_size=2, in_chans=1, error_matrix=True, embed_dim=12, depths=(1, 1, 1, 1),
                    num_heads=(3, 6, 12, 24), window_size=5, device=device,
                    generator=torch.Generator().manual_seed(3))


def trainer(device="cpu", dtype=None):
    return RLTrainer(tiny(device), AlphaPolicy(device=device, generator=torch.Generator().manual_seed(4)), (),
                     d_centers=GRID, compute_dtype=dtype, seed=5, verbose=False)


def images(seed=0, device="cpu"):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1e3, (2, 1, H, W)).astype(np.float32)).to(device)


def since():
    return time.perf_counter_ns()


def test_an_eager_device_span_is_a_host_span():
    t0 = since()
    with span("outer"):
        with device_span("inner"):
            pass
    records = spans(t0)
    outer, inner = (next(r for r in records if r.name == n) for n in ("outer", "inner"))
    assert inner.parent == outer.seq and inner.request == outer.request
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


def test_an_eager_rl_step_records_its_phases_once_and_counts_them():
    t = trainer()
    before = profiling.counters()
    t0 = since()
    for k in range(2):
        t.train_step(images(k))
    after = profiling.counters()
    records = spans(t0)
    assert after["rl_reward"] - before["rl_reward"] == after["distance_gate"] - before["distance_gate"] == 2
    roots = [r for r in records if r.name == "train.step"]
    for root in roots:
        mine = [r for r in records if r.request == root.request and r.name in RL_PHASES]
        assert sorted(r.name for r in mine) == sorted(RL_PHASES)
        by_name = {r.name: r for r in mine}
        assert by_name["physics.distance_gate"].parent == by_name["rl.reward"].seq
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in mine)
    assert not [r for r in records if r.name.startswith("device.")]


def test_a_device_span_outside_a_capture_adds_no_pair():
    with profiling.device_spans() as pairs:
        pass
    with device_span("outside"):
        pass
    assert pairs == []


# ---- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_replayed_rl_steps_nest_their_device_spans_in_the_graph(cuda, dtype):
    t = trainer(cuda, dtype)
    t0 = since()
    for k in range(5):  # the capture, then four replays; the fifth call reads the fourth's events
        t.train_step(images(k, cuda))
    records = spans(t0)
    counts = profiling.graph_counts()["make_rl_train_step.run"][-1]
    assert counts["rl_reward"] == counts["distance_gate"] == 1
    launches = [r for r in records if r.name == "program.launch"]
    graphs_ = {r.parent: r for r in records if r.name == "device.graph"}
    assert len(launches) == 4 and len(graphs_) == 3
    for name in RL_PHASES:
        got = [r for r in records if r.name == "device." + name]
        per_replay = counts["rl_reward"] if name != "physics.distance_gate" else counts["distance_gate"]
        assert len(got) == per_replay * len(graphs_), name
        for r in got:
            g = graphs_[r.parent]
            assert g.start_ns <= r.start_ns <= r.end_ns <= g.end_ns, name
            assert r.end_ns > r.start_ns
    reward = {r.parent: r for r in records if r.name == "device.rl.reward"}
    for gate in (r for r in records if r.name == "device.physics.distance_gate"):
        assert reward[gate.parent].start_ns <= gate.start_ns <= gate.end_ns <= reward[gate.parent].end_ns
    # the host spans are the capture's warm-up alone: a replay runs no Python
    assert sorted(r.name for r in records if r.name in RL_PHASES) == sorted(RL_PHASES)


@pytest.mark.cuda
def test_the_serving_graph_records_no_device_spans(cuda):
    fn = make_inference_fn(tiny(cuda).eval())
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1e3, (1, 2, 40, 40)).astype(np.float32)).to(cuda)
    t0 = since()
    for _ in range(4):
        fn(x)
        torch.cuda.synchronize()  # each replay's events complete before the next call reads them
    records = spans(t0)
    assert len([r for r in records if r.name == "device.graph"]) == 2
    assert not [r for r in records if r.name.startswith("device.") and r.name not in
                ("device.graph", "device.launch_wait")]
    assert fn._graphs and all(g.spans == [] for g in fn._graphs.values())
    counts = profiling.graph_counts()["inference_stages"][-1]
    assert counts["rl_reward"] == counts["distance_gate"] == 0
