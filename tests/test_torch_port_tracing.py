"""The port's tracing (swinwnet_tpu_torch/utils/profiling.py and its users):
spans at the serving and training entries and in `Program`, nested by
parent and request id; the fixed ring; records made under `torch.profiler`
flagged and shown in its Chrome trace as nested user annotations; the
LayerNorm and cast counters of `models/layers.py` against counts derived
from the models' structure; `write_spans`. The cases marked `cuda` capture
and replay on the card (`python -m pytest --noconftest
tests/test_torch_port_tracing.py -m cuda`): a replay's counts against the
eager call's, its device records read without a host sync."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch import nn

from swinwnet_tpu_torch.core import graphs
from swinwnet_tpu_torch.models import SwinUNet, SwinWNet
from swinwnet_tpu_torch.models.layers import _MultiheadAttentionParams
from swinwnet_tpu_torch.ops import swin_block as sb
from swinwnet_tpu_torch.pipelines import (
    SwinWNetInference,
    inference_stages,
    make_inference_fn,
    make_segmentation_fn,
    make_split_inference_fn,
)
from swinwnet_tpu_torch.utils import profiling
from swinwnet_tpu_torch.utils.profiling import span, spans, trace_context, write_spans

torch.set_num_threads(1)

TINY = dict(patch_size=2, in_chans=1, embed_dim=12, depths=(1, 1, 1, 1), num_heads=(3, 6, 12, 24), window_size=5)
S = 40
# how often the 8-stage pipeline runs each of SwinWNet's parts: the shared
# embedding thrice, the segmentator twice (segment_1, segment_2), the rest once
USES = {"patch_embed": 3, "segmentator_encoder": 2, "segmentator_bottleneck": 2, "segmentator_decoder": 2,
        "segmentator_head": 2, "ca_seg_to_sr": 1, "ca_sr_to_seg": 1, "upscaler_encoder": 1,
        "upscaler_bottleneck": 1, "upscaler_decoder": 1, "upscaler_head": 1}


def wnet(dtype="float32", device="cpu", **kw):
    return SwinWNet(**TINY, error_matrix=True, dtype=dtype, device=device,
                    generator=torch.Generator().manual_seed(3), **kw).eval()


def images(b=1, c=2, seed=0):
    return np.random.default_rng(seed).uniform(0, 1e3, (b, c, S, S)).astype(np.float32)


def since():
    """A start time before the records a test makes (the ring is shared)."""
    return time.perf_counter_ns()


def children(records, parent):
    return [r for r in records if r.parent == parent.seq]


# ---- spans -------------------------------------------------------------------


def test_a_serving_request_is_one_request_of_nested_spans():
    infer = SwinWNetInference(wnet())
    t0 = since()
    infer(images())
    infer(images(seed=1))
    records = spans(t0)
    roots = [r for r in records if r.name == "serve.request"]
    assert len(roots) == 2 and all(r.parent == -1 for r in roots)
    assert roots[0].request != roots[1].request
    for root in roots:
        kids = children(records, root)
        assert [r.name for r in kids] == ["serve.to_device", "program.key", "program.eager"]
        assert all(r.request == root.request for r in kids)
        assert all(root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns for r in kids)
        assert [r.arg for r in kids] == [None, "inference_stages", "inference_stages"]
        assert not any(r.profiled for r in kids + [root])
    assert {r.request for r in records} == {r.request for r in roots}


def test_a_training_step_is_one_request_of_nested_spans():
    from swinwnet_tpu_torch.train import FullModelTrainer

    trainer = FullModelTrainer(wnet(), [None] * 4, num_epochs=1, warmup_epochs=0, verbose=False)
    masks = (np.random.default_rng(2).uniform(size=(1, S, S)) > 0.5).astype(np.float32)
    t0 = since()
    trainer.train_step(images(c=1), masks, even=True)
    trainer.train_step(images(c=1, seed=1), masks, even=False)
    records = spans(t0)
    roots = [r for r in records if r.name == "train.step"]
    assert len(roots) == 2 and all(r.parent == -1 for r in roots)
    for root, fn in zip(roots, ("stage3_even_loss.step", "stage3_odd_loss.step")):
        kids = children(records, root)
        assert [r.name for r in kids] == ["train.batch", "program.key", "program.eager"]
        assert [r.arg for r in kids[1:]] == [fn, fn]
        assert all(r.request == root.request for r in kids)


def test_segmentation_and_split_programs_carry_their_functions_names():
    t0 = since()
    seg = make_segmentation_fn(SwinUNet(**TINY, device="cpu"))
    seg(images(c=1))
    split = make_split_inference_fn(wnet())
    split(torch.from_numpy(images()))
    records = spans(t0)
    assert seg.program.name == "make_segmentation_fn.segment"
    root = next(r for r in records if r.name == "serve.request")
    assert {r.arg for r in children(records, root)} == {None, "make_segmentation_fn.segment"}
    assert [r.arg for r in records if r.name == "program.eager"][1:] == ["stage_a", "stage_b", "stage_c"]
    assert graphs.name_of(make_inference_fn(wnet()).fn) == "inference_stages"


def test_each_thread_keeps_its_own_open_spans():
    seen = {}

    def worker(key):
        with span("outer") as outer:
            with span("inner") as inner:
                seen[key] = (outer.seq, outer.request, inner.parent, inner.request)

    with span("main"):
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    (o0, r0, p0, q0), (o1, r1, p1, q1) = seen[0], seen[1]
    assert (p0, q0) == (o0, r0) and (p1, q1) == (o1, r1) and r0 != r1


def test_the_ring_wraps_without_growing(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 8)
    monkeypatch.setattr(profiling, "_MASK", 7)
    monkeypatch.setattr(profiling, "_ring", [None] * 8)
    t0 = since()
    with span("root") as root:
        for k in range(19):
            with span(f"s{k}"):
                pass
    assert len(profiling._ring) == 8
    records = spans(t0)  # the last 8 to end, in order of opening
    assert [r.name for r in records] == ["root"] + [f"s{k}" for k in range(12, 19)]
    assert [r.seq for r in records] == [root.seq] + list(range(root.seq + 13, root.seq + 20))
    assert all(r.parent == root.seq for r in records[1:])


def test_the_real_ring_is_allocated_once():
    ring = profiling._ring
    assert len(ring) == profiling.RING == 1 << 18
    for _ in range(3):
        with span("x"):
            pass
    assert profiling._ring is ring and len(ring) == profiling.RING


def test_records_made_under_the_profiler_are_flagged():
    from torch.profiler import ProfilerActivity, profile

    t0 = since()
    with span("before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with span("during", "fn"):
            pass
    with span("after"):
        pass
    flags = {r.name: r.profiled for r in spans(t0)}
    assert flags == {"before": False, "during": True, "after": False}


def test_spans_nest_as_user_annotations_in_the_chrome_trace(tmp_path):
    infer = SwinWNetInference(wnet())
    infer(images())
    with trace_context(str(tmp_path)):
        infer(images(seed=1))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"}
    assert {"serve.request", "serve.to_device", "program.key", "program.eager"} <= set(ours)
    root = ours["serve.request"]
    for name in ("serve.to_device", "program.key", "program.eager"):
        e = ours[name]
        assert root["ts"] <= e["ts"] and e["ts"] + e["dur"] <= root["ts"] + root["dur"], name
    ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    eager = ours["program.eager"]
    assert any(eager["ts"] <= e["ts"] <= eager["ts"] + eager["dur"] for e in ops)
    lines = [json.loads(x) for x in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert [x["name"] for x in lines][:2] == ["serve.request", "serve.to_device"]
    assert all(x["profiled"] for x in lines)


def test_write_spans_round_trips(tmp_path):
    t0 = since()
    with span("a", "f"):
        with span("b"):
            pass
    path = tmp_path / "spans.jsonl"
    assert write_spans(str(path), t0) == 2
    back = [profiling.Span(**json.loads(x)) for x in path.read_text().splitlines()]
    assert back == spans(t0)
    assert back[1].parent == back[0].seq and back[0].arg == "f" and back[1].arg is None


# ---- counters ------------------------------------------------------------------


def _weight_casts(module: nn.Module) -> int:
    """A bf16 forward's parameter casts: each Linear's and conv's weight and
    bias, and the cross-attention's three in-projection slices (its bias
    stays fp32)."""
    n = 0
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            n += 1 + (m.bias is not None)
        elif isinstance(m, _MultiheadAttentionParams):
            n += 3
    return n


def _layer_norms(module: nn.Module) -> int:
    return sum(isinstance(m, nn.LayerNorm) for m in module.modules())


def _counted(fn):
    before = profiling.counters()
    with torch.no_grad():
        fn()
    after = profiling.counters()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("kind", ["SwinWNet", "SwinUNet"])
def test_layer_norm_and_weight_casts_match_the_models_structure(kind):
    if kind == "SwinWNet":
        model = wnet("bfloat16")
        got = _counted(lambda: inference_stages(model, torch.from_numpy(images())))
        parts = dict(model.named_children())
        assert set(parts) == set(USES)
        want_ln = sum(USES[n] * _layer_norms(m) for n, m in parts.items())
        want_w = sum(USES[n] * _weight_casts(m) for n, m in parts.items())
    else:
        model = SwinUNet(**TINY, dtype="bfloat16", device="cpu").eval()
        got = _counted(lambda: model(torch.from_numpy(images(c=1))))
        want_ln, want_w = _layer_norms(model), _weight_casts(model)
    assert got["layer_norm"] == want_ln > 0
    assert got["weight_cast"] == want_w > 0
    assert got["activation_cast"] > 0


def test_fp32_casts_nothing_and_counters_are_registered():
    model = wnet("float32")
    got = _counted(lambda: inference_stages(model, torch.from_numpy(images())))
    assert got["weight_cast"] == 0 and got["activation_cast"] == 0 and got["layer_norm"] > 0
    names = set(profiling.counters())
    assert {k.__name__ for k in sb.KERNELS} | {"layer_norm", "weight_cast", "activation_cast",
                                                "graph_events_missed"} <= names


# ---- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_replay_counts_what_the_eager_call_counts(cuda, monkeypatch):
    from swinwnet_tpu_torch.models import BasicLayer

    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    model = wnet("bfloat16", device=cuda, fused_blocks=True)
    fn = make_inference_fn(model)
    x = torch.from_numpy(images()).to(cuda)
    eager = _counted(lambda: inference_stages(model, x))
    fn(x)
    replay = _counted(lambda: fn(x))
    captured = profiling.graph_counts()["inference_stages"][-1]
    assert replay == eager == captured
    assert eager["layer_norm"] > 0 and eager["weight_cast"] > 0 and eager["fused_swin_block_cst"] > 0


@pytest.mark.cuda
def test_device_records_are_read_at_the_next_call_without_a_sync(cuda, monkeypatch):
    model = wnet("bfloat16", device=cuda)
    fn = make_inference_fn(model)
    x = torch.from_numpy(images()).to(cuda)
    fn(x)  # warm-up and capture
    t0 = since()
    missed = profiling.counters()["graph_events_missed"]
    for _ in range(3):
        fn(x)
        torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("the program waited on the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse)
    fn(x)
    monkeypatch.undo()
    records = spans(t0)
    launches = [r for r in records if r.name == "program.launch"]
    waits = [r for r in records if r.name == "device.launch_wait"]
    runs = [r for r in records if r.name == "device.graph"]
    assert len(launches) == 4 and len(waits) == len(runs) == 3
    assert profiling.counters()["graph_events_missed"] == missed
    for launch, wait, run in zip(launches, waits, runs):
        assert wait.parent == run.parent == launch.seq and wait.request == launch.request
        assert wait.arg == "inference_stages"
        assert wait.end_ns - wait.start_ns >= 0 and run.end_ns - run.start_ns > 0
        assert wait.end_ns == run.start_ns


@pytest.mark.cuda
def test_capture_happens_once_per_signature(cuda):
    fn = make_inference_fn(wnet("bfloat16", device=cuda))
    t0 = since()
    for b in (1, 1, 2, 1, 2):
        fn(torch.from_numpy(images(b)).to(cuda))
    names = [r.name for r in spans(t0) if r.name.startswith("program.") and r.name != "program.key"]
    assert names.count("program.capture") == 2 and names.count("program.launch") == 3
