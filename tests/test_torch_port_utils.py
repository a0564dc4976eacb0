"""The port's debugging and profiling aids (swinwnet_tpu_torch/utils/
debug.py, profiling.py): `nan_check` raises at the first non-finite result
of a forward (naming the module) and of a backward; `assert_finite_pytree`
names the first non-finite path of a state dict or an optimizer state;
`trace_context` writes a Chrome trace (the spans are held in
test_torch_port_tracing.py)."""

import json

import pytest
import torch
from torch import nn

from swinwnet_tpu_torch.utils import assert_finite_pytree, nan_check, trace_context

torch.set_num_threads(1)


def small_model():
    torch.manual_seed(0)
    return nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))


def test_nan_check_raises_on_a_nan_forward_and_names_the_module():
    model = small_model()
    x = torch.ones(3, 4)
    with nan_check(model):
        model(x)  # finite: no error
    with torch.no_grad():
        model[2].weight[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="output of 2"):
        with nan_check(model):
            model(x)
    assert not model[0]._forward_hooks  # the hooks are gone after the block
    model(x)


def test_nan_check_raises_on_a_nan_backward():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan"):
        with nan_check():
            torch.sqrt(x * 0.0).sum().backward()  # d/dx sqrt at 0 is inf, times 0 is nan


def test_assert_finite_pytree_names_the_bad_path():
    model = small_model()
    opt = torch.optim.AdamW(model.parameters())
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    assert_finite_pytree(model.state_dict(), "params")
    assert_finite_pytree(opt.state_dict(), "opt")
    with torch.no_grad():
        model[2].bias[1] = float("inf")
    with pytest.raises(FloatingPointError, match=r"non-finite values in params at 2\.bias"):
        assert_finite_pytree(model.state_dict(), "params")
    opt.state_dict()["state"][0]["exp_avg"][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="opt at state/0/exp_avg"):
        assert_finite_pytree(opt.state_dict(), "opt")
    assert_finite_pytree({"steps": [torch.tensor(3), (1.0, "a")]}, "ints and others pass")


def test_trace_context_writes_a_chrome_trace(tmp_path):
    with trace_context(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with trace_context(None):
        pass
