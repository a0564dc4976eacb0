"""PatchExpanding's shuffle and LayerNorm kernel (swinwnet_tpu_torch/ops/
expand_norm.py, csrc/expand_norm.cu) and its route in `PatchExpanding`.

On the CPU: the plain version against the shuffle's copy then `layer_norm`,
bit for bit, at the five widths of SwinWNet's expansions, odd grids
included; the route (the wrapper under `torch.inference_mode` only, the
plain version under autograd and `no_grad`), by the counters; the
counter's registration.
The cases marked `cuda` run on the card (`python -m pytest --noconftest
tests/test_torch_port_expand_norm.py -m cuda`): the kernel against the plain
version at the serving path's shapes, within one bf16 ulp of the plain value
(the two differ only in the order of the fp32 sums; the ulp taken at no
less than 2^-8); a captured serving program's counts a replay; the
wrapper's refusals."""

import pytest
import torch
from torch import nn

from swinwnet_tpu_torch.models import SwinUNet, SwinWNet
from swinwnet_tpu_torch.models import layers
from swinwnet_tpu_torch.models.layers import PatchExpanding, layer_norm, linear
from swinwnet_tpu_torch.ops.expand_norm import patch_expand_norm, patch_expand_norm_plain
from swinwnet_tpu_torch.utils import profiling

torch.set_num_threads(1)

# C/2 of SwinWNet's expansions (the decoder's 192, 96, 48; the SR head's 24,
# 12) and the token grid each expands at the 250 x 480 detector
WIDTHS = {192: (16, 30), 96: (32, 60), 48: (63, 120), 24: (125, 240), 12: (250, 480)}
DTYPES = [torch.bfloat16, torch.float32]


def _norm(c: int, seed: int) -> nn.LayerNorm:
    g = torch.Generator().manual_seed(seed)
    ln = nn.LayerNorm(c)
    with torch.no_grad():
        ln.weight.copy_(torch.rand(c, generator=g) + 0.5)
        ln.bias.copy_(torch.randn(c, generator=g) * 0.1)
    return ln


def _y(B, H, W, c, dtype, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(B, H, W, 4 * c, generator=g, device=device) * 2 + 0.5).to(dtype)


def _counted(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: after[k] - before[k] for k in after}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", sorted(WIDTHS))
def test_plain_is_the_layers_composition_bit_for_bit(c, dtype):
    B, H, W = 2, 5, 7
    y, ln = _y(B, H, W, c, dtype, c), _norm(c, c + 1)
    x = y.reshape(B, H, W, 2, 2, c).permute(0, 1, 3, 2, 4, 5).reshape(B, 2 * H, 2 * W, c)
    want = layer_norm(x, ln, dtype)
    got = patch_expand_norm_plain(y, ln, dtype)
    assert got.dtype == dtype and got.shape == (B, 2 * H, 2 * W, c)
    assert torch.equal(got, want)
    out, counts = _counted(lambda: patch_expand_norm(y, ln, dtype))  # a CPU y runs the plain version
    assert torch.equal(out, want) and counts["patch_expand_norm"] == 0


def _expanding(dtype=torch.bfloat16, C=48, seed=0):
    torch.manual_seed(seed)
    m = PatchExpanding(C, dtype)
    with torch.no_grad():
        m.norm.weight.copy_(torch.rand(C // 2) + 0.5)
    return m


def test_under_grad_the_module_takes_the_layers_path():
    m = _expanding()
    x = torch.randn(1, 3, 5, 48, requires_grad=True)
    out, counts = _counted(lambda: m(x))
    assert counts["layer_norm"] == 1 and counts["patch_expand_norm"] == 0 and counts["activation_cast"] == 3
    out.float().sum().backward()
    assert x.grad is not None and m.expand.weight.grad is not None and m.norm.weight.grad is not None


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad"])
def test_on_the_cpu_without_grad_the_module_takes_the_layers_path(mode):
    m = _expanding(seed=1)
    x = torch.randn(2, 3, 5, 48)
    with getattr(torch, mode)():
        out, counts = _counted(lambda: m(x))
    assert counts["layer_norm"] == 1 and counts["patch_expand_norm"] == 0
    with torch.no_grad():
        y = linear(x, m.expand, torch.bfloat16)
    assert torch.equal(out, patch_expand_norm_plain(y, m.norm, torch.bfloat16))


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference_mode"])
def test_the_module_calls_the_wrapper_only_under_inference_mode(monkeypatch, mode):
    """The RL and stage-2 steps' no_grad parts and the trainers' evals run
    the plain version, as training does; the serving programs, under
    inference_mode, the wrapper."""
    calls = []

    def spy(y, ln, dtype):
        calls.append(tuple(y.shape))
        return patch_expand_norm(y, ln, dtype)

    monkeypatch.setattr(layers, "patch_expand_norm", spy)
    m = _expanding(seed=3)
    x = torch.randn(1, 3, 5, 48)
    with torch.inference_mode() if mode == "inference_mode" else torch.set_grad_enabled(mode == "grad"):
        out, counts = _counted(lambda: m(x))
    assert calls == ([(1, 3, 5, 96)] if mode == "inference_mode" else [])
    assert counts["layer_norm"] == 1 and out.shape == (1, 6, 10, 24)


def test_the_counter_is_registered():
    assert "patch_expand_norm" in profiling.counters()
    assert patch_expand_norm in profiling.COUNTERS


def test_a_width_that_does_not_match_the_norm_is_refused():
    with pytest.raises(ValueError, match=r"\[B, H, W, 48\]"):
        patch_expand_norm(torch.zeros(1, 2, 2, 40), _norm(12, 0), torch.float32)


# ---- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each value, 2^(e - 8) for |v| in [2^(e-1), 2^e),
    taken at no less than 2^-8 in magnitude: below it the affine step's
    cancellation (w x + b near 0) leaves a value whose fp32 rounding, about
    1e-7 of its O(1) terms, is itself more than one of its bf16 ulps."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -8))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _within_one_ulp(out: torch.Tensor, want: torch.Tensor) -> None:
    excess = (out.float() - want.float()).abs() / _bf16_ulp(want)
    worst = int(excess.argmax())
    assert excess.max().item() <= 1, (f"{excess.max().item():.2f} ulps at {worst}: kernel "
                                      f"{out.flatten()[worst].item()}, plain {want.flatten()[worst].item()}")


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 64])
@pytest.mark.parametrize("c", sorted(WIDTHS))
def test_kernel_matches_plain_at_the_serving_shapes(cuda, c, B):
    H, W = WIDTHS[c]
    y, ln = _y(B, H, W, c, torch.bfloat16, c + B, cuda), _norm(c, c).to(cuda)
    out, counts = _counted(lambda: patch_expand_norm(y, ln, torch.bfloat16))
    torch.cuda.synchronize()
    assert counts["patch_expand_norm"] == 1 and out.dtype == torch.bfloat16 and out.shape == (B, 2 * H, 2 * W, c)
    _within_one_ulp(out, patch_expand_norm_plain(y, ln, torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 6, 12, 24, 48, 96, 192])
def test_kernel_matches_plain_in_fp32_and_at_narrow_widths(cuda, c):
    """fp32 at torch.testing's fp32 tolerance; bf16 at the tiny models'
    widths (3 and 6, 2- and 4-byte vectors)."""
    y, ln = _y(3, 7, 9, c, torch.float32, c, cuda), _norm(c, c).to(cuda)
    torch.testing.assert_close(patch_expand_norm(y, ln, torch.float32), patch_expand_norm_plain(y, ln, torch.float32))
    yb = y.to(torch.bfloat16)
    _within_one_ulp(patch_expand_norm(yb, ln, torch.bfloat16), patch_expand_norm_plain(yb, ln, torch.bfloat16))


PUBLISHED = dict(patch_size=2, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,expansions,layer_norms", [("SwinWNet", 11, 80), ("SwinUNet", 3, 24)])
def test_a_serving_replay_counts_the_kernel_in_place_of_layer_norms(cuda, monkeypatch, kind, expansions,
                                                                    layer_norms):
    """The published widths, every C <= 96 level fused (the 128-window gate
    lifted, as the full detector passes it): a replay adds the expansions'
    launches, and the LayerNorms left to torch."""
    from swinwnet_tpu_torch.models import BasicLayer
    from swinwnet_tpu_torch.pipelines import make_inference_fn, make_segmentation_fn

    monkeypatch.setattr(BasicLayer, "min_windows", 1)
    g = torch.Generator().manual_seed(5)
    if kind == "SwinWNet":
        model = SwinWNet(**PUBLISHED, in_chans=1, error_matrix=True, fused_blocks=True, dtype="bfloat16",
                         device=cuda, generator=g).eval()
        fn, x = make_inference_fn(model), torch.rand(2, 2, 50, 60, device=cuda) * 1e3
    else:
        model = SwinUNet(**PUBLISHED, in_chans=1, fused_blocks=True, dtype="bfloat16", device=cuda).eval()
        fn, x = make_segmentation_fn(model), torch.rand(2, 1, 50, 60, device=cuda)
    _, eager = _counted(lambda: fn(x))  # the warm-up and capture
    _, replay = _counted(lambda: fn(x))
    torch.cuda.synchronize()
    assert replay["patch_expand_norm"] == expansions and replay["layer_norm"] == layer_norms
    assert eager["patch_expand_norm"] == expansions


@pytest.mark.cuda
def test_under_grad_on_the_card_the_module_takes_the_layers_path(cuda):
    m = _expanding(seed=2).to(cuda)
    x = torch.randn(2, 3, 5, 48, device=cuda)
    out, counts = _counted(lambda: m(x))
    assert counts["layer_norm"] == 1 and counts["patch_expand_norm"] == 0 and out.requires_grad
    with torch.no_grad():
        _, counts = _counted(lambda: m(x))
    assert counts["layer_norm"] == 1 and counts["patch_expand_norm"] == 0
    with torch.inference_mode():
        _, counts = _counted(lambda: m(x))
    assert counts["layer_norm"] == 0 and counts["patch_expand_norm"] == 1


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    ln = _norm(24, 0).to(cuda)
    y = torch.randn(1, 4, 6, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        patch_expand_norm(y.transpose(1, 2), ln, torch.bfloat16)
    with pytest.raises(ValueError, match="compute dtype"):
        patch_expand_norm(y, ln, torch.float32)
    with pytest.raises(ValueError, match="float32 tensor"):
        patch_expand_norm(y, _norm(24, 0).to(cuda).to(torch.bfloat16), torch.bfloat16)
