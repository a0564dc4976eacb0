"""The unfused levels' window attention kernel (swinwnet_tpu_torch/ops/
window_attention.py, csrc/window_attention.cu) and its route in
`WindowAttention`.

On the CPU: the route (`WindowAttention.kernel_route`: off the CPU, bf16,
under `torch.inference_mode`, no mask, no attention dropout drawn, head
width 16 or 32, N <= 32), never under grad, in fp32, shifted or with dropout
drawn; the module calling the wrapper once, before `attn_chunk`'s split; the
plain version against `_attend` bit for bit; the plain version against the
JAX package's `attend_matmul` in fp32, at SwinWNet's four unfused shapes on
small batches; the counter's registration.
The cases marked `cuda` run on the card (`python -m pytest --noconftest
tests/test_torch_port_window_attention.py -m cuda`): the kernel against the
plain version at the four shapes with B = 64's window counts (and at other
token counts and ragged window counts), within the bound that the rounding
of the probabilities to bf16 leaves (see `_within_rounding`); a captured
serving program's counts a replay, and its replay against its eager call
bit for bit; the wrapper's refusals."""

import pytest
import torch

from swinwnet_tpu_torch.models import layers
from swinwnet_tpu_torch.models.layers import WindowAttention, linear
from swinwnet_tpu_torch.ops.window_attention import takes, window_attention, window_attention_plain
from swinwnet_tpu_torch.utils import profiling

torch.set_num_threads(1)

N = 25
# SwinWNet's unfused levels in bf16 serving: (C, heads) -> windows a level at B = 64
SHAPES = {(384, 24): 1536, (192, 12): 5376, (384, 12): 5376, (192, 6): 19968}


def _module(C, nH, dtype=torch.bfloat16, seed=0, device="cpu", **kw):
    g = torch.Generator().manual_seed(seed)
    m = WindowAttention(C, 5, nH, True, dtype, **kw)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * (p.shape[-1] ** -0.5 if p.dim() == 2 else 0.5))
    return m.to(device)


def _x(Bw, C, dtype=torch.bfloat16, seed=1, device="cpu", n=N):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(Bw, n, C, generator=g).to(device=device, dtype=dtype)


def _counted(fn):
    before = profiling.counters()
    out = fn()
    after = profiling.counters()
    return out, {k: after[k] - before[k] for k in after}


# ---- the route ---------------------------------------------------------------


def _route(m, x, mask=None, deterministic=True, mode="inference_mode"):
    ctx = torch.inference_mode() if mode == "inference_mode" else torch.set_grad_enabled(mode == "grad")
    with ctx:
        return m.kernel_route(x, mask, deterministic)


@pytest.mark.parametrize("C,nH", sorted(SHAPES))
def test_the_route_engages_in_bf16_serving_off_the_cpu(C, nH):
    m = _module(C, nH, device="meta")
    assert _route(m, torch.empty(8, N, C, device="meta", dtype=torch.bfloat16))


@pytest.mark.parametrize("case", ["cpu", "fp32", "grad", "no_grad", "shifted", "dropout drawn", "head width 8",
                                  "head width 64", "36 tokens"])
def test_the_route_stays_off_elsewhere(case):
    C, nH, n = {"head width 8": (24, 3, N), "head width 64": (384, 6, N), "36 tokens": (192, 12, 36)}.get(
        case, (192, 12, N))
    m = _module(C, nH, torch.float32 if case == "fp32" else torch.bfloat16, device="meta",
                attn_drop=0.1 if case == "dropout drawn" else 0.0)
    x = torch.empty(8, n, C, device="cpu" if case == "cpu" else "meta", dtype=torch.bfloat16)
    mask = torch.zeros(4, n, n, device=x.device) if case == "shifted" else None
    mode = case if case in ("grad", "no_grad") else "inference_mode"
    assert not _route(m, x, mask, deterministic=case != "dropout drawn", mode=mode)


def test_dropout_rates_alone_leave_the_route_on():
    """A deterministic forward of a model built with attention dropout computes
    as rate 0, so the kernel takes it."""
    m = _module(192, 12, device="meta", attn_drop=0.1)
    assert _route(m, torch.empty(8, N, 192, device="meta", dtype=torch.bfloat16), deterministic=True)


def test_the_module_calls_the_wrapper_once_before_the_chunks(monkeypatch):
    calls = []

    def spy(qkv, bias, num_heads, dtype):
        calls.append((tuple(qkv.shape), tuple(bias.shape), num_heads, dtype))
        return torch.empty(qkv.shape[0], qkv.shape[1], qkv.shape[2] // 3, dtype=dtype, device=qkv.device)

    monkeypatch.setattr(layers, "window_attention", spy)
    m = _module(192, 6, device="meta", attn_chunk=4)
    with torch.inference_mode():
        out = m(torch.empty(11, N, 192, device="meta", dtype=torch.bfloat16))
    assert calls == [((11, N, 576), (6, N, N), 6, torch.bfloat16)] and out.shape == (11, N, 192)
    calls.clear()
    with torch.no_grad():
        m(torch.empty(11, N, 192, device="meta", dtype=torch.bfloat16))
    assert calls == []


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "grad"])
def test_on_the_cpu_the_module_keeps_the_chunked_chain(monkeypatch, mode):
    sizes = []
    real = WindowAttention._attend
    monkeypatch.setattr(WindowAttention, "_attend", lambda self, x, *a: sizes.append(x.shape[0]) or real(self, x, *a))
    m = _module(192, 12, attn_chunk=4)
    with torch.inference_mode() if mode == "inference_mode" else torch.set_grad_enabled(mode == "grad"):
        _, counts = _counted(lambda: m(_x(9, 192)))
    assert sizes == [4, 4, 1] and counts["window_attention"] == 0


def test_the_counter_is_registered():
    assert "window_attention" in profiling.counters()
    assert window_attention in profiling.COUNTERS


@pytest.mark.parametrize("C,nH,n,want", [(384, 24, 25, True), (192, 6, 25, True), (96, 6, 25, True),
                                         (48, 3, 25, True), (96, 3, 9, True), (192, 12, 32, True),
                                         (24, 3, 25, False), (12, 3, 25, False), (192, 12, 33, False),
                                         (80, 5, 25, False), (576, 18, 25, True), (320, 10, 25, False)])
def test_takes(C, nH, n, want):
    """Head widths 16 and 32 at up to 32 tokens, C in units of at most 192
    channels whose heads divide 12 warps (576 = 3 units of 6 heads: yes;
    80 = 5 heads of 16 and 320, not a whole number of units: no)."""
    assert takes(C, nH, n) == want


# ---- the plain version -------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C,nH", sorted(SHAPES))
def test_plain_is_attend_bit_for_bit(C, nH, dtype):
    m, x = _module(C, nH, dtype, seed=C + nH), _x(6, C, dtype, seed=nH)
    bias = m.rel_bias()
    with torch.no_grad():
        want = m._attend(x, bias, None, True, None)
        qkv = linear(x, m.qkv, dtype)
        got = window_attention_plain(qkv, bias, nH, dtype)
        wrapped, counts = _counted(lambda: window_attention(qkv, bias, nH, dtype))  # a CPU qkv runs the plain version
    assert got.dtype == dtype and got.shape == (6, N, C)
    assert torch.equal(got, want) and torch.equal(wrapped, want) and counts["window_attention"] == 0


@pytest.mark.parametrize("C,nH", sorted(SHAPES))
def test_plain_matches_the_jax_attend_matmul_in_fp32(C, nH):
    """The JAX package's WindowAttention with formulation "matmul" (its
    `attend_matmul`) and the port's plain version between the same qkv and
    output projections, in fp32 on 3 windows."""
    np = pytest.importorskip("numpy")
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from swinwnet_tpu.models.layers import WindowAttention as JaxWindowAttention

    jm = JaxWindowAttention(dim=C, window_size=5, num_heads=nH, formulation="matmul", dtype=jnp.float32)
    rng = np.random.default_rng(C + nH)
    params = {"qkv": {"kernel": rng.standard_normal((C, 3 * C)) / np.sqrt(C), "bias": 0.1 * rng.standard_normal(3 * C)},
              "proj": {"kernel": rng.standard_normal((C, C)) / np.sqrt(C), "bias": 0.1 * rng.standard_normal(C)},
              "relative_position_bias_table": rng.standard_normal((81, nH))}
    params = jax.tree_util.tree_map(lambda a: a.astype(np.float32), params)
    x = rng.standard_normal((3, N, C)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))

    m = WindowAttention(C, 5, nH, True, torch.float32)
    with torch.no_grad():
        m.qkv.weight.copy_(torch.from_numpy(params["qkv"]["kernel"].T.copy()))
        m.qkv.bias.copy_(torch.from_numpy(params["qkv"]["bias"]))
        m.proj.weight.copy_(torch.from_numpy(params["proj"]["kernel"].T.copy()))
        m.proj.bias.copy_(torch.from_numpy(params["proj"]["bias"]))
        m.relative_position_bias_table.copy_(torch.from_numpy(params["relative_position_bias_table"]))
        xt = torch.from_numpy(x)
        heads = window_attention_plain(linear(xt, m.qkv, torch.float32), m.rel_bias(), nH, torch.float32)
        got = linear(heads, m.proj, torch.float32).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 2e-5, f"max rel err {err:.3e}"


def test_the_wrapper_refuses_a_bias_of_another_shape():
    with pytest.raises(ValueError, match=r"bias must be \[6, 25, 25\]"):
        window_attention(torch.zeros(2, N, 3 * 96), torch.zeros(3, N, N), 6, torch.float32)


# ---- on the card -----------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |v|, 2^(e - 8) for |v| in [2^(e-1), 2^e), at
    least the smallest normal's."""
    _, e = torch.frexp(v.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


def _within_rounding(out, qkv, bias, nH):
    """The kernel and the plain version sum in other orders, so a
    probability's fp32 value may fall on the other side of a bf16 rounding:
    one bf16 ulp of P_j, at most 2^-7 P_j. So the two outputs differ by at
    most 2^-7 sum_j P_j |v_j| (every probability rounded the other way)
    before their own rounding to bf16, and by one bf16 ulp of the larger
    value more after it."""
    want = window_attention_plain(qkv, bias, nH, torch.bfloat16).float()
    Bw, n, C3 = qkv.shape
    C, hd = C3 // 3, C3 // 3 // nH
    parts = qkv.reshape(Bw, n, 3, nH, hd).permute(2, 0, 3, 1, 4)
    q = parts[0] * torch.tensor(hd ** -0.5, dtype=torch.bfloat16)
    p = torch.softmax(q.float() @ parts[1].float().transpose(-1, -2) + bias, dim=-1).to(torch.bfloat16).float()
    spread = (p @ parts[2].float().abs()).transpose(1, 2).reshape(Bw, n, C) * 2.0 ** -7
    excess = (out.float() - want).abs() - spread - _bf16_ulp(want.abs() + spread)
    worst = int(excess.argmax())
    assert excess.max().item() <= 0, (f"{excess.max().item():.3e} past the bound at {worst}: kernel "
                                      f"{out.flatten()[worst].item()}, plain {want.flatten()[worst].item()}")
    return (out.float() == want).float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("C,nH", sorted(SHAPES))
def test_kernel_matches_plain_at_the_serving_shapes(cuda, C, nH):
    Bw = SHAPES[(C, nH)]
    g = torch.Generator(device=cuda).manual_seed(C + nH)
    qkv = (torch.randn(Bw, N, 3 * C, device=cuda, generator=g) * 1.5).to(torch.bfloat16)
    bias = torch.randn(nH, N, N, device=cuda, generator=g)
    out, counts = _counted(lambda: window_attention(qkv, bias, nH, torch.bfloat16))
    torch.cuda.synchronize()
    assert counts["window_attention"] == 1 and out.dtype == torch.bfloat16 and out.shape == (Bw, N, C)
    assert _within_rounding(out, qkv, bias, nH) > 0.9  # most elements bit for bit


@pytest.mark.cuda
@pytest.mark.parametrize("C,nH,n,Bw", [(192, 6, 25, 7), (384, 24, 25, 133), (384, 12, 9, 1), (192, 12, 32, 300),
                                       (96, 3, 16, 50), (48, 3, 25, 129), (96, 6, 25, 3), (576, 18, 4, 20)])
def test_kernel_matches_plain_at_other_counts(cuda, C, nH, n, Bw):
    """Ragged last steps (windows not a multiple of a step's units, fewer
    steps than CTAs), other token counts, and the widths the route would
    take from a model without fused levels."""
    g = torch.Generator(device=cuda).manual_seed(Bw)
    qkv = (torch.randn(Bw, n, 3 * C, device=cuda, generator=g) * 2).to(torch.bfloat16)
    bias = torch.randn(nH, n, n, device=cuda, generator=g)
    _within_rounding(window_attention(qkv, bias, nH, torch.bfloat16), qkv, bias, nH)


@pytest.mark.cuda
def test_the_module_on_the_card_takes_the_kernel_only_under_inference_mode(cuda):
    m = _module(192, 12, device=cuda)
    x = _x(40, 192, device=cuda)
    with torch.no_grad():
        want, counts = _counted(lambda: m(x))
    assert counts["window_attention"] == 0
    with torch.inference_mode():
        got, counts = _counted(lambda: m(x))
    assert counts["window_attention"] == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=0.02, atol=0.02)


PUBLISHED = dict(patch_size=2, embed_dim=48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24), window_size=5)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,launches", [("SwinWNet", 30), ("SwinUNet", 10)])
def test_a_serving_replay_counts_the_kernel_and_equals_its_eager_call(cuda, monkeypatch, kind, launches):
    """The published widths, every C <= 96 level fused (the 128-window gate
    lifted, as the full detector passes it), the rest through the kernel: a
    replay adds its launches, and its answer is the eager call's, bit for
    bit."""
    from swinwnet_tpu_torch.models import BasicLayer, SwinUNet, SwinWNet
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
    eager, eager_counts = _counted(lambda: fn(x))  # the warm-up and capture
    replay, counts = _counted(lambda: fn(x))
    torch.cuda.synchronize()
    assert counts["window_attention"] == launches and eager_counts["window_attention"] == launches
    if isinstance(eager, dict):
        assert eager.keys() == replay.keys() and all(torch.equal(eager[k], replay[k]) for k in eager)
    else:
        assert torch.equal(eager, replay)


@pytest.mark.cuda
def test_takes_is_the_kernels_plan(cuda):
    """`takes`, which routes on the CPU and the meta device too, against
    the kernel's own `plan_of` over widths, heads and token counts."""
    import ctypes

    from swinwnet_tpu_torch.ops import window_attention as wa

    lib, plan = wa._load(), (ctypes.c_int * 6)()
    for C in range(8, 1153, 8):
        for nH in range(1, 49):
            for n in (0, 1, 9, 25, 32, 33):
                assert takes(C, nH, n) == (lib.window_attention_plan(n, C, nH, plan) == 0), (C, nH, n)


@pytest.mark.cuda
def test_the_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    bias = torch.zeros(6, N, N, device=cuda)
    qkv = torch.zeros(4, N, 3 * 192, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        window_attention(qkv.float(), bias, 6, torch.float32)
    with pytest.raises(ValueError, match="contiguous, 16-byte"):
        window_attention(qkv.transpose(0, 1).contiguous().transpose(0, 1), bias, 6, torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for 25 tokens, C = 24"):
        window_attention(torch.zeros(4, N, 72, device=cuda, dtype=torch.bfloat16), torch.zeros(3, N, N, device=cuda),
                         3, torch.bfloat16)
    with pytest.raises(ValueError, match="float32 tensor"):
        window_attention(qkv, bias.to(torch.bfloat16), 6, torch.bfloat16)
