"""The Mamba2 mixer's causal conv1d, bias and SiLU: its plain versions on
the CPU against the JAX package, its routes and the wrapper's checks, and
on the card the CUDA kernels (``csrc/causal_conv.cu``) against the plain
versions.

The CPU tests import JAX inside the tests that compare with it, so the
card tests run where JAX is not installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_causal_conv.py

Inputs are views cut from an in_proj-shaped output ([B, S, 2·di + 2·G·ds +
nh]) at mamba2-130m's and jamba-1.5-large's widths, as the mixer hands them
in.  Tolerances: 2e-4 in fp32 (tests/test_torch_model.py's prefill
tolerance), 3e-2 in bf16 (tests/test_kernels.py's bf16 kernel tolerance:
the JAX formula rounds each product and partial sum to bf16, the kernels'
arithmetic once).
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.causal_conv import causal_conv as kernels
from repro_torch.kernels.causal_conv import ops, ref
from repro_torch.models import layers as TL

FP32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
# (di, G·ds, nh): mamba2-130m (C = 1792) and jamba-1.5-large (C = 18432)
WIDTHS = {"mamba2-130m": (1536, 128, 24), "jamba": (16384, 1024, 256)}
W = 4


def inputs(name, batch, seq, dtype, seed, shift=0, device="cpu"):
    """(xBC view of a zxbcdt-shaped tensor, w [W,C], b [C] fp32, state
    [B,W-1,C]) from a numpy seed; ``shift`` moves the view's first column
    off the mixer's (a misaligned view)."""
    di, gds, nh = WIDTHS[name]
    C = di + 2 * gds
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(batch, seq, 2 * di + 2 * gds + nh + shift))
    w = rng.normal(size=(W, C)) / 2
    b = rng.normal(size=(C,)) / 4
    state = rng.normal(size=(batch, W - 1, C))
    t = lambda a, dt: torch.from_numpy(a).to(dt).to(device)  # noqa: E731
    zxbcdt = t(z, dtype)
    x = zxbcdt[..., di + shift:di + shift + C]
    return x, t(w, dtype), t(b, torch.float32), t(state, dtype)


def np_(a):
    return a.detach().float().cpu().numpy()


# ---------------------------------------------------------------------- #
# on the CPU
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("seq", [1, 2, 3, 257])
@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_fp32_mirror_matches_jax(name, with_state, seq):
    """The kernels' arithmetic (``causal_conv_fp32_reference``) against the
    JAX package's ``_causal_conv``, in fp32 and in bf16, on a strided view
    cut from in_proj's output; the new state too."""
    import jax.numpy as jnp
    from repro.models import layers as JL

    batch = 1 if name == "jamba" else 2
    for dtype, jdt, tol in ((torch.float32, jnp.float32, FP32_TOL),
                            (torch.bfloat16, jnp.bfloat16, BF16_TOL)):
        x, w, b, state = inputs(name, batch, seq, dtype, seed=seq)
        st = state if with_state else None
        got, gst = ref.causal_conv_fp32_reference(x, w, b, st)
        want, wst = JL._causal_conv(
            jnp.asarray(np_(x), jdt), jnp.asarray(np_(w), jdt),
            jnp.asarray(np_(b)),
            None if st is None else jnp.asarray(np_(st), jdt))
        assert got.dtype == dtype and got.is_contiguous()
        np.testing.assert_allclose(np_(got), np.asarray(want, np.float32),
                                   **tol)
        if seq >= W - 1 or with_state:
            np.testing.assert_array_equal(np_(gst),
                                          np.asarray(wst, np.float32))


@pytest.mark.parametrize("seq", [1, 2, 3, 257])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_new_state_is_the_plain_routes_bitwise(dtype, seq):
    """The kernels' new state (the last W-1 rows of cat(state, x), as the
    mirror takes them) is the plain route's, bit for bit, for sequences
    shorter than the state too."""
    x, w, b, state = inputs("mamba2-130m", 2, seq, dtype, seed=7 + seq)
    _, mine = ref.causal_conv_fp32_reference(x, w, b, state)
    _, plain = ref.causal_conv_reference(x, w, b, state)
    assert mine.shape == (2, W - 1, x.shape[2]) and mine.dtype == dtype
    assert torch.equal(mine, plain)


def test_cpu_route_is_the_plain_version():
    """On the CPU the mixer's conv is the plain version, bit for bit, with
    its gradient through plain autograd, and no kernel is counted."""
    assert TL._causal_conv is ops.causal_conv
    counts = (kernels.LAUNCHES, kernels.BACKWARD_LAUNCHES)
    for with_state in (False, True):
        x, w, b, state = inputs("mamba2-130m", 2, 33, torch.float32, seed=3)
        x.requires_grad_(True)
        st = state if with_state else None
        got, gst = ops.causal_conv(x, w, b, st)
        want, wst = ref.causal_conv_reference(x, w, b, st)
        assert torch.equal(got, want) and torch.equal(gst, wst)
        (g1,) = torch.autograd.grad(got.square().sum(), x)
        (g2,) = torch.autograd.grad(want.square().sum(), x)
        assert torch.equal(g1, g2)
    assert (kernels.LAUNCHES, kernels.BACKWARD_LAUNCHES) == counts


def test_route_by_what_the_call_shows():
    """The route is the device's: the CPU runs the plain version at any
    width and dtype (W = 5 and fp16 here), the card the kernels, which
    refuse what they do not take rather than hand it to the plain
    version: wider taps, other dtypes and a state that needs a gradient
    (refused before anything is launched, so on the CPU too)."""
    x, w, b, state = inputs("mamba2-130m", 2, 5, torch.bfloat16, seed=1)
    w5 = torch.cat([w, w[:1]]).float()
    st5 = state.float()[:, :1].expand(-1, 4, -1).contiguous()
    out, st = ops.causal_conv(x.float(), w5, b, st5)
    want, wst = ref.causal_conv_reference(x.float(), w5, b, st5)
    assert torch.equal(out, want) and torch.equal(st, wst)
    out, _ = ops.causal_conv(x.half(), w.half(), b)
    assert out.dtype == torch.float16 and out.shape == x.shape
    with pytest.raises(ValueError, match="widths 1..4"):
        kernels.check(x, torch.cat([w, w[:1]]), b)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        kernels.check(x.half(), w.half(), b)
    with pytest.raises(ValueError, match="gradient of the cached state"):
        ops._Conv.apply(x, w, b, state.clone().requires_grad_(True))


def test_wrapper_refuses_what_the_kernels_do_not_take():
    x, w, b, state = inputs("mamba2-130m", 2, 9, torch.bfloat16, seed=2)
    f = kernels.causal_conv_cuda
    with pytest.raises(TypeError, match="fp32 or bf16"):
        f(x.half(), w.half(), b)
    with pytest.raises(TypeError, match="taps"):
        f(x, w.float(), b)
    with pytest.raises(TypeError, match="bias"):
        f(x, w, b.bfloat16())
    with pytest.raises(TypeError, match="state"):
        f(x, w, b, state.float())
    with pytest.raises(ValueError, match="shapes disagree"):
        f(x, w[:, :-8].contiguous(), b)
    with pytest.raises(ValueError, match=r"expected x \[B,S,C\]"):
        f(x[0], w, b)
    with pytest.raises(ValueError, match="widths 1..4"):
        f(x, torch.cat([w, w[:1]]), b)
    with pytest.raises(ValueError, match="state must be"):
        f(x, w, b, state[:, :2].contiguous())
    with pytest.raises(ValueError, match="contiguous w"):
        f(x, w.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="multiples of 8"):
        f(x[..., :-3], w[:, :-3].contiguous(), b[:-3].contiguous())
    with pytest.raises(ValueError, match="CUDA"):        # all else in order
        f(x, w, b, state)
    dy = torch.zeros_like(x)
    with pytest.raises(ValueError, match="widths 1..4"):
        kernels.causal_conv_backward_cuda(x, torch.cat([w, w[:1]]), b, dy)


def test_which_views_take_the_16_byte_path():
    """The mixer's views of in_proj's output are 16-byte aligned at both
    configs' widths and are read as they lie; a view one column off, an
    odd row stride or strided channels is not, and is copied first into a
    contiguous tensor that is."""
    for name in WIDTHS:
        x, *_ = inputs(name, 1, 4, torch.bfloat16, seed=0)
        assert kernels.aligned(x) and not x.is_contiguous()
        assert kernels._readable(x) is x
        off, *_ = inputs(name, 1, 4, torch.bfloat16, seed=0, shift=1)
        assert not kernels.aligned(off)
    x, *_ = inputs("mamba2-130m", 2, 4, torch.float32, seed=0)
    assert kernels.aligned(x)
    odd = torch.zeros(2, 4, 1795)[..., :1792]
    assert not kernels.aligned(odd)
    assert kernels.aligned(torch.zeros(1, 1, 1795)[..., :1792])  # one row
    state = torch.arange(2 * 3 * 1792 + 1.)[1:].reshape(2, 3, 1792)
    assert state.is_contiguous() and not kernels.aligned(state)
    strided = torch.zeros(2, 4, 1792, 2)[..., 0]
    assert kernels.aligned(strided)
    for t in (off, odd, state, strided):
        got = kernels._readable(t)
        assert got is not t and got.is_contiguous() and torch.equal(got, t)
        assert kernels.aligned(got)


def test_kernel_names_stay_out_of_the_benchmarks_kernel_families():
    """No kernel of the conv source matches a kernel family the benchmark
    counts into a roofline (``arcbench/harness/trace.py``'s FAMILIES), so
    the SSD, flash and hash shares read what they read before."""
    import re

    from arcbench.harness.trace import FAMILIES

    names = re.findall(r"__global__ void(?: __launch_bounds__\([^)]*\))?\s+"
                       r"(\w+)\(", kernels.SOURCE.read_text())
    assert sorted(names) == ["causal_conv_bwd_kernel",
                             "causal_conv_fwd_kernel",
                             "causal_conv_wsum_kernel"]
    for name in names:
        for family, (pattern, _) in FAMILIES.items():
            assert not re.search(pattern, f"void {name}<4, bf16>"), \
                (name, family)


# ---------------------------------------------------------------------- #
# on the card
# ---------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    """The card, decided when the test runs (never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run `pytest -m cuda` on the GPU")
    return torch.device("cuda")


def _ulps_bf16(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two bf16 tensors in units in the last
    place (bf16's bit patterns are ordered as the values for one sign)."""
    ia = a.view(torch.int16).to(torch.int32)
    ib = b.view(torch.int16).to(torch.int32)
    ia = torch.where(ia < 0, -32768 - ia, ia)
    ib = torch.where(ib < 0, -32768 - ib, ib)
    return int((ia - ib).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [1, 2, 3, 257, 1030])
@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("name", sorted(WIDTHS))
def test_kernel_forward_matches_the_mirror(cuda_device, name, with_state,
                                           seq):
    """The forward within one bf16 ulp of the fp32 mirror (fp32 within
    1e-5 of it: fused against separate multiply-adds over taps up to about
    8), on the 16-byte path, with the new state bitwise the plain
    route's."""
    for dtype in (torch.bfloat16, torch.float32):
        x, w, b, state = inputs(name, 2, seq, dtype, seed=seq,
                                device=cuda_device)
        st = state if with_state else None
        assert kernels.aligned(x)
        before = kernels.LAUNCHES
        out, new = kernels.causal_conv_cuda(x, w, b, st)
        assert kernels.LAUNCHES == before + 1
        want, _ = ref.causal_conv_fp32_reference(x, w, b, st)
        if dtype == torch.bfloat16:
            assert _ulps_bf16(out, want) <= 1
        else:
            torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
        if with_state:
            _, plain = ref.causal_conv_reference(x, w, b, st)
            assert torch.equal(new, plain)
        else:
            assert new is None


def _grads_fp32(x, w, b, dy, state=None):
    """dx, dw, db of the plain conv by fp32 autograd."""
    xf = x.detach().float().requires_grad_(True)
    wf = w.detach().float().requires_grad_(True)
    bf = b.detach().float().requires_grad_(True)
    out, _ = ref.causal_conv_fp32_reference(
        xf, wf, bf, None if state is None else state.float())
    return torch.autograd.grad(out, (xf, wf, bf), dy.float())


def _close_to_largest(got, want, tol):
    """|got - want| within tol of want's largest magnitude, elementwise."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [1, 3, 257, 1030])
@pytest.mark.parametrize("with_state", [False, True], ids=["fresh", "state"])
@pytest.mark.parametrize("shift", [0, 1], ids=["aligned", "misaligned"])
def test_kernel_gradient_matches_fp32_autograd(cuda_device, shift,
                                               with_state, seq):
    """dx, dw, db of the gradient kernel against fp32 autograd of the plain
    conv (bf16: one rounding of dx and dw, 2^-7 of the largest; fp32: 1e-5),
    a misaligned view copied first; two calls bitwise equal."""
    for dtype, tol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
        x, w, b, state = inputs("mamba2-130m", 2, seq, dtype, seed=seq + 11,
                                shift=shift, device=cuda_device)
        st = state if with_state else None
        assert kernels.aligned(x) == (shift == 0)
        dy = torch.randn(x.shape, dtype=dtype, device=cuda_device,
                         generator=torch.Generator(cuda_device)
                         .manual_seed(seq))
        before = kernels.BACKWARD_LAUNCHES
        dx, dw, db = kernels.causal_conv_backward_cuda(x, w, b, dy, st)
        assert kernels.BACKWARD_LAUNCHES == before + 1
        assert dx.dtype == dtype and dw.dtype == dtype and \
            db.dtype == torch.float32 and dx.is_contiguous()
        for got, want in zip((dx, dw, db), _grads_fp32(x, w, b, dy, st)):
            _close_to_largest(got, want, tol)
        again = kernels.causal_conv_backward_cuda(x, w, b, dy, st)
        assert all(torch.equal(p, q) for p, q in zip((dx, dw, db), again))


@pytest.mark.cuda
def test_misaligned_views_are_copied_and_match(cuda_device):
    """A view one column off 16 bytes and a state 2 bytes off are copied
    first and match the mirror; the new state is the plain route's."""
    x, w, b, state = inputs("mamba2-130m", 2, 300, torch.bfloat16, seed=5,
                            shift=1, device=cuda_device)
    assert not kernels.aligned(x)
    buf = torch.empty(state.numel() + 1, dtype=state.dtype,
                      device=cuda_device)
    st = buf[1:].view(state.shape).copy_(state)
    assert st.is_contiguous() and not kernels.aligned(st)
    out, new = kernels.causal_conv_cuda(x, w, b, st)
    want, plain = ref.causal_conv_fp32_reference(x, w, b, state)
    assert _ulps_bf16(out, want) <= 1 and torch.equal(new, plain)


@pytest.mark.cuda
def test_routes_and_autograd_on_the_card(cuda_device):
    """``ops.causal_conv`` on the card: the kernel pair under autograd (a
    bf16 conv weight and an fp32 bias, as the mixer passes them), W > 4
    and a state that needs a gradient refused with nothing launched, and
    the build's plan and registers (no spills)."""
    x, w, b, _ = inputs("mamba2-130m", 2, 64, torch.bfloat16, seed=9,
                        device=cuda_device)
    x = x.detach().requires_grad_(True)
    w = w.float().requires_grad_(True)
    b = b.requires_grad_(True)
    counts = (kernels.LAUNCHES, kernels.BACKWARD_LAUNCHES)
    out, new = ops.causal_conv(x, w.to(torch.bfloat16), b)
    assert new is None
    out.float().square().sum().backward()
    assert (kernels.LAUNCHES, kernels.BACKWARD_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    assert x.grad is not None and w.grad.dtype == torch.float32
    with pytest.raises(ValueError, match="widths 1..4"):
        ops.causal_conv(x.detach(), torch.cat([w, w[:1]]).detach()
                        .to(torch.bfloat16), b.detach())
    state = torch.zeros(2, W - 1, x.shape[2], dtype=x.dtype,
                        device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError, match="gradient of the cached state"):
        ops.causal_conv(x.detach(), w.detach(), b.detach(), state)
    assert (kernels.LAUNCHES, kernels.BACKWARD_LAUNCHES) == (
        counts[0] + 1, counts[1] + 1)
    assert kernels.plan() == (kernels.TILE_ROWS, kernels.MAX_WIDTH, 64, 32)
    for dtype in kernels.DTYPES:
        for info in kernels.kernel_info(W, dtype):
            assert info["local_bytes"] == 0, info


@pytest.mark.cuda
def test_launch_counts_of_a_mamba2_step_and_prefill(cuda_device):
    """A reduced mamba2-130m (bf16 compute, block remat) train step runs
    the forward kernel twice a layer (forward and remat) and the gradient
    once; a prefill once a layer."""
    from dataclasses import replace

    from repro_torch.configs import reduced_config
    from repro_torch.models import model as TM
    from repro_torch.train import step as S

    cfg = replace(reduced_config("mamba2-130m"), compute_dtype="bfloat16",
                  remat="block")
    params = TM.init_params(cfg, torch.Generator(device="cuda")
                            .manual_seed(0), device=cuda_device)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128))).to(cuda_device)
    counts = (kernels.LAUNCHES, kernels.BACKWARD_LAUNCHES)
    S.grads_and_metrics(params, {"tokens": toks, "labels": toks}, cfg)
    L = cfg.n_layers
    assert (kernels.LAUNCHES - counts[0],
            kernels.BACKWARD_LAUNCHES - counts[1]) == (2 * L, L)
    with torch.no_grad():
        before = kernels.LAUNCHES
        TM.serve_step(TM.cast_params(params, cfg), cfg, {"tokens": toks},
                      None, None)
    assert kernels.LAUNCHES - before == L
