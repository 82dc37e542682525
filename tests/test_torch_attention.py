"""The port's attention against the JAX package's, on the CPU: the plain
flash-attention version against ``attention_reference`` and the Pallas
kernel (interpret mode), the routing of ``kernels/flash_attention/ops``,
rotary embeddings, each attention strategy of ``models/layers.py``
(direct, blockwise, sliding) and the GQA layer with and without a cache.
Inputs come from numpy seeds and reach both packages as the same arrays.

Tolerances: 2e-5 in fp32 and 3e-2 in bf16 for the kernel-level checks
(tests/test_kernels.py's); 2e-5 for the attention strategies in fp32
(the same products summed in another order); 2e-4 for the GQA layer,
whose projections and rotary tables add their own roundings
(tests/test_arch_smoke.py's prefill tolerance).
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.configs import reduced_config as jax_reduced
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_reference as jax_ref
from repro.models import layers as JL
from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers as TL

FP32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)
LAYER_TOL = dict(atol=2e-4, rtol=2e-4)


def draw(shapes, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(dtype) for s in shapes]


def np_(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


def both(arrays, jdtype=jnp.float32, tdtype=torch.float32):
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(tdtype) for a in arrays])


# ----------------------- plain version and routing ----------------------- #

@pytest.mark.parametrize("B,H,KV,S,D", [
    (2, 4, 2, 256, 64), (1, 8, 8, 128, 128), (2, 2, 1, 512, 32),
    (1, 4, 2, 384, 64),
])
def test_reference_matches_jax_and_pallas_causal(B, H, KV, S, D):
    (jq, jk, jv), (tq, tk, tv) = both(draw(
        [(B, H, S, D), (B, KV, S, D), (B, KV, S, D)], B * S))
    got = ref.attention_reference(tq, tk, tv, causal=True)
    np.testing.assert_allclose(np_(got), np_(jax_ref(jq, jk, jv, causal=True)),
                               **FP32_TOL)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, bq=128, bk=128,
                                    interpret=True)
    np.testing.assert_allclose(np_(got), np_(pallas), **FP32_TOL)


@pytest.mark.parametrize("kw", [
    dict(causal=False),
    dict(causal=True, window=128),
    dict(causal=True, cap=50.0),
    dict(causal=True, window=64, cap=30.0),
])
def test_reference_matches_jax_and_pallas_mask_variants(kw):
    (jq, jk, jv), (tq, tk, tv) = both(draw(
        [(1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64)], 7))
    got = ref.attention_reference(tq, tk, tv, **kw)
    np.testing.assert_allclose(np_(got), np_(jax_ref(jq, jk, jv, **kw)),
                               **FP32_TOL)
    pallas = flash_attention_pallas(jq, jk, jv, bq=128, bk=128,
                                    interpret=True, **kw)
    np.testing.assert_allclose(np_(got), np_(pallas), **FP32_TOL)


def test_reference_matches_jax_in_bf16():
    """bf16 inputs, p cast to bf16 before the PV product on both sides."""
    (jq, jk, jv), (tq, tk, tv) = both(
        draw([(1, 2, 256, 64)] * 3, 3), jnp.bfloat16, torch.bfloat16)
    got = ref.attention_reference(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np_(got), np_(jax_ref(jq, jk, jv, causal=True)),
                               **BF16_TOL)
    pallas = flash_attention_pallas(jq, jk, jv, causal=True, bq=128, bk=128,
                                    interpret=True)
    np.testing.assert_allclose(np_(got), np_(pallas), **BF16_TOL)


def test_reference_with_a_window_narrower_than_a_tile_and_a_ragged_length():
    """The cases the kernel handles at its tile edges (a window of 16, a
    length of 200 that no tile size divides): the plain version agrees
    with the JAX package's there too."""
    for S, kw in ((256, dict(causal=True, window=16)),
                  (200, dict(causal=True, window=100, cap=20.0))):
        (jq, jk, jv), (tq, tk, tv) = both(draw(
            [(1, 4, S, 32), (1, 2, S, 32), (1, 2, S, 32)], S))
        np.testing.assert_allclose(
            np_(ref.attention_reference(tq, tk, tv, **kw)),
            np_(jax_ref(jq, jk, jv, **kw)), **FP32_TOL)


def test_ops_routes_cpu_tensors_to_the_plain_version():
    _, (tq, tk, tv) = both(draw([(1, 4, 64, 32), (1, 2, 64, 32),
                                 (1, 2, 64, 32)], 1))
    before = fa.LAUNCHES
    got = ops.flash_attention(tq, tk, tv, causal=True, window=16, cap=30.0)
    assert fa.LAUNCHES == before
    assert torch.equal(got, ref.attention_reference(
        tq, tk, tv, causal=True, window=16, cap=30.0))
    meta = [t.to("meta") for t in (tq, tk, tv)]
    with pytest.raises(ValueError, match="no attention route"):
        ops.flash_attention(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(tq, tk, tv)        # the kernel takes no CPU


def tc_smem(D, Dv):
    """flash_fwd_wgmma's shared bytes (csrc/flash_attention.cu, TcCfg): 1 KB
    to align the ring, Q [128 rows] and two stages of K and V [Bc rows],
    each row whole 64-column boxes of 128 bytes (TMA fills a box past the
    head dim with zeros and counts it whole), 128 B of barriers."""
    keys = 64 if D == 256 else 128
    boxes, v_boxes = -(-D // 64), -(-Dv // 64)
    return 1024 + 128 * boxes * 128 + 2 * keys * (boxes + v_boxes) * 128 + 128


def mma_keys(dtype, D):
    """Keys of flash_fwd_kernel's K/V tile (csrc/flash_attention.cu,
    mma_keys): 64 in bf16; in fp32 64 up to D 128, 32 up to 192, 16 above."""
    if dtype == torch.bfloat16 or D <= 128:
        return 64
    return 32 if D <= 192 else 16


def mma_smem(dtype, D, Dv):
    """flash_fwd_kernel's shared bytes: Q [128 rows] and two stages of K and
    V [Bc rows], rows padded to 8k + 4 floats or 16k + 8 bf16."""
    if dtype == torch.float32:
        ld = lambda n: -(-n // 8) * 8 + 4            # noqa: E731
        size = 4
    else:
        ld = lambda n: -(-n // 16) * 16 + 8          # noqa: E731
        size = 2
    return size * (128 * ld(D) + 2 * mma_keys(dtype, D) * (ld(D) + ld(Dv)))


def test_tile_plan_fits_a_block_for_every_input_the_kernel_takes():
    """Every (dtype, D, Dv) the wrapper's check accepts (fp32 or bf16, D a
    multiple of 4 up to 256, Dv one up to D) has a plan within the 232,448
    bytes of shared memory a Hopper block may use; bf16 at the pairs of
    TENSOR_CORE_PAIRS goes to the tensor cores in 128-row blocks with a
    two-stage K/V ring whose bytes are TcCfg's arithmetic (214,144 at MLA's
    192/128, 160 KB + 1 KB + 128 B at hubert's 80), and fp32 always to the
    CUDA cores."""
    assert fa.MAX_SMEM == 232448
    assert tc_smem(192, 128) == 214144
    assert tc_smem(80, 80) == tc_smem(128, 128) == 160 * 1024 + 1024 + 128
    pairs = {(D, Dv) for D in range(4, fa.MAX_HEAD_DIM + 1, 4)
             for Dv in (D, D // 2 // 4 * 4 or 4, 128 if D > 128 else D)}
    assert set(fa.TENSOR_CORE_PAIRS) <= pairs and (192, 128) in pairs
    for dtype in (torch.float32, torch.bfloat16):
        for D, Dv in sorted(pairs):
            plan = fa.tile_plan(dtype, D, Dv)
            assert 0 < plan.smem_bytes <= fa.MAX_SMEM, (dtype, D, Dv, plan)
            tensor_cores = dtype == torch.bfloat16 and \
                (D, Dv) in fa.TENSOR_CORE_PAIRS
            assert plan.route == ("tensor_cores" if tensor_cores
                                  else "cuda_cores"), (dtype, D, Dv)
            if tensor_cores:
                assert (plan.rows, plan.stages) == (128, 2)
                assert plan.keys % 16 == 0 and plan.keys <= 256   # wgmma N
                assert plan.smem_bytes == tc_smem(D, Dv), (D, Dv)
            else:
                assert (plan.rows, plan.keys, plan.stages) == \
                    (128, mma_keys(dtype, D), 2), (dtype, D, Dv, plan)
                assert plan.smem_bytes == mma_smem(dtype, D, Dv), (D, Dv)


def test_serving_widths_go_to_the_tensor_cores():
    """The dense GQA configs' head dims in bf16 (qwen2-7b, starcoder2-3b
    and command-r-35b at 128, gemma2-9b at 256), deepseek-v3's MLA prefill
    (qk_nope + qk_rope, v_head_dim) = (192, 128), hubert-xlarge's 80 and
    the kernel tests' 64 get the tensor-core plan; the same widths in fp32
    do not."""
    from repro_torch.configs import get_config

    dims = {get_config(a).resolved_head_dim
            for a in ("qwen2-7b", "starcoder2-3b", "command-r-35b",
                      "gemma2-9b")}
    assert dims == {128, 256}
    ds = get_config("deepseek-v3-671b")
    mla = (ds.qk_nope_dim + ds.qk_rope_dim, ds.v_head_dim)
    hubert = get_config("hubert-xlarge").resolved_head_dim
    assert mla == (192, 128) and hubert == 80
    for D, Dv in {(d, d) for d in dims | {64, hubert}} | {mla}:
        assert fa.tile_plan(torch.bfloat16, D, Dv).route == "tensor_cores"
        assert fa.tile_plan(torch.float32, D, Dv).route == "cuda_cores"
    assert fa.tile_plan(torch.bfloat16, 256).keys == 64      # 192 KB of tiles
    assert fa.tile_plan(torch.bfloat16, 128).keys == 128     # 160 KB
    assert fa.tile_plan(torch.bfloat16, *mla).keys == 128    # 208 KB
    assert fa.tile_plan(torch.bfloat16, hubert).keys == 128  # 160 KB


# ----------------------------- rotary tables ----------------------------- #

def test_rope_matches_jax():
    x = draw([(2, 40, 3, 32)], 5)[0]
    pos = np.arange(7, 47)[None, :]
    jc, js = JL.rope_tables(jnp.asarray(pos), 32, 1e4)
    tc, ts = TL.rope_tables(torch.from_numpy(pos), 32, 1e4)
    np.testing.assert_allclose(np_(tc), np_(jc), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(np_(ts), np_(js), atol=1e-6, rtol=1e-6)
    got = TL.apply_rope(torch.from_numpy(x), tc, ts)
    want = JL.apply_rope(jnp.asarray(x), jc, js)
    np.testing.assert_allclose(np_(got), np_(want), atol=1e-5, rtol=1e-5)


# -------------------------- attention strategies -------------------------- #

# (Sq, Sk, kwargs, the strategy the JAX package's dispatch picks)
STRATEGIES = [
    (64, 64, dict(causal=True, cap=50.0), "direct"),
    (1, 48, dict(causal=False, window=16, q_offset=40, kv_len=41), "direct"),
    (2560, 2560, dict(causal=True, cap=30.0), "blockwise"),
    (2560, 2560, dict(causal=True, window=256, cap=50.0), "sliding"),
]


@pytest.mark.parametrize("Sq,Sk,kw,strategy", STRATEGIES,
                         ids=["direct", "direct-decode", "blockwise",
                              "sliding"])
def test_attention_strategies_match_jax(Sq, Sk, kw, strategy):
    """layers.attention on CPU tensors against the JAX package's, at
    shapes where its dispatch picks each strategy (blockwise needs
    Sq·Sk > 2048², sliding a window below S); that strategy's own function
    against the JAX one, and equal to what the port's dispatch returned."""
    (jq, jk, jv), (tq, tk, tv) = both(draw(
        [(1, Sq, 1, 2, 16), (1, Sk, 1, 16), (1, Sk, 1, 16)], Sq + Sk))
    got = TL.attention(tq, tk, tv, **kw)
    np.testing.assert_allclose(np_(got), np_(JL.attention(jq, jk, jv, **kw)),
                               **FP32_TOL)
    common = dict(scale=1.0 / 4.0, window=kw.get("window"), cap=kw.get("cap"))
    mine, theirs, args = {
        "direct": (TL._direct_attention, JL._direct_attention,
                   dict(common, causal=kw["causal"],
                        q_offset=kw.get("q_offset", 0),
                        kv_len=kw.get("kv_len"))),
        "blockwise": (TL._blockwise_attention, JL._blockwise_attention,
                      dict(common, causal=True, q_offset=0, chunk_q=512)),
        "sliding": (TL._sliding_attention, JL._sliding_attention,
                    dict(common, chunk_q=512)),
    }[strategy]
    args_j = args if strategy == "direct" else dict(args, unroll=False)
    own = mine(tq, tk, tv, **args)
    np.testing.assert_allclose(np_(own), np_(theirs(jq, jk, jv, **args_j)),
                               **FP32_TOL)
    assert torch.equal(own, got)            # the dispatch chose this strategy


def test_attention_in_bf16_matches_jax():
    """bf16 inputs: fp32 scores, p rounded to bf16 before the PV product,
    on both sides."""
    (jq, jk, jv), (tq, tk, tv) = both(draw(
        [(2, 96, 2, 2, 32), (2, 96, 2, 32), (2, 96, 2, 32)], 9),
        jnp.bfloat16, torch.bfloat16)
    kw = dict(causal=True, window=40, cap=50.0)
    got = TL.attention(tq, tk, tv, **kw)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np_(got), np_(JL.attention(jq, jk, jv, **kw)),
                               **BF16_TOL)


# ----------------------------- GQA attention ----------------------------- #

def gqa_setup(name, seed):
    jcfg = replace(jax_reduced(name), n_kv_heads=2)
    tcfg = replace(reduced_config(name), n_kv_heads=2)
    rng = np.random.default_rng(seed)
    shapes = TL.gqa_params_shapes(tcfg)
    p = {k: (rng.normal(size=s) * 0.2).astype(np.float32)
         for k, s in shapes.items()}
    return (jcfg, tcfg, {k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


@pytest.mark.parametrize("name,local", [("gemma2-9b", True),
                                        ("gemma2-9b", False),
                                        ("qwen2-7b", False)],
                         ids=["gemma2-local", "gemma2-global", "qwen2-bias"])
def test_gqa_attention_without_a_cache_matches_jax(name, local):
    """4 heads over 2 kv heads (G = 2); gemma2's window (64 in the reduced
    config, below S = 96) and softcap, qwen2's qkv bias."""
    jcfg, tcfg, jp, tp = gqa_setup(name, 1)
    x = draw([(2, 96, tcfg.d_model)], 2)[0]
    got, none = TL.gqa_attention(torch.from_numpy(x), tp, tcfg, local=local)
    want, _ = JL.gqa_attention(jnp.asarray(x), jp, jcfg, local=local)
    assert none is None
    np.testing.assert_allclose(np_(got), np_(want), **LAYER_TOL)


@pytest.mark.parametrize("local", [True, False], ids=["local", "global"])
def test_gqa_attention_with_a_cache_matches_jax(local):
    """Prefill of 80 tokens into a 96-slot cache (attending within the new
    span), then decode steps at positions 80..83 against the cache, with
    gemma2's window of 64 active: outputs and cache contents equal the JAX
    package's, and the port's cache is written in place."""
    jcfg, tcfg, jp, tp = gqa_setup("gemma2-9b", 3)
    x = draw([(2, 84, tcfg.d_model)], 4)[0]
    spec = TL.gqa_cache_spec(tcfg, 2, 96)
    jcache = JL.gqa_cache_spec(jcfg, 2, 96)
    assert tuple(spec["k"].shape) == tuple(jcache["k"].shape)
    jc = {k: jnp.zeros(s.shape, s.dtype) for k, s in jcache.items()}
    tc = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in spec.items()}
    for lo, hi in ((0, 80), (80, 81), (81, 82), (82, 83), (83, 84)):
        got, tc2 = TL.gqa_attention(torch.from_numpy(x[:, lo:hi]), tp, tcfg,
                                    local=local, cache=tc, index=lo)
        want, jc = JL.gqa_attention(jnp.asarray(x[:, lo:hi]), jp, jcfg,
                                    local=local, cache=jc,
                                    index=jnp.int32(lo))
        assert tc2["k"] is tc["k"] and tc2["v"] is tc["v"]
        np.testing.assert_allclose(np_(got), np_(want), **LAYER_TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(np_(tc[k]), np_(jc[k]), **LAYER_TOL)
