"""The gradient of the port's attention against the JAX package's, on the
CPU: the plain backward (``attention_backward_reference``) and the
per-row log-sum-exp (``attention_lse_reference``) against
``jax.value_and_grad`` of the JAX package's ``attention_reference`` and
against float64 autograd of the port's plain forward; the autograd
Function ``ops._Flash`` (the plumbing the card runs: the saved lse, the
group sums, the views) against the same oracles; one train step of three
attention configs with their prefill routed through ``_Flash`` against
the JAX package's ``jax.grad`` step; planted faults; the kernels' plan
and routing.  Inputs come from numpy seeds and reach both packages as the
same arrays.

Tolerances, each gradient held by max |port - jax| over its largest |jax|:
2e-5 in fp32 (the same products summed in other orders), 5e-2 in bf16
(both packages round p and the gradients to bf16, JAX also its
intermediate products); 1e-10 against float64 autograd (the same
function in float64); the train steps as ``test_torch_train.py`` holds
``forward_train``: the loss within 1e-5, each grad leaf within 5e-5 of its
largest magnitude.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import reduced_config as jax_reduced
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JDataset
from repro.kernels.flash_attention.ref import attention_reference as jax_ref
from repro.models import model as JM
from repro.optim import OptConfig as JOptConfig
from repro.train.step import init_train_state as jax_init_train_state
from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import layers as TL
from repro_torch.models.convert import train_state_from_numpy
from repro_torch.train.step import grads_and_metrics
from repro_torch.tree import leaf_paths

TOL = {"float32": 2e-5, "bfloat16": 5e-2}
F64_TOL = 1e-10
J_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (B, H, KV, S, D, Dv) and options: causal, window, softcap, GQA (H 4 over
# KV 2), Dv < D (24 over 16), D 80 and not causal
CASES = {
    "causal": ((1, 2, 2, 96, 32, 32), dict(causal=True)),
    "window": ((1, 2, 2, 96, 32, 32), dict(causal=True, window=24)),
    "softcap": ((1, 2, 2, 96, 32, 32), dict(causal=True, cap=5.0)),
    "gqa": ((2, 4, 2, 64, 32, 32), dict(causal=True, window=40, cap=5.0)),
    "dv-below-d": ((1, 4, 4, 64, 24, 16), dict(causal=True, scale=0.3)),
    "d80": ((1, 2, 2, 48, 80, 80), dict(causal=True)),
    "not-causal": ((2, 4, 2, 64, 32, 32), dict(causal=False)),
    "not-causal-window": ((1, 4, 2, 64, 32, 32), dict(causal=False,
                                                      window=20, cap=4.0)),
}


def draw(case, seed):
    """q, k, v and the cotangent of o as float32 numpy arrays; q scaled so
    that the softcap's range is reached."""
    (B, H, KV, S, D, Dv), _ = case
    rng = np.random.default_rng(seed)
    shapes = ((B, H, S, D), (B, KV, S, D), (B, KV, S, Dv), (B, H, S, Dv))
    arrs = [rng.normal(size=s).astype(np.float32) for s in shapes]
    arrs[0] *= 3.0
    return arrs


def jax_grads(arrs, kw, dtype):
    """o, (dq, dk, dv) of the JAX package's reference, through
    jax.value_and_grad of <o, ct>, as float32 numpy."""
    jq, jk, jv, jct = (jnp.asarray(a, J_DTYPES[dtype]) for a in arrs)

    def loss(q, k, v):
        o = jax_ref(q, k, v, **kw)
        return jnp.sum(o.astype(jnp.float32) * jct.astype(jnp.float32)), o
    (_, o), g = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        jq, jk, jv)
    return np.asarray(o.astype(jnp.float32)), \
        [np.asarray(x.astype(jnp.float32)) for x in g]


def rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def torch_inputs(arrs, dtype):
    return [torch.from_numpy(a).to(T_DTYPES[dtype]) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_grad(name, dtype):
    case = CASES[name]
    kw = case[1]
    arrs = draw(case, seed=len(name))
    jo, jg = jax_grads(arrs, kw, dtype)
    q, k, v, ct = torch_inputs(arrs, dtype)
    o = ref.attention_reference(q, k, v, **kw)
    lse = ref.attention_lse_reference(q, k, **kw)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    assert rel(o, jo) <= TOL[dtype]
    grads = ref.attention_backward_reference(q, k, v, o, lse, ct, **kw)
    for g, t in zip(grads, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
    errs = [rel(g, w) for g, w in zip(grads, jg)]
    assert max(errs) <= TOL[dtype], errs


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_float64_autograd(name):
    """The written-out backward against autograd of the plain forward, both
    in float64; the lse against logsumexp of the float64 scores."""
    case = CASES[name]
    kw = case[1]
    q, k, v, ct = (torch.from_numpy(a).double() for a in draw(case, 3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = ref.attention_reference(*leaves, **kw)
    want = torch.autograd.grad((o * ct).sum(), leaves)
    lse = ref.attention_lse_reference(q, k, **kw)
    assert lse.dtype == torch.float64
    got = ref.attention_backward_reference(q, k, v, o.detach(), lse, ct, **kw)
    errs = [rel(g.numpy(), w.numpy()) for g, w in zip(got, want)]
    assert max(errs) <= F64_TOL, errs
    # exp(s - lse) sums to 1 over each row's visible keys
    s = ref._masked_scores(q, k, kw.get("causal", True), kw.get("window"),
                           kw.get("cap"), kw.get("scale", 1 / math.sqrt(
                               q.shape[-1])))
    torch.testing.assert_close(torch.exp(s - lse[..., None]).sum(-1),
                               torch.ones_like(lse), atol=1e-12, rtol=0)


@pytest.mark.parametrize("fault", ref.FAULTS)
def test_planted_faults_fail_the_check(fault):
    """Each wrong backward misses the JAX gradient by more than the fp32
    tolerance, at a case where it can bite (a softcap in its range, a
    group of two heads, a window narrower than the sequence)."""
    kw = CASES["gqa"][1]
    arrs = draw(CASES["gqa"], seed=11)
    _, jg = jax_grads(arrs, kw, "float32")
    q, k, v, ct = torch_inputs(arrs, "float32")
    o = ref.attention_reference(q, k, v, **kw)
    lse = ref.attention_lse_reference(q, k, **kw)
    right = ref.attention_backward_reference(q, k, v, o, lse, ct, **kw)
    assert max(rel(g, w) for g, w in zip(right, jg)) <= TOL["float32"]
    wrong = ref.attention_backward_reference(q, k, v, o, lse, ct, fault=fault,
                                             **kw)
    assert max(rel(g, w) for g, w in zip(wrong, jg)) > 100 * TOL["float32"]
    with pytest.raises(ValueError):
        ref.attention_backward_reference(q, k, v, o, lse, ct, fault="other")


# ------------------------------ _Flash ---------------------------------- #

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["gqa", "window", "d80", "not-causal"])
def test_flash_function_on_the_layers_views(monkeypatch, name, dtype):
    """``ops.flash_attention`` with inputs that need a gradient is the
    autograd Function: q, k, v and the cotangent as the layer passes them
    (permuted [B,S,H,D] views), grads through the Function's backward
    against JAX's, in the inputs' layout."""
    case = CASES[name]
    kw = case[1]
    arrs = draw(case, seed=5 + len(name))
    _, jg = jax_grads(arrs, kw, dtype)
    leaves = [t.transpose(1, 2).contiguous().requires_grad_(True)
              for t in torch_inputs(arrs[:3], dtype)]
    ct = torch_inputs(arrs[3:], dtype)[0]
    calls = []
    real = ref.attention_backward_reference

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(ref, "attention_backward_reference", counted)
    o = ops.flash_attention(*(t.transpose(1, 2) for t in leaves), **kw)
    assert o.grad_fn is not None and o.dtype == T_DTYPES[dtype]
    (o.float() * ct.float()).sum().backward()
    assert calls == [1]
    errs = [rel(t.grad.transpose(1, 2), w) for t, w in zip(leaves, jg)]
    assert max(errs) <= TOL[dtype], errs
    with torch.no_grad():                  # no gradient: the plain forward
        assert ops.flash_attention(*(t.transpose(1, 2) for t in leaves),
                                   **kw).grad_fn is None


def test_flash_function_on_mlas_value_slice():
    """MLA's prefill passes v as the [..., dn:] half of its key/value
    expansion; the Function's dv lands in that half and dk in k's."""
    B, H, S, dn, dr, dv = 1, 4, 64, 16, 8, 16
    rng = np.random.default_rng(9)
    q = rng.normal(size=(B, S, H, dn + dr)).astype(np.float32)
    kv = rng.normal(size=(B, S, H, dn + dv)).astype(np.float32)
    kr = rng.normal(size=(B, S, H, dr)).astype(np.float32)
    ct = rng.normal(size=(B, H, S, dv)).astype(np.float32)
    kw = dict(causal=True, scale=1.0 / math.sqrt(dn + dr))

    def jloss(q, kv, kr):
        k = jnp.concatenate([kv[..., :dn], kr], -1)
        o = jax_ref(q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                    kv[..., dn:].transpose(0, 2, 1, 3), **kw)
        return jnp.sum(o * ct)
    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, kv, kr)))
    tq, tkv, tkr = (torch.from_numpy(a).requires_grad_(True)
                    for a in (q, kv, kr))
    k = torch.cat([tkv[..., :dn], tkr], -1)
    o = ops.flash_attention(tq.transpose(1, 2), k.transpose(1, 2),
                            tkv[..., dn:].transpose(1, 2), **kw)
    (o * torch.from_numpy(ct)).sum().backward()
    for t, w in zip((tq, tkv, tkr), jg):
        assert rel(t.grad, np.asarray(w)) <= TOL["float32"]


# -------------------------- the slice on the CPU ------------------------- #

def fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def jax_leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch,seq", [("gemma2-9b", 96),
                                      ("deepseek-v3-671b", 32),
                                      ("hubert-xlarge", 48)])
def test_train_step_through_the_flash_function_matches_jax(monkeypatch, arch,
                                                           seq):
    """One step's loss and grads of a reduced config with every prefill
    attention routed through ``_flash_attention`` (so through ``_Flash`` and
    the plain backward, as the card runs the kernels), against the JAX
    package's ``jax.grad`` step: gemma2 with its window of 64 biting at 96
    tokens and its softcap, deepseek-v3 with MLA (Dv < D) and its MTP
    block, hubert not causal."""
    real = TL.attention
    calls = {"forward": 0, "backward": 0}

    def routed(q, k, v, *, causal=True, window=None, cap=None, q_offset=0,
               kv_len=None, chunk_q=512, scale=None):
        if q.shape[1] != k.shape[1] or kv_len is not None or q_offset:
            return real(q, k, v, causal=causal, window=window, cap=cap,
                        q_offset=q_offset, kv_len=kv_len, chunk_q=chunk_q,
                        scale=scale)
        calls["forward"] += 1
        scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        return TL._flash_attention(q, k, v, scale=scale, causal=causal,
                                   window=window, cap=cap)
    real_bwd = ref.attention_backward_reference

    def counted(*a, **k):
        calls["backward"] += 1
        return real_bwd(*a, **k)
    monkeypatch.setattr(TL, "attention", routed)
    monkeypatch.setattr(ref, "attention_backward_reference", counted)

    jcfg, cfg = fp32(jax_reduced(arch)), fp32(reduced_config(arch))
    jstate = jax_init_train_state(jax.random.key(1), jcfg, JOptConfig())
    state = train_state_from_numpy(jax.tree_util.tree_map(np.asarray, jstate),
                                   device="cpu")
    batch = JDataset(jcfg, JDataConfig(batch=2, seq_len=seq)).batch_at(0)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JM.forward_train(p, jcfg, b), has_aux=True))(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()})
    port = {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}
    grads, met = grads_and_metrics(state["params"], port, cfg)
    # each attention layer once in the backward; a block's layers twice in
    # the forward (block remat), the dense prologue and MTP block once
    in_blocks = cfg.n_blocks * sum(k.mixer == "attn"
                                   for k in cfg.block_pattern())
    outside = cfg.first_dense_layers + cfg.mtp_depth
    assert calls == {"forward": 2 * in_blocks + outside,
                     "backward": in_blocks + outside}, calls
    assert float(met["loss"]) == pytest.approx(float(jloss), rel=1e-5)
    want = jax_leaves(jgrads)
    got = dict(leaf_paths(grads))
    assert set(got) == set(want)
    errs = {n: rel(got[n], want[n]) for n in want}
    assert max(errs.values()) <= 5e-5, sorted(errs.items(),
                                              key=lambda kv: -kv[1])[:3]


# --------------------------- routing and plan ---------------------------- #

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_plan_fits_shared_memory_at_every_head_dim(dtype):
    """The CUDA-core plan at every head dim (the plan of the route that
    serves it, but for bf16 at a tensor-core pair, where it is asked for by
    name); the tensor-core plans have their own test below."""
    for D in range(4, 257, 4):
        tc = dtype == torch.bfloat16 and (D, D) in fa.TENSOR_CORE_PAIRS
        plan = fa.backward_plan(dtype, D, route="cuda_cores" if tc else None)
        assert plan.route == "cuda_cores"
        assert max(plan.smem_bytes, plan.dq_smem_bytes) <= fa.MAX_SMEM, \
            (D, plan)
        assert plan.launches == 3 and plan.dq_stages == 2
        fp32 = dtype == torch.float32
        assert (plan.keys, plan.rows, plan.dq_rows, plan.dq_keys) == (
            (32 if D > 192 else 64, 64 if D <= 64 else 32,
             32 if D > 192 else 64, 32 if D > 128 else 64) if fp32
            else (64, 64, 64, 64)), (D, plan)
        narrow = fa.backward_plan(dtype, D, 4,
                                  route="cuda_cores" if tc else None)
        assert narrow.smem_bytes <= plan.smem_bytes  # V's tiles follow Dv
        assert (narrow.rows, narrow.keys) == (plan.rows, plan.keys)
    with pytest.raises(ValueError):
        fa.backward_plan(dtype, 260)
    with pytest.raises(ValueError):
        fa.backward_plan(dtype, 64, 80)
    with pytest.raises(TypeError):
        fa.backward_plan(torch.float16, 64)


def test_backward_of_cpu_tensors_refuses_the_kernel():
    """The kernels' wrapper takes CUDA tensors only, and nothing launches;
    an entry point asked for the card on a machine without one raises."""
    q, k, v, ct = torch_inputs(draw(CASES["gqa"], 1), "float32")
    o, lse = ref.attention_reference(q, k, v), ref.attention_lse_reference(q, k)
    before = (fa.BACKWARD_LAUNCHES, fa.BACKWARD_CALL_LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_backward_cuda(q, k, v, o, lse, ct)
    assert (fa.BACKWARD_LAUNCHES, fa.BACKWARD_CALL_LAUNCHES) == before
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "gemma2-9b", "--reduced", "--steps", "1"])
