"""The port's dry run and its experiment registry.

Every fake process group lives in a subprocess (so none leaks into the
other tests of this worker); the JAX package's side, where a test needs
it, runs in another on forced host devices and compiles nothing.
"""

import json
import math
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a subprocess's limit: the qwen2-7b train_4k fake run takes about 45 s on
# an idle 8-core host and several times that beside five other busy test
# workers
TIMEOUT = 600


def run(code: str, **env) -> dict:
    e = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), **env)
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=e,
                         timeout=TIMEOUT)
    assert out.returncode == 0, f"stderr:\n{out.stderr}\nstdout:{out.stdout}"
    return json.loads(out.stdout.strip().splitlines()[-1])


FULL_CELLS = [("qwen2-7b", "train_4k"), ("gemma2-9b", "decode_32k")]


@pytest.fixture(scope="module")
def port_cells():
    return run(f"""
        import json
        from repro_torch.launch.dryrun import run_cell
        print(json.dumps({{f"{{a}} {{s}}": run_cell(a, s, False, quiet=True)
                          for a, s in {FULL_CELLS!r}}}))
    """)


@pytest.fixture(scope="module")
def jax_argument_bytes():
    """Σ over a cell's arguments of each leaf's ``NamedSharding.shard_shape``
    bytes, from the JAX package's ``build_cell`` (nothing lowered)."""
    return run(f"""
        import json, numpy as np, jax
        from repro.configs import get_config
        from repro.launch import dryrun
        from repro.launch.mesh import make_production_mesh
        mesh = make_production_mesh(multi_pod=False)
        out = {{}}
        for arch, shape in {FULL_CELLS!r}:
            _, args, in_sh, _, _ = dryrun.build_cell(get_config(arch), shape,
                                                     mesh)
            leaves = jax.tree_util.tree_leaves(args)
            shs = jax.tree_util.tree_leaves(
                in_sh, is_leaf=lambda x: isinstance(
                    x, jax.sharding.NamedSharding))
            out[f"{{arch}} {{shape}}"] = int(sum(
                np.prod(sh.shard_shape(a.shape)) * a.dtype.itemsize
                for a, sh in zip(leaves, shs)))
        print(json.dumps(out))
    """, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=256")


def test_full_size_qwen2_train_cell_runs(port_cells):
    r = port_cells["qwen2-7b train_4k"]
    assert r["status"] == "ok", r
    assert r["mesh"] == "16x16" and r["n_devices"] == 256
    assert r["partition"] == 16                 # 16 of 256 rows a shard
    mem = r["memory_analysis"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes"}
    assert all(v > 0 for v in mem.values())
    coll = r["collective_bytes_per_device"]
    assert set(coll) == {"all-gather", "all-reduce", "reduce-scatter",
                         "all-to-all", "collective-permute", "count"}
    assert coll["all-gather"] > 0 and coll["all-to-all"] == 0
    assert r["model_params"] > 7e9


@pytest.mark.parametrize("cell", [f"{a} {s}" for a, s in FULL_CELLS])
def test_argument_bytes_equal_jax_shard_shapes(port_cells,
                                               jax_argument_bytes, cell):
    assert port_cells[cell]["status"] == "ok", port_cells[cell]
    assert port_cells[cell]["memory_analysis"]["argument_size_in_bytes"] == \
        jax_argument_bytes[cell]


def test_qwen2_train_flops_equal_the_analytic_count(port_cells):
    """qwen2-7b, train_4k: one data-parallel shard is 16 sequences of 4096
    tokens, divided over the 16-way model axis.  A layer's matmuls (q, k,
    v, o, gated MLP: 2·P FLOPs a token) and its attention (QKᵀ and P·V over
    all 4096 keys: the CPU blockwise strategy computes masked blocks too)
    run forward, again under block remat, and twice in the backward pass,
    except that remat stops before the MLP's down projection, whose output
    the backward does not need; the LM head runs once forward and twice
    backward."""
    D, H, KV, hd, F, V, L, S = 3584, 28, 4, 128, 18944, 152064, 28, 4096
    P = 2 * D * H * hd + 2 * D * KV * hd + 3 * D * F
    layer = 4 * (2 * P + 4 * S * H * hd) - 2 * D * F
    per_token = L * layer + 3 * 2 * D * V
    want = per_token * 16 * S / 16
    got = port_cells["qwen2-7b train_4k"]["flops_per_device"]
    assert abs(got - want) / want < 1e-3, (got, want)


ACCOUNT = """
import json, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import reduced_config
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.dryrun import collective_account
from repro_torch.models import model as M
from repro_torch.tree import leaf_paths
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
cfg = reduced_config("qwen2-7b")
rules = ShardingRules(mesh, fsdp_min_size=1)
specs = M.param_specs(cfg)
sh = rules.param_shardings(specs)
out = {k: collective_account(cfg, k, rules, specs, sh, (2, 64), (8, 64))
       for k in ("train", "serve")}
out["specs"] = {p: list(s.spec) for p, s in leaf_paths(sh)}
out["tie"] = cfg.tie_embeddings
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_collective_account_by_hand():
    """Reduced qwen2 (D 128, 4 heads of 32, 4 kv heads, MLP 256, vocab 512,
    one block, fp32, block remat) on a (data 4, model 2) fake mesh with
    every leaf eligible for sharding, 2 × 64 tokens a device of 8 × 64."""
    r = run(ACCOUNT)
    specs = r["specs"]
    assert specs["['embed']['w']"] == ["model", "data"]
    assert specs["['blocks']['l0']['attn']['wq']"] == [None, "data", "model"]
    assert specs["['blocks']['l0']['attn']['wo']"] == [None, "model", None,
                                                        None, "data"]
    assert specs["['blocks']['l0']['ffn']['wi']"] == [None, "data", None,
                                                       "model"]
    assert specs["['blocks']['l0']['ffn']['wo']"] == [None, "model", "data"]
    assert specs["['blocks']['l0']['attn']['bq']"] == [None, "model"]
    assert specs["['blocks']['l0']['ln1']['w']"] == []
    assert not r["tie"] and specs["['lm_head']['w']"] == ["data", "model"]
    f32 = 4
    # FSDP leaves (split over data 4): local bytes of one device
    embed = 512 // 2 * 128 // 4 * f32          # vocab/model × embed/data
    lm_head = 128 // 4 * 512 // 2 * f32
    wq = wk = wv = wo = 128 // 4 * (4 // 2) * 32 * f32
    wi = 128 // 4 * 2 * 256 // 2 * f32
    wo_ffn = 256 // 2 * 128 // 4 * f32
    blocks = [wq, wk, wv, wo, wi, wo_ffn]
    # all-gather: the gathered leaf (local × 4), forward + backward, and
    # once more for block leaves under remat; serving: forward only
    gather_train = 4 * (2 * (embed + lm_head) + 3 * sum(blocks))
    gather_serve = 4 * (embed + lm_head + sum(blocks))
    scatter = embed + lm_head + sum(blocks)
    # grads of the leaves not split over data: the q/k/v biases (kv heads
    # over model) and the three norms
    bias = 4 // 2 * 32 * f32                   # bq [1, 4, 1, 32] over model
    reduce_grads = 3 * bias + 3 * 128 * f32
    act = 2 * 64 * 128 * f32                   # [B, S, D] of one device
    # TP: the embedding (vocab over model) forward; attention wo and MLP wo
    # forward, twice with remat; q/k/v and MLP wi backward; the LM head
    # backward
    tp_train = act * (1 + 2 + 2 + 1 + 1 + 1)
    tp_serve = act * (1 + 1 + 1)
    train, serve = r["train"], r["serve"]
    assert train["all-gather"] == gather_train
    assert train["reduce-scatter"] == scatter
    assert train["all-reduce"] == reduce_grads + tp_train
    assert train["all-to-all"] == train["collective-permute"] == 0
    assert train["count"] == (2 * 2 + 3 * 6) + 8 + 6 + 8
    assert serve == {"all-gather": gather_serve, "all-reduce": tp_serve,
                     "reduce-scatter": 0, "all-to-all": 0,
                     "collective-permute": 0, "count": 8 + 3}


def reduced_overrides(arch: str) -> dict:
    """The reduced config's differences from the full one, keeping
    deepseek-v3's 256 experts so that EP over 256 ranks applies."""
    import dataclasses
    from repro_torch.configs import get_config, reduced_config
    full = dataclasses.asdict(get_config(arch))
    red = dataclasses.asdict(reduced_config(arch))
    out = {k: v for k, v in red.items() if v != full[k]}
    if arch == "deepseek-v3-671b":
        out.update(n_experts=256, experts_per_token=8)
    return out


@pytest.fixture(scope="module")
def jax_experiments():
    """The JAX package's registry, read in a subprocess (importing it sets
    its 512-device XLA flags there only)."""
    return run("""
        import json
        from repro.launch.perf import EXPERIMENTS
        print(json.dumps(EXPERIMENTS, default=list))
    """, JAX_PLATFORMS="cpu")


def _normal(kw: dict) -> dict:
    return json.loads(json.dumps(kw, default=list))


def test_experiments_have_the_jax_names_and_arguments(jax_experiments):
    from repro_torch.launch import perf
    assert sorted(perf.EXPERIMENTS) == sorted(jax_experiments)
    for name, kw in perf.EXPERIMENTS.items():
        assert _normal(kw) == jax_experiments[name], name


@pytest.fixture(scope="module")
def reduced_runs():
    from repro_torch.launch import perf
    cells = {name: dict(kw, cfg_overrides=reduced_overrides(kw["arch"]))
             for name, kw in perf.EXPERIMENTS.items()}
    return run(f"""
        import json
        from repro_torch.launch.dryrun import run_cell
        from repro_torch.models import layers as L, model as M
        out = {{}}
        for name, kw in {cells!r}.items():
            out[name] = run_cell(quiet=True, **kw)
            # the switches are cleared after each cell
            assert L._EP_STATE is None and M._ACT_SPEC is None
        print(json.dumps(out))
    """)


def _experiment_names():
    from repro_torch.launch import perf
    return sorted(perf.EXPERIMENTS)


@pytest.mark.parametrize("name", _experiment_names())
def test_every_experiment_runs_on_a_reduced_config(reduced_runs, name):
    r = reduced_runs[name]
    assert r["status"] == "ok", r
    assert r["flops_per_device"] > 0
    coll = r["collective_bytes_per_device"]
    if name in ("deepseek_ep_a2a", "deepseek_ep_a2a_fsdp"):
        assert coll["all-to-all"] > 0      # EP dispatch over 256 ranks
    else:
        assert coll["all-to-all"] == 0
    if name.startswith("journal"):
        assert r["mesh"] == "2x16x16"


def test_journal_adds_the_integrity_record(reduced_runs):
    """The journaled step returns one int64 hash a grad leaf beside the
    same state."""
    on, off = reduced_runs["journal_on"], reduced_runs["journal_off"]
    extra = on["memory_analysis"]["output_size_in_bytes"] - \
        off["memory_analysis"]["output_size_in_bytes"]
    assert extra > 0 and extra % 8 == 0
    assert on["memory_analysis"]["argument_size_in_bytes"] == \
        off["memory_analysis"]["argument_size_in_bytes"]


def test_a_cell_that_cannot_run_reports_the_operator():
    """A data-dependent read on fake tensors fails the cell, names the
    operator, and replicates nothing."""
    r = run("""
        import json, torch
        from repro_torch.launch import dryrun
        from repro_torch.models import layers as L
        real = L.rms_norm
        def norm(x, w, eps=1e-6):
            if float(x.abs().max()) > 1e30:    # a data-dependent branch
                pass
            return real(x, w, eps)
        L.rms_norm = norm
        print(json.dumps(dryrun.run_cell(
            "qwen2-7b", "decode_32k", False, quiet=True,
            cfg_overrides=dict(n_layers=1))))
    """)
    assert r["status"] == "fail"
    assert "aten._local_scalar_dense" in r["error"], r["error"]


def test_skip_for_shapes_the_config_does_not_take():
    r = run("""
        import json
        from repro_torch.launch.dryrun import run_cell
        print(json.dumps(run_cell("hubert-xlarge", "decode_32k", False,
                                  quiet=True)))
    """)
    assert r["status"] == "skip"
    assert math.isfinite(len(r["reason"]))


def test_op_bytes_leave_out_views_and_metadata_queries():
    """The fake run's byte count on a known sequence: a product counts its
    operands and its result once; a view and ``prim.device`` (a metadata
    query autograd makes tens of thousands of times a step, which the
    dispatch mode sees twice per call here) count nothing."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import _OpBytes

    seen = []

    class Seen(_OpBytes):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(str(func))
            return super().__torch_dispatch__(func, types, args, kwargs)

    with FakeTensorMode():
        a, b = torch.zeros(64, 32), torch.zeros(32, 16)
        ops = Seen()
        with ops:
            c = a @ b
            c.t()
            assert torch.ops.prim.device.default(c) == torch.device("cpu")
    assert "prim.device.default" in seen and "aten.t.default" in seen
    assert ops.bytes == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert ops.last_op == "aten.t.default"
