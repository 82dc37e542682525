"""The port's distributed layer over gloo, held against the JAX package.

Each multi-rank scenario runs in its own processes: one per rank, joined
through a ``FileStore`` in the test's temporary directory (no fixed port,
so parallel test workers cannot clash), one thread each, every process
with its own timeout.  The JAX side runs once in a subprocess on 8 forced
host devices, as ``tests/test_distributed.py`` does; the two exchange
numpy arrays drawn from seeded ``np.random.default_rng``s.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.distributed import compression

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env.update({k: str(v) for k, v in extra.items()})
    return env


def run_jax(code: str, out_dir, n_devices: int = 8) -> None:
    env = _env(OUT=out_dir, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_devices}")
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, env=env,
                         timeout=TIMEOUT)
    assert out.returncode == 0, f"stderr:\n{out.stderr}\nstdout:{out.stdout}"


PREAMBLE = """
import os, numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD, OUT = int(os.environ["RANK"]), int(os.environ["WORLD"]), \\
    os.environ["OUT"]
dist.init_process_group("gloo", store=dist.FileStore(
    os.environ["STORE"], WORLD), rank=RANK, world_size=WORLD)
"""


def run_ranks(code: str, world: int, tmp_path) -> None:
    """Run ``code`` on ``world`` gloo ranks, one process each; every process
    has TIMEOUT seconds, and all are killed if one fails."""
    code = textwrap.dedent(PREAMBLE) + textwrap.dedent(code) + \
        "\ndist.destroy_process_group()\n"
    store = tmp_path / "store"
    procs = [subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=_env(RANK=r, WORLD=world, OUT=tmp_path, STORE=store))
        for r in range(world)]
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {r} rc {rc}\nstderr:\n{err}\nstdout:{out}"


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX package's pipeline, compressed all-reduce and EP runs on 8
    host devices, with the inputs they drew."""
    out = tmp_path_factory.mktemp("jax")
    run_jax("""
        import os, numpy as np, jax, jax.numpy as jnp
        from repro.configs import reduced_config
        from repro.distributed.compression import quantized_allreduce
        from repro.distributed.pipeline import pipeline_forward
        from repro.models import layers as L
        OUT = os.environ["OUT"]
        r = {}
        # pipeline: tests/test_distributed.py's scenario
        mesh = jax.make_mesh((4,), ("stage",))
        rng = np.random.default_rng(0)
        n_stages, n_micro, mb, d = 4, 8, 2, 16
        r["pipe_w"] = (rng.normal(size=(n_stages, d, d)) * 0.3
                       ).astype(np.float32)
        r["pipe_x"] = rng.normal(size=(n_micro, mb, d)).astype(np.float32)
        r["pipe_y"] = np.asarray(pipeline_forward(
            lambda w, h: jnp.tanh(h @ w), jnp.asarray(r["pipe_w"]),
            jnp.asarray(r["pipe_x"]), mesh=mesh, axis="stage",
            n_micro=n_micro))
        # compressed all-reduce over 8 ranks
        mesh = jax.make_mesh((8,), ("data",))
        r["comp_x"] = np.random.default_rng(1).normal(
            size=(8, 4096)).astype(np.float32)
        r["comp_y"] = np.asarray(quantized_allreduce(
            jnp.asarray(r["comp_x"]), mesh, "data"))
        # MoE EP on (4, 2), dropless reduced moonshot
        cfg = reduced_config("moonshot-v1-16b-a3b")
        rng = np.random.default_rng(0)
        B, S, D = 8, 16, cfg.d_model
        r["ep_x"] = (rng.normal(size=(B, S, D)) * 0.3).astype(np.float32)
        r["ep_router"] = (rng.normal(size=(D, cfg.n_experts)) * 0.1
                          ).astype(np.float32)
        r["ep_wi"] = (rng.normal(size=(cfg.n_experts, D, 2, cfg.moe_d_ff))
                      * 0.05).astype(np.float32)
        r["ep_wo"] = (rng.normal(size=(cfg.n_experts, cfg.moe_d_ff, D))
                      * 0.05).astype(np.float32)
        p = {"router": jnp.asarray(r["ep_router"]),
             "experts": {"wi": jnp.asarray(r["ep_wi"]),
                         "wo": jnp.asarray(r["ep_wo"])}}
        x = jnp.asarray(r["ep_x"])
        mesh = jax.make_mesh((4, 2), ("data", "model"))
        L.set_moe_ep(mesh, ("data", "model"))
        with mesh:
            y, aux = jax.jit(lambda x, p: L.moe_ffn(x, p, cfg))(x, p)
            gp, gx = jax.jit(jax.grad(lambda p, x: L.moe_ffn(x, p, cfg)[0]
                                      .sum(), argnums=(0, 1)))(p, x)
        L.set_moe_ep(None, None)
        r["ep_y"], r["ep_aux"] = np.asarray(y), np.asarray(aux)
        r["ep_gx"], r["ep_grouter"] = np.asarray(gx), np.asarray(gp["router"])
        r["ep_gwi"] = np.asarray(gp["experts"]["wi"])
        r["ep_gwo"] = np.asarray(gp["experts"]["wo"])
        np.savez(os.path.join(OUT, "jax.npz"), **r)
    """, str(out))
    return dict(np.load(out / "jax.npz"))


def test_pipeline_four_stages_matches_sequential_and_jax(jax_side, tmp_path):
    np.savez(tmp_path / "in.npz", w=jax_side["pipe_w"], x=jax_side["pipe_x"])
    run_ranks("""
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.distributed.pipeline import pipeline_forward
        d = np.load(os.path.join(OUT, "in.npz"))
        mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("stage",))
        y = pipeline_forward(lambda w, h: torch.tanh(h @ w),
                             torch.from_numpy(d["w"]), torch.from_numpy(d["x"]),
                             mesh=mesh, axis="stage", n_micro=8)
        np.save(os.path.join(OUT, f"y{RANK}.npy"), y.numpy())
    """, 4, tmp_path)
    w, x = torch.from_numpy(jax_side["pipe_w"]), torch.from_numpy(
        jax_side["pipe_x"])
    ref = x
    for s in range(4):
        ref = torch.tanh(ref @ w[s])
    ys = [np.load(tmp_path / f"y{r}.npy") for r in range(4)]
    for y in ys:                        # every stage holds the outputs
        np.testing.assert_array_equal(y, ys[0])
    np.testing.assert_allclose(ys[0], ref.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ys[0], jax_side["pipe_y"], rtol=1e-5,
                               atol=1e-5)


COMPRESS = """
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.distributed.compression import quantized_allreduce
x = torch.from_numpy(np.load(os.path.join(OUT, "x.npy")))
mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("data",))
np.save(os.path.join(OUT, f"y{RANK}.npy"),
        quantized_allreduce(x[RANK:RANK + 1], mesh, "data").numpy())
sr = [quantized_allreduce(x[RANK:RANK + 1], mesh, "data",
                          torch.Generator().manual_seed(1000 * s + RANK))
      for s in range(SEEDS)]
np.save(os.path.join(OUT, f"sr{RANK}.npy"), torch.cat(sr).numpy())
"""
SEEDS = 48


def test_quantized_allreduce_codes_match_jax(jax_side, tmp_path):
    """8 ranks: every rank gets JAX's output bitwise (so the int8 codes on
    the wire are JAX's), the plain version's, within 0.02 of exact relative
    to the largest value; with stochastic rounding each seed stays within
    its worst case, and the mean over seeds sits within the requantize
    step's half code of the exact sum."""
    x = jax_side["comp_x"]
    np.save(tmp_path / "x.npy", x)
    run_ranks(COMPRESS.replace("SEEDS", str(SEEDS)), 8, tmp_path)
    exact = x.sum(0)
    plain = compression.compressed_psum_reference(
        [torch.from_numpy(x[r:r + 1]) for r in range(8)]).numpy()
    scale2 = np.abs(x).max() / np.float32(127.0) * 8
    for r in range(8):
        y = np.load(tmp_path / f"y{r}.npy")[0]
        np.testing.assert_array_equal(y, jax_side["comp_y"][r])
        np.testing.assert_array_equal(y, plain[0])
        codes = np.round(y / scale2)         # int8 codes times scale2
        np.testing.assert_array_equal(codes.astype(np.float32) * scale2, y)
        assert np.abs(codes).max() <= 127
        rel = np.abs(y - exact).max() / np.abs(exact).max()
        assert rel < 0.02, rel
        sr = np.load(tmp_path / f"sr{r}.npy")
        # each seed: 8 stochastic roundings of under a code each, then the
        # requantize's half code of scale·8
        assert np.abs(sr - exact).max() <= (8 + 4) * scale2 / 8
        # mean over seeds: the first rounding is unbiased, the requantize
        # rounds to nearest (half a code of scale·8), plus 4 sigma of the
        # mean of 48 draws of 8 unit-variance-at-most roundings
        bias = np.abs(sr.mean(0) - exact).max()
        assert bias < 0.5 * scale2 + 4 * (scale2 / 8) * np.sqrt(8 / SEEDS)
    assert len({np.load(tmp_path / f"sr{r}.npy").tobytes()
                for r in range(8)}) == 1      # every rank the same sum


@pytest.mark.parametrize("frac", [0.3, 0.5, 0.7])
def test_stochastic_rounding_is_unbiased(frac):
    """x at ``frac`` of a code: round-to-nearest is off by up to half a
    code at every draw; the mean of stochastic roundings over 4096 seeds
    is within 4 sigma (sigma <= half a code / sqrt(4096)) of x."""
    scale = torch.tensor(0.01)
    x = torch.full((64,), frac, dtype=torch.float32) * scale + \
        torch.arange(64) * scale
    draws = torch.stack([
        compression._quantize(x, scale, torch.Generator().manual_seed(s)
                              ).float() * scale for s in range(4096)])
    bound = 4 * 0.5 * float(scale) / np.sqrt(4096)
    assert float((draws.mean(0) - x).abs().max()) < bound
    nearest = compression._quantize(x, scale).float() * scale
    assert float((nearest - x).abs().min()) > bound


EP = """
import torch.distributed.nn.functional
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.configs import reduced_config
from repro_torch.models import layers as L
d = np.load(os.path.join(OUT, "in.npz"))
cfg = reduced_config("moonshot-v1-16b-a3b")
mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))

def run(kind):
    x = torch.from_numpy(d["x"]).requires_grad_(True)
    p = {"router": torch.from_numpy(d["router"]).requires_grad_(True),
         "experts": {"wi": torch.from_numpy(d["wi"]).requires_grad_(True),
                     "wo": torch.from_numpy(d["wo"]).requires_grad_(True)}}
    leaves = [x, p["router"], p["experts"]["wi"], p["experts"]["wo"]]
    xin = x
    if kind == "dtensor":
        xin = distribute_tensor(x.detach(), mesh, [Shard(0), Shard(1)]
                                ).requires_grad_(True)
        leaves[0] = xin
    L.set_moe_ep(mesh, None if kind == "dense" else ("data", "model"))
    try:
        y, aux = L.moe_ffn(xin, p, cfg)
    finally:
        L.set_moe_ep(None, None)
    if kind == "dtensor":
        y, aux = y.full_tensor(), aux.full_tensor()
    y.sum().backward()
    grads = [t.grad.full_tensor() if kind == "dtensor" and i == 0
             else t.grad for i, t in enumerate(leaves)]
    return [y, aux] + grads

for kind in ("dense", "plain", "dtensor"):
    vals = run(kind)
    np.savez(os.path.join(OUT, f"{kind}{RANK}.npz"),
             **{k: v.detach().numpy() for k, v in zip(
                 ("y", "aux", "gx", "grouter", "gwi", "gwo"), vals)})
"""


def test_moe_expert_parallel_matches_dense_and_jax(jax_side, tmp_path):
    """(4, 2) mesh, 8 ranks, reduced moonshot (8 experts, top-3, capacity
    factor 8: dropless): EP with plain inputs and with a DTensor x equals
    the dense ``moe_ffn`` and the JAX package's EP within 1e-5, on y, aux
    and the grads of x, router, wi and wo, on every rank."""
    np.savez(tmp_path / "in.npz", **{k[3:]: v for k, v in jax_side.items()
                                     if k in ("ep_x", "ep_router", "ep_wi",
                                              "ep_wo")})
    run_ranks(EP, 8, tmp_path)
    dense = np.load(tmp_path / "dense0.npz")
    for r in range(8):
        for kind in ("plain", "dtensor"):
            ep = np.load(tmp_path / f"{kind}{r}.npz")
            for k in ("y", "aux", "gx", "grouter", "gwi", "gwo"):
                np.testing.assert_allclose(ep[k], dense[k], rtol=1e-5,
                                           atol=1e-5, err_msg=f"{kind} {k}")
                np.testing.assert_allclose(ep[k], jax_side[f"ep_{k}"],
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{kind} {k} vs jax")
    assert np.abs(dense["gwi"]).max() > 0 and np.abs(dense["gx"]).max() > 0


def test_moe_ep_is_not_applicable_off_the_grid():
    """EP needs the batch to split over data, the sequence over model and
    the experts over both; otherwise moe_ffn keeps the dense path."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import layers as L

    class Mesh:                          # only names and sizes are read
        mesh_dim_names, shape = ("data", "model"), (4, 2)
    cfg = reduced_config("moonshot-v1-16b-a3b")
    L.set_moe_ep(Mesh(), ("data", "model"))
    try:
        assert L._moe_ep_applicable(torch.empty(8, 16, 4), cfg)
        assert not L._moe_ep_applicable(torch.empty(6, 16, 4), cfg)
        assert not L._moe_ep_applicable(torch.empty(8, 15, 4), cfg)
        L.set_moe_ep(Mesh(), ("data", "pod"))
        assert not L._moe_ep_applicable(torch.empty(8, 16, 4), cfg)
    finally:
        L.set_moe_ep(None, None)
    assert not L._moe_ep_applicable(torch.empty(8, 16, 4), cfg)


ELASTIC = """
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from repro_torch.checkpoint import (CheckpointConfig, CheckpointManager,
                                    ObjectStore, ReplicatedStore)
from repro_torch.core import Log, LogConfig, PMEMDevice
from repro_torch.distributed.sharding import placements
mesh_a = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
w = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
state = {"w": distribute_tensor(w, mesh_a, placements(("data", "model"),
                                                      mesh_a))}
log = Log.create(PMEMDevice(1 << 20), LogConfig(capacity=1 << 18),
                 device="cpu")
mgr = CheckpointManager(ReplicatedStore([ObjectStore("s0")], 1), log,
                        CheckpointConfig(chunks_per_leaf=4))
mgr.save(1, state, sync=True)
# restore onto a different mesh layout
mesh_b = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
template = {"w": distribute_tensor(torch.zeros(64, 32), mesh_b,
                                   placements(("model", "data"), mesh_b))}
step, got, _ = mgr.restore(template)
mgr.close()
wb = got["w"]
assert step == 1 and tuple(wb.device_mesh.shape) == (2, 4)
np.save(os.path.join(OUT, f"full{RANK}.npy"), wb.full_tensor().numpy())
np.save(os.path.join(OUT, f"local{RANK}.npy"), wb.to_local().numpy())
"""


def test_elastic_restore_onto_another_mesh(tmp_path):
    """A state saved from a (4, 2) mesh as P("data", "model") restores onto
    a (2, 4) mesh as P("model", "data") bitwise: every rank's block is the
    one JAX's NamedSharding gives its device."""
    run_ranks(ELASTIC, 8, tmp_path)
    w = np.arange(64 * 32, dtype=np.float32).reshape(64, 32)
    for r in range(8):
        np.testing.assert_array_equal(np.load(tmp_path / f"full{r}.npy"), w)
        d, m = divmod(r, 4)              # coordinate on (data=2, model=4)
        np.testing.assert_array_equal(np.load(tmp_path / f"local{r}.npy"),
                                      w[m * 16:(m + 1) * 16,
                                        d * 16:(d + 1) * 16])


def test_card_entry_points_raise_without_a_card():
    """No fallback: asking for the card where there is none raises."""
    from repro_torch.distributed import backend_for, one_rank_group
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert backend_for("cpu") == "gloo"
    for call in (lambda: backend_for("cuda"),
                 lambda: make_smoke_mesh(1, device_type="cuda"),
                 lambda: make_production_mesh()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with one_rank_group("cuda"):
            pass


def test_smoke_mesh_over_a_one_rank_gloo_group():
    import torch.distributed as dist
    from repro_torch.distributed import one_rank_group
    from repro_torch.launch.mesh import make_smoke_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_smoke_mesh(device_type="cpu")
    with one_rank_group("cpu"):
        mesh = make_smoke_mesh(device_type="cpu")
        assert dist.get_backend() == "gloo"
        assert tuple(mesh.shape) == (1, 1)
        assert mesh.mesh_dim_names == ("data", "model")
    assert not dist.is_initialized()
