"""The port's sharding rules, input specs and optimizer-state layout held
against the JAX package on the production meshes.

The JAX side runs in a subprocess on 512 forced host devices; the port's
side in another, over PyTorch's fake process group of 256 and 512 ranks
(so no default group leaks into the other tests of this worker).  Each
dumps every leaf's spec (a ``PartitionSpec``'s entries) and local shard
shape for all ten configs' params, every (arch × applicable shape)
batch and cache, and the optimizer state of qwen2-7b (AdamW) and
deepseek-v3 (Adafactor); the tests compare the two dumps.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
ARCHS = ["hubert-xlarge", "moonshot-v1-16b-a3b", "deepseek-v3-671b",
         "mamba2-130m", "jamba-1.5-large-398b", "starcoder2-3b", "gemma2-9b",
         "command-r-35b", "qwen2-7b", "llava-next-34b"]
MESHES = ["16x16", "2x16x16"]
OPT_ARCHS = ["qwen2-7b", "deepseek-v3-671b"]
# (shape, spec) leaves whose every device block is compared, including a
# dim split against the mesh order
BLOCK_LEAVES = [((3584, 4, 7, 128), ("data", None, None, "model")),
                ((256, 64), (("data", "model"),)),
                ((256, 64), (("model", "data"),)),
                ((64, 32), ("model", "data")),
                ((58, 256, 7168, 2, 2048), (None, "model", "data"))]
RANKS = {"16x16": [0, 1, 17, 200, 255], "2x16x16": [0, 19, 300, 511]}


def run(code: str, **env) -> dict:
    e = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), **env)
    out = subprocess.run([sys.executable, "-c", COMMON + textwrap.dedent(code)],
                         capture_output=True, text=True, env=e,
                         timeout=TIMEOUT)
    assert out.returncode == 0, f"stderr:\n{out.stderr}\nstdout:{out.stdout}"
    return json.loads(out.stdout.strip().splitlines()[-1])


COMMON = f"""
import json
ARCHS = {ARCHS!r}
OPT_ARCHS = {OPT_ARCHS!r}
BLOCK_LEAVES = {BLOCK_LEAVES!r}
RANKS = {RANKS!r}
SHAPE_NAMES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]

def norm(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]
"""


@pytest.fixture(scope="module")
def jax_dump():
    return run("""
        import numpy as np, jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from jax.tree_util import keystr, tree_flatten_with_path
        from repro.configs import get_config, applicable_shapes, input_specs
        from repro.distributed.sharding import ShardingRules
        from repro.launch import dryrun
        from repro.launch.mesh import make_production_mesh
        from repro.models import model as M

        def dump(specs, shardings):
            out = {}
            for (p, s), (_, ns) in zip(tree_flatten_with_path(specs)[0],
                                       tree_flatten_with_path(shardings)[0]):
                out[keystr(p)] = [norm(tuple(ns.spec)),
                                  list(ns.shard_shape(s.shape))]
            return out

        res = {}
        for multi in (False, True):
            mesh = make_production_mesh(multi_pod=multi)
            name = "x".join(str(v) for v in mesh.devices.shape)
            rules = ShardingRules(mesh)
            r = res[name] = {"params": {}, "inputs": {}, "opt": {},
                             "blocks": {}}
            for arch in ARCHS:
                cfg = get_config(arch)
                specs = M.param_specs(cfg)
                r["params"][arch] = dump(specs, rules.param_shardings(specs))
                for shape in applicable_shapes(cfg):
                    cell = input_specs(cfg, shape)
                    d = {"batch": dump(cell["batch"],
                                       rules.input_shardings(cell["batch"])),
                         "shapes": {keystr(p): [list(s.shape), str(s.dtype)]
                                    for p, s in tree_flatten_with_path(
                                        cell)[0] if hasattr(s, "shape")}}
                    if cell["cache"] is not None:
                        d["cache"] = dump(cell["cache"], rules.cache_shardings(
                            cell["cache"]))
                    r["inputs"][f"{arch} {shape}"] = d
            for arch in OPT_ARCHS:
                _, args, in_sh, _, _ = dryrun.build_cell(
                    get_config(arch), "train_4k", mesh)
                r["opt"][arch] = dump(args[0]["opt"], in_sh[0]["opt"])
            devs = mesh.devices.reshape(-1)
            for i, (shape, spec) in enumerate(BLOCK_LEAVES):
                idx = NamedSharding(mesh, P(*spec)).devices_indices_map(
                    tuple(shape))
                r["blocks"][str(i)] = {
                    str(k): [[sl.start or 0, sl.stop if sl.stop is not None
                              else n] for sl, n in zip(idx[devs[k]], shape)]
                    for k in RANKS[name]}
        print(json.dumps(res))
    """, JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=512")


@pytest.fixture(scope="module")
def port_dump():
    return run("""
        import torch, torch.distributed as dist
        from torch.distributed.tensor._utils import \\
            compute_local_shape_and_global_offset
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.configs import get_config, applicable_shapes, \\
            input_specs
        from repro_torch.distributed.sharding import ShardingRules, placements
        from repro_torch.launch import dryrun
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.models import model as M
        from repro_torch.tree import leaf_paths

        def dump(specs, shardings):
            sh = dict(leaf_paths(shardings))
            return {p: [norm(sh[p].spec), list(sh[p].shard_shape(s.shape))]
                    for p, s in leaf_paths(specs)}

        res = {}
        for multi, n in ((False, 256), (True, 512)):
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=n)
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            name = "x".join(str(v) for v in mesh.shape)
            rules = ShardingRules(mesh)
            r = res[name] = {"params": {}, "inputs": {}, "opt": {},
                             "blocks": {}, "mesh_size": mesh.size()}
            for arch in ARCHS:
                cfg = get_config(arch)
                specs = M.param_specs(cfg)
                r["params"][arch] = dump(specs, rules.param_shardings(specs))
                for shape in applicable_shapes(cfg):
                    cell = input_specs(cfg, shape)
                    d = {"batch": dump(cell["batch"],
                                       rules.input_shardings(cell["batch"])),
                         "shapes": {p: [list(s.shape),
                                        str(s.dtype).replace("torch.", "")]
                                    for p, s in leaf_paths(cell)
                                    if hasattr(s, "shape")}}
                    if cell["cache"] is not None:
                        d["cache"] = dump(cell["cache"], rules.cache_shardings(
                            cell["cache"]))
                    r["inputs"][f"{arch} {shape}"] = d
            for arch in OPT_ARCHS:
                _, args, in_sh, _, _ = dryrun.build_cell(
                    get_config(arch), "train_4k", mesh)
                r["opt"][arch] = dump(args[0]["opt"], in_sh[0]["opt"])
            dist.destroy_process_group()
            # every sampled rank's block through DTensor's own layout
            for k in RANKS[name]:
                dist.init_process_group("fake", store=FakeStore(), rank=k,
                                        world_size=n)
                mesh = make_production_mesh(multi_pod=multi,
                                            device_type="cpu")
                for i, (shape, spec) in enumerate(BLOCK_LEAVES):
                    spec = tuple(tuple(e) if isinstance(e, list) else e
                                 for e in spec)
                    size, off = compute_local_shape_and_global_offset(
                        shape, mesh, placements(spec, mesh))
                    r["blocks"].setdefault(str(i), {})[str(k)] = [
                        [o, o + s] for o, s in zip(off, size)]
                dist.destroy_process_group()
        print(json.dumps(res))
    """)


def _compare(port: dict, jax: dict, what: str) -> None:
    assert port.keys() == jax.keys(), what
    bad = {p: (port[p], jax[p]) for p in port if port[p] != jax[p]}
    assert not bad, f"{what}: {len(bad)} leaves differ, e.g. " \
        f"{list(bad.items())[:3]}"


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shard_shapes_match_jax(port_dump, jax_dump, mesh,
                                                arch):
    _compare(port_dump[mesh]["params"][arch], jax_dump[mesh]["params"][arch],
             f"{arch} params on {mesh}")


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_and_cache_specs_match_jax(port_dump, jax_dump, mesh, arch):
    cells = [k for k in jax_dump[mesh]["inputs"] if k.startswith(arch + " ")]
    assert cells and cells == [k for k in port_dump[mesh]["inputs"]
                               if k.startswith(arch + " ")]
    for cell in cells:
        port, jax = port_dump[mesh]["inputs"][cell], \
            jax_dump[mesh]["inputs"][cell]
        assert port.keys() == jax.keys(), cell
        for part in ("batch", "cache"):
            if part in jax:
                _compare(port[part], jax[part], f"{cell} {part} on {mesh}")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_shapes_and_dtypes_match_jax(port_dump, jax_dump, arch):
    for cell, d in jax_dump["16x16"]["inputs"].items():
        if cell.startswith(arch + " "):
            assert port_dump["16x16"]["inputs"][cell]["shapes"] == \
                d["shapes"], cell


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", OPT_ARCHS)
def test_optimizer_state_layout_matches_jax(port_dump, jax_dump, mesh, arch):
    """``opt_sh``: AdamW's m/v inherit the param spec; Adafactor's vr/vc
    drop a dim of it; ZeRO-1 where the param is replicated."""
    _compare(port_dump[mesh]["opt"][arch], jax_dump[mesh]["opt"][arch],
             f"{arch} optimizer state on {mesh}")


@pytest.mark.parametrize("mesh", MESHES)
def test_dtensor_blocks_are_jax_device_blocks(port_dump, jax_dump, mesh):
    """``placements`` on the DeviceMesh give every sampled rank the block
    (offsets and sizes, via DTensor's ``compute_local_shape_and_global_
    offset``) that JAX's NamedSharding gives the device at the same mesh
    coordinate, also for a dim split over (model, data), against the mesh
    order."""
    assert port_dump[mesh]["blocks"] == jax_dump[mesh]["blocks"]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_no_large_leaf_left_replicated(port_dump, mesh, arch):
    """tests/test_distributed.py's check on the port's rules: a leaf's
    share on one device is at most its even share of the mesh (1% slack)
    or 256 MB.  On the multi-pod mesh the params are replicated over the
    pods by default (the pod axis carries data parallelism; FSDP over it is
    the dry run's ``--fsdp-pods``), so the share is one pod's."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.tree import leaf_paths
    n = port_dump[mesh]["mesh_size"] // (2 if mesh == "2x16x16" else 1)
    got = port_dump[mesh]["params"][arch]
    bad = []
    for path, spec in leaf_paths(M.param_specs(get_config(arch))):
        item = np.dtype(str(spec.dtype).replace("torch.", "")
                        .replace("bfloat16", "float16")).itemsize
        nbytes = int(np.prod(spec.shape)) * item
        per_dev = int(np.prod(got[path][1])) * item
        if per_dev > max(nbytes / n * 1.01, 256e6):
            bad.append((path, spec.shape, got[path][0]))
    assert not bad, bad
