"""The port's slice as a whole, on the CPU.

The quickstart flow (examples/quickstart.py) runs through both packages
with equal outputs; the port's entry points default to the card and
raise where there is none; the port imports nothing of JAX or of the
JAX package; and chip_smoke.py fails without a card or without the
repository beside it.
"""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore

from torch_parity import durable, stats

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def quickstart(core, **dev_kw):
    """examples/quickstart.py as a function returning what it observed."""
    out = {}
    dev = core.PMEMDevice(core.device_size(1 << 20), mode="strict")
    log = core.Log.create(dev, core.LogConfig(capacity=1 << 20), **dev_kw)
    out["first"] = log.append(b"hello pmem")
    for i in range(16):
        rid, ptr = log.reserve(32)
        log.copy(rid, f"record-{i:02d}".encode().ljust(32))
        log.complete(rid)
        log.force(rid, freq=8)
    out["freq"] = (log.durable_lsn, log.completed_lsn,
                   log.vulnerability_window(), log.vulnerability_bound(8))
    survivor = dev.crash(np.random.default_rng(0), keep_probability=0.3)
    relog = core.Log.open(survivor, core.LogConfig(capacity=1 << 20),
                          **dev_kw)
    out["recovered"] = list(relog.iter_records())
    out["image"] = durable(survivor)
    out["stats"] = stats(dev)
    rs = core.build_replica_set(mode="local+remote", capacity=1 << 20,
                                n_backups=2, write_quorum=2, **dev_kw)
    try:
        out["replicated"] = [rs.log.append(f"replicated-{i}".encode())
                             for i in range(8)]
        out["n_durable"] = rs.n_durable
        rs.fail_backup("node1")
        out["partitioned"] = rs.log.append(b"still-durable")
        rs.group.drain()
        out["backup2"] = rs.servers[1].device.read(0, rs.servers[1].device.size)
    finally:
        rs.shutdown()
    return out


def test_quickstart_flow_matches_jax():
    got = quickstart(tcore, device="cpu")
    want = quickstart(jcore)
    assert got == want
    assert got["freq"] == (16, 17, 1, 8 * 64)
    assert got["partitioned"] == 9


def test_entry_points_default_to_the_card():
    dev = tcore.PMEMDevice(tcore.device_size(1 << 16))
    cfg = tcore.LogConfig(capacity=1 << 16)
    if torch.cuda.is_available():
        assert tcore.Log.create(dev, cfg).device.type == "cuda"
        return
    for call in (lambda: tcore.Log.create(dev, cfg),
                 lambda: tcore.Log.open(dev, cfg),
                 lambda: tcore.Log(dev, cfg),
                 lambda: tcore.build_replica_set(mode="local"),
                 lambda: tcore.quorum_recover([], cfg, write_quorum=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError):
        tcore.Log.create(dev, cfg, device="meta")


def test_port_has_no_environment_switch():
    src = "\n".join(p.read_text() for p in PORT.rglob("*.py"))
    assert "os.environ" not in src and "getenv" not in src


def imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax"), \
            f"{path.name} imports {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys; import repro_torch.core, "
            "repro_torch.kernels.checksum.ops, repro_torch.kernels.ssd_scan.ops, "
            "repro_torch.models.model, repro_torch.models.convert, "
            "repro_torch.checkpoint, repro_torch.configs, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.train, repro_torch.optim, repro_torch.data; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'repro.')) or m == 'repro']; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs for real there")
    res = run_smoke(ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the repository beside it
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = run_smoke(tmp_path)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


@pytest.mark.parametrize("seed", range(3))
def test_virtual_timeline_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jt, tt = jcore.VirtualTimeline(), tcore.VirtualTimeline()
    for _ in range(200):
        res = f"r{int(rng.integers(0, 4))}"
        busy, lat, after = (float(v) for v in rng.uniform(0, 100, 3))
        ji = jt.schedule(res, busy=busy, latency=lat, after=after)
        ti = tt.schedule(res, busy=busy, latency=lat, after=after)
        assert (ti.resource, ti.start, ti.busy_until, ti.end) == \
            (ji.resource, ji.start, ji.busy_until, ji.end)
    assert tt.clocks() == jt.clocks() and tt.makespan() == jt.makespan()
