"""Nothing the benchmark imports is JAX, Flax or the JAX package: module
names compared by their top-level part whole, so that ``repro_torch``
passes and ``repro`` does not."""

import ast
import json
import subprocess
import sys

from arcbench.harness import env

from .common import ROOT

BENCH = ROOT / "arcbench"


def _top_levels(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_source_imports_jax_or_the_jax_package():
    found = {}
    for path in BENCH.rglob("*.py"):
        bad = set(_top_levels(path)) & set(env.FORBIDDEN)
        if bad:
            found[str(path.relative_to(ROOT))] = sorted(bad)
    assert not found


def test_the_comparison_is_of_whole_top_level_names():
    assert "repro" in env.FORBIDDEN
    mods = dict(sys.modules)
    try:
        sys.modules["repro_torch_probe.x"] = sys.modules[__name__]
        assert "repro" not in env.forbidden_modules()
        sys.modules["repro.models"] = sys.modules[__name__]
        assert "repro" in env.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_a_run_loads_none_of_them(tmp_path):
    """A whole tiny run (set-up, window, check) in a fresh process."""
    script = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "from arcbench.tests.common import run_tiny\n"
        "from arcbench.harness import env\n"
        "out = run_tiny('mamba2-130m.train')\n"
        "run_tiny('mamba2-130m.prefill')\n"
        "print(json.dumps([out.correct, env.forbidden_modules()]))\n")
    res = subprocess.run([sys.executable, "-c", script], cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    correct, bad = json.loads(res.stdout.strip().splitlines()[-1])
    assert bad == []
