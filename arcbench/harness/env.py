"""The run's surroundings: cache directories inside the checkout, the
card, and the modules that must not be loaded."""

from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def fixed_caches(root: Path) -> None:
    """Point every kernel and build cache a library may use at fixed
    directories inside the checkout (the port builds its own kernels into
    ``src/repro_torch/_build/``, which is inside it already)."""
    cache = root / "arcbench" / "_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's, Flax's or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def host_free_gb() -> float:
    """MemAvailable of the host, in GB (0 where it cannot be read)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return 0.0
