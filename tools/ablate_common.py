"""What the ablation tools share: build a patched copy of a kernel source
and time a call between CUDA events.

Imported by ``tools/flash_mma_ablate.py`` and ``tools/ssd_ablate.py``
(run as scripts from the repo, so ``tools/`` is on ``sys.path``).
"""

from __future__ import annotations

import subprocess
from pathlib import Path


def card() -> str:
    """The card's ``name, power.limit`` as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def variant(source: Path, prefix: str, name: str, subs) -> Path:
    """``source`` with each (old, new) of ``subs`` replaced (every ``old``
    must be in it), written as ``<prefix>_<stem>_<name>.cu`` beside the
    kernels' builds and built with their nvcc flags."""
    from repro_torch.kernels import nvcc

    text = source.read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"{name}: {source.name} no longer has "
                               f"{old[:60]!r}")
        text = text.replace(old, new)
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = nvcc.BUILD_DIR / f"{prefix}_{source.stem}_{name}.cu"
    path.write_text(text)
    nvcc.build(path)
    return path


def median_ms(fn, reps: int) -> float:
    """The median of ``reps`` calls of ``fn`` between CUDA events, after
    one call that is not timed."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]
