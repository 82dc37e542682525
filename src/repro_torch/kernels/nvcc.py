"""Build and load the port's CUDA kernels: one ``nvcc`` call per source.

Every kernel of the port is a ``csrc/*.cu`` file with a plain C
interface.  ``build`` compiles one source with ``nvcc`` into a shared
library in ``_build/`` beside the package's sources, named by the hash
of the source and the flags (an edited kernel is rebuilt, an unchanged
one is reused); ``load`` builds it if needed and opens it with
``ctypes`` once per process.  Nothing is compiled at import time: the
kernels' wrappers call ``load`` at their first launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_libs: Dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def library_path(source: Path) -> Path:
    """Where ``build`` puts the library of ``source``."""
    tag = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_DIR / f"libarcadia_{source.stem}-{tag}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless a library of the same source and flags is
    already built; returns the library's path.  Raises with nvcc's
    message if the build fails."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)                 # atomic: concurrent builders agree
    return out


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source``, built at the first call; ``bind``
    sets the C functions' argument and result types once."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            bind(lib)
            _libs[source] = lib
        return lib
