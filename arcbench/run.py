"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one run
of one cell.

    python3 arcbench/run.py --workload mamba2-130m.train --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout that holds ``src/repro_torch``; the cells
and metrics are named in ``BENCHMARK.json``.
"""

import time

T0 = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from arcbench.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
