"""Run one cell of the benchmark once and print its result's line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder and
``svgir_tpu_torch``.  See ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(_HERE), str(_HERE.parent)]

from benchlib.run_cell import run  # noqa: E402

if __name__ == "__main__":
    run(T_START)
