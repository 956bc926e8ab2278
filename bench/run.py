"""The benchmark of the PyTorch and CUDA aligner (``src/repro_torch``).

    python3 bench/run.py --workload wfa-100bp.score --seed 7 --seconds 20 \\
        --trace 0

Runs one cell of ``BENCHMARK.json`` on the card and prints its result as
the last line of standard output (see ``bench/README.md``).
"""
import time

T_PROC = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.join(os.path.dirname(_HERE), "src"))

from harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main(t_proc=T_PROC))
