"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Exits non-zero, printing no result, without
a CUDA card (or with fewer cards than the cell asks for), where the port
is missing, or where the run loaded the JAX package.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# one process, one host thread for torch's and numpy's CPU kernels: the
# port computes on the card, and idle OpenMP workers spinning beside the
# caller only add jitter to its walls
os.environ["OMP_NUM_THREADS"] = "1"

from perfbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
