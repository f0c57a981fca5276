"""Run one cell of the benchmark once.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout; see ``bench/harness.py``.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root, not this directory: the benchmark is the package
# ``bench``, and the port is under ``src``.
sys.path[0] = ROOT
sys.path.insert(1, os.path.join(ROOT, "src"))

if __name__ == "__main__":
    from bench import harness
    sys.exit(harness.main(sys.argv[1:], T_START))
