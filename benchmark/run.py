"""Entry point of the benchmark: ``python3 benchmark/run.py --workload
<cell> --seed <n> --seconds <s> --trace <0|1>`` (``harness.py``)."""

import os
import sys
import time

T_START = time.perf_counter()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
