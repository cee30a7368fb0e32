#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run it from the root of a checkout on a machine with a CUDA card; see
``benchmark/harness/core.py``.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark.harness import core  # noqa: E402

if __name__ == "__main__":
    sys.exit(core.main())
