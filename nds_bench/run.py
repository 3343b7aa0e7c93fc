#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 nds_bench/run.py --workload q97.tasks --seed 7 --seconds 30 --trace 0

Run from the root of a checkout that holds the port.  The cell, its
configuration, traffic mix, query, reference and metrics are found by the
names in ``BENCHMARK.json``.  The last line of standard output is the
result's JSON object.
"""

import os
import sys
import time


def _process_start() -> float:
    """The process's start on the monotonic clock (its age from /proc where
    the system has it)."""
    now = time.monotonic()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


if __name__ == "__main__":
    START = _process_start()
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    CACHE = os.path.join(ROOT, "build", "nds_bench_cache")
    # the program's build and kernel caches stay inside the checkout, at
    # fixed paths, so that only a checkout's first run builds
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ.setdefault("USE_FLAX", "0")
    sys.path.insert(0, ROOT)
    from nds_bench.core.harness import main

    sys.exit(main(process_start=START))
