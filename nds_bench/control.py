#!/usr/bin/env python3
"""The control of a cell's correctness check, read at the cell's own size.

For each seed, the cell's task pool is made as a run makes it, and every
task's answer from the plain reference is compared with the control's: the
same reference with one of the configuration's guarantees broken
(``reference/<query>.py`` says which).  A control that the check cannot tell
from the program would make ``correct`` meaningless, so every seed must read
wrong answers.

    python3 nds_bench/control.py --workload q97.tasks --seeds 11 12 13

One JSON line per seed: the tasks compared and the control's wrong answers.
The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys
import time


def read(cell, seed: int, device) -> dict:
    """The control's reading on one seed: the pool's tasks compared, and how
    many the control answers wrongly."""
    pool = cell.query.make_pool(cell.config, cell.traffic, seed, device)
    ref = cell.reference
    t0 = time.perf_counter()
    want = ref.answers(pool.tasks, pool.shared, cell.config, device)
    got = ref.answers(pool.tasks, pool.shared, cell.config, device, control=True)
    return {"workload": cell.name, "seed": seed, "tasks": len(want),
            "control_wrong_answers": sum(1 for a, b in zip(want, got) if a != b),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from nds_bench.core import registry

    cell = registry.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(read(cell, seed, args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
