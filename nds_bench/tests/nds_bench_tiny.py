"""Cells of ``BENCHMARK.json`` cut to sizes the CPU runs in seconds, for the
benchmark's own tests.  The widths and domains that the reference and the
check depend on stay; rows, pools and windows shrink."""

from __future__ import annotations

import time

from nds_bench.core import harness, registry

CPU_RATES = (3.35e12, None)  # the card's memory rate; no integer rate on the CPU


def shrink(cell: registry.Cell) -> registry.Cell:
    """``cell`` with small tasks: a few thousand rows, key domains small
    enough that pairs repeat and sides overlap, and q3's filter loose enough
    that hundreds of rows pass."""
    cfg, tr = cell.config, cell.traffic
    if cfg["query"] == "q97":
        per = cfg["sales_years"] * cfg["shuffle_partitions"]
        cfg.update(store_sales_rows=4000 * per, catalog_sales_rows=2000 * per,
                   customers=3000, items=200)
        if "budget_bytes" in tr:  # as tight against the tiny tasks as on the card
            tr["budget_bytes"] = int(0.9 * largest_working_set(cell))
    else:
        tr["task_rows"] = 1 << 14
        cfg.update(manufacturers=5, manufact_id=3)
    return cell


def largest_working_set(cell: registry.Cell) -> int:
    """The port's working-set estimate (``q97_working_set_bytes``) of the
    largest task of ``cell``'s pool, on one rank."""
    import numpy as np

    from spark_rapids_jni_tpu_torch.models.q97 import (
        Q97Batch,
        default_q97_capacity,
        q97_working_set_bytes,
    )

    out = 0
    for scale in set(cell.query.pool_scales(cell.traffic)):
        s, c = (np.zeros(n, np.int32) for n in cell.query.task_rows(cell.config, scale))
        batch = Q97Batch(s, s, c, c, capacity=default_q97_capacity(len(s) + len(c), 1))
        out = max(out, q97_working_set_bytes(batch, 1))
    return out


def tiny_cell(workload: str) -> registry.Cell:
    return shrink(registry.load_cell(workload))


def run_tiny(cell: registry.Cell, seed: int = 2**31 + 7, seconds: float = 0.5,
             trace: bool = False) -> dict:
    """One run of ``cell`` on the CPU; returns the result dict."""
    return harness.run_cell(cell, seed, seconds, trace, time.monotonic(), device="cpu",
                            rates=CPU_RATES)

