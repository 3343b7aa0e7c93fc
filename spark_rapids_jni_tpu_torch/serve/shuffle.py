"""The range shuffle's single-process driver and its ordered combine
(PyTorch port of part of ``serve/shuffle.py``).

A RangeExchange plan splits at the exchange (``plans/compiler.
split_exchange_plan``): the map side ranks rows by the exchange's sort keys
and buckets them against splitters sampled once from the whole input, so
every shard agrees on the global order; each partition's reduce plan orders
its rows locally with its Sort/TopK sink; and the combine concatenates the
per-partition results in partition order -- partition ``p``'s every row
orders before partition ``p+1``'s, so the concatenation is the merge.

Here are the pieces that need no transport: the shard split
(:func:`split_tables_n`, :func:`range_split_n`), the trim of a reduce output
to its valid rows (:func:`_slice_order_output`), the ordered combine
(:func:`combine_ordered_outputs`) and the single-process oracle
(:func:`run_range_plan_local`).  The peer-to-peer shuffle service, the
executor-side shuffle handlers and the hash exchange's drivers come with the
rest of the serving layer (ROADMAP A.15b).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.compiler import (
    EXCHANGE_SOURCE,
    emit_range_partitions,
    sample_range_splitters,
    split_exchange_plan,
)
from spark_rapids_jni_tpu_torch.plans.runtime import execute_plan

__all__ = ["scan_table_names", "split_tables_n", "range_split_n", "make_range_split",
           "combine_ordered_outputs", "run_range_plan_local"]


def scan_table_names(plan) -> set:
    """Names of the plan's scan tables (what split_tables_n chunks)."""
    return {s.table for s in ir.scan_tables(plan)}


def split_tables_n(tables: Dict[str, Dict[str, np.ndarray]],
                   scan_names, n: int) -> List[dict]:
    """Split scan tables into ``n`` contiguous row chunks (dims ride whole
    into every chunk) -- the supervisor-side shard split."""
    out: List[dict] = [{} for _ in range(n)]
    for table, fields in tables.items():
        if table not in scan_names:
            for shard in out:
                shard[table] = fields
            continue
        rows = len(next(iter(fields.values())))
        for i, shard in enumerate(out):
            lo, hi = rows * i // n, rows * (i + 1) // n
            shard[table] = {k: v[lo:hi] for k, v in fields.items()}
    return out


def range_split_n(plan, tables: Dict[str, Dict[str, np.ndarray]], n: int,
                  sample_cap: int = 4096, device: _device.DeviceLike = None) -> List[dict]:
    """The shard split of a RangeExchange plan: choose splitters once from
    the WHOLE input (sampled, the map fragment emitted on ``device``), then
    chunk the scan tables into ``n`` contiguous row shards, each carrying the
    same splitters."""
    exchange, _reduce = split_exchange_plan(plan)
    splitters = sample_range_splitters(exchange, tables, n, sample_cap=sample_cap,
                                       device=device)
    shards = split_tables_n(tables, scan_table_names(plan), n)
    return [{"tables": s, "splitters": splitters} for s in shards]


def make_range_split(plan, sample_cap: int = 4096,
                     device: _device.DeviceLike = None) -> Callable:
    def split_n(tables, n):
        return range_split_n(plan, tables, n, sample_cap=sample_cap, device=device)

    return split_n


def _slice_order_output(reduce_plan, out) -> Dict[str, np.ndarray]:
    """Trim an order sink's padded output vectors to the valid ``rows``
    prefix (invalid rows sort last by construction): exact-size rows are
    what crosses the wire and what the ordered combine glues."""
    sink = ir.order_sink(reduce_plan)
    rows = int(out["rows"])
    sliced = {f: np.asarray(out[f])[:rows] for f in sink.fields}
    sliced["rows"] = np.int64(rows)
    return sliced


def combine_ordered_outputs(plan) -> Callable:
    """The join combiner of a range shuffle: results arrive in PARTITION
    order, each already sorted within its key range, so the global result is
    their concatenation -- plus the TopK truncation, since k rows per
    partition can still be nparts*k rows in all.  Produce-only revivals'
    marker results are skipped."""
    sink = ir.order_sink(plan)
    if sink is None:
        raise ValueError(
            f"plan {plan.name!r} has no Sort/TopK sink: use "
            f"combine_exchange_outputs for additive plans")

    def combine(outs: List[Dict[str, np.ndarray]]):
        parts = [o for o in outs
                 if o is not None and not ("reproduced" in o and len(o) == 1)]
        cat = {f: np.concatenate([np.asarray(p[f]) for p in parts]) for f in sink.fields}
        rows = sum(int(p["rows"]) for p in parts)
        if isinstance(sink, ir.TopK):
            k = int(sink.k)
            cat = {f: v[:k] for f, v in cat.items()}
            rows = min(rows, k)
        cat["rows"] = np.int64(rows)
        return cat

    return combine


def run_range_plan_local(plan, tables, device: _device.DeviceLike = None
                         ) -> Dict[str, np.ndarray]:
    """The single-process oracle of the range shuffle: one shard, one
    partition, no splitters, no transport -- the map emit, an identity
    'shuffle', the same reduce plan, sliced to the valid rows.  Both halves
    run on ``device``, the card unless the caller asks for the CPU.  A
    cluster's outputs must equal this bit for bit, row order included."""
    exchange, reduce_plan = split_exchange_plan(plan)
    (part0,) = emit_range_partitions(exchange, tables, 1, (), device=device)
    reduce_tables: Dict[str, Any] = {EXCHANGE_SOURCE: part0}
    for dim in ir.dim_tables(reduce_plan):
        reduce_tables[dim.table] = tables[dim.table]
    out = execute_plan(None, reduce_plan, reduce_tables, device=device)
    return _slice_order_output(reduce_plan, out)
