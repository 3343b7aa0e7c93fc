"""NDS q5: the three-channel sales/returns rollup (PyTorch port of
``models/q5.py``).

TPC-DS q5 unions store, catalog and web channel activity over a 14-day
window, computing per-business-id sales, returns and profit, grouped by
ROLLUP(channel, id).  Per channel:

1. **date dim join** (device): membership of each fact row's date_sk in the
   filtered date_dim window via searchsorted over the (tiny, replicated)
   dim -- the broadcast-join analog of the Spark plan.
2. **null-key semantics**: fact rows with null dim/date foreign keys drop
   out of the inner joins, exactly as in SQL.
3. **partial aggregation** (device): masked segment sums into dense
   per-dim-sk buckets -- sales cents, return cents, profit cents, and a
   contributing-row count.  Money is decimal(7,2) as unscaled int64 cents;
   sums widen to decimal(17,2), which stays int64-exact.
4. **exchange**: the partial vectors summed over the data axis (rows never
   need a shuffle: the dim space is dense and small).
5. **rollup** (host, tiny): (channel, id) rows -> channel totals -> grand
   total, with the string business ids attached from the dim table.

The device side is ONE plan (:func:`q5_plan`): all six fact streams (3
channels x sales/returns), their window semi-joins and segment
aggregations, run by the plan executor and cached on (plan structure,
dtype signature, pow2 batch bucket).  The governed runner admits the whole
plan as one working set, and SplitAndRetryOOM re-executes the plan on split
halves -- exact, because every aggregate is additive.  The per-op eager path
survives as :func:`q5_local_unfused`, the parity oracle of the plan.
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.models.tpcds import CHANNELS, Q5Data
from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.compiler import segment_sum, window_index
from spark_rapids_jni_tpu_torch.plans.ir import Bin, Cast, band_all, col, lit

__all__ = [
    "Q5Row",
    "q5_local",
    "q5_local_unfused",
    "q5_plan",
    "make_distributed_q5",
    "run_distributed_q5",
    "run_q5_partials",
    "q5_rollup",
    "q5_host_channel_partials",
    "ChannelPartials",
    "add_partials",
]


class Q5Row(NamedTuple):
    """One result row: ROLLUP levels use None for grouped-out columns."""

    channel: object  # str | None
    id: object  # str | None
    sales: int  # cents
    returns_: int
    profit: int


class ChannelPartials(NamedTuple):
    """Per-dim-sk partial aggregates of one channel -- ADDITIVE over any
    disjoint row partition (the invariant row splits rely on)."""

    sales: object  # int64[n_dim]
    returns_: object
    profit: object
    count: object  # int32[n_dim] contributing rows (sales+returns)


def add_partials(
    a: Dict[str, ChannelPartials], b: Dict[str, ChannelPartials]
) -> Dict[str, ChannelPartials]:
    """Element-wise sum of per-channel partial dicts."""
    return {name: ChannelPartials(*(x + y for x, y in zip(a[name], b[name])))
            for name in a}


# ------------------------------------------------------------------ the plan


@functools.lru_cache(maxsize=64)
def q5_plan(n_dims: Tuple[int, ...], lo: int, hi: int) -> ir.Plan:
    """The whole q5 device pipeline as ONE plan: per channel, the sales and
    returns streams each scan -> bounds/null filter -> date-window semi-join
    -> masked segment aggregation; profit and count derive in post over the
    summed partial vectors.  Geometry scalars are normalized to python ints
    (via ``plans.ir.lit``), so equal geometry always builds an EQUAL plan --
    one cache entry."""
    n_dims = tuple(int(n) for n in n_dims)
    dim = ir.Dim("date_dim", ("sk", "days"))
    sinks: list = []
    post: list = []
    outputs: list = []

    for name, n_dim in zip(CHANNELS, n_dims):
        for suffix, value_fields, aggs in (
            ("sales", ("price", "profit"),
             ((f"{name}_sales", col("price"), "int64"),
              (f"{name}_profit_s", col("profit"), "int64"),
              (f"{name}_count_s", lit(1), "int32"))),
            ("ret", ("amt", "loss"),
             ((f"{name}_returns", col("amt"), "int64"),
              (f"{name}_loss", col("loss"), "int64"),
              (f"{name}_count_r", lit(1), "int32"))),
        ):
            node: ir.Node = ir.Scan(
                f"{name}_{suffix}",
                ("sk", "sk_valid", "date", "date_valid") + value_fields)
            node = ir.Filter(node, band_all(
                col("sk_valid"),
                Bin("ge", col("sk"), lit(1)),
                Bin("le", col("sk"), lit(n_dim)),
            ))
            node = ir.SemiJoinWindow(
                node, dim, key=col("date"), key_valid=col("date_valid"),
                sk_field="sk", days_field="days", lo=lit(lo), hi=lit(hi))
            sinks.append(ir.SegmentAgg(
                node, key=Bin("sub", Cast(col("sk"), "int32"), lit(1)),
                num_segments=n_dim, aggs=aggs))
        post.append((f"{name}_profit",
                     Bin("sub", col(f"{name}_profit_s"), col(f"{name}_loss"))))
        post.append((f"{name}_count",
                     Bin("add", col(f"{name}_count_s"), col(f"{name}_count_r"))))
        outputs.extend([f"{name}_sales", f"{name}_returns",
                        f"{name}_profit", f"{name}_count"])
    return ir.Plan("q5", tuple(sinks), tuple(post), tuple(outputs))


def _q5_tables(batch: Dict[str, Dict[str, np.ndarray]],
               date_sk: np.ndarray, date_days: np.ndarray):
    """The plan's input tables from a per-channel fact-array batch (the
    ``_facts_of`` field names)."""
    tables = {"date_dim": {"sk": np.asarray(date_sk), "days": np.asarray(date_days)}}
    for name, facts in batch.items():
        tables[f"{name}_sales"] = {
            "sk": facts["sales_sk"], "sk_valid": facts["sales_sk_valid"],
            "date": facts["sales_date"], "date_valid": facts["sales_date_valid"],
            "price": facts["sales_price"], "profit": facts["sales_profit"],
        }
        tables[f"{name}_ret"] = {
            "sk": facts["ret_sk"], "sk_valid": facts["ret_sk_valid"],
            "date": facts["ret_date"], "date_valid": facts["ret_date_valid"],
            "amt": facts["ret_amt"], "loss": facts["ret_loss"],
        }
    return tables


def _partials_of(outputs: Dict[str, np.ndarray]) -> Dict[str, ChannelPartials]:
    return {name: ChannelPartials(
        outputs[f"{name}_sales"], outputs[f"{name}_returns"],
        outputs[f"{name}_profit"], outputs[f"{name}_count"])
        for name in CHANNELS}


def _plan_and_tables(data: Q5Data):
    n_dims = tuple(len(data.channels[n].dim_sk) for n in CHANNELS)
    plan = q5_plan(n_dims, data.sales_date_lo, data.sales_date_hi)
    tables = _q5_tables({n: _facts_of(data.channels[n]) for n in CHANNELS},
                        data.date_sk, data.date_days)
    return plan, tables


def _dim_ids(data: Q5Data) -> Dict[str, List[str]]:
    return {n: data.channels[n].dim_id for n in CHANNELS}


# ------------------------------------------------------- unfused oracle path


def _window_member(date, date_valid, dim_sk, dim_days, lo, hi):
    """Inner-join membership of fact date_sk in the filtered date dim."""
    idx = window_index(dim_sk, date)
    hit = dim_sk[idx] == date
    in_win = (dim_days[idx] >= lo) & (dim_days[idx] < hi)
    return date_valid & hit & in_win


def _masked_segment(values, sk, ok, n_dim, dtype=torch.int64):
    """Segment sum of values into 1-based sk buckets, masked rows dropped."""
    bucket = torch.where(ok, sk.to(torch.int32) - 1, n_dim)
    return segment_sum(torch.where(ok, values, 0).to(dtype), bucket, n_dim)


def _channel_partials(ch, n_dim, dim_sk, dim_days, lo, hi) -> ChannelPartials:
    """One shard's partial aggregates for one channel, per-op eager form.

    ``ch`` is a dict of this channel's fact tensors (see models/tpcds.py
    ChannelTables field names).  The plan's parity oracle."""
    s_ok = ch["sales_sk_valid"] & (ch["sales_sk"] >= 1) & (
        ch["sales_sk"] <= n_dim
    ) & _window_member(ch["sales_date"], ch["sales_date_valid"],
                       dim_sk, dim_days, lo, hi)
    r_ok = ch["ret_sk_valid"] & (ch["ret_sk"] >= 1) & (
        ch["ret_sk"] <= n_dim
    ) & _window_member(ch["ret_date"], ch["ret_date_valid"],
                       dim_sk, dim_days, lo, hi)

    sales = _masked_segment(ch["sales_price"], ch["sales_sk"], s_ok, n_dim)
    profit_s = _masked_segment(ch["sales_profit"], ch["sales_sk"], s_ok, n_dim)
    returns_ = _masked_segment(ch["ret_amt"], ch["ret_sk"], r_ok, n_dim)
    loss = _masked_segment(ch["ret_loss"], ch["ret_sk"], r_ok, n_dim)
    count = (
        _masked_segment(torch.ones_like(ch["sales_sk"]), ch["sales_sk"],
                        s_ok, n_dim, torch.int32)
        + _masked_segment(torch.ones_like(ch["ret_sk"]), ch["ret_sk"],
                          r_ok, n_dim, torch.int32)
    )
    return ChannelPartials(sales, returns_, profit_s - loss, count)


def _facts_of(ch_tables) -> Dict[str, np.ndarray]:
    return {
        "sales_sk": ch_tables.sales_sk,
        "sales_sk_valid": ch_tables.sales_sk_valid,
        "sales_date": ch_tables.sales_date,
        "sales_date_valid": ch_tables.sales_date_valid,
        "sales_price": ch_tables.sales_price,
        "sales_profit": ch_tables.sales_profit,
        "ret_sk": ch_tables.ret_sk,
        "ret_sk_valid": ch_tables.ret_sk_valid,
        "ret_date": ch_tables.ret_date,
        "ret_date_valid": ch_tables.ret_date_valid,
        "ret_amt": ch_tables.ret_amt,
        "ret_loss": ch_tables.ret_loss,
    }


def q5_local_unfused(data: Q5Data, device: _device.DeviceLike = None) -> List[Q5Row]:
    """Per-op eager q5 on ``device`` (the card unless the caller asks for
    the CPU): partials per channel, host rollup.  The plan path's oracle."""
    dev = _device.resolve(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    dim_sk, dim_days = t(data.date_sk), t(data.date_days)
    per_channel = {}
    for name in CHANNELS:
        ch = data.channels[name]
        parts = _channel_partials(
            {k: t(v) for k, v in _facts_of(ch).items()},
            len(ch.dim_sk), dim_sk, dim_days,
            data.sales_date_lo, data.sales_date_hi,
        )
        per_channel[name] = ChannelPartials(*(p.cpu().numpy() for p in parts))
    return q5_rollup(per_channel, _dim_ids(data))


def q5_local(data: Q5Data, device: _device.DeviceLike = None) -> List[Q5Row]:
    """Single-device q5 through the plan, on ``device`` (the card unless the
    caller asks for the CPU): the whole six-stream pipeline is one cached
    executor, then the host rollup."""
    from spark_rapids_jni_tpu_torch.plans.runtime import execute_plan

    plan, tables = _plan_and_tables(data)
    outputs = execute_plan(None, plan, tables, device=device)
    return q5_rollup(_partials_of(outputs), _dim_ids(data))


def q5_rollup(per_channel: Dict[str, ChannelPartials],
              dim_ids: Dict[str, List[str]]) -> List[Q5Row]:
    """ROLLUP(channel, id) formatting: leaf rows, channel totals, grand
    total -- ordered like the SQL output (channel, id, nulls last).
    ``dim_ids`` maps channel -> business-id strings (dim_sk order)."""
    rows: List[Q5Row] = []
    g_sales = g_ret = g_prof = 0
    for name in CHANNELS:
        p = per_channel[name]
        ids = dim_ids[name]
        c_sales = c_ret = c_prof = 0
        leaf: List[Q5Row] = []
        for i in range(len(ids)):
            if int(p.count[i]) == 0:
                continue  # group absent from the filtered join
            s, r, pr = int(p.sales[i]), int(p.returns_[i]), int(p.profit[i])
            leaf.append(Q5Row(name, ids[i], s, r, pr))
            c_sales += s
            c_ret += r
            c_prof += pr
        rows.extend(sorted(leaf, key=lambda q: q.id))
        rows.append(Q5Row(name, None, c_sales, c_ret, c_prof))
        g_sales += c_sales
        g_ret += c_ret
        g_prof += c_prof
    rows.append(Q5Row(None, None, g_sales, g_ret, g_prof))
    return rows


# ------------------------------------------------------------- distributed --


def make_distributed_q5(mesh, data: Q5Data):
    """The executor of distributed q5 over ``mesh``'s data axis: the
    :class:`plans.cache.CompiledPlan` for ``data``'s geometry and batch
    bucket.  Its ``fn`` runs on each rank over that rank's flat data shards
    (``plans.runtime.plan_inputs``); facts are sharded over ``data``, the
    date dim replicated, the partial vectors summed.  Same-geometry data
    returns the IDENTICAL cached object, with O(1) host work on a hit: the
    key derives from lengths and dtypes alone."""
    from spark_rapids_jni_tpu_torch.plans.runtime import compiled_plan_for

    plan, tables = _plan_and_tables(data)
    return compiled_plan_for(plan, mesh, tables)


def run_q5_partials(
    mesh,
    batch: Dict[str, Dict[str, np.ndarray]],
    *,
    date_sk: np.ndarray,
    date_days: np.ndarray,
    n_dims: Tuple[int, ...],
    lo: int,
    hi: int,
    budget=None,
    task_id: int = 0,
    manage_task: bool = True,
    device: _device.DeviceLike = None,
) -> Dict[str, ChannelPartials]:
    """Governed q5 PARTIALS over a host fact batch, over ``mesh`` (every rank
    passing the same batch) or, with ``mesh`` None, on ``device`` (the card
    unless the caller asks for the CPU).

    ``batch`` maps channel -> fact-array dict (the ``_facts_of`` field
    names).  The whole pipeline is ONE plan under ONE governed bracket: one
    admission for its working set, RetryOOM re-runs the plan,
    SplitAndRetryOOM halves every fact stream and re-executes the plan per
    half (exact -- all aggregates are additive), and one flight-recorder
    task spans the plan.
    """
    from spark_rapids_jni_tpu_torch.plans.runtime import run_governed_plan

    plan = q5_plan(tuple(n_dims), lo, hi)
    tables = _q5_tables(batch, date_sk, date_days)
    outputs = run_governed_plan(
        mesh, plan, tables,
        budget=budget, task_id=task_id, manage_task=manage_task, device=device,
    )
    return _partials_of(outputs)


def run_distributed_q5(mesh, data: Q5Data, *, budget=None, task_id: int = 0,
                       manage_task: bool = True,
                       device: _device.DeviceLike = None) -> List[Q5Row]:
    """Governed q5 over host data: the plan's partials via
    :func:`run_q5_partials`, then the host rollup."""
    per_channel = run_q5_partials(
        mesh,
        {n: _facts_of(data.channels[n]) for n in CHANNELS},
        date_sk=data.date_sk,
        date_days=data.date_days,
        n_dims=tuple(len(data.channels[n].dim_sk) for n in CHANNELS),
        lo=data.sales_date_lo,
        hi=data.sales_date_hi,
        budget=budget,
        task_id=task_id,
        manage_task=manage_task,
        device=device,
    )
    return q5_rollup(per_channel, _dim_ids(data))


def q5_host_channel_partials(facts: Dict[str, np.ndarray], n_dim: int,
                             date_sk: np.ndarray, date_days: np.ndarray,
                             lo: int, hi: int) -> ChannelPartials:
    """Host (numpy) oracle for one channel's partial vectors -- the same
    join/filter/segment-sum semantics as the device body, int64-exact."""
    def member(date, dvalid):
        idx = np.clip(np.searchsorted(date_sk, date), 0, len(date_sk) - 1)
        hit = date_sk[idx] == date
        in_win = (date_days[idx] >= lo) & (date_days[idx] < hi)
        return dvalid & hit & in_win

    def seg(values, sk, ok, dtype=np.int64):
        acc = np.zeros(n_dim, dtype)
        np.add.at(acc, sk[ok].astype(np.int64) - 1, values[ok].astype(dtype))
        return acc

    s_ok = (facts["sales_sk_valid"] & (facts["sales_sk"] >= 1)
            & (facts["sales_sk"] <= n_dim)
            & member(facts["sales_date"], facts["sales_date_valid"]))
    r_ok = (facts["ret_sk_valid"] & (facts["ret_sk"] >= 1)
            & (facts["ret_sk"] <= n_dim)
            & member(facts["ret_date"], facts["ret_date_valid"]))
    sales = seg(facts["sales_price"], facts["sales_sk"], s_ok)
    profit_s = seg(facts["sales_profit"], facts["sales_sk"], s_ok)
    returns_ = seg(facts["ret_amt"], facts["ret_sk"], r_ok)
    loss = seg(facts["ret_loss"], facts["ret_sk"], r_ok)
    count = (seg(np.ones_like(facts["sales_sk"]), facts["sales_sk"], s_ok, np.int32)
             + seg(np.ones_like(facts["ret_sk"]), facts["ret_sk"], r_ok, np.int32))
    return ChannelPartials(sales, returns_, profit_s - loss, count)
