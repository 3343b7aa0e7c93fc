"""NDS q3: star join (store_sales x item x date_dim) + grouped aggregation
(PyTorch port of ``models/q3.py``).

    select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price)
    from date_dim, store_sales, item
    where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
      and i_manufact_id = M and d_moy = 11
    group by d_year, i_brand_id, i_brand
    order by d_year, sum_agg desc, i_brand_id

A selective dimension FILTER pushed through two dense dimension joins into
one grouped money aggregation.  Both dimensions are dense surrogate-keyed,
so each join is a replicated-table gather; the group key (d_year,
i_brand_id) lives in a small dense product space, so the aggregation is one
masked segment sum into a [n_years * n_brands] grid, and the distributed
form sums that grid over the data axis -- no row exchange.

Money stays unscaled int64 cents (decimal scale 2) end to end; brand
STRINGS materialize only in the host-formatted result rows.  The int64 path
is ONE plan (:func:`q3_plan`) run by the plan executor; the per-op eager
path survives as :func:`q3_local_unfused`, its parity oracle.  The
decimal-columns variant keeps its own device step (:func:`_q3_columns_step`;
columns are outside the scalar plan IR).  Both governed runners,
:func:`run_distributed_q3` and :func:`run_distributed_q3_columns`, admit one
working set through the memory arbiter and split fact rows in half on
SplitAndRetryOOM (exact: sums and counts are additive).
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.models.tpcds import Q3Data
from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, axis_group
from spark_rapids_jni_tpu_torch.parallel.shuffle import quantized_rows
from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.compiler import segment_sum
from spark_rapids_jni_tpu_torch.plans.ir import Bin, Cast, band_all, col, lit

__all__ = ["Q3Row", "q3_local", "q3_local_unfused", "q3_plan", "make_distributed_q3",
           "run_distributed_q3", "run_distributed_q3_columns", "q3_columns_host_oracle",
           "q3_working_set_bytes"]

_M32 = 0xFFFFFFFF


class Q3Row(NamedTuple):
    d_year: int
    brand_id: int
    brand: str
    sum_agg: int  # cents


class _Partials(NamedTuple):
    sums: object  # [n_years * n_brands] int64 cents
    counts: object  # [n_years * n_brands] int32


def _add_at(n: int, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``jnp.zeros(n).at[idx].add(values, mode="drop")``: an index in
    ``[-n, 0)`` counts from the end, as numpy indexing does, and one outside
    ``[-n, n)`` is dropped."""
    return segment_sum(values, torch.where(idx < 0, idx + n, idx), n)


def _group(i_idx, d_idx, item_brand, date_year, *, n_brands, year0, n_years):
    """The dense group id: clip(year - year0, 0, n_years-1) * n_brands +
    (brand - 1), brand being 1-based."""
    brand = item_brand[i_idx].to(torch.int32)
    year_off = (date_year[d_idx] - year0).to(torch.int32)
    return torch.clamp(year_off, 0, n_years - 1) * n_brands + (brand - 1)


def _partials(ss_item, ss_item_v, ss_date, ss_date_v, price,
              item_brand, item_manufact, date_year, date_moy,
              *, n_brands: int, year0: int, n_years: int,
              date_sk0: int, manufact_id: int, moy: int) -> _Partials:
    """Device body over [rows] facts; dims are replicated dense tables."""
    i_idx = torch.clamp(ss_item - 1, 0, item_brand.shape[0] - 1)
    d_idx = torch.clamp(ss_date - date_sk0, 0, date_year.shape[0] - 1)
    ok = (
        ss_item_v & ss_date_v
        & (item_manufact[i_idx] == manufact_id)
        & (date_moy[d_idx] == moy)
    )
    group = _group(i_idx, d_idx, item_brand, date_year,
                   n_brands=n_brands, year0=year0, n_years=n_years)
    ngroups = n_years * n_brands
    sums = _add_at(ngroups, group, torch.where(ok, price, 0).to(torch.int64))
    counts = _add_at(ngroups, group, ok.to(torch.int32))
    return _Partials(sums, counts)


def _assemble_rows(counts: np.ndarray, sum_of, year0: int, n_brands: int,
                   render_brands) -> List[Q3Row]:
    """Shared result assembly: drop empty groups, decode the group grid
    (year = year0 + g//n_brands, brand = g%n_brands + 1), attach brand names
    via ``render_brands(zero_based_idx_array)``, order by (d_year, sum desc,
    brand_id) -- ONE owner of the grid layout and sort rule for both the
    int64 and the decimal-columns variants."""
    groups = np.nonzero(counts)[0]
    names = render_brands((groups % n_brands).astype(np.int32))
    rows = [
        Q3Row(year0 + int(g) // n_brands, int(g) % n_brands + 1, name, sum_of(int(g)))
        for g, name in zip(groups, names)
    ]
    rows.sort(key=lambda r: (r.d_year, -r.sum_agg, r.brand_id))
    return rows


def _format(parts: _Partials, data: Q3Data, year0: int) -> List[Q3Row]:
    """Host: int64-partials formatting (host-list brand lookup)."""
    sums = np.asarray(parts.sums)
    return _assemble_rows(
        np.asarray(parts.counts), lambda g: int(sums[g]), year0,
        len(data.brand_names),
        lambda idx: [data.brand_names[i] for i in idx])


def _geometry(data: Q3Data):
    year0 = int(data.date_year.min())
    n_years = int(data.date_year.max()) - year0 + 1
    return dict(
        n_brands=len(data.brand_names), year0=year0, n_years=n_years,
        date_sk0=int(data.date_sk[0]), manufact_id=data.manufact_id,
        moy=data.moy,
    )


def _facts(data: Q3Data) -> dict:
    return dict(
        ss_item=data.ss_item_sk, ss_item_v=data.ss_item_sk_valid,
        ss_date=data.ss_sold_date_sk, ss_date_v=data.ss_sold_date_sk_valid,
        price=data.ss_ext_sales_price,
    )


# ------------------------------------------------------------------ the plan


@functools.lru_cache(maxsize=64)
def q3_plan(*, n_brands: int, year0: int, n_years: int, date_sk0: int,
            manufact_id: int, moy: int) -> ir.Plan:
    """The whole q3 device pipeline as ONE plan: scan -> item gather ->
    date gather -> manufact/moy filter -> grouped segment sum into the dense
    [n_years * n_brands] grid.  Geometry scalars normalize through
    ``plans.ir.lit``, so equal geometry always builds an EQUAL plan (one
    cache entry); memoized per geometry."""
    item = ir.Dim("item", ("brand", "manufact"))
    date = ir.Dim("date_dim", ("year", "moy"))
    node: ir.Node = ir.Scan(
        "store_sales", ("ss_item", "ss_item_v", "ss_date", "ss_date_v", "price"))
    node = ir.GatherJoin(node, item, key=col("ss_item"), base=lit(1),
                         fields=(("brand", "brand"), ("manufact", "manufact")))
    node = ir.GatherJoin(node, date, key=col("ss_date"), base=lit(date_sk0),
                         fields=(("year", "year"), ("moy", "moy")))
    node = ir.Filter(node, band_all(
        col("ss_item_v"), col("ss_date_v"),
        Bin("eq", col("manufact"), lit(manufact_id)),
        Bin("eq", col("moy"), lit(moy)),
    ))
    # group = clip(year - year0, 0, n_years-1) * n_brands + (brand - 1),
    # exactly the per-op body's grid arithmetic (brand is 1-based)
    year_off = Cast(Bin("sub", col("year"), lit(year0)), "int32")
    clipped = Bin("min", Bin("max", year_off, lit(0)), lit(n_years - 1))
    group = Bin("add", Bin("mul", clipped, lit(n_brands)),
                Bin("sub", Cast(col("brand"), "int32"), lit(1)))
    node = ir.Project(node, (("group", group),))
    sink = ir.SegmentAgg(
        node, key=col("group"), num_segments=n_years * n_brands,
        aggs=(("sums", col("price"), "int64"), ("counts", lit(1), "int32")))
    return ir.Plan("q3", (sink,))


def _q3_tables(facts: dict, dims: dict) -> dict:
    """The plan's input tables from the fact/dim array dicts."""
    return {
        "store_sales": dict(facts),
        "item": {"brand": dims["item_brand"], "manufact": dims["item_manufact"]},
        "date_dim": {"year": dims["date_year"], "moy": dims["date_moy"]},
    }


def _dims(data: Q3Data) -> dict:
    return dict(
        item_brand=data.item_brand_id,
        item_manufact=data.item_manufact_id,
        date_year=data.date_year,
        date_moy=data.date_moy,
    )


def q3_local_unfused(data: Q3Data, device: _device.DeviceLike = None) -> List[Q3Row]:
    """Per-op eager q3 on ``device`` (the card unless the caller asks for the
    CPU).  The plan path's parity oracle."""
    dev = _device.resolve(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    geo = _geometry(data)
    parts = _partials(*(t(v) for v in _facts(data).values()),
                      **{k: t(v) for k, v in _dims(data).items()}, **geo)
    return _format(_Partials(*(p.cpu().numpy() for p in parts)), data, geo["year0"])


def q3_local(data: Q3Data, device: _device.DeviceLike = None) -> List[Q3Row]:
    """Single-device q3 through the plan, on ``device`` (the card unless the
    caller asks for the CPU): gathers, filter and grouped sum are one cached
    executor, then host formatting."""
    from spark_rapids_jni_tpu_torch.plans.runtime import execute_plan

    geo = _geometry(data)
    outputs = execute_plan(None, q3_plan(**geo), _q3_tables(_facts(data), _dims(data)),
                           device=device)
    return _format(_Partials(outputs["sums"], outputs["counts"]), data, geo["year0"])


def make_distributed_q3(mesh, data: Q3Data):
    """The executor of distributed q3 over ``mesh``'s data axis: the
    :class:`plans.cache.CompiledPlan` for ``data``'s geometry and batch
    bucket, facts sharded over ``data``, dims replicated, the group grid
    summed.  Same-geometry data returns the IDENTICAL cached object, with
    O(1) host work on a hit."""
    from spark_rapids_jni_tpu_torch.plans.runtime import compiled_plan_for

    plan = q3_plan(**_geometry(data))
    return compiled_plan_for(plan, mesh, _q3_tables(_facts(data), _dims(data)))


def q3_working_set_bytes(facts_or_data, dp: int = 1) -> int:
    """Reserved bytes for one q3 attempt over the given facts (inputs +
    masks/buckets + partials headroom), over the quantized (padded) row
    counts a run uploads; equal to ``plans.runtime.plan_working_set_bytes``
    of the q3 plan."""
    facts = (facts_or_data if isinstance(facts_or_data, dict)
             else _facts(facts_or_data))
    return sum(quantized_rows(len(v), dp) * v.itemsize for v in facts.values()) * 3


def _pad_facts(facts: dict, dp: int) -> dict:
    """dp-aligned pow2-quantized padding; pad rows carry False validity."""
    n = len(facts["ss_item"])
    pad = quantized_rows(n, dp) - n
    if pad == 0:
        return facts
    out = {k: np.concatenate([v, np.zeros(pad, v.dtype)]) for k, v in facts.items()}
    out["ss_item_v"][-pad:] = False
    out["ss_date_v"][-pad:] = False
    return out


def _split_facts(facts: dict):
    n = len(facts["ss_item"])
    return [{k: v[:n // 2] for k, v in facts.items()},
            {k: v[n // 2:] for k, v in facts.items()}]


def run_distributed_q3(mesh, data: Q3Data, *, budget=None, task_id: int = 0,
                       manage_task: bool = True,
                       device: _device.DeviceLike = None) -> List[Q3Row]:
    """Governed q3 through the plan, over ``mesh`` (every rank passing the
    same data) or, with ``mesh`` None, on ``device`` (the card unless the
    caller asks for the CPU): ONE admission for the plan's working set,
    RetryOOM re-runs the plan, SplitAndRetryOOM halves fact rows and
    re-executes the plan per half (exact: sums/counts are additive), one
    flight-recorder task spans the plan."""
    from spark_rapids_jni_tpu_torch.plans.runtime import run_governed_plan

    geo = _geometry(data)
    outputs = run_governed_plan(
        mesh, q3_plan(**geo), _q3_tables(_facts(data), _dims(data)),
        budget=budget, task_id=task_id, manage_task=manage_task, device=device,
    )
    return _format(_Partials(outputs["sums"], outputs["counts"]), data, geo["year0"])


# ----------------------------------------------------------- columns variant
# The real TPC-DS q3 selects i_brand (a STRING) and sums a DECIMAL money
# column.  This variant's device step takes ss_ext_sales_price as a
# Decimal128Column whose per-group SUM is accumulated in 128-bit limb
# arithmetic -- exact mod 2^128, i.e. for every total that fits int128: the
# unsigned low limb is decomposed into 32-bit halves whose segment sums stay
# int64-exact and are recombined after the sum over the data axis, while
# the top limb accumulates with ordinary wrapping int64 adds, which ARE
# mod-2^64 adds and therefore correct for the high limb at any magnitude.


class _DecPartials(NamedTuple):
    hi: torch.Tensor  # int64[n_groups] high limb of the decimal sum
    lo: torch.Tensor  # int64[n_groups] holding the unsigned low limb's bits
    counts: torch.Tensor  # int32[n_groups]


def _dec_partials(ss_item, ss_date, price, item_brand, item_manufact,
                  date_year, date_moy, *, mesh, n_brands: int, year0: int,
                  n_years: int, date_sk0: int, manufact_id: int,
                  moy: int) -> _DecPartials:
    """Device body on one rank: 128-bit grouped money sum over nullable
    Columns, summed over the data axis (a local step when ``mesh`` is None).

    ``price.lo`` is int64 holding the unsigned low limb's bits, so its upper
    half is taken with an arithmetic shift and masked.  The three int64 sums
    ride one ``all_reduce`` and the counts another."""
    i_idx = torch.clamp(ss_item.data - 1, 0, item_brand.shape[0] - 1)
    d_idx = torch.clamp(ss_date.data - date_sk0, 0, date_year.shape[0] - 1)
    ok = (
        ss_item.is_valid() & ss_date.is_valid() & price.is_valid()
        & (item_manufact[i_idx] == manufact_id)
        & (date_moy[d_idx] == moy)
    )
    group = _group(i_idx, d_idx, item_brand, date_year,
                   n_brands=n_brands, year0=year0, n_years=n_years)
    ngroups = n_years * n_brands

    def seg(values):
        return _add_at(ngroups, group, torch.where(ok, values, 0))

    limbs = torch.stack([seg(price.lo & _M32), seg((price.lo >> 32) & _M32), seg(price.hi)])
    counts = seg(ok.to(torch.int32))
    if mesh is not None:
        group_ = axis_group(mesh, DATA_AXIS)
        dist.all_reduce(limbs, group=group_)
        dist.all_reduce(counts, group=group_)
    s0, s1, sh = limbs

    # recombine: total = sh*2^64 + s1*2^32 + s0 (mod 2^128), s0/s1 >= 0
    u = s1 + (s0 >> 32)
    lo = ((u & _M32) << 32) | (s0 & _M32)
    hi = sh + (u >> 32)
    return _DecPartials(hi, lo, counts)


@functools.lru_cache(maxsize=32)
def _q3_columns_step(mesh, geo_items: tuple):
    """The decimal-columns device step for ``mesh`` (None: one device) and the geometry
    ``tuple(sorted(_geometry(data).items()))``: a callable that each rank
    calls with its data shard of ``ss_item``/``ss_date`` (INT32 Columns) and
    ``price`` (a Decimal128Column), and the four dim tensors whole; returns
    the global (hi, lo, counts) of every group."""
    return functools.partial(_dec_partials, mesh=mesh, **dict(geo_items))


def _price_limbs(price: np.ndarray):
    """int64 cents -> two's-complement (hi, lo) 64-bit limb arrays; ``lo``
    is int64 holding the unsigned low limb's bits, as the port's
    Decimal128Column holds it."""
    lo = price.astype(np.int64)
    hi = np.where(price < 0, np.int64(-1), np.int64(0))
    return hi, lo


def q3_columns_host_oracle(data: Q3Data) -> List[Q3Row]:
    """Arbitrary-precision host oracle (python ints -- exact at magnitudes
    where the int64 path would overflow)."""
    geo = _geometry(data)
    sums: dict = {}
    counts: dict = {}
    for i in range(len(data.ss_item_sk)):
        if not (data.ss_item_sk_valid[i] and data.ss_sold_date_sk_valid[i]):
            continue
        isk = int(data.ss_item_sk[i])
        dsk = int(data.ss_sold_date_sk[i]) - geo["date_sk0"]
        if not (1 <= isk <= len(data.item_sk)) or \
                not (0 <= dsk < len(data.date_year)):
            continue
        if int(data.item_manufact_id[isk - 1]) != geo["manufact_id"]:
            continue
        if int(data.date_moy[dsk]) != geo["moy"]:
            continue
        key = (int(data.date_year[dsk]), int(data.item_brand_id[isk - 1]))
        sums[key] = sums.get(key, 0) + int(data.ss_ext_sales_price[i])
        counts[key] = counts.get(key, 0) + 1
    rows = [Q3Row(y, b, data.brand_names[b - 1], s) for (y, b), s in sums.items()]
    rows.sort(key=lambda r: (r.d_year, -r.sum_agg, r.brand_id))
    return rows


def run_distributed_q3_columns(mesh, data: Q3Data, *, budget=None, task_id: int = 0,
                               manage_task: bool = True,
                               device: _device.DeviceLike = None) -> List[Q3Row]:
    """Governed q3 with Decimal128Column money and a StringColumn brand
    dimension, over ``mesh`` (every rank passing the same data) or, with
    ``mesh`` None, on ``device`` (the card unless the caller asks for the
    CPU).

    Same protocol as :func:`run_distributed_q3` (admission, RetryOOM,
    row-split SplitAndRetryOOM, the outcome agreed over the data axis) but
    per-group sums are exact for every total that fits int128 (128-bit limbs
    on the device; combined in python ints), and the result brand strings
    are gathered from the device StringColumn through its padded view.
    """
    import contextlib

    from spark_rapids_jni_tpu_torch.columnar.column import (
        Column,
        Decimal128Column,
        next_pow2,
        strings_column,
        strings_from_padded,
    )
    from spark_rapids_jni_tpu_torch.columnar.dtypes import INT32, decimal
    from spark_rapids_jni_tpu_torch.mem.governed import (
        default_device_budget,
        run_with_split_retry,
        task_context,
    )
    from spark_rapids_jni_tpu_torch.parallel.mesh import axis_index, axis_size
    from spark_rapids_jni_tpu_torch.plans.compiler import plan_device

    geo = _geometry(data)
    dp = 1 if mesh is None else axis_size(mesh, DATA_AXIS)
    d = 0 if mesh is None else axis_index(mesh, DATA_AXIS)
    dev = plan_device(mesh, device)
    step = _q3_columns_step(mesh, tuple(sorted(geo.items())))
    # analyze: ignore[governed-allocation] - shared replicated dim tables,
    # uploaded once and shared by every retry/split piece
    dims = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in _dims(data).items()}
    brands = strings_column(data.brand_names, device=dev)  # the STRING dimension

    hi0, lo0 = _price_limbs(data.ss_ext_sales_price)
    facts = dict(
        ss_item=data.ss_item_sk, ss_item_v=data.ss_item_sk_valid,
        ss_date=data.ss_sold_date_sk, ss_date_v=data.ss_sold_date_sk_valid,
        price_hi=hi0, price_lo=lo0,
    )

    def nbytes_of(f):
        return q3_working_set_bytes(f, dp)

    def run(f):
        padded = _pad_facts(f, dp)
        m = len(padded["ss_item"]) // dp

        def put(v):  # this rank's data block of a padded fact array
            return torch.from_numpy(np.ascontiguousarray(v[d * m:(d + 1) * m])).to(dev)

        out = step(Column(put(padded["ss_item"]), put(padded["ss_item_v"]), INT32),
                   Column(put(padded["ss_date"]), put(padded["ss_date_v"]), INT32),
                   Decimal128Column(put(padded["price_hi"]), put(padded["price_lo"]),
                                    None, decimal(38, 2)),
                   *dims.values())
        hi = out.hi.cpu().numpy()
        lo = out.lo.cpu().numpy().view(np.uint64)
        sums = [int(h) * (1 << 64) + int(x) for h, x in zip(hi, lo)]
        return sums, out.counts.cpu().numpy()

    def combine(results):
        sums = [sum(r[0][g] for r in results) for g in range(len(results[0][0]))]
        counts = sum(r[1] for r in results)
        return sums, counts

    budget = budget if budget is not None else default_device_budget()
    ctx = (task_context(budget.gov, task_id) if manage_task
           else contextlib.nullcontext())
    with ctx:
        sums, counts = run_with_split_retry(
            budget, facts, nbytes_of=nbytes_of, run=run, split=_split_facts,
            combine=combine, group=None if mesh is None else axis_group(mesh, DATA_AXIS))

    # brand strings are RENDERED from the device StringColumn; the gather
    # length is pow2-quantized (pad rows gather row 0, cut off after), as
    # the JAX package's, so the shapes it sees stay few
    def render_brands(idx: np.ndarray):
        n_sel = len(idx)
        sel_np = np.zeros(next_pow2(max(n_sel, 1)), np.int64)
        sel_np[:n_sel] = idx
        padded, lens = brands.padded()
        sel = torch.from_numpy(sel_np).to(dev)
        return strings_from_padded(padded[sel], lens[sel]).to_list()[:n_sel]

    return _assemble_rows(counts, lambda g: sums[g], geo["year0"],
                          len(data.brand_names), render_brands)
