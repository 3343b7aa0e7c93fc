"""Mini NDS q67: top-k ranked rows per category — the windowed-rank tier
(a copy of the JAX package's ``models/q67.py``, which imports no framework).

TPC-DS q67 ranks store sales within each category by sales and keeps the
top 100 rows per category:

    SELECT * FROM (
      SELECT ..., RANK() OVER (PARTITION BY i_category
                               ORDER BY sumsales DESC) rk ...)
    WHERE rk <= 100 ORDER BY i_category, rk, ...

The plan's shape (the first order-sensitive plan):

1. **dim join** (map side): category gathered from the replicated item
   dim by surrogate key;
2. **range exchange** on ``category`` — every category co-located on one
   reduce partition AND partitions contiguous in category order, so the
   per-partition outputs concatenate into global order (splitters
   sampled at dispatch, plans/window.py);
3. **window** (reduce side): ``rank``/``dense_rank`` over
   ``price DESC`` within each category run — ties share a rank, and
   rank depends only on key VALUES, so the filtered row set is
   deterministic no matter how a stable sort broke the ties;
4. **filter** ``rk <= k`` and a **Sort sink** on
   ``(category, rk, sid)`` — ``sid`` is a unique row id, making the
   emitted row ORDER bit-reproducible too.

:func:`q67_oracle` is the pure-numpy unfused twin the parity tests pin
the compiled plan against (the q5_local_unfused discipline), and
:func:`topk_sales_plan` is the global top-k variant whose
``RangeExchange.limit`` pushes the partial top-k below the wire.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.ir import Bin, WinFunc, band_all, col, lit

__all__ = ["q67_plan", "q67_oracle", "make_q67_tables",
           "topk_sales_plan", "naive_sort_limit_plan", "topk_oracle"]

#: output row columns, in plan field order
Q67_FIELDS = ("category", "item_sk", "price", "sid", "rk", "drk")


@functools.lru_cache(maxsize=32)
def q67_plan(k: int, n_items: int) -> ir.Plan:
    """The whole mini-q67 pipeline as ONE order-sensitive plan.

    ``k`` (rank cutoff) and ``n_items`` (dim size, validity bound) are
    plan structure, like q97's capacity.  Contains a RangeExchange —
    runs split across the serve shuffle plane or through
    ``run_range_plan_local``.
    """
    scan = ir.Scan("store_sales", ("item_sk", "price", "sid"))
    join = ir.GatherJoin(
        scan, ir.Dim("item", ("category",)),
        key=col("item_sk"), base=lit(1),
        fields=(("category", "category"),))
    valid = ir.Filter(join, band_all(
        Bin("ge", col("item_sk"), lit(1)),
        Bin("le", col("item_sk"), lit(int(n_items)))))
    ex = ir.RangeExchange(
        valid, keys=((col("category"), True),),
        fields=("category", "item_sk", "price", "sid"))
    win = ir.Window(
        ex, partition_by=(col("category"),),
        order_by=((col("price"), False),),
        funcs=(WinFunc("rk", "rank", dtype="int32"),
               WinFunc("drk", "dense_rank", dtype="int32")))
    top = ir.Filter(win, Bin("le", col("rk"), lit(int(k))))
    sink = ir.Sort(
        top, keys=((col("category"), True), (col("rk"), True),
                   (col("sid"), True)),
        fields=Q67_FIELDS)
    return ir.Plan("q67", (sink,))


def q67_oracle(tables: Dict[str, Dict[str, np.ndarray]],
               k: int) -> Dict[str, np.ndarray]:
    """Pure-numpy unfused q67: the reference semantics the compiled plan
    must match bit for bit (same output dict shape as the plan path:
    field vectors + ``rows``)."""
    ss = tables["store_sales"]
    item = tables["item"]
    n_items = len(item["category"])
    sel = (ss["item_sk"] >= 1) & (ss["item_sk"] <= n_items)
    item_sk = ss["item_sk"][sel]
    price = ss["price"][sel]
    sid = ss["sid"][sel]
    category = item["category"][item_sk - 1]

    # rank within category by price desc: count rows strictly greater
    order = np.lexsort((sid, -price, category))
    cat_s, price_s, item_s, sid_s = (category[order], price[order],
                                     item_sk[order], sid[order])
    n = len(order)
    rk = np.zeros(n, np.int32)
    drk = np.zeros(n, np.int32)
    start = 0
    for i in range(1, n + 1):
        if i == n or cat_s[i] != cat_s[start]:
            p = price_s[start:i]
            uniq = np.unique(-p)  # ascending over negated = desc prices
            for j in range(start, i):
                rk[j] = 1 + int(np.sum(p > price_s[j]))
                drk[j] = 1 + int(np.searchsorted(uniq, -price_s[j]))
            start = i
    keep = rk <= k
    out_order = np.lexsort((sid_s[keep], rk[keep], cat_s[keep]))
    rows = {
        "category": cat_s[keep][out_order],
        "item_sk": item_s[keep][out_order],
        "price": price_s[keep][out_order],
        "sid": sid_s[keep][out_order],
        "rk": rk[keep][out_order].astype(np.int32),
        "drk": drk[keep][out_order].astype(np.int32),
    }
    rows["rows"] = np.int64(int(keep.sum()))
    return rows


def make_q67_tables(rows: int, n_items: int, n_cats: int,
                    seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Synthetic q67 inputs: a store_sales fact (with a unique ``sid``
    row id for deterministic ordering) and an item dim mapping surrogate
    keys to categories."""
    rng = np.random.RandomState(seed)
    return {
        "store_sales": {
            "item_sk": rng.randint(1, n_items + 1, rows).astype(np.int64),
            "price": rng.randint(100, 10000, rows).astype(np.int64),
            "sid": np.arange(rows, dtype=np.int64),
        },
        "item": {
            "category": rng.randint(0, n_cats, n_items).astype(np.int64),
        },
    }


# ------------------------------------------------------------- global topk


@functools.lru_cache(maxsize=32)
def topk_sales_plan(k: int) -> ir.Plan:
    """Global top-k sales by price: ``RangeExchange.limit`` pushes the
    partial top-k below the shuffle (each map shard sends at most ``k``
    rows), the TopK sink takes the per-partition first k, and the
    ordered combine truncates the concat back to k."""
    keys = ((col("price"), False), (col("sid"), True))
    scan = ir.Scan("store_sales", ("price", "sid"))
    ex = ir.RangeExchange(scan, keys=keys, fields=("price", "sid"),
                          limit=int(k))
    sink = ir.TopK(ex, keys=keys, k=int(k), fields=("price", "sid"))
    return ir.Plan("topk_sales", (sink,))


@functools.lru_cache(maxsize=32)
def naive_sort_limit_plan(k: int) -> ir.Plan:
    """The strawman: full global sort, THEN limit — identical answer,
    every row crosses the wire.  Exists so the top-k byte-reduction is a
    measured assertion (tests + bench), not a claim."""
    keys = ((col("price"), False), (col("sid"), True))
    scan = ir.Scan("store_sales", ("price", "sid"))
    ex = ir.RangeExchange(scan, keys=keys, fields=("price", "sid"))
    sink = ir.TopK(ex, keys=keys, k=int(k), fields=("price", "sid"))
    return ir.Plan("topk_sales_naive", (sink,))


def topk_oracle(tables, k: int) -> Dict[str, np.ndarray]:
    """Numpy top-k by (price desc, sid asc)."""
    ss = tables["store_sales"]
    order = np.lexsort((ss["sid"], -ss["price"]))[:k]
    return {"price": ss["price"][order], "sid": ss["sid"][order],
            "rows": np.int64(len(order))}
