"""Mini NDS q64: multi-join over sorted runs with framed running aggs (a
copy of the JAX package's ``models/q64.py``, which imports no framework).

TPC-DS q64 is the multi-way-join monster; the mini keeps its
order-sensitive core: store sales join TWO dims (item -> category/brand,
customer -> income band), filter, then analyze each (category, brand)
group in net-value order — row_number, a running net total, a
3-preceding ROWS-frame sum, and a running max:

    SELECT ..., ROW_NUMBER() OVER w rn,
           SUM(net)  OVER w run_net,
           SUM(net)  OVER (w ROWS 3 PRECEDING) net4,
           MAX(net)  OVER w peak
    FROM ... WHERE band >= b0
    WINDOW w AS (PARTITION BY category, brand ORDER BY net DESC, sid)
    QUALIFY rn <= k ORDER BY category, brand, rn

The range exchange keys on ``(category, brand)`` only — group
co-location is the window's correctness condition, and group-contiguous
partitions are the ordered concat's.  ``order_by`` includes the unique
``sid`` so every running aggregate is deterministic (no tie-order
ambiguity), unlike q67 which deliberately leaves price ties ambiguous to
exercise value-only rank semantics.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.ir import Bin, WinFunc, band_all, col, lit

__all__ = ["q64_plan", "q64_oracle", "make_q64_tables", "Q64_FIELDS"]

Q64_FIELDS = ("category", "brand", "sid", "net", "rn", "run_net",
              "net4", "peak")

#: the bounded ROWS frame (current row + 3 preceding)
_NET4_PRECEDING = 3


@functools.lru_cache(maxsize=32)
def q64_plan(k: int, n_items: int, n_custs: int, band0: int) -> ir.Plan:
    """The mini-q64 pipeline as ONE order-sensitive plan: two gather
    joins below a (category, brand) range exchange, framed window
    aggregates over sorted runs, top-``k`` rows per group, ordered row
    output."""
    scan = ir.Scan("store_sales", ("item_sk", "cust_sk", "qty", "price",
                                   "sid"))
    join_i = ir.GatherJoin(
        scan, ir.Dim("item", ("category", "brand")),
        key=col("item_sk"), base=lit(1),
        fields=(("category", "category"), ("brand", "brand")))
    join_c = ir.GatherJoin(
        join_i, ir.Dim("customer", ("band",)),
        key=col("cust_sk"), base=lit(1), fields=(("band", "band"),))
    net = ir.Project(join_c, (("net", Bin("mul", col("qty"),
                                          col("price"))),))
    valid = ir.Filter(net, band_all(
        Bin("ge", col("item_sk"), lit(1)),
        Bin("le", col("item_sk"), lit(int(n_items))),
        Bin("ge", col("cust_sk"), lit(1)),
        Bin("le", col("cust_sk"), lit(int(n_custs))),
        Bin("ge", col("band"), lit(int(band0)))))
    ex = ir.RangeExchange(
        valid, keys=((col("category"), True), (col("brand"), True)),
        fields=("category", "brand", "net", "sid"))
    win = ir.Window(
        ex, partition_by=(col("category"), col("brand")),
        order_by=((col("net"), False), (col("sid"), True)),
        funcs=(WinFunc("rn", "row_number", dtype="int32"),
               WinFunc("run_net", "sum", arg=col("net"), dtype="int64"),
               WinFunc("net4", "sum", arg=col("net"), dtype="int64",
                       preceding=_NET4_PRECEDING),
               WinFunc("peak", "max", arg=col("net"), dtype="int64")))
    top = ir.Filter(win, Bin("le", col("rn"), lit(int(k))))
    sink = ir.Sort(
        top, keys=((col("category"), True), (col("brand"), True),
                   (col("rn"), True)),
        fields=Q64_FIELDS)
    return ir.Plan("q64", (sink,))


def q64_oracle(tables: Dict[str, Dict[str, np.ndarray]], k: int,
               band0: int) -> Dict[str, np.ndarray]:
    """Pure-numpy unfused q64 (reference semantics, bit-exact)."""
    ss = tables["store_sales"]
    item = tables["item"]
    cust = tables["customer"]
    n_items = len(item["category"])
    n_custs = len(cust["band"])
    sel = ((ss["item_sk"] >= 1) & (ss["item_sk"] <= n_items)
           & (ss["cust_sk"] >= 1) & (ss["cust_sk"] <= n_custs))
    item_sk = ss["item_sk"][sel]
    cust_sk = ss["cust_sk"][sel]
    net = (ss["qty"][sel] * ss["price"][sel]).astype(np.int64)
    sid = ss["sid"][sel]
    category = item["category"][item_sk - 1]
    brand = item["brand"][item_sk - 1]
    band = cust["band"][cust_sk - 1]
    keep = band >= band0
    category, brand, net, sid = (category[keep], brand[keep], net[keep],
                                 sid[keep])

    order = np.lexsort((sid, -net, brand, category))
    cat_s, br_s, net_s, sid_s = (category[order], brand[order],
                                 net[order], sid[order])
    n = len(order)
    rn = np.zeros(n, np.int32)
    run_net = np.zeros(n, np.int64)
    net4 = np.zeros(n, np.int64)
    peak = np.zeros(n, np.int64)
    start = 0
    for i in range(1, n + 1):
        if i == n or cat_s[i] != cat_s[start] or br_s[i] != br_s[start]:
            g = net_s[start:i]
            rn[start:i] = np.arange(1, i - start + 1, dtype=np.int32)
            run_net[start:i] = np.cumsum(g)
            for j in range(len(g)):
                lo = max(0, j - _NET4_PRECEDING)
                net4[start + j] = int(g[lo:j + 1].sum())
            peak[start:i] = np.maximum.accumulate(g)
            start = i
    keep_k = rn <= k
    # already sorted by (category, brand, net desc, sid) == output order
    # for the kept rows (rn increases with that order)
    rows = {
        "category": cat_s[keep_k], "brand": br_s[keep_k],
        "sid": sid_s[keep_k], "net": net_s[keep_k],
        "rn": rn[keep_k], "run_net": run_net[keep_k],
        "net4": net4[keep_k], "peak": peak[keep_k],
    }
    rows["rows"] = np.int64(int(keep_k.sum()))
    return rows


def make_q64_tables(rows: int, n_items: int, n_custs: int,
                    n_cats: int = 6, n_brands: int = 4, n_bands: int = 5,
                    seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """Synthetic q64 inputs: a sales fact plus item and customer dims."""
    rng = np.random.RandomState(seed)
    return {
        "store_sales": {
            "item_sk": rng.randint(1, n_items + 1, rows).astype(np.int64),
            "cust_sk": rng.randint(1, n_custs + 1, rows).astype(np.int64),
            "qty": rng.randint(1, 20, rows).astype(np.int64),
            "price": rng.randint(100, 5000, rows).astype(np.int64),
            "sid": np.arange(rows, dtype=np.int64),
        },
        "item": {
            "category": rng.randint(0, n_cats, n_items).astype(np.int64),
            "brand": rng.randint(0, n_brands, n_items).astype(np.int64),
        },
        "customer": {
            "band": rng.randint(0, n_bands, n_custs).astype(np.int64),
        },
    }
