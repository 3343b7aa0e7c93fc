"""TPC-DS-shaped synthetic data for the NDS model pipelines (q3, q5, q97): a
copy of the JAX package's numpy generators (``models/tpcds.py``).

A small, seeded generator producing the tables the queries touch, with the
shapes that make TPC-DS data hard: nullable foreign keys, string dimension
ids, and decimal(7,2) money columns (stored as unscaled int64 cents, the
Arrow/Spark DECIMAL representation).  Scale factor ``sf`` linearly sizes the
fact tables; sf=0.01 ~ 1.4k fact rows total, sf=1 ~ 140k.  The generators
draw from ``numpy.random.RandomState``, so the same seed gives the same arrays
as the JAX package's copy.  Not a full dsdgen port, but faithful to the
column shapes the query plans exercise.  :func:`write_q97_parquet` writes
the q97 tables as multi-row-group parquet (pyarrow, imported in the call).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

__all__ = ["Q3Data", "Q5Data", "Q5Dims", "q5_dims", "generate_q3_data",
           "generate_q5_data", "generate_q97_tables", "write_q97_parquet",
           "CHANNELS"]

# (channel label, fact prefix, dim id prefix) for q5's three channel unions
CHANNELS = ("store", "catalog", "web")

_D0 = 2450815  # d_date_sk epoch base the generator uses (arbitrary julian-ish)


@dataclasses.dataclass
class ChannelTables:
    """One channel's fact pair + dimension, column-oriented numpy arrays.

    Sales fact: (sk -> dim key, date_sk, ext_sales_price, net_profit);
    returns fact: (sk, date_sk, return_amt, net_loss).  Money columns are
    unscaled cents (decimal scale 2).  Nullable columns carry a mask
    (True == valid), mirroring Column validity.
    """

    sales_sk: np.ndarray
    sales_sk_valid: np.ndarray
    sales_date: np.ndarray
    sales_date_valid: np.ndarray
    sales_price: np.ndarray  # int64 cents
    sales_profit: np.ndarray  # int64 cents

    ret_sk: np.ndarray
    ret_sk_valid: np.ndarray
    ret_date: np.ndarray
    ret_date_valid: np.ndarray
    ret_amt: np.ndarray
    ret_loss: np.ndarray

    dim_sk: np.ndarray  # [n_dim] surrogate keys (dense, 1..n)
    dim_id: list  # [n_dim] business id strings (e.g. AAAAAAAAAABAAAAA-ish)


@dataclasses.dataclass
class Q5Data:
    channels: Dict[str, ChannelTables]
    date_sk: np.ndarray  # date_dim surrogate keys
    date_days: np.ndarray  # d_date as days-since-epoch ints
    sales_date_lo: int  # the q5 14-day window, as day numbers
    sales_date_hi: int


def _dim_ids(prefix: str, n: int, rng) -> list:
    # TPC-DS business ids are fixed-width uppercase strings
    out = []
    for i in range(n):
        digits = []
        v = i
        for _ in range(8):
            digits.append(chr(ord("A") + v % 26))
            v //= 26
        out.append(prefix + "".join(reversed(digits)))
    return out


def _money(rng, n: int, lo=0, hi=500_00) -> np.ndarray:
    return rng.randint(lo, hi, n).astype(np.int64)


def _nullable(rng, vals: np.ndarray, null_pct: float):
    valid = rng.rand(len(vals)) >= null_pct
    return np.where(valid, vals, 0).astype(vals.dtype), valid


@dataclasses.dataclass
class Q5Dims:
    """The q5 dimension side: date_dim + per-channel business dims.

    Deterministic and sf-independent (dims are tiny; facts scale), so a
    streamed producer and a bucket executor can each rebuild them without
    exchanging anything — the replicated-broadcast-dim shape of the plan.
    """

    date_sk: np.ndarray
    date_days: np.ndarray
    sales_date_lo: int
    sales_date_hi: int
    dim_sk: Dict[str, np.ndarray]
    dim_id: Dict[str, list]

    @property
    def n_dims(self):
        return tuple(len(self.dim_sk[n]) for n in CHANNELS)

    def channel_size(self, name: str) -> int:
        return len(self.dim_sk[name])


def q5_dims() -> Q5Dims:
    """Build the (deterministic) q5 dimension tables."""
    n_dates = 120
    lo = 30
    dim_sk = {}
    dim_id = {}
    for ci, name in enumerate(CHANNELS):
        n_dim = max(3, int(6 * (ci + 1)))
        dim_sk[name] = np.arange(1, n_dim + 1, dtype=np.int32)
        dim_id[name] = _dim_ids(name[0].upper(), n_dim, None)
    return Q5Dims(
        date_sk=np.arange(_D0, _D0 + n_dates, dtype=np.int32),
        date_days=np.arange(n_dates, dtype=np.int32),
        sales_date_lo=lo,
        sales_date_hi=lo + 14,  # q5's 14-day window
        dim_sk=dim_sk,
        dim_id=dim_id,
    )


def generate_q5_data(sf: float = 0.01, seed: int = 0,
                     null_pct: float = 0.04) -> Q5Data:
    """Generate the q5 table set at scale factor ``sf``."""
    rng = np.random.RandomState(seed)
    dims = q5_dims()
    date_sk = dims.date_sk
    date_days = dims.date_days
    n_dates = len(date_sk)
    lo = dims.sales_date_lo
    hi = dims.sales_date_hi

    channels: Dict[str, ChannelTables] = {}
    for ci, name in enumerate(CHANNELS):
        n_dim = dims.channel_size(name)
        n_sales = max(8, int(40_000 * sf) // (ci + 1))
        n_ret = max(4, n_sales // 8)
        dim_sk = dims.dim_sk[name]

        s_sk, s_skv = _nullable(
            rng, rng.randint(1, n_dim + 1, n_sales).astype(np.int32), null_pct)
        s_dt, s_dtv = _nullable(
            rng, rng.randint(_D0, _D0 + n_dates, n_sales).astype(np.int32),
            null_pct)
        r_sk, r_skv = _nullable(
            rng, rng.randint(1, n_dim + 1, n_ret).astype(np.int32), null_pct)
        r_dt, r_dtv = _nullable(
            rng, rng.randint(_D0, _D0 + n_dates, n_ret).astype(np.int32),
            null_pct)

        channels[name] = ChannelTables(
            sales_sk=s_sk, sales_sk_valid=s_skv,
            sales_date=s_dt, sales_date_valid=s_dtv,
            sales_price=_money(rng, n_sales),
            sales_profit=_money(rng, n_sales, -100_00, 200_00),
            ret_sk=r_sk, ret_sk_valid=r_skv,
            ret_date=r_dt, ret_date_valid=r_dtv,
            ret_amt=_money(rng, n_ret),
            ret_loss=_money(rng, n_ret, 0, 80_00),
            dim_sk=dim_sk,
            dim_id=dims.dim_id[name],
        )
    return Q5Data(channels, date_sk, date_days, lo, hi)


@dataclasses.dataclass
class Q3Data:
    """q3 table set: store_sales fact + item and date_dim dimensions.

    item: dense surrogate keys 1..n_items, a brand string per item (many
    items share a brand), and a manufacturer id (the query's filter).
    date_dim: dense keys with (d_year, d_moy) attributes.
    """

    ss_item_sk: np.ndarray
    ss_item_sk_valid: np.ndarray
    ss_sold_date_sk: np.ndarray
    ss_sold_date_sk_valid: np.ndarray
    ss_ext_sales_price: np.ndarray  # int64 cents (decimal scale 2)

    item_sk: np.ndarray  # [n_items] dense 1..n
    item_brand_id: np.ndarray  # [n_items] int32
    item_manufact_id: np.ndarray  # [n_items] int32
    brand_names: list  # [n_brands] strings; brand_id b -> brand_names[b-1]

    date_sk: np.ndarray  # [n_dates] dense keys (from _D0)
    date_year: np.ndarray
    date_moy: np.ndarray

    manufact_id: int  # the query's i_manufact_id literal
    moy: int  # the query's d_moy literal


def generate_q3_data(sf: float = 0.01, seed: int = 0,
                     null_pct: float = 0.04) -> Q3Data:
    """Generate the q3 table set at scale factor ``sf``."""
    rng = np.random.RandomState(seed + 3)
    n_items = max(12, int(200 * sf))
    n_brands = max(5, n_items // 4)
    n_manufact = 8
    n_dates = 3 * 365
    n_sales = max(16, int(120_000 * sf))

    item_sk = np.arange(1, n_items + 1, dtype=np.int32)
    item_brand_id = rng.randint(1, n_brands + 1, n_items).astype(np.int32)
    item_manufact_id = rng.randint(1, n_manufact + 1, n_items).astype(np.int32)
    brand_names = [f"corpbrand #{b}" for b in range(1, n_brands + 1)]

    date_sk = np.arange(_D0, _D0 + n_dates, dtype=np.int32)
    date_year = (1998 + np.arange(n_dates) // 365).astype(np.int32)
    date_moy = (1 + (np.arange(n_dates) % 365) // 31).astype(np.int32)

    i_sk, i_v = _nullable(
        rng, rng.randint(1, n_items + 1, n_sales).astype(np.int32), null_pct)
    d_sk, d_v = _nullable(
        rng, rng.randint(_D0, _D0 + n_dates, n_sales).astype(np.int32),
        null_pct)

    return Q3Data(
        ss_item_sk=i_sk, ss_item_sk_valid=i_v,
        ss_sold_date_sk=d_sk, ss_sold_date_sk_valid=d_v,
        ss_ext_sales_price=_money(rng, n_sales),
        item_sk=item_sk, item_brand_id=item_brand_id,
        item_manufact_id=item_manufact_id, brand_names=brand_names,
        date_sk=date_sk, date_year=date_year, date_moy=date_moy,
        manufact_id=int(rng.randint(1, n_manufact + 1)), moy=11,
    )


def generate_q97_tables(sf: float, seed: int):
    """The q97 fact pair: (customer_sk, item_sk) int32 arrays per channel,
    ~SF-proportional (SF1 store_sales is ~2.9M rows)."""
    rng = np.random.RandomState(seed)
    n = max(1000, int(2_800_000 * sf))
    store = (rng.randint(1, max(2, n // 14), n).astype(np.int32),
             rng.randint(1, 18_000, n).astype(np.int32))
    catalog = (rng.randint(1, max(2, n // 14), n).astype(np.int32),
               rng.randint(1, 18_000, n).astype(np.int32))
    return store, catalog


def write_q97_parquet(outdir: str, sf: float = 0.05, seed: int = 42,
                      rows_per_group: int = 65536):
    """Write the q97 fact pair as multi-row-group parquet files.

    Each file carries the two join keys plus money columns the query does
    NOT touch -- so split planning via the footer (row-group midpoint
    filter) and column pruning are both load-bearing when the NDS harness
    reads these back (``nds_harness --input``).  Returns the two paths.
    """
    import os

    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(outdir, exist_ok=True)
    store, catalog = generate_q97_tables(sf, seed)
    rng = np.random.RandomState(seed + 97)
    paths = {}
    for name, prefix, (cust, item) in (
            ("store_sales", "ss", store), ("catalog_sales", "cs", catalog)):
        n = len(cust)
        table = pa.table({
            f"{prefix}_customer_sk": pa.array(cust, pa.int32()),
            f"{prefix}_item_sk": pa.array(item, pa.int32()),
            # pruned by the q97 read schema: never materialized
            f"{prefix}_ext_sales_price": pa.array(
                _money(rng, n), pa.int64()),
            f"{prefix}_net_profit": pa.array(
                rng.rand(n) * 100.0, pa.float64()),
        })
        path = os.path.join(outdir, f"{name}.parquet")
        pq.write_table(table, path, row_group_size=rows_per_group)
        paths[name] = path
    return paths["store_sales"], paths["catalog_sales"]
