"""Mini NDS q97: a two-table join-count, on one device and over the mesh
(PyTorch port of ``models/q97.py``).

TPC-DS q97 counts the (customer_sk, item_sk) pairs sold in store only, in
catalog only, and in both: a full outer join on a composite key reduced to
presence counts.

    SELECT SUM(store_only), SUM(catalog_only), SUM(both) FROM
      (SELECT customer_sk, item_sk FROM store_sales GROUP BY 1,2) ss
      FULL OUTER JOIN
      (SELECT customer_sk, item_sk FROM catalog_sales GROUP BY 1,2) cs
      USING (customer_sk, item_sk)

Distributed form, on each rank over its data shard:

1. pack the composite key and place it with the placement hash;
2. shuffle both tables' keys, tagged by side, with one ``all_to_all`` over
   the data axis, which co-locates every distinct key on one rank;
3. sort the received keys and count the equal-key runs by the sides that
   appear in them;
4. sum the three counters over the data axis.

The shuffle's capacity is a fixed bound; rows past it are reported in
``dropped`` and the caller retries with a larger one.  The governed runner,
:func:`run_distributed_q97`, does so, and splits the key space when the
memory arbiter says the batch does not fit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from spark_rapids_jni_tpu_torch.columnar.column import Column, next_pow2
from spark_rapids_jni_tpu_torch.columnar.dtypes import INT8, INT64
from spark_rapids_jni_tpu_torch.models import key_split
from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_size
from spark_rapids_jni_tpu_torch.parallel.shuffle import (
    ShuffleCrossing,
    all_to_all_shuffle,
    partition_of,
    quantized_rows,
)
from spark_rapids_jni_tpu_torch.parallel.table_shuffle import shuffle_table
from spark_rapids_jni_tpu_torch.plans import ir as ir_mod

_SENTINEL = 0x7FFFFFFFFFFFFFFF  # sorts last; a run of it is not counted
_GOLDEN = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64


class Q97Out(NamedTuple):
    store_only: torch.Tensor  # int64 scalar
    catalog_only: torch.Tensor
    both: torch.Tensor
    dropped: torch.Tensor  # int32 scalar: shuffle capacity overflows (0 == exact result)


def _composite_key(customer_sk: torch.Tensor, item_sk: torch.Tensor) -> torch.Tensor:
    """One int64 key per (customer, item) pair: both are positive 32-bit
    surrogate keys in TPC-DS, so the packing is exact."""
    return (customer_sk.to(torch.int64) << 32) | (item_sk.to(torch.int64) & 0xFFFFFFFF)


def _presence_counts(run_start: torch.Tensor, counted: torch.Tensor, store_s: torch.Tensor,
                     cat_s: torch.Tensor):
    """(store_only, catalog_only, both) over the runs of sorted rows that
    start where ``run_start`` is set, counting only the runs whose key is
    ``counted``: a run has a side when any of its rows has it."""
    n = run_start.shape[0]
    run_id = torch.cumsum(run_start, 0) - 1
    seen = torch.zeros((3, n), dtype=torch.int32, device=run_start.device)
    for i, flags in enumerate((store_s, cat_s, counted)):
        seen[i].index_add_(0, run_id, flags.to(torch.int32))
    has_store, has_cat = (seen[:2] > 0) & (seen[2] > 0)
    return ((has_store & ~has_cat).sum(), (has_cat & ~has_store).sum(),
            (has_store & has_cat).sum())


def _count_runs(keys: torch.Tensor, is_store: torch.Tensor, valid: torch.Tensor):
    """Sort-merge presence counting over one shard's co-located rows: for
    every distinct valid key, did it appear with a store tag, a catalog tag,
    or both?  Returns (store_only, catalog_only, both) int64 scalars."""
    ks, order = torch.sort(torch.where(valid, keys, _SENTINEL))
    store_s = (valid & is_store)[order]
    cat_s = (valid & ~is_store)[order]
    run_start = torch.ones_like(ks, dtype=torch.bool)
    run_start[1:] = ks[1:] != ks[:-1]
    return _presence_counts(run_start, ks != _SENTINEL, store_s, cat_s)


def q97_host_oracle(store, catalog):
    """(store_only, catalog_only, both) via host sets over (customer_sk,
    item_sk) arrays: the reference semantics (non-null keys)."""
    s = set(zip(store[0].tolist(), store[1].tolist()))
    c = set(zip(catalog[0].tolist(), catalog[1].tolist()))
    return len(s - c), len(c - s), len(s & c)


def q97_local(store: tuple, catalog: tuple) -> Q97Out:
    """Single-device q97 over (customer_sk, item_sk) int tensors, on their
    device."""
    sk = _composite_key(*store)
    ck = _composite_key(*catalog)
    keys = torch.cat([sk, ck])
    is_store = torch.cat([torch.ones_like(sk, dtype=torch.bool),
                          torch.zeros_like(ck, dtype=torch.bool)])
    so, co, b = _count_runs(keys, is_store, torch.ones_like(is_store))
    return Q97Out(so, co, b, torch.zeros((), dtype=torch.int32, device=keys.device))


def _sum_over_data(mesh: DeviceMesh, so, co, b, dropped) -> Q97Out:
    """The three counters and the drops summed over the data axis, in one
    collective."""
    out = torch.stack([so, co, b, dropped.to(torch.int64)])
    dist.all_reduce(out, group=axis_group(mesh, DATA_AXIS))
    return Q97Out(out[0], out[1], out[2], out[3].to(torch.int32))


def _tag(n_store: int, n_catalog: int, device) -> torch.Tensor:
    """int8 side tags: 1 for the store rows, then 0 for the catalog rows."""
    return torch.cat([torch.ones((n_store,), dtype=torch.int8, device=device),
                      torch.zeros((n_catalog,), dtype=torch.int8, device=device)])


def _sharded_q97(s_cust, s_item, c_cust, c_item, capacity: int, mesh: DeviceMesh,
                 s_valid=None, c_valid=None) -> Q97Out:
    sk = _composite_key(s_cust, s_item)
    ck = _composite_key(c_cust, c_item)
    # both tables ride one tagged all_to_all: the same bytes, half the collectives
    keys = torch.cat([sk, ck])
    tag = _tag(sk.shape[0], ck.shape[0], keys.device)
    row_valid = None
    if s_valid is not None or c_valid is not None:
        sv = torch.ones_like(sk, dtype=torch.bool) if s_valid is None else s_valid
        cv = torch.ones_like(ck, dtype=torch.bool) if c_valid is None else c_valid
        row_valid = torch.cat([sv, cv])
    part = partition_of(keys, axis_size(mesh, DATA_AXIS))
    ex = all_to_all_shuffle({"k": keys, "tag": tag}, part, capacity, mesh, axis=DATA_AXIS,
                            row_valid=row_valid)
    so, co, b = _count_runs(ex.columns["k"], ex.columns["tag"] == 1, ex.valid)
    return _sum_over_data(mesh, so, co, b, ex.dropped)


def make_distributed_q97(mesh: DeviceMesh, capacity: int, with_validity: bool = False):
    """q97 over ``mesh``'s data axis: a callable that each rank calls with its
    data shard of the store customer/item and catalog customer/item int
    tensors (and, with ``with_validity``, two bool tensors marking the store's
    and the catalog's real rows, so that padding rows do not count).  It
    returns the global :class:`Q97Out`.  ``capacity`` bounds each
    per-destination bucket of the combined row stream; ``dropped > 0`` means
    retry with a larger one.

    The callable crosses ``seam(COLLECTIVE, "all_to_all_shuffle")`` once per
    input signature, at its first call with it and before any launch, where
    the JAX package's jit traces the step (:class:`ShuffleCrossing`)."""
    crossing = ShuffleCrossing()
    if with_validity:
        def step(s_cust, s_item, c_cust, c_item, s_valid, c_valid):
            crossing(s_cust, s_item, c_cust, c_item, s_valid, c_valid)
            return _sharded_q97(s_cust, s_item, c_cust, c_item, capacity, mesh,
                                s_valid=s_valid, c_valid=c_valid)
    else:
        def step(s_cust, s_item, c_cust, c_item):
            crossing(s_cust, s_item, c_cust, c_item)
            return _sharded_q97(s_cust, s_item, c_cust, c_item, capacity, mesh)

    return step


@functools.lru_cache(maxsize=64)
def q97_plan(capacity: int) -> ir_mod.Plan:
    """The whole distributed q97 pipeline as ONE plan: two fact scans project
    the packed composite key, union with a source tag, exchange by key hash
    (the static ``capacity`` is plan structure: one executor per pow2
    capacity), then sort-merge presence counting.  Mesh-only (it contains an
    Exchange)."""
    from spark_rapids_jni_tpu_torch.plans.ir import Bin, Cast, col, lit

    key = Bin("bor",
              Bin("shl", Cast(col("cust"), "int64"), lit(32)),
              Bin("band", Cast(col("item"), "int64"), lit(0xFFFFFFFF)))
    store = ir_mod.Project(ir_mod.Scan("store", ("cust", "item")), (("key", key),))
    catalog = ir_mod.Project(ir_mod.Scan("catalog", ("cust", "item")), (("key", key),))
    node = ir_mod.Union((store, catalog), tag="tag", tag_values=(1, 0))
    node = ir_mod.Exchange(node, key=col("key"), capacity=int(capacity),
                           fields=("key", "tag"))
    return ir_mod.Plan("q97", (ir_mod.PresenceCount(node, key="key", tag="tag"),))


# ------------------------------------------------------- nullable columns --
# q97 over Column inputs with nullable keys.  SQL semantics: NULL keys group
# within a side (DISTINCT treats NULLs as one group) but never join across
# sides (NULL = NULL is unknown), so a side's null-key groups count as that
# side's "only" rows.


def _pair_key(cust, cust_valid, item, item_valid, side: int):
    """(k_hi, k_lo) two-limb group key over nullable (cust, item) int32 pairs.

    Each component widens to 33 bits (value | null flag); a row with any null
    key also carries a null marker and the side bit in k_lo, so null groups
    stay on their side.  Null slots are normalised to 0 | null flag: their
    data bits are garbage by contract."""
    null = 1 << 32
    c_ext = torch.where(cust_valid, cust.to(torch.int64) & 0xFFFFFFFF, null)
    i_ext = torch.where(item_valid, item.to(torch.int64) & 0xFFFFFFFF, null)
    null_any = ~cust_valid | ~item_valid
    k_lo = i_ext | torch.where(null_any, (2 | (side & 1)) << 33, 0)
    return c_ext, k_lo


def _count_runs_pair(k_hi, k_lo, is_store, valid):
    """:func:`_count_runs` over a two-limb key, sorted by (k_hi, k_lo): a
    stable sort by the low limb, then a stable sort by the high one."""
    kh = torch.where(valid, k_hi, _SENTINEL)
    kl = torch.where(valid, k_lo, _SENTINEL)
    by_lo = torch.argsort(kl, stable=True)
    order = by_lo[torch.argsort(kh[by_lo], stable=True)]
    khs, kls = kh[order], kl[order]
    store_s = (valid & is_store)[order]
    cat_s = (valid & ~is_store)[order]
    run_start = torch.ones_like(khs, dtype=torch.bool)
    run_start[1:] = (khs[1:] != khs[:-1]) | (kls[1:] != kls[:-1])
    return _presence_counts(run_start, khs != _SENTINEL, store_s, cat_s)


def _sharded_q97_columns(s_cust: Column, s_item: Column, c_cust: Column, c_item: Column,
                         s_rv, c_rv, capacity: int, mesh: DeviceMesh) -> Q97Out:
    """q97 on one rank over nullable Column keys.  ``s_rv``/``c_rv`` mark
    padding rows (the row does not exist); a null key in a real row is data,
    handled by the pair key's null semantics.  The whole table rides one
    tagged exchange through the columnar table shuffle."""
    skh, skl = _pair_key(s_cust.data, s_cust.is_valid(), s_item.data, s_item.is_valid(), 1)
    ckh, ckl = _pair_key(c_cust.data, c_cust.is_valid(), c_item.data, c_item.is_valid(), 0)
    k_hi = torch.cat([skh, ckh])
    k_lo = torch.cat([skl, ckl])
    tag = _tag(skh.shape[0], ckh.shape[0], k_hi.device)
    mixed = k_hi ^ (k_lo * _GOLDEN)  # golden-ratio mix, wrapping
    part = partition_of(mixed, axis_size(mesh, DATA_AXIS))
    ex = shuffle_table({"kh": Column(k_hi, None, INT64), "kl": Column(k_lo, None, INT64),
                        "tag": Column(tag, None, INT8)},
                       part, capacity, mesh, axis=DATA_AXIS, row_valid=torch.cat([s_rv, c_rv]))
    so, co, b = _count_runs_pair(ex.columns["kh"].data, ex.columns["kl"].data,
                                 ex.columns["tag"].data == 1, ex.valid)
    return _sum_over_data(mesh, so, co, b, ex.dropped)


def make_distributed_q97_columns(mesh: DeviceMesh, capacity: int):
    """q97 over nullable Column keys: a callable that each rank calls with its
    data shard of four int32 Columns (store customer/item, catalog
    customer/item, each with or without validity) and two bool row-valid
    tensors marking padding; it returns the global :class:`Q97Out`.

    The callable crosses ``seam(COLLECTIVE, "all_to_all_shuffle")`` once per
    input signature (which columns have validity counts), at its first call
    with it and before any launch, where the JAX package's jit traces the
    step (:class:`ShuffleCrossing`)."""
    crossing = ShuffleCrossing()

    def step(s_cust, s_item, c_cust, c_item, s_rv, c_rv):
        crossing(s_cust, s_item, c_cust, c_item, s_rv, c_rv)
        return _sharded_q97_columns(s_cust, s_item, c_cust, c_item, s_rv, c_rv, capacity,
                                    mesh)

    return step


# ------------------------------------------------------------ host helpers --
# Framework-neutral pieces of the governed control loop: key-space splitting,
# working-set estimates and capacities, the single-attempt plan run and the
# governed runner.


@dataclasses.dataclass(frozen=True)
class Q97Batch:
    """One (sub-)batch of host rows: the store and catalog key columns.

    ``split_depth`` tracks which key-space bit splits this piece next;
    ``capacity`` is the per-destination shuffle bucket bound.
    """

    s_cust: np.ndarray
    s_item: np.ndarray
    c_cust: np.ndarray
    c_item: np.ndarray
    capacity: int
    split_depth: int = 0

    @property
    def rows(self) -> int:
        return len(self.s_cust) + len(self.c_cust)


def split_q97_batch(batch: Q97Batch):
    """Split the *key space* in half (bit ``split_depth`` of a mixing hash).

    Unlike a row split, a key-space split is exact for q97: every distinct
    key lands wholly in one child (both tables filtered by the same
    predicate), so the three presence counters sum across children.  Each
    child also halves the shuffle capacity: the exchange buffers dominate the
    working set, and a child carries about half the rows.

    Each table is partitioned in native code (:mod:`.key_split`), which
    releases the GIL; the children's rows keep their input order, side 0's
    child first.
    """
    bit = 63 - batch.split_depth
    (s0, s1), (c0, c1) = (key_split.partition(batch.s_cust, batch.s_item, bit),
                          key_split.partition(batch.c_cust, batch.c_item, bit))
    return [dataclasses.replace(batch, s_cust=s[0], s_item=s[1], c_cust=c[0], c_item=c[1],
                                capacity=max(16, batch.capacity // 2),
                                split_depth=batch.split_depth + 1)
            for s, c in ((s0, c0), (s1, c1))]


def q97_working_set_bytes(batch: Q97Batch, dp: int) -> int:
    """Global working-set estimate: inputs + key/tag/valid stream + the
    [dp, capacity] send/recv exchange buffers + sort-merge workspace, over
    the quantized (padded) row counts that a run uploads."""
    n = (quantized_rows(len(batch.s_cust), dp)
         + quantized_rows(len(batch.c_cust), dp))
    per_row = 8 + 1 + 1  # key int64 + tag int8 + row_valid bool
    slots = dp * dp * batch.capacity
    return n * (8 + per_row) + 2 * slots * per_row + 2 * slots * 10


def _pad_to_multiple(arr: np.ndarray, mult: int, fill=0):
    """Pad to the dp-aligned pow2-quantized batch length; returns the padded
    array and a bool mask of its real rows."""
    pad = quantized_rows(len(arr), mult) - len(arr)
    if pad == 0:
        return arr, np.ones(len(arr), bool)
    padded = np.concatenate([arr, np.full(pad, fill, dtype=arr.dtype)])
    valid = np.concatenate([np.ones(len(arr), bool), np.zeros(pad, bool)])
    return padded, valid


def default_q97_capacity(total_rows: int, dp: int) -> int:
    """Default per-(sender, destination) bucket bound: the uniform share with
    a 2x skew margin (overflow is recoverable by growing), rounded up to a
    power of two so that data-dependent totals share few capacities."""
    raw = max(16, int(2 * total_rows / (dp * dp)) if dp > 1 else total_rows)
    return next_pow2(raw)


def run_q97_piece(mesh: DeviceMesh, piece: Q97Batch) -> Q97Out:
    """One execution of one q97 (sub-)batch through :func:`q97_plan` on every
    rank of ``mesh``, each rank passing the same host batch; returns the
    global counts as numpy scalars.  Pad, upload and run live in
    ``plans.runtime.execute_plan``.  Raises
    :class:`mem.governed.ShuffleCapacityExceeded` (on every rank) when rows
    overflowed the piece's exchange capacity: the caller grows it and
    re-runs."""
    from spark_rapids_jni_tpu_torch.plans.runtime import execute_plan

    out = execute_plan(mesh, q97_plan(piece.capacity), {
        "store": {"cust": piece.s_cust, "item": piece.s_item},
        "catalog": {"cust": piece.c_cust, "item": piece.c_item},
    })
    return Q97Out(out["store_only"], out["catalog_only"], out["both"], out["dropped"])


def combine_q97_outs(outs) -> Q97Out:
    """Sum partial presence counts (additive across key-space pieces)."""
    return Q97Out(
        sum(int(o.store_only) for o in outs),
        sum(int(o.catalog_only) for o in outs),
        sum(int(o.both) for o in outs),
        0,
    )


def run_distributed_q97(
    mesh: DeviceMesh,
    store,
    catalog,
    *,
    budget=None,
    task_id: int = 0,
    capacity: Optional[int] = None,
    manage_task: bool = True,
) -> Q97Out:
    """Governed distributed q97 over host (numpy) inputs, every rank of
    ``mesh`` passing the same tables.

    ``store``/``catalog`` are (customer_sk, item_sk) int32 array pairs.
    Every launch is admitted through the memory arbiter: the working set is
    reserved before the plan runs (mem/governed.py), RetryOOM retries,
    SplitAndRetryOOM splits the key space (exact), and shuffle-capacity
    overflow (dropped > 0) doubles the exchange capacity and re-reserves.
    The admission outcome is agreed over the data axis, so every rank splits
    and grows together.

    Reference protocol: RmmSpark.java:402-416; admission point analog of
    SparkResourceAdaptorJni.cpp:1731 do_allocate.

    ``manage_task=False`` joins a task context the caller already registered
    (the Spark shape: one dedicated thread registered per task runs many
    ops); the default registers/ends ``task_id`` itself.
    """
    import contextlib

    from spark_rapids_jni_tpu_torch.mem.governed import (
        default_device_budget,
        run_with_split_retry,
        task_context,
    )

    dp = axis_size(mesh, DATA_AXIS)
    s_cust, s_item = (np.asarray(a, np.int32) for a in store)
    c_cust, c_item = (np.asarray(a, np.int32) for a in catalog)
    if budget is None:
        budget = default_device_budget()
    total = len(s_cust) + len(c_cust)
    cap0 = capacity if capacity is not None else default_q97_capacity(total, dp)
    batch = Q97Batch(s_cust, s_item, c_cust, c_item, capacity=cap0)

    def run(piece: Q97Batch) -> Q97Out:
        return run_q97_piece(mesh, piece)

    ctx = (task_context(budget.gov, task_id) if manage_task
           else contextlib.nullcontext())
    with ctx:
        return run_with_split_retry(
            budget, batch,
            nbytes_of=lambda b: q97_working_set_bytes(b, dp),
            run=run,
            split=split_q97_batch,
            combine=combine_q97_outs,
            grow=lambda b: dataclasses.replace(b, capacity=2 * b.capacity),
            group=axis_group(mesh, DATA_AXIS),
        )
