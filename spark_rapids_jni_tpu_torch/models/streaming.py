"""Out-of-core NDS execution: streamed generation + grace-hash bucketing
(PyTorch port of ``models/streaming.py``).

BASELINE config 5 names TPC-DS SF100; no single host holds the fact stream
in memory.  The scalable shape is the classic external hash shuffle the
reference relies on Spark for:

- facts are *generated/ingested in chunks* (bounded host memory),
- each chunk's rows are routed to a key-space bucket by a stable hash of
  the join key and appended to that bucket's spill file -- JCUDF row
  batches carrying the FULL table (validity, strings, decimal128) through
  io/spill.py's ExternalTableShuffle, the host analog of
  parallel/table_shuffle.py's device exchange,
- each bucket then fits in memory by construction (total/n_buckets) and
  is executed as one governed distributed query piece on the card (q97's
  Exchange places its rows with the ``mm_hash_long`` kernel); per-bucket
  results are additive because a (customer, item) pair lands in exactly one
  bucket on both sides.

On several ranks the same plan maps bucket -> rank group and spill file ->
an ``all_to_all`` (parallel/table_shuffle.py); here the seam between "route
rows" and "execute bucket" is identical, just disk-backed.  Parity: the
reference delegates exactly this to Spark's external shuffle
(RapidsShuffleManager) carrying its JCUDF row batches
(row_conversion.cu:574); q97 itself is src/main/java: same join-count
semantics as models/q97.py.

Every chunk stream, spill file, bucket routing and per-bucket result equals
the JAX package's: the generators make the same numpy calls from the same
seeds, and the spill codec writes the same bytes.  ``PHASES`` (host clock)
and :func:`device_seconds` (CUDA events around each bucket's device run)
split a run's wall time into host and device work; ``io.spill.PHASES``
holds the shuffle's own share.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.io import spill as _spill
from spark_rapids_jni_tpu_torch.io.spill import ExternalTableShuffle, pair_mix64
from spark_rapids_jni_tpu_torch.obs.phases import PhaseTimes

__all__ = [
    "ExternalTableShuffle",
    "generate_q97_chunks",
    "run_streaming_q97",
    "bucket_of_pairs",
    "q97_spill_shuffle",
    "generate_q5_chunks",
    "run_streaming_q5",
]

#: host seconds of a streamed run outside the shuffle: drawing the chunks,
#: the routing hash and owner filter, each bucket's governed run (host
#: clock around the device work) and the per-bucket oracle
PHASES = PhaseTimes("generate", "hash", "bucket_run", "verify", name="streaming")
_SPANS: List[tuple] = []  # (start, end) CUDA events around each bucket's device run


def reset_timers() -> None:
    """Zero :data:`PHASES`, ``io.spill.PHASES`` and the device spans."""
    PHASES.reset()
    _spill.PHASES.reset()
    _SPANS.clear()


def device_seconds() -> float:
    """Seconds between the CUDA events around every bucket's device run
    since :func:`reset_timers` (0.0 when no bucket ran on a card)."""
    if not _SPANS:
        return 0.0
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in _SPANS) / 1e3


@contextlib.contextmanager
def _bucket_span(mesh):
    """Time one bucket's governed run: the host clock always, CUDA events
    too when ``mesh`` is on the card."""
    with PHASES.phase("bucket_run"):
        if mesh.device_type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield
        finally:
            end.record()
            _SPANS.append((start, end))


def _ranks_group(mesh):
    """The data axis's group when ``mesh`` spans several data ranks, else
    None.  Every rank stages the same chunks into buckets of its own, so the
    host reservations agree by construction; agreeing each outcome over the
    group as well keeps the ranks' on-disk splits, and so their collectives,
    in step should one rank's host budget ever decide otherwise."""
    from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_size

    return axis_group(mesh, DATA_AXIS) if axis_size(mesh, DATA_AXIS) > 1 else None


def _timed_chunks(chunks: Iterable):
    """``chunks`` with the time spent drawing each one added to
    ``PHASES["generate"]``."""
    it = iter(chunks)
    while True:
        with PHASES.phase("generate"):
            try:
                chunk = next(it)
            except StopIteration:
                return
        yield chunk


def _host_column(values: np.ndarray, validity: Optional[np.ndarray], dtype):
    """A port Column over host arrays (copied only when not writable)."""
    from spark_rapids_jni_tpu_torch.columnar.column import Column

    def t(a):
        return None if a is None else torch.from_numpy(np.require(a, requirements=["C", "W"]))

    return Column(t(values), t(validity), dtype)


def bucket_of_pairs(cust: np.ndarray, item: np.ndarray,
                    n_buckets: int) -> np.ndarray:
    """Stable key-space bucket of (customer, item) int32 pairs: splitmix64
    finalizer over the packed pair (io/spill.py pair_mix64).  Any fixed mix
    works -- both sides must agree, nothing else -- but it must be *well
    mixed*: TPC-DS surrogate keys are dense integers, and ``pair % n``
    would put all of one customer in one bucket."""
    return (pair_mix64(cust, item) % np.uint64(n_buckets)).astype(np.int64)


def _pair_key_hash(cols) -> np.ndarray:
    """ExternalTableShuffle key hash for the q97 (cust, item) int32 pair --
    identical mix to :func:`bucket_of_pairs`, so bucket placement agrees
    with the ownership filter."""
    return pair_mix64(cols[0].data.cpu().numpy(), cols[1].data.cpu().numpy())


def q97_spill_shuffle(tmpdir: str, n_buckets: int) -> ExternalTableShuffle:
    """The q97 fact-pair spill shuffle: two non-null int32 key columns in
    JCUDF rows, routed by the pair hash."""
    from spark_rapids_jni_tpu_torch.columnar.dtypes import INT32

    return ExternalTableShuffle(
        tmpdir, n_buckets, [INT32, INT32], key_indices=(0, 1),
        key_hash=_pair_key_hash)


def generate_q97_chunks(sf: float, seed: int, chunk_rows: int
                        ) -> Iterator[Tuple[str, np.ndarray, np.ndarray]]:
    """Stream the q97 fact pair as ``(side, cust, item)`` chunks.

    Same marginal distribution as tpcds.generate_q97_tables (chunk c draws
    from a per-chunk seeded rng, so any prefix is reproducible without
    materializing the whole table -- the streaming analog of dsdgen's
    parallel generation, which also seeds per partition)."""
    n = max(1000, int(2_800_000 * sf))
    n_cust = max(2, n // 14)
    for side_idx, side in enumerate(("store", "catalog")):
        done = 0
        chunk = 0
        while done < n:
            m = min(chunk_rows, n - done)
            rng = np.random.RandomState(
                (seed + 1_000_003 * side_idx + chunk) % (2**31 - 1))
            yield (side,
                   rng.randint(1, n_cust, m).astype(np.int32),
                   rng.randint(1, 18_000, m).astype(np.int32))
            done += m
            chunk += 1


def _packed_distinct(cust: np.ndarray, item: np.ndarray) -> np.ndarray:
    """The sorted distinct (cust, item) int32 pairs, packed into int64 (an
    injective packing of any two int32s)."""
    k = np.sort((cust.astype(np.int64) << 32) | (item.astype(np.int64) & 0xFFFFFFFF))
    if len(k) == 0:
        return k
    keep = np.empty(len(k), bool)
    keep[0] = True
    np.not_equal(k[1:], k[:-1], out=keep[1:])
    return k[keep]


def _distinct_counts(store, catalog) -> Tuple[int, int, int]:
    """``q97_host_oracle``'s (store_only, catalog_only, both) from sorted
    distinct pairs rather than Python sets: the per-bucket oracle at SF100
    (millions of rows a bucket), where sets take longer than the query."""
    s = _packed_distinct(*store)
    c = _packed_distinct(*catalog)
    at = np.searchsorted(c, s)
    both = int(np.count_nonzero(c[np.minimum(at, len(c) - 1)] == s)) if len(c) else 0
    return len(s) - both, len(c) - both, both


# ------------------------------------------------------------ streamed q5 --
# q5's aggregates are per-(channel, dim_sk) segment sums -- additive over any
# disjoint row partition -- so the grace hash needs no join co-location; it
# routes by the GROUP key (dim sk) per channel anyway, which makes every
# (channel, sk) group bucket-local and the per-bucket oracle exact without a
# global materialize.  Facts spill as full JCUDF tables (nullable keys +
# int64 money) through one ExternalTableShuffle with six sides:
# "{channel}.{sales|ret}".


def generate_q5_chunks(sf: float, seed: int, chunk_rows: int,
                       null_pct: float = 0.04):
    """Stream the q5 fact tables as ``(channel, kind, arrays)`` chunks.

    Same totals as tpcds.generate_q5_data (n_sales = 40k*sf scaled down by
    channel, returns = sales/8) with per-chunk seeded rngs, so any prefix
    is reproducible without materializing a table.  ``kind`` is "sales"
    (m1=price, m2=profit) or "ret" (m1=amt, m2=loss).
    """
    from spark_rapids_jni_tpu_torch.models.tpcds import CHANNELS, q5_dims

    dims = q5_dims()
    d0 = int(dims.date_sk[0])
    n_dates = len(dims.date_sk)
    for ci, name in enumerate(CHANNELS):
        n_dim = dims.channel_size(name)
        n_sales = max(8, int(40_000 * sf) // (ci + 1))
        for ki, (kind, total, m2_lo, m2_hi) in enumerate(
                (("sales", n_sales, -100_00, 200_00),
                 ("ret", max(4, n_sales // 8), 0, 80_00))):
            done = 0
            chunk = 0
            while done < total:
                m = min(chunk_rows, total - done)
                rng = np.random.RandomState(
                    (seed + 7_000_003 * ci + 500_009 * ki + chunk)
                    % (2**31 - 1))
                sk = rng.randint(1, n_dim + 1, m).astype(np.int32)
                sk_valid = rng.rand(m) >= null_pct
                date = rng.randint(d0, d0 + n_dates, m).astype(np.int32)
                date_valid = rng.rand(m) >= null_pct
                yield (name, kind, {
                    "sk": np.where(sk_valid, sk, 0).astype(np.int32),
                    "sk_valid": sk_valid,
                    "date": np.where(date_valid, date, 0).astype(np.int32),
                    "date_valid": date_valid,
                    "m1": rng.randint(0, 500_00, m).astype(np.int64),
                    "m2": rng.randint(m2_lo, m2_hi, m).astype(np.int64),
                })
                done += m
                chunk += 1


def _q5_side_facts(shuffle: ExternalTableShuffle, channel: str, bucket: int):
    """Decode one channel's (sales, ret) spill sides of one bucket into the
    q5 fact-array dict the partials step consumes (host arrays)."""
    out = {}
    for kind, names in (("sales", ("sales_sk", "sales_date",
                                   "sales_price", "sales_profit")),
                        ("ret", ("ret_sk", "ret_date",
                                 "ret_amt", "ret_loss"))):
        cols = shuffle.read(f"{channel}.{kind}", bucket, device="cpu")
        n = len(cols[0])
        for col, cname in zip(cols, names):
            out[cname] = col.data.numpy()
        for key_col, cname in ((cols[0], f"{kind}_sk"),
                               (cols[1], f"{kind}_date")):
            out[f"{cname}_valid"] = (
                np.ones(n, bool) if key_col.validity is None
                else key_col.validity.numpy())
    return out


def _check_owner(bucket_owner: Optional[Tuple[int, int]]) -> None:
    if bucket_owner is not None:
        proc_id, nprocs = bucket_owner
        if not (0 <= proc_id < nprocs):
            raise ValueError(f"bucket_owner {bucket_owner}: need "
                             "0 <= proc_id < nprocs")


def run_streaming_q5(
    mesh,
    chunks,
    *,
    tmpdir: str,
    n_buckets: int = 16,
    budget=None,
    host_budget=None,
    task_id: int = 0,
    verify: bool = False,
    bucket_owner: Optional[Tuple[int, int]] = None,
):
    """Out-of-core governed distributed q5 over streamed fact chunks, on
    ``mesh`` (its device is where every bucket runs).

    Returns ``(rows, verified, stats)`` where ``rows`` is the full
    ROLLUP(channel, id) result.  Each bucket runs through ONE cached plan
    executor (geometry is the dim side, bucket-independent); per-bucket
    partial vectors sum into the global answer because every aggregate is
    additive over the disjoint bucket rows.  ``verify`` checks each bucket
    against the numpy oracle (models.q5.q5_host_channel_partials) --
    bucket-local, bounded memory.

    Host staging is governed like streamed q97: the bucket's ACTUAL
    spill-file bytes are reserved on the arbiter's CPU path; an
    over-budget bucket recursively splits on disk (partials stay additive
    under ANY row partition, so key-space splits are trivially exact).
    """
    from spark_rapids_jni_tpu_torch.columnar.dtypes import INT32, INT64
    from spark_rapids_jni_tpu_torch.mem.governed import (
        default_device_budget,
        run_with_split_retry,
        task_context,
    )
    from spark_rapids_jni_tpu_torch.models.q5 import (
        ChannelPartials,
        add_partials,
        q5_host_channel_partials,
        q5_rollup,
        run_q5_partials,
    )
    from spark_rapids_jni_tpu_torch.models.tpcds import CHANNELS, q5_dims

    _check_owner(bucket_owner)
    if budget is None:
        budget = default_device_budget()
    dims = q5_dims()
    schema = [INT32, INT32, INT64, INT64]  # sk, date, m1, m2
    shuffle = ExternalTableShuffle(tmpdir, n_buckets, schema,
                                   key_indices=(0,))
    rows_in = 0
    try:
        for channel, kind, ch in _timed_chunks(chunks):
            rows_in += len(ch["sk"])
            with PHASES.phase("hash"):
                arrays = [(ch["sk"], ch["sk_valid"], INT32),
                          (ch["date"], ch["date_valid"], INT32),
                          (ch["m1"], None, INT64),
                          (ch["m2"], None, INT64)]
                hashes = shuffle.row_hashes([_host_column(*a) for a in arrays])
                if bucket_owner is not None:
                    ids = (hashes % np.uint64(n_buckets)).astype(np.int64)
                    mine = (ids % bucket_owner[1]) == bucket_owner[0]
                    if not mine.any():
                        continue
                    arrays = [(v[mine], None if ok is None else ok[mine], dt)
                              for v, ok, dt in arrays]
                    hashes = hashes[mine]
                cols = [_host_column(*a) for a in arrays]
            shuffle.append(f"{channel}.{kind}", cols, hashes=hashes)

        verified: Optional[bool] = True if verify else None

        def run_bucket(b: int):
            with _spill.PHASES.phase("read_decode"):
                batch = {name: _q5_side_facts(shuffle, name, b)
                         for name in CHANNELS}
            with _bucket_span(mesh):
                per = run_q5_partials(
                    mesh, batch,
                    date_sk=dims.date_sk, date_days=dims.date_days,
                    n_dims=dims.n_dims,
                    lo=dims.sales_date_lo, hi=dims.sales_date_hi,
                    budget=budget, task_id=task_id, manage_task=False)
            oracle_ok = True
            if verify:
                with PHASES.phase("verify"):
                    for name, n_dim in zip(CHANNELS, dims.n_dims):
                        want = q5_host_channel_partials(
                            batch[name], n_dim, dims.date_sk, dims.date_days,
                            dims.sales_date_lo, dims.sales_date_hi)
                        got = per[name]
                        oracle_ok = oracle_ok and all(
                            np.array_equal(np.asarray(g, np.int64),
                                           np.asarray(w, np.int64))
                            for g, w in zip(got, want))
            return per, oracle_ok

        n_splits = [0]

        def split_piece(b: int):
            n_splits[0] += 1
            return shuffle.split_bucket(b)

        def combine_pieces(rs):
            acc = rs[0][0]
            for per, _ok in rs[1:]:
                acc = add_partials(acc, per)
            return acc, all(ok for _p, ok in rs)

        totals = None
        with task_context(budget.gov, task_id):
            for b in range(n_buckets):
                if bucket_owner is not None and \
                        b % bucket_owner[1] != bucket_owner[0]:
                    continue
                if shuffle.bucket_rows(b) == 0:
                    continue
                if host_budget is not None:
                    per, oracle_ok = run_with_split_retry(
                        host_budget, b,
                        nbytes_of=shuffle.bucket_nbytes,
                        run=run_bucket,
                        split=split_piece,
                        combine=combine_pieces,
                        group=_ranks_group(mesh),
                    )
                else:
                    per, oracle_ok = run_bucket(b)
                if verify and not oracle_ok:
                    verified = False
                totals = per if totals is None else add_partials(totals, per)
        if totals is None:  # no owned rows at all
            totals = {name: ChannelPartials(
                np.zeros(nd, np.int64), np.zeros(nd, np.int64),
                np.zeros(nd, np.int64), np.zeros(nd, np.int32))
                for name, nd in zip(CHANNELS, dims.n_dims)}
        rows = q5_rollup(totals, dims.dim_id)
        stats = {
            "rows_in": rows_in,
            "n_buckets": n_buckets,
            "max_bucket_rows": shuffle.max_bucket_rows(),
        }
        if host_budget is not None:
            stats["host_peak_reserved"] = host_budget.peak
            stats["bucket_splits"] = n_splits[0]
        return rows, verified, stats
    finally:
        shuffle.close()


def run_streaming_q97(
    mesh,
    chunks: Iterable[Tuple[str, np.ndarray, np.ndarray]],
    *,
    tmpdir: str,
    n_buckets: int = 16,
    budget=None,
    host_budget=None,
    task_id: int = 0,
    verify: bool = False,
    bucket_owner: Optional[Tuple[int, int]] = None,
) -> Tuple[Tuple[int, int, int], Optional[bool], Dict[str, int]]:
    """Out-of-core governed distributed q97 over streamed fact chunks, on
    ``mesh`` (its device is where every bucket runs).

    Returns ``((store_only, catalog_only, both), verified, stats)``.
    ``verified`` is per-bucket oracle agreement (None when ``verify`` is
    off) -- bucket-local distinct sets are the whole point: the oracle's
    working set is also bounded by the bucket size.

    ``host_budget`` (a ``BudgetedResource(..., is_cpu=True)``) governs the
    HOST-side bucket materialization: each bucket's ACTUAL spill-file bytes
    are reserved through the arbiter's CPU path before the bucket is read
    back, so a multi-tenant host blocks/wakes on pinned-host pressure
    exactly like device pressure (the reference governs CPU allocations
    through the same state machine -- SparkResourceAdaptorJni.cpp is_for_cpu
    paths).

    ``bucket_owner=(proc_id, nprocs)`` restricts execution to the buckets
    this participant OWNS (``b % nprocs == proc_id``) -- the deployment
    shape across hosts: host groups partition the bucket space, per-owner
    counts stay additive, and the global answer is the sum of the owners'
    results.
    """
    from spark_rapids_jni_tpu_torch.columnar.dtypes import INT32
    from spark_rapids_jni_tpu_torch.mem.governed import (
        default_device_budget,
        run_with_split_retry,
        task_context,
    )
    from spark_rapids_jni_tpu_torch.models.q97 import (
        default_q97_capacity,
        run_distributed_q97,
    )
    from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, axis_size

    _check_owner(bucket_owner)
    if budget is None:
        budget = default_device_budget()
    shuffle = q97_spill_shuffle(tmpdir, n_buckets)
    rows_in = 0
    try:
        for side, cust, item in _timed_chunks(chunks):
            rows_in += len(cust)
            with PHASES.phase("hash"):
                hashes = pair_mix64(cust, item)
                if bucket_owner is not None:
                    # spool ONLY owned buckets: (nprocs-1)/nprocs of the
                    # shuffle disk IO is someone else's and never read here
                    ids = (hashes % np.uint64(n_buckets)).astype(np.int64)
                    mine = (ids % bucket_owner[1]) == bucket_owner[0]
                    if not mine.any():
                        continue
                    cust, item, hashes = cust[mine], item[mine], hashes[mine]
                cols = [_host_column(cust, None, INT32), _host_column(item, None, INT32)]
            shuffle.append(side, cols, hashes=hashes)

        dp = axis_size(mesh, DATA_AXIS)
        # ONE capacity for every bucket piece -> one plan executor reused
        cap = default_q97_capacity(shuffle.max_bucket_rows(), dp)
        totals = [0, 0, 0]
        verified: Optional[bool] = True if verify else None

        def read_pair(side: str, b: int):
            cols = shuffle.read(side, b, device="cpu")
            return cols[0].data.numpy(), cols[1].data.numpy()

        def run_bucket(b: int):
            with _spill.PHASES.phase("read_decode"):
                store_b = read_pair("store", b)
                cat_b = read_pair("catalog", b)
            with _bucket_span(mesh):
                out = run_distributed_q97(
                    mesh, store_b, cat_b, budget=budget, task_id=task_id,
                    capacity=cap, manage_task=False)
                got = (int(out.store_only), int(out.catalog_only), int(out.both))
            oracle_ok = True
            if verify:
                with PHASES.phase("verify"):
                    oracle_ok = got == _distinct_counts(store_b, cat_b)
            return got, oracle_ok

        n_splits = [0]

        def split_piece(b: int):
            # recursive grace hash: re-partition the oversized bucket on
            # disk into two key-space-consistent halves (counts stay
            # additive); run_with_split_retry then reserves each half
            n_splits[0] += 1
            return shuffle.split_bucket(b)

        def combine_pieces(rs):
            return (tuple(sum(r[0][i] for r in rs) for i in range(3)),
                    all(r[1] for r in rs))

        with task_context(budget.gov, task_id):
            for b in range(n_buckets):
                if bucket_owner is not None and \
                        b % bucket_owner[1] != bucket_owner[0]:
                    continue
                if shuffle.bucket_rows(b) == 0:
                    continue
                if host_budget is not None:
                    # the canonical retry driver brackets the host
                    # reservation -- sized by the bucket's ACTUAL spill-file
                    # bytes: RetryOOM from multi-tenant pressure re-runs
                    # the bucket; an over-budget bucket splits on disk
                    # instead of crashing the stream
                    got, oracle_ok = run_with_split_retry(
                        host_budget, b,
                        nbytes_of=shuffle.bucket_nbytes,
                        run=run_bucket,
                        split=split_piece,
                        combine=combine_pieces,
                        group=_ranks_group(mesh),
                    )
                else:
                    got, oracle_ok = run_bucket(b)
                if verify and not oracle_ok:
                    verified = False
                for i in range(3):
                    totals[i] += got[i]
        stats = {
            "rows_in": rows_in,
            "n_buckets": n_buckets,
            "max_bucket_rows": shuffle.max_bucket_rows(),
            "capacity": cap,
        }
        if host_budget is not None:
            # snapshot, NOT reset_peak(): the budget may be shared by
            # concurrent tenants, and mutating a caller-owned high-water
            # mark would race; this is the global peak so far by contract
            stats["host_peak_reserved"] = host_budget.peak
            stats["bucket_splits"] = n_splits[0]
        return tuple(totals), verified, stats
    finally:
        shuffle.close()
