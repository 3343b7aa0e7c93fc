"""Fixed-size page pools with row-offset tables for ragged batching (a copy
of the JAX package's ``columnar/pages.py``, host numpy only).

The executor's micro-batcher concatenates compatible payloads, so every
distinct total row count is its own compiled shape — the pow2 bucket
lattice bounds the variant set per geometry, but heterogeneous traffic
still walks the whole lattice (plan_cache gauges show the miss ramp).
*Ragged Paged Attention* (PAPERS.md) is the TPU-serving answer: requests
of arbitrary length pack into FIXED-SIZE pages, the kernel sees one
rectangular ``[num_pages * page_rows]`` buffer plus per-row bookkeeping,
and the compiled-variant set is bounded by page GEOMETRIES (pow2 page
counts), not request shapes.

This module is the host-side half of that convention:

- :func:`pack_ragged` packs N rider row-arrays contiguously into one
  page-pool buffer (``num_pages`` pow2-quantized), with the row-offset
  table, per-row validity, and per-row rider-id arrays the device kernel
  and the scatter-back need;
- :func:`scatter_ragged` slices a row-aligned result back per rider
  (bit-identical to running each rider alone — padding rows are
  validity-masked, and the fuzz parity test pins it);
- :class:`PagePool` recycles the host-side pack buffers per geometry so
  a steady-state serving tick allocates nothing, with occupancy gauges
  for serve/metrics and the flight recorder.

Split discipline: :func:`split_riders` halves a pack's PAGE COUNT by
partitioning riders into two groups (never splitting a rider mid-pack),
the page-granularity analog of ``split_scan_tables`` — a
``SplitAndRetryOOM`` re-packs each group into half the pages and re-runs;
a rider is never silently dropped.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from spark_rapids_jni_tpu_torch.columnar.column import next_pow2

__all__ = [
    "PageGeometry", "PackedPages", "PagePool", "page_pool",
    "geometry_for", "pack_ragged", "scatter_ragged", "split_point",
    "split_riders",
]

#: default rows per page (the JAX package's value); the
#: serving engine reads the ``serve_page_rows`` flag instead of this
DEFAULT_PAGE_ROWS = 256


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """The compiled-shape half of a pack: everything a traced program's
    input signature depends on.  ``num_pages`` and ``riders_cap`` are
    pow2-quantized, so the set of geometries a serving tick can produce
    is O(log max_rows * log max_riders) per (page_rows, dtype) — the
    plan-cache key bound the ragged path exists to deliver."""

    page_rows: int   # rows per fixed-size page (config, not data)
    num_pages: int   # pow2 page count covering the packed rows
    riders_cap: int  # pow2 bound on riders sharing the pool
    dtype: str       # row dtype of the packed data buffer

    @property
    def total_rows(self) -> int:
        return self.page_rows * self.num_pages

    def describe(self) -> str:
        return (f"p{self.page_rows}x{self.num_pages}"
                f"r{self.riders_cap}:{self.dtype}")


def geometry_for(total_rows: int, n_riders: int, page_rows: int,
                 dtype: str, *, min_pages: int = 1,
                 min_riders: int = 1) -> PageGeometry:
    """Geometry covering ``total_rows`` packed rows from ``n_riders``
    requests: page count AND rider capacity quantized to pow2, floored at
    ``min_pages``/``min_riders``.  The serving dispatcher floors at its
    STANDING pool size, so every steady-state tick — full or half-empty —
    shares ONE compiled program (padding is validity-masked); the floor
    only drops when a split explicitly halves the page count, so the
    compiled-variant set is bounded by page geometries (O(log) under
    pressure), never by request shapes."""
    page_rows = max(1, int(page_rows))
    pages = next_pow2(max(1, int(min_pages),
                          -(-int(total_rows) // page_rows)))
    riders = next_pow2(max(1, int(min_riders), int(n_riders)))
    return PageGeometry(page_rows, pages, riders, str(dtype))


@dataclasses.dataclass
class PackedPages:
    """One packed tick: the device-bound buffers + host scatter table.

    ``data``/``valid``/``rid`` are flat ``[num_pages * page_rows]``
    arrays (the page-pool calling convention — a kernel may reshape to
    ``[num_pages, page_rows]`` freely, the layout is row-major pages);
    ``offsets[i]:offsets[i+1]`` is rider ``i``'s row span, the scatter
    table.  Padding rows have ``valid=False`` and ``rid=riders_cap`` (an
    out-of-range drop bucket for segment scatters).
    """

    geometry: PageGeometry
    data: np.ndarray      # [total_rows] packed rider rows, zero-padded
    valid: np.ndarray     # bool[total_rows] real-row mask
    rid: np.ndarray       # int32[total_rows] rider index (riders_cap=pad)
    offsets: np.ndarray   # int64[n_riders + 1] rider row offsets
    n_riders: int
    rows_packed: int      # sum of rider lengths (== offsets[-1])

    @property
    def occupancy(self) -> float:
        """Real rows / pool capacity — the launch-efficiency gauge."""
        cap = self.geometry.total_rows
        return self.rows_packed / cap if cap else 0.0


def pack_ragged(rows: Sequence[np.ndarray], page_rows: int,
                pool: Optional["PagePool"] = None, *,
                min_pages: int = 1, min_riders: int = 1) -> PackedPages:
    """Pack rider row-arrays contiguously into one page-pool buffer.

    Riders keep their submit order (``offsets`` indexes them the same
    way), zero-row riders occupy an empty span (offsets[i] == offsets[i+1])
    and still scatter back an empty result — a rider is never dropped.
    All riders must share one dtype (the handler class contract).
    ``min_pages``/``min_riders`` floor the geometry (see
    :func:`geometry_for`).
    """
    if not rows:
        raise ValueError("pack_ragged needs at least one rider")
    arrs = [np.asarray(r) for r in rows]
    dtype = arrs[0].dtype
    for a in arrs:
        if a.dtype != dtype:
            raise ValueError(
                f"riders disagree on dtype: {a.dtype} != {dtype}")
        if a.ndim != 1:
            raise ValueError("pack_ragged packs 1-D row arrays")
    lens = [int(a.shape[0]) for a in arrs]
    offsets = np.zeros(len(arrs) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    total = int(offsets[-1])
    geom = geometry_for(total, len(arrs), page_rows, dtype.name,
                        min_pages=min_pages, min_riders=min_riders)
    cap = geom.total_rows
    if pool is not None:
        data, valid, rid = pool.acquire(geom)
    else:
        data = np.zeros(cap, dtype)
        valid = np.zeros(cap, bool)
        rid = np.full(cap, geom.riders_cap, np.int32)
    try:
        for i, a in enumerate(arrs):
            s, e = int(offsets[i]), int(offsets[i + 1])
            data[s:e] = a
            rid[s:e] = i
        valid[:total] = True
    except BaseException:
        # a mid-pack fault (an incompatible cast a rider smuggled past
        # the dtype check) must hand pooled buffers back, not orphan
        # them from the free list forever
        if pool is not None:
            pool.release(PackedPages(geom, data, valid, rid, offsets,
                                     len(arrs), total))
        raise
    return PackedPages(geom, data, valid, rid, offsets, len(arrs), total)


def scatter_ragged(result: np.ndarray, packed: PackedPages) -> List[np.ndarray]:
    """Slice a ROW-ALIGNED result (leading dim == pool rows) back per
    rider, copying so the pooled buffer can be recycled immediately."""
    result = np.asarray(result)
    if result.shape[0] != packed.geometry.total_rows:
        raise ValueError(
            f"result rows {result.shape[0]} != pool rows "
            f"{packed.geometry.total_rows}")
    out = []
    for i in range(packed.n_riders):
        s, e = int(packed.offsets[i]), int(packed.offsets[i + 1])
        out.append(np.array(result[s:e]))
    return out


def split_point(lens: Sequence[int]) -> int:
    """The rider index that halves a pack's ROWS: riders [0, cut) hold
    roughly half the packed rows, [cut, n) the rest, order preserved and
    each side non-empty.  The ONE cut-point rule shared by
    :func:`split_riders` and the serving dispatcher's request-group
    split (serve/ragged.py) — the two views of a pack must halve at the
    same rider or re-packs and re-groups diverge."""
    half = sum(lens) / 2.0
    acc = 0
    cut = 1  # each group keeps at least one rider
    for i, ln in enumerate(lens[:-1]):
        acc += ln
        cut = i + 1
        if acc >= half:
            break
    return cut


def split_riders(rows: Sequence[np.ndarray]) -> List[List[np.ndarray]]:
    """Halve a pack at PAGE granularity: partition riders into two groups
    of roughly half the packed rows each (rider order preserved, no rider
    ever split mid-pack or dropped).  A single rider cannot halve — the
    caller falls back to its per-request split protocol."""
    if len(rows) <= 1:
        return [list(rows)]
    cut = split_point([int(np.asarray(r).shape[0]) for r in rows])
    return [list(rows[:cut]), list(rows[cut:])]


class PagePool:
    """Reusable host-side pack buffers, one free list per geometry.

    The serving tick packs and scatters on the worker thread; recycling
    the (data, valid, rid) triple means a steady-state tick allocates
    nothing on host.  Bounded per geometry (a traffic spike's buffers
    don't pin memory forever) and fully lock-guarded — gauges are read
    from dump/telemetry threads mid-tick.
    """

    MAX_FREE_PER_GEOMETRY = 4

    def __init__(self):
        self._lock = threading.Lock()
        # geometry -> [(data, valid, rid), ...]  # guarded-by: _lock
        self._free: Dict[PageGeometry, List[Tuple]] = {}
        self._stats: Dict[str, int] = {  # guarded-by: _lock
            "acquires": 0, "reuses": 0, "allocated_bytes": 0,
            "buffers_free": 0,
        }

    def acquire(self, geom: PageGeometry) -> Tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
        """A zeroed (data, valid, rid) triple for ``geom`` — recycled
        when a buffer of that geometry is free, else freshly allocated."""
        with self._lock:
            self._stats["acquires"] += 1
            free = self._free.get(geom)
            if free:
                data, valid, rid = free.pop()
                self._stats["reuses"] += 1
                self._stats["buffers_free"] -= 1
            else:
                data = valid = rid = None
        if data is None:
            cap = geom.total_rows
            data = np.zeros(cap, np.dtype(geom.dtype))
            valid = np.zeros(cap, bool)
            rid = np.full(cap, geom.riders_cap, np.int32)
            with self._lock:
                self._stats["allocated_bytes"] += (
                    data.nbytes + valid.nbytes + rid.nbytes)
        else:
            data[:] = 0
            valid[:] = False
            rid[:] = geom.riders_cap
        return data, valid, rid

    def release(self, packed: PackedPages) -> None:
        """Return a pack's buffers to the free list (drop past the per-
        geometry bound — spike buffers are not pinned forever)."""
        with self._lock:
            free = self._free.setdefault(packed.geometry, [])
            if len(free) < self.MAX_FREE_PER_GEOMETRY:
                free.append((packed.data, packed.valid, packed.rid))
                self._stats["buffers_free"] += 1

    def gauges(self) -> Dict[str, int]:
        """JSON-able pool stats for serve/metrics + flight telemetry."""
        with self._lock:
            g = dict(self._stats)
            g["geometries"] = len(self._free)
            return g

    def clear(self) -> None:
        with self._lock:
            self._free.clear()
            self._stats["buffers_free"] = 0


#: the process-global pool every ragged dispatcher shares (like the plan
#: cache: one resident set, one gauge surface)
page_pool = PagePool()
