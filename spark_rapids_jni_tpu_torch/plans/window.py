"""Order-sensitive execution primitives: sort keys, sorted runs and
segment-scan window functions (PyTorch port of ``plans/window.py``).

Everything order-related reduces to one canonical transform: :func:`sort_rank`
maps a column to u64 ranks whose unsigned ascending order is the column's SQL
order (descending keys bit-flip; floats use the IEEE total order with Spark's
NaN/+-0.0 canonicalization: -0.0 == 0.0 and every NaN is one largest value).
The Sort/Window/TopK emitters (compiler.py) sort by the ranks, and the host
side samples them to choose range splitters (:func:`choose_splitters`,
:func:`range_partition`), so the device order and the partition order cannot
disagree.

torch's ``uint64`` lacks ``<``, ``>>`` and a sort, so a rank is carried as the
int64 tensor of its bits -- equal, through numpy's ``.view(np.uint64)``, to
the JAX package's ``uint64`` -- and sorted or compared after flipping its top
bit (:func:`signed_key`): the signed order of ``r ^ (1 << 63)`` is the
unsigned order of ``r``.

Window functions run on sorted runs: equal-partition-key rows form segments
(run starts from rank change points), and rank/dense_rank/row_number and the
running sum/min/max with ROWS-frame semantics come from segment scans --
``cummax`` over start indices, a log-step doubling scan that stops at each
segment's start, and cumsum differences.  Invalid rows sort last and open
their own runs, so they never reach a valid segment's aggregate.  The two
host functions (:func:`sort_rank_np`, :func:`choose_splitters`,
:func:`range_partition`) are numpy, copied.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "sort_rank", "sort_rank_np", "order_permutation", "run_boundaries",
    "change_points", "segment_start_indices", "row_number", "rank",
    "dense_rank", "framed_sum", "framed_minmax",
    "choose_splitters", "range_partition", "signed_key", "signed_splitter",
]

_SIGN = np.uint64(1) << np.uint64(63)
#: the top bit as an int64: ``r ^ _SIGN64`` flips it
_SIGN64 = -(1 << 63)
#: one canonical quiet-NaN bit pattern (Spark: all NaNs equal, largest)
_CANON_NAN = np.int64(0x7FF8000000000000)


# ------------------------------------------------------------- sort ranks


# twin: sort_rank
def sort_rank(x: torch.Tensor, ascending: bool = True) -> torch.Tensor:
    """u64 ranks (as int64 bits) whose unsigned ascending order is ``x``'s
    sort order.

    - ints/bool: ints sign-bias (order-preserving), bools are 0 and 1;
    - floats: widen to float64, canonicalize ``-0.0 -> +0.0`` and every NaN
      to one quiet-NaN pattern (NaN == NaN, NaN largest -- Spark's ordering),
      then the IEEE total-order transform;
    - ``ascending=False`` bit-flips, so a descending key is just another
      ascending rank.
    """
    if x.is_floating_point():
        f = x.to(torch.float64)
        f = torch.where(f == 0.0, 0.0, f)  # -0.0 and +0.0 are one value
        bits = torch.where(torch.isnan(f), int(_CANON_NAN), f.view(torch.int64))
        u = torch.where(bits < 0, ~bits, bits | _SIGN64)
    elif x.dtype == torch.bool:
        u = x.to(torch.int64)
    else:
        u = x.to(torch.int64) ^ _SIGN64
    return u if ascending else ~u


# twin: sort_rank
def sort_rank_np(x: np.ndarray, ascending: bool = True) -> np.ndarray:
    """Host twin of :func:`sort_rank`, bit-identical (as ``uint64``)."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        f = x.astype(np.float64)
        f = np.where(f == 0.0, 0.0, f)
        bits = f.view(np.int64).copy()
        bits[np.isnan(f)] = _CANON_NAN
        u = np.where(bits < 0,
                     ~bits.view(np.uint64),
                     bits.view(np.uint64) | _SIGN)
    elif x.dtype == np.bool_:
        u = x.astype(np.uint64)
    else:
        u = x.astype(np.int64).view(np.uint64) ^ _SIGN
    return u if ascending else ~u


def signed_key(ranks: torch.Tensor) -> torch.Tensor:
    """The int64 whose signed order is the unsigned order of ``ranks``."""
    return ranks ^ _SIGN64


def signed_splitter(value: int) -> int:
    """:func:`signed_key` of one python-int u64 rank."""
    v = int(value) ^ (1 << 63)
    return v - (1 << 64) if v >= (1 << 63) else v


def order_permutation(ranks: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """The gather permutation sorting rows by ``ranks`` (major key first),
    valid rows before invalid.  It is ``jnp.lexsort``'s, ties included: one
    stable sort per key from the least significant up, so equal-key rows
    keep their input order."""
    keys = [signed_key(r) for r in reversed(list(ranks))]
    keys.append((~valid).to(torch.int8))
    perm = torch.arange(valid.shape[0], dtype=torch.int64, device=valid.device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


# ------------------------------------------------------------ sorted runs


def change_points(ranks: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row i differs from row i-1 in ANY rank column (row 0 is True) -- the
    run-start primitive over already-sorted rank columns."""
    ranks = list(ranks)
    n = ranks[0].shape[0]
    out = torch.zeros(n, dtype=torch.bool, device=ranks[0].device)
    for r in ranks:
        out[1:] |= r[1:] != r[:-1]
    if n:
        out[0] = True
    return out


def run_boundaries(part_ranks: Sequence[torch.Tensor], valid: torch.Tensor) -> torch.Tensor:
    """Run starts over sorted partition-key ranks, with the validity flag as
    an extra key: the first invalid row (they sort last) always opens a new
    run, so invalid rows never extend a valid segment."""
    return change_points(list(part_ranks) + [valid.to(torch.int8)])


def _index(run_start: torch.Tensor) -> torch.Tensor:
    return torch.arange(run_start.shape[0], dtype=torch.int64, device=run_start.device)


def segment_start_indices(run_start: torch.Tensor) -> torch.Tensor:
    """For every row, the index of its run's first row (run_start[0] is True
    by construction): a cummax over the start positions."""
    return torch.cummax(torch.where(run_start, _index(run_start), 0), dim=0).values


# ------------------------------------------------------ window functions


def row_number(run_start: torch.Tensor) -> torch.Tensor:
    """1-based position within the run."""
    return _index(run_start) - segment_start_indices(run_start) + 1


def rank(run_start: torch.Tensor, order_change: torch.Tensor) -> torch.Tensor:
    """SQL rank: 1 + number of rows strictly before this row's tie group.
    It depends only on key values (ties share a rank), never on the order
    within a tie."""
    group_start = segment_start_indices(run_start | order_change)
    return group_start - segment_start_indices(run_start) + 1


def dense_rank(run_start: torch.Tensor, order_change: torch.Tensor) -> torch.Tensor:
    """SQL dense_rank: 1 + number of distinct order keys before this row's
    within its run."""
    c = torch.cumsum((run_start | order_change).to(torch.int64), dim=0)
    return c - c[segment_start_indices(run_start)] + 1


_SCAN_BLOCK = 16  # XLA:CPU's cumsum block width


def _xla_cumsum(v: torch.Tensor) -> torch.Tensor:
    """Inclusive float cumsum of a 1-D tensor in the order XLA:CPU adds
    ``jnp.cumsum``: a base-16 blocked scan.  The vector is zero-padded to
    whole blocks of 16; each block is a left fold from a zero start; the
    block totals are scanned by the same rule, recursively; each block then
    adds its exclusive carry.  A vector of one element comes back as it is.
    Every step is a column add, the same IEEE operation on the CPU and the
    card, so both give XLA's bits (NaN signs aside, which XLA leaves to its
    vector units' operand order)."""
    n = v.shape[0]
    if n <= 1:
        return v.clone()
    m = -(-n // _SCAN_BLOCK)
    blocks = torch.zeros((m * _SCAN_BLOCK,), dtype=v.dtype, device=v.device)
    blocks[:n] = v
    blocks = blocks.view(m, _SCAN_BLOCK)
    acc = torch.zeros((m,), dtype=v.dtype, device=v.device)
    cols = []
    for j in range(_SCAN_BLOCK):
        acc = acc + blocks[:, j]
        cols.append(acc)
    sums = torch.stack(cols, dim=1)
    if m > 1:
        inclusive = _xla_cumsum(sums[:, -1].contiguous())
        carry = torch.cat([torch.zeros((1,), dtype=v.dtype, device=v.device), inclusive[:-1]])
        sums = sums + carry[:, None]
    return sums.reshape(-1)[:n]


def framed_sum(v: torch.Tensor, run_start: torch.Tensor,
               preceding: Optional[int] = None) -> torch.Tensor:
    """Running sum over the ROWS frame ``[i - preceding, i]`` within the run
    (``preceding=None`` = UNBOUNDED PRECEDING), via cumsum differences
    clamped at the segment start.  Exact for integer dtypes, which keep
    their width (and wrap) as ``jnp.cumsum``'s do; a bool sums as int64.
    Floats add in XLA:CPU's order (:func:`_xla_cumsum`), so they equal the
    JAX package's bits on the CPU and on the card."""
    seg0 = segment_start_indices(run_start)
    if v.is_floating_point():
        cs = _xla_cumsum(v)
    else:
        cs = torch.cumsum(v, dim=0, dtype=None if v.dtype == torch.bool else v.dtype)
    if preceding is None:
        lo = seg0
    else:
        lo = torch.maximum(seg0, _index(run_start) - int(preceding))
    zero = torch.zeros((), dtype=cs.dtype, device=cs.device)
    return cs - torch.where(lo > 0, cs[torch.clamp(lo - 1, min=0)], zero)


def _minmax(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """``jnp.minimum``/``jnp.maximum``.  On floats XLA orders -0.0 before
    +0.0 (IEEE 754-2019 minimum/maximum) and returns a NaN operand as it is,
    where torch's may return either zero and its CPU kernels an all-ones NaN;
    so where both operands are zeros, or one is NaN, take the one XLA
    takes."""
    out = torch.minimum(a, b) if kind == "min" else torch.maximum(a, b)
    if not out.is_floating_point():
        return out
    both0 = (a == 0) & (b == 0)
    neg_a = torch.signbit(a)
    take_a = torch.isnan(a) | (both0 & (neg_a if kind == "min" else ~neg_a))
    return torch.where(take_a, a, torch.where(torch.isnan(b) | both0, b, out))


def _seg_scan(v: torch.Tensor, run_start: torch.Tensor, kind: str) -> torch.Tensor:
    """Segmented inclusive min/max scan, log-step doubling: after the step of
    width ``d`` row i holds the op over ``[max(seg0[i], i - 2d + 1), i]``.
    Min and max are exact in any order, so this equals the JAX package's
    associative scan bit for bit -- with one more step: that scan interleaves
    its halves by adding zero padding, which turns every -0.0 of its output
    into +0.0 once there are two rows or more, and so does this one."""
    n = v.shape[0]
    if n < 2:
        return v.clone()
    seg0 = segment_start_indices(run_start)
    idx = _index(run_start)
    out = v
    d = 1
    while d < n:
        prev = torch.cat([out[:d], out[:-d]])  # row i - d (rows < d never take it)
        take = idx - d >= seg0
        out = torch.where(take, _minmax(prev, out, kind), out)
        d *= 2
    if out.is_floating_point():
        out = torch.where(out == 0, torch.zeros((), dtype=out.dtype, device=out.device), out)
    return out


def framed_minmax(v: torch.Tensor, run_start: torch.Tensor, kind: str,
                  preceding: Optional[int] = None) -> torch.Tensor:
    """Running min/max over the ROWS frame ``[i - preceding, i]`` within the
    run.  Unbounded frames use one segmented scan; bounded frames unroll
    ``preceding`` identity-filled shifts (static and small: the plan holds
    the frame)."""
    if preceding is None:
        return _seg_scan(v, run_start, kind)
    if v.is_floating_point():
        ident = float("inf") if kind == "min" else float("-inf")
    else:
        info = torch.iinfo(v.dtype)
        ident = info.max if kind == "min" else info.min
    n = v.shape[0]
    idx = _index(run_start)
    seg0 = segment_start_indices(run_start)
    fill = torch.full((), ident, dtype=v.dtype, device=v.device)
    out = v
    # a shift of >= n rows contributes only identity: cap the unroll so
    # frames wider than the batch stay shape-correct
    for j in range(1, min(int(preceding), max(n - 1, 0)) + 1):
        shifted = torch.cat([fill.expand(j), v[:-j]])
        out = _minmax(out, torch.where(idx - j >= seg0, shifted, fill), kind)
    return out


# ------------------------------------------- host-side range partitioning


def choose_splitters(rank_cols: Sequence[np.ndarray], valid: np.ndarray,
                     nparts: int, sample_cap: int = 4096
                     ) -> List[Tuple[int, ...]]:
    """``nparts - 1`` composite-rank splitters from an even row sample: sort
    the sampled rank tuples lexicographically and take the quantile
    boundaries.  Returned as tuples of python ints (every map shard must
    receive the same splitters).

    Heavy skew yields duplicate splitters (equal keys all land in one
    partition), and an empty sample yields all-zero splitters (every row
    ranks after them: partition ``nparts - 1`` takes the lot)."""
    valid = np.asarray(valid, bool)
    sel = np.flatnonzero(valid)
    if sel.size > sample_cap:
        sel = sel[np.linspace(0, sel.size - 1, sample_cap).astype(np.int64)]
    if sel.size == 0:
        return [tuple(0 for _ in rank_cols) for _ in range(nparts - 1)]
    sample = [np.asarray(r)[sel] for r in rank_cols]
    order = np.lexsort(tuple(reversed(sample)))
    n = sel.size
    out = []
    for p in range(1, nparts):
        at = order[min(n - 1, n * p // nparts)]
        out.append(tuple(int(r[at]) for r in sample))
    return out


def range_partition(rank_cols: Sequence[np.ndarray],
                    splitters: Sequence[Tuple[int, ...]]) -> np.ndarray:
    """Partition index per row: how many splitters order strictly before the
    row's composite rank (rows equal to splitter ``p`` stay in partition
    ``p``).  Concatenating partitions in index order yields globally sorted
    rows."""
    n = len(np.asarray(rank_cols[0]))
    part = np.zeros(n, np.int64)
    for s in splitters:
        gt = np.zeros(n, bool)
        eq = np.ones(n, bool)
        for rc, sv in zip(rank_cols, s):
            rc = np.asarray(rc)
            sv = np.uint64(sv)
            gt |= eq & (rc > sv)
            eq &= rc == sv
        part += gt
    return part
