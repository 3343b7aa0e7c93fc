"""Spark ``percentile`` aggregation over pre-binned data (PyTorch port of
``ops/histogram.py``).

Spark-exact semantics of the reference's histogram ops
(histogram.cu:283 create_histogram_if_valid, histogram.cu:431
percentile_from_histogram; interpolation kernel fill_percentile_fn
histogram.cu:50-105).

The reference sorts each LIST segment with a segmented sort, scans counts by
key, then runs one thread per (histogram, percentage) doing a sequential
``lower_bound`` over that histogram's accumulated counts.  Here the ragged
segments are gathered into a dense padded ``[num_histograms, max_len]`` tile
(padding = int64 max) so that every search is a compare-and-sum over lanes.

Exactness split, as in the JAX package: sorting (three stable sorts), the
int64 count scan, the per-percentile searches and the element gathers run on
the column's device over exact integer keys (FLOAT64 columns are IEEE-754
bits in int64; sorting uses the sign-flip total order on the bits).  The
final O(H x P) interpolation is finished on the host in numpy binary64 with
the JAX package's operations, so the output bits agree.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch.columnar.column import Column, ListColumn, StructColumn
from spark_rapids_jni_tpu_torch.columnar.dtypes import FLOAT64, Kind
from spark_rapids_jni_tpu_torch.utils.floatbits import f32_to_bits
from spark_rapids_jni_tpu_torch.utils.u64 import SIGN

_I64_MAX = (1 << 63) - 1
# elements of one [H, P, L] compare block of the lower_bound
_SEARCH_BLOCK = 1 << 28


def create_histogram_if_valid(values: Column, frequencies: Column, output_as_lists: bool):
    """Validate (values, frequencies) and build a histogram column.

    Mirrors histogram.cu:283-425: frequencies must be INT64, non-null and
    non-negative.  ``output_as_lists=False`` returns STRUCT<value,freq> with
    zero-frequency rows nullified (their freq forced to 1, histogram.cu:365-378);
    ``True`` wraps each row in its own list, with zero-frequency rows becoming
    empty lists.
    """
    if frequencies.dtype.kind != Kind.INT64:
        raise TypeError("The input frequencies must be of type INT64.")
    if frequencies.validity is not None and frequencies.null_count() > 0:
        raise ValueError("The input frequencies must not have nulls.")
    if values.size != frequencies.size:
        raise ValueError("The input values and frequencies must have the same size.")

    # validation decisions are scalar syncs; the frequency bytes stay on the device
    freq = frequencies.data
    negative, has_zero = (torch.stack([(freq < 0).any(), (freq == 0).any()]).tolist()
                          if freq.numel() else (False, False))
    if negative:
        raise ValueError("The input frequencies must not contain negative values.")
    n = values.size
    dev = freq.device

    if output_as_lists:
        # Each row becomes a 1-element list; zero-frequency rows become empty.
        if not has_zero:
            offsets = torch.arange(n + 1, dtype=torch.int32, device=dev)
            return ListColumn(offsets, StructColumn((values, frequencies), None), None)
        keep = freq > 0
        offsets = torch.zeros((n + 1,), dtype=torch.int32, device=dev)
        offsets[1:] = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32)
        gather = torch.nonzero(keep).flatten()  # kept rows in row order
        kept_vals = Column(values.data[gather],
                           None if values.validity is None else values.validity[gather],
                           values.dtype)
        kept_freq = Column(freq[gather], None, frequencies.dtype)
        return ListColumn(offsets, StructColumn((kept_vals, kept_freq), None), None)

    if not has_zero:
        # Reference quirk preserved: when no zero frequencies exist, null-value
        # rows keep their original frequency (the freq->1 fixup below only
        # runs on the zero-frequency path; histogram.cu:399-401 vs :365-378).
        return StructColumn((values, frequencies), None)
    # Nullify zero-frequency values (AND with any existing mask) and force
    # the frequency of EVERY null row (including originally-null values) to 1
    # so downstream MERGE_HISTOGRAM never sees freq 0.
    pos = freq > 0
    validity = pos if values.validity is None else (values.validity & pos)
    fixed_freq = torch.where(validity, freq, 1)
    out_vals = Column(values.data, validity, values.dtype)
    return StructColumn((out_vals, Column(fixed_freq, None, frequencies.dtype)), None)


def _total_order_key(col: Column) -> torch.Tensor:
    """int64 key whose < order equals the column's value order.

    FLOAT64 data is already IEEE-754 bits in int64; the standard sign-flip map
    (negatives -> bitwise complement) makes integer compare match float compare.
    """
    kind = col.dtype.kind
    if kind == Kind.FLOAT64:
        bits = col.data.to(torch.int64)
        return torch.where(bits < 0, ~bits, bits | SIGN) ^ SIGN
    if kind == Kind.FLOAT32:
        bits = f32_to_bits(col.data).to(torch.int64)
        return torch.where(bits < 0, (~bits) & 0xFFFFFFFF, bits | 0x80000000)
    if kind == Kind.UINT64:
        return col.data ^ SIGN  # the u64 bits, held in int64
    return col.data.to(torch.int64)


def _raw_int_repr(col: Column) -> torch.Tensor:
    """int64 carrying the exact value representation (bits for floats)."""
    if col.dtype.kind == Kind.FLOAT32:
        return f32_to_bits(col.data).to(torch.int64)
    return col.data.to(torch.int64)


def _decode_raw(raw: np.ndarray, kind: Kind) -> np.ndarray:
    """Host: raw gathered int64 representations -> float64 values."""
    if kind == Kind.FLOAT64:
        return raw.astype(np.int64).view(np.float64)
    if kind == Kind.FLOAT32:
        return raw.astype(np.int64).astype(np.int32).view(np.float32).astype(np.float64)
    if kind == Kind.UINT64:
        return raw.astype(np.int64).view(np.uint64).astype(np.float64)
    return raw.astype(np.float64)


def _stable_order(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True).indices


def percentile_from_histogram(input: ListColumn, percentages: Sequence[float],
                              output_as_list: bool):
    """Spark percentile over LIST<STRUCT<value, freq INT64>> histograms.

    Returns FLOAT64 percentiles (as bit-pattern int64 per framework
    convention): a flat Column of ``H * P`` rows, or a ListColumn of
    P-element lists per histogram with all-null histograms yielding empty
    lists (histogram.cu:255).
    """
    if not isinstance(input, ListColumn) or not isinstance(input.child, StructColumn):
        raise TypeError("The input column must be of type LIST of STRUCT.")
    struct = input.child
    if len(struct.children) != 2:
        raise TypeError("Child of the input column must have two children.")
    if struct.validity is not None and bool((~struct.validity).any()):
        raise ValueError("Child of the input column must not have nulls.")
    data_col, counts_col = struct.children
    if not isinstance(counts_col, Column) or counts_col.dtype.kind != Kind.INT64:
        raise TypeError("Histogram frequencies must be INT64.")
    if counts_col.validity is not None and counts_col.null_count() > 0:
        raise ValueError("Histogram frequencies must be non-null.")
    arithmetic = isinstance(data_col, Column) and (
        data_col.dtype.is_integral
        or data_col.dtype.is_floating
        or data_col.dtype.kind in (Kind.BOOL, Kind.UINT8, Kind.UINT64)
    )
    if not arithmetic:
        raise TypeError("Unsupported type in histogram-to-percentile evaluation.")

    dev = input.device
    num_hist = input.size
    pcts = np.asarray(list(percentages), dtype=np.float64)
    num_pct = pcts.size

    offsets_np = input.offsets.cpu().numpy().astype(np.int64)
    seg_lens = offsets_np[1:] - offsets_np[:-1]
    max_len = int(seg_lens.max()) if num_hist else 0

    if data_col.size == 0 or num_pct == 0:
        # Reference-faithful: empty data or empty percentages yield
        # num_histograms ALL-NULL rows (flat) / empty lists, NOT 0 rows
        # (percentile_dispatcher early return, histogram.cu:171-180).
        return _wrap_percentile_output(
            np.zeros((num_hist * max(num_pct, 1),), np.int64),
            np.zeros((num_hist,), np.bool_), num_pct, output_as_list, dev)

    # --- device: segmented sort (label asc, value asc, nulls AFTER) ---
    key = _total_order_key(data_col)
    valid = data_col.is_valid()
    seg_lens_t = torch.from_numpy(seg_lens).to(dev)
    labels = torch.repeat_interleave(torch.arange(num_hist, dtype=torch.int64, device=dev),
                                     seg_lens_t)
    order = _stable_order(key)
    order = order[_stable_order((~valid)[order].to(torch.uint8))]
    order = order[_stable_order(labels[order])]

    sorted_raw = _raw_int_repr(data_col)[order]
    sorted_valid = valid[order]
    sorted_counts = counts_col.data[order].to(torch.int64)

    # Per-segment inclusive scan of counts: global cumsum minus segment base.
    csum = torch.cumsum(sorted_counts, 0)
    starts = torch.from_numpy(offsets_np[:-1].copy()).to(dev)
    base = torch.where(starts > 0, csum[torch.clamp(starts - 1, min=0)], 0)
    acc = csum - base[labels]

    # Dense padded [H, L] tiles; pad index n_elem reads the spare slot after
    # the data (acc pads with i64 max so searches stop there).
    n_elem = data_col.size
    lane = torch.arange(max_len, dtype=torch.int64, device=dev)[None, :]
    in_seg = lane < seg_lens_t[:, None]
    pad_idx_t = torch.where(in_seg, starts[:, None] + lane, n_elem)

    def padded(arr, fill):
        safe = torch.cat([arr, torch.full((1,), fill, dtype=arr.dtype, device=dev)])
        return torch.where(in_seg, safe[pad_idx_t], fill)

    acc_pad = padded(acc, _I64_MAX)
    raw_pad = padded(sorted_raw, 0)
    valid_pad = padded(sorted_valid.to(torch.int32), 0)

    # Valid prefix length per histogram (nulls sort last; histogram.cu:57-64).
    n_valid_d = valid_pad.sum(dim=1)
    end_idx = torch.clamp(n_valid_d - 1, min=0)
    max_positions_d = acc_pad.gather(1, end_idx[:, None].to(torch.int64))[:, 0] - 1

    # --- host: exact binary64 position math on [H] / [H,P] scalars ---
    n_valid = n_valid_d.cpu().numpy()
    has_any = n_valid > 0
    if input.validity is not None:
        # Null histogram rows produce null/empty outputs even if their segment
        # is non-empty (cudf purges null rows' segments; guard it here).
        has_any &= input.validity.cpu().numpy()
    max_positions = np.where(has_any, max_positions_d.cpu().numpy(), 0)
    position = max_positions[:, None].astype(np.float64) * pcts[None, :]  # [H,P]
    lower = np.floor(position).astype(np.int64)
    higher = np.ceil(position).astype(np.int64)

    # --- device: lower_bound as an [H, P, L] compare-and-sum, in row blocks ---
    def lower_bound(q_np):
        q = torch.from_numpy(q_np).to(dev)  # [H,P]
        out = torch.empty((num_hist, num_pct), dtype=torch.int64, device=dev)
        step = max(1, _SEARCH_BLOCK // max(1, num_pct * max_len))
        for h0 in range(0, num_hist, step):
            lt = acc_pad[h0:h0 + step, None, :] < q[h0:h0 + step, :, None]
            out[h0:h0 + step] = lt.sum(dim=-1)
        return torch.clamp(out, max=max_len - 1)

    lo_raw = raw_pad.gather(1, lower_bound(lower + 1)).cpu().numpy()
    hi_raw = raw_pad.gather(1, lower_bound(higher + 1)).cpu().numpy()

    # --- host: exact binary64 interpolation (fill_percentile_fn :77-104) ---
    kind = data_col.dtype.kind
    lo_elem = _decode_raw(lo_raw, kind)
    hi_elem = _decode_raw(hi_raw, kind)
    lower_part = (higher.astype(np.float64) - position) * lo_elem
    higher_part = (position - lower.astype(np.float64)) * hi_elem
    interp = np.where((higher == lower) | (hi_raw == lo_raw), lo_elem,
                      lower_part + higher_part)
    out_bits = interp.view(np.int64).reshape(num_hist * num_pct)
    return _wrap_percentile_output(out_bits, has_any, num_pct, output_as_list, dev)


def _wrap_percentile_output(out_bits_np, row_valid_np, num_pct, output_as_list, dev):
    """Package flat [H*P] percentile bits + per-histogram validity (host
    arrays) as columns on ``dev``."""
    num_hist = row_valid_np.shape[0]
    if not output_as_list:
        validity = None
        if num_hist and (~row_valid_np).any():
            rep = np.repeat(row_valid_np, max(num_pct, 1))[:out_bits_np.shape[0]]
            validity = torch.from_numpy(rep).to(dev)
        return Column(torch.from_numpy(np.ascontiguousarray(out_bits_np)).to(dev), validity,
                      FLOAT64)
    # Lists: all-null histograms become empty lists (purge_nonempty_nulls).
    sizes = np.where(row_valid_np, num_pct, 0).astype(np.int32)
    offsets = torch.from_numpy(
        np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)).to(dev)
    keep = np.repeat(row_valid_np, max(num_pct, 1))[:out_bits_np.shape[0]]
    child = Column(torch.from_numpy(np.ascontiguousarray(out_bits_np[keep])).to(dev), None,
                   FLOAT64)
    return ListColumn(offsets, child, None)
