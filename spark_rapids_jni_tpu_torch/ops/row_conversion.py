"""JCUDF row format <-> columns, Spark's row-major interchange format (PyTorch
port of ``ops/row_conversion.py``).

Byte-compatible with the reference's row_conversion.cu: convert_to_rows :1990
/ convert_from_rows :2028 and the fixed-width-optimized legacy pair
:306/:425.

Row layout (RowConversion.java:44-117 doc, compute_column_information
row_conversion.cu:1323-1362):
- columns in order, each aligned to its own byte width (C-struct style);
  a string column occupies an aligned 8-byte (offset:uint32, length:uint32)
  pair pointing at char data appended after the fixed section;
- validity bits follow the last column, byte-aligned, one bit per column,
  LSB-first within each byte, 1 == valid;
- string char data (in column order) follows validity, starting at
  ``size_per_row`` exactly (no alignment, copy_strings_to_rows :837);
- every row is padded to an 8-byte boundary (JCUDF_ROW_ALIGNMENT);
- output is split into batches of at most ``max_batch_bytes`` (2GB in the
  reference), batch boundaries rounded down to 32 rows (build_batches :1505).

The (src, dst) byte permutation between the column byte lanes and the row
layout depends only on the schema, so it is computed once per schema (numpy)
and cached in the process-global plan cache keyed on (schema signature, pow2
row bucket); its device copies are cached per device inside the plan, so a
CPU call and a CUDA call never share a tensor.  Execution is then one
permutation gather over the lane matrix plus the one ragged string pass, on
either arm:

- host arm: numpy byte *views* of the column buffers, permuted in one
  fancy-index op; results go back to the columns' device;
- device arm: torch ops on the columns' device, byte lanes taken with
  ``Tensor.view(torch.uint8)`` (an exact reinterpretation, so FLOAT64's int64
  bits and DECIMAL128's words cross unchanged) and one ``index_select``
  along the cached permutation.

The per-column scatter chain is kept as the parity oracle behind
``rows_plan_cache=False``.  ``rows_device_path="auto"`` picks the arm by the
columns' device: the device arm for CUDA tensors, the host arm for CPU ones.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column,
    Decimal128Column,
    ListColumn,
    StringColumn,
    next_pow2,
    strings_from_padded,
)
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType, Kind, UINT8
from spark_rapids_jni_tpu_torch.obs.phases import PhaseTimes
from spark_rapids_jni_tpu_torch.plans.cache import CompiledPlan, plan_cache

JCUDF_ROW_ALIGNMENT = 8
MAX_BATCH_SIZE = (1 << 31) - 1

# Sub-timings across both directions: plan (permutation lookup/build),
# lanes (byte-lane construction / decode), gather (the fused permutation),
# emit (batch split + ragged string pass).  Host arm: wall-clock host work;
# device arm: dispatch time plus the host syncs of the phase.
PHASES = PhaseTimes("plan", "lanes", "gather", "emit", name="row_conversion")


def _round_up(x: int, align: int) -> int:
    return (x + align - 1) // align * align


def compute_layout(dtypes: Sequence[DType]):
    """(col_starts, col_sizes, validity_offset, size_per_row) per
    compute_column_information (row_conversion.cu:1323-1362)."""
    starts, sizes = [], []
    at = 0
    for dt in dtypes:
        if dt.kind == Kind.STRING:
            size, align = 8, 4  # uint32 offset + uint32 length pair
        else:
            size = dt.fixed_width
            if size == 0:
                raise TypeError(f"Unsupported type in JCUDF row conversion: {dt}")
            align = size
        at = _round_up(at, align)
        starts.append(at)
        sizes.append(size)
        at += size
    validity_offset = at
    size_per_row = at + (len(dtypes) + 7) // 8
    return starts, sizes, validity_offset, size_per_row


def _storage_dtype(dt: DType) -> torch.dtype:
    """The torch dtype a fixed-width column's data holds (FLOAT64: int64 bits)."""
    return torch.int64 if dt.kind == Kind.FLOAT64 else dt.torch_dtype


def _np_dtype(t: torch.dtype) -> np.dtype:
    return torch.empty((0,), dtype=t).numpy().dtype


# ---------------------------------------------------------------------------
# cached byte-permutation plans
# ---------------------------------------------------------------------------


def _rows_device_enabled(dev: torch.device) -> bool:
    v = config.get("rows_device_path")
    if v == "auto":
        return dev.type != "cpu"
    return bool(v)


def _row_plan_sig(dtypes: Sequence[DType]):
    """Layout-determining schema signature: byte width per column, -1 for
    the variable-width (string) pair slot."""
    return tuple(-1 if dt.kind == Kind.STRING else dt.fixed_width for dt in dtypes)


def _build_row_plan(sig) -> dict:
    """Precompute the lane->row byte permutation for one schema.

    The lane matrix is the per-column little-endian value bytes concatenated
    in column order (a string column contributes its 8 pair bytes), followed
    by the validity bytes.  ``perm[j]`` is the lane feeding row byte ``j``;
    ``keep[j]`` is 0 on alignment gaps and row padding (forced to zero, so
    gap bytes match the reference's zero-filled rows bit-exactly).
    """
    starts, sizes = [], []
    at = 0
    for w in sig:
        size, align = (8, 4) if w < 0 else (w, w)
        at = _round_up(at, align)
        starts.append(at)
        sizes.append(size)
        at += size
    validity_offset = at
    nbytes = (len(sig) + 7) // 8
    size_per_row = validity_offset + nbytes
    fixed_row = _round_up(size_per_row, JCUDF_ROW_ALIGNMENT)
    perm = np.zeros((fixed_row,), np.int64)
    keep = np.zeros((fixed_row,), np.uint8)
    lane = 0
    for start, size in zip(starts, sizes):
        perm[start : start + size] = np.arange(lane, lane + size)
        keep[start : start + size] = 1
        lane += size
    perm[validity_offset:size_per_row] = np.arange(lane, lane + nbytes)
    keep[validity_offset:size_per_row] = 1
    lane += nbytes
    return {
        "starts": starts,
        "sizes": sizes,
        "validity_offset": validity_offset,
        "size_per_row": size_per_row,
        "fixed_row": fixed_row,
        "lane_width": lane,
        "perm": perm,
        "keep": keep,
        "dev": {},  # device -> (perm, keep) tensors, filled on first use
    }


def _get_row_plan(dtypes: Sequence[DType], n: int) -> dict:
    sig = _row_plan_sig(dtypes)
    key = (("rows_perm", sig), next_pow2(max(int(n), 1)))

    def build() -> CompiledPlan:
        plan = _build_row_plan(sig)
        return CompiledPlan(fn=plan["perm"], plan=plan, mesh=None, signature=key,
                            out_names=("fixed",), arg_names=("lanes",))

    return plan_cache.get_or_compile(key, build).plan


def _plan_tensors(plan: dict, dev: torch.device):
    """The plan's (perm, keep) as tensors on ``dev``, made once per device."""
    cached: Dict[torch.device, tuple] = plan["dev"]
    pk = cached.get(dev)
    if pk is None:
        pk = cached[dev] = (torch.from_numpy(plan["perm"]).to(dev),
                            torch.from_numpy(plan["keep"]).to(dev))
    return pk


def _gather_fixed(lanes, perm, keep):
    return torch.index_select(lanes, 1, perm) * keep


def _gather_fixed_np(lanes, perm, keep):
    return np.take(lanes, perm, axis=1) * keep


def _np_col_lanes(col) -> np.ndarray:
    """[n, w] little-endian value bytes of a fixed-width column, via numpy
    buffer views (host mirror of :func:`_col_le_bytes`)."""
    n = col.size
    if isinstance(col, Decimal128Column):
        lo = np.ascontiguousarray(col.lo.cpu().numpy())
        hi = np.ascontiguousarray(col.hi.cpu().numpy())
        return np.concatenate(
            [lo.view(np.uint8).reshape(n, 8), hi.view(np.uint8).reshape(n, 8)], axis=1)
    kind = col.dtype.kind
    w = col.dtype.fixed_width
    if kind == Kind.FLOAT32:
        v = np.ascontiguousarray(col.data.cpu().numpy().astype(np.float32))
        return v.view(np.uint8).reshape(n, 4)
    if kind == Kind.BOOL:
        return col.data.cpu().numpy().astype(np.uint8).reshape(n, 1)
    v = col.data.cpu().numpy()
    if v.dtype != np.int64 or not v.flags["C_CONTIGUOUS"]:
        v = np.ascontiguousarray(v.astype(np.int64))
    return v.view(np.uint8).reshape(n, 8)[:, :w]


def _np_bytes_to_col(raw: np.ndarray, dt: DType, validity: torch.Tensor):
    """[n, w] contiguous little-endian bytes -> column on ``validity``'s
    device (host mirror of :func:`_bytes_to_col`)."""
    dev = validity.device
    if dt.kind == Kind.DECIMAL128:
        words = raw.view(np.int64)
        return Decimal128Column(torch.from_numpy(words[:, 1].copy()).to(dev),
                                torch.from_numpy(words[:, 0].copy()).to(dev), validity, dt)
    w = dt.fixed_width
    if dt.kind == Kind.BOOL:
        data = raw[:, 0] != 0
    elif dt.kind == Kind.FLOAT32:
        data = raw.view(np.float32)[:, 0]
    elif dt.kind == Kind.FLOAT64:
        data = raw.view(np.int64)[:, 0]  # bit pattern carried as int64
    else:
        signed = raw.view(np.dtype("<i%d" % w))[:, 0]
        data = signed.astype(_np_dtype(dt.torch_dtype))
    return Column(torch.from_numpy(np.ascontiguousarray(data)).to(dev), validity, dt)


# ---------------------------------------------------------------------------
# device byte codecs (shared by the oracle and the device fast arm)
# ---------------------------------------------------------------------------


def _col_le_bytes(col) -> torch.Tensor:
    """[n, w] little-endian bytes of a column's values, by reinterpreting its
    storage (``Tensor.view(torch.uint8)``)."""
    n = col.size
    if isinstance(col, Decimal128Column):
        words = torch.stack([col.lo, col.hi], dim=1)  # [n, 2] int64, low word first
        return words.view(torch.uint8)
    if col.dtype.kind == Kind.BOOL:
        return col.data.to(torch.uint8).reshape(n, 1)
    v = col.data.to(_storage_dtype(col.dtype)).contiguous()
    return v.view(torch.uint8).reshape(n, col.dtype.fixed_width)


def _bytes_to_col(raw: torch.Tensor, dtype: DType, validity):
    """[n, w] little-endian bytes -> column of ``dtype`` (FLOAT64 as its int64
    bits, never a float cast)."""
    raw = raw.contiguous()
    if dtype.kind == Kind.DECIMAL128:
        words = raw.view(torch.int64)  # [n, 2]
        return Decimal128Column(words[:, 1].contiguous(), words[:, 0].contiguous(), validity,
                                dtype)
    if dtype.kind == Kind.BOOL:
        return Column(raw[:, 0] != 0, validity, dtype)
    return Column(raw.view(_storage_dtype(dtype))[:, 0].contiguous(), validity, dtype)


def _pair_bytes(starts: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[n, 8] bytes of a string column's (offset:uint32, length:uint32) pair."""
    pair = torch.stack([starts, lens], dim=1).to(torch.int32)  # low 32 bits of each
    return pair.view(torch.uint8)


def _validity_bytes(columns) -> torch.Tensor:
    """[n, ceil(ncols/8)] JCUDF validity bytes (bit c%8 of byte c//8, 1=valid)."""
    n = columns[0].size
    out = torch.zeros((n, (len(columns) + 7) // 8), dtype=torch.int32,
                      device=columns[0].device)
    for c, col in enumerate(columns):
        out[:, c // 8] |= col.is_valid().to(torch.int32) << (c % 8)
    return out.to(torch.uint8)


def _batch_boundaries(row_sizes: np.ndarray, max_batch_bytes: int) -> List[int]:
    """Batch ends per build_batches (row_conversion.cu:1458-1545): lower_bound
    on the running total, rounded down to 32 rows except for the final batch."""
    n = len(row_sizes)
    if n and int(row_sizes.max()) > max_batch_bytes:
        raise ValueError("A single row is larger than the maximum batch size")
    bounds = [0]
    cum = np.cumsum(row_sizes, dtype=np.int64)
    last = 0
    while last < n:
        base = cum[last - 1] if last > 0 else 0
        # first absolute index whose cumulative size exceeds the limit, i.e.
        # rows [last, i) fit.  (side='right' keeps an exactly-fitting row in
        # the batch; the reference's lower_bound is degenerate in that
        # never-hit-in-practice equality case.)
        i = int(np.searchsorted(cum, base + max_batch_bytes, side="right"))
        if i >= n:
            end = n
        elif i - last >= 32:
            end = last + (i - last) // 32 * 32
        else:
            # fewer than 32 rows fit: take all of them rather than degrade to
            # 1-row batches (the reference would round down to 0 and hang)
            end = max(i, last + 1)
        bounds.append(end)
        last = end
    return bounds


def _row_batch(offsets_np: np.ndarray, flat: torch.Tensor) -> ListColumn:
    offsets = torch.from_numpy(offsets_np).to(flat.device)
    return ListColumn(offsets, Column(flat, None, UINT8), None)


# ---------------------------------------------------------------------------
# host fast arm
# ---------------------------------------------------------------------------


def _ragged_char_indices(base: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Flat char positions for per-row runs starting at ``base`` with the
    given lengths: repeat each base over its run and add a per-run ramp."""
    total = int(lens.sum())
    out = np.repeat(base, lens)
    out += np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
    return out


def _convert_to_rows_host(columns: Sequence, max_batch_bytes: int) -> List[ListColumn]:
    n = columns[0].size
    dev = columns[0].device
    dtypes = [c.dtype for c in columns]
    with PHASES.phase("plan"):
        plan = _get_row_plan(dtypes, n)
    size_per_row = plan["size_per_row"]
    fixed_row = plan["fixed_row"]
    string_cols = [c for c in columns if c.dtype.kind == Kind.STRING]

    with PHASES.phase("lanes"):
        lanes_list: List[np.ndarray] = []
        str_lens: List[np.ndarray] = []
        str_starts: List[np.ndarray] = []
        within = np.full((n,), size_per_row, dtype=np.int64) if string_cols else None
        for col in columns:
            if col.dtype.kind == Kind.STRING:
                lens = col.lengths().cpu().numpy().astype(np.int64)
                str_lens.append(lens)
                str_starts.append(within)
                pair = np.empty((n, 2), np.uint32)
                pair[:, 0] = within
                pair[:, 1] = lens
                lanes_list.append(pair.view(np.uint8))
                within = within + lens
            else:
                lanes_list.append(_np_col_lanes(col))
        vbytes = np.zeros((n, (len(columns) + 7) // 8), np.uint8)
        for c, col in enumerate(columns):
            valid = col.is_valid().cpu().numpy().astype(np.uint8)
            vbytes[:, c // 8] |= valid << np.uint8(c % 8)
        lanes = np.concatenate(lanes_list + [vbytes], axis=1)

    with PHASES.phase("gather"):
        fixed = _gather_fixed_np(lanes, plan["perm"], plan["keep"])

    with PHASES.phase("emit"):
        if string_cols:
            a = JCUDF_ROW_ALIGNMENT
            row_sizes = (size_per_row + sum(str_lens) + (a - 1)) // a * a
        else:
            row_sizes = np.full((n,), fixed_row, dtype=np.int64)
        bounds = _batch_boundaries(row_sizes, max_batch_bytes)
        cum_sizes = np.concatenate([[0], np.cumsum(row_sizes)])
        chars_np = [c.chars.cpu().numpy() for c in string_cols]
        soffs_np = [c.offsets.cpu().numpy() for c in string_cols]
        out: List[ListColumn] = []
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            offsets_np = (cum_sizes[b0 : b1 + 1] - cum_sizes[b0]).astype(np.int32)
            total = int(offsets_np[-1])
            if not string_cols:
                # uniform fixed_row rows: the permuted matrix IS the batch
                flat = np.ascontiguousarray(fixed[b0:b1]).reshape(-1)
            else:
                row_off = offsets_np[:-1].astype(np.int64)
                flat = np.zeros((total,), np.uint8)
                pos = row_off[:, None] + np.arange(size_per_row, dtype=np.int64)
                flat[pos] = fixed[b0:b1, :size_per_row]
                for lens, sstart, chars, soffs in zip(str_lens, str_starts, chars_np,
                                                      soffs_np):
                    lsub = lens[b0:b1]
                    tot = int(lsub.sum())
                    if not tot:
                        continue
                    idx = _ragged_char_indices(row_off + sstart[b0:b1], lsub)
                    c0 = int(soffs[b0])
                    flat[idx] = chars[c0 : c0 + tot]
            out.append(_row_batch(offsets_np, torch.from_numpy(flat).to(dev)))
        return out


def _convert_from_rows_host(rows: ListColumn, dtypes: Sequence[DType]) -> List:
    n = rows.size
    dev = rows.device
    with PHASES.phase("plan"):
        plan = _get_row_plan(dtypes, n)
    starts, sizes = plan["starts"], plan["sizes"]
    validity_offset = plan["validity_offset"]
    size_per_row = plan["size_per_row"]
    fixed_row = plan["fixed_row"]
    flat = rows.child.data.cpu().numpy()
    offs = rows.offsets.cpu().numpy().astype(np.int64)
    row_off = offs[:-1]

    with PHASES.phase("gather"):
        if flat.size == n * fixed_row and bool(
            (offs == np.arange(n + 1, dtype=np.int64) * fixed_row).all()
        ):
            # uniform rows (fixed-width-only batch): a reshape view, no copy
            fixed = flat.reshape(n, fixed_row)
        else:
            pos = row_off[:, None] + np.arange(size_per_row, dtype=np.int64)
            fixed = flat[np.minimum(pos, max(flat.size - 1, 0))]

    out: List = []
    with PHASES.phase("lanes"):
        for c, (dt, start, size) in enumerate(zip(dtypes, starts, sizes)):
            vb = fixed[:, validity_offset + c // 8]
            validity = torch.from_numpy(((vb >> np.uint8(c % 8)) & np.uint8(1)) == 1).to(dev)
            if dt.kind == Kind.STRING:
                pr = np.ascontiguousarray(fixed[:, start : start + 8]).view(np.uint32)
                soff = pr[:, 0].astype(np.int64)
                slen = pr[:, 1].astype(np.int64)
                tot = int(slen.sum())
                if tot:
                    idx = _ragged_char_indices(row_off + soff, slen)
                    chars = flat[np.minimum(idx, flat.size - 1)]
                else:
                    chars = np.zeros((0,), np.uint8)
                soffsets = np.zeros((n + 1,), np.int32)
                soffsets[1:] = np.cumsum(slen)
                out.append(StringColumn(torch.from_numpy(chars).to(dev),
                                        torch.from_numpy(soffsets).to(dev), validity))
            else:
                raw = np.ascontiguousarray(fixed[:, start : start + size])
                out.append(_np_bytes_to_col(raw, dt, validity))
    return out


# ---------------------------------------------------------------------------
# device arm (cached single-gather fast path + the scatter-chain oracle)
# ---------------------------------------------------------------------------


def convert_to_rows(columns: Sequence, max_batch_bytes: int = MAX_BATCH_SIZE
                    ) -> List[ListColumn]:
    """Table -> list of LIST<UINT8> batches in JCUDF row format, on the
    columns' device."""
    if not columns:
        raise ValueError("The input table must have at least one column.")
    if bool(config.get("rows_plan_cache")) and not _rows_device_enabled(columns[0].device):
        return _convert_to_rows_host(columns, max_batch_bytes)
    return _convert_to_rows_device(columns, max_batch_bytes)


def _convert_to_rows_device(columns: Sequence, max_batch_bytes: int) -> List[ListColumn]:
    n = columns[0].size
    dev = columns[0].device
    dtypes = [c.dtype for c in columns]
    starts, sizes, validity_offset, size_per_row = compute_layout(dtypes)
    string_cols = [c for c in columns if c.dtype.kind == Kind.STRING]
    fixed_row = _round_up(size_per_row, JCUDF_ROW_ALIGNMENT)
    str_lens = [c.lengths().to(torch.int64) for c in string_cols]
    # exclusive running char offset per string column: spr + the lengths of
    # the preceding string columns
    str_starts = []
    within = torch.full((n,), size_per_row, dtype=torch.int64, device=dev)
    for lens in str_lens:
        str_starts.append(within)
        within = within + lens
    if string_cols:
        a = JCUDF_ROW_ALIGNMENT
        row_sizes = ((within + (a - 1)) // a * a).cpu().numpy()
    else:
        row_sizes = np.full((n,), fixed_row, dtype=np.int64)

    # ---- fixed-width section as a dense [n, fixed_row] matrix ----
    if bool(config.get("rows_plan_cache")):
        # one fused permutation gather over the lane matrix
        with PHASES.phase("plan"):
            plan = _get_row_plan(dtypes, n)
            perm, keep = _plan_tensors(plan, dev)
        with PHASES.phase("lanes"):
            lanes_list = []
            si = 0
            for col in columns:
                if col.dtype.kind == Kind.STRING:
                    lanes_list.append(_pair_bytes(str_starts[si], str_lens[si]))
                    si += 1
                else:
                    lanes_list.append(_col_le_bytes(col))
            lanes = torch.cat(lanes_list + [_validity_bytes(columns)], dim=1)
        with PHASES.phase("gather"):
            fixed = _gather_fixed(lanes, perm, keep)
    else:
        # oracle: per-column scatter chain
        fixed = torch.zeros((n, fixed_row), dtype=torch.uint8, device=dev)
        si = 0
        for col, start, size in zip(columns, starts, sizes):
            if col.dtype.kind == Kind.STRING:
                fixed[:, start : start + 8] = _pair_bytes(str_starts[si], str_lens[si])
                si += 1
            else:
                fixed[:, start : start + size] = _col_le_bytes(col)
        fixed[:, validity_offset:size_per_row] = _validity_bytes(columns)

    # ---- emit batches ----
    with PHASES.phase("emit"):
        bounds = _batch_boundaries(row_sizes, max_batch_bytes)
        cum_sizes = np.concatenate([[0], np.cumsum(row_sizes)])
        str_lens_np = [lens.cpu().numpy() for lens in str_lens]
        out: List[ListColumn] = []
        for b0, b1 in zip(bounds[:-1], bounds[1:]):
            offsets_np = (cum_sizes[b0 : b1 + 1] - cum_sizes[b0]).astype(np.int32)
            total = int(offsets_np[-1])
            if not string_cols:
                # uniform fixed_row rows, padding zeroed: the matrix IS the batch
                out.append(_row_batch(offsets_np, fixed[b0:b1].reshape(-1)))
                continue
            row_off = torch.from_numpy(offsets_np[:-1].astype(np.int64)).to(dev)
            # one spare byte at ``total`` takes the positions that must drop
            flat = torch.zeros((total + 1,), dtype=torch.uint8, device=dev)
            pos = row_off[:, None] + torch.arange(size_per_row, dtype=torch.int64,
                                                  device=dev)[None, :]
            flat[pos] = fixed[b0:b1, :size_per_row]
            # scatter string chars (column order); pad per batch so one long
            # string elsewhere in the table doesn't inflate this batch's tile
            for scol, lens_np, lens, sstart in zip(string_cols, str_lens_np, str_lens,
                                                   str_starts):
                if not scol.chars.numel():
                    continue
                batch_max = max(int(lens_np[b0:b1].max()) if b1 > b0 else 0, 1)
                lane = torch.arange(batch_max, dtype=torch.int64, device=dev)[None, :]
                src = torch.clamp(scol.offsets[b0:b1, None].to(torch.int64) + lane,
                                  max=scol.chars.numel() - 1)
                cpos = row_off[:, None] + sstart[b0:b1, None] + lane
                cpos = torch.where(lane < lens[b0:b1, None], cpos, total)
                flat[cpos] = scol.chars[src]
            out.append(_row_batch(offsets_np, flat[:total]))
    return out


def convert_to_rows_fixed_width_optimized(columns: Sequence) -> List[ListColumn]:
    """Legacy fixed-width path: <100 columns, row size <= 1KB
    (RowConversion.java:118-121; row_conversion.cu:306)."""
    if len(columns) >= 100:
        raise ValueError("Too many columns for the fixed-width optimized path")
    for c in columns:
        if c.dtype.kind == Kind.STRING:
            raise TypeError("Only fixed width types are supported")
    _, _, _, size_per_row = compute_layout([c.dtype for c in columns])
    if _round_up(size_per_row, JCUDF_ROW_ALIGNMENT) > 1024:
        raise ValueError("Row size is too large")
    return convert_to_rows(columns)


def convert_from_rows(rows: ListColumn, dtypes: Sequence[DType]) -> List:
    """LIST<UINT8> batch in JCUDF format -> columns of ``dtypes`` on the rows'
    device."""
    if bool(config.get("rows_plan_cache")) and not _rows_device_enabled(rows.device):
        return _convert_from_rows_host(rows, dtypes)
    return _convert_from_rows_device(rows, dtypes)


def _convert_from_rows_device(rows: ListColumn, dtypes: Sequence[DType]) -> List:
    starts, sizes, validity_offset, size_per_row = compute_layout(dtypes)
    n = rows.size
    dev = rows.device
    flat = rows.child.data
    last = max(flat.shape[0] - 1, 0)
    row_off = rows.offsets.to(torch.int64)[:-1]
    fixed_row = _round_up(size_per_row, JCUDF_ROW_ALIGNMENT)

    # plan-cached: gather the whole fixed section once (a reshape when every
    # row is fixed_row bytes), then decode columns from contiguous slices of
    # it.  Oracle: one clipped gather per column straight from the flat buffer.
    fixed = None
    if bool(config.get("rows_plan_cache")):
        with PHASES.phase("plan"):
            _get_row_plan(dtypes, n)  # warm/validate the cached layout
        with PHASES.phase("gather"):
            uniform = flat.shape[0] == n * fixed_row and bool(torch.equal(
                rows.offsets.to(torch.int64),
                torch.arange(n + 1, dtype=torch.int64, device=dev) * fixed_row))
            if uniform:
                fixed = flat.view(n, fixed_row)
            else:
                pos = row_off[:, None] + torch.arange(size_per_row, dtype=torch.int64,
                                                      device=dev)[None, :]
                fixed = flat[torch.clamp(pos, 0, last)]

    def raw_bytes(start: int, size: int) -> torch.Tensor:
        if fixed is not None:
            return fixed[:, start : start + size]
        pos = row_off[:, None] + start + torch.arange(size, dtype=torch.int64,
                                                      device=dev)[None, :]
        return flat[torch.clamp(pos, 0, last)]

    vbytes = raw_bytes(validity_offset, (len(dtypes) + 7) // 8)
    out = []
    with PHASES.phase("lanes"):
        for c, (dt, start, size) in enumerate(zip(dtypes, starts, sizes)):
            # keep the validity tensor unconditionally: normalizing all-valid
            # to None would cost a host sync per column
            vb = vbytes[:, c // 8].to(torch.int32)
            validity: Optional[torch.Tensor] = ((vb >> (c % 8)) & 1) == 1
            if dt.kind != Kind.STRING:
                out.append(_bytes_to_col(raw_bytes(start, size), dt, validity))
                continue
            pair = raw_bytes(start, 8).contiguous().view(torch.int32).to(torch.int64)
            soff = pair[:, 0] & 0xFFFFFFFF
            slen = pair[:, 1] & 0xFFFFFFFF
            max_len = max(int(slen.max()) if n else 0, 1)
            lane = torch.arange(max_len, dtype=torch.int64, device=dev)[None, :]
            cpos = torch.clamp(row_off[:, None] + soff[:, None] + lane, 0, last)
            padded = torch.where(lane < slen[:, None], flat[cpos], 0)
            out.append(strings_from_padded(padded, slen, validity))
    return out


def convert_from_rows_fixed_width_optimized(rows: ListColumn, dtypes: Sequence[DType]
                                            ) -> List:
    """Legacy fixed-width read path (row_conversion.cu:306)."""
    for dt in dtypes:
        if dt.kind == Kind.STRING:
            raise TypeError("Only fixed width types are supported")
    return convert_from_rows(rows, dtypes)
