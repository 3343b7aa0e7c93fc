"""External (disk-backed) shuffle of FULL columnar tables in JCUDF rows
(PyTorch port of ``io/spill.py``).

The reference rides Spark's fully-general external shuffle for every
out-of-core exchange; its own contribution is the serialized row format
those shuffle files carry (row_conversion.cu:574 ``copy_to_rows`` -- the
JCUDF row layout, RowConversion.java:44-117).  This module is a grace-hash
disk partitioner whose spill files hold JCUDF row batches, so ANY table the
columnar model can express -- validity, strings, decimal128 -- spills and
re-loads without a schema-specific format.

Three pieces, all host numpy over port columns:

- a HOST JCUDF codec (:func:`encode_jcudf_rows` / :func:`decode_jcudf_rows`)
  byte-identical to ``ops.row_conversion.convert_to_rows`` and to the JAX
  package's codec.  A column on the card comes to the host with an explicit
  ``.cpu()``; decoded columns go to the device the caller asks for.
  Fixed-width schemas (every row the same size) move whole rows as a
  ``[n, row_size]`` view; the bytes are the same as the general path's.
- key hashing (:func:`pair_mix64`, :func:`chained_key_hash`): a stable,
  well-mixed 64-bit hash of the key columns; bucket-space refinement relies
  only on ``hash % M == b  =>  hash % 2M in {b, b+M}``.
- :class:`ExternalTableShuffle`: append chunks, read buckets back as
  columns, and recursively split an over-budget bucket ON DISK by moving
  raw row bytes (rows are self-delimiting given their sizes; only the key
  columns are ever decoded during a split).

Byte accounting is from ACTUAL spill-file sizes (``bucket_nbytes``), not a
rows*width estimate -- the number the host-memory governor reserves before a
bucket is materialized.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar.column import (
    Column,
    Decimal128Column,
    StringColumn,
)
from spark_rapids_jni_tpu_torch.columnar.dtypes import DType, Kind
from spark_rapids_jni_tpu_torch.obs.phases import PhaseTimes
from spark_rapids_jni_tpu_torch.ops.row_conversion import (
    JCUDF_ROW_ALIGNMENT,
    compute_layout,
)

__all__ = [
    "encode_jcudf_rows",
    "decode_jcudf_rows",
    "splitmix64",
    "pair_mix64",
    "chained_key_hash",
    "ExternalTableShuffle",
]

#: host seconds of the shuffle's own work: routing and encoding each chunk,
#: writing its bucket files (``append``), and what a caller times as reading
#: and decoding a bucket back
PHASES = PhaseTimes("route_encode", "write", "read_decode", name="spill")


# ------------------------------------------------------------- host codec --


def _host(t: Optional[torch.Tensor]) -> Optional[np.ndarray]:
    """A column buffer as a host numpy array (an explicit copy off the card)."""
    return None if t is None else t.cpu().numpy()


def _nrows(col) -> int:
    if isinstance(col, StringColumn):
        return int(col.offsets.shape[0] - 1)
    if isinstance(col, Decimal128Column):
        return int(col.hi.shape[0])
    return int(col.data.shape[0])


def _round_up(x, align: int):
    return (x + align - 1) // align * align


def _ragged_arange(lens: np.ndarray, total: Optional[int] = None) -> np.ndarray:
    """[0..lens[0]), [0..lens[1]), ... concatenated (int64)."""
    if total is None:
        total = int(lens.sum())
    ends = np.cumsum(lens)
    return np.arange(total, dtype=np.int64) - np.repeat(ends - lens, lens)


def _np_le(dt: DType) -> np.dtype:
    """Little-endian numpy dtype of a fixed-width column's DATA buffer.

    FLOAT64 data is the IEEE-754 bit pattern in int64 (columnar convention)
    and UINT64 its bits in int64; BOOL is stored as one 0/1 byte."""
    if dt.kind in (Kind.FLOAT64, Kind.UINT64):
        return np.dtype("<i8")
    if dt.kind == Kind.BOOL:
        return np.dtype(np.uint8)
    return torch.empty((0,), dtype=dt.torch_dtype).numpy().dtype.newbyteorder("<")


def _fixed_le_bytes(col) -> np.ndarray:
    """[n, w] little-endian value bytes of a fixed-width column."""
    if col.dtype.kind == Kind.DECIMAL128:
        lo = _host(col.lo).astype("<i8").view(np.uint8).reshape(-1, 8)
        hi = _host(col.hi).astype("<i8").view(np.uint8).reshape(-1, 8)
        return np.concatenate([lo, hi], axis=1)
    data = _host(col.data)
    if col.dtype.kind == Kind.BOOL:
        return data.astype(np.uint8).reshape(-1, 1)
    w = col.dtype.fixed_width
    return np.ascontiguousarray(data.astype(_np_le(col.dtype))) \
        .view(np.uint8).reshape(-1, w)


def _validity_bytes(columns, n: int) -> np.ndarray:
    """[n, ceil(ncols/8)] JCUDF validity bytes (bit c%8 of byte c//8)."""
    nbytes = (len(columns) + 7) // 8
    out = np.zeros((n, nbytes), np.uint8)
    for c, col in enumerate(columns):
        if col.validity is None:
            out[:, c // 8] |= np.uint8(1 << (c % 8))
        else:
            out[:, c // 8] |= (_host(col.validity).astype(np.uint8) << (c % 8))
    return out


def encode_jcudf_rows(columns: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Port columns (on any device) -> ``(flat_bytes uint8[total], row_sizes
    int64[n])`` on the host.

    Byte-identical to the rows the device path emits (a single
    ``ops.row_conversion.convert_to_rows`` batch): column values aligned to
    their widths, string (offset,length) pairs + char tails, validity bytes,
    rows padded to 8.  Rows are independent of batching, so concatenating
    encoded chunks yields one valid row stream -- the append-only spill-file
    property this codec exists for.
    """
    n = _nrows(columns[0])
    dtypes = [c.dtype for c in columns]
    starts, sizes, validity_offset, size_per_row = compute_layout(dtypes)
    has_strings = any(d.kind == Kind.STRING for d in dtypes)
    row_size = _round_up(size_per_row, JCUDF_ROW_ALIGNMENT)

    # fixed-width rows are built in place as [n, row_size] (their padding zero)
    fixed = np.zeros((n, size_per_row if has_strings else row_size), np.uint8)
    within = np.full(n, size_per_row, np.int64)
    str_plan: List[tuple] = []
    for col, start, size in zip(columns, starts, sizes):
        if col.dtype.kind == Kind.STRING:
            offs = _host(col.offsets).astype(np.int64)
            lens = offs[1:] - offs[:-1]
            pair = np.empty((n, 2), "<u4")
            pair[:, 0] = within
            pair[:, 1] = lens
            fixed[:, start:start + 8] = pair.view(np.uint8).reshape(n, 8)
            str_plan.append((_host(col.chars), within.copy(), offs, lens))
            within = within + lens
        else:
            fixed[:, start:start + size] = _fixed_le_bytes(col)
    fixed[:, validity_offset:size_per_row] = _validity_bytes(columns, n)
    if not has_strings:
        return fixed.reshape(-1), np.full(n, row_size, np.int64)

    row_sizes = _round_up(within, JCUDF_ROW_ALIGNMENT)
    total = int(row_sizes.sum())
    out = np.zeros(total, np.uint8)
    row_off = np.cumsum(row_sizes, dtype=np.int64) - row_sizes
    out[row_off[:, None] + np.arange(size_per_row, dtype=np.int64)] = fixed
    for chars, sstarts, offs, lens in str_plan:
        nchars = int(lens.sum())
        if nchars == 0:
            continue
        ragged = _ragged_arange(lens, nchars)
        src = chars[np.repeat(offs[:-1], lens) + ragged]
        out[np.repeat(row_off + sstarts, lens) + ragged] = src
    return out, row_sizes


def _fixed_row_view(buf: np.ndarray, row_offsets: np.ndarray, row_size: int):
    """``buf`` as ``[n, row_size]`` when its rows are exactly that size from
    byte 0 (a fixed-width schema's row stream), else None."""
    n = len(row_offsets) - 1
    if len(buf) < n * row_size or not np.array_equal(
            row_offsets, np.arange(n + 1, dtype=np.int64) * row_size):
        return None
    return buf[:n * row_size].reshape(n, row_size)


def _decode_host(buf: np.ndarray, row_offsets: np.ndarray, dtypes: Sequence[DType],
                 select: Optional[Sequence[int]] = None) -> List:
    """JCUDF row bytes -> per column ``(kind, arrays..., validity)`` host
    tuples (None for columns not in ``select``)."""
    starts, sizes, validity_offset, size_per_row = compute_layout(dtypes)
    row_offsets = np.asarray(row_offsets, np.int64)
    n = len(row_offsets) - 1
    rows = None
    if not any(d.kind == Kind.STRING for d in dtypes):
        rows = _fixed_row_view(buf, row_offsets,
                               _round_up(size_per_row, JCUDF_ROW_ALIGNMENT))
    row_off = row_offsets[:-1]

    def field(start: int, size: int) -> np.ndarray:
        if rows is not None:
            return np.ascontiguousarray(rows[:, start:start + size])
        return np.ascontiguousarray(
            buf[row_off[:, None] + start + np.arange(size, dtype=np.int64)])

    nb = (len(dtypes) + 7) // 8
    vbytes = field(validity_offset, nb)
    sel = set(range(len(dtypes))) if select is None else set(select)
    out: List = []
    for c, (dt, start, size) in enumerate(zip(dtypes, starts, sizes)):
        if c not in sel:
            out.append(None)
            continue
        valid = ((vbytes[:, c // 8] >> np.uint8(c % 8)) & 1).astype(bool)
        validity = None if bool(valid.all()) else valid
        if dt.kind == Kind.STRING:
            pair = field(start, 8).view("<u4").reshape(n, 2)
            soff = pair[:, 0].astype(np.int64)
            slen = pair[:, 1].astype(np.int64)
            nchars = int(slen.sum())
            ragged = _ragged_arange(slen, nchars)
            chars = buf[np.repeat(row_off + soff, slen) + ragged]
            offsets = np.zeros(n + 1, np.int32)
            offsets[1:] = np.cumsum(slen).astype(np.int32)
            out.append(("string", chars, offsets, validity))
        elif dt.kind == Kind.DECIMAL128:
            raw = field(start, 16)
            lo = raw[:, :8].copy().view("<i8").ravel()
            hi = raw[:, 8:].copy().view("<i8").ravel()
            out.append(("decimal128", hi, lo, validity))
        else:
            data = field(start, size).view(_np_le(dt)).ravel()
            if dt.kind == Kind.BOOL:
                data = data != 0
            out.append(("fixed", data, validity))
    return out


def _to_column(host, dt: DType, dev: torch.device):
    """One ``_decode_host`` tuple as a port column on ``dev``."""
    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if host[0] == "string":
        _, chars, offsets, validity = host
        return StringColumn(t(chars), t(offsets), t(validity), dt)
    if host[0] == "decimal128":
        _, hi, lo, validity = host
        return Decimal128Column(t(hi), t(lo), t(validity), dt)
    _, data, validity = host
    return Column(t(data), t(validity), dt)


def decode_jcudf_rows(
    buf: np.ndarray,
    row_offsets: np.ndarray,
    dtypes: Sequence[DType],
    select: Optional[Sequence[int]] = None,
    device: _device.DeviceLike = None,
) -> List:
    """JCUDF row bytes -> port columns on ``device`` (the card unless the
    caller asks for the CPU).

    ``row_offsets`` is int64[n+1] (exclusive scan of row sizes).  With
    ``select``, only those column indices are decoded (others come back as
    ``None``) -- how a disk split reads just the key columns of a bucket.
    """
    dev = _device.resolve(device)
    return [None if h is None else _to_column(h, dt, dev)
            for h, dt in zip(_decode_host(buf, row_offsets, dtypes, select), dtypes)]


# ------------------------------------------------------------ key hashing --

_GOLDEN = np.uint64(0x9E3779B97F4A7C15)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer over a uint64 vector (well-mixed, stable)."""
    with np.errstate(over="ignore"):
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def pair_mix64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Mixed hash of an (int32, int32) key pair of host arrays: splitmix64
    over the packed pair.  TPC-DS surrogate keys are dense; packing then
    finalizing spreads them (models.streaming.bucket_of_pairs is this mod
    n_buckets)."""
    k = ((a.astype(np.int64).astype(np.uint64) << np.uint64(32))
         | (b.astype(np.int64).astype(np.uint64) & np.uint64(0xFFFFFFFF)))
    return splitmix64(k)


def _key_limbs(col) -> List[np.ndarray]:
    """uint64 limb(s) of a fixed-width key column, nulls normalized to a
    flag limb (null data bytes are garbage by contract and must not steer
    routing)."""
    if isinstance(col, StringColumn):
        raise TypeError("string key columns are not supported for the "
                        "external shuffle hash (fixed-width keys only)")
    if isinstance(col, Decimal128Column):
        limbs = [_host(col.lo).view(np.uint64),
                 _host(col.hi).astype(np.int64).astype(np.uint64)]
    else:
        data = _host(col.data)
        if col.dtype.kind == Kind.BOOL:
            data = data.astype(np.uint8)
        limbs = [data.astype(np.int64).astype(np.uint64)]
    # The null-flag limb is UNCONDITIONAL: a chunk appended with an
    # all-valid mask and the same rows decoded later with validity=None
    # must hash identically, or disk splits would re-route rows.
    if col.validity is None:
        limbs.append(np.zeros(len(limbs[0]), np.uint64))
    else:
        valid = _host(col.validity)
        limbs = [np.where(valid, limb, np.uint64(0)) for limb in limbs]
        limbs.append(np.where(valid, np.uint64(0), _GOLDEN))
    return limbs


def chained_key_hash(cols: Sequence) -> np.ndarray:
    """General N-column key hash: fold every column's 64-bit limbs through
    splitmix64.  Any fixed mix works -- both sides of a join must agree,
    nothing else -- but it must spread dense keys (see pair_mix64)."""
    n = _nrows(cols[0])
    h = np.zeros(n, np.uint64)
    with np.errstate(over="ignore"):
        for i, col in enumerate(cols):
            for limb in _key_limbs(col):
                h = splitmix64(h ^ (limb + np.uint64(i + 1) * _GOLDEN))
    return h


def _bucket_ranges(ids: np.ndarray, n_buckets: int):
    """The stable order of ``ids`` (bucket ids in ``[0, n_buckets)``) and each
    present bucket's ``(bucket, start, end)`` in it.  A narrow integer copy
    of the ids lets numpy's stable sort take its radix path (the permutation
    is the same: a stable sort has one answer), and ``bincount`` gives the
    ranges without a second sort."""
    narrow = np.uint8 if n_buckets <= 1 << 8 else np.uint16 if n_buckets <= 1 << 16 else np.int64
    order = np.argsort(ids.astype(narrow), kind="stable")
    counts = np.bincount(ids, minlength=n_buckets)
    ends = np.cumsum(counts)
    present = np.flatnonzero(counts)
    return order, [(int(b), int(ends[b] - counts[b]), int(ends[b])) for b in present]


# -------------------------------------------------------- the disk shuffle --


class ExternalTableShuffle:
    """Disk-backed grace-hash partitioner for full columnar tables.

    ``append(side, columns)`` routes a chunk's rows to per-(side, bucket)
    spill files holding JCUDF row bytes (append-only); ``read(side, b)``
    materializes one bucket back into columns.  Peak host memory is one
    chunk during routing plus one bucket during execution.

    ``split_bucket(b)`` refines one bucket into two ON DISK with bounded
    memory: per-bucket hash modulus doubles (``hash % M == b`` implies
    ``hash % 2M in {b, b+M}``), so refinement is consistent across sides --
    the recursive-grace-hash rung of the split-and-retry protocol.  Only
    the key columns are decoded during a split; row bytes move verbatim.

    Spill files: ``{side}.{bucket:04d}.rows`` (JCUDF row bytes) plus, for
    schemas with strings (variable row size), ``.len`` (little-endian
    uint32 row sizes).  Fixed-width schemas need no length file -- every
    row is ``fixed_row_size`` bytes.
    """

    def __init__(self, tmpdir: str, n_buckets: int,
                 dtypes: Sequence[DType],
                 key_indices: Sequence[int],
                 key_hash: Optional[Callable[[Sequence], np.ndarray]] = None):
        self.dir = tmpdir
        self.n_buckets = n_buckets
        self.dtypes = list(dtypes)
        self.key_indices = tuple(key_indices)
        self.key_hash = key_hash if key_hash is not None else chained_key_hash
        self.has_strings = any(d.kind == Kind.STRING for d in self.dtypes)
        _, _, _, size_per_row = compute_layout(self.dtypes)
        self.fixed_row_size = _round_up(size_per_row, JCUDF_ROW_ALIGNMENT)
        self.rows: Dict[Tuple[str, int], int] = {}
        self._modulus: Dict[int, int] = {}
        os.makedirs(tmpdir, exist_ok=True)

    # -- paths -------------------------------------------------------------

    def _path(self, side: str, bucket: int, ext: str) -> str:
        return os.path.join(self.dir, f"{side}.{bucket:04d}.{ext}")

    def _sides(self) -> List[str]:
        return sorted({s for (s, _b) in self.rows})

    # -- ingest ------------------------------------------------------------

    def row_hashes(self, columns: Sequence) -> np.ndarray:
        """The routing hash of a chunk (uint64[n]); ``% n_buckets`` is the
        bucket id -- exposed so owners can filter chunks before spooling."""
        return self.key_hash([columns[i] for i in self.key_indices])

    def append(self, side: str, columns: Sequence,
               hashes: Optional[np.ndarray] = None) -> None:
        """Route one chunk's rows to this side's bucket spill files."""
        if self._modulus:
            raise ValueError(
                "append after split_bucket would route at the wrong modulus")
        n = _nrows(columns[0])
        if n == 0:
            return
        with PHASES.phase("route_encode"):
            if hashes is None:
                hashes = self.row_hashes(columns)
            ids = (hashes % np.uint64(self.n_buckets)).astype(np.int64)
            buf, row_sizes = encode_jcudf_rows(columns)
            order, ranges = _bucket_ranges(ids, self.n_buckets)
            if not self.has_strings:
                rows = buf.reshape(n, self.fixed_row_size)
            else:
                row_off = np.cumsum(row_sizes, dtype=np.int64) - row_sizes
        for b, s, e in ranges:
            with PHASES.phase("route_encode"):
                idx = order[s:e]
                if self.has_strings:
                    sz = row_sizes[idx]
                    data = buf[np.repeat(row_off[idx], sz) + _ragged_arange(sz)]
                else:
                    data = rows[idx]
            with PHASES.phase("write"):
                with open(self._path(side, b, "rows"), "ab") as f:
                    f.write(data.tobytes())
                if self.has_strings:
                    with open(self._path(side, b, "len"), "ab") as f:
                        f.write(sz.astype("<u4").tobytes())
            key = (side, b)
            self.rows[key] = self.rows.get(key, 0) + (e - s)

    # -- read back ---------------------------------------------------------

    def _bucket_row_sizes(self, side: str, bucket: int) -> np.ndarray:
        if self.has_strings:
            path = self._path(side, bucket, "len")
            if not os.path.exists(path):
                return np.zeros(0, np.int64)
            with open(path, "rb") as f:
                return np.frombuffer(f.read(), "<u4").astype(np.int64)
        n = self.rows.get((side, bucket), 0)
        return np.full(n, self.fixed_row_size, np.int64)

    def read(self, side: str, bucket: int,
             device: _device.DeviceLike = None) -> List:
        """Materialize one (side, bucket) as port columns on ``device`` (the
        card unless the caller asks for the CPU)."""
        path = self._path(side, bucket, "rows")
        if not os.path.exists(path):
            return decode_jcudf_rows(np.zeros(0, np.uint8), np.zeros(1, np.int64),
                                     self.dtypes, device=device)
        with open(path, "rb") as f:
            buf = np.frombuffer(f.read(), np.uint8)
        sizes = self._bucket_row_sizes(side, bucket)
        offsets = np.zeros(len(sizes) + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        return decode_jcudf_rows(buf, offsets, self.dtypes, device=device)

    # -- accounting --------------------------------------------------------

    def bucket_nbytes(self, bucket: int) -> int:
        """ACTUAL spill bytes of one bucket (all sides, rows + len files) --
        what the host governor reserves before the bucket materializes."""
        total = 0
        for side in self._sides():
            for ext in ("rows", "len"):
                path = self._path(side, bucket, ext)
                if os.path.exists(path):
                    total += os.path.getsize(path)
        return total

    def bucket_rows(self, bucket: int) -> int:
        return sum(n for (s, b), n in self.rows.items() if b == bucket)

    def max_bucket_rows(self) -> int:
        """Largest combined bucket -- sizes the exchange capacity once so
        every bucket reuses ONE executor."""
        per_bucket: Dict[int, int] = {}
        for (_side, b), n in self.rows.items():
            per_bucket[b] = per_bucket.get(b, 0) + n
        return max(per_bucket.values(), default=0)

    # -- refinement --------------------------------------------------------

    def split_bucket(self, bucket: int,
                     chunk_rows: int = 1 << 18) -> Tuple[int, int]:
        """Refine one bucket into two on DISK with bounded memory.

        Rows whose key hash lands on ``bucket`` at modulus ``2M`` stay; the
        rest move (raw bytes, no re-encode) to ``bucket + M``.  Streamed in
        ``chunk_rows`` chunks -- never the whole bucket in memory.
        """
        m = self._modulus.get(bucket, self.n_buckets)
        new_bucket = bucket + m
        for side in self._sides():
            if (side, bucket) not in self.rows:
                continue
            sizes = self._bucket_row_sizes(side, bucket)
            keep_rows = self._path(side, bucket, "rows") + ".keep"
            keep_len = self._path(side, bucket, "len") + ".keep"
            kept = moved = 0
            with open(self._path(side, bucket, "rows"), "rb") as rf, \
                    open(keep_rows, "wb") as kf:
                lf = open(keep_len, "wb") if self.has_strings else None
                try:
                    for at in range(0, len(sizes), chunk_rows):
                        sz = sizes[at:at + chunk_rows]
                        buf = np.frombuffer(rf.read(int(sz.sum())), np.uint8)
                        offs = np.zeros(len(sz) + 1, np.int64)
                        np.cumsum(sz, out=offs[1:])
                        keys = decode_jcudf_rows(
                            buf, offs, self.dtypes, select=self.key_indices,
                            device="cpu")
                        h = self.key_hash([keys[i] for i in self.key_indices])
                        stay = (h % np.uint64(2 * m)).astype(np.int64) == bucket
                        byte_stay = np.repeat(stay, sz)
                        kf.write(buf[byte_stay].tobytes())
                        if not stay.all():
                            with open(self._path(side, new_bucket, "rows"),
                                      "ab") as mf:
                                mf.write(buf[~byte_stay].tobytes())
                            if self.has_strings:
                                with open(self._path(side, new_bucket, "len"),
                                          "ab") as mlf:
                                    mlf.write(
                                        sz[~stay].astype("<u4").tobytes())
                        if self.has_strings:
                            lf.write(sz[stay].astype("<u4").tobytes())
                        kept += int(stay.sum())
                        moved += int((~stay).sum())
                finally:
                    if lf is not None:
                        lf.close()
            os.replace(keep_rows, self._path(side, bucket, "rows"))
            if self.has_strings:
                os.replace(keep_len, self._path(side, bucket, "len"))
            self.rows[(side, bucket)] = kept
            if moved:
                self.rows[(side, new_bucket)] = (
                    self.rows.get((side, new_bucket), 0) + moved)
        self._modulus[bucket] = 2 * m
        self._modulus[new_bucket] = 2 * m
        return bucket, new_bucket

    def close(self) -> None:
        for (side, b) in list(self.rows):
            for ext in ("rows", "len"):
                try:
                    os.remove(self._path(side, b, ext))
                except OSError:
                    pass
        self.rows.clear()
        self._modulus.clear()
