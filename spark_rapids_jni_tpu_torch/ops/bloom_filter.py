"""Spark-sketch-compatible bloom filter: create / put / merge / probe /
(de)serialize (PyTorch port of ``ops/bloom_filter.py``).

Capability parity with the reference's bloom filter ops (bloom_filter.cu:63
gpu_bloom_filter_put, :92 bloom_probe_functor, :229 bloom_filter_create, :275
bloom_filter_merge, :324 bloom_filter_probe), matching Spark's
``BloomFilterImpl.putLong``/``mightContainLong`` bit-for-bit.

As in the JAX package, the live filter is a logical long array -- bit ``i``
of ``longs[i >> 6]`` -- held here as int64 with the uint64 bits; Spark's
big-endian wire format (12-byte header {version=1, numHashes, numLongs} +
numLongs big-endian int64s) exists only in ``serialize``/``deserialize``,
which run on the host.  Byte-level interchange with Spark is exact.

Both hashes of a value go through the ``mm_hash_long`` kernel
(``hash_cuda.mm_hash_long_cuda``: launched for a CUDA tensor, its plain
version for a CPU one), the second with the first as its per-row seed.  Put
keeps the JAX package's two paths and their threshold: a byte-per-bit
scatter packed 64 bits a word for inserts dense in the filter, and a sort +
dedup + scatter-add for a small insert into a large filter.  Indices that
must drop (null rows) go to one spare slot past the filter, never out of
range: an out-of-range index on the card is a device-side assert, not a drop.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Dict

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar.column import Column
from spark_rapids_jni_tpu_torch.columnar.dtypes import BOOL, Kind
from spark_rapids_jni_tpu_torch.ops.hash_cuda import M32, mm_hash_long_cuda

SPARK_BLOOM_FILTER_VERSION = 1
HEADER_SIZE = 12

#: bloom_filter_put calls per put path ("scatter", "sorted"), for callers
#: that check which path a geometry takes
put_paths: Dict[str, int] = {"scatter": 0, "sorted": 0}


@dataclasses.dataclass
class BloomFilter:
    """A Spark bloom filter: ``num_longs`` 64-bit words, ``num_hashes`` probes."""

    longs: torch.Tensor  # int64[num_longs] holding the uint64 words, logical bit order
    num_hashes: int
    num_longs: int

    @property
    def num_bits(self) -> int:
        return self.num_longs * 64

    @property
    def device(self) -> torch.device:
        return self.longs.device


def _check_geometry(num_hashes: int, num_longs: int) -> None:
    if num_longs <= 0:
        raise ValueError("Invalid empty bloom filter size")
    if num_hashes <= 0:
        raise ValueError("Number of bloom filter hashes must be positive")


def bloom_filter_create(num_hashes: int, bloom_filter_longs: int,
                        device: _device.DeviceLike = None) -> BloomFilter:
    """Empty filter of ``bloom_filter_longs`` 64-bit words (bloom_filter.cu:229)
    on ``device`` (the card unless the caller asks for the CPU)."""
    _check_geometry(num_hashes, bloom_filter_longs)
    longs = torch.zeros((bloom_filter_longs,), dtype=torch.int64,
                        device=_device.resolve(device))
    return BloomFilter(longs, int(num_hashes), int(bloom_filter_longs))


def _hash_pair(values: torch.Tensor):
    """(h1, h2) of int64 values as int64 holding int32 values:
    h1 = murmur3(long, 0), h2 = murmur3(long, h1) (BloomFilterImpl.java:87-88)."""
    v = values.to(torch.int64).contiguous()
    h1 = mm_hash_long_cuda(v, 0)
    h2 = mm_hash_long_cuda(v, h1)
    return h1.to(torch.int64), h2.to(torch.int64)


def _hash_index(h1: torch.Tensor, h2: torch.Tensor, i: int, num_bits: int) -> torch.Tensor:
    """Bit index of the ``i``-th hash (1-based): combined = h1 + i*h2 with
    int32 wraparound, ``~combined`` where negative, modulo the bit count."""
    c = (h1 + i * h2) & M32
    c = c - ((c >> 31) << 32)  # back to a signed int32 value
    return torch.where(c < 0, ~c, c) % num_bits


def _bit_indices(values: torch.Tensor, num_hashes: int, num_bits: int) -> torch.Tensor:
    """[num_hashes, n] int64 bloom bit indices of int64 values
    (BloomFilterImpl.java:87-94), hash-major as in the JAX package."""
    h1, h2 = _hash_pair(values)
    return torch.stack([_hash_index(h1, h2, i, num_bits)
                        for i in range(1, num_hashes + 1)])


# Path-selection threshold for put: the scatter-set path materializes a
# byte per BIT of transient memory (plus its packing) no matter how few
# values are inserted, while the sort+dedup path costs a few words per
# inserted INDEX.  Below num_bits ~ 8x the index count the dense scatter
# wins (big inserts into a filter they mostly fill); above it a small batch
# into a huge filter must not allocate byte-per-bit (ADVICE.md:3).
_SCATTER_BITS_PER_INDEX = 8


def _put_scatter_bits(flat: torch.Tensor, num_bits: int) -> torch.Tensor:
    """int64[num_longs] via a byte-per-bit scatter-set + 64x pack.  Setting is
    idempotent, so duplicate bits need no dedup; the spare byte at
    ``num_bits`` takes the null rows' sentinel indices."""
    bits = torch.zeros((num_bits + 1,), dtype=torch.uint8, device=flat.device)
    bits[flat] = 1
    weights = 1 << torch.arange(8, dtype=torch.int32, device=flat.device)
    # eight bits per byte, LSB-first; a word's eight bytes little-endian give
    # bit (i & 63) of word i >> 6
    packed = (bits[:num_bits].view(-1, 8).to(torch.int32) * weights).sum(dim=1)
    return packed.to(torch.uint8).view(torch.int64)


def _put_sorted(flat: torch.Tensor, num_bits: int) -> torch.Tensor:
    """int64[num_longs] via sort + first-occurrence dedup + scatter-add.

    Transient memory scales with the INDEX count, not the filter width:
    dedup guarantees each bit contributes once, so the per-word sum of
    distinct powers of two (wrapping in int64) equals the bitwise or.
    Sentinel indices (== num_bits, the null rows) sort to the top and add
    into the spare word at ``num_longs``.
    """
    s = torch.sort(flat).values
    first = torch.ones_like(s, dtype=torch.bool)
    first[1:] = s[1:] != s[:-1]
    first &= s < num_bits
    contrib = torch.where(first, torch.ones_like(s) << (s & 63), 0)
    out = torch.zeros((num_bits // 64 + 1,), dtype=torch.int64, device=flat.device)
    out.index_add_(0, s >> 6, contrib)
    return out[:-1]


def bloom_filter_put(bloom_filter: BloomFilter, input: Column) -> BloomFilter:
    """Insert an INT64 column's non-null values; returns the updated filter
    (a new filter: the input's words are not written)."""
    if input.dtype.kind != Kind.INT64:
        raise TypeError("bloom_filter_put requires an INT64 column")
    idx = _bit_indices(input.data, bloom_filter.num_hashes, bloom_filter.num_bits)
    if input.validity is not None:
        # null rows' bits go to the sentinel num_bits: both paths drop it
        idx = torch.where(input.validity[None, :], idx, bloom_filter.num_bits)
    flat = idx.reshape(-1)
    if bloom_filter.num_bits <= _SCATTER_BITS_PER_INDEX * flat.shape[0]:
        put_paths["scatter"] += 1
        batch = _put_scatter_bits(flat, bloom_filter.num_bits)
    else:
        put_paths["sorted"] += 1
        batch = _put_sorted(flat, bloom_filter.num_bits)
    return dataclasses.replace(bloom_filter, longs=bloom_filter.longs | batch)


def bloom_filter_probe(input: Column, bloom_filter: BloomFilter) -> Column:
    """BOOL column: True if the value may be present (bloom_filter.cu:324).
    Output validity mirrors the input's (null in, null out)."""
    if input.dtype.kind != Kind.INT64:
        raise TypeError("bloom_filter_probe requires an INT64 column")
    h1, h2 = _hash_pair(input.data)
    present = None
    for i in range(1, bloom_filter.num_hashes + 1):
        ii = _hash_index(h1, h2, i, bloom_filter.num_bits)
        hit = ((bloom_filter.longs[ii >> 6] >> (ii & 63)) & 1) == 1
        present = hit if present is None else present & hit
    return Column(present, input.validity, BOOL)


def bloom_filter_merge(filters: list[BloomFilter]) -> BloomFilter:
    """Bitwise-or of same-shaped filters (bloom_filter.cu:275)."""
    if not filters:
        raise ValueError("at least one bloom filter is required")
    head = filters[0]
    for f in filters[1:]:
        if (f.num_hashes, f.num_longs) != (head.num_hashes, head.num_longs):
            raise ValueError("Mismatch of bloom filter parameters")
    longs = head.longs
    for f in filters[1:]:
        longs = longs | f.longs
    return dataclasses.replace(head, longs=longs)


def bloom_filter_serialize(bloom_filter: BloomFilter) -> bytes:
    """Spark wire format: big-endian header + big-endian longs (host-side)."""
    header = struct.pack(">iii", SPARK_BLOOM_FILTER_VERSION, bloom_filter.num_hashes,
                         bloom_filter.num_longs)
    longs = bloom_filter.longs.cpu().numpy().view(np.uint64).astype(">u8")
    return header + longs.tobytes()


def bloom_filter_deserialize(buf: bytes, device: _device.DeviceLike = None) -> BloomFilter:
    """Parse the Spark wire format (validation per bloom_filter.cu:141-166) into
    a filter on ``device`` (the card unless the caller asks for the CPU)."""
    if len(buf) < HEADER_SIZE:
        raise ValueError("Encountered truncated bloom filter")
    version, num_hashes, num_longs = struct.unpack(">iii", buf[:HEADER_SIZE])
    if version != SPARK_BLOOM_FILTER_VERSION:
        raise ValueError("Unexpected bloom filter version")
    _check_geometry(num_hashes, num_longs)
    if len(buf) != HEADER_SIZE + num_longs * 8:
        raise ValueError("Encountered invalid/mismatched bloom filter buffer data")
    longs = np.frombuffer(buf, dtype=">u8", offset=HEADER_SIZE).astype(np.uint64)
    return BloomFilter(torch.from_numpy(longs.view(np.int64)).to(_device.resolve(device)),
                       num_hashes, num_longs)
