"""Flagship pipeline, single-chip form: the NDS-style hash-aggregate step.

PyTorch port of ``local_query_step`` from ``spark_rapids_jni_tpu/models/nds.py``:
xxhash64 of the int64 keys reduced mod ``n_buckets`` into a segment-sum
aggregation, and a bloom build and probe whose bit positions are
double-hashed from two murmur3 seeds.  The hashes run in the CUDA kernels on
the card (``ops/hash_cuda.py``); the rest is plain torch.  The distributed
step arrives with the distributed slice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.ops.hashing import murmur3_raw_int64, xxhash64_raw_int64

_M32 = 0xFFFFFFFF


class QueryStepConfig(NamedTuple):
    n_buckets: int = 1024  # aggregation hash-table size
    bloom_bits: int = 1 << 16  # bloom bit count
    bloom_hashes: int = 3  # k probe hashes


def _umod(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h mod m`` for u64 bits held in int64, exactly.  torch's ``%`` reads
    int64 as signed, which gives the wrong bucket for every hash with its top
    bit set, so h is split into 32-bit halves: (hi * 2**32 + lo) mod m."""
    if not 0 < m < (1 << 31):
        raise ValueError(f"modulus must be in [1, 2**31), got {m}")
    hi = (h >> 32) & _M32
    lo = h & _M32
    return ((hi % m) * ((1 << 32) % m) + lo % m) % m


def _bloom_positions(keys: torch.Tensor, k: int, total_bits: int) -> torch.Tensor:
    """[n, k] int64 bit positions via double hashing from two murmur seeds.
    Built in place in one [n, k] buffer: at full batch size it is the step's
    largest tensor."""
    h1 = murmur3_raw_int64(keys, 0).to(torch.int64) & _M32
    h2 = murmur3_raw_int64(keys, 0x9747B28C).to(torch.int64) & _M32
    ks = torch.arange(1, k + 1, dtype=torch.int64, device=keys.device)
    pos = h2[:, None] * ks[None, :]
    pos.add_(h1[:, None])
    return pos.remainder_(total_bits)


def local_query_step(keys: torch.Tensor, values: torch.Tensor, cfg: QueryStepConfig):
    """Single-chip step on the inputs' device: hash + bloom build/probe +
    bucket aggregation.  Returns (bucket sums [n_buckets] of ``values``'
    dtype, bucket counts [n_buckets] int32, bloom bits [bloom_bits] uint8,
    probe hits as an int64 scalar tensor)."""
    dev = keys.device
    h = xxhash64_raw_int64(keys)
    bucket = _umod(h, cfg.n_buckets)
    sums = torch.zeros((cfg.n_buckets,), dtype=values.dtype, device=dev)
    sums.index_add_(0, bucket, values)
    counts = torch.zeros((cfg.n_buckets,), dtype=torch.int32, device=dev)
    counts.index_add_(0, bucket, torch.ones_like(values, dtype=torch.int32))
    pos = _bloom_positions(keys, cfg.bloom_hashes, cfg.bloom_bits)
    bits = torch.zeros((cfg.bloom_bits,), dtype=torch.uint8, device=dev)
    bits[pos.reshape(-1)] = 1
    probed = bits[pos].all(dim=1)
    return sums, counts, bits, probed.sum()


def make_example_batch(n: int, seed: int = 0,
                       device: _device.DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthetic (keys int64 in [0, 2**20), values int64 in [0, 1000)) batch
    drawn from ``numpy.random.RandomState(seed)``, on ``device`` (the card
    unless the caller asks for the CPU)."""
    dev = _device.resolve(device)
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 1 << 20, n, dtype=np.int64)
    values = rng.randint(0, 1000, n, dtype=np.int64)
    return torch.from_numpy(keys).to(dev), torch.from_numpy(values).to(dev)
