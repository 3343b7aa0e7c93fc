"""Flagship pipeline: the NDS-style hash-aggregate step, on one device and
over a (data, model) mesh.

PyTorch port of ``spark_rapids_jni_tpu/models/nds.py``: xxhash64 of the int64
keys reduced mod ``n_buckets`` into a segment-sum aggregation, and a bloom
build and probe whose bit positions are double-hashed from two murmur3 seeds.
The distributed step shards the bloom bits over ``model`` and moves rows to
their owning data-rank with an ``all_to_all`` shuffle before aggregating.  The
hashes run in the CUDA kernels on the card (``ops/hash_cuda.py``); the rest is
plain torch and ``torch.distributed``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.ops.hashing import murmur3_raw_int64, xxhash64_raw_int64
from spark_rapids_jni_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
)
from spark_rapids_jni_tpu_torch.parallel.shuffle import (
    ShuffleCrossing,
    all_to_all_shuffle,
    partition_of,
)

_M32 = 0xFFFFFFFF


class QueryStepConfig(NamedTuple):
    n_buckets: int = 1024  # aggregation hash-table size (per data shard)
    bloom_bits: int = 1 << 16  # bloom bit count (sharded over the model axis)
    bloom_hashes: int = 3  # k probe hashes
    shuffle_capacity: int = 0  # 0 == the local row count: no row is ever dropped


class QueryStepOut(NamedTuple):
    bucket_sums: torch.Tensor  # [n_buckets] this data shard's partial aggregate
    bucket_counts: torch.Tensor  # [n_buckets] int32
    bloom_bits: torch.Tensor  # [bloom_bits // mp] uint8, this model shard's bit range
    probe_hits: torch.Tensor  # int64 scalar: rows passing the bloom probe (global)
    total_rows: torch.Tensor  # int32 scalar: global row count
    dropped: torch.Tensor  # int32 scalar: shuffle capacity overflows (global)


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


def _sharded_bloom(keys: torch.Tensor, cfg: QueryStepConfig, mesh: DeviceMesh):
    """The bloom build and probe on one rank: (this model shard's bits, the
    global probe hits as an int64 scalar)."""
    mp = axis_size(mesh, MODEL_AXIS)
    data_group = axis_group(mesh, DATA_AXIS)
    # build: this model shard sets only the bits of its own range, then ORs
    # (max) its partial bitmap over the data axis.  Positions are taken mod
    # the effective total (bits_per_shard * mp), so no range is orphaned when
    # bloom_bits does not divide by the mesh.
    bits_per_shard = cfg.bloom_bits // mp
    pos = _bloom_positions(keys, cfg.bloom_hashes, bits_per_shard * mp)
    if mp > 1:  # local positions; the other shards' go to a spare bit past the range
        pos.sub_(axis_index(mesh, MODEL_AXIS) * bits_per_shard)
        pos.masked_fill_((pos < 0) | (pos >= bits_per_shard), bits_per_shard)
    bits = torch.zeros((bits_per_shard + 1,), dtype=torch.uint8, device=keys.device)
    bits[pos.reshape(-1)] = 1
    bits[bits_per_shard] = 0  # the spare bit reads 0 in the probe
    local_bits = bits[:bits_per_shard]
    dist.all_reduce(local_bits, op=dist.ReduceOp.MAX, group=data_group)
    # probe: each model shard counts the probe bits it owns and has set; a
    # row passes iff the sum over the model axis reaches k
    set_total = bits[pos].sum(dim=1, dtype=torch.int32)
    dist.all_reduce(set_total, group=axis_group(mesh, MODEL_AXIS))
    probe_hits = (set_total == cfg.bloom_hashes).sum()
    dist.all_reduce(probe_hits, group=data_group)
    return local_bits, probe_hits


def _aggregate(shuffled, cfg: QueryStepConfig):
    """Bucket sums and counts of the received rows; pad slots go to an extra
    bucket that is cut off."""
    valid = shuffled.valid
    keys, values = shuffled.columns["keys"], shuffled.columns["values"]
    bucket = torch.where(valid, _umod(xxhash64_raw_int64(keys), cfg.n_buckets), cfg.n_buckets)
    sums = torch.zeros((cfg.n_buckets + 1,), dtype=values.dtype, device=values.device)
    sums.index_add_(0, bucket, torch.where(valid, values, 0))
    counts = torch.zeros((cfg.n_buckets + 1,), dtype=torch.int32, device=values.device)
    counts.index_add_(0, bucket, valid.to(torch.int32))
    return sums[:-1], counts[:-1]


def _sharded_step(keys: torch.Tensor, values: torch.Tensor, cfg: QueryStepConfig,
                  mesh: DeviceMesh) -> QueryStepOut:
    """The step on one rank, over its data shard of ``keys`` and ``values``:
    bloom build and probe, shuffle of the rows to their owning data-rank,
    aggregation of the owned rows."""
    n_local = keys.shape[0]
    bits, probe_hits = _sharded_bloom(keys, cfg, mesh)
    part = partition_of(keys, axis_size(mesh, DATA_AXIS))
    shuffled = all_to_all_shuffle({"keys": keys, "values": values}, part,
                                  cfg.shuffle_capacity or n_local, mesh, axis=DATA_AXIS)
    sums, counts = _aggregate(shuffled, cfg)
    # total rows and drops summed over the whole mesh, once per model replica
    totals = torch.stack([torch.tensor(n_local, dtype=torch.int32, device=keys.device),
                          shuffled.dropped])
    dist.all_reduce(totals)  # the whole group: make_mesh spans every rank
    totals //= axis_size(mesh, MODEL_AXIS)
    return QueryStepOut(sums, counts, bits, probe_hits, totals[0], totals[1])


def make_distributed_query_step(mesh: DeviceMesh, cfg: QueryStepConfig):
    """The step over ``mesh``: a callable that each rank calls with its data
    shard of ``keys`` and ``values`` (rows sharded over ``data``, replicated
    over ``model``) and that returns this rank's :class:`QueryStepOut`.
    Concatenated over the data axis, the ranks' bucket sums and counts are the
    JAX package's global outputs; over the model axis, their bloom bits.

    The callable crosses ``seam(COLLECTIVE, "all_to_all_shuffle")`` once per
    input signature, at its first call with it and before any launch, where
    the JAX package's jit traces the step (:class:`ShuffleCrossing`)."""
    crossing = ShuffleCrossing()

    def step(keys: torch.Tensor, values: torch.Tensor) -> QueryStepOut:
        crossing(keys, values)
        return _sharded_step(keys, values, cfg, mesh)

    return step


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
