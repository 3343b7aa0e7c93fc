"""Columnar hash-repartition over the mesh's ``data`` axis (PyTorch port of
``parallel/shuffle.py``).

Rows move between ranks with one ``all_to_all_single`` per column, in
fixed-capacity buckets, with the JAX package's slot layout bit for bit:

    local rows --bucket by partition--> [ndev, capacity] send buffer
               --all_to_all--> [ndev, capacity] receive buffer + slot-valid mask

A row's slot is ``part * capacity + rank``, its rank the row's place among
the rows of its partition in a stable sort; chunk ``i`` of the receive buffer
comes from data-rank ``i``; unused slots are zeros.  Rows past a bucket's
capacity are not sent and are counted in ``dropped``, the caller's signal to
retry with a larger capacity.  The functions run on each rank, on its shard,
with the mesh passed in.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.columnar.column import next_pow2
from spark_rapids_jni_tpu_torch.ops.hashing import murmur3_raw_int64, partition_mix32
from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_size

_M32 = 0xFFFFFFFF
PLACEMENTS = ("murmur3", "mix32")


class ShuffleResult(NamedTuple):
    columns: Dict[str, torch.Tensor]  # [ndev * capacity, ...] received rows (padded)
    valid: torch.Tensor  # bool[ndev * capacity] slot occupancy
    dropped: torch.Tensor  # int32 scalar: local rows lost to capacity overflow


def partition_of(keys: torch.Tensor, n_parts: int,
                 placement: Optional[str] = None) -> torch.Tensor:
    """Owning partition (int32) of each int64 key: the placement hash, Spark's
    murmur3 with seed 42 (the default) or ``mix32`` (:func:`partition_mix32`),
    reduced mod ``n_parts`` as the unsigned value of its 32 bits.
    ``placement`` None reads the ``partition_hash`` flag at each call, the
    setting that places the JAX package's rows too."""
    if placement is None:
        placement = config.get("partition_hash")
    if placement == "murmur3":
        h = murmur3_raw_int64(keys, 42)
    elif placement == "mix32":
        h = partition_mix32(keys)
    else:
        raise ValueError(f"placement must be one of {PLACEMENTS}, got {placement!r}")
    return ((h.to(torch.int64) & _M32) % n_parts).to(torch.int32)


def quantized_rows(n: int, mult: int) -> int:
    """Batch length that is a ``mult`` multiple AND pow2-quantized:
    ``mult * next_pow2(ceil(n / mult))`` (min one block), so a long-lived
    executor sees O(log max_rows) batch shapes per geometry."""
    return mult * next_pow2(max(1, -(-int(n) // mult)))


def bucket_by_partition(part: torch.Tensor, n_parts: int, capacity: int):
    """Each local row's slot in a [n_parts, capacity] send layout.

    Returns (slot int32 [n], in-capacity mask [n], per-partition counts int32
    [n_parts]).  A partition outside [0, n_parts) is not counted and takes
    the ranks of the last partition, as the JAX package's clamped gathers give
    them; callers never send such rows."""
    n = part.shape[0]
    order = torch.argsort(part, stable=True)
    sorted_part = part[order].to(torch.int64)
    counts = torch.bincount(torch.clamp(part.to(torch.int64), 0, n_parts),
                            minlength=n_parts + 1)[:n_parts].to(torch.int32)
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    rank_sorted = torch.arange(n, dtype=torch.int32, device=part.device) - \
        starts[torch.clamp(sorted_part, max=n_parts - 1)]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    in_cap = rank < capacity
    slot = part.to(torch.int32) * capacity + torch.clamp(rank, max=capacity - 1)
    return slot, in_cap, counts


def _exchange(send: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all_single`` with equal splits; bool tensors travel as the
    uint8 of the same bytes."""
    wire = send.view(torch.uint8) if send.dtype == torch.bool else send
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    return recv.view(torch.bool) if send.dtype == torch.bool else recv


def all_to_all_shuffle(columns: Dict[str, torch.Tensor], part: torch.Tensor, capacity: int,
                       mesh: DeviceMesh, axis: str = DATA_AXIS,
                       row_valid: Optional[torch.Tensor] = None) -> ShuffleResult:
    """Exchange rows so that each rank receives the rows whose ``part`` is its
    index along ``axis``.  Every column has the rows of ``part`` along its
    first dimension.

    ``row_valid`` (bool[n], optional) marks padding rows: they are never
    sent, never take a slot and are not counted in ``dropped``."""
    ndev = axis_size(mesh, axis)
    group = axis_group(mesh, axis)
    if row_valid is not None:
        # invalid rows ride the out-of-range partition, which sorts last
        part = torch.where(row_valid, part, ndev)
    slot, in_cap, _ = bucket_by_partition(part, ndev, capacity)
    if row_valid is None:
        sendable, dropped = in_cap, (~in_cap).sum()
    else:
        sendable, dropped = in_cap & row_valid, (row_valid & ~in_cap).sum()
    slots = ndev * capacity
    # unsendable rows land in one extra slot past the end, which is cut off
    target = torch.where(sendable, slot.to(torch.int64), slots)
    send_valid = torch.zeros((slots + 1,), dtype=torch.bool, device=part.device)
    send_valid[target] = True
    recv_valid = _exchange(send_valid[:slots], group)
    recv_cols = {}
    for name, data in columns.items():
        send = torch.zeros((slots + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
                           device=data.device)
        send[target] = data
        recv_cols[name] = _exchange(send[:slots], group)
    return ShuffleResult(recv_cols, recv_valid, dropped.to(torch.int32))
