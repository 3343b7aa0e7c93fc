"""Spill-to-host staging for budget-governed device data (PyTorch port of
``mem/spill.py``).

The reference's recovery ladder on allocation failure is: ask the spill
framework to free device memory (RmmEventHandler.onAllocFailure -> stores
spill to host), retry, and only then escalate to Retry/SplitAndRetry
(protocol doc RmmSpark.java:402-416; the arbiter's recursive-alloc
detection, SparkResourceAdaptorJni.cpp:1244-1261, exists precisely for
allocations made *while* spilling).  This module is that rung on the card:

- :class:`SpillableBuffer` -- a budget-accounted device tensor that can move
  to host memory (pinned, for a card; releasing its reservation) and back
  on demand;
- :class:`SpillPool` -- LRU registry; ``spill_until(nbytes)`` frees budget
  by spilling least-recently-used unpinned buffers;
- ``BudgetedResource.register_spill_handler`` (mem/governor.py) calls the
  pool between a failed reservation and the BLOCKED/BUFN escalation, so a
  tenant under pressure first reclaims idle cached data -- exactly where
  the reference consults its spill store.

Pinning: ``with buf.use() as t:`` marks the buffer in-use; pinned buffers
are never spilled (spilling one would free budget while the borrowed device
tensor is still live -- accounting drift).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import List, Optional

import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.mem.governor import BudgetedResource
from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.obs import seam as _seam

__all__ = ["SpillableBuffer", "SpillPool", "pool_gauges"]

# live pools, for spill-pressure gauges (serve metrics + flight dumps)
_POOLS: "weakref.WeakSet" = weakref.WeakSet()


def pool_gauges() -> dict:
    """Aggregate spill gauges over live pools (non-destructive)."""
    out = {"pools": 0, "device_bytes": 0, "spill_count": 0,
           "spilled_bytes": 0}
    for p in list(_POOLS):
        out["pools"] += 1
        out["device_bytes"] += p.device_bytes()
        out["spill_count"] += p.spill_count
        out["spilled_bytes"] += p.spilled_bytes
    return out


_flight.register_telemetry_source("spill", pool_gauges)


class SpillableBuffer:
    """A device tensor whose reservation can be reclaimed.

    States: DEVICE (budget held, ``_dev`` set) or HOST (budget released,
    ``_host`` set, in pinned memory when the pool's device is a card).  All
    transitions run under the owning pool's lock via the pool's methods;
    ``use()`` re-admits through the budget (which may itself spill *other*
    buffers or block under the arbiter protocol) and uploads again.
    """

    def __init__(self, pool: "SpillPool", tensor: torch.Tensor) -> None:
        self._pool = pool
        self.nbytes = int(tensor.numel() * tensor.element_size())
        self._dev: Optional[torch.Tensor] = None
        self._pins = 0
        self._seq = 0  # LRU clock value, maintained by the pool
        self._host: Optional[torch.Tensor] = pool._to_host(tensor)  # upload on first use()

    @property
    def spilled(self) -> bool:
        return self._dev is None

    def use(self):
        """Context manager yielding the device tensor, pinned while open."""
        return _Pinned(self)

    def spill(self) -> int:
        """Move to host and release the reservation (pool lock held by
        caller or single-threaded test).  Returns bytes freed."""
        return self._pool._spill_one(self)


class _Pinned:
    def __init__(self, buf: SpillableBuffer) -> None:
        self._buf = buf

    def __enter__(self):
        return self._buf._pool._pin(self._buf)

    def __exit__(self, *exc) -> None:
        self._buf._pool._unpin(self._buf)


class SpillPool:
    """LRU spill registry bound to one :class:`BudgetedResource`.

    Registers itself as the budget's spill handler: when a reservation
    fails, the budget asks ``spill_until(shortfall)`` before escalating
    to the arbiter's BLOCKED/BUFN path.
    """

    def __init__(self, budget: BudgetedResource,
                 device: _device.DeviceLike = None) -> None:
        self._budget = budget
        # where resident buffers live: the card unless the caller asks for
        # the CPU; a card's spilled copies sit in pinned host memory
        self.device = _device.resolve(device)
        self._lock = threading.RLock()
        self._buffers: List[SpillableBuffer] = []  # guarded-by: _lock
        self._clock = 0  # guarded-by: _lock
        self.spill_count = 0  # guarded-by: _lock
        self.spilled_bytes = 0  # guarded-by: _lock
        budget.register_spill_handler(self.spill_until)
        _POOLS.add(self)

    # ---- user API --------------------------------------------------------

    def add(self, tensor: torch.Tensor) -> SpillableBuffer:
        """Adopt ``tensor`` as spillable cached data.  Starts HOST-side
        (no budget held) -- the first ``use()`` admits it."""
        buf = SpillableBuffer(self, tensor)
        with self._lock:
            self._buffers.append(buf)
        return buf

    def device_bytes(self) -> int:
        with self._lock:
            return sum(b.nbytes for b in self._buffers if not b.spilled)

    def remove(self, buf: SpillableBuffer) -> None:
        """Deregister a buffer, releasing its reservation if resident;
        dropping a resident buffer without this would leak its budget.
        Not a spill: no D2H copy happens and no spill metric is counted —
        the data is being discarded, not staged."""
        with self._lock:
            if not buf.spilled and buf._pins > 0:
                raise RuntimeError("cannot remove a pinned buffer")
            resident = not buf.spilled
            buf._dev = None
            buf._host = None
            if buf in self._buffers:
                self._buffers.remove(buf)
        if resident:
            self._budget.release(buf.nbytes)

    def close(self) -> None:
        """Release every resident buffer and detach from the budget —
        per-query pools must not accumulate on a long-lived budget."""
        with self._lock:
            bufs = list(self._buffers)
        for b in bufs:
            self.remove(b)
        self._budget.unregister_spill_handler(self.spill_until)

    # ---- budget hook -----------------------------------------------------

    def spill_until(self, nbytes: int) -> int:
        """Spill least-recently-used unpinned device buffers until
        ``nbytes`` are freed (or no candidates remain).  Returns freed."""
        freed = 0
        while freed < nbytes:
            with self._lock:
                cands = [b for b in self._buffers
                         if not b.spilled and b._pins == 0]
                if not cands:
                    break
                victim = min(cands, key=lambda b: b._seq)
                freed += self._spill_one(victim)
        return freed

    # ---- internals (pool lock) ------------------------------------------

    def _to_host(self, tensor: torch.Tensor) -> torch.Tensor:
        """A host copy of ``tensor``, pinned when this pool's device is a
        card (so the upload in ``use()`` and the spill copy are DMA)."""
        pin = self.device.type == "cuda"
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=pin)
        host.copy_(tensor)
        return host

    def _spill_one(self, buf: SpillableBuffer) -> int:
        with self._lock:
            if buf.spilled or buf._pins > 0:
                return 0
            task = self._budget.gov.arbiter.task_of(
                threading.get_ident())
            _flight.record(_flight.EV_SPILL_BEGIN, task, value=buf.nbytes)
            t0 = time.monotonic_ns()
            try:
                with _seam.seam(_seam.SPILL, f"spill:{buf.nbytes}B"):
                    buf._host = self._to_host(buf._dev)
            except BaseException:
                # an injected/real spill failure still closes the window
                _flight.record(_flight.EV_SPILL_END, task, detail="error",
                               value=time.monotonic_ns() - t0)
                raise
            _flight.record(_flight.EV_SPILL_END, task,
                           detail=f"{buf.nbytes}B",
                           value=time.monotonic_ns() - t0)
            buf._dev = None
            self.spill_count += 1
            self.spilled_bytes += buf.nbytes
        self._budget.release(buf.nbytes)
        return buf.nbytes

    def _pin(self, buf: SpillableBuffer):
        with self._lock:
            self._clock += 1
            buf._seq = self._clock
            if not buf.spilled:
                buf._pins += 1
                return buf._dev
            host = buf._host
        # HOST -> DEVICE admission, OPTIMISTIC: no per-buffer lock is held
        # across the (possibly blocking) acquire — blocking must happen
        # inside the arbiter where the deadlock watchdog can see and break
        # it.  Two racers may both admit; the loser releases its duplicate
        # reservation immediately (bounded, brief over-reservation instead
        # of a watchdog-invisible Python-lock deadlock).
        # analyze: ignore[resource-lifecycle] - the reservation
        # deliberately outlives _pin: on the winning path its ownership
        # transfers to the buffer's device residency (buf._dev installed
        # below), and _spill_locked / remove() release it when the bytes
        # leave the device — a value-level hand-off the pass's
        # receiver-store escape rule cannot see.  The losing/orphaned
        # paths below release explicitly.
        self._budget.acquire(buf.nbytes)
        try:
            with _seam.seam(_seam.SPILL, f"readmit:{buf.nbytes}B"):
                dev = host.to(self.device)
        except BaseException:
            self._budget.release(buf.nbytes)  # never leak the reservation
            raise
        with self._lock:
            if buf not in self._buffers:
                # remove()/close() raced the unlocked admission above: the
                # buffer is orphaned, so installing _dev would leak this
                # reservation forever (remove() saw it spilled and released
                # nothing; _unpin never releases).  Drop it and fail.
                removed = True
                won = False
            else:
                removed = False
                if buf._dev is None:
                    buf._dev = dev
                    buf._host = None
                    won = True
                else:
                    won = False
                buf._pins += 1
                out = buf._dev
        if not won:
            self._budget.release(buf.nbytes)
        if removed:
            raise RuntimeError("spillable buffer was removed from its pool "
                               "during host->device re-admission")
        return out

    def _unpin(self, buf: SpillableBuffer) -> None:
        with self._lock:
            buf._pins = max(0, buf._pins - 1)
