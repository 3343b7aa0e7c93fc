"""Compiled-plan cache: one built executor per (plan, mesh, input signature)
(PyTorch port of ``plans/cache.py``).

- The key is ``(plan value, mesh, input signature)``, plus the device for a
  local plan.  The input signature is the tuple of (table, field, dtype,
  padded length) that the executor uploads; lengths come quantized onto the
  pow2 bucket lattice (``parallel.shuffle.quantized_rows``), so
  data-dependent row counts collapse onto O(log rows) entries.
- Plans are frozen dataclasses built through :func:`plans.ir.lit`, which
  normalizes numpy scalars, so equal geometry never builds two unequal keys.
- Hit, miss, trace, eviction and execute counters, with the cumulative
  build and execute seconds, are read through :meth:`PlanCache.stats`.
  While a profiler capture runs, each build is the span ``srt.plan.build``.

Entries are LRU-bounded by the ``plan_cache_size`` flag (``config.py``, 64
by default), unless a cache is built with its own ``maxsize``.  The
process-global cache's counters are the flight recorder's ``plan_cache``
telemetry source, so anomaly dumps show compile churn beside governance.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.obs.phases import trace_range

__all__ = ["CompiledPlan", "PlanCache", "plan_cache"]


class CompiledPlan:
    """One cached executor: the callable over the flat inputs plus its call
    metadata.  ``device`` is where its inputs must lie (the mesh's device
    under a mesh)."""

    __slots__ = ("fn", "plan", "mesh", "signature", "out_names", "arg_names", "device")

    def __init__(self, fn, plan, mesh, signature, out_names, arg_names, device=None):
        self.fn = fn
        self.plan = plan
        self.mesh = mesh
        self.signature = signature
        self.out_names = out_names
        self.arg_names = arg_names
        self.device = device


class PlanCache:
    """Process-global LRU of :class:`CompiledPlan` + counters."""

    def __init__(self, maxsize: Optional[int] = None):
        self._fixed_maxsize = maxsize
        self._lock = threading.RLock()
        # the LRU table + its counters: every access below goes through
        # _lock, so stats() readers never see a half-updated eviction
        self._entries: "collections.OrderedDict" = \
            collections.OrderedDict()  # guarded-by: _lock
        self._building: Dict[Tuple, threading.Event] = {}  # guarded-by: _lock
        self._stats: Dict[str, float] = {  # guarded-by: _lock
            "hits": 0, "misses": 0, "evictions": 0, "build_s": 0.0,
            "execute_calls": 0, "execute_s": 0.0,
        }

    @property
    def _maxsize(self) -> int:
        """The LRU bound: this cache's own ``maxsize``, else the
        ``plan_cache_size`` flag, read at each eviction."""
        if self._fixed_maxsize is not None:
            return self._fixed_maxsize
        return int(config.get("plan_cache_size"))

    def get_or_compile(self, key: Tuple,
                       build: Callable[[], CompiledPlan]) -> CompiledPlan:
        """Return the cached executor for ``key``, building it on a miss.
        Builds are deduplicated PER KEY, not by holding the cache lock across
        the build: a concurrent same-key request waits for the one in-flight
        build, while different keys build in parallel and hits and stats()
        never stall behind someone else's build."""
        while True:
            with self._lock:
                hit = self._entries.get(key)
                if hit is not None:
                    self._entries.move_to_end(key)
                    self._stats["hits"] += 1
                    return hit
                ev = self._building.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._building[key] = ev
                    break  # we own this build
            # same-key build in flight: wait, then re-check (the owner may
            # have failed, in which case the next iteration claims the build)
            ev.wait()
        try:
            t0 = time.perf_counter()
            with trace_range("srt.plan.build"):
                entry = build()
            dt = time.perf_counter() - t0
        except BaseException:
            with self._lock:
                del self._building[key]
            ev.set()
            raise
        with self._lock:
            del self._building[key]
            self._stats["misses"] += 1
            self._stats["build_s"] += dt
            self._entries[key] = entry
            while len(self._entries) > max(self._maxsize, 1):
                self._entries.popitem(last=False)
                self._stats["evictions"] += 1
        ev.set()
        return entry

    def record_execute(self, seconds: float) -> None:
        with self._lock:
            self._stats["execute_calls"] += 1
            self._stats["execute_s"] += seconds

    def stats(self) -> Dict[str, Any]:
        """Counter snapshot (JSON-able).  ``traces`` mirrors ``misses``:
        every miss is exactly one build of an executor -- the number a
        retrace-stability test watches."""
        with self._lock:
            out = dict(self._stats)
            out["entries"] = len(self._entries)
            out["traces"] = out["misses"]
            for k in ("build_s", "execute_s"):
                out[k] = round(out[k], 6)
            return out

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def reset_stats(self) -> None:
        with self._lock:
            for k in self._stats:
                self._stats[k] = 0 if isinstance(self._stats[k], int) else 0.0


#: the process-global cache every plan-compiled query shares
plan_cache = PlanCache()

# anomaly dumps carry the cache's counters next to serve and governor gauges
_flight.register_telemetry_source("plan_cache", plan_cache.stats)
