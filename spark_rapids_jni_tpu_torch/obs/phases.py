"""Per-op pipeline phase timing (a framework-neutral copy of the JAX
package's ``obs/phases.py``).

A hot op that regresses as one opaque number is hard to attribute; callers
therefore read a ``phases_s`` dict per op so a regression points at a
pipeline phase (plan / lanes / gather / emit), not just the total.  Ops
instantiate one module-level :class:`PhaseTimes` and wrap their phases; a
measurement resets, runs one instrumented call, and snapshots.

Timings are host wall clock around the dispatch: on host arms they are the
real phase cost; on device arms they measure enqueue plus any host sync the
phase performs (CUDA work is asynchronous).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

__all__ = ["PhaseTimes"]


class PhaseTimes:
    """Accumulating named phase timers (thread-safe, reset per measurement)."""

    def __init__(self, *keys: str):
        self._lock = threading.Lock()
        self._times: Dict[str, float] = {k: 0.0 for k in keys}  # guarded-by: _lock

    def reset(self) -> None:
        with self._lock:
            for k in self._times:
                self._times[k] = 0.0

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._times)

    @contextlib.contextmanager
    def phase(self, key: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._times[key] = self._times.get(key, 0.0) + dt
