"""Per-op pipeline phase timing (a framework-neutral copy of the JAX
package's ``obs/phases.py``), and the port's spans on the device trace's
clock.

A hot op that regresses as one opaque number is hard to attribute; callers
therefore read a ``phases_s`` dict per op so a regression points at a
pipeline phase (plan / lanes / gather / emit), not just the total.  Ops
instantiate one module-level :class:`PhaseTimes` and wrap their phases; a
measurement resets, runs one instrumented call, and snapshots.

Timings are host wall clock around the dispatch: on host arms they are the
real phase cost; on device arms they measure enqueue plus any host sync the
phase performs (CUDA work is asynchronous).

Spans: while a ``torch.profiler`` capture runs, every phase, and every
:func:`trace_range` the port opens at a layer boundary, is also a host range
named ``srt.<layer>.<step>``, recorded on the profiler's own clock beside
the device's activity, on whichever thread opened it.  With no capture
running a span costs one read of the profiler's process-wide flag.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["PhaseTimes", "trace_range"]

_OFF = contextlib.nullcontext()

# a range of operator scope: ``torch.profiler.record_function`` opens a user
# annotation instead, which the profiler also copies onto the device's
# timeline as one interval from the first to the last kernel the range
# launched, and a reader of the device's activity would count those as busy
_range = torch._C._profiler._RecordFunctionFast


def trace_range(name: str):
    """A host range ``name`` while a profiler capture runs, else a shared
    no-op context.  The gate is the profiler's process-wide flag: the
    thread-local ``torch.autograd._profiler_enabled()`` reads False on the
    threads a capture records with ``profile_all_threads``."""
    if _autograd_profiler._is_profiler_enabled:
        return _range(name)
    return _OFF


class PhaseTimes:
    """Accumulating named phase timers (thread-safe, reset per measurement).
    Phase ``key`` of timers named ``name`` is also the span
    ``srt.<name>.<key>``."""

    def __init__(self, *keys: str, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._times: Dict[str, float] = {k: 0.0 for k in keys}  # guarded-by: _lock
        self._spans = {k: f"srt.{name}.{k}" for k in keys}

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
            with trace_range(self._spans.get(key) or f"srt.{self.name}.{key}"):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._times[key] = self._times.get(key, 0.0) + dt
