"""The framework dispatch seam: one instrumentation point for every op call
(a copy of the JAX package's ``obs/seam.py``; the port's own sinks).

The reference hooks its observability and chaos tooling into the CUDA API
boundary from outside the op code (CUPTI subscriber for the profiler,
ProfilerJni.cpp:437; CUDA_INJECTION64_PATH driver hook for fault injection,
faultinj/faultinj.cu).  The equivalent boundary here is the public op
dispatch: every call to an instrumented op/transfer/collective passes through
:func:`seam`, which consults the fault injector (may raise) and the profiler
(records a range).  When neither is active the overhead is two module-flag
checks.

Categories mirror the activity kinds the reference captures: ``op`` (kernel
launches), ``transfer`` (host<->device movement), ``collective`` (multi-chip
exchange), ``alloc`` (memory governance), ``spill`` (host-staging traffic,
mem/spill.py — the reference profiles its spill store's device<->host copies
the same way, as MEMCPY activity), ``compile`` (step build / XLA
compilation — the reference's CUPTI hook sees module loads the same way,
and its CUDA-API injector can fail them, faultinj.cu:32).

The ``transfer``/``collective``/``compile`` crossings sit BENEATH the op
layer, in the runtime paths of the distributed models (batch upload, step
launch, step build), so chaos can simulate a failing device transfer, a
wedged collective, or a failed compile mid-governed-query — the failure
modes the CUPTI-level injector reaches in the reference.

The ``serve`` crossing sits ABOVE the op layer, around each admitted
request's handler execution in the serving engine (serve/executor.py) —
inside the retry bracket, so an injected RetryOOM/SplitAndRetryOOM at this
seam drives the same protocol a mid-query device fault does, and the
profiler sees one range per served request.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Optional

__all__ = ["seam", "instrument", "OP", "TRANSFER", "COLLECTIVE", "ALLOC",
           "SPILL", "COMPILE", "SERVE", "SHUFFLE"]

OP = "op"
TRANSFER = "transfer"
COLLECTIVE = "collective"
ALLOC = "alloc"
SPILL = "spill"
COMPILE = "compile"
SERVE = "serve"
# the cross-process columnar data plane (serve/shuffle.py): every framed
# partition send crosses this category, so chaos can corrupt, truncate, or
# stall the transport the way libcufaultinj corrupts a UCX hand-off
SHUFFLE = "shuffle"

# registered sinks; None = inactive (checked without locks on the hot path)
_injector: Optional[Callable[[str, str], None]] = None  # may raise
_profiler_range: Optional[Callable[[str, str], "contextlib.AbstractContextManager"]] = None
# category -> threading.Lock held across the crossing; None = inactive.
# The serving engine installs {COLLECTIVE: lock}: the single-process CPU
# collective runtime wedges when two threads launch rendezvous programs
# concurrently, so multi-threaded serving serializes collective launches
# HERE — beneath every model runner's budget reservation, which keeps the
# lock order (budget, then launch) acyclic by construction.
_serializers: Optional[dict] = None
_install_lock = threading.Lock()


def _set_injector(fn: Optional[Callable[[str, str], None]]) -> None:
    global _injector
    _injector = fn


def _set_profiler(fn) -> None:
    global _profiler_range
    _profiler_range = fn


def serialize_category(category: str) -> None:
    """Install (idempotently) a crossing lock for ``category``.

    Reentrant: a launch crossing (``seam(COLLECTIVE, "launch:...")``)
    re-enters on the same thread when the step traces through an
    ``@instrument(COLLECTIVE, ...)``-wrapped collective at compile time.
    The read-modify-write is guarded: two engines constructed
    concurrently must end up sharing ONE lock per category, or the
    serialization this exists for is void.
    """
    global _serializers
    with _install_lock:
        cur = dict(_serializers or {})
        if category not in cur:
            cur[category] = threading.RLock()
        _serializers = cur


@contextlib.contextmanager
def seam(category: str, name: str):
    """Cross the instrumented dispatch boundary."""
    inj = _injector
    if inj is not None:
        inj(category, name)  # may raise an injected fault
    sers = _serializers
    lock = sers.get(category) if sers is not None else None
    prof = _profiler_range
    if lock is None:
        if prof is None:
            yield
            return
        with prof(category, name):
            yield
        return
    with lock:
        if prof is None:
            yield
            return
        with prof(category, name):
            yield


def instrument(category: str, name: str):
    """Decorator form: wrap a callable in the dispatch seam."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if (_injector is None and _profiler_range is None
                    and _serializers is None):
                return fn(*args, **kwargs)
            with seam(category, name):
                return fn(*args, **kwargs)

        wrapped.__srt_seam__ = (category, name)
        return wrapped

    return deco
