"""Serving metrics: per-session and global counters + latency histograms (a
copy of the JAX package's ``serve/metrics.py``; the profiler hook goes to
the port's ``obs/profiler.Profiler``).

The serving analog of the governor's per-task metrics (RmmSpark.java:533-590
getAndReset* counters): every admission decision and every lifecycle edge of
a request increments a named counter, and queue-wait / run latencies land in
log2-bucketed histograms cheap enough to live on the hot path.

Export path: the same ``obs`` seam the rest of the framework uses — when the
profiler is active, :meth:`ServeMetrics.publish` emits the live counters as
profiler COUNTER records (and the executor's per-request SERVE seam ranges
carry the latencies), so the soak/convert tooling sees serving events in the
same capture stream as op ranges and budget counters.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Optional

from spark_rapids_jni_tpu_torch.obs import flight as _flight

__all__ = ["LatencyHistogram", "ServeMetrics", "percentile_of_counts",
           "BATCH_MISS_REASONS"]


def percentile_of_counts(counts, p: float) -> int:
    """Upper-edge percentile over raw log2 bucket counts — the windowed
    twin of :meth:`LatencyHistogram.percentile_ns` for callers that diff
    two cumulative samples (controller probe windows).  Returns 0 for an
    empty window."""
    total = sum(counts)
    if total == 0:
        return 0
    rank = max(1, int(round(total * p / 100.0)))
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= rank:
            return 1 << (i + 1)
    return 1 << len(counts)  # pragma: no cover - unreachable


class LatencyHistogram:
    """Log2-bucketed latency histogram over nanoseconds.

    Bucket ``i`` counts samples in ``[2^i, 2^(i+1))`` ns; percentile
    estimates take the upper edge of the covering bucket (conservative,
    and exact enough for p50/p99 serving dashboards).  Lock-free reads
    are not needed — every record happens under the owning
    :class:`ServeMetrics` lock.
    """

    NBUCKETS = 64

    def __init__(self):
        self.counts = [0] * self.NBUCKETS
        self.total = 0
        self.sum_ns = 0

    def record(self, ns: int) -> None:
        ns = max(int(ns), 0)
        self.counts[min(max(ns, 1).bit_length() - 1, self.NBUCKETS - 1)] += 1
        self.total += 1
        self.sum_ns += ns

    def percentile_ns(self, p: float) -> int:
        """Upper-edge estimate of the ``p``-th percentile (0 < p <= 100).
        Delegates to :func:`percentile_of_counts` so cumulative and
        windowed (controller probe) percentiles can never diverge."""
        return percentile_of_counts(self.counts, p)

    def mean_ns(self) -> float:
        return self.sum_ns / self.total if self.total else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.total,
            "mean_ms": round(self.mean_ns() / 1e6, 3),
            "p50_ms": round(self.percentile_ns(50) / 1e6, 3),
            "p99_ms": round(self.percentile_ns(99) / 1e6, 3),
        }


# counter names every engine maintains (a fixed vocabulary so dashboards
# and tests never chase typos)
COUNTERS = (
    "submitted",        # requests accepted into the queue
    "rejected_full",    # backpressure: queue at capacity
    "rejected_session", # session cap: working set over the session budget
    "admitted",         # popped by a worker and bracketed into the governor
    "completed",        # handler result delivered
    "failed",           # handler raised a non-protocol error
    "timed_out",        # deadline expired (in queue or between retries)
    "retried",          # RetryOOM re-attempts inside the bracket
    "split_requeued",   # SplitAndRetryOOM -> halves re-queued
    "presplit",         # requests split BEFORE dispatch (controller knob)
    "batched",          # requests that rode a micro-batch launch
    "cancelled",        # queue shut down with the request still waiting
    "protocol_leaked",  # control-flow exception escaped every bracket (bug)
    "hung",             # watchdog flagged a handler past its EWMA bound
    # continuous ragged batching (serve/ragged.py, round 12): the fused
    # page-pool launch path.  launches-saved and occupancy gauges derive
    # from these in the engine's gauge source.
    "ragged_batched",   # riders that rode a fused page-pool launch
    "ragged_launches",  # fused page-pool launches issued
    "ragged_pages",     # pages packed across all launches
    "ragged_rows",      # real rows packed across all launches
    "ragged_row_capacity",  # pool row capacity across all launches
    "ragged_splits",    # SplitAndRetryOOM page-count halvings
    # the governed result cache (plans/rcache.py, round 15) as THIS
    # serving tier saw it: hits short-circuit before the governed
    # bracket (engine) or before dispatch (supervisor); per-tier byte/
    # entry gauges ride the gauge source (rcache_* in snapshots)
    "rcache_hits",      # requests served from the result cache
    "rcache_misses",    # cacheable requests that paid compute
    "rcache_stores",    # computed results inserted into the cache
)

# why a request did NOT merge into a batch (micro or ragged gather) —
# a small counter map rather than COUNTERS entries so dashboards can
# iterate reasons without a fixed schema; the ragged-vs-micro win
# condition ("how much merge opportunity does micro-batching leave on
# the table?") is read directly off this map in serve snapshots and the
# engine's flight telemetry source.
BATCH_MISS_REASONS = (
    "no_batch",          # handler has no batch hooks / is self-governed
    "post_split",        # request is a split product (no_batch flag)
    "disabled",          # micro_batch_max <= 1 (see micro_batch_disabled)
    "handler_mismatch",  # queued candidate serves a different handler
    "cap",               # ride filled to max_batch / pool capacity
)

# supervisor-tier counter vocabulary (serve/supervisor.py): lease and
# executor-process lifecycle plus degradation-ladder admission decisions.
# Kept separate so engine dashboards stay engine-shaped; ServeMetrics
# snapshots merge in whichever of these the owner actually incremented.
SUPERVISOR_COUNTERS = (
    "leases_granted",     # requests dispatched to an executor process
    "leases_redispatched",  # dead/hung executor's leases re-queued
    "leases_completed",   # leases that reached a terminal state
    "duplicate_results",  # late results for an already-completed lease
    "workers_spawned",    # executor processes started (incl. respawns)
    "workers_dead",       # executors declared dead (crash/heartbeat/hung)
    "rejected_degraded",  # submits shed by the degradation ladder
    # the peer-to-peer columnar data plane (serve/shuffle.py, round 13):
    # partition-map lifecycle as the SUPERVISOR sees it (per-transport
    # frame/byte/retry gauges live in each executor's ShuffleService
    # telemetry source)
    "shuffles_started",       # Exchange requests split into map children
    "shuffles_completed",     # partition maps retired (parent terminal)
    "shuffle_produced",       # map tasks that announced partitions
    "shuffle_stale_produces",  # late announcements from recycled
    #                            incarnations, dropped
    "shuffle_acks",           # consumer partition acks recorded
    "shuffle_revivals",       # produce-only re-runs of completed tasks
    #                           whose executor died with the data
    # speculative hedging (round 19): duplicate dispatches of leases
    # sitting past their handler's windowed p99
    "hedges_launched",    # hedge copies dispatched (<= budget frac)
    "hedge_wins",         # hedge result completed the lease first
    "hedge_losses",       # primary won / hedge abandoned (busy, dead)
)


class ServeMetrics:
    """Global + per-session serving counters and latency histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._global: Dict[str, int] = defaultdict(int)  # guarded-by: _lock
        self._per_session: Dict[str, Dict[str, int]] = {}  # guarded-by: _lock
        self.queue_wait = LatencyHistogram()  # guarded-by: _lock
        self.run_latency = LatencyHistogram()  # guarded-by: _lock
        # per-handler run latency: the admission controller's latency-aware
        # presplit probe compares a class's p99 across probe windows, which
        # the single global histogram cannot answer
        self._run_by_handler: Dict[str, LatencyHistogram] = {}  # guarded-by: _lock
        # batch-miss reason -> count (see BATCH_MISS_REASONS)
        self._batch_miss: Dict[str, int] = {}  # guarded-by: _lock
        self._depth = 0  # guarded-by: _lock
        self._gauge_source: Optional[Callable[[], dict]] = None  # guarded-by: _lock
        self._gauge_cache: Dict[str, int] = {}  # guarded-by: _lock
        self._gauge_cache_t = -1e9  # guarded-by: _lock

    def set_gauge_source(self, fn: Optional[Callable[[], dict]]) -> None:
        """Attach a memory-pressure gauge sampler (the engine passes
        governor budget + spill-pool gauges); sampled per snapshot/publish
        so serving telemetry reflects pressure, not just request counts."""
        with self._lock:
            self._gauge_source = fn
            self._gauge_cache_t = -1e9

    def gauges(self, max_age_s: float = 0.0) -> Dict[str, int]:
        """Sample the gauge source.  ``max_age_s`` lets per-request
        publishing reuse a recent sample: the walk behind the sampler
        (pool buffer lists, a native arbiter call per governor) is too
        heavy to repeat for every served request under capture."""
        with self._lock:
            fn = self._gauge_source
            if max_age_s > 0.0 and (
                    time.monotonic() - self._gauge_cache_t) < max_age_s:
                return dict(self._gauge_cache)
        if fn is None:
            return {}
        try:
            g = dict(fn())
        # analyze: ignore[retry-protocol] - gauge sampling during metrics
        # publishing: a failing sampler (governor shut down mid-snapshot)
        # must degrade to "no gauges", never fail the serving hot path
        except Exception:  # noqa: BLE001
            return {}
        with self._lock:
            self._gauge_cache = dict(g)
            self._gauge_cache_t = time.monotonic()
        return g

    # -- recording ----------------------------------------------------------
    def count(self, name: str, session_id: Optional[str] = None,
              n: int = 1) -> None:
        with self._lock:
            self._global[name] += n
            if session_id is not None:
                sess = self._per_session.setdefault(
                    session_id, defaultdict(int))
                sess[name] += n

    def count_batch_miss(self, reason: str, n: int = 1) -> None:
        """One request (or scanned candidate) failed to merge into a
        batch for ``reason`` — the merge-opportunity ledger."""
        with self._lock:
            self._batch_miss[reason] = self._batch_miss.get(reason, 0) + n

    def batch_miss(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._batch_miss)

    def record_wait(self, ns: int) -> None:
        with self._lock:
            self.queue_wait.record(ns)

    def record_run(self, ns: int, handler: Optional[str] = None) -> None:
        with self._lock:
            self.run_latency.record(ns)
            if handler is not None:
                h = self._run_by_handler.get(handler)
                if h is None:
                    h = self._run_by_handler[handler] = LatencyHistogram()
                h.record(ns)

    def handler_latency_counts(self) -> Dict[str, list]:
        """Cumulative per-handler latency bucket counts.  Callers diff two
        samples to get a WINDOWED distribution (the controller's probe
        windows) — the histograms themselves never reset."""
        with self._lock:
            return {h: list(hist.counts)
                    for h, hist in self._run_by_handler.items()}

    def run_latency_counts(self) -> list:
        """The global run-latency bucket counts (a copy, sampled under
        the lock) — the service-wide window the SLO burn-rate engine
        (serve/slo.py) diffs for ``handler="*"`` latency objectives."""
        with self._lock:
            return list(self.run_latency.counts)

    def set_depth(self, depth: int) -> None:
        with self._lock:
            self._depth = depth

    # -- reading ------------------------------------------------------------
    def get(self, name: str, session_id: Optional[str] = None) -> int:
        with self._lock:
            if session_id is not None:
                return self._per_session.get(session_id, {}).get(name, 0)
            return self._global.get(name, 0)

    def snapshot(self) -> dict:
        """One JSON-able dict: global counters, latency summaries, the
        per-session counter tables (the serve_bench emission payload),
        memory-pressure gauges, and the flight recorder's per-task
        arbiter accumulators (retries / blocked-ns, non-destructive)."""
        gauges = self.gauges()
        tasks = {str(t): st for t, st in _flight.task_stats().items()}
        with self._lock:
            counters = {k: self._global.get(k, 0) for k in COUNTERS}
            # supervisor-tier counters appear only when this metrics
            # object belongs to a supervisor (engine snapshots stay
            # engine-shaped, dashboards don't grow dead columns)
            counters.update({k: self._global[k] for k in SUPERVISOR_COUNTERS
                             if k in self._global})
            return {
                "counters": counters,
                "batch_miss": dict(self._batch_miss),
                "queue_depth": self._depth,
                "queue_wait": self.queue_wait.snapshot(),
                "run_latency": self.run_latency.snapshot(),
                # per-handler latency summaries ride every snapshot so
                # the telemetry plane's per-handler dashboard columns
                # (tools/servetop.py) need no second export path
                "handlers": {h: hist.snapshot()
                             for h, hist in self._run_by_handler.items()},
                "sessions": {
                    sid: dict(c) for sid, c in self._per_session.items()
                },
                "gauges": gauges,
                "tasks": tasks,
            }

    def publish(self) -> None:
        """Emit the live global counters + queue depth into the profiler
        capture.  Gated on the seam's lock-free profiler flag first: this
        runs once per served request, and with the profiler detached it
        must cost two attribute reads, not a dozen global-lock no-ops."""
        from spark_rapids_jni_tpu_torch.obs import seam as _seam

        if _seam._profiler_range is None:
            return
        from spark_rapids_jni_tpu_torch.obs.profiler import Profiler

        with self._lock:
            items = [("serve_" + k, v) for k, v in self._global.items()]
            items.append(("serve_queue_depth", self._depth))
        # memory-pressure gauges ride the same capture stream, so the
        # converter's counter tracks show pressure next to request counts
        # (a 0.25s-aged sample is fine for a trace-viewer counter track)
        items.extend(("serve_" + k, int(v))
                     for k, v in self.gauges(max_age_s=0.25).items()
                     if isinstance(v, (int, float)))
        for name, value in items:
            Profiler.counter(name, value)
