"""Governance flight recorder: always-on ring of state-transition events
(a copy of the JAX package's ``obs/flight.py``; the ring is the port's own,
not shared with the JAX package).  The profiler's STATE stream is a deferred
hook, :data:`_profiler_state`, unbound until the port has a profiler.

The reference's only window into its SparkResourceAdaptor state machine is
a CSV transition log the operator must arm *before* the incident
(task_arbiter.cpp log_transition; ``TaskArbiter(log_path=...)`` here) —
after a soak deadlock or a retry storm, "which task was blocked on what,
and what woke it" is unanswerable.  This module is the always-on analog a
production query engine keeps: a bounded, lock-cheap ring buffer of
structured state-transition events fed from every governance layer —

- ``mem/arbiter.py``   blocked/woken around parking calls, retry and
  split-and-retry signal deliveries, deadlock-break verdicts (state_of
  sweeps across ``check_and_break_deadlocks``);
- ``mem/governed.py``  task admission / completion (``task_context``);
- ``mem/spill.py``     spill begin/end with byte counts;
- ``serve/executor.py`` queue rejections/timeouts, split-requeues,
  OOM-killed requests, queue-saturation detection.

Events are tuples appended to a ``collections.deque(maxlen=N)``.  The
hot recording path takes one uncontended leaf lock around the
(sequence-allocate, append) pair — ring order and the round-14 telemetry
cursor's seq order must agree, or a preempted recorder would land a
lower seq after a higher one and every downstream cursor/dedup consumer
would silently drop that event — plus the stats-table lock for four
event kinds only.  When the
SRTP profiler is active each event is additionally streamed into the
capture as a STATE record (format v2, obs/profiler.py), which
``obs/convert.py`` renders as per-task governance tracks aligned with the
op/serve ranges.

On anomaly — deadlock broken, queue saturation, task OOM-killed, watchdog
fire — :func:`anomaly` dumps the full ring plus a unified telemetry
snapshot (every registered source: serve metrics, governor budget gauges,
spill-pool gauges) to a JSON artifact under the ``flight_dump_dir`` config
flag (kept in memory when unset).  ``tools/flightdump.py`` pretty-prints
the reconstructed per-task timeline from such a dump.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from spark_rapids_jni_tpu_torch.obs import seam as _seam

__all__ = [
    "EV_TASK_ADMITTED", "EV_TASK_BLOCKED", "EV_TASK_WOKEN", "EV_RETRY",
    "EV_SPLIT_RETRY", "EV_SPILL_BEGIN", "EV_SPILL_END",
    "EV_DEADLOCK_VERDICT", "EV_QUEUE_REJECT", "EV_QUEUE_TIMEOUT",
    "EV_TASK_DONE", "EV_TASK_KILLED", "EV_ANOMALY",
    "EV_CONTROL_ADJUST", "EV_CONTROL_FREEZE", "EV_CONTROL_PRESPLIT",
    "EV_TASK_HUNG", "EV_DEGRADE_ENTER", "EV_DEGRADE_EXIT",
    "EV_LEASE_GRANT", "EV_LEASE_REDISPATCH", "EV_LEASE_DONE",
    "EV_WORKER_SPAWN", "EV_WORKER_DEAD",
    "EV_RAGGED_PACK", "EV_RAGGED_LAUNCH", "EV_RAGGED_SPLIT",
    "EV_SHUFFLE_PRODUCE", "EV_SHUFFLE_FETCH", "EV_SHUFFLE_RETRY",
    "EV_SHUFFLE_ACK",
    "EV_SPAN_OPEN", "EV_SPAN_CLOSE", "EV_SLO_BURN", "EV_SLO_OK",
    "EV_TELEMETRY_EXPORT", "EV_TELEMETRY_DROP",
    "EV_RCACHE_HIT", "EV_RCACHE_STORE", "EV_RCACHE_DEMOTE",
    "EV_RCACHE_EVICT", "EV_RCACHE_INVALIDATE",
    "EV_PLAN_REWRITE", "EV_ADAPT_EXCHANGE",
    "EV_HEDGE_LAUNCH", "EV_HEDGE_WIN", "EV_HEDGE_LOSE",
    "EV_ATTRIB",
    "EVENT_KINDS", "EVENT_PAIRS", "KIND_IDS", "DUMP_SCHEMA",
    "FlightRecorder", "record", "anomaly", "snapshot", "snapshot_since",
    "task_stats", "task_stat", "ring_stats",
    "register_telemetry_source", "unregister_telemetry_source",
    "unified_snapshot", "recorder",
]

# --------------------------------------------------------------------------
# event-kind vocabulary (wire ids = tuple index; ci/analyze.py's
# flight-discipline pass enforces that emission sites use these constants)
# --------------------------------------------------------------------------

EV_TASK_ADMITTED = "admitted"          # task registered a dedicated thread
EV_TASK_BLOCKED = "blocked"            # thread parked waiting for budget
EV_TASK_WOKEN = "woken"                # parked wait returned (value=wait_ns)
EV_RETRY = "retry"                     # RetryOOM delivered to the thread
EV_SPLIT_RETRY = "split_retry"         # SplitAndRetryOOM / split-requeue
EV_SPILL_BEGIN = "spill_begin"         # D2H staging starts (value=nbytes)
EV_SPILL_END = "spill_end"             # D2H staging done (value=dur_ns)
EV_DEADLOCK_VERDICT = "deadlock_verdict"  # watchdog escalated a thread
EV_QUEUE_REJECT = "queue_reject"       # admission backpressure rejection
EV_QUEUE_TIMEOUT = "queue_timeout"     # deadline expired while queued
EV_TASK_DONE = "task_done"             # task deregistered cleanly
EV_TASK_KILLED = "task_killed"         # task failed terminally on OOM
EV_ANOMALY = "anomaly"                 # a dump was triggered (detail=reason)
# admission-controller decision ledger (serve/controller.py): every knob
# adjustment, freeze transition, and pre-emptive split lands in the ring so
# tools/flightdump.py can reconstruct WHY the admission posture changed
EV_CONTROL_ADJUST = "control_adjust"   # knob changed (detail=knob:old->new
#                                        :reason, value=new scaled)
EV_CONTROL_FREEZE = "control_freeze"   # kill-switch froze (value=1) /
#                                        resumed (value=0) the controller
EV_CONTROL_PRESPLIT = "control_presplit"  # request split BEFORE dispatch
#                                        (detail=handler:pieces)
# crash-only serving (serve/supervisor.py, round 10): the supervisor's
# lease table, executor-process lifecycle, and degradation ladder all
# narrate into the ring so a cross-process incident is reconstructable
# from the per-process dumps (tools/flightdump.py --cluster)
EV_TASK_HUNG = "task_hung"             # handler exceeded its EWMA hang
#                                        bound (value=elapsed_ns)
EV_DEGRADE_ENTER = "degrade_enter"     # ladder stepped DOWN a level
#                                        (detail=level name, value=level)
EV_DEGRADE_EXIT = "degrade_exit"       # ladder recovered UP a level
#                                        (detail=level name, value=level)
EV_LEASE_GRANT = "lease_grant"         # request leased to an executor
#                                        (detail=rid:<id>:worker:<wid>...)
EV_LEASE_REDISPATCH = "lease_redispatch"  # dead/hung executor's lease
#                                        re-queued to survivors
EV_LEASE_DONE = "lease_done"           # lease reached a terminal state
#                                        (detail=rid:<id>:...:status)
EV_WORKER_SPAWN = "worker_spawn"       # executor process (re)started
#                                        (detail=worker:<wid>:inc:<n>:pid)
EV_WORKER_DEAD = "worker_dead"         # executor declared dead (crashed,
#                                        heartbeat-lost, or hung-recycled)
# continuous ragged batching (serve/ragged.py, round 12): every fused
# page-pool tick narrates pack -> launch (-> split) into the ring, so a
# pressure incident shows WHICH riders shared a launch and how the page
# count walked down under SplitAndRetryOOM
EV_RAGGED_PACK = "ragged_pack"         # riders packed into the page pool
#                                        (detail=handler:<h>:riders:<n>
#                                        :pages:<p>, value=rows packed)
EV_RAGGED_LAUNCH = "ragged_launch"     # one fused page-pool launch
#                                        (detail=handler:<h>:geom:<g>,
#                                        value=rows packed)
EV_RAGGED_SPLIT = "ragged_split"       # page-count halving on
#                                        SplitAndRetryOOM (detail=
#                                        handler:<h>:riders:<n>:pages:
#                                        <from>-><to>, value=new depth)
# crash-safe columnar shuffle (serve/shuffle.py, round 13): the
# peer-to-peer data plane narrates map-side production, every framed
# partition fetch (with its source path), every transport retry (CRC
# mismatch, truncation, stalled peer, refused connection), and the
# consumer acks the supervisor's partition map tracks — detail tokens
# carry rid:/sid:/part: so flightdump --cluster can stitch partition
# lineage across executor processes
EV_SHUFFLE_PRODUCE = "shuffle_produce"  # map task's partitions framed +
#                                        stored (detail=rid:<r>:sid:<s>:
#                                        map:<m>:parts:<n>, value=bytes)
EV_SHUFFLE_FETCH = "shuffle_fetch"      # one partition fetched + CRC-
#                                        verified (detail=rid:<r>:sid:<s>
#                                        :from:<k>:part:<p>:src:<how>,
#                                        value=bytes)
EV_SHUFFLE_RETRY = "shuffle_retry"      # fetch attempt failed, backing
#                                        off (detail=...:reason:<why>)
EV_SHUFFLE_ACK = "shuffle_ack"          # consumer acked a fetched
#                                        partition into the supervisor's
#                                        partition map (detail=rid:<r>:
#                                        sid:<s>:from:<k>:part:<p>)
# the live telemetry plane (round 14, obs/trace.py + serve/telemetry.py
# + serve/slo.py): distributed request spans, continuous export, and the
# SLO burn-rate engine all narrate into the ring like every other layer
EV_SPAN_OPEN = "span_open"              # request phase span opened
#                                        (detail=rid:<r>:span:<s>:parent:
#                                        <p>:kind:<queue|dispatch|
#                                        transport|compute|scatter>...;
#                                        emitted ONLY by obs/trace.py)
EV_SPAN_CLOSE = "span_close"            # span closed (same detail
#                                        tokens, value=duration ns)
EV_SLO_BURN = "slo_burn"                # an objective entered burn
#                                        (detail=slo:<name>:obj:<kind>:
#                                        burn:<x>, value=burn x1000)
EV_SLO_OK = "slo_ok"                    # the objective recovered
EV_TELEMETRY_EXPORT = "telemetry_export"  # a worker's export stream came
#                                        up (first delta shipped;
#                                        value=events in the delta)
EV_TELEMETRY_DROP = "telemetry_drop"    # an export was skipped (stalled
#                                        supervisor pipe) or trimmed
#                                        (delta over the cap) — the
#                                        worker NEVER blocks on export
# the governed multi-tier result cache (round 15, plans/rcache.py +
# models/tables.py): every hit/store, every residency move down the
# HBM -> host -> disk ladder, and every table-version invalidation
# narrates into the ring, so "why did this query skip compute" and
# "where did the cache's bytes go under pressure" reconstruct from the
# same artifact as the retry storm that squeezed them
EV_RCACHE_HIT = "rcache_hit"            # result served from the cache
#                                        (detail=[rid:<r>:]handler:<h>:
#                                        tier:<hbm|host|disk>:key:<tok>,
#                                        value=result bytes)
EV_RCACHE_STORE = "rcache_store"        # result inserted (detail=
#                                        handler:<h>:tier:<t>:key:<tok>,
#                                        value=result bytes)
EV_RCACHE_DEMOTE = "rcache_demote"      # entry moved down one tier
#                                        (detail=key:<tok>:<from>-><to>:
#                                        reason:<pressure|cap>,
#                                        value=bytes moved)
EV_RCACHE_EVICT = "rcache_evict"        # entry dropped entirely (detail=
#                                        key:<tok>:tier:<t>:reason:
#                                        <cap|corrupt|stale>, value=bytes)
EV_RCACHE_INVALIDATE = "rcache_invalidate"  # a table-version bump made
#                                        entries unreachable (detail=
#                                        table:<name>:version:<v>,
#                                        value=new version; emitted by
#                                        models/tables.py per bump and
#                                        by the cache per reclaimed key)
# the stats-driven optimizer + adaptive execution (round 19,
# plans/optimizer.py + serve/shuffle.py + serve/supervisor.py): every
# plan rewrite, every runtime reduce-side Exchange decision, and every
# speculative hedge narrates into the ring, so "why did this plan's
# shape change" and "which dispatch was a hedge copy" reconstruct from
# the same artifact as everything else (flightdump --control renders
# the decision ledger)
EV_PLAN_REWRITE = "plan_rewrite"        # optimizer applied one rewrite
#                                        (detail=plan:<name>:rule:<rule>
#                                        :node:<type>, value=pass no.) or
#                                        summary (rule:done, value=total)
EV_ADAPT_EXCHANGE = "adapt_exchange"    # reduce side picked its shape at
#                                        runtime (detail=rid:<r>:sid:<s>:
#                                        strategy:<broadcast|coalesce|
#                                        shuffle>:parts:<from>-><to>,
#                                        value=total exchange bytes)
EV_HEDGE_LAUNCH = "hedge_launch"        # lease sat past its handler's
#                                        windowed p99: hedge copy sent
#                                        (detail=rid:<r>:worker:<w>:inc:
#                                        <i>:handler:<h>, value=age_ns)
EV_HEDGE_WIN = "hedge_win"              # the hedge copy's result
#                                        completed the lease first
#                                        (detail=rid:<r>:worker:<w>)
EV_HEDGE_LOSE = "hedge_lose"            # the primary finished first (or
#                                        the hedge aborted): hedge copy's
#                                        result will be duplicate-dropped
#                                        (detail=rid:<r>:reason:<why>)
# per-request resource attribution (round 21, serve/attribution.py): one
# event per terminal request carrying the full AttributionRecord — what
# the supervisor's per-tenant rollup and the capacity observatory fold.
# Detail grammar: ``rid:<r>:tenant:<t>:handler:<h>:comp:<ns>`` always,
# then nonzero-only ``gbs:<byte_ns>:q:<ns>:blk:<ns>:tx:<bytes>:
# res:<bytes>:hit:<n>:miss:<n>:retry:<n>:split:<n>`` tokens, and
# ``flags:<a+b>`` (``split``/``cache``/``hedge``) last; value=comp ns.
# Tenant and handler names must not contain ':'.
EV_ATTRIB = "attrib"

# Paired kinds: a layer that emits the left side of a pair must also emit
# the right side (module-granular balance, enforced by the analyze gate's
# state-machine pass) — the drift class where one side of a bracket
# protocol is dropped and every reconstruction silently loses its spans.
EVENT_PAIRS = (
    (EV_TASK_BLOCKED, EV_TASK_WOKEN),
    (EV_TASK_ADMITTED, EV_TASK_DONE),
    (EV_SPILL_BEGIN, EV_SPILL_END),
    (EV_DEGRADE_ENTER, EV_DEGRADE_EXIT),
    (EV_LEASE_GRANT, EV_LEASE_DONE),
    (EV_SHUFFLE_PRODUCE, EV_SHUFFLE_ACK),
    # round 14: a module opening spans must close them, and an SLO layer
    # that can declare burn must be able to declare recovery — both sides
    # live in one module (obs/trace.py, serve/slo.py) by construction
    (EV_SPAN_OPEN, EV_SPAN_CLOSE),
    (EV_SLO_BURN, EV_SLO_OK),
)

EVENT_KINDS = (
    EV_TASK_ADMITTED, EV_TASK_BLOCKED, EV_TASK_WOKEN, EV_RETRY,
    EV_SPLIT_RETRY, EV_SPILL_BEGIN, EV_SPILL_END, EV_DEADLOCK_VERDICT,
    EV_QUEUE_REJECT, EV_QUEUE_TIMEOUT, EV_TASK_DONE, EV_TASK_KILLED,
    EV_ANOMALY,
    # round 9: appended (never reordered) so v2 STATE wire ids stay stable
    EV_CONTROL_ADJUST, EV_CONTROL_FREEZE, EV_CONTROL_PRESPLIT,
    # round 10: appended for the same reason
    EV_TASK_HUNG, EV_DEGRADE_ENTER, EV_DEGRADE_EXIT,
    EV_LEASE_GRANT, EV_LEASE_REDISPATCH, EV_LEASE_DONE,
    EV_WORKER_SPAWN, EV_WORKER_DEAD,
    # round 12: appended (wire ids frozen in ci/flight_wire_ids.json)
    EV_RAGGED_PACK, EV_RAGGED_LAUNCH, EV_RAGGED_SPLIT,
    # round 13: appended for the same reason
    EV_SHUFFLE_PRODUCE, EV_SHUFFLE_FETCH, EV_SHUFFLE_RETRY, EV_SHUFFLE_ACK,
    # round 14: appended for the same reason
    EV_SPAN_OPEN, EV_SPAN_CLOSE, EV_SLO_BURN, EV_SLO_OK,
    EV_TELEMETRY_EXPORT, EV_TELEMETRY_DROP,
    # round 15: appended for the same reason
    EV_RCACHE_HIT, EV_RCACHE_STORE, EV_RCACHE_DEMOTE,
    EV_RCACHE_EVICT, EV_RCACHE_INVALIDATE,
    # round 19: appended for the same reason
    EV_PLAN_REWRITE, EV_ADAPT_EXCHANGE,
    EV_HEDGE_LAUNCH, EV_HEDGE_WIN, EV_HEDGE_LOSE,
    # round 21: appended for the same reason
    EV_ATTRIB,
)
KIND_IDS = {k: i for i, k in enumerate(EVENT_KINDS)}

DUMP_SCHEMA = "srt-flight-dump-v1"

# per-task accumulators kept for at most this many distinct tasks (oldest
# evicted); sized above any realistic live-task count, below leak territory
_MAX_TASKS = 1024


def _dump_min_interval_s() -> float:
    """One dump per (reason) per this many seconds — a retry storm must
    produce one artifact, not thousands.  Config-tunable (round 14,
    ``flight_dump_rate_s``): chaos tiers tighten it to see every
    incident; fleets widen it to bound artifact churn."""
    from spark_rapids_jni_tpu_torch import config

    return float(config.get("flight_dump_rate_s"))


# the profiler's STATE record sink, ``Profiler.state(kind_id, task_id,
# detail, value, t_ns=, tid=)`` in the JAX package: unbound (None) until the
# port has a profiler, so an active profiler range streams no state records
_profiler_state: Optional[Callable[..., None]] = None


class FlightRecorder:
    """Bounded ring of governance events + per-task accumulators."""

    def __init__(self, ring_size: Optional[int] = None):
        if ring_size is None:
            from spark_rapids_jni_tpu_torch import config

            ring_size = int(config.get("flight_ring_size"))
        self._ring: "collections.deque" = collections.deque(maxlen=ring_size)
        # monotonically increasing per-event sequence: the telemetry
        # exporter's cursor (serve/telemetry.py snapshot_since).  Seq
        # allocation and the append must be ONE atomic step — a thread
        # preempted between them would land a lower seq AFTER a higher
        # one, and every cursor/high-water consumer downstream would
        # silently drop that event forever — so the ring append takes a
        # dedicated leaf lock (an uncontended CPython lock is tens of
        # ns; the stats table below keeps its own lock, touched for four
        # kinds only)
        self._ev_seq = itertools.count(1)
        self._ring_lock = threading.Lock()
        # wrap-around loss ledger: every append that evicted the oldest
        # event (satellite, round 21) — completeness claims (waterfall
        # fractions, attribution coverage) can then STATE how many
        # events the ring dropped instead of silently presenting a
        # truncated history as complete
        self.ring_dropped = 0  # guarded-by: _ring_lock
        self._stats_lock = threading.Lock()
        self._tasks: "collections.OrderedDict" = collections.OrderedDict()
        self._sources: Dict[str, Callable[[], dict]] = {}
        self._sources_lock = threading.Lock()
        self._dump_lock = threading.Lock()
        self._last_dump_t: Dict[str, float] = {}
        self._dump_seq = 0
        self.dumps: List[dict] = []          # last few dumps, newest last
        self.dump_count = 0
        self.dumps_suppressed = 0

    # -- recording (the hot path) ------------------------------------------
    def record(self, kind: str, task_id: int = -1, detail: str = "",
               value: int = 0) -> None:
        t_ns = time.monotonic_ns()
        tid = threading.get_ident() & 0xFFFFFFFF
        # seq allocation + append under one leaf lock: ring order and
        # seq order must agree (see _ring_lock above)
        with self._ring_lock:
            if (self._ring.maxlen is not None
                    and len(self._ring) == self._ring.maxlen):
                self.ring_dropped += 1
            self._ring.append((next(self._ev_seq), t_ns, kind, task_id,
                               tid, detail, value))
        if task_id >= 0 and kind in _STAT_KINDS:
            with self._stats_lock:
                st = self._tasks.get(task_id)
                if st is None:
                    if len(self._tasks) >= _MAX_TASKS:
                        self._tasks.popitem(last=False)
                    st = self._tasks[task_id] = {
                        "retries": 0, "split_retries": 0,
                        "blocked_ns": 0, "wakes": 0, "killed": 0,
                    }
                if kind == EV_RETRY:
                    st["retries"] += 1
                elif kind == EV_SPLIT_RETRY:
                    st["split_retries"] += 1
                elif kind == EV_TASK_WOKEN:
                    st["wakes"] += 1
                    st["blocked_ns"] += max(int(value), 0)
                elif kind == EV_TASK_KILLED:
                    st["killed"] += 1
        if _seam._profiler_range is not None and _profiler_state is not None:
            _profiler_state(KIND_IDS[kind], task_id, detail, value,
                           t_ns=t_ns, tid=tid)

    # -- reading -----------------------------------------------------------
    def snapshot(self) -> List[dict]:
        """The ring as event dicts, oldest first (a point-in-time copy)."""
        return [
            {"seq": seq, "t_ns": t, "kind": k, "task_id": task, "tid": tid,
             "detail": d, "value": v}
            for seq, t, k, task, tid, d, v in list(self._ring)
        ]

    def snapshot_since(self, cursor: int) -> Tuple[List[dict], int]:
        """Events with ``seq > cursor`` plus the new cursor — the rolling
        delta the telemetry plane exports (serve/telemetry.py).  A caller
        that falls further behind than the ring's capacity simply misses
        the overwritten prefix: the ring is the retention bound, and the
        gap is visible as non-contiguous ``seq`` values downstream.

        O(delta), not O(ring): the scan walks backward under the ring
        lock and stops at the cursor — per-request force-flushes must
        not pay a full-ring copy for a handful of new events."""
        newest: List[tuple] = []
        with self._ring_lock:
            for item in reversed(self._ring):
                if item[0] <= cursor:
                    break
                newest.append(item)
        newest.reverse()
        events = [
            {"seq": seq, "t_ns": t, "kind": k, "task_id": task, "tid": tid,
             "detail": d, "value": v}
            for seq, t, k, task, tid, d, v in newest
        ]
        return events, (events[-1]["seq"] if events else cursor)

    def task_stats(self) -> Dict[int, dict]:
        """Per-task accumulators (non-destructive, unlike the arbiter's
        get-and-reset metrics — safe to sample from any dump/publish)."""
        with self._stats_lock:
            return {task: dict(st) for task, st in self._tasks.items()}

    def task_stat(self, task_id: int) -> Optional[dict]:
        """ONE task's accumulators (or None) — O(1), unlike task_stats'
        full-table copy: the attribution finish path samples blocked-ns
        and retry counts per request, and must not pay _MAX_TASKS dict
        copies on every completion."""
        with self._stats_lock:
            st = self._tasks.get(task_id)
            return dict(st) if st is not None else None

    def ring_stats(self) -> dict:
        """The ring's retention ledger: capacity, occupancy, and how
        many events wrap-around has evicted since start/reset."""
        with self._ring_lock:
            return {"capacity": self._ring.maxlen or 0,
                    "events": len(self._ring),
                    "dropped": self.ring_dropped}

    # -- telemetry sources -------------------------------------------------
    def register_telemetry_source(self, name: str,
                                  fn: Callable[[], dict]) -> None:
        with self._sources_lock:
            self._sources[name] = fn

    def unregister_telemetry_source(self, name: str) -> None:
        with self._sources_lock:
            self._sources.pop(name, None)

    def unified_snapshot(self) -> dict:
        """Every registered telemetry source, sampled now.  A failing
        source becomes an ``{"error": ...}`` entry — a dump taken mid-crash
        must never itself crash."""
        with self._sources_lock:
            sources = dict(self._sources)
        out = {}
        for name, fn in sources.items():
            try:
                out[name] = fn()
            # analyze: ignore[retry-protocol] - dump-time sampling of user
            # gauge callables: any failure (a closed engine, a shut-down
            # governor) is reported in-band, never propagated out of the
            # anomaly path
            except Exception as e:  # noqa: BLE001
                out[name] = {"error": repr(e)[:200]}
        return out

    # -- anomaly dumps -----------------------------------------------------
    def anomaly(self, reason: str, detail: str = "") -> Optional[dict]:
        """Record an ANOMALY event and dump ring + telemetry.

        Returns the dump dict, or None when rate-limited (one dump per
        reason per second — a storm produces one artifact, counted).
        """
        self.record(EV_ANOMALY, -1, f"{reason}:{detail}" if detail
                    else reason)
        now = time.monotonic()
        min_interval = _dump_min_interval_s()
        with self._dump_lock:
            last = self._last_dump_t.get(reason, -1e9)
            if now - last < min_interval:
                self.dumps_suppressed += 1
                return None
            self._last_dump_t[reason] = now
            self._dump_seq += 1
            seq = self._dump_seq
        dump = {
            "schema": DUMP_SCHEMA,
            "reason": reason,
            "detail": detail,
            # pid + paired (wall, monotonic) stamps let the --cluster merge
            # align per-process monotonic event times on one wall clock
            "pid": os.getpid(),
            "wall_time_s": time.time(),
            "t_ns": time.monotonic_ns(),
            "events": self.snapshot(),
            "ring": self.ring_stats(),
            "tasks": {str(k): v for k, v in self.task_stats().items()},
            "telemetry": self.unified_snapshot(),
        }
        self.dumps.append(dump)
        del self.dumps[:-4]  # keep the newest few in memory
        self.dump_count += 1
        path = self._write_dump(dump, reason, seq)
        if path:
            dump["artifact"] = path
        return dump

    def _write_dump(self, dump: dict, reason: str, seq: int) -> str:
        from spark_rapids_jni_tpu_torch import config

        d = str(config.get("flight_dump_dir") or "")
        if not d:
            return ""
        try:
            os.makedirs(d, exist_ok=True)
            path = os.path.join(
                d, f"flight_{reason}_{os.getpid()}_{seq}.json")
            with open(path, "w") as f:
                json.dump(dump, f, indent=1, sort_keys=True)
                f.write("\n")
            return path
        except OSError:
            return ""  # an unwritable dump dir must not break governance

    def reset_for_tests(self) -> None:
        with self._ring_lock:
            self._ring.clear()
            self.ring_dropped = 0
        with self._stats_lock:
            self._tasks.clear()
        with self._dump_lock:
            self._last_dump_t.clear()
        self.dumps = []
        self.dump_count = 0
        self.dumps_suppressed = 0


_STAT_KINDS = frozenset({EV_RETRY, EV_SPLIT_RETRY, EV_TASK_WOKEN,
                         EV_TASK_KILLED})

# --------------------------------------------------------------------------
# module-level singleton facade (the always-on recorder every layer feeds)
# --------------------------------------------------------------------------

_RECORDER = FlightRecorder()


def recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, task_id: int = -1, detail: str = "",
           value: int = 0) -> None:
    _RECORDER.record(kind, task_id, detail, value)


def anomaly(reason: str, detail: str = "") -> Optional[dict]:
    return _RECORDER.anomaly(reason, detail)


def snapshot() -> List[dict]:
    return _RECORDER.snapshot()


def snapshot_since(cursor: int) -> Tuple[List[dict], int]:
    return _RECORDER.snapshot_since(cursor)


def task_stats() -> Dict[int, dict]:
    return _RECORDER.task_stats()


def task_stat(task_id: int) -> Optional[dict]:
    return _RECORDER.task_stat(task_id)


def ring_stats() -> dict:
    return _RECORDER.ring_stats()


def register_telemetry_source(name: str, fn: Callable[[], dict]) -> None:
    _RECORDER.register_telemetry_source(name, fn)


def unregister_telemetry_source(name: str) -> None:
    _RECORDER.unregister_telemetry_source(name)


def unified_snapshot() -> dict:
    return _RECORDER.unified_snapshot()
