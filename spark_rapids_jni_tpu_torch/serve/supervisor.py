"""Crash-only serving: supervised multi-process failure domains (a copy of
the JAX package's ``serve/supervisor.py``; its workers are the port's
``serve/rpc.py`` executor processes, on the card unless their
``worker_cfg["device"]`` asks for the CPU).  One departure: each worker's
pipe gets wide socket buffers (:data:`PIPE_BUFFER_BYTES`), because shuffle
shards cross it whole.

The reference's ``SparkResourceAdaptor`` arbitrates memory *within* one
executor; Spark's actual resilience lives one layer up, where the driver
watches executors and re-dispatches the tasks of any that die.  This
module is that layer for the serve tier: a **router/supervisor** that owns
sessions and the admission queue, over **N executor worker processes**
(serve/rpc.py) each running its own :class:`ServingEngine` on its own
memory governor — separate failure domains, nothing shared but pipes.

Three mechanisms make it crash-only (processes are only ever killed and
respawned, never coaxed back to health):

- **Heartbeat/health protocol** — every worker beats pressure gauges at
  ``serve_heartbeat_s``; a worker that stops beating, whose process exits,
  or whose pipe EOFs is declared dead, SIGKILLed for certainty, and
  respawned with a bumped incarnation.
- **Per-request lease table with idempotent re-dispatch** — every
  dispatched request holds a lease recording (worker, incarnation).  A
  dead or hung executor's leased requests re-queue to survivors exactly
  once (death detection is idempotent per incarnation), and late results
  from a recycled worker are dropped as duplicates — each lease completes
  effectively once.  Fan-out splits keep parent lineage in the lease
  table, so a re-dispatched child still lands in its ``_SplitJoin`` slot
  and the parent's join completes (*Thallus*-shaped owner-to-owner seam:
  the columnar exchange of ROADMAP open item 1 plugs in here later).
- **Degradation ladder** — healthy -> shed-low-priority ->
  serve-only-cached-plans -> reject-with-retry-after, steered by the same
  pressure signals the round-9 admission controller samples (worker
  mem/blocked gauges via heartbeats, queue occupancy) plus the alive
  fraction.  Degrade before you drop (*Sparkle*'s tiered capacity): each
  transition is a ledger entry and an ``EV_DEGRADE_*`` flight event, and
  every step is reversible when pressure clears.
"""

from __future__ import annotations

import itertools
import multiprocessing
import os
import socket
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.obs import trace as _trace
from spark_rapids_jni_tpu_torch.serve import attribution as _attrib
from spark_rapids_jni_tpu_torch.serve.attribution import AttributionRollup
from spark_rapids_jni_tpu_torch.serve.executor import _SplitJoin, split_till
from spark_rapids_jni_tpu_torch.serve.metrics import ServeMetrics, percentile_of_counts
from spark_rapids_jni_tpu_torch.serve.queue import (
    CANCELLED,
    ERROR,
    OK,
    TIMED_OUT,
    AdmissionQueue,
    Backpressure,
    Request,
    RequestTimeout,
)
from spark_rapids_jni_tpu_torch.serve import rpc
from spark_rapids_jni_tpu_torch.serve.session import (
    Session,
    SessionBudgetExceeded,
    SessionRegistry,
)

__all__ = [
    "Degraded", "HandlerSpec", "ShuffleSpec", "RemoteExecutorError",
    "Supervisor",
    "DEGRADE_LEVELS", "LEVEL_HEALTHY", "LEVEL_SHED_LOW",
    "LEVEL_CACHED_ONLY", "LEVEL_REJECT",
]

#: send and receive buffer asked for on both ends of each worker's pipe (a
#: socketpair).  With the kernel's defaults a 112 MB shard payload took about
#: 5 s to cross it on an H100 host (about 22 MB/s); with these buffers about
#: 0.36 s, while the heartbeat that shares the pipe waits on the same send.
PIPE_BUFFER_BYTES = 8 << 20


def _widen_pipe(conn) -> None:
    """Ask for PIPE_BUFFER_BYTES of socket buffer on one end of a duplex
    ``multiprocessing`` pipe (the kernel may grant less)."""
    s = socket.socket(fileno=os.dup(conn.fileno()))
    try:
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            s.setsockopt(socket.SOL_SOCKET, opt, PIPE_BUFFER_BYTES)
    finally:
        s.close()


# the degradation ladder, shallow to deep
DEGRADE_LEVELS = ("healthy", "shed_low", "cached_only", "reject")
LEVEL_HEALTHY = 0
LEVEL_SHED_LOW = 1       # shed below-threshold-priority submits
LEVEL_CACHED_ONLY = 2    # admit only warm/cacheable handler classes
LEVEL_REJECT = 3         # reject everything with retry-after

# lease states
_QUEUED = "queued"       # in the admission queue (initial or re-dispatch)
_LEASED = "leased"       # dispatched to one executor incarnation
_DONE = "done"           # effectively completed (exactly once)

# executor-process health states (_ExecutorHandle.health)
_STARTING = "starting"   # spawned, hello not yet received
_ALIVE = "alive"         # heartbeating and leasable
_DEAD = "dead"           # declared dead (terminal: a respawn is a NEW
#                          handle with a bumped incarnation)

# The machines the analyze gate checks every transition site against
# (docs/STATIC_ANALYSIS.md, state-machine pass).  A write to the bound
# field must be an __init__ initialization, sit under an `== <state>`
# guard matching a declared edge, or carry a `# transition:` annotation.
# state-machine: lease field=state
_LEASE_TRANSITIONS = {
    _QUEUED: (_LEASED, _DONE),   # grant; queue-timeout/shutdown retire
    _LEASED: (_QUEUED, _DONE),   # dead/hung/busy re-dispatch; completion
    _DONE: (),                   # terminal: exactly-once, never revived
}

_H_NONE = "none"          # no hedge outstanding for this lease
_H_LAUNCHED = "launched"  # ONE duplicate dispatch in flight

# A lease's speculative-hedge lifecycle (round 19): the health sweep
# launches at most one duplicate dispatch of a lease sitting past its
# handler's windowed p99, and the attempt always retires back to "none"
# — hedge result wins the lease, primary wins first (loser dropped as a
# duplicate), hedge target says BUSY, or the hedge's worker dies.
# Declared as its own machine (not new lease edges) so the lease
# machine's exactly-once story is untouched: completion still flows
# through _lease_done_locked exactly once, whoever ran the work.
# state-machine: hedge field=hedge_state
_HEDGE_TRANSITIONS = {
    _H_NONE: (_H_LAUNCHED,),     # health sweep fires a hedge copy
    _H_LAUNCHED: (_H_NONE,),     # win / primary-won / busy / dead target
}
# state-machine: worker field=health
_WORKER_TRANSITIONS = {
    _STARTING: (_ALIVE, _DEAD),  # hello; spawn-timeout/proc-exit
    _ALIVE: (_DEAD,),            # crash-only: never coaxed back
    _DEAD: (),                   # terminal per incarnation
}
# The degradation ladder moves one level at a time, both directions —
# adjacency IS the declared edge set.  (The marker must sit directly
# above the table for the pass-9 loader to bind it — the protocol-model
# pass caught this declaration dangling two lines up.)
# state-machine: ladder field=_level
_LADDER_TRANSITIONS = {
    LEVEL_HEALTHY: (LEVEL_SHED_LOW,),
    LEVEL_SHED_LOW: (LEVEL_HEALTHY, LEVEL_CACHED_ONLY),
    LEVEL_CACHED_ONLY: (LEVEL_SHED_LOW, LEVEL_REJECT),
    LEVEL_REJECT: (LEVEL_CACHED_ONLY,),
}


class Degraded(Backpressure):
    """Submit shed by the degradation ladder (a typed Backpressure: the
    client's reject/retry loop needs no new branch, but can see WHY)."""

    def __init__(self, msg: str, retry_after_s: float, level: int):
        super().__init__(msg, retry_after_s)
        self.level = level


class RemoteExecutorError(RuntimeError):
    """A handler failure inside an executor process, re-raised here with
    the remote type name preserved in the message."""


class HandlerSpec:
    """The supervisor's view of a query class: enough to admit (byte
    estimate), optionally fan a request out across executors
    (``split``/``combine``, up to ``fanout`` pieces), and classify it for
    the cached-only degradation level (``cacheable`` marks classes whose
    compiled plans are expected resident; otherwise a class becomes
    "warm" after its first completed request).

    ``cache_key``/``cache_tables`` (round 15) opt the class into the
    governed RESULT cache — same contract as
    :class:`~spark_rapids_jni_tpu_torch.serve.executor.QueryHandler`:
    ``cache_key(payload)`` returns a hashable identity embedding a
    content digest (or None = uncacheable payload), ``cache_tables`` the
    named-table dependencies.  The supervisor then short-circuits hits
    BEFORE dispatch — a hit never costs a lease or a pipe crossing — and
    stores each OK result it routes."""

    __slots__ = ("name", "nbytes_of", "split", "combine", "cacheable",
                 "fanout", "cache_key", "cache_tables")

    def __init__(self, name: str,
                 nbytes_of: Callable[[Any], int] = lambda p: 0,
                 split: Optional[Callable[[Any], Sequence[Any]]] = None,
                 combine: Optional[Callable[[List[Any]], Any]] = None,
                 cacheable: bool = False, fanout: int = 1,
                 cache_key: Optional[Callable[[Any], Any]] = None,
                 cache_tables: Any = ()):
        if (split is None) != (combine is None):
            raise ValueError("split and combine must be provided together")
        if fanout > 1 and split is None:
            raise ValueError("fanout > 1 requires split/combine")
        self.name = name
        self.nbytes_of = nbytes_of
        self.split = split
        self.combine = combine
        self.cacheable = cacheable
        self.fanout = int(fanout)
        self.cache_key = cache_key
        self.cache_tables = cache_tables


class ShuffleSpec(HandlerSpec):
    """A query class whose Exchange runs as a REAL cross-process shuffle
    (serve/shuffle.py): the supervisor splits the payload into N map
    shards (``split_n``), brokers the partition map while the children
    exchange partitions peer-to-peer, and ``combine`` sums the partial
    sink outputs (then evaluates the plan's post expressions — see
    serve/shuffle.combine_exchange_outputs).  ``fanout`` caps N; actual
    N = min(fanout, alive-at-dispatch), floored at 1 — a lone (or
    not-yet-hello'd) pool serves the request as ONE shard, still through
    the shuffle handler, partitioning to itself."""

    __slots__ = ("split_n",)

    def __init__(self, name: str, split_n: Callable[[Any, int], List[Any]],
                 combine: Callable[[List[Any]], Any],
                 nbytes_of: Callable[[Any], int] = lambda p: 0,
                 cacheable: bool = False, fanout: int = 4):
        super().__init__(name, nbytes_of=nbytes_of, cacheable=cacheable)
        self.split_n = split_n
        self.combine = combine
        self.fanout = max(1, int(fanout))


class _Lease:
    """One dispatched request's supervision record (lease-table entry)."""

    __slots__ = ("rid", "req", "state", "worker_id", "incarnation",
                 "dispatches", "redispatches", "granted_ns", "completed",
                 "hedge_state", "hedge_worker_id", "hedge_incarnation")

    def __init__(self, rid: int, req: Request):
        self.rid = rid
        self.req = req
        self.state = _QUEUED
        self.worker_id = -1
        self.incarnation = -1
        self.dispatches = 0
        self.redispatches = 0
        self.granted_ns = 0
        self.completed = False
        # speculative-hedge bookkeeping (round 19): which second worker
        # holds the duplicate dispatch, incarnation-pinned like the
        # primary so a recycled target's late answer can never match
        # (all three fields follow the lease: guarded-by: _lock)
        self.hedge_state = _H_NONE
        self.hedge_worker_id = -1
        self.hedge_incarnation = -1


class _ShuffleState:
    """The supervisor's partition map for one live shuffle: per map task,
    which (worker, incarnation) currently owns it, whether it has
    produced (sizes + serving endpoint), and which consumer partitions
    acked the fetch.  Alongside the lease table it is what makes the
    data plane crash-safe: a dead producer's un-acked partitions
    re-produce through re-dispatch (lease live) or a produce-only
    revival (lease already done), and every transition re-broadcasts the
    map to the participants."""

    __slots__ = ("sid", "nparts", "parent_rid", "handler", "tasks",
                 "workers_seen")

    def __init__(self, sid: int, nparts: int, parent_rid: int,
                 handler: str):
        self.sid = sid
        self.nparts = nparts
        self.parent_rid = parent_rid
        self.handler = handler
        # map_index -> {"rid", "data" (the shard payload, retained for
        # revival), "worker", "inc", "state" ("pending"|"produced"),
        # "sizes" ({part: bytes}), "ep", "acks" (set of consumer parts)}
        self.tasks: Dict[int, dict] = {}
        self.workers_seen: set = set()  # cleanup recipients

    def wire_map(self) -> dict:
        """The picklable per-task view broadcast to participants."""
        return {m: {"state": t["state"], "ep": t["ep"],
                    "incarnation": t["inc"], "sizes": dict(t["sizes"])}
                for m, t in self.tasks.items()}


class _ExecutorHandle:
    """Supervisor-side record of one executor process incarnation."""

    __slots__ = ("worker_id", "incarnation", "proc", "conn", "health",
                 "pid", "last_beat", "gauges", "inflight", "recv_thread")

    def __init__(self, worker_id: int, incarnation: int, proc, conn):
        self.worker_id = worker_id
        self.incarnation = incarnation
        self.proc = proc
        self.conn = conn
        self.health = _STARTING    # starting -> alive -> dead
        self.pid = 0
        self.last_beat = time.monotonic()
        self.gauges: dict = {}
        self.inflight: set = set()  # rids leased to this incarnation
        self.recv_thread = None


class Supervisor:
    """Router/supervisor process: sessions + admission + lease table over
    N executor worker processes.

    ``stress_source`` (tests) injects the ladder's pressure sample;
    ``start=False`` builds the supervisor without spawning processes or
    threads so unit tests can drive :meth:`_ladder_tick` and the lease
    table deterministically.
    """

    def __init__(self, *, workers: int = 2, factory=None,
                 factory_kwargs: Optional[dict] = None,
                 worker_cfg: Optional[dict] = None,
                 worker_flags: Optional[dict] = None,
                 chaos: Optional[Callable[[int, int], Optional[dict]]] = None,
                 queue_size: Optional[int] = None,
                 default_deadline_s: Optional[float] = 30.0,
                 heartbeat_s: Optional[float] = None,
                 heartbeat_misses: Optional[int] = None,
                 lease_hang_s: Optional[float] = None,
                 lease_max_dispatches: int = 3,
                 spawn_grace_s: float = 60.0,
                 max_inflight_per_worker: int = 8,
                 degrade_up: Sequence[float] = (0.2, 0.55, 0.85),
                 degrade_margin: float = 0.1,
                 degrade_dwell_ticks: int = 2,
                 degrade_alpha: float = 0.5,
                 shed_priority_min: int = 1,
                 dump_on_exit: bool = False,
                 stress_source: Optional[Callable[[], float]] = None,
                 slos: Optional[Sequence] = None,
                 slo_opts: Optional[dict] = None,
                 telemetry: Optional[bool] = None,
                 start: bool = True):
        from spark_rapids_jni_tpu_torch import config

        if queue_size is None:
            queue_size = int(config.get("serve_queue_size"))
        if heartbeat_s is None:
            heartbeat_s = float(config.get("serve_heartbeat_s"))
        if heartbeat_misses is None:
            heartbeat_misses = int(config.get("serve_heartbeat_misses"))
        if lease_hang_s is None:
            lease_hang_s = float(config.get("serve_lease_hang_s"))
        self.nworkers = int(workers)
        self.factory = factory
        self.factory_kwargs = dict(factory_kwargs or {})
        self.worker_cfg = dict(worker_cfg or {})
        self.worker_flags = dict(worker_flags or {})
        self.chaos = chaos
        self.default_deadline_s = default_deadline_s
        self.heartbeat_s = heartbeat_s
        self.heartbeat_misses = int(heartbeat_misses)
        self.lease_hang_s = float(lease_hang_s)
        self.lease_max_dispatches = int(lease_max_dispatches)
        self.spawn_grace_s = float(spawn_grace_s)
        self.max_inflight_per_worker = int(max_inflight_per_worker)
        self.degrade_up = tuple(degrade_up)
        self.degrade_margin = float(degrade_margin)
        self.degrade_dwell_ticks = int(degrade_dwell_ticks)
        self.degrade_alpha = float(degrade_alpha)
        self.shed_priority_min = int(shed_priority_min)
        self.dump_on_exit = bool(dump_on_exit)
        self._stress_source = stress_source
        self._ctx = multiprocessing.get_context("spawn")
        self.metrics = ServeMetrics()
        self.sessions = SessionRegistry()
        self.queue = AdmissionQueue(queue_size,
                                    retry_after_hint=self._retry_after,
                                    on_timeout=self._on_queue_timeout)
        self._seq = itertools.count()
        # ONE lock guards the supervisor's shared state: handles, the
        # lease table, handler specs, the warm set, and ladder fields —
        # every attribute below declares it, and the guarded-by pass
        # (ci/analyze) rejects any access outside it at merge time.
        # Leaf discipline: never held across pipe sends, queue calls,
        # process spawns, or session/response completion.
        self._lock = threading.Lock()
        self._handles: Dict[int, _ExecutorHandle] = {}  # guarded-by: _lock
        # live leases only: completed entries retire into the aggregate
        # counters below (holding every served request's payload+result
        # forever would be an unbounded leak, and the monitor's sweeps
        # scan this table every heartbeat tick)
        self._leases: Dict[int, _Lease] = {}  # guarded-by: _lock
        self._leases_total = 0  # guarded-by: _lock
        self._leases_completed = 0  # guarded-by: _lock
        self._leases_redispatched = 0  # guarded-by: _lock
        self._lease_max_dispatches_seen = 0  # guarded-by: _lock
        # speculative hedging (round 19): launched count enforces the
        # budget (<= frac x leases granted, checked at launch)
        self._hedge_on = bool(config.get("serve_hedge"))
        self.hedge_factor = float(config.get("serve_hedge_factor"))
        self.hedge_budget_frac = float(config.get("serve_hedge_budget_frac"))
        self.hedge_min_samples = int(config.get("serve_hedge_min_samples"))
        self.hedge_window_s = float(config.get("serve_hedge_window_s"))
        self._hedges_launched = 0  # guarded-by: _lock
        # sliding window of (t, handler_latency_counts()) histogram
        # samples the hedge trigger diffs into a windowed p99; monitor
        # thread only — never shared, never locked
        self._hedge_lat: deque = deque()
        self._specs: Dict[str, HandlerSpec] = {}  # guarded-by: _lock
        self._warm: set = set()  # guarded-by: _lock
        # live shuffles' partition maps (retired at parent completion)
        self._shuffles: Dict[int, _ShuffleState] = {}  # guarded-by: _lock
        self._shuffle_seq = itertools.count(1)
        self._level = LEVEL_HEALTHY  # guarded-by: _lock
        self._level_max_seen = LEVEL_HEALTHY  # guarded-by: _lock
        self._stress_ewma: Optional[float] = None  # guarded-by: _lock
        self._ladder_tickno = 0  # guarded-by: _lock
        self._ladder_last_change = -10**9  # guarded-by: _lock
        self.ledger: List[dict] = []  # guarded-by: _lock
        self._stop = threading.Event()
        self._dispatcher: Optional[threading.Thread] = None
        self._monitor: Optional[threading.Thread] = None
        self._telemetry_name = f"supervisor:{id(self):x}"
        _flight.register_telemetry_source(self._telemetry_name,
                                          self.snapshot)
        # the governed result cache (plans/rcache.py, round 15): the
        # supervisor keeps its own process-global store (host/disk tiers
        # — no governed compute runs here, so no budget binds) and
        # short-circuits hits before dispatch.  Workers advertise their
        # hottest key tokens in heartbeat gauges; the cached_only
        # degradation level admits submits whose key is hot ANYWHERE.
        self._rcache_on = bool(config.get("serve_result_cache"))
        # the live telemetry plane (round 14, serve/telemetry.py): the
        # bounded cluster timeline every worker's MSG_TELEMETRY deltas
        # (and this process's own ring) merge into, served over a local
        # endpoint for flightdump --live / servetop
        if telemetry is None:
            telemetry = bool(config.get("serve_telemetry"))
        # span rooting rides the same flag: plane off = no span events,
        # the full round-13 ring capacity for governance history
        self._spans_on = bool(telemetry)
        self.timeline = None
        self._tl_server = None
        self._tl_lock = threading.Lock()
        self._tl_cursor = 0  # guarded-by: _tl_lock
        # the attribution rollup (round 21): per-tenant dominant-resource
        # accounting + the capacity/headroom model.  Fed post-dedup from
        # the timeline's on_event hook, so a re-ingested delta can never
        # double-count a request's costs; worker reconciliation gauges
        # arrive on the MSG_TELEMETRY path below.  Capacity model:
        # threads-per-executor from worker_cfg (the engine's pool width),
        # governed budget per executor likewise (config default when the
        # cfg leaves the engine to probe it).
        self.attribution = AttributionRollup()
        self._attrib_threads = int(self.worker_cfg.get("workers", 2))
        self._attrib_budget = int(self.worker_cfg.get("budget_bytes")
                                  or config.get("device_budget_bytes"))
        if telemetry:
            from spark_rapids_jni_tpu_torch.serve.telemetry import ClusterTimeline

            self.timeline = ClusterTimeline(
                on_event=self.attribution.ingest_event)
        # the SLO burn-rate engine (serve/slo.py): declared objectives
        # evaluated on the monitor tick; burn feeds the ladder's stress
        # sample and the MSG_PRESSURE broadcast (slo_frac)
        if slos is None:
            from spark_rapids_jni_tpu_torch.serve.slo import parse_slo_config

            slos = parse_slo_config(str(config.get("serve_slo_config")))
        self.slo = None
        if slos:
            from spark_rapids_jni_tpu_torch.serve.slo import (
                BurnRateEngine,
                supervisor_metrics_source,
            )

            self.slo = BurnRateEngine(
                list(slos), supervisor_metrics_source(self.metrics),
                **(slo_opts or {}))
        if start:
            if self.timeline is not None:
                from spark_rapids_jni_tpu_torch.serve.telemetry import (
                    TelemetryServer,
                )

                self._tl_server = TelemetryServer(
                    self._telemetry_view).start()
            for wid in range(self.nworkers):
                self._spawn_worker(wid, 0)
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name="serve-supervisor-dispatch")
            self._monitor = threading.Thread(
                target=self._monitor_loop, daemon=True,
                name="serve-supervisor-monitor")
            self._dispatcher.start()
            self._monitor.start()

    # -- registration / sessions --------------------------------------------
    def register(self, spec: HandlerSpec) -> None:
        with self._lock:
            if spec.name in self._specs:
                raise ValueError(f"handler {spec.name!r} already registered")
            self._specs[spec.name] = spec

    def open_session(self, name: Optional[str] = None, *, priority: int = 0,
                     byte_budget: Optional[int] = None) -> Session:
        return self.sessions.open(name, priority=priority,
                                  byte_budget=byte_budget)

    def close_session(self, session: Session) -> None:
        self.sessions.close(session)

    # -- the producer surface -----------------------------------------------
    def submit(self, session: Session, handler: str, payload: Any, *,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None,
               tenant: Optional[str] = None):
        with self._lock:
            spec = self._specs.get(handler)
        if spec is None:
            raise KeyError(f"no handler {handler!r} registered")
        prio = priority if priority is not None else session.priority
        # the attribution identity every cost this request causes rolls
        # up under — explicit billing label, else the session
        tname = tenant if tenant else session.session_id
        # the result-cache read path runs BEFORE the degradation gate:
        # a hit is served work, not shed work — it costs no lease, no
        # pipe crossing, no worker capacity, so even a ladder at
        # `reject` serves it (that is what cached_only DEGRADES TO:
        # under overload the hot tail keeps answering from memory while
        # cold queries shed).  A hit must therefore never touch
        # Session.note_degraded or the rejected_degraded counter.
        ckey = cdeps = ctoken = None
        if self._rcache_on and spec.cache_key is not None:
            ckey, cdeps, ctoken, resp = self._rcache_submit(
                session, spec, payload, tname)
            if resp is not None:
                return resp
        self._gate(session, spec, prio, hot_token=ctoken)
        nbytes = int(spec.nbytes_of(payload))
        try:
            session.charge(nbytes)
        except SessionBudgetExceeded:
            self.metrics.count("rejected_session", session.session_id)
            raise
        dl = deadline_s if deadline_s is not None else self.default_deadline_s
        tid = self.sessions.next_task_id()
        req = Request(
            handler=handler, payload=payload,
            session_id=session.session_id, priority=prio,
            deadline=(time.monotonic() + dl) if dl is not None else None,
            seq=next(self._seq), task_id=tid,
            # the request's trace roots HERE: rid = the supervisor lease
            # id, the same token every cross-process chain keys on
            trace=_trace.new_root(tid) if self._spans_on else None,
            tenant=tname,
        )
        req.charge_bytes = nbytes
        req.session = session
        req.rcache_key, req.rcache_deps = ckey, cdeps  # miss: store on OK
        if ckey is not None:
            self.metrics.count("rcache_misses", session.session_id)
        # opened BEFORE the request becomes poppable (engine.submit twin):
        # the dispatcher may grant — and close this span — the instant
        # submit returns
        req.qspan = _trace.open_span(req.trace, _trace.SPAN_QUEUE,
                                     task_id=tid,
                                     extra=f"handler:{handler}")
        try:
            self.queue.submit(req)
        except Backpressure:
            session.credit(nbytes)
            _trace.close_span(req.qspan)
            req.qspan = None
            self.metrics.count("rejected_full", session.session_id)
            _flight.record(_flight.EV_QUEUE_REJECT, req.task_id,
                           detail=f"handler:{handler}")
            raise
        except BaseException:  # closed queue (shutdown): no charge leaks
            session.credit(nbytes)
            _trace.close_span(req.qspan)
            req.qspan = None
            raise
        self.metrics.count("submitted", session.session_id)
        return req.response

    def _rcache_submit(self, session: Session, spec: HandlerSpec,
                       payload: Any, tenant: str):
        """Result-cache short-circuit of one submit.  Returns
        ``(key, deps, token, response)``: response is non-None on a hit
        (already terminal — the caller returns it without gating,
        queueing, or leasing); on a miss key/deps ride the request so
        ``_on_result`` stores the computed value, and token feeds the
        cached_only gate's advertised-hot check."""
        from spark_rapids_jni_tpu_torch.plans.rcache import (
            key_token,
            request_key,
            result_cache,
        )

        pk = spec.cache_key(payload)
        if pk is None:
            return None, None, None, None
        names = (spec.cache_tables(payload)
                 if callable(spec.cache_tables) else spec.cache_tables)
        key, deps = request_key(spec.name, pk, names)
        tid = self.sessions.next_task_id()
        t0_ns = time.monotonic_ns()
        # meter the lookup so the cache hooks land residency/hit counts
        # on an attribution record: a hit is served work and must be
        # billed — zero compute, nonzero residency
        arec = _attrib.AttributionRecord(rid=tid, tenant=tenant,
                                         handler=spec.name)
        with _attrib.metered(arec):
            hit = result_cache.lookup(key, rid=tid)
        if hit is None:
            # the dispatched request re-attributes itself end to end;
            # the probe record (one miss, no cost) is dropped
            return key, deps, key_token(key), None
        req = Request(
            handler=spec.name, payload=None, session_id=session.session_id,
            priority=session.priority, deadline=None, seq=next(self._seq),
            task_id=tid,
            trace=_trace.new_root(tid) if self._spans_on else None,
            tenant=tenant,
        )
        # the waterfall of a hit: queue (instantaneous — the request was
        # never poppable) -> cache_hit, no dispatch, no compute
        req.qspan = _trace.open_span(req.trace, _trace.SPAN_QUEUE,
                                     task_id=tid,
                                     extra=f"handler:{spec.name}")
        _trace.close_span(req.qspan)
        req.qspan = None
        self.metrics.count("submitted", session.session_id)
        self.metrics.count("rcache_hits", session.session_id)
        # end-to-end latency as the SLO engine sees it: a hit IS a
        # served request, and its near-zero submit->result belongs in
        # the same per-handler distribution the burn rates evaluate
        self.metrics.record_run(time.monotonic_ns() - t0_ns,
                                handler=spec.name)
        with _trace.span(req.trace, _trace.SPAN_CACHE, task_id=tid,
                         extra=f"handler:{spec.name}"):
            self._finish(req, OK, value=hit)
        _attrib.emit(arec, task_id=tid)
        return key, deps, None, req.response

    def _advertised_hot_locked(self, token: str) -> bool:
        """(Caller holds ``self._lock``.)  True when any live worker's
        heartbeat advertised ``token`` among its hottest cache keys."""
        return any(token in (h.gauges.get("rcache_hot") or ())
                   for h in self._handles.values()
                   if h.health == _ALIVE)

    def _gate(self, session: Session, spec: HandlerSpec,
              priority: int, hot_token: Optional[str] = None) -> None:
        """The degradation ladder's admission decision for one submit."""
        with self._lock:
            level = self._level
            warm = spec.name in self._warm
            # a key some worker advertises as hot will very likely hit
            # that worker's cache: admitting it under cached_only costs
            # near-zero compute, exactly the traffic the level exists
            # to keep serving
            hot = (hot_token is not None and level >= LEVEL_CACHED_ONLY
                   and self._advertised_hot_locked(hot_token))
        if level == LEVEL_HEALTHY:
            return
        reason = None
        if level >= LEVEL_REJECT:
            reason = "rejecting all submits"
        elif level >= LEVEL_CACHED_ONLY and not (spec.cacheable or warm
                                                 or hot):
            reason = f"only warm/cacheable classes served ({spec.name} cold)"
        elif level >= LEVEL_SHED_LOW and priority < self.shed_priority_min:
            reason = (f"shedding priority < {self.shed_priority_min} "
                      f"(got {priority})")
        if reason is None:
            return
        retry = self._retry_after(self.queue.depth()) * (1 + level)
        self.metrics.count("rejected_degraded", session.session_id)
        session.note_degraded()
        _flight.record(_flight.EV_QUEUE_REJECT, -1,
                       detail=f"degraded:{DEGRADE_LEVELS[level]}:"
                              f"handler:{spec.name}")
        raise Degraded(
            f"degraded ({DEGRADE_LEVELS[level]}): {reason}", retry, level)

    def _retry_after(self, depth: int) -> float:
        return min(5.0, 0.01 * max(depth, 1))

    # -- queue callbacks -----------------------------------------------------
    def _credit(self, req: Request) -> None:
        sess = getattr(req, "session", None)
        if sess is not None:
            sess.credit(getattr(req, "charge_bytes", 0))
            req.session = None

    def _lease_done_locked(self, lease: _Lease) -> None:
        """Retire a lease (caller holds ``self._lock``): fold it into the
        aggregate counters and drop the table entry — the lease table
        holds LIVE supervision state only."""
        if lease.completed:
            return
        lease.completed = True
        lease.state = _DONE  # transition: lease *->done (retire from any)
        self._leases_completed += 1
        self._lease_max_dispatches_seen = max(
            self._lease_max_dispatches_seen, lease.dispatches)
        self._leases.pop(lease.rid, None)

    def _on_queue_timeout(self, req: Request) -> None:
        self._credit(req)
        _trace.close_span(req.qspan)
        req.qspan = None
        self.metrics.count("timed_out", req.session_id)
        _flight.record(_flight.EV_QUEUE_TIMEOUT, req.task_id,
                       detail=f"handler:{req.handler}")
        with self._lock:
            lease = self._leases.get(req.task_id)
            if lease is not None:
                self._lease_done_locked(lease)
        if req.join is not None:
            req.join.deliver(req.join_slot, TIMED_OUT, None,
                             req.response.error)

    def _finish(self, req: Request, status: str, value: Any = None,
                error: Optional[BaseException] = None) -> None:
        first = req.response._complete(status, value=value, error=error)
        if not first:
            return
        self._credit(req)
        # terminal: no phase span may outlive the request (idempotent)
        _trace.close_span(req.qspan)
        _trace.close_span(req.dspan)
        req.qspan = req.dspan = None
        counter = {OK: "completed", TIMED_OUT: "timed_out",
                   CANCELLED: "cancelled"}.get(status, "failed")
        self.metrics.count(counter, req.session_id)
        if req.shuffle_sid is not None and req.shuffle_map_index < 0:
            # the shuffle's parent reached its terminal state (join
            # complete OR terminal failure): the partition map retires
            # and every participant frees its store
            self._shuffle_cleanup(req.shuffle_sid)
        if req.join is not None:
            req.join.deliver(req.join_slot, status, value, error)

    # -- worker lifecycle ----------------------------------------------------
    def _spawn_worker(self, worker_id: int, incarnation: int) -> None:
        parent_conn, child_conn = self._ctx.Pipe(duplex=True)
        _widen_pipe(parent_conn)
        _widen_pipe(child_conn)
        chaos_cfg = (self.chaos(worker_id, incarnation)
                     if self.chaos is not None else None)
        proc = self._ctx.Process(
            target=rpc.executor_worker_main,
            args=(worker_id, incarnation, child_conn, self.factory),
            kwargs={"factory_kwargs": self.factory_kwargs,
                    "worker_cfg": self.worker_cfg,
                    "chaos": chaos_cfg,
                    "flags": self.worker_flags},
            daemon=True, name=f"serve-executor-{worker_id}")
        proc.start()
        child_conn.close()  # the child's end lives in the child now
        handle = _ExecutorHandle(worker_id, incarnation, proc,
                                 rpc.SafeConn(parent_conn))
        handle.recv_thread = threading.Thread(
            target=self._recv_loop, args=(handle,), daemon=True,
            name=f"serve-supervisor-recv-{worker_id}.{incarnation}")
        with self._lock:
            self._handles[worker_id] = handle
        handle.recv_thread.start()
        self.metrics.count("workers_spawned")
        _flight.record(_flight.EV_WORKER_SPAWN, -1,
                       detail=f"worker:{worker_id}:inc:{incarnation}:"
                              f"pid:{proc.pid}")

    def _recv_loop(self, handle: _ExecutorHandle) -> None:
        while True:
            msg = handle.conn.recv()
            if msg is None:
                # EOF during shutdown is the worker draining on request,
                # not a death — only a LIVE supervisor treats it as one
                if not self._stop.is_set():
                    self._worker_dead(handle, "pipe_eof")
                return
            tag = msg[0]
            if tag == rpc.MSG_HELLO:
                with self._lock:
                    if handle.health == _STARTING:
                        handle.health = _ALIVE
                    handle.pid = msg[3]
                    handle.last_beat = time.monotonic()
            elif tag == rpc.MSG_BEAT:
                with self._lock:
                    handle.last_beat = time.monotonic()
                    handle.gauges = dict(msg[4])
            elif tag == rpc.MSG_RESULT:
                self._on_result(handle, msg[1], msg[2], msg[3], msg[4])
            elif tag == rpc.MSG_SHUFFLE_PRODUCED:
                self._on_shuffle_produced(handle, msg[3], msg[4], msg[5],
                                          msg[6])
            elif tag == rpc.MSG_SHUFFLE_ACK:
                self._on_shuffle_ack(handle, msg[3], msg[4], msg[5])
            elif tag == rpc.MSG_TELEMETRY:
                # reconciliation gauges high-water per incarnation even
                # when the timeline plane is off or HELLO hasn't landed
                # — measured busy/byte·ns must survive every race the
                # events themselves survive
                self.attribution.note_worker_gauges(msg[1], msg[2],
                                                    msg[6])
                # a delta racing ahead of HELLO has no pid to key on yet
                # (worker spans can't predate the hello, so nothing of a
                # request's waterfall is lost by dropping it)
                if self.timeline is not None and handle.pid:
                    self.timeline.ingest(
                        handle.pid, msg[3], msg[4], msg[5],
                        incarnation=msg[2], worker_id=msg[1],
                        metrics=msg[6])

    def _worker_dead(self, handle: _ExecutorHandle, reason: str) -> None:
        """Idempotent per incarnation: declare dead, SIGKILL for
        certainty, re-queue its leases to survivors (each exactly once),
        respawn."""
        with self._lock:
            if handle.health == _DEAD:
                return
            # transition: worker *->dead (idempotent guard above; both
            # starting and alive executors die through this one path)
            handle.health = _DEAD
            current = self._handles.get(handle.worker_id) is handle
            orphans = []
            dead_hedges = []
            for rid in handle.inflight:
                lease = self._leases.get(rid)
                if lease is None or lease.completed:
                    continue
                if (lease.state == _LEASED
                        and lease.worker_id == handle.worker_id
                        and lease.incarnation == handle.incarnation):
                    lease.state = _QUEUED  # transition: lease leased->queued
                    if lease.redispatches == 0:
                        self._leases_redispatched += 1
                    lease.redispatches += 1
                    orphans.append(lease)
                if (lease.hedge_state == _H_LAUNCHED
                        and lease.hedge_worker_id == handle.worker_id
                        and lease.hedge_incarnation == handle.incarnation):
                    # the hedge copy died with its worker; the primary
                    # (or a re-dispatch) still owns the lease — just
                    # retire the attempt so the lease may hedge again
                    lease.hedge_state = _H_NONE  # transition: hedge launched->none
                    dead_hedges.append(rid)
            handle.inflight.clear()
        self.metrics.count("workers_dead")
        _flight.record(_flight.EV_WORKER_DEAD, -1,
                       detail=f"worker:{handle.worker_id}:"
                              f"inc:{handle.incarnation}:{reason}")
        try:
            handle.proc.kill()
        except (OSError, ValueError, AttributeError):
            pass
        handle.conn.close()
        for rid in dead_hedges:
            self.metrics.count("hedge_losses")
            _flight.record(_flight.EV_HEDGE_LOSE, rid,
                           detail=f"rid:{rid}:reason:{reason}")
        for lease in orphans:
            self.metrics.count("leases_redispatched")
            _flight.record(_flight.EV_LEASE_REDISPATCH, lease.rid,
                           detail=f"rid:{lease.rid}:"
                                  f"from:{handle.worker_id}."
                                  f"{handle.incarnation}:{reason}")
            self._requeue(lease.req)
        # data-plane lineage: live shuffles that lost produced partitions
        # with this incarnation re-point their tasks (and revive the ones
        # whose leases already completed)
        self._revive_shuffle_tasks(handle)
        if current and not self._stop.is_set():
            self._spawn_worker(handle.worker_id, handle.incarnation + 1)

    def _requeue(self, req: Request) -> None:
        # a re-dispatch ends the failed dispatch phase and starts a new
        # queue-wait phase: redispatch churn is visible as repeated
        # dispatch bars in the waterfall, never a gap
        _trace.close_span(req.dspan)
        req.dspan = None
        if req.trace is not None and req.qspan is None:
            req.qspan = _trace.open_span(req.trace, _trace.SPAN_QUEUE,
                                         task_id=req.task_id,
                                         extra=f"handler:{req.handler}"
                                               f":requeue")
        try:
            self.queue.submit(req, force=True)
        # analyze: ignore[retry-protocol] - queue.submit crosses no seam;
        # the breadth is for shutdown races, where the request must reach
        # a terminal state rather than be lost (engine._requeue twin)
        except BaseException as e:  # noqa: BLE001
            self._finish(req, ERROR, error=e)

    # -- dispatch ------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while True:
            req = self.queue.pop(timeout=0.1)
            if req is None:
                if self._stop.is_set():
                    return
                continue
            # the pop slot is returned only AFTER routing: between pop and
            # lease grant (or re-queue) the request is tracked by neither
            # the heap nor the lease table, and wait_drained must not see
            # idle through that window (review r10)
            try:
                self._route(req)
            # analyze: ignore[retry-protocol] - routing crosses no seam
            # and runs no governed work; any unexpected failure must
            # terminate THIS request loudly, never the dispatcher thread
            except Exception as e:  # noqa: BLE001
                self._finish(req, ERROR, error=e)
            finally:
                self.queue.task_done()

    def _route(self, req: Request) -> None:
        with self._lock:
            spec = self._specs.get(req.handler)
            alive = sum(1 for h in self._handles.values()
                        if h.health == _ALIVE)
            # a request that already holds a lease is a re-dispatch (dead
            # worker, BUSY): it must re-grant as itself — fanning out now
            # would complete the response through child leases while the
            # original lease sat un-completed forever (review r10)
            has_lease = req.task_id in self._leases
        if spec is None:
            self._finish(req, ERROR,
                         error=KeyError(f"no handler {req.handler!r}"))
            return
        if (isinstance(spec, ShuffleSpec) and req.join is None
                and req.shuffle_sid is None and not has_lease):
            # N map shards = live capacity (min 1: a lone executor still
            # shuffles — to itself); children exchange peer-to-peer
            self._shuffle_dispatch(req, spec,
                                   max(1, min(spec.fanout, alive)))
            return
        if (spec.fanout > 1 and spec.split is not None and req.join is None
                and req.split_depth == 0 and not has_lease and alive > 1):
            parts = self._fanout_parts(spec, req.payload,
                                       min(spec.fanout, alive))
            if len(parts) > 1:
                self._fanout_dispatch(req, spec, parts)
                return
        self._grant(req)

    def _fanout_parts(self, spec: HandlerSpec, payload: Any,
                      want: int) -> List[Any]:
        # halving per level yields powers of two: bound by the DEEPEST
        # level that stays <= want, so the piece count never exceeds the
        # spec's documented fanout contract (2^floor(log2(want)))
        return split_till(payload, spec.split,
                          max_levels=max(1, want.bit_length() - 1))[0]

    def _fanout_dispatch(self, req: Request, spec: HandlerSpec,
                         parts: List[Any]) -> None:
        """Split one request across executors; children carry the parent's
        lineage through the lease table so a re-dispatched child still
        joins (the _SplitJoin machinery is the executor's own)."""
        join = _SplitJoin(req, spec.combine, len(parts), self._finish)
        self.metrics.count("split_requeued", req.session_id, n=len(parts))
        for slot, part in enumerate(parts):
            child = Request(
                handler=req.handler, payload=part,
                session_id=req.session_id, priority=req.priority,
                deadline=req.deadline, seq=next(self._seq),
                task_id=self.sessions.next_task_id(),
                split_depth=1, no_batch=True, join=join, join_slot=slot,
                trace=(_trace.child_of(req.trace)
                       if req.trace is not None else None),
                tenant=req.tenant,
            )
            _flight.record(_flight.EV_SPLIT_RETRY, child.task_id,
                           detail=f"rid:{child.task_id}:"
                                  f"fanout_from:{req.task_id}")
            self._requeue(child)

    # -- the shuffle partition map (round 13) --------------------------------
    def _shuffle_dispatch(self, req: Request, spec: ShuffleSpec,
                          want: int) -> None:
        """Split one Exchange-plan request into ``want`` map-task
        children that shuffle partitions peer-to-peer; the supervisor
        records the partition map and brokers endpoints, the children's
        partial sinks join through ``spec.combine``."""
        shards = list(spec.split_n(req.payload, want))
        n = len(shards)
        sid = next(self._shuffle_seq)
        req.shuffle_sid = sid  # parent marker (map_index stays -1):
        #                        completion of the join triggers cleanup
        join = _SplitJoin(req, spec.combine, n, self._finish)
        state = _ShuffleState(sid, n, req.task_id, req.handler)
        children = []
        for m, shard in enumerate(shards):
            tid = self.sessions.next_task_id()
            child = Request(
                handler=req.handler,
                payload={"sid": sid, "m": m, "nparts": n, "rid": tid,
                         "data": shard},
                session_id=req.session_id, priority=req.priority,
                deadline=req.deadline, seq=next(self._seq), task_id=tid,
                split_depth=1, no_batch=True, join=join, join_slot=m,
                shuffle_sid=sid, shuffle_map_index=m,
                trace=(_trace.child_of(req.trace)
                       if req.trace is not None else None),
                tenant=req.tenant,
            )
            state.tasks[m] = {"rid": tid, "data": shard, "worker": -1,
                              "inc": -1, "state": "pending", "sizes": {},
                              "ep": None, "acks": set()}
            children.append(child)
        with self._lock:
            self._shuffles[sid] = state
        self.metrics.count("shuffles_started", req.session_id)
        self.metrics.count("split_requeued", req.session_id, n=n)
        for child in children:
            _flight.record(_flight.EV_SPLIT_RETRY, child.task_id,
                           detail=f"rid:{child.task_id}:sid:{sid}:"
                                  f"map:{child.shuffle_map_index}:"
                                  f"shuffle_from:{req.task_id}")
            self._requeue(child)

    def _shuffle_task_located(self, req: Request, worker_id: int,
                              incarnation: int) -> Optional[int]:
        """(Caller holds ``self._lock``.)  Point the partition map's task
        at the incarnation that just took its lease; production restarts
        from scratch there, so the state drops back to pending.  Returns
        the sid to re-broadcast (the old endpoint must stop being
        consulted NOW, not at the next produce)."""
        state = self._shuffles.get(req.shuffle_sid)
        if state is None:
            return None
        task = state.tasks.get(req.shuffle_map_index)
        if task is None or task["rid"] != req.task_id:
            return None
        task["worker"], task["inc"] = worker_id, incarnation
        task["state"], task["ep"] = "pending", None
        state.workers_seen.add(worker_id)
        return state.sid

    def _on_shuffle_produced(self, handle: _ExecutorHandle, sid: int,
                             map_index: int, sizes: dict, ep) -> None:
        with self._lock:
            state = self._shuffles.get(sid)
            task = (state.tasks.get(map_index)
                    if state is not None else None)
            stale = (task is None
                     or task["worker"] != handle.worker_id
                     or task["inc"] != handle.incarnation)
            if not stale:
                task["state"] = "produced"
                task["sizes"] = {int(p): int(b) for p, b in sizes.items()}
                task["ep"] = tuple(ep)
        if stale:
            # a recycled incarnation's late announcement: the current
            # owner's (re-)produce governs — count and drop, like a
            # duplicate result
            self.metrics.count("shuffle_stale_produces")
            return
        self.metrics.count("shuffle_produced")
        self._broadcast_shuffle(sid)

    def _on_shuffle_ack(self, handle: _ExecutorHandle, sid: int,
                        map_index: int, part: int) -> None:
        with self._lock:
            state = self._shuffles.get(sid)
            task = (state.tasks.get(map_index)
                    if state is not None else None)
            if task is not None:
                task["acks"].add(int(part))
        self.metrics.count("shuffle_acks")

    def _broadcast_shuffle(self, sid: int) -> None:
        """Push one shuffle's current partition map to its participants
        (every worker that ever held one of its tasks)."""
        with self._lock:
            state = self._shuffles.get(sid)
            if state is None:
                return
            wire = state.wire_map()
            nparts = state.nparts
            conns = [h.conn for wid in state.workers_seen
                     for h in (self._handles.get(wid),)
                     if h is not None and h.health == _ALIVE]
        for conn in conns:
            conn.send((rpc.MSG_SHUFFLE_MAP, sid, nparts, wire))

    def _shuffle_cleanup(self, sid: int) -> None:
        """The shuffle's parent reached a terminal state: retire the
        partition map and tell every participant to free its store."""
        with self._lock:
            state = self._shuffles.pop(sid, None)
            if state is None:
                return
            conns = [h.conn for wid in state.workers_seen
                     for h in (self._handles.get(wid),)
                     if h is not None and h.health == _ALIVE]
        self.metrics.count("shuffles_completed")
        for conn in conns:
            conn.send((rpc.MSG_SHUFFLE_CLEANUP, sid))

    def _revive_shuffle_tasks(self, dead: _ExecutorHandle) -> None:
        """Data-plane lineage recovery on worker death: any LIVE
        shuffle's task located on the dead incarnation loses its
        produced data with the process.  Tasks whose lease is still live
        re-produce through the normal re-dispatch; a task whose lease
        already completed has nobody to re-run it — so the supervisor
        revives it as a produce-only child (``reproduce``) from the
        retained shard, keeping the partition available for consumers
        that have not fetched it yet."""
        revivals = []
        stale_sids = []
        with self._lock:
            for state in self._shuffles.values():
                for m, task in state.tasks.items():
                    if (task["worker"] != dead.worker_id
                            or task["inc"] != dead.incarnation):
                        continue
                    task["worker"], task["inc"] = -1, -1
                    task["state"], task["ep"] = "pending", None
                    stale_sids.append(state.sid)
                    if task["rid"] in self._leases:
                        continue  # live lease: re-dispatch re-produces
                    tid = self.sessions.next_task_id()
                    task["rid"] = tid
                    revival = Request(
                        handler=state.handler,
                        payload={"sid": state.sid, "m": m,
                                 "nparts": state.nparts, "rid": tid,
                                 "data": task["data"], "reproduce": True},
                        session_id="shuffle-revival", priority=1,
                        deadline=time.monotonic() + 30.0,
                        seq=next(self._seq), task_id=tid,
                        split_depth=1, no_batch=True,
                        shuffle_sid=state.sid, shuffle_map_index=m,
                        trace=(_trace.new_root(tid) if self._spans_on
                               else None),
                    )
                    revivals.append(revival)
        for sid in set(stale_sids):
            self._broadcast_shuffle(sid)
        for revival in revivals:
            self.metrics.count("shuffle_revivals")
            _flight.record(_flight.EV_LEASE_REDISPATCH, revival.task_id,
                           detail=f"rid:{revival.task_id}:"
                                  f"sid:{revival.shuffle_sid}:"
                                  f"map:{revival.shuffle_map_index}:"
                                  f"reproduce")
            self._requeue(revival)

    def _grant(self, req: Request) -> None:
        rid = req.task_id
        now_ns = time.monotonic_ns()
        # target choice and lease recording are ONE critical section: a
        # worker declared dead between a separate pick and record would
        # leave the lease pointing at an incarnation whose orphan scan
        # already ran — lost forever (review r10, pass 2)
        broadcast_sid = None
        with self._lock:
            candidates = [h for h in self._handles.values()
                          if h.health == _ALIVE
                          and len(h.inflight) < self.max_inflight_per_worker]
            target = (min(candidates, key=lambda h: len(h.inflight))
                      if candidates else None)
            if target is not None:
                lease = self._leases.get(rid)
                if lease is None:
                    lease = self._leases[rid] = _Lease(rid, req)
                    self._leases_total += 1
                if lease.completed:
                    return  # completed while queued (timeout race)
                # transition: lease queued->leased (fresh or re-dispatch:
                # both reach here in state QUEUED, pinned by the guard
                # in _worker_dead / the BUSY path before re-queueing)
                lease.state = _LEASED
                lease.worker_id = target.worker_id
                lease.incarnation = target.incarnation
                lease.dispatches += 1
                lease.granted_ns = now_ns
                target.inflight.add(rid)
                if req.shuffle_sid is not None and req.shuffle_map_index >= 0:
                    broadcast_sid = self._shuffle_task_located(
                        req, target.worker_id, target.incarnation)
        if target is None:
            # no live capacity right now (all dead/saturated/starting):
            # breathe, then line back up — deadline expiry in the queue
            # still bounds how long a request can wait for a survivor
            time.sleep(min(0.05, self.heartbeat_s))
            self._requeue(req)
            return
        if broadcast_sid is not None:
            # a (re-)located map task's old endpoint must stop being
            # consulted before the new incarnation's produce lands
            self._broadcast_shuffle(broadcast_sid)
        if req.response.admitted_ns == 0:
            req.response.admitted_ns = now_ns
            self.metrics.count("admitted", req.session_id)
            self.metrics.record_wait(now_ns - req.response.submitted_ns)
        # the queue-wait phase ends at the grant; the dispatch phase
        # (lease outstanding on one worker) opens, and ITS context crosses
        # the pipe so the worker's spans chain under the same rid
        _trace.close_span(req.qspan)
        req.qspan = None
        req.dspan = _trace.open_span(
            req.trace, _trace.SPAN_DISPATCH, task_id=rid,
            extra=f"worker:{target.worker_id}:inc:{target.incarnation}")
        self.metrics.count("leases_granted", req.session_id)
        _flight.record(_flight.EV_LEASE_GRANT, rid,
                       detail=f"rid:{rid}:worker:{target.worker_id}:"
                              f"inc:{target.incarnation}:"
                              f"handler:{req.handler}")
        deadline_rel = (None if req.deadline is None
                        else max(0.05, req.deadline - time.monotonic()))
        ok = target.conn.send((rpc.MSG_DISPATCH, rid, req.handler,
                               req.payload, deadline_rel, req.priority,
                               _trace.to_wire(req.dspan.ctx
                                              if req.dspan is not None
                                              else req.trace),
                               req.tenant))
        if not ok:
            # reclaim THIS lease explicitly: if the EOF path already ran
            # for this incarnation, _worker_dead below is a no-op and
            # would never re-scan — without this the lease is orphaned
            with self._lock:
                lease = self._leases.get(rid)
                reclaim = (lease is not None and not lease.completed
                           and lease.state == _LEASED
                           and lease.worker_id == target.worker_id
                           and lease.incarnation == target.incarnation)
                if reclaim:
                    lease.state = _QUEUED  # transition: lease leased->queued
                    if lease.redispatches == 0:
                        self._leases_redispatched += 1
                    lease.redispatches += 1
                    target.inflight.discard(rid)
            if reclaim:
                self.metrics.count("leases_redispatched")
                _flight.record(_flight.EV_LEASE_REDISPATCH, rid,
                               detail=f"rid:{rid}:"
                                      f"from:{target.worker_id}."
                                      f"{target.incarnation}:send_failed")
                self._requeue(req)
            self._worker_dead(target, "send_failed")

    def _on_result(self, handle: _ExecutorHandle, rid: int, status: str,
                   value: Any, err) -> None:
        requeue = False
        granted_ns = 0
        hedge_won = hedge_lost = hedge_shed = False
        with self._lock:
            lease = self._leases.get(rid)
            primary = (lease is not None and not lease.completed
                       and lease.state == _LEASED
                       and lease.worker_id == handle.worker_id
                       and lease.incarnation == handle.incarnation)
            # a hedge copy's answer is authoritative too: hedge fields
            # are incarnation-pinned exactly like the primary's, and the
            # check stands even if the primary died and re-queued in
            # between (queued->done is a declared lease edge)
            hedge = (not primary and lease is not None
                     and not lease.completed
                     and lease.hedge_state == _H_LAUNCHED
                     and lease.hedge_worker_id == handle.worker_id
                     and lease.hedge_incarnation == handle.incarnation)
            stale = not (primary or hedge)
            if not stale:
                granted_ns = lease.granted_ns
                handle.inflight.discard(rid)
                if hedge:
                    # the hedge attempt retires whatever it brought back
                    # (a result wins the lease below; BUSY abandons it —
                    # the primary still owns the lease)
                    lease.hedge_state = _H_NONE  # transition: hedge launched->none
                # a fetch that stalled out (dead peer mid-recovery, storm
                # of transport faults) is data-plane weather, not a
                # handler failure: re-dispatch like BUSY, bounded by the
                # same blast-radius cap hung leases get
                stalled = (status == ERROR and err
                           and err[0] == "ShuffleFetchStalled"
                           and lease.dispatches < self.lease_max_dispatches)
                if status == rpc.STATUS_BUSY or stalled:
                    if hedge:
                        hedge_shed = True  # lease untouched: primary runs on
                    else:
                        lease.state = _QUEUED  # transition: lease leased->queued
                        if lease.redispatches == 0:
                            self._leases_redispatched += 1
                        lease.redispatches += 1
                        requeue = True
                else:
                    # first terminal result completes the lease, whoever
                    # ran it; the loser's copy lands on the stale path
                    hedge_won = hedge
                    if primary and lease.hedge_state == _H_LAUNCHED:
                        hedge_lost = True
                        lease.hedge_state = _H_NONE  # transition: hedge launched->none
                    self._lease_done_locked(lease)
            else:
                # a LIVE loser (hedge raced a completed lease, or vice
                # versa) must free its inflight slot here — unlike a
                # recycled incarnation, no dead-worker sweep will
                handle.inflight.discard(rid)
        if stale:
            # a recycled worker's (or hedge loser's) late answer for an
            # already-settled lease: the winning dispatch owns
            # completion — count and drop
            self.metrics.count("duplicate_results")
            return
        req = lease.req
        if hedge_shed:
            self.metrics.count("hedge_losses")
            why = "busy" if status == rpc.STATUS_BUSY else "fetch_stalled"
            _flight.record(_flight.EV_HEDGE_LOSE, rid,
                           detail=f"rid:{rid}:reason:{why}")
            return
        if hedge_won:
            self.metrics.count("hedge_wins")
            _flight.record(_flight.EV_HEDGE_WIN, rid,
                           detail=f"rid:{rid}:worker:{handle.worker_id}")
        elif hedge_lost:
            self.metrics.count("hedge_losses")
            _flight.record(_flight.EV_HEDGE_LOSE, rid,
                           detail=f"rid:{rid}:reason:primary_won")
        if requeue:
            why = "busy" if status == rpc.STATUS_BUSY else "fetch_stalled"
            self.metrics.count("leases_redispatched")
            _flight.record(_flight.EV_LEASE_REDISPATCH, rid,
                           detail=f"rid:{rid}:from:{handle.worker_id}."
                                  f"{handle.incarnation}:{why}")
            self._requeue(req)
            return
        self.metrics.count("leases_completed", req.session_id)
        _flight.record(_flight.EV_LEASE_DONE, rid,
                       detail=f"rid:{rid}:worker:{handle.worker_id}:"
                              f"{status}")
        if status == OK:
            # END-TO-END latency as the front door promised it: submit ->
            # result, queue wait and every re-dispatch included (the
            # grant->result of the final attempt alone would hide exactly
            # the storms an SLO exists to catch).  This is the per-handler
            # distribution the burn-rate engine evaluates.
            t0_ns = req.response.submitted_ns or granted_ns
            if t0_ns:
                self.metrics.record_run(
                    time.monotonic_ns() - t0_ns, handler=req.handler)
            with self._lock:
                self._warm.add(req.handler)
            if req.rcache_key is not None:
                from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

                # the supervisor saw this result cross anyway — caching
                # it here is what makes the NEXT identical submit skip
                # the lease and the pipe entirely.  put() revalidates
                # the dependency versions stamped at submit, so a table
                # bumped while this request was leased drops the insert.
                if result_cache.put(req.rcache_key, value,
                                    req.rcache_deps, label=req.handler):
                    self.metrics.count("rcache_stores", req.session_id)
            self._finish(req, OK, value=value)
        elif status == TIMED_OUT:
            self._finish(req, TIMED_OUT, error=RequestTimeout(
                err[1] if err else "deadline expired in executor"))
        elif status == CANCELLED:
            self._finish(req, CANCELLED, error=RuntimeError(
                "executor cancelled the request"))
        else:
            tname, msg = err if err else ("unknown", "")
            self._finish(req, ERROR,
                         error=RemoteExecutorError(f"{tname}: {msg}"))

    # -- the monitor: health, hung leases, the ladder ------------------------
    def _monitor_loop(self) -> None:
        period = max(0.01, self.heartbeat_s)
        while not self._stop.wait(period):
            self._health_sweep()
            if self.slo is not None:
                self.slo.tick()
            self._ladder_tick()
            self._pressure_broadcast()
            self._ingest_own_events()

    def _ingest_own_events(self) -> None:
        """Merge THIS process's flight-ring delta into the live timeline
        (the supervisor's queue/dispatch spans, lease and ladder events
        live in its own ring, not in any worker's)."""
        if self.timeline is None:
            return
        import os as _os

        with self._tl_lock:
            events, self._tl_cursor = _flight.snapshot_since(
                self._tl_cursor)
            if events:
                self.timeline.ingest(_os.getpid(), time.time(),
                                     time.monotonic_ns(), events,
                                     incarnation=0, worker_id=-1)

    def _telemetry_view(self) -> dict:
        """The JSON view the local telemetry endpoint serves (one per
        connection): the merged cluster timeline plus everything a
        dashboard needs to label it."""
        from spark_rapids_jni_tpu_torch.serve.telemetry import TIMELINE_SCHEMA

        self._ingest_own_events()  # the view must include this instant
        return {
            "schema": TIMELINE_SCHEMA,
            "wall_t": time.time(),
            "timeline": self.timeline.merged(),
            "timeline_stats": self.timeline.stats(),
            "workers_telemetry": self.timeline.worker_metrics(),
            "supervisor": self.snapshot(),
            # per-tenant admission counters as the FRONT DOOR saw them
            # (shed/reject decisions happen here, not in any worker)
            "sessions": self.metrics.snapshot()["sessions"],
            "slo": self.slo.snapshot() if self.slo is not None else None,
            # per-tenant dominant-resource shares, cluster utilization,
            # capacity headroom (round 21 — the accounting plane)
            "attribution": self.attribution.snapshot(),
        }

    def telemetry_endpoint(self) -> Optional[tuple]:
        """(host, port) of the live telemetry endpoint, or None when the
        plane is disabled / the supervisor was built with start=False."""
        return (self._tl_server.endpoint if self._tl_server is not None
                else None)

    def _pressure_broadcast(self) -> None:
        """Federated admission (ROADMAP item 1's tail): aggregate the
        workers' heartbeat gauges into ONE cluster-wide pressure view and
        push it down to every worker's AdmissionController tick — knob
        decisions then see the cluster, not one process (ledger reasons
        carry a ``:cluster`` suffix when this signal drives them)."""
        with self._lock:
            alive = [h for h in self._handles.values()
                     if h.health == _ALIVE]
            gauges = [h.gauges for h in alive if h.gauges]
            conns = [h.conn for h in alive]
        if not gauges or not conns:
            return
        # refresh the fleet capacity model with the live executor count,
        # then summarize attribution into the same broadcast: workers'
        # admission controllers see tenant skew + headroom alongside
        # memory/queue pressure (acting on them is the next PR)
        self.attribution.set_capacity(
            workers=len(alive), threads=self._attrib_threads,
            budget_bytes=self._attrib_budget)
        cluster = {
            "blocked_frac": sum(float(g.get("blocked_frac", 0.0))
                                for g in gauges) / len(gauges),
            "mem_frac": max(float(g.get("mem_frac", 0.0))
                            for g in gauges),
            "queue_frac": self.queue.depth() / max(1, self.queue.maxsize),
            # SLO burn as first-class cluster pressure: every worker's
            # admission controller tightens when the service is burning
            # its declared budgets, not just when memory is short
            "slo_frac": (self.slo.pressure() if self.slo is not None
                         else 0.0),
            "workers": len(gauges),
        }
        cluster.update(self.attribution.pressure_gauges())
        for conn in conns:
            conn.send((rpc.MSG_PRESSURE, cluster))

    def _health_sweep(self) -> None:
        now = time.monotonic()
        now_ns = time.monotonic_ns()
        with self._lock:
            handles = list(self._handles.values())
            hang_ns = int(self.lease_hang_s * 1e9)
            hung = [lease for lease in self._leases.values()
                    if lease.state == _LEASED and not lease.completed
                    and now_ns - lease.granted_ns > hang_ns]
            # blast-radius cap: a request that has hung repeatedly must
            # not serially destroy the whole pool — after
            # lease_max_dispatches it fails terminally instead of
            # re-dispatching again (the worker it wedged still recycles)
            doomed = []
            for lease in hung:
                if lease.dispatches >= self.lease_max_dispatches:
                    doomed.append(lease.req)
                    self._lease_done_locked(lease)
            hung_keys = {(lease.worker_id, lease.incarnation)
                         for lease in hung}
        for req in doomed:
            _flight.record(_flight.EV_LEASE_DONE, req.task_id,
                           detail=f"rid:{req.task_id}:gave_up:"
                                  f"hung_x{self.lease_max_dispatches}")
            self._finish(req, ERROR, error=RuntimeError(
                f"request hung on {self.lease_max_dispatches} separate "
                f"executors (lease_hang_s={self.lease_hang_s:g} each)"))
        for h in handles:
            if h.health == _DEAD:
                continue
            if not h.proc.is_alive():
                self._worker_dead(h, "proc_exit")
            elif (h.health == _ALIVE and now - h.last_beat
                    > self.heartbeat_s * self.heartbeat_misses):
                self._worker_dead(h, "heartbeat_lost")
            elif (h.health == _STARTING
                    and now - h.last_beat > self.spawn_grace_s):
                self._worker_dead(h, "spawn_timeout")
            elif (h.worker_id, h.incarnation) in hung_keys:
                # crash-only hung-lease recovery: recycle the WHOLE
                # process (its wedged thread is unrecoverable anyway) and
                # let the shared dead-worker path re-dispatch
                _flight.record(_flight.EV_TASK_HUNG, -1,
                               detail=f"worker:{h.worker_id}:"
                                      f"inc:{h.incarnation}:hung_lease")
                self._worker_dead(h, "hung_lease")
        if self._hedge_on:
            self._hedge_sweep(now, now_ns)

    # -- speculative hedging (round 19) --------------------------------------
    def _windowed_p99_ns(self, now: float) -> Dict[str, tuple]:
        """handler -> (windowed completions, p99 ns): the cumulative
        per-handler latency histograms sampled each sweep, oldest
        in-window sample diffed away (serve/metrics.py documents exactly
        this caller pattern).  Monitor thread only."""
        counts = self.metrics.handler_latency_counts()
        self._hedge_lat.append((now, counts))
        while (len(self._hedge_lat) > 1
               and now - self._hedge_lat[1][0] > self.hedge_window_s):
            self._hedge_lat.popleft()
        base = self._hedge_lat[0][1]
        out = {}
        for handler, cum in counts.items():
            old = base.get(handler, ())
            window = [c - (old[i] if i < len(old) else 0)
                      for i, c in enumerate(cum)]
            n = sum(window)
            if n > 0:
                out[handler] = (n, percentile_of_counts(window, 99.0))
        return out

    def _hedge_sweep(self, now: float, now_ns: int) -> None:
        """Launch hedge copies for leases sitting past hedge_factor x
        their handler's windowed p99.  Same critical-section discipline
        as _grant: target choice and hedge bookkeeping are atomic under
        the lock, the pipe send happens outside it."""
        p99s = self._windowed_p99_ns(now)
        if not p99s:
            return
        launches = []
        with self._lock:
            # the budget is strict — hedges never exceed the configured
            # fraction of leases granted, no floor: a pool that has
            # served too few requests to afford a hedge doesn't hedge
            budget = int(self.hedge_budget_frac * self._leases_total)
            for lease in self._leases.values():
                if self._hedges_launched >= budget:
                    break
                if (lease.state != _LEASED or lease.completed
                        or lease.hedge_state != _H_NONE):
                    continue
                if lease.req.shuffle_sid is not None:
                    # never hedge shuffle participants: a duplicate map
                    # task would race the partition map's (worker, inc)
                    # ownership; stragglers there have their own
                    # revival/re-dispatch story
                    continue
                stat = p99s.get(lease.req.handler)
                if stat is None or stat[0] < self.hedge_min_samples:
                    continue
                age_ns = now_ns - lease.granted_ns
                if age_ns <= int(self.hedge_factor * stat[1]):
                    continue
                cands = [
                    h for h in self._handles.values()
                    if h.health == _ALIVE
                    and h.worker_id != lease.worker_id
                    and len(h.inflight) < self.max_inflight_per_worker]
                if not cands:
                    continue
                target = min(cands, key=lambda h: len(h.inflight))
                lease.hedge_state = _H_LAUNCHED  # transition: hedge none->launched
                lease.hedge_worker_id = target.worker_id
                lease.hedge_incarnation = target.incarnation
                lease.dispatches += 1
                self._hedges_launched += 1
                target.inflight.add(lease.rid)
                launches.append((lease, target, age_ns))
        for lease, target, age_ns in launches:
            req = lease.req
            self.metrics.count("hedges_launched", req.session_id)
            _flight.record(_flight.EV_HEDGE_LAUNCH, lease.rid,
                           detail=f"rid:{lease.rid}:"
                                  f"worker:{target.worker_id}:"
                                  f"inc:{target.incarnation}:"
                                  f"handler:{req.handler}",
                           value=age_ns)
            deadline_rel = (None if req.deadline is None
                            else max(0.05, req.deadline - time.monotonic()))
            ok = target.conn.send(
                (rpc.MSG_DISPATCH, lease.rid, req.handler, req.payload,
                 deadline_rel, req.priority,
                 _trace.to_wire(req.dspan.ctx if req.dspan is not None
                                else req.trace), req.tenant))
            if not ok:
                # reclaim THIS hedge explicitly (the _grant send-failure
                # twin): if the EOF path already ran for the target's
                # incarnation, _worker_dead below is a no-op
                with self._lock:
                    if (lease.hedge_state == _H_LAUNCHED
                            and lease.hedge_worker_id == target.worker_id
                            and lease.hedge_incarnation
                            == target.incarnation):
                        lease.hedge_state = _H_NONE  # transition: hedge launched->none
                        target.inflight.discard(lease.rid)
                self.metrics.count("hedge_losses")
                _flight.record(_flight.EV_HEDGE_LOSE, lease.rid,
                               detail=f"rid:{lease.rid}:"
                                      f"reason:send_failed")
                self._worker_dead(target, "send_failed")

    def _sample_stress(self) -> tuple:
        """(stress, dominant source name) — the source labels ladder
        ledger entries so an operator can tell an SLO-driven degrade
        from a capacity-driven one at a glance."""
        with self._lock:
            handles = list(self._handles.values())
        alive = [h for h in handles if h.health == _ALIVE]
        # missing capacity: dead workers plus RESPAWNING incarnations
        # (their capacity is genuinely absent until the new process says
        # hello).  Cold-start incarnation-0 spawns don't count — a pool
        # that has never been up is booting, not degraded.
        missing = sum(1 for h in handles
                      if h.health == _DEAD
                      or (h.health == _STARTING and h.incarnation > 0))
        dead_frac = missing / max(1, self.nworkers)
        queue_frac = self.queue.depth() / max(1, self.queue.maxsize)
        worker_press = max(
            (max(float(h.gauges.get("mem_frac", 0.0)),
                 float(h.gauges.get("blocked_frac", 0.0)))
             for h in alive), default=0.0)
        # a burning SLO pressures the ladder exactly like missing
        # capacity: degrade-and-shed is how a promise under burn gets
        # its budget back (the EV_SLO_BURN -> EV_DEGRADE_ENTER chain the
        # round-14 acceptance pins)
        slo_press = self.slo.pressure() if self.slo is not None else 0.0
        terms = (("capacity", dead_frac), ("queue", queue_frac),
                 ("workers", min(1.0, worker_press)), ("slo", slo_press))
        src, stress = max(terms, key=lambda t: t[1])
        return stress, src

    def _ladder_tick(self, stress: Optional[float] = None) -> None:
        """One degradation-ladder step: EWMA the stress signal, move at
        most one level per dwell window, record every transition."""
        src = "injected"
        if stress is None:
            if self._stress_source is not None:
                stress = self._stress_source()
            else:
                stress, src = self._sample_stress()
        transition = None
        with self._lock:
            self._ladder_tickno += 1
            tick = self._ladder_tickno
            ewma = (stress if self._stress_ewma is None
                    else self.degrade_alpha * stress
                    + (1.0 - self.degrade_alpha) * self._stress_ewma)
            self._stress_ewma = ewma
            level = self._level
            desired = sum(1 for t in self.degrade_up if ewma >= t)
            if tick - self._ladder_last_change < self.degrade_dwell_ticks:
                return
            if desired > level:
                new = level + 1
            elif (level > 0
                  and ewma <= self.degrade_up[level - 1]
                  - self.degrade_margin):
                new = level - 1
            else:
                return
            # analyze: ignore[state-machine] - new is level +- 1 by the
            # branch arithmetic above, exactly the _LADDER_TRANSITIONS
            # adjacency; dynamic arithmetic is invisible to the static
            # pass, and the down-AND-up ladder tests pin it at runtime
            self._level = new
            self._level_max_seen = max(self._level_max_seen, new)
            self._ladder_last_change = tick
            transition = {
                "tick": tick, "t_ns": time.monotonic_ns(),
                "from": DEGRADE_LEVELS[level], "to": DEGRADE_LEVELS[new],
                "level": new, "stress_ewma": round(ewma, 4),
                "source": src,
            }
            self.ledger.append(transition)
            del self.ledger[:-256]
        if transition["level"] > level:
            _flight.record(_flight.EV_DEGRADE_ENTER, -1,
                           detail=f"{transition['to']}:"
                                  f"ewma:{transition['stress_ewma']}",
                           value=transition["level"])
        else:
            _flight.record(_flight.EV_DEGRADE_EXIT, -1,
                           detail=f"{transition['to']}:"
                                  f"ewma:{transition['stress_ewma']}",
                           value=transition["level"])

    # -- the result cache's cluster surface (round 15) -----------------------
    def bump_table(self, name: str) -> int:
        """Declare "table ``name`` changed": bump the local version
        registry (reclaiming this process's dependent cache entries via
        the registered listener, synchronously — no lookup after this
        returns can serve the old version) and broadcast the new version
        to every live executor so worker-side caches converge.  The
        broadcast is monotonic on the worker (``tables.advance_to``), so
        reordered or duplicate deliveries are harmless."""
        from spark_rapids_jni_tpu_torch.models import tables as _tables

        version = _tables.bump(name)
        with self._lock:
            conns = [h.conn for h in self._handles.values()
                     if h.health == _ALIVE]
        for conn in conns:
            conn.send((rpc.MSG_TABLE_BUMP, name, version))
        return version

    # -- introspection / lifecycle ------------------------------------------
    def level(self) -> int:
        with self._lock:
            return self._level

    def lease_stats(self) -> dict:
        """The exactly-once ledger the chaos bench gates on.  Completed
        leases live only in the aggregates; the table holds live ones."""
        with self._lock:
            live = list(self._leases.values())
            total = self._leases_total
            completed = self._leases_completed
            redispatched = self._leases_redispatched
            hedged = self._hedges_launched
            maxd = max([self._lease_max_dispatches_seen]
                       + [le.dispatches for le in live])
        return {
            "leases": total,
            "completed": completed,
            "outstanding": len(live),
            "redispatched": redispatched,
            "hedged": hedged,
            "max_dispatches": maxd,
        }

    def snapshot(self) -> dict:
        with self._lock:
            workers = {
                str(h.worker_id): {
                    "state": h.health, "incarnation": h.incarnation,
                    "pid": h.pid, "inflight": len(h.inflight),
                    "gauges": dict(h.gauges),
                }
                for h in self._handles.values()
            }
            shuffles = {
                str(st.sid): {
                    "nparts": st.nparts,
                    "parent_rid": st.parent_rid,
                    "handler": st.handler,
                    "produced": sum(1 for t in st.tasks.values()
                                    if t["state"] == "produced"),
                    "acks": sum(len(t["acks"]) for t in st.tasks.values()),
                }
                for st in self._shuffles.values()
            }
            ladder = {
                "level": self._level,
                "level_name": DEGRADE_LEVELS[self._level],
                "max_level_seen": self._level_max_seen,
                "stress_ewma": (round(self._stress_ewma, 4)
                                if self._stress_ewma is not None else None),
                "ledger_tail": list(self.ledger)[-16:],
                "transitions": len(self.ledger),
            }
        rcache = None
        if self._rcache_on:
            from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

            rcache = result_cache.stats()
        tl = self.timeline
        return {
            "workers": workers,
            "ladder": ladder,
            "leases": self.lease_stats(),
            "shuffles": shuffles,
            "rcache": rcache,
            "queue_depth": self.queue.depth(),
            "counters": self.metrics.snapshot()["counters"],
            "telemetry": (tl.stats() if tl is not None else None),
            "telemetry_endpoint": (list(self._tl_server.endpoint)
                                   if self._tl_server is not None
                                   else None),
            "slo_burning": (self.slo.burning()
                            if self.slo is not None else []),
        }

    def wait_drained(self, timeout: float = 60.0) -> bool:
        """Block until every lease completed and the queue is empty."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                pending = bool(self._leases)  # live leases only
            if not pending and self.queue.outstanding() == 0:
                return True
            time.sleep(0.02)
        return False

    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        if drain:
            self.wait_drained(timeout)
        self._stop.set()
        dropped = self.queue.close()
        for req in dropped:
            self._credit(req)
            _trace.close_span(req.qspan)
            req.qspan = None
            self.metrics.count("cancelled", req.session_id)
            if req.join is not None:
                req.join.deliver(req.join_slot, CANCELLED, None,
                                 req.response.error)
        with self._lock:
            handles = list(self._handles.values())
            live = list(self._leases.values())
            orphans = [le.req for le in live]
            for le in live:
                self._lease_done_locked(le)
            live_sids = list(self._shuffles)
            self._shuffles.clear()
        # abandoned shuffles must not leak spooled frames on the shared
        # host: broadcast their cleanup before asking workers to exit
        for sid in live_sids:
            for h in handles:
                if h.conn is not None and h.health == _ALIVE:
                    h.conn.send((rpc.MSG_SHUFFLE_CLEANUP, sid))
        for h in handles:
            if h.conn is not None:
                h.conn.send((rpc.MSG_SHUTDOWN, self.dump_on_exit))
        for req in orphans:
            self._finish(req, CANCELLED,
                         error=RuntimeError("supervisor shut down"))
        for h in handles:
            if h.proc is not None:
                h.proc.join(timeout=5.0)
                if h.proc.is_alive():
                    h.proc.kill()
                    h.proc.join(timeout=2.0)
            if h.conn is not None:
                h.conn.close()
        for t in (self._dispatcher, self._monitor):
            if t is not None:
                t.join(timeout=5.0)
        if self._tl_server is not None:
            self._tl_server.close()
        _flight.unregister_telemetry_source(self._telemetry_name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

