"""The serving engine: worker pool + governed execution + split re-queueing
(PyTorch port of ``serve/executor.py``).

Composition point of the whole stack: requests admitted by the bounded
queue (serve/queue.py) are executed by a pool of worker threads, each
request bracketed through the memory governor exactly like a Spark task —
dedicated-thread registration (``task_context``), retry-block + working-set
reservation (``attempt_once``, the same protocol driver mem/governed.py
uses), and the reference's OOM protocol (RmmSpark.java:402-416) honored at
the serving level:

- ``RetryOOM``   -> the same request re-attempts in place (bounded, with
  the deadline checked between attempts);
- ``SplitAndRetryOOM`` / an over-budget working set -> the request's
  payload is SPLIT and the halves are RE-QUEUED as first-class requests
  (force-admitted: rejecting an admitted request's halves would lose work);
  a join object combines the halves' results into the parent's response;
- micro-batching: compatible small requests (same handler, batch-capable,
  not post-split) ride one device launch; a batch that draws a split
  signal is disbanded back into individual requests instead of split.

Every handler execution crosses ``seam(SERVE, "handle:<name>")`` — the
profiler sees one range per served request and the chaos injector can fail
or OOM a request mid-protocol (test_serve_chaos.py).

The port's engine runs its handlers on one card: over ``mesh`` when one is
given (a one-rank NCCL mesh from ``parallel.one_rank_mesh`` on one card),
else on ``device`` -- the card unless the caller asks for the CPU.  No
process group is made implicitly.  Every handler returns host values (the
runners download their outputs), so each latency and busy reading below is
taken after the result is on the host, never over asynchronous device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import random
import threading
import time
import weakref
from typing import Any, Callable, List, Optional, Sequence

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.mem.exceptions import RetryOOM, SplitAndRetryOOM
from spark_rapids_jni_tpu_torch.mem.governed import (
    ShuffleCapacityExceeded,
    attempt_once,
    default_device_budget,
    task_context,
)
from spark_rapids_jni_tpu_torch.mem.governor import MemoryGovernor, OutOfBudget
from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.obs import trace as _trace
from spark_rapids_jni_tpu_torch.obs.seam import SERVE, seam
from spark_rapids_jni_tpu_torch.serve import attribution as _attrib
from spark_rapids_jni_tpu_torch.serve.metrics import ServeMetrics
from spark_rapids_jni_tpu_torch.serve.queue import (
    CANCELLED,
    ERROR,
    OK,
    TIMED_OUT,
    AdmissionQueue,
    Backpressure,
    Request,
    RequestTimeout,
    Response,
)
from spark_rapids_jni_tpu_torch.serve.session import (
    Session,
    SessionBudgetExceeded,
    SessionRegistry,
)

__all__ = ["HandlerContext", "QueryHandler", "ServingEngine",
           "register_builtin_handlers", "split_till"]

# get_json_object's device arm is launch-bound Python (hundreds of thousands
# of small kernels a call): calls made at once contend for the interpreter
# lock and run slower than one after another (four 1,024-row 8-path calls at
# once took 27.5 s on an H100, one alone 1.8-2.7 s: chip_smoke.serve_json_probe),
# so the built-in handler runs one such call at a time on the card
_JSON_DEVICE_LOCK = threading.Lock()

# one-time (per process) misconfiguration warning: micro_batch_max <= 1
# disables micro-batching entirely, which used to be silent
_BATCH_DISABLED_WARNED = []


def _warn_batching_disabled(value: int) -> None:
    if _BATCH_DISABLED_WARNED:
        return
    _BATCH_DISABLED_WARNED.append(value)
    import warnings

    warnings.warn(
        f"micro_batch_max={value} disables micro-batching entirely "
        f"(and serve_ragged is off): every request launches alone. "
        f"Set micro_batch_max >= 2 or enable serve_ragged; snapshots "
        f"carry gauges.micro_batch_disabled=1 while this persists.",
        RuntimeWarning, stacklevel=3)


def split_till(payload: Any, split: Callable[[Any], Sequence[Any]], *,
               want_parts: Optional[int] = None,
               max_levels: Optional[int] = None) -> tuple:
    """Repeatedly apply ``split`` (halves per level) until ``want_parts``
    pieces or ``max_levels`` levels are reached, or splitting stalls
    (``split`` stops producing more than one piece).  Returns
    ``(parts, levels)`` — the one split-expansion loop shared by the
    engine's pre-dispatch split and the supervisor's cross-executor
    fan-out."""
    parts = [payload]
    levels = 0
    while ((want_parts is None or len(parts) < want_parts)
           and (max_levels is None or levels < max_levels)):
        nxt: List[Any] = []
        for p in parts:
            sub = list(split(p))
            nxt.extend(sub if len(sub) > 1 else [p])
        if len(nxt) == len(parts):
            break  # not splittable further
        parts = nxt
        levels += 1
    return parts, levels


@dataclasses.dataclass(frozen=True)
class HandlerContext:
    """What a handler sees of the engine (one admitted request's view);
    ``device`` is the engine's (the mesh's device under a mesh)."""

    mesh: Any
    budget: Any
    gov: MemoryGovernor
    task_id: int
    device: Any = None


@dataclasses.dataclass
class QueryHandler:
    """A registered query type.

    ``fn(payload, ctx)`` runs the work; ``nbytes_of(payload)`` estimates
    the working set the executor reserves before launch.  Optional hooks:

    - ``split``/``combine``: enable split-requeue on SplitAndRetryOOM;
    - ``grow``: re-attempt with grown buffers on ShuffleCapacityExceeded
      (the exchange-overflow retry);
    - ``batch``/``unbatch``: enable micro-batching (``batch(payloads)``
      merges, ``unbatch(result, payloads)`` redistributes);
    - ``ragged``: a :class:`serve.ragged.RaggedSpec` opting the handler
      into continuous ragged batching — arbitrary concurrent requests
      pack into the fixed-size page pool and ride ONE fused launch per
      tick (used only when the engine's ``serve_ragged`` flag is on; the
      micro-batch hooks above stay the flag-off oracle);
    - ``cache_key``/``cache_tables``: opt the handler into the governed
      result cache (plans/rcache.py, round 15; engine flag
      ``serve_result_cache``).  ``cache_key(payload)`` returns a
      hashable payload identity (embed ``rcache.array_digest`` for any
      data the payload ships — equal keys must imply bit-equal inputs)
      or None for "this payload is uncacheable"; ``cache_tables`` is the
      named-table dependency set (a static sequence or
      ``fn(payload) -> names``) whose versions ride the fingerprint, so
      a ``models/tables.bump`` makes stale entries unreachable.  A hit
      never enters the governed bracket;
    - ``self_governed``: fn drives its own admission (the models/ runners,
      which internally run run_with_split_retry) — the executor supplies
      only the task context and skips its own reservation bracket.
    """

    name: str
    fn: Callable[[Any, HandlerContext], Any]
    nbytes_of: Callable[[Any], int] = lambda payload: 0
    split: Optional[Callable[[Any], Sequence[Any]]] = None
    combine: Optional[Callable[[List[Any]], Any]] = None
    grow: Optional[Callable[[Any], Any]] = None
    batch: Optional[Callable[[List[Any]], Any]] = None
    unbatch: Optional[Callable[[Any, List[Any]], List[Any]]] = None
    ragged: Any = None  # Optional[serve.ragged.RaggedSpec]
    cache_key: Optional[Callable[[Any], Any]] = None
    cache_tables: Any = ()  # Sequence[str] | Callable[[Any], Sequence]
    self_governed: bool = False
    max_batch: int = 8
    max_grows: int = 8


class _SplitJoin:
    """Combines re-queued halves' results into the parent's response."""

    def __init__(self, parent: Request, combine: Callable, n: int,
                 finish: Callable):
        self.parent = parent
        self.combine = combine
        self.slots: List[Any] = [None] * n
        self.remaining = n
        self.error: Optional[BaseException] = None
        self.error_status = ERROR
        self._lock = threading.Lock()
        self._finish = finish  # engine._finish (metrics + session credit)

    def deliver(self, slot: int, status: str, value: Any,
                error: Optional[BaseException]) -> None:
        with self._lock:
            if status == OK:
                self.slots[slot] = value
            elif self.error is None:
                self.error, self.error_status = error, status
            self.remaining -= 1
            done = self.remaining == 0
        if not done:
            return
        if self.error is None:
            try:
                self._finish(self.parent, OK, value=self.combine(self.slots))
            except (RetryOOM, SplitAndRetryOOM, ShuffleCapacityExceeded) as e:
                # combine runs outside any retry bracket and the halves are
                # already consumed: a control signal here cannot be retried
                # or re-split — terminal failure, never silently swallowed
                self._finish(self.parent, ERROR, error=e)
            except Exception as e:  # noqa: BLE001 - combine failure
                self._finish(self.parent, ERROR, error=e)
        else:
            self._finish(self.parent, self.error_status, error=self.error)


class ServingEngine:
    """Multi-tenant front door over one mesh (or one device) + one governed
    budget."""

    def __init__(self, *, mesh=None, device: _device.DeviceLike = None,
                 gov: Optional[MemoryGovernor] = None,
                 budget=None, workers: Optional[int] = None,
                 queue_size: Optional[int] = None,
                 default_deadline_s: Optional[float] = 30.0,
                 micro_batch_max: int = 8, max_split_depth: int = 8,
                 builtin_handlers: bool = False,
                 adaptive: Optional[bool] = None,
                 serve_ragged: Optional[bool] = None):
        from spark_rapids_jni_tpu_torch import config

        if workers is None:
            workers = int(config.get("serve_workers"))
        if queue_size is None:
            queue_size = int(config.get("serve_queue_size"))
        if adaptive is None:
            adaptive = bool(config.get("serve_adaptive"))
        if serve_ragged is None:
            serve_ragged = bool(config.get("serve_ragged"))
        from spark_rapids_jni_tpu_torch.plans.compiler import plan_device

        # handlers run on the mesh's device under a mesh, else on ``device``
        # (the card unless the caller asks for the CPU); unlike the JAX
        # engine, no mesh (and no process group) is made implicitly
        self.mesh = mesh
        self.device = plan_device(mesh, device)
        self.gov = gov if gov is not None else MemoryGovernor.instance()
        self.budget = (budget if budget is not None
                       else default_device_budget(self.gov))
        self.default_deadline_s = default_deadline_s
        self.micro_batch_max = micro_batch_max
        self.max_split_depth = max_split_depth
        # continuous ragged batching (serve/ragged.py): packs arbitrary
        # same-handler requests into the fixed-size page pool and fuses
        # one launch per tick.  Off (default) keeps the micro-batcher
        # bit-identical to round 11 — the parity oracle.
        self.serve_ragged = serve_ragged
        # span rooting rides the telemetry-plane flag (cached: submit is
        # the hot path): with the plane off, NO span events enter the
        # ring and anomaly dumps keep their full round-13 governance
        # history capacity.  A trace that already crossed the pipe is
        # always continued — the supervisor decided for the cluster.
        self._spans_on = bool(config.get("serve_telemetry"))
        self._ragged = None
        if serve_ragged:
            from spark_rapids_jni_tpu_torch.serve.ragged import RaggedDispatcher

            self._ragged = RaggedDispatcher(self)
        # the governed result cache (plans/rcache.py, round 15): hits
        # short-circuit before the handler bracket.  Binding the engine's
        # budget gives the HBM tier its byte source AND registers the
        # pressure demoter — cached residency competes under the SAME
        # budget live queries admit through.
        self._rcache_on = bool(config.get("serve_result_cache"))
        if self._rcache_on:
            from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

            result_cache.bind_budget(self.budget, device=self.device)
        if micro_batch_max <= 1 and not serve_ragged:
            # a silent no-batching configuration is the misconfiguration
            # the batch-miss observability exists to surface: warn once
            # per process, and _gauges() exports micro_batch_disabled so
            # every serve snapshot carries the signal
            _warn_batching_disabled(micro_batch_max)
        # Multi-threaded serving over one process-local device group:
        # concurrent collective launches wedge the single-process CPU
        # rendezvous runtime, so collective crossings serialize at the
        # seam (inside every runner's budget reservation — lock order
        # budget -> launch, acyclic).  Idempotent and process-global.
        from spark_rapids_jni_tpu_torch.obs import seam as _seam

        _seam.serialize_category(_seam.COLLECTIVE)
        self.metrics = ServeMetrics()
        self.sessions = SessionRegistry()
        self.queue = AdmissionQueue(
            queue_size,
            retry_after_hint=self._retry_after,
            on_timeout=self._on_queue_timeout,
        )
        self._seq = itertools.count()
        # registration is exists-check + insert under _reg_lock; READS
        # are deliberately lock-free (GIL-atomic dict gets on a dict that
        # only grows at startup) and carry per-site suppressions below
        self._handlers: dict = {}  # guarded-by: _reg_lock
        self._reg_lock = threading.Lock()  # guards handler registration
        # adaptive-admission state (serve/controller.py): the static knob
        # values the kill switch restores, per-handler pre-emptive split
        # depths the controller sets, and per-handler split history it
        # reads.  One leaf lock, never held across calls into other layers.
        self.static_queue_size = queue_size
        self._ctl_lock = threading.Lock()
        # handler -> pre-dispatch split depth  # guarded-by: _ctl_lock
        self._presplit: dict = {}
        # handler -> cumulative splits seen  # guarded-by: _ctl_lock
        self._class_splits: dict = {}
        self._ewma_lock = threading.Lock()
        self._ewma_service_s = 0.05  # guarded-by: _ewma_lock
        # queue-saturation detector: N consecutive backpressure rejections
        # with no successful admit in between trigger a flight-recorder
        # anomaly dump (obs/flight.py)
        self._sat_lock = threading.Lock()
        self._sat_rejects = 0  # guarded-by: _sat_lock
        self._sat_threshold = int(config.get("flight_saturation_rejects"))
        # seeded retry-after jitter: split children of one batch land back
        # in their clients' retry loops at the SAME instant, and an
        # unjittered hint marches them all back through the front door in
        # lockstep (a thundering herd the governor then re-splits).  The
        # RNG is seeded from config so chaos runs stay replayable.
        self._jitter = random.Random(int(config.get(
            "serve_retry_jitter_seed")))
        # hung-task watchdog: per-popped-request start stamps the watchdog
        # thread sweeps (leaf lock, nothing else acquired while held)
        self._inflight_lock = threading.Lock()
        # worker name -> [req, t0_ns, flagged]  # guarded-by: _inflight_lock
        self._inflight: dict = {}
        # handler -> EWMA service seconds  # guarded-by: _ewma_lock
        self._ewma_by_handler: dict = {}
        self._hang_factor = float(config.get("serve_hang_factor"))
        self._hang_min_s = float(config.get("serve_hang_min_s"))
        self._hang_stop = threading.Event()
        # post-serve hook (round 14, serve/rpc.py): runs on the WORKER
        # thread after a popped request's group fully served — by then
        # every span-close finally block has run, so a telemetry
        # force-flush here deterministically ships a completed request's
        # whole story before a chaos SIGKILL can eat it
        self.on_served: Optional[Callable[[], None]] = None
        self.metrics.set_gauge_source(self._gauges)
        self._telemetry_name = f"serve:{id(self):x}"
        # weakly referenced, like the governor/spill gauge registries: an
        # engine that is never shut down (crash path, abandoned test
        # instance) must not be pinned forever by the process-global
        # recorder, and its source self-unregisters once collected
        wm = weakref.WeakMethod(self.metrics.snapshot)
        name = self._telemetry_name

        def _sample(wm=wm, name=name):
            fn = wm()
            if fn is None:
                _flight.unregister_telemetry_source(name)
                return {"error": "engine collected"}
            return fn()

        _flight.register_telemetry_source(name, _sample)
        if builtin_handlers:
            register_builtin_handlers(self)
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"serve-worker-{i}")
            for i in range(workers)
        ]
        for t in self._workers:
            t.start()
        self._hang_watchdog = None
        if self._workers and self._hang_factor > 0:
            self._hang_watchdog = threading.Thread(
                target=self._hang_watchdog_loop, daemon=True,
                name="serve-hang-watchdog")
            self._hang_watchdog.start()
        self.adaptive = adaptive
        self.controller = None
        if adaptive:
            from spark_rapids_jni_tpu_torch.serve.controller import (
                AdmissionController,
            )

            self.controller = AdmissionController(self)
            self.controller.start()

    def note_cluster_pressure(self, gauges: dict) -> None:
        """Cluster-wide pressure from the supervisor (federated
        admission, serve/rpc.py MSG_PRESSURE): forwarded into the
        admission controller's tick; a no-op on static engines."""
        c = self.controller
        if c is not None:
            c.note_cluster_pressure(gauges)

    # -- registration / sessions -------------------------------------------
    def register(self, handler: QueryHandler) -> None:
        if (handler.batch is None) != (handler.unbatch is None):
            raise ValueError("batch and unbatch must be provided together")
        if handler.split is not None and handler.combine is None:
            raise ValueError("split requires combine")
        # exists-check + insert under one lock: two concurrent registers of
        # the same name must not both pass the check (workers read the dict
        # concurrently; the GIL makes the reads safe, not this write race)
        with self._reg_lock:
            if handler.name in self._handlers:
                raise ValueError(
                    f"handler {handler.name!r} already registered")
            self._handlers[handler.name] = handler

    def open_session(self, name: Optional[str] = None, *, priority: int = 0,
                     byte_budget: Optional[int] = None) -> Session:
        sess = self.sessions.open(name, priority=priority,
                                  byte_budget=byte_budget)
        if self.controller is not None:  # join at the CURRENT posture,
            # not the static one (a tenant arriving mid-overload must not
            # enforce its full static budget until the next adjustment)
            self.controller.apply_to_new_session(sess)
        return sess

    def close_session(self, session: Session) -> None:
        self.sessions.close(session)

    # -- the producer surface ----------------------------------------------
    def submit(self, session: Session, handler: str, payload: Any, *,
               priority: Optional[int] = None,
               deadline_s: Optional[float] = None,
               trace: Any = None, tenant: Optional[str] = None) -> Response:
        """Admit one request; returns its :class:`Response`.

        Raises :class:`Backpressure` (queue full — retry after the hint) or
        :class:`SessionBudgetExceeded` (the session is over its byte
        budget) — both clean rejections; the request never queues.

        ``trace`` continues an upstream span context (the supervisor's
        dispatch span, carried over MSG_DISPATCH): the worker's queue and
        compute spans then chain under the SAME rid across processes.
        Without it the request roots a fresh trace on its own task id.

        ``tenant`` names the billing identity the request's attribution
        record rolls up under (serve/attribution.py); it defaults to the
        session id — the right answer for front-door submits, while the
        cluster worker engines (one ``lease:wN`` session each) pass the
        tenant the supervisor carried over MSG_DISPATCH.
        """
        # analyze: ignore[guarded-by] - hot-path read of a registration
        # dict that only grows at startup; a GIL-atomic get needs no lock
        # (the _reg_lock guards the register-register write race only)
        h = self._handlers.get(handler)
        if h is None:
            raise KeyError(f"no handler {handler!r} registered")
        nbytes = int(h.nbytes_of(payload))
        try:
            session.charge(nbytes)
        except SessionBudgetExceeded:
            self.metrics.count("rejected_session", session.session_id)
            raise
        dl = deadline_s if deadline_s is not None else self.default_deadline_s
        tid = self.sessions.next_task_id()
        # span lineage: continue the supervisor's dispatch span when one
        # crossed the pipe (same rid), else root a fresh trace here
        # (unless the telemetry plane is off — untraced requests record
        # no span events at all)
        ctx = (_trace.child_of(trace) if trace is not None
               else _trace.new_root(tid) if self._spans_on else None)
        req = Request(
            handler=handler, payload=payload,
            session_id=session.session_id,
            # session.age_boost is the controller's anti-starvation knob
            # (0 under static config): an explicit per-request priority
            # still wins outright
            priority=(priority if priority is not None
                      else session.priority + session.age_boost),
            deadline=(time.monotonic() + dl) if dl is not None else None,
            seq=next(self._seq),
            task_id=tid,
            trace=ctx,
            tenant=(tenant if tenant else session.session_id),
        )
        req.charge_bytes = nbytes
        req.session = session
        # the queue span opens BEFORE the request becomes poppable: a
        # worker may pop and close it the instant submit returns, so
        # opening afterwards would race (and leak an unclosed span)
        req.qspan = _trace.open_span(ctx, _trace.SPAN_QUEUE, task_id=tid,
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
            with self._sat_lock:
                self._sat_rejects += 1
                saturated = self._sat_rejects >= self._sat_threshold
                if saturated:
                    self._sat_rejects = 0
            if saturated:
                _flight.anomaly("queue_saturation",
                                detail=f"depth={self.queue.depth()} "
                                       f"rejects={self._sat_threshold}")
            raise
        except BaseException:  # closed queue (shutdown): no charge leaks
            session.credit(nbytes)
            _trace.close_span(req.qspan)
            req.qspan = None
            raise
        with self._sat_lock:
            self._sat_rejects = 0
        self.metrics.count("submitted", session.session_id)
        self.metrics.set_depth(self.queue.depth())
        return req.response

    def _gauges(self) -> dict:
        """Memory-pressure gauges for metrics snapshots: governor budget
        bytes, spill-pool bytes, and the compiled-plan cache (hit/miss/
        entries — compile-variant churn shows up beside memory pressure
        in the same snapshot)."""
        from spark_rapids_jni_tpu_torch.mem.governor import budget_gauges
        from spark_rapids_jni_tpu_torch.mem.spill import pool_gauges
        from spark_rapids_jni_tpu_torch.plans.cache import plan_cache

        g = {"gov_" + k: v for k, v in budget_gauges().items()}
        sp = pool_gauges()
        g["spill_pool_bytes"] = sp["device_bytes"]
        g["spill_spilled_bytes"] = sp["spilled_bytes"]
        g["spill_count"] = sp["spill_count"]
        pc = plan_cache.stats()
        for k in ("hits", "misses", "entries", "evictions"):
            g[f"plan_cache_{k}"] = int(pc[k])
        # misconfiguration visibility: every snapshot says whether this
        # engine can batch at all (see _warn_batching_disabled)
        g["micro_batch_disabled"] = int(
            self.micro_batch_max <= 1 and not self.serve_ragged)
        if self._rcache_on:
            from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

            # the result cache's residency + flow as gauges: per-tier
            # bytes/entries beside the hit/miss counters, so one snapshot
            # answers "is the cache earning its bytes under this budget"
            rs = result_cache.stats()
            for k in ("entries", "hbm_bytes", "host_bytes", "disk_bytes",
                      "hbm_entries", "host_entries", "disk_entries",
                      "hits", "misses", "stores", "evictions",
                      "demotes_hbm_host", "demotes_host_disk",
                      "invalidated", "stale_puts", "corrupt_drops"):
                g[f"rcache_{k}"] = int(rs[k])
        if self._ragged is not None:
            from spark_rapids_jni_tpu_torch.columnar.pages import page_pool

            # the ragged win conditions as gauges: launches saved (riders
            # that shared a fused launch), pool occupancy (packed rows /
            # pool capacity), and the host page-pool recycling stats
            m = self.metrics
            launches = m.get("ragged_launches")
            g["ragged_launches_saved"] = m.get("ragged_batched") - launches
            cap = m.get("ragged_row_capacity")
            g["ragged_occupancy_pct"] = int(
                100 * m.get("ragged_rows") / cap) if cap else 0
            for k, v in page_pool.gauges().items():
                g[f"page_pool_{k}"] = int(v)
        return g

    # -- lifecycle ----------------------------------------------------------
    def shutdown(self, drain: bool = True, timeout: float = 60.0) -> None:
        """Stop serving.  ``drain=True`` waits for queued + in-flight work
        first; anything still queued after the wait (or with drain=False)
        completes as cancelled — never silently lost."""
        deadline = time.monotonic() + timeout
        self._hang_stop.set()
        if self.controller is not None:
            self.controller.stop()
        if drain:
            # queued + popped-but-unfinished under ONE lock: no window
            # where an in-flight request is invisible to the drain
            self.queue.wait_idle(timeout=timeout)
        dropped = self.queue.close()
        for req in dropped:
            self._credit(req)
            _trace.close_span(req.qspan)
            req.qspan = None
            self.metrics.count("cancelled", req.session_id)
            if req.join is not None:  # cancelled halves still join (above)
                req.join.deliver(req.join_slot, CANCELLED, None,
                                 req.response.error)
        for t in self._workers:
            t.join(timeout=max(0.1, deadline - time.monotonic()))
        self.metrics.set_depth(0)
        _flight.unregister_telemetry_source(self._telemetry_name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- adaptive-admission surface (serve/controller.py) -------------------
    def set_presplit(self, handler: str, depth: int) -> None:
        """Controller knob: split ``handler`` requests ``depth`` times
        BEFORE dispatch (0 clears).  Only top-level splittable requests
        pre-split; halves and self-governed handlers are untouched."""
        with self._ctl_lock:
            if depth <= 0:
                self._presplit.pop(handler, None)
            else:
                self._presplit[handler] = min(int(depth),
                                              self.max_split_depth)

    def presplit_depth(self, handler: str) -> int:
        with self._ctl_lock:
            return self._presplit.get(handler, 0)

    def presplit_map(self) -> dict:
        with self._ctl_lock:
            return dict(self._presplit)

    def class_split_counts(self) -> dict:
        """Cumulative reactive TOP-LEVEL splits per handler class — the
        history the controller turns into pre-emptive split depths.  Only
        depth-0 splits count: a pre-split (or half) that splits again is
        either deeper real pressure the NEXT top-level split will re-report
        or injected chaos weather — escalating on it would ratchet the
        knob toward max depth under any sustained fault storm."""
        with self._ctl_lock:
            return dict(self._class_splits)

    def _note_class_split(self, handler: str, n: int = 1) -> None:
        with self._ctl_lock:
            self._class_splits[handler] = (
                self._class_splits.get(handler, 0) + n)

    # -- internals ----------------------------------------------------------
    def _retry_after(self, depth: int) -> float:
        """Backpressure retry hint: EWMA-of-service x occupancy, spread by
        seeded jitter over [0.5x, 1.5x) so synchronized rejectees (split
        children, batch disbands) de-phase instead of thundering back in
        lockstep.  Deterministic under a fixed serve_retry_jitter_seed
        (pinned by test_serve_executor)."""
        with self._ewma_lock:
            per_req = self._ewma_service_s
            u = self._jitter.random()
        base = per_req * depth / max(len(self._workers), 1)
        return min(5.0, max(0.005, base * (0.5 + u)))

    def _credit(self, req: Request) -> None:
        sess = getattr(req, "session", None)
        if sess is not None:
            sess.credit(getattr(req, "charge_bytes", 0))
            req.session = None  # credit exactly once

    def _on_queue_timeout(self, req: Request) -> None:
        """Queue-side expiry (response already completed by the queue)."""
        self._credit(req)
        _trace.close_span(req.qspan)
        req.qspan = None
        self.metrics.count("timed_out", req.session_id)
        _flight.record(_flight.EV_QUEUE_TIMEOUT, req.task_id,
                       detail=f"handler:{req.handler}")
        if req.join is not None:  # an expired split half still joins: the
            # parent must reach a terminal state, not hang on the slot
            req.join.deliver(req.join_slot, TIMED_OUT, None,
                             req.response.error)

    def _finish(self, req: Request, status: str, value: Any = None,
                error: Optional[BaseException] = None) -> None:
        """Single terminal-state owner: completes the response (first
        completion wins), credits the session, counts, delivers joins."""
        first = req.response._complete(status, value=value, error=error)
        if not first:
            return
        self._credit(req)
        rec = req.attrib
        if rec is not None:
            # fold the governor-side per-task accumulators (blocked
            # time, retry/split deliveries) in at the terminal state,
            # then emit the record as ONE EV_ATTRIB event — first-wins
            # completion makes double emission structurally impossible
            st = _flight.task_stat(req.task_id)
            if st is not None:
                rec.blocked_ns = st["blocked_ns"]
                rec.retries = st["retries"]
                rec.splits = st["split_retries"]
            _attrib.emit(rec, task_id=req.task_id)
        # terminal state: no phase span may outlive the request (close is
        # idempotent, so paths that already closed these cost nothing)
        _trace.close_span(req.qspan)
        req.qspan = None
        counter = {OK: "completed", TIMED_OUT: "timed_out",
                   CANCELLED: "cancelled"}.get(status, "failed")
        self.metrics.count(counter, req.session_id)
        if status == ERROR and isinstance(error, MemoryError):
            # the serving analog of an OOM-killed task: the governor's
            # protocol gave up on this request (terminal OutOfBudget /
            # split-depth cap / device OOM) — anomaly-dump the ring while
            # the transition history leading here is still in it
            _flight.record(_flight.EV_TASK_KILLED, req.task_id,
                           detail=type(error).__name__)
            _flight.anomaly("task_oom_killed",
                            detail=f"task={req.task_id} "
                                   f"handler={req.handler}")
        if req.join is not None:
            req.join.deliver(req.join_slot, status, value, error)

    def _worker_loop(self) -> None:
        me = threading.current_thread().name
        while True:
            req = self.queue.pop()
            if req is None:
                return  # queue closed and drained
            self.metrics.set_depth(self.queue.depth())
            t0 = time.monotonic()
            with self._inflight_lock:
                self._inflight[me] = [req, time.monotonic_ns(), False]
            # _serve returns every popped member to the queue's
            # outstanding count itself (incl. batch mates); on an
            # unexpected escape only the primary is outstanding here
            try:
                self._serve(req)
            except (RetryOOM, SplitAndRetryOOM, ShuffleCapacityExceeded) as e:
                # a governor control-flow signal leaked past every bracket:
                # a protocol bug, not a handler failure.  Fail the request
                # loudly (counted separately) and keep the worker alive —
                # re-raising here would silently kill the pool thread.
                self.metrics.count("protocol_leaked", req.session_id)
                self._finish(req, ERROR, error=e)
            except Exception as e:  # noqa: BLE001 - never kill the worker
                self._finish(req, ERROR, error=e)
            finally:
                dt = time.monotonic() - t0
                with self._inflight_lock:
                    self._inflight.pop(me, None)
                with self._ewma_lock:
                    self._ewma_service_s = (0.8 * self._ewma_service_s
                                            + 0.2 * dt)
                    prev = self._ewma_by_handler.get(req.handler, dt)
                    self._ewma_by_handler[req.handler] = (0.8 * prev
                                                          + 0.2 * dt)
                self.metrics.publish()
                cb = self.on_served
                if cb is not None:
                    try:
                        cb()
                    # analyze: ignore[retry-protocol] - the post-serve
                    # telemetry hook crosses no seam and owns no retry
                    # context; any failure (pipe mid-death) must never
                    # kill the pool worker
                    except Exception:  # noqa: BLE001
                        pass

    def _hang_watchdog_loop(self) -> None:
        """Sweep in-flight requests for handlers running far past their
        class EWMA (``serve_hang_factor x``, floored at serve_hang_min_s).
        A hung handler silently eats a pool worker forever — the watchdog
        cannot unwedge the thread (crash-only recovery is the supervisor
        tier's job), but it makes the wedge LOUD: one EV_TASK_HUNG + one
        rate-limited anomaly dump per stuck request, while the transition
        history that led there is still in the ring."""
        period = max(0.02, min(1.0, self._hang_min_s / 4.0))
        while not self._hang_stop.wait(period):
            now_ns = time.monotonic_ns()
            hung = []
            with self._ewma_lock:
                ewmas = dict(self._ewma_by_handler)
            with self._inflight_lock:
                for entry in self._inflight.values():
                    req, t0_ns, flagged = entry
                    if flagged:
                        continue
                    bound_s = max(self._hang_min_s, self._hang_factor
                                  * ewmas.get(req.handler, 0.0))
                    elapsed_ns = now_ns - t0_ns
                    if elapsed_ns > bound_s * 1e9:
                        entry[2] = True
                        hung.append((req, elapsed_ns, bound_s))
            for req, elapsed_ns, bound_s in hung:
                self.metrics.count("hung", req.session_id)
                _flight.record(_flight.EV_TASK_HUNG, req.task_id,
                               detail=f"handler:{req.handler}:"
                                      f"bound_ms:{bound_s * 1e3:.0f}",
                               value=elapsed_ns)
                _flight.anomaly("task_hung",
                                detail=f"task={req.task_id} "
                                       f"handler={req.handler} "
                                       f"elapsed_ms={elapsed_ns / 1e6:.0f}")

    def _gather_batch(self, req: Request, h: QueryHandler) -> List[Request]:
        """Pull compatible queued requests to ride this launch.

        Every way a request FAILS to merge is counted in the metrics
        batch-miss map (``no_batch`` = the handler cannot batch at all,
        ``post_split`` = the primary or a candidate is a split product,
        ``disabled`` = micro_batch_max <= 1, ``handler_mismatch`` per
        scanned candidate, ``cap`` at most once per tick when the ride
        filled with work still queued — a heuristic: the remainder may
        serve other handlers).  The ragged gather counts the same
        reasons the same way — the measurable half of the
        ragged-vs-micro win condition."""
        if h.batch is None or h.self_governed:
            self.metrics.count_batch_miss("no_batch")
            return [req]
        if req.no_batch:
            self.metrics.count_batch_miss("post_split")
            return [req]
        if self.micro_batch_max <= 1:
            self.metrics.count_batch_miss("disabled")
            return [req]
        limit = min(h.max_batch, self.micro_batch_max) - 1
        miss = {"handler_mismatch": 0, "post_split": 0}

        def pred(r: Request) -> bool:
            if r.handler != req.handler:
                miss["handler_mismatch"] += 1
                return False
            if r.no_batch:
                miss["post_split"] += 1
                return False
            return True

        mates = self.queue.pop_compatible(pred, limit)
        # counted OUTSIDE pop_compatible: pred runs under the queue lock,
        # and the metrics lock must stay a leaf
        for reason, n in miss.items():
            if n:
                self.metrics.count_batch_miss(reason, n)
        if len(mates) == limit and self.queue.depth() > 0:
            # the ride filled to its cap with work still queued — the
            # max_batch ceiling is the binding constraint this tick
            self.metrics.count_batch_miss("cap")
        if mates:
            self.metrics.set_depth(self.queue.depth())
        return [req] + mates

    def _serve(self, req: Request) -> None:
        group = [req]
        try:
            group = self._serve_group(req)
        finally:
            # every popped member is terminal or re-queued by now: return
            # them to the queue's outstanding count (the drain watches it)
            self.queue.task_done(len(group))

    def _attrib_rec(self, req: Request):
        """The request's :class:`AttributionRecord`, created on first
        serve — a re-queued half or disbanded mate keeps accumulating
        into the SAME record across attempts, so retry churn is part of
        its cost story.  The rid is the trace lineage's rid (the
        supervisor lease id on cluster workers — split children carry
        their parent's, so child costs roll up to the parent rid in the
        supervisor's rollup), else the engine task id."""
        rec = req.attrib
        if rec is None:
            rec = req.attrib = _attrib.AttributionRecord(
                rid=(req.trace.rid if req.trace is not None
                     else req.task_id),
                tenant=(req.tenant or req.session_id),
                handler=req.handler)
            if req.split_depth > 0 or req.join is not None:
                rec.flags.add("split")
        return rec

    def _serve_group(self, req: Request) -> List[Request]:
        # the request's attribution record becomes the thread's active
        # meter for the whole serve scope: governed reservations, shuffle
        # fetches, and rcache consults all land their costs on it without
        # plumbing.  The inline presplit child recursion below nests its
        # own record via metered's save/restore.
        with _attrib.metered(self._attrib_rec(req)):
            return self._serve_group_metered(req)

    def _serve_group_metered(self, req: Request) -> List[Request]:
        # the queue-wait phase of the waterfall ends at the pop that led
        # here (batch mates close theirs in the admission-stamp loop)
        _trace.close_span(req.qspan)
        req.qspan = None
        # analyze: ignore[guarded-by] - same lock-free registration-dict
        # read as submit(): GIL-atomic on a startup-only-growing dict
        h = self._handlers[req.handler]
        if (self._rcache_on and h.cache_key is not None
                and req.join is None and req.split_depth == 0):
            served = self._rcache_consult(req, h)
            if served:
                return [req]
        if (req.split_depth == 0 and req.join is None
                and h.split is not None and not h.self_governed):
            depth = self.presplit_depth(req.handler)
            if depth > 0:
                parts, d = self._presplit_parts(req.payload, h, depth)
                if len(parts) > 1:
                    return self._presplit_dispatch(req, h, parts, d)
        if (self._ragged is not None and h.ragged is not None
                and not h.self_governed):
            # continuous ragged batching: gather/pack/fused-launch/
            # scatter with page-granularity retry/split semantics —
            # split products (no_batch) still ride as single-rider packs
            # so the compiled-geometry set stays the pool's, and every
            # popped member is terminal or re-queued on return
            return self._ragged.serve_group(req, h)
        now_ns = time.monotonic_ns()
        group = self._gather_batch(req, h)
        for r in group:
            _trace.close_span(r.qspan)  # mates' queue wait ends here too
            r.qspan = None
            rec = self._attrib_rec(r)  # mates meter their own queue wait
            if r.response.admitted_ns == 0:  # re-served requests (split
                # halves got fresh responses; disbanded mates did not)
                # keep their first admission stamp and count once
                r.response.admitted_ns = now_ns
                self.metrics.count("admitted", r.session_id)
                wait_ns = now_ns - r.response.submitted_ns
                self.metrics.record_wait(wait_ns)
                rec.queue_ns += wait_ns
        # one compute span per member (mates ride the primary's launch but
        # each request's waterfall must still show its compute phase); the
        # primary's compute context becomes the thread's CURRENT context,
        # so nested layers (shuffle fetches) attach transport spans under
        # it without plumbing.  Closed on EVERY exit below — a member
        # re-queued by the retry protocol closes this attempt's span and
        # opens a fresh queue span in _requeue.
        cspans = [_trace.open_span(
            r.trace, _trace.SPAN_COMPUTE, task_id=r.task_id,
            extra=(f"handler:{h.name}" if len(group) == 1
                   else f"handler:{h.name}:batch:{len(group)}"))
            for r in group]
        try:
            if cspans[0] is not None:
                _trace.push_current(cspans[0].ctx)
            return self._serve_attempt(req, h, group)
        finally:
            if cspans[0] is not None:
                _trace.pop_current()
            for cs in cspans:
                _trace.close_span(cs)

    def _rcache_consult(self, req: Request, h: QueryHandler) -> bool:
        """Result-cache read path of one cacheable top-level request:
        True = served from cache (terminal, no bracket, no launch).  On
        miss the key is stamped onto the request so the completion path
        stores the computed result under the same fingerprint."""
        from spark_rapids_jni_tpu_torch.plans.rcache import (
            request_key,
            result_cache,
        )

        pk = h.cache_key(req.payload)
        if pk is None:
            return False
        names = (h.cache_tables(req.payload) if callable(h.cache_tables)
                 else h.cache_tables)
        key, deps = request_key(h.name, pk, names)
        t0_ns = time.monotonic_ns()
        # no rid= here: engine task ids are NOT supervisor lease ids,
        # and a bare rid: token would collide in cluster merges — the
        # cache span opened below carries the trace's rid lineage
        hit = result_cache.lookup(key)
        if hit is None:
            self.metrics.count("rcache_misses", req.session_id)
            req.rcache_key, req.rcache_deps = key, deps
            return False
        now_ns = time.monotonic_ns()
        if req.response.admitted_ns == 0:
            req.response.admitted_ns = now_ns
            self.metrics.count("admitted", req.session_id)
            wait_ns = now_ns - req.response.submitted_ns
            self.metrics.record_wait(wait_ns)
            if req.attrib is not None:
                req.attrib.queue_ns += wait_ns
        self.metrics.count("rcache_hits", req.session_id)
        # hits land in the handler latency histograms too: the SLO and
        # dashboard view of this class's p50/p99 must reflect that the
        # hot tail stopped paying compute
        self.metrics.record_run(now_ns - t0_ns, handler=h.name)
        with _trace.span(req.trace, _trace.SPAN_CACHE,
                         task_id=req.task_id,
                         extra=f"handler:{h.name}"):
            self._finish(req, OK, value=hit)
        return True

    def _rcache_store(self, req: Request, h: QueryHandler,
                      result: Any) -> None:
        if req.rcache_key is None:
            return
        from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

        if result_cache.put(req.rcache_key, result, req.rcache_deps,
                            label=h.name):
            self.metrics.count("rcache_stores", req.session_id)

    def _serve_attempt(self, req: Request, h: QueryHandler,
                       group: List[Request]) -> List[Request]:
        if len(group) > 1:
            self.metrics.count("batched", n=len(group))
            try:
                payload = h.batch([r.payload for r in group])
            except (RetryOOM, SplitAndRetryOOM, ShuffleCapacityExceeded):
                # pressure inside the batch hook (it may allocate): the
                # protocol answer is to disband — each member re-queues
                # alone (no_batch), gets its own bracket, and cannot
                # re-enter this path
                self.metrics.count("split_requeued", n=len(group))
                for r in group:
                    self._requeue(r, no_batch=True)
                return group
            except Exception as e:  # noqa: BLE001 - mates were popped too:
                # every member must reach a terminal state, not just req
                for r in group:
                    self._finish(r, ERROR, error=e)
                return group
        else:
            payload = req.payload
        # the grow retry mutates this so a later split divides the GROWN
        # payload — halves inherit the discovered exchange capacity
        state = {"payload": payload}

        ctx = HandlerContext(self.mesh, self.budget, self.gov, req.task_id,
                             self.device)

        def run(p):
            with seam(SERVE, f"handle:{h.name}"):
                return h.fn(p, ctx)

        def on_retry(count: int) -> None:
            self.metrics.count("retried", req.session_id)
            if any(r.expired() for r in group):
                raise RequestTimeout(
                    f"deadline expired after {count} retries "
                    f"(handler={h.name})")
            # a REAL RetryOOM already paid an arbiter block; an injected
            # one re-enters immediately — pace the loop so a request's
            # deadline, not the 500-retry cap, decides its fate
            time.sleep(0.001)

        run_t0 = time.monotonic_ns()
        try:
            with task_context(self.gov, req.task_id):
                if h.self_governed:
                    result = run(state["payload"])
                else:
                    result = self._governed_attempt(h, state, run, on_retry)
        except RequestTimeout as e:
            for r in group:
                if r.expired():
                    self._finish(r, TIMED_OUT, error=e)
                else:  # batch-mate with time left: runs again alone
                    self._requeue(r, no_batch=True)
            return group
        except (SplitAndRetryOOM, OutOfBudget) as e:
            if isinstance(e, OutOfBudget):
                try:
                    fits = (int(h.nbytes_of(state["payload"]))
                            <= self.budget.limit)
                # analyze: ignore[retry-protocol] - size probe of a user
                # estimator while already handling an OOM: any failure
                # (control signals included) means "broken estimator", and
                # the enclosing handler fails the request terminally below
                except Exception:  # noqa: BLE001 - broken estimator: fail,
                    fits = True    # don't split on garbage
                if fits:
                    # arbiter declared it non-retryable at a size that
                    # fits: a real OOM (retry-cap/livelock), as in
                    # mem/governed.py
                    for r in group:
                        self._finish(r, ERROR, error=e)
                    return group
            self._split_requeue(group, h, e, payload=state["payload"])
            return group
        except RetryOOM as e:
            # only reachable from self_governed handlers that exhausted
            # their internal protocol — surface as a failure
            for r in group:
                self._finish(r, ERROR, error=e)
            return group
        except ShuffleCapacityExceeded as e:
            # exchange overflow with no grow hook (or grows exhausted in
            # _governed_attempt): the piece cannot fit its static exchange
            # capacity — terminal, explicitly not swallowed as generic
            for r in group:
                self._finish(r, ERROR, error=e)
            return group
        except Exception as e:  # noqa: BLE001 - handler failure
            for r in group:
                self._finish(r, ERROR, error=e)
            return group

        run_ns = time.monotonic_ns() - run_t0
        if len(group) > 1:
            with _trace.span(req.trace, _trace.SPAN_SCATTER,
                             task_id=req.task_id,
                             extra=f"handler:{h.name}:n:{len(group)}"):
                return self._unbatch_finish(req, h, group, result, run_ns)
        else:
            self.metrics.record_run(run_ns, handler=h.name)
            # compute attribution at the SAME site that records run
            # latency: the measured-busy counter and the per-request
            # comp_ns advance together, so the completeness gate
            # compares like against like
            _attrib.note_busy(run_ns)
            if req.attrib is not None:
                req.attrib.comp_ns += run_ns
            self._rcache_store(req, h, result)
            self._finish(req, OK, value=result)
        return group

    def _unbatch_finish(self, req: Request, h: QueryHandler,
                        group: List[Request], result: Any,
                        run_ns: int) -> List[Request]:
        """Redistribute a batch result to its members (the scatter phase
        of the waterfall)."""
        try:
            parts = h.unbatch(result, [r.payload for r in group])
        except (RetryOOM, SplitAndRetryOOM, ShuffleCapacityExceeded):
            # pressure inside the unbatch hook: disband and re-run each
            # member alone (handlers are pure queries, so re-running is
            # safe; failing them would turn recoverable pressure into
            # lost work)
            self.metrics.count("split_requeued", n=len(group))
            for r in group:
                self._requeue(r, no_batch=True)
            return group
        except Exception as e:  # noqa: BLE001
            for r in group:
                self._finish(r, ERROR, error=e)
            return group
        parts = list(parts)
        if len(parts) != len(group):
            # a short result would leave trailing members PENDING
            # forever (zip truncates; popped requests have no queue-side
            # expiry) — every member must reach a terminal state
            e = RuntimeError(
                f"unbatch returned {len(parts)} results for "
                f"{len(group)} requests (handler={h.name})")
            for r in group:
                self._finish(r, ERROR, error=e)
            return group
        for r, value in zip(group, parts):
            self.metrics.record_run(run_ns, handler=h.name)
            # per-member, mirroring record_run: the batch's one launch
            # is billed to every rider, and note_busy advances the
            # measured side identically so coverage stays 1:1
            _attrib.note_busy(run_ns)
            if r.attrib is not None:
                r.attrib.comp_ns += run_ns
            self._finish(r, OK, value=value)
        return group

    def _governed_attempt(self, h: QueryHandler, state: dict, run, on_retry):
        """attempt_once + the exchange-grow retry (capacity overflow).

        ``state["payload"]`` carries the grown payload back to the caller
        so a subsequent split divides the grown batch, not the original.
        """
        grows = 0
        while True:
            try:
                return attempt_once(self.gov, self.budget, state["payload"],
                                    h.nbytes_of, run, on_retry=on_retry)
            except ShuffleCapacityExceeded:
                if h.grow is None or grows >= h.max_grows:
                    raise
                grows += 1
                state["payload"] = h.grow(state["payload"])

    def _presplit_parts(self, payload: Any, h: QueryHandler,
                        depth: int) -> tuple:
        """Split ``payload`` up to ``depth`` times.  Returns
        (parts, achieved_depth) — callers fall back to normal dispatch
        when nothing split."""
        return split_till(payload, h.split,
                          max_levels=min(depth, self.max_split_depth))

    def _presplit_dispatch(self, req: Request, h: QueryHandler,
                           parts: List[Any], depth: int) -> List[Request]:
        """Pre-emptive split sizing: the controller marked this request
        class as one whose history shows SplitAndRetryOOM, so skip the
        doomed full-size attempt (and its blocked/retry churn) and
        dispatch the pieces directly through the same join machinery a
        reactive split uses."""
        now_ns = time.monotonic_ns()
        if req.response.admitted_ns == 0:
            req.response.admitted_ns = now_ns
            self.metrics.count("admitted", req.session_id)
            wait_ns = now_ns - req.response.submitted_ns
            self.metrics.record_wait(wait_ns)
            if req.attrib is not None:
                req.attrib.queue_ns += wait_ns
        self.metrics.count("presplit", req.session_id)
        _flight.record(_flight.EV_CONTROL_PRESPLIT, req.task_id,
                       detail=f"handler:{h.name}:pieces:{len(parts)}",
                       value=len(parts))
        join = _SplitJoin(req, h.combine, len(parts), self._finish)
        children = [
            Request(
                handler=req.handler, payload=part,
                session_id=req.session_id, priority=req.priority,
                deadline=req.deadline, seq=next(self._seq),
                task_id=self.sessions.next_task_id(),
                split_depth=depth,
                no_batch=True, join=join, join_slot=slot,
                # children span under the parent's trace: the rid lineage
                # survives the split, so one waterfall shows every piece
                # (and their attribution records keep the parent's rid +
                # tenant — piece costs roll up to the parent request)
                trace=(_trace.child_of(req.trace)
                       if req.trace is not None else None),
                tenant=req.tenant,
            )
            for slot, part in enumerate(parts)
        ]
        for child in children[1:]:
            self._requeue(child)  # force-admitted, as for reactive halves
        # the first piece runs INLINE on this worker: the request already
        # owns a pop slot, so one piece fewer rides the queue (lower
        # occupancy under exactly the pressure that triggered presplit)
        # and the join's critical path loses one queue round trip.  The
        # child was never handed out by the queue, so it must NOT flow
        # through _serve/task_done — _serve_group alone keeps every
        # terminal/requeue path it needs.
        self._serve_group(children[0])
        return [req]

    def _requeue(self, req: Request, *, no_batch: bool = False) -> None:
        req.no_batch = req.no_batch or no_batch
        # a re-queued request starts a NEW queue-wait phase (its previous
        # queue/compute spans already closed): redispatch churn shows up
        # as repeated queue bars in the waterfall, not a gap
        if req.trace is not None and req.qspan is None:
            req.qspan = _trace.open_span(req.trace, _trace.SPAN_QUEUE,
                                         task_id=req.task_id,
                                         extra=f"handler:{req.handler}"
                                               f":requeue")
        try:
            self.queue.submit(req, force=True)
        # analyze: ignore[retry-protocol] - queue.submit crosses no seam
        # and launches no device work, so no control signal can originate
        # here; the breadth is for shutdown races, where the request must
        # reach a terminal state rather than be lost
        except BaseException as e:  # closed mid-shutdown: terminal, not lost
            self._finish(req, ERROR, error=e)

    def _split_requeue(self, group: List[Request], h: QueryHandler,
                       err: BaseException, *, payload: Any = None) -> None:
        """SplitAndRetryOOM at the serving level.

        A micro-batch disbands: each member re-queues alone (the batch WAS
        the split unit).  A single request splits its payload; the halves
        re-queue as first-class requests joined back into the parent's
        response.  Force-admitted in both cases: these requests were
        already admitted once, and bouncing them off a full queue would
        lose accepted work (test_serve_chaos.py pins this under a full
        queue + injected OOMs).
        """
        if len(group) > 1:
            self.metrics.count("split_requeued", n=len(group))
            for r in group:
                self._requeue(r, no_batch=True)
            return
        req = group[0]
        if h.split is None:
            self._finish(req, ERROR, error=err)
            return
        if req.split_depth >= self.max_split_depth:
            self._finish(req, ERROR, error=MemoryError(
                f"split depth {req.split_depth} reached and the request "
                f"still does not fit"))
            return
        # split the (possibly capacity-grown) payload the attempt actually
        # ran with, so halves inherit the discovered exchange capacity
        parts = list(h.split(payload if payload is not None
                             else req.payload))
        if len(parts) <= 1:
            self._finish(req, ERROR,
                         error=MemoryError("request is not splittable"))
            return
        if req.split_depth == 0:  # see class_split_counts: only top-level
            self._note_class_split(req.handler)
        join = _SplitJoin(req, h.combine, len(parts), self._finish)
        self.metrics.count("split_requeued", req.session_id, n=len(parts))
        for slot, part in enumerate(parts):
            child = Request(
                handler=req.handler, payload=part,
                session_id=req.session_id, priority=req.priority,
                deadline=req.deadline, seq=next(self._seq),
                task_id=self.sessions.next_task_id(),
                split_depth=req.split_depth + 1,
                no_batch=True, join=join, join_slot=slot,
                trace=(_trace.child_of(req.trace)
                       if req.trace is not None else None),
                tenant=req.tenant,
            )
            # the serve-level half: a fresh task carrying its parent's
            # lineage into the flight ring (the arbiter already recorded
            # the parent's split signal delivery)
            _flight.record(_flight.EV_SPLIT_RETRY, child.task_id,
                           detail=f"requeued_from:{req.task_id}")
            self._requeue(child)  # force-admitted; terminal on shutdown race


# --------------------------------------------------------------- builtins --

def register_builtin_handlers(engine: ServingEngine) -> None:
    """The models/ query pipelines and an ops/ kernel as query handlers, on
    the engine's mesh or device.

    - ``q97``: executor-governed — the engine reserves the working set,
      splits the key space by re-queueing halves, grows the exchange on
      capacity overflow (payload: ``(store, catalog)`` table pair or a
      prepared ``Q97Batch``).  Its plan has an exchange, so it needs the
      engine's mesh: without one it fails as the plan compiler refuses it.
    - ``q5`` / ``q3``: self-governed — the distributed runners drive their
      own inline split-retry under the engine's task context (payload:
      ``Q5Data`` / ``Q3Data``).
    - ``hash32``: a batchable pure op (murmur3 over an int64 array, the
      ``mm_hash_long`` kernel on the card) — the micro-batching
      demonstration payload (payload: 1-D numpy int64), with its ragged
      page-pool twin.
    - ``get_json_object``: multi-path JSON extraction (payload:
      ``(rows, paths)`` — a sequence of JSON strings/None and a sequence
      of ``$.a[0].*`` path strings); returns one list of extracted
      values per path.  Executor-governed: the engine reserves the
      token-table working set before the launch.  On the card one call
      runs at a time (``_JSON_DEVICE_LOCK``).
    """
    import numpy as np
    import torch

    from spark_rapids_jni_tpu_torch.models.q97 import (
        Q97Batch,
        combine_q97_outs,
        default_q97_capacity,
        q97_working_set_bytes,
        run_q97_piece,
        split_q97_batch,
    )
    from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, axis_size

    dp = 1 if engine.mesh is None else axis_size(engine.mesh, DATA_AXIS)
    dev = engine.device

    def as_batch(payload) -> Q97Batch:
        if isinstance(payload, Q97Batch):
            return payload
        store, catalog = payload
        total = len(store[0]) + len(catalog[0])
        return Q97Batch(
            np.asarray(store[0], np.int32), np.asarray(store[1], np.int32),
            np.asarray(catalog[0], np.int32),
            np.asarray(catalog[1], np.int32),
            capacity=default_q97_capacity(total, dp))

    engine.register(QueryHandler(
        name="q97",
        fn=lambda p, ctx: run_q97_piece(engine.mesh, as_batch(p)),
        nbytes_of=lambda p: q97_working_set_bytes(as_batch(p), dp),
        split=lambda p: split_q97_batch(as_batch(p)),
        combine=combine_q97_outs,
        grow=lambda p: dataclasses.replace(
            as_batch(p), capacity=2 * as_batch(p).capacity),
    ))

    def run_q5(p, ctx):
        from spark_rapids_jni_tpu_torch.models import run_distributed_q5

        return run_distributed_q5(engine.mesh, p, budget=ctx.budget,
                                  task_id=ctx.task_id, manage_task=False,
                                  device=dev)

    def run_q3(p, ctx):
        from spark_rapids_jni_tpu_torch.models import run_distributed_q3

        return run_distributed_q3(engine.mesh, p, budget=ctx.budget,
                                  task_id=ctx.task_id, manage_task=False,
                                  device=dev)

    engine.register(QueryHandler(name="q5", fn=run_q5, self_governed=True))
    engine.register(QueryHandler(name="q3", fn=run_q3, self_governed=True))

    def run_hash(p, ctx):
        from spark_rapids_jni_tpu_torch.columnar.column import Column
        from spark_rapids_jni_tpu_torch.columnar.dtypes import INT64
        from spark_rapids_jni_tpu_torch.ops.hashing import murmur_hash32

        data = torch.from_numpy(np.asarray(p, np.int64)).to(dev, copy=True)
        out = murmur_hash32([Column(data, None, INT64)], seed=42)
        return out.data.cpu().numpy()

    def unbatch_hash(result, payloads):
        sizes = [len(p) for p in payloads]
        offs = np.cumsum([0] + sizes)
        return [result[offs[i]:offs[i + 1]] for i in range(len(sizes))]

    def hash_kernel(data, valid, rid, riders_cap):
        # the page-pool twin of run_hash: same murmur body over the flat
        # pool tensor; padding rows hash harmlessly and are sliced away
        # by the scatter, so results stay bit-identical to the per-
        # request path
        from spark_rapids_jni_tpu_torch.columnar.column import Column
        from spark_rapids_jni_tpu_torch.columnar.dtypes import INT64
        from spark_rapids_jni_tpu_torch.ops.hashing import murmur_hash32

        return murmur_hash32([Column(data, None, INT64)], seed=42).data

    from spark_rapids_jni_tpu_torch.serve.ragged import RaggedSpec

    engine.register(QueryHandler(
        name="hash32",
        fn=run_hash,
        nbytes_of=lambda p: 16 * len(p),  # int64 in + int32 out + slack
        batch=lambda ps: np.concatenate(
            [np.asarray(p, np.int64) for p in ps]),
        unbatch=unbatch_hash,
        ragged=RaggedSpec(
            rows_of=lambda p: np.asarray(p, np.int64),
            kernel=hash_kernel,
            kernel_key="builtin.hash32",
        ),
        max_batch=16,
    ))

    def run_json(p, ctx):
        from spark_rapids_jni_tpu_torch.columnar.column import strings_column
        from spark_rapids_jni_tpu_torch.ops.get_json_object import (
            get_json_object_multiple_paths,
        )

        rows, paths = p
        with _JSON_DEVICE_LOCK if dev.type == "cuda" else contextlib.nullcontext():
            col = strings_column(list(rows), device=dev)
            outs = get_json_object_multiple_paths(col, list(paths))
            return [c.to_list() for c in outs]

    def json_nbytes(p) -> int:
        rows, paths = p
        src = sum(len(r) for r in rows if r is not None)
        # token tables + byte tables run ~10-30x the source bytes; the
        # per-path fan-out adds machines + rendered output per path
        return 32 * src + 8 * src * max(len(paths), 1) + (1 << 16)

    engine.register(QueryHandler(
        name="get_json_object",
        fn=run_json,
        nbytes_of=json_nbytes,
    ))
