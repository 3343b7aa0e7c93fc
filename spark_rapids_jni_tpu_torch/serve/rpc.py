"""Cross-process RPC for crash-only serving: the executor-worker side (a copy
of the JAX package's ``serve/rpc.py``, but for the worker's device, its
budget on a shared card and its warm-up before ``HELLO``: see
:func:`executor_worker_main`; and for :class:`SafeConn`'s framing, below).

Spark's real resilience layer sits ABOVE the resource adaptor this repo
reproduces: executors die and the driver re-dispatches their tasks.  This
module is the executor half of that layer for the serve tier — a worker
process entry point (:func:`executor_worker_main`) that runs today's
:class:`~spark_rapids_jni_tpu_torch.serve.executor.ServingEngine` over its OWN
memory governor on its own device (the card unless ``worker_cfg["device"]``
asks for the CPU), plus the small message protocol it speaks with the
supervisor (serve/supervisor.py) over a ``multiprocessing`` pipe.

Protocol (plain tuples, first element the tag — pickled by the pipe):

- ``(HELLO, worker_id, incarnation, pid)``        worker ready to serve
- ``(BEAT, worker_id, incarnation, wall_t, gauges)``  liveness + pressure
- ``(DISPATCH, rid, handler, payload, deadline_rel_s, priority)``
- ``(RESULT, rid, status, value, (err_type, err_msg) | None)``
- ``(SHUTDOWN, dump_epilogue)``                   drain and exit

Framing (the port's departure from the JAX package, which keeps the fault
this repairs): each message is pickled once (protocol 5) and crosses the pipe
as frames.  A message of up to :data:`CHUNK_THRESHOLD` bytes is one frame.
A larger one -- its pickle, plus each array buffer of more than
:data:`CHUNK_THRESHOLD` bytes, kept out of band and never copied into it --
goes as a header and :data:`CHUNK_BYTES` chunks, each sent under the send
lock on its own, so a heartbeat waits for one chunk, never for a whole
result of hundreds of MB (with the JAX package's one-message send it waited
for all of it and missed its budget).  The receiver reassembles the parts by
message id and unpickles the arrays over its own buffers.  Both ends of a
pipe must be :class:`SafeConn`.

Crash-only discipline: the worker never tries to hand off state on the way
down.  A SIGKILL (injected ``proc_kill`` fault, OOM killer, operator) just
drops the pipe; the supervisor's receiver sees EOF, declares the worker
dead, and re-dispatches its leases — the same path a missed-heartbeat or
hung-lease recycle takes.  Symmetrically, a worker whose pipe to the
supervisor breaks exits: an orphaned executor must not keep burning the
machine.

The ``rid`` (supervisor lease id) is deliberately woven into the worker's
flight ring (``EV_LEASE_GRANT`` with ``rid:<id>`` detail next to the
engine-local task id) so ``tools/flightdump.py --cluster`` can stitch
per-process dumps into one cross-process request timeline.
"""

from __future__ import annotations

import importlib
import io
import itertools
import os
import pickle
import socket
import struct
import threading
import time
from multiprocessing.reduction import ForkingPickler
from typing import Callable, Optional

import numpy as np

__all__ = [
    "MSG_HELLO", "MSG_BEAT", "MSG_DISPATCH", "MSG_RESULT", "MSG_SHUTDOWN",
    "MSG_SHUFFLE_PRODUCED", "MSG_SHUFFLE_ACK", "MSG_SHUFFLE_MAP",
    "MSG_SHUFFLE_CLEANUP", "MSG_PRESSURE", "MSG_TELEMETRY",
    "MSG_TABLE_BUMP", "MESSAGE_FIELDS", "CHUNK_THRESHOLD", "CHUNK_BYTES",
    "SafeConn", "resolve_factory", "executor_worker_main",
    "set_shuffle_sink", "shuffle_uplink",
]

MSG_HELLO = "hello"
MSG_BEAT = "beat"
MSG_DISPATCH = "dispatch"
MSG_RESULT = "result"
MSG_SHUTDOWN = "shutdown"
# the columnar data plane's control half (round 13, serve/shuffle.py):
# partition DATA moves peer-to-peer over the framed socket transport; the
# supervisor pipe only carries the partition-map bookkeeping — production
# announcements + consumer acks up, map/cleanup broadcasts down — plus
# the cluster-wide pressure gauge feeding each worker's admission
# controller (the federated-admission tail of ROADMAP item 1)
MSG_SHUFFLE_PRODUCED = "shuffle_produced"
MSG_SHUFFLE_ACK = "shuffle_ack"
MSG_SHUFFLE_MAP = "shuffle_map"
MSG_SHUFFLE_CLEANUP = "shuffle_cleanup"
MSG_PRESSURE = "pressure"
# the live telemetry plane (round 14, serve/telemetry.py): each worker
# piggybacks rolling flight-ring deltas + a metrics snapshot onto the
# heartbeat cadence; the supervisor merges them into the bounded cluster
# timeline its local endpoint serves (tools/servetop.py, flightdump
# --live).  An undeliverable export is SKIPPED, never blocked on — the
# same discipline as the round-13 heartbeat fix.
MSG_TELEMETRY = "telemetry"
# the governed result cache's invalidation plane (round 15,
# plans/rcache.py + models/tables.py): the supervisor owns table-version
# bumps (Supervisor.bump_table) and broadcasts the new version so every
# executor's local registry — and therefore its result-cache keys —
# converges.  Monotonic on the receiving side (tables.advance_to): late
# or duplicate broadcasts are no-ops, never rollbacks.
MSG_TABLE_BUMP = "table_bump"

# The declared wire schema: tag -> field names after the tag.  BOTH sides
# of the pipe are checked against this table at merge time (ci/analyze
# wire-protocol pass): every tuple constructed with one of these tags must
# carry exactly these fields, and every destructure site (tuple unpack or
# msg[i] index under an `if tag == MSG_X` guard) must match arity and
# names.  The round-10 blocked_frac drift — a gauge the supervisor read
# but no worker sent — is the defect class this freezes out; changing a
# message means changing this row, which forces every site on both sides
# into the same review.
MESSAGE_FIELDS = {
    MSG_HELLO: ("worker_id", "incarnation", "pid"),
    MSG_BEAT: ("worker_id", "incarnation", "wall_t", "gauges"),
    # `trace` (round 14) is the supervisor's dispatch-span context
    # (obs/trace.to_wire tuple or None): the worker's queue/compute spans
    # chain under the SAME rid, so one live waterfall crosses the pipe.
    # `tenant` (round 21) is the billing identity the request's
    # attribution record rolls up under — the worker engines run ONE
    # internal lease session each, so the tenant must ride the dispatch
    # itself (hedge copies carry the same rid + tenant, which is how
    # hedge-loser cost stays attributed)
    MSG_DISPATCH: ("rid", "handler", "payload", "deadline_rel_s",
                   "priority", "trace", "tenant"),
    MSG_RESULT: ("rid", "status", "value", "err"),
    MSG_SHUTDOWN: ("dump_epilogue",),
    # worker -> supervisor: map task `map_index` of shuffle `sid` framed
    # its partitions ({part: nbytes} sizes) and serves them at `ep`
    MSG_SHUFFLE_PRODUCED: ("worker_id", "incarnation", "sid", "map_index",
                           "sizes", "ep"),
    # worker -> supervisor: consumer `part` fetched + CRC-verified map
    # task `map_index`'s partition (the partition map's ack column)
    MSG_SHUFFLE_ACK: ("worker_id", "incarnation", "sid", "map_index",
                      "part"),
    # supervisor -> participants: the current partition map of one
    # shuffle ({map_index: {state, ep, incarnation, sizes}})
    MSG_SHUFFLE_MAP: ("sid", "nparts", "tasks"),
    # supervisor -> participants: shuffle finished/abandoned; free stores
    MSG_SHUFFLE_CLEANUP: ("sid",),
    # supervisor -> workers: cluster-wide pressure aggregate (mean/max of
    # heartbeat gauges) for the local AdmissionController's tick
    MSG_PRESSURE: ("cluster",),
    # worker -> supervisor: one telemetry export — flight-ring event
    # dicts since the last export plus a ServeMetrics snapshot, stamped
    # with a paired (wall_t, t_ns) clock so the timeline aligns this
    # process's monotonic event times onto the cluster's wall clock
    MSG_TELEMETRY: ("worker_id", "incarnation", "wall_t", "t_ns",
                    "events", "metrics"),
    # supervisor -> workers: table `name` is now at `version` — advance
    # the local registry (reclaiming dependent result-cache entries)
    MSG_TABLE_BUMP: ("name", "version"),
}

# RESULT statuses mirror serve.queue terminal states, plus the one
# non-terminal flow-control verdict a worker may return:
STATUS_BUSY = "busy"        # worker queue full — supervisor re-queues


#: a message whose pickle is larger than this crosses the pipe in chunks
CHUNK_THRESHOLD = 1 << 20
#: pickled bytes per chunk: what a heartbeat may wait behind
CHUNK_BYTES = 256 << 10

# frame kinds: a whole message; the header of a chunked one (its id, its
# part count, then each part's size: the pickle, then its out-of-band
# buffers); one chunk of one part
_WHOLE = b"M"
_HEAD = b"H"
_CHUNK = b"C"
_HEAD_FIXED = struct.Struct("<QQ")  # message id, parts
_SIZE = struct.Struct("<Q")
_CHUNK_HEAD = struct.Struct("<QQQ")  # message id, part, offset


class _Pickler(pickle.Pickler):
    """``ForkingPickler`` (what ``Connection.send`` pickles with, so the same
    reducers apply) at protocol 5 with a ``buffer_callback``, which
    ``ForkingPickler`` does not pass through."""

    def __init__(self, file, buffer_callback):
        super().__init__(file, 5, buffer_callback=buffer_callback)
        self.dispatch_table = ForkingPickler._copyreg_dispatch_table.copy()
        self.dispatch_table.update(ForkingPickler._extra_reducers)


class _TicketLock:
    """A first-come, first-served lock.  ``threading.Lock`` hands no turn to
    its waiters: a sender that releases it between chunks and takes it again
    at once could starve a heartbeat for a whole message."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._next = 0
        self._serving = 0

    def __enter__(self):
        with self._cv:
            me = self._next
            self._next += 1
            while self._serving != me:
                self._cv.wait()
        return self

    def __exit__(self, *exc):
        with self._cv:
            self._serving += 1
            self._cv.notify_all()


class SafeConn:
    """A ``multiprocessing`` connection that survives its peer dying.

    ``send`` serializes concurrent senders (heartbeat thread + result
    waiters share one pipe) and returns False instead of raising once the
    peer is gone — by then the supervisor/worker death path owns cleanup,
    and a crashing send inside a waiter thread would just add noise.
    ``recv`` returns None on EOF for the same reason.

    A message is pickled once, outside the send lock, and sent as frames
    (module docstring): one frame, or a header and :data:`CHUNK_BYTES`
    chunks when it holds more than :data:`CHUNK_THRESHOLD` bytes, each chunk
    under the lock on its own and the lock served in arrival order, so a
    beat goes between two chunks of a large result.  ``recv`` reassembles
    the parts of each message.

    ``send`` is also BOUNDED-TIME: a live peer that stops draining its
    pipe (wedged receive loop) would otherwise block the sender forever
    while it holds the send lock — heartbeats stop, the sender looks
    dead, and the wrong process gets recycled.  After ``send_timeout_s``
    waiting for pipe writability the send surfaces as backpressure
    instead: an ``EV_TASK_HUNG`` flight event plus a False return, which
    callers already map to the unreachable-peer path.  (The guard bounds
    the wait for buffer SPACE before each frame; a frame is at most a chunk,
    so no single write outlasts a chunk's drain.)

    ``shutdown`` wakes a thread blocked in ``recv`` (EOF) and a sender
    blocked in a write, but keeps the descriptor: its number is not handed
    to a new pipe until ``close``, which waits for a send in progress.
    """

    def __init__(self, conn, send_timeout_s: Optional[float] = None):
        if send_timeout_s is None:
            from spark_rapids_jni_tpu_torch import config

            send_timeout_s = float(config.get("serve_send_timeout_s"))
        self._conn = conn
        self._send_timeout_s = float(send_timeout_s)
        self._send_lock = _TicketLock()
        self._ids = itertools.count()
        # message id -> [part buffers, bytes still to come]; touched by the
        # one receiving thread only
        self._partial: dict = {}

    def send(self, msg: tuple) -> bool:
        try:
            out, bufs = io.BytesIO(), []

            def out_of_band(buf) -> bool:  # False: this buffer goes out of band
                if buf.raw().nbytes <= CHUNK_THRESHOLD:
                    return True
                bufs.append(buf.raw())
                return False

            _Pickler(out, out_of_band).dump(msg)
            data = out.getbuffer()
            tag = msg[0] if msg else "?"
            if not bufs and len(data) <= CHUNK_THRESHOLD:
                return self._send_frame(_WHOLE + data, tag)
            mid, parts = next(self._ids), [data, *bufs]
            head = _HEAD + _HEAD_FIXED.pack(mid, len(parts)) + b"".join(
                _SIZE.pack(p.nbytes) for p in parts)
            if not self._send_frame(head, tag):
                return False
            for i, part in enumerate(parts):
                for off in range(0, part.nbytes, CHUNK_BYTES):
                    frame = (_CHUNK + _CHUNK_HEAD.pack(mid, i, off)
                             + part[off:off + CHUNK_BYTES])
                    if not self._send_frame(frame, tag):
                        return False
            return True
        # analyze: ignore[retry-protocol] - pipe serialization crosses no
        # seam and launches no governed work: nothing here can originate a
        # control signal.  Any failure (broken pipe mid-crash, an
        # unpicklable result value) means "peer unreachable / message
        # undeliverable", which the caller maps to the dead-worker path.
        except Exception:  # noqa: BLE001
            return False

    def _send_frame(self, frame: bytes, tag) -> bool:
        with self._send_lock:
            if self._send_timeout_s > 0:
                import select

                ready = select.select(
                    [], [self._conn.fileno()], [],
                    self._send_timeout_s)[1]
                if not ready:
                    from spark_rapids_jni_tpu_torch.obs import (
                        flight as _flight,
                    )

                    _flight.record(
                        _flight.EV_TASK_HUNG, -1,
                        detail=f"pipe_send_stalled:"
                               f"{self._send_timeout_s:g}s:tag:{tag}")
                    return False
            # analyze: ignore[blocking-under-lock] - the send lock
            # EXISTS to serialize this pipe write (heartbeat thread +
            # result waiters share one fd; interleaved frames would
            # corrupt the stream), and the select() guard above bounds
            # the wait for buffer space, so this is the one place a pipe
            # write may block while holding it -- for one frame at most.
            self._conn.send_bytes(frame)
        return True

    def recv(self) -> Optional[tuple]:
        try:
            while True:
                frame = self._conn.recv_bytes()
                kind, view = frame[:1], memoryview(frame)
                if kind == _WHOLE:
                    return ForkingPickler.loads(view[1:])
                if kind == _HEAD:
                    mid, nparts = _HEAD_FIXED.unpack_from(frame, 1)
                    at = 1 + _HEAD_FIXED.size
                    sizes = [_SIZE.unpack_from(frame, at + _SIZE.size * i)[0]
                             for i in range(nparts)]
                    # uninitialised host buffers: every byte is written by a chunk
                    self._partial[mid] = [[np.empty(n, np.uint8) for n in sizes],
                                          sum(sizes)]
                else:
                    mid, i, off = _CHUNK_HEAD.unpack_from(frame, 1)
                    body = view[1 + _CHUNK_HEAD.size:]
                    part = self._partial[mid]
                    part[0][i][off:off + len(body)] = body
                    part[1] -= len(body)
                if self._partial.get(mid, (None, 1))[1] == 0:
                    parts = self._partial.pop(mid)[0]
                    return ForkingPickler.loads(parts[0], buffers=parts[1:])
        except (EOFError, OSError):
            return None

    def shutdown(self) -> None:
        """Shut the connection's socket down both ways, keeping its
        descriptor open (a no-op where the pipe is not a socket)."""
        try:
            s = socket.socket(fileno=os.dup(self._conn.fileno()))
        except (OSError, ValueError):
            return
        try:
            s.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        finally:
            s.close()

    def close(self) -> None:
        with self._send_lock:
            try:
                self._conn.close()
            except OSError:
                pass


# --------------------------------------------------------------------------
# shuffle plumbing: the worker main loop routes shuffle control messages to
# the process's ShuffleService WITHOUT importing serve/shuffle.py (which
# pulls in the plan compiler and torch — workers that never serve a shuffle
# handler must stay cheap to spawn).  The service registers a sink when it
# starts; messages arriving first are buffered and drained at registration.
# The uplink is how the service (running in handler threads) sends
# produced/ack announcements up the ONE supervisor pipe.
# --------------------------------------------------------------------------

_shuffle_lock = threading.Lock()
_shuffle_sink: Optional[Callable[[tuple], None]] = None
_shuffle_pending: list = []
_shuffle_uplink: Optional[tuple] = None  # (send_fn, worker_id, incarnation)


def set_shuffle_sink(fn: Optional[Callable[[tuple], None]]) -> None:
    """Register (or clear) the process ShuffleService's message sink;
    buffered messages drain in arrival order.  The drain AND every
    subsequent delivery run under the one lock, so a map broadcast
    arriving concurrently with registration can never be applied before
    (and then overwritten by) an older buffered map."""
    global _shuffle_sink
    with _shuffle_lock:
        _shuffle_sink = fn
        pending, _shuffle_pending[:] = list(_shuffle_pending), []
        if fn is not None:
            for msg in pending:
                fn(msg)


def _route_shuffle_msg(msg: tuple) -> None:
    # delivery stays under the lock (see set_shuffle_sink): the sink's
    # own state has its own condition, and no sink path re-enters this
    # lock while holding it — produce/ack read the uplink AFTER
    # releasing the service condition
    with _shuffle_lock:
        if _shuffle_sink is None:
            _shuffle_pending.append(msg)
            del _shuffle_pending[:-256]  # bounded: maps re-broadcast
            return
        _shuffle_sink(msg)


def shuffle_uplink() -> Optional[tuple]:
    """(send_fn, worker_id, incarnation) of this executor-worker process,
    or None outside one (standalone services skip announcements)."""
    with _shuffle_lock:
        return _shuffle_uplink


def _set_shuffle_uplink(uplink: Optional[tuple]) -> None:
    global _shuffle_uplink
    with _shuffle_lock:
        _shuffle_uplink = uplink


def resolve_factory(factory) -> Callable:
    """Resolve a handler factory: a callable passes through; a
    ``"module:attr"`` string imports in THIS process.  String specs are
    what cross the spawn boundary robustly — the child resolves them
    against its own interpreter instead of unpickling a closure."""
    if callable(factory):
        return factory
    mod_name, _, attr = str(factory).partition(":")
    if not attr:
        raise ValueError(
            f"factory spec {factory!r} must be 'module:function'")
    return getattr(importlib.import_module(mod_name), attr)


def _warm_device(dev) -> None:
    """Make this process's first CUDA work now, before any thread that must
    keep a deadline runs: the context, one small tensor, and one
    ``mm_hash_long`` launch, which loads the kernel library."""
    import torch

    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    hash_cuda.mm_hash_long_cuda(torch.ones(1, dtype=torch.int64, device=dev), 42)
    torch.cuda.synchronize(dev)


def executor_worker_main(worker_id: int, incarnation: int, conn,
                         factory, factory_kwargs: Optional[dict] = None,
                         worker_cfg: Optional[dict] = None,
                         chaos: Optional[dict] = None,
                         flags: Optional[dict] = None) -> None:
    """Entry point of one executor worker process (spawned by the
    supervisor).  Builds its own governor + budget + ServingEngine (one
    failure domain, nothing shared with any sibling), registers handlers
    via ``factory(engine, **factory_kwargs)``, optionally arms the fault
    injector from ``chaos``, then serves DISPATCH messages until the pipe
    closes or a SHUTDOWN arrives.

    The port's three departures from the JAX worker, all in ``worker_cfg``:

    - ``"device"`` is the engine's device, the card when absent.  A worker
      told to use the card where there is none raises here, before HELLO;
      it never carries on on the CPU.  No mesh or process group is made.
    - ``"budget_bytes"`` is the worker's governed budget.  Absent, it is
      the default device budget: the card's whole memory over 1.25, which
      suits a lone worker only -- workers that share one card must each be
      given their share.
    - On the card the worker initialises its device before the heartbeat
      thread starts and before HELLO: the CUDA context, one small tensor
      and one ``mm_hash_long`` launch (which loads the kernel library).  A
      first CUDA call can hold the interpreter lock for longer than the
      heartbeat's miss budget, which would have a healthy worker recycled.
    """
    from spark_rapids_jni_tpu_torch import config

    for k, v in (flags or {}).items():
        config.set(k, v)

    from spark_rapids_jni_tpu_torch import device as _device
    from spark_rapids_jni_tpu_torch.mem.governed import default_device_budget
    from spark_rapids_jni_tpu_torch.mem.governor import (
        BudgetedResource,
        MemoryGovernor,
    )
    from spark_rapids_jni_tpu_torch.obs import flight as _flight
    from spark_rapids_jni_tpu_torch.obs import trace as _trace
    from spark_rapids_jni_tpu_torch.serve.executor import ServingEngine
    from spark_rapids_jni_tpu_torch.serve.queue import OK

    cfg = dict(worker_cfg or {})
    dev = _device.resolve(cfg.pop("device", None))
    if dev.type == "cuda":
        _warm_device(dev)
    gov = MemoryGovernor(
        watchdog_period_s=float(cfg.pop("watchdog_period_s", 0.05)))
    budget_bytes = cfg.pop("budget_bytes", None)
    budget = (BudgetedResource(gov, int(budget_bytes))
              if budget_bytes is not None else default_device_budget(gov))
    engine = ServingEngine(
        device=dev, gov=gov, budget=budget,
        workers=int(cfg.pop("workers", 2)),
        queue_size=int(cfg.pop("queue_size", 64)),
        default_deadline_s=cfg.pop("default_deadline_s", 30.0),
        adaptive=bool(cfg.pop("adaptive", False)))
    resolve_factory(factory)(engine, **(factory_kwargs or {}))
    if chaos:
        from spark_rapids_jni_tpu_torch.obs.faultinj import FaultInjector

        FaultInjector.install(chaos)

    # one uncapped internal session: tenant admission (budgets, ladder,
    # priorities) already happened in the supervisor; the worker engine's
    # job is governed execution, not a second front door
    sess = engine.open_session(f"lease:w{worker_id}")
    sconn = SafeConn(conn)
    stop = threading.Event()
    dump_epilogue = [False]

    exporter = None
    if bool(config.get("serve_telemetry")):
        from spark_rapids_jni_tpu_torch.serve import attribution as _attrib
        from spark_rapids_jni_tpu_torch.serve.telemetry import TelemetryExporter

        def _metrics_with_attrib():
            # the cumulative attribution reconciliation gauges ride
            # EVERY export's metrics — including the post-result
            # force-flush, the same message that carries the EV_ATTRIB
            # events — so a chaos SIGKILL can't strand attributed work
            # without the measurement it reconciles against
            m = engine.metrics.snapshot()
            m.setdefault("gauges", {}).update(_attrib.worker_gauges())
            return m

        exporter = TelemetryExporter(worker_id, incarnation,
                                     metrics_source=_metrics_with_attrib)
        # force-flush on the SERVING thread after each popped group fully
        # serves: every span-close finally has run by then, so a chaos
        # SIGKILL landing before the next heartbeat cannot eat the story
        # of work that already completed (deterministic ordering — no
        # sleep-and-hope between waiter and serving threads)
        engine.on_served = lambda: exporter.export(sconn.send, force=True)

    rcache_on = bool(config.get("serve_result_cache"))
    rcache_hot_n = int(config.get("serve_result_cache_advertise"))

    def heartbeat() -> None:
        period = float(config.get("serve_heartbeat_s"))
        nworkers = max(1, len(engine._workers))
        while not stop.wait(period):
            # blocked_frac mirrors the admission controller's pressure
            # signal (rolling arbiter park time over the window, per
            # worker thread) — the supervisor's ladder reads both
            try:
                rolled = engine.gov.arbiter.rolling_blocked(1.0)
                blocked = min(1.0, sum(rolled.values()) / (1e9 * nworkers))
            except RuntimeError:  # governor closing: no trend signal
                blocked = 0.0
            gauges = {
                "mem_frac": engine.budget.used / max(1, engine.budget.limit),
                "blocked_frac": blocked,
                "queue_depth": engine.queue.depth(),
                "outstanding": engine.queue.outstanding(),
            }
            if rcache_on:
                from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

                # key advertisement (round 15): the hottest resident
                # tokens ride the beat so the router knows which submits
                # will hit SOMEWHERE — the cached_only ladder level
                # admits exactly those.  Per-tier residency rides along
                # for servetop's per-worker CACHE column.
                rs = result_cache.stats()
                gauges["rcache"] = {
                    k: rs[k] for k in
                    ("entries", "hbm_bytes", "host_bytes", "disk_bytes",
                     "hits", "misses", "hit_ratio")}
                if rcache_hot_n > 0:
                    gauges["rcache_hot"] = result_cache.hot_tokens(
                        rcache_hot_n)
            if not sconn.send((MSG_BEAT, worker_id, incarnation,
                               time.time(), gauges)):
                # undeliverable beat: the pipe may be CLOSED (supervisor
                # gone — the main loop's EOF owns that) or merely
                # STALLED past the send guard's bound.  Either way the
                # right move is to skip this beat and keep beating: a
                # heartbeat thread that exits on one stalled send leaves
                # a healthy worker permanently silent, and the
                # supervisor would kill it for the supervisor's own
                # congestion
                continue
            if exporter is not None:
                # continuous telemetry piggybacks the beat cadence; the
                # exporter applies the same skip-never-block discipline
                # (a stalled pipe costs this delta, not the thread)
                exporter.export(sconn.send)

    def waiter(rid: int, resp) -> None:
        resp.wait()  # the engine guarantees a terminal state
        if resp.status == OK:
            err = None
            value = resp.value
        else:
            err = (type(resp.error).__name__ if resp.error is not None
                   else resp.status,
                   str(resp.error) if resp.error is not None else "")
            value = None
        if not sconn.send((MSG_RESULT, rid, resp.status, value, err)):
            # the value may be unpicklable even though the pipe is fine:
            # degrade to an in-band error so the lease still terminates
            sconn.send((MSG_RESULT, rid, "error", None,
                        ("UnserializableResult",
                         f"result of rid {rid} could not cross the pipe")))
        _flight.record(_flight.EV_LEASE_DONE, resp.task_id,
                       detail=f"rid:{rid}:worker:{worker_id}:{resp.status}")

    beat_thread = threading.Thread(target=heartbeat, daemon=True,
                                   name=f"serve-worker-{worker_id}-beat")
    beat_thread.start()
    _set_shuffle_uplink((sconn.send, worker_id, incarnation))
    sconn.send((MSG_HELLO, worker_id, incarnation, os.getpid()))

    try:
        while True:
            msg = sconn.recv()
            if msg is None:
                break  # supervisor died: crash-only both directions
            tag = msg[0]
            if tag == MSG_SHUTDOWN:
                dump_epilogue[0] = bool(msg[1])
                break
            if tag == MSG_PRESSURE:
                engine.note_cluster_pressure(dict(msg[1]))
                continue
            if tag == MSG_SHUFFLE_MAP or tag == MSG_SHUFFLE_CLEANUP:
                _route_shuffle_msg(msg)
                continue
            if tag == MSG_TABLE_BUMP:
                # lazy: workers that never see a bump never import the
                # models package.  advance_to runs the result cache's
                # invalidation listener synchronously on this thread, so
                # by the next dispatch the stale entries are gone.
                from spark_rapids_jni_tpu_torch.models import tables as _tables

                _tables.advance_to(msg[1], msg[2])
                continue
            if tag != MSG_DISPATCH:
                continue
            (_, rid, handler, payload, deadline_rel_s, priority, trace,
             tenant) = msg
            try:
                resp = engine.submit(sess, handler, payload,
                                     priority=priority,
                                     deadline_s=deadline_rel_s,
                                     trace=_trace.from_wire(trace),
                                     tenant=tenant)
            # analyze: ignore[retry-protocol] - submit crosses no seam
            # (admission only); failures here are flow control
            # (Backpressure -> BUSY re-queue upstream) or setup bugs
            # (unknown handler), both reported in-band to the supervisor
            except Exception as e:  # noqa: BLE001
                from spark_rapids_jni_tpu_torch.serve.queue import Backpressure

                status = (STATUS_BUSY if isinstance(e, Backpressure)
                          else "error")
                sconn.send((MSG_RESULT, rid, status, None,
                            (type(e).__name__, str(e))))
                continue
            _flight.record(_flight.EV_LEASE_GRANT, resp.task_id,
                           detail=f"rid:{rid}:worker:{worker_id}:local")
            threading.Thread(target=waiter, args=(rid, resp), daemon=True,
                             name=f"serve-worker-{worker_id}-rid{rid}").start()
    finally:
        stop.set()
        _set_shuffle_uplink(None)
        if dump_epilogue[0]:
            # end-of-run ring dump so the --cluster merge has this
            # process's timeline even when nothing anomalous happened here
            _flight.anomaly("cluster_epilogue",
                            detail=f"worker:{worker_id}:inc:{incarnation}")
        engine.shutdown(drain=False, timeout=5.0)
        gov.close()
        sconn.close()
