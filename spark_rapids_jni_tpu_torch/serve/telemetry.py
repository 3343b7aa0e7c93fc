"""The live cluster telemetry plane: continuous export + queryable timeline
(a copy of the JAX package's ``serve/telemetry.py``; the same JSON view, so
``tools/servetop.py`` reads a port supervisor's endpoint).

Rounds 4-13 built deep per-process observability — the always-on flight
ring, anomaly dumps, the ``--cluster`` dump merge — but all of it is
POST-HOC: until something anomalous dumps, nobody can answer "where did
request X spend its 80 ms" or "is tenant Y burning its p99 budget" while
the cluster is running.  The reference ships an *always-on* CUPTI
profiler for exactly this reason.  This module is the continuous analog:

- :class:`TelemetryExporter` — runs in each executor worker (piggybacked
  on the heartbeat thread, serve/rpc.py): every ``serve_telemetry_s`` it
  ships the flight ring's rolling delta (``FlightRecorder.snapshot_since``
  cursor) plus a ``ServeMetrics`` snapshot up the supervisor pipe as one
  ``MSG_TELEMETRY`` message.  The export NEVER blocks the worker: an
  undeliverable message (stalled supervisor pipe past the SafeConn send
  guard) is skipped and counted (``EV_TELEMETRY_DROP``), mirroring the
  round-13 heartbeat fix — a healthy worker must not wedge, or fall
  silent, for the supervisor's own congestion.
- :class:`ClusterTimeline` — supervisor-side bounded merge of every
  process's exports (its own ring included): events gain ``pid`` and an
  aligned ``wall_s`` from each export's paired (wall, monotonic) stamp —
  the same alignment the dump merge uses — and group by ``rid:``/``sid:``
  detail tokens, so span waterfalls (obs/trace.py) and lease chains
  reconstruct LIVE.
- :class:`TelemetryServer` — a local TCP endpoint (127.0.0.1, one JSON
  snapshot per connection) serving the merged timeline + per-worker
  metrics + supervisor/SLO state: the feed behind ``flightdump --live``
  and ``tools/servetop.py``.

Retention is bounded end to end: the worker ring bounds what a delta can
carry, ``serve_telemetry_max_events`` bounds one message, and
``serve_timeline_events`` bounds the supervisor's merged history.
"""

from __future__ import annotations

import collections
import json
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.serve import rpc

__all__ = [
    "TelemetryExporter", "ClusterTimeline", "TelemetryServer",
    "fetch_view", "TIMELINE_SCHEMA",
]

TIMELINE_SCHEMA = "srt-live-timeline-v1"

_RID_TOKEN = "rid:"
_SID_TOKEN = "sid:"


class TelemetryExporter:
    """One worker's continuous export of flight-ring deltas + metrics.

    ``metrics_source`` is sampled per export (typically
    ``engine.metrics.snapshot``); ``recorder`` defaults to the process
    singleton.  :meth:`export` is called from the heartbeat thread with
    the SafeConn's bounded-time ``send`` — this class adds pacing,
    delta-cursor bookkeeping, and trim/skip accounting, and never blocks
    beyond that send.
    """

    def __init__(self, worker_id: int, incarnation: int, *,
                 metrics_source: Optional[Callable[[], dict]] = None,
                 recorder: Optional["_flight.FlightRecorder"] = None,
                 min_period_s: Optional[float] = None,
                 max_events: Optional[int] = None):
        from spark_rapids_jni_tpu_torch import config

        self.worker_id = int(worker_id)
        self.incarnation = int(incarnation)
        self._metrics_source = metrics_source
        self._recorder = recorder if recorder is not None \
            else _flight.recorder()
        self.min_period_s = (float(config.get("serve_telemetry_s"))
                             if min_period_s is None else float(min_period_s))
        self.max_events = (int(config.get("serve_telemetry_max_events"))
                           if max_events is None else int(max_events))
        # shared between the heartbeat thread (periodic exports) and
        # result-waiter threads (the force-flush that makes a completed
        # request's spans survive a SIGKILL landing before the next
        # beat) — one leaf lock serializes the CURSOR BOOKKEEPING ONLY.
        # The pipe send itself runs OUTSIDE the lock (round-16 fix,
        # blocking-under-lock gate): the bounded-time SafeConn send can
        # still cost its full timeout against a stalled supervisor, and
        # holding the lock across it made every concurrent force-flush
        # queue behind that stall.  `_inflight` hands the window to one
        # sender at a time, so snapshots never overlap and the cursor
        # stays exactly-once; a force arriving mid-send parks in
        # `_force_pending` and the in-flight sender drains it — the
        # completed request's spans still leave before the next beat,
        # without a second thread ever blocking.
        self._lock = threading.Lock()
        self._cursor = 0  # guarded-by: _lock
        self._last_t = -1e9  # guarded-by: _lock
        self._inflight = False  # guarded-by: _lock
        self._force_pending = False  # guarded-by: _lock
        # after a failed send, FORCE flushes stand down until the pipe
        # proves drained (a periodic export succeeds): each failed
        # attempt costs the sender the SafeConn guard's full timeout, so
        # per-request force-flushes against a stalled pipe would
        # collapse serving throughput to one group per timeout
        self._fail_cooldown = False  # guarded-by: _lock
        self._announced = False  # guarded-by: _lock
        # guarded-by: _lock
        self.stats = {"exports": 0, "events": 0, "skipped": 0,
                      "trimmed": 0, "paced": 0}

    def export(self, send: Callable[[tuple], bool], *,
               force: bool = False) -> bool:
        """Ship one delta through ``send`` (bounded-time, returns False
        when the peer is unreachable/stalled).  Returns True when there
        was nothing to do or the delta shipped; False when it was
        skipped — the cursor then stays put so the NEXT export retries
        the same window (the ring is the retention bound).  ``force``
        bypasses the pacing: result waiters flush at completion so a
        request's spans are off-process BEFORE a kill can eat them."""
        ok = True
        while True:
            with self._lock:
                plan = self._plan_locked(force)
            if plan is None:
                return ok
            events, cursor = plan
            # the window is claimed (_inflight): the commit MUST run
            # even if the caller-supplied send raises, or every future
            # export would skip at the inflight check forever
            sent = False
            try:
                metrics = {}
                if self._metrics_source is not None:
                    try:
                        metrics = dict(self._metrics_source())
                    # analyze: ignore[retry-protocol] - sampling a
                    # metrics snapshot for export: a failing sampler
                    # (engine mid-shutdown) degrades to an empty
                    # snapshot, never a wedged heartbeat thread
                    except Exception:  # noqa: BLE001
                        metrics = {}
                sent = send((rpc.MSG_TELEMETRY, self.worker_id,
                             self.incarnation, time.time(),
                             time.monotonic_ns(), events, metrics))
            finally:
                with self._lock:
                    again = self._commit_locked(sent, cursor,
                                                len(events))
            ok = ok and sent
            if not again:
                return ok
            force = True  # drain the force that arrived mid-send

    def _plan_locked(self, force: bool):
        """Claim the next export window, or None when there is nothing
        to send (paced, cooled down, empty, or another sender owns the
        pipe right now — a force then parks in ``_force_pending``)."""
        if self._inflight:
            if force:
                self._force_pending = True
            self.stats["paced"] += 1
            return None
        now = time.monotonic()
        if force and self._fail_cooldown:
            # stalled pipe: only the heartbeat-paced path keeps probing
            self.stats["paced"] += 1
            return None
        if not force and now - self._last_t < self.min_period_s:
            self.stats["paced"] += 1
            return None
        events, cursor = self._recorder.snapshot_since(self._cursor)
        if not events and force:
            return None  # a flush with nothing new costs nothing
        if len(events) > self.max_events:
            # ship the newest, count the trim loudly: one giant post-storm
            # delta must not wedge the pipe behind it
            dropped = len(events) - self.max_events
            events = events[-self.max_events:]
            self.stats["trimmed"] += dropped
            _flight.record(_flight.EV_TELEMETRY_DROP, -1,
                           detail=f"worker:{self.worker_id}:trimmed",
                           value=dropped)
        self._inflight = True
        return events, cursor

    def _commit_locked(self, sent: bool, cursor: int,
                       n_events: int) -> bool:
        """Settle one send; True when a parked force needs draining."""
        self._inflight = False
        pending, self._force_pending = self._force_pending, False
        if not sent:
            # stalled/retired pipe: skip — NEVER block or exit.  The
            # cursor stays put, so the window re-ships when the pipe
            # drains; events older than the ring just age out.  Force
            # flushes stand down until a paced export succeeds.
            self._fail_cooldown = True
            self.stats["skipped"] += 1
            _flight.record(_flight.EV_TELEMETRY_DROP, -1,
                           detail=f"worker:{self.worker_id}:send_failed")
            return False
        self._fail_cooldown = False
        self._cursor = cursor
        self._last_t = time.monotonic()
        self.stats["exports"] += 1
        self.stats["events"] += n_events
        if not self._announced:
            self._announced = True
            _flight.record(_flight.EV_TELEMETRY_EXPORT, -1,
                           detail=f"worker:{self.worker_id}:"
                                  f"inc:{self.incarnation}:up",
                           value=n_events)
        return pending


class ClusterTimeline:
    """Bounded, queryable merge of every process's telemetry exports.

    Events are normalized exactly like the ``flightdump --cluster`` dump
    merge — ``pid`` attached, per-process monotonic times re-based onto
    the wall clock via each export's stamp pair — so one reconstruction
    grammar (rid chains, sid chains, span waterfalls) serves dumps AND
    the live plane.  Deduplication is a per-(pid, incarnation) high-water
    ``seq`` mark, O(1) per event.

    ``on_event`` (round 21) observes each NEW post-dedup event — the
    attribution rollup's feed.  Hooking downstream of the seq high-water
    is what makes a re-shipped delta (stalled pipe retry) unable to
    double-count a request's costs; the callback fires OUTSIDE the
    timeline lock, so consumers may take their own locks freely.
    """

    def __init__(self, max_events: Optional[int] = None,
                 on_event: Optional[Callable[[dict], None]] = None):
        from spark_rapids_jni_tpu_torch import config

        if max_events is None:
            max_events = int(config.get("serve_timeline_events"))
        self._lock = threading.Lock()
        self._on_event = on_event
        # normalized event dicts, append-ordered  # guarded-by: _lock
        self._events: "collections.deque" = collections.deque(
            maxlen=max_events)
        # (pid, incarnation) -> highest seq ingested  # guarded-by: _lock
        self._seq_hi: Dict[tuple, int] = {}
        # (pid, incarnation) -> highest wall_s emitted  # guarded-by: _lock
        self._wall_hi: Dict[tuple, float] = {}
        # pid -> latest metrics snapshot + meta  # guarded-by: _lock
        self._workers: Dict[int, dict] = {}
        self.ingests = 0  # guarded-by: _lock
        self.dropped_stale = 0  # guarded-by: _lock
        self.clamped = 0  # guarded-by: _lock

    def ingest(self, pid: int, wall_t: float, t_ns: int,
               events: List[dict], *, incarnation: int = 0,
               worker_id: int = -1,
               metrics: Optional[dict] = None) -> int:
        """Merge one export; returns how many events were new."""
        added = 0
        key = (int(pid), int(incarnation))
        fresh: List[dict] = []
        with self._lock:
            self.ingests += 1
            hi = self._seq_hi.get(key, 0)
            wall_hi = self._wall_hi.get(key, float("-inf"))
            for e in events:
                seq = int(e.get("seq", 0))
                if seq and seq <= hi:
                    self.dropped_stale += 1
                    continue
                ev = dict(e)
                ev["pid"] = int(pid)
                # the stamp pair re-bases this process's monotonic clock
                ws = wall_t - (t_ns - int(e.get("t_ns", 0))) / 1e9
                # a wall clock stepped backward between exports (NTP)
                # would make this delta's events PREDATE ones already
                # ingested from the same stream — the event order (seq,
                # monotonic) is ground truth, so clamp the re-base to
                # keep per-stream wall_s monotone and count it
                if ws < wall_hi:
                    ws = wall_hi
                    self.clamped += 1
                wall_hi = ws
                ev["wall_s"] = ws
                self._events.append(ev)
                if seq:
                    hi = seq
                added += 1
                if self._on_event is not None:
                    fresh.append(ev)
            self._seq_hi[key] = hi
            self._wall_hi[key] = wall_hi
            if metrics is not None:
                self._workers[int(pid)] = {
                    "worker_id": int(worker_id),
                    "incarnation": int(incarnation),
                    "wall_t": wall_t,
                    "metrics": metrics,
                }
        for ev in fresh:
            try:
                self._on_event(ev)
            # analyze: ignore[retry-protocol] - a consumer hook must
            # never kill the recv thread feeding the timeline; the
            # rollup counts its own unparsable events
            except Exception:  # noqa: BLE001
                pass
        return added

    def merged(self, *, since_wall_s: float = 0.0) -> dict:
        """The cluster view in the dump-merge shape ``{pids, events,
        rids, sids}`` — flightdump's ``format_cluster`` and the span
        waterfall reconstruction consume either source unchanged."""
        with self._lock:
            events = [e for e in self._events
                      if e["wall_s"] >= since_wall_s]
        events.sort(key=lambda e: e["wall_s"])
        rids: Dict[str, List[dict]] = {}
        sids: Dict[str, List[dict]] = {}
        for e in events:
            detail = str(e.get("detail", ""))
            # token scan without regex: this runs per query, over the
            # full window — keep it a string find, not a regex walk
            for tok, out in ((_RID_TOKEN, rids), (_SID_TOKEN, sids)):
                i = detail.find(tok)
                while i > 0 and detail[i - 1] != ":":
                    i = detail.find(tok, i + 1)
                if i < 0:
                    continue
                j = i + len(tok)
                k = j
                while k < len(detail) and detail[k].isdigit():
                    k += 1
                if k > j:
                    out.setdefault(detail[j:k], []).append(e)
        return {"pids": sorted({e["pid"] for e in events}),
                "events": events, "rids": rids, "sids": sids}

    def worker_metrics(self) -> Dict[str, dict]:
        with self._lock:
            return {str(pid): dict(w) for pid, w in self._workers.items()}

    def stats(self) -> dict:
        with self._lock:
            return {"events": len(self._events),
                    "ingests": self.ingests,
                    "dropped_stale": self.dropped_stale,
                    "clamped": self.clamped,
                    "processes": len(self._seq_hi)}


class TelemetryServer:
    """The supervisor's local telemetry endpoint: a 127.0.0.1 TCP
    listener that writes one JSON view per connection and closes — no
    protocol to version, trivially consumable from ``nc``, flightdump
    ``--live``, and servetop.  ``view_source`` builds the payload (the
    supervisor composes timeline + workers + ladder + SLO state)."""

    def __init__(self, view_source: Callable[[], dict],
                 port: Optional[int] = None):
        from spark_rapids_jni_tpu_torch import config

        self._view_source = view_source
        self._port = (int(config.get("serve_telemetry_port"))
                      if port is None else int(port))
        self._sock: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.endpoint: Optional[tuple] = None
        self.served = 0

    def start(self) -> "TelemetryServer":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", self._port))
            s.listen(16)
            s.settimeout(0.25)
        except BaseException:
            s.close()  # a failed bind (port taken) must not leak the fd
            raise
        self._sock = s
        self.endpoint = s.getsockname()
        self._thread = threading.Thread(target=self._serve_loop,
                                        daemon=True,
                                        name="serve-telemetry-endpoint")
        self._thread.start()
        return self

    def _serve_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # closed under us during shutdown
            try:
                # accepted sockets do NOT inherit the listener's
                # timeout: a consumer that connects and never reads
                # (suspended servetop) must cost one bounded write, not
                # wedge the endpoint thread.  Inside the try so even a
                # failing setsockopt cannot leak the accepted fd.
                conn.settimeout(5.0)
                try:
                    view = self._view_source()
                # analyze: ignore[retry-protocol] - building the view
                # samples live gauges mid-anything; a failure must answer
                # the client in-band, never kill the endpoint thread
                except Exception as e:  # noqa: BLE001
                    view = {"schema": TIMELINE_SCHEMA,
                            "error": repr(e)[:200]}
                conn.sendall(json.dumps(view).encode("utf-8"))
                self.served += 1
            except OSError:
                pass  # client went away mid-write: its problem
            finally:
                try:
                    conn.close()
                except OSError:
                    pass

    def close(self) -> None:
        self._stop.set()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)


def fetch_view(host: str, port: int, timeout_s: float = 5.0) -> dict:
    """Client half of the endpoint: one connection, one JSON view."""
    with socket.create_connection((host, int(port)),
                                  timeout=timeout_s) as s:
        s.settimeout(timeout_s)
        chunks = []
        while True:
            b = s.recv(1 << 16)
            if not b:
                break
            chunks.append(b)
    return json.loads(b"".join(chunks).decode("utf-8"))
