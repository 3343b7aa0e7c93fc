"""Crash-safe peer-to-peer columnar shuffle: the cross-process data plane
(PyTorch port of ``serve/shuffle.py``).

Executors exchange shuffle partitions DIRECTLY over framed sockets
(columnar/frames.py -- length-prefixed, CRC32 over the whole frame) while
the supervisor (serve/supervisor.py) only brokers endpoints and tracks the
partition map.  The transport, its wire format and the partition map are the
JAX package's, byte for byte: a port executor and a JAX executor fetch each
other's partitions.

One cluster shuffle of a plan with an Exchange (``sid``) runs as N child
leases, map task ``m`` on whichever executor currently holds its lease:

1. **map** -- ``plans/compiler.split_exchange_plan`` splits the plan at the
   Exchange; the child subtree emits eagerly over this shard on the
   executor's device, and rows partition by the placement hash the in-mesh
   all_to_all uses (``partition_of``: ``mm_hash_long`` on the card);
2. **produce** -- partitions frame into the process :class:`ShuffleService`
   store and announce up the supervisor pipe (``MSG_SHUFFLE_PRODUCED`` with
   sizes + endpoint); the supervisor broadcasts the updated partition map;
3. **fetch** -- the child pulls partition ``m`` from every map task, local
   store / same-host spool / socket in that order, CRC-verified, with
   seeded-jitter backoff on every failure and a budget reservation bounding
   in-flight transport bytes; each verified fetch acks into the map;
4. **reduce** -- received partitions concat (producer order) into the
   synthetic ``__exchange__`` scan and the reduce plan runs through the
   governed plan runtime on the executor's device; partial sinks return to
   the supervisor, which sums them and evaluates ``post``.

A RangeExchange plan (distributed sort / window / top-k) takes the same
plane with a different partitioner and combiner: the map side ranks rows by
the exchange's sort keys and buckets them against splitters sampled once
from the whole input (:func:`make_range_split`), every shard agreeing on the
global order; each partition's reduce plan orders its rows locally with its
Sort/TopK sink; and the combine concatenates the per-partition results in
partition order -- partition ``p``'s every row orders before partition
``p+1``'s, so the concatenation is the merge.

Crash safety is the lease table's, pushed down to partition granularity: a
producer SIGKILLed mid-exchange drops its lease and the re-dispatched child
re-produces at a new location; a producer that died AFTER completing is
revived by the supervisor as a produce-only child (``reproduce``).  Stores
retain partitions until the supervisor's ``MSG_SHUFFLE_CLEANUP``.

The single-process oracles (:func:`run_exchange_plan_local`,
:func:`run_range_plan_local`) run both halves on one device with no
transport; a cluster's answers must equal them bit for bit.
"""

from __future__ import annotations

import glob
import os
import random
import socket
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar import frames
from spark_rapids_jni_tpu_torch.mem.governed import reservation
from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.obs import trace
from spark_rapids_jni_tpu_torch.obs.faultinj import transport_fault
from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.compiler import (
    EXCHANGE_SOURCE,
    emit_exchange_partitions,
    emit_range_partitions,
    eval_post,
    sample_range_splitters,
    split_exchange_plan,
)
from spark_rapids_jni_tpu_torch.plans.runtime import execute_plan, run_governed_plan
from spark_rapids_jni_tpu_torch.serve import attribution as _attrib
from spark_rapids_jni_tpu_torch.serve import rpc

__all__ = [
    "ShuffleFetchStalled", "ShuffleService", "service",
    "reset_service_for_tests",
    "make_shuffle_handler", "run_shuffle_piece", "plan_adaptive_groups",
    "run_exchange_plan_local", "combine_exchange_outputs",
    "split_tables_n", "scan_table_names",
    "range_split_n", "make_range_split", "run_range_shuffle_piece",
    "make_range_shuffle_handler", "combine_ordered_outputs",
    "run_range_plan_local",
]

# The per-map-task lifecycle tracked in the supervisor's partition map
# (_ShuffleState.tasks[m]["state"]) and mirrored into every
# participant's map view over MSG_SHUFFLE_MAP.  The state travels in
# dict entries (it is wire-visible), so the state-machine pass has no
# attribute sites to check — the table is declared for the
# protocol-model pass (analyze pass 12), whose shuffle environment
# model explores produce / duplicate / SIGKILL-revival interleavings
# against exactly these edges.
# state-machine: shuffle_task field=state
_TASK_TRANSITIONS = {
    "pending": ("produced",),   # MSG_SHUFFLE_PRODUCED recorded (owner
    #                             incarnation matched)
    "produced": ("pending",),   # owner died with its store: revival
    #                             re-points the task at the respawn
}


class ShuffleFetchStalled(RuntimeError):
    """A consumer exhausted ``serve_shuffle_fetch_timeout_s`` waiting for
    one partition.  The supervisor treats this error type as
    re-dispatchable (like BUSY), bounded by ``lease_max_dispatches`` —
    the request re-runs on another executor rather than failing a client
    on transient data-plane weather."""


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    """Read exactly ``n`` bytes or None on a cleanly closed peer; raises
    socket.timeout on a stalled one."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(1 << 20, n - got))
        if not chunk:
            return None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _read_frame_bytes(sock: socket.socket) -> Optional[bytes]:
    """One whole frame off a socket (prefix, then payload); None on EOF.
    A peer that closes mid-payload yields a SHORT frame — the caller's
    decode sees ``truncated``, exactly like a spooled partial write."""
    prefix = _recv_exact(sock, frames.PREFIX.size)
    if prefix is None:
        return None
    _magic, frame_len, _crc = frames.PREFIX.unpack(prefix)
    if frame_len > (1 << 31):
        return prefix  # insane length: let decode fail on magic/len
    rest = _recv_exact(sock, frame_len)
    return prefix + (rest if rest is not None else b"")


class ShuffleService:
    """Per-process shuffle transport endpoint: partition store + framed
    socket server + fetch client + the worker's view of partition maps.

    Everything shared is guarded by ONE condition (AdmissionQueue
    discipline): map updates notify blocked fetchers.  Leaf discipline:
    never held across socket I/O, flight records, or pipe sends.
    """

    def __init__(self, io_timeout_s: Optional[float] = None,
                 spool_dir: Optional[str] = None):
        if io_timeout_s is None:
            io_timeout_s = float(config.get("serve_shuffle_io_timeout_s"))
        if spool_dir is None:
            spool_dir = str(config.get("serve_shuffle_spool_dir") or "")
        self.io_timeout_s = float(io_timeout_s)
        self.spool_dir = spool_dir
        self._cond = threading.Condition()
        # (sid, map_index) -> {part: framed bytes}  # guarded-by: _cond
        self._store: Dict[tuple, Dict[int, bytes]] = {}
        # sid -> {"nparts": n, "tasks": {m: {state, ep, incarnation,
        #         sizes}}} — the supervisor's broadcast partition map
        self._maps: Dict[int, dict] = {}  # guarded-by: _cond
        self._counters: Dict[str, int] = {}  # guarded-by: _cond
        # idle peer connections, endpoint -> sockets: the server loop
        # answers many fetches per connection, so the client keeps a
        # small pool instead of paying a connect per (partition, retry)
        self._conn_lock = threading.Lock()
        self._conns: Dict[tuple, list] = {}  # guarded-by: _conn_lock
        self._sock: Optional[socket.socket] = None
        self._port = 0
        self._accept_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._telemetry_name = ""

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "ShuffleService":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            s.listen(64)
        except BaseException:
            s.close()  # a failed bind must not leak the listener fd
            raise
        with self._cond:
            if self._sock is not None:  # idempotent: already serving
                s.close()
                return self
            self._sock = s
            self._port = s.getsockname()[1]
            name = f"shuffle:{os.getpid()}:{self._port}"
            self._telemetry_name = name
            t = threading.Thread(
                target=self._accept_loop, args=(s,), daemon=True,
                name=f"shuffle-serve-{self._port}")
            self._accept_thread = t
        t.start()
        _flight.register_telemetry_source(name, self.snapshot)
        return self

    def close(self) -> None:
        self._stop.set()
        with self._cond:
            sock = self._sock
            name, self._telemetry_name = self._telemetry_name, ""
        with self._conn_lock:
            idle = [s for socks in self._conns.values() for s in socks]
            self._conns.clear()
        for s in idle + ([sock] if sock is not None else []):
            try:
                s.close()  # the accept loop exits on the OSError
            except OSError:
                pass
        if name:
            _flight.unregister_telemetry_source(name)

    @property
    def endpoint(self) -> tuple:
        with self._cond:
            return ("127.0.0.1", self._port)

    def _count(self, name: str, n: int = 1) -> None:
        with self._cond:
            self._counters[name] = self._counters.get(name, 0) + n

    # -- the serving side --------------------------------------------------
    def _accept_loop(self, sock: socket.socket) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = sock.accept()
            except OSError:
                return  # closed
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name="shuffle-conn").start()

    def _serve_conn(self, conn: socket.socket) -> None:
        """Answer framed FR_FETCH requests on one peer connection until
        EOF.  Transport chaos (frame_corrupt / frame_truncate /
        peer_stall) applies HERE, on the sender — the receiver's
        integrity checks are what's under test."""
        conn.settimeout(max(10.0, 5 * self.io_timeout_s))
        try:
            while not self._stop.is_set():
                raw = _read_frame_bytes(conn)
                if raw is None:
                    return
                try:
                    meta, _bufs = frames.decode_frame(raw)
                except frames.FrameError:
                    return  # a damaged REQUEST is not retryable here
                tag = meta[0]
                if tag != frames.FR_FETCH:
                    continue
                _, sid, map_index, part, _consumer = meta
                with self._cond:
                    data = self._store.get((sid, map_index), {}).get(part)
                    mapped = sid in self._maps
                if data is None:
                    reason = "not_ready" if mapped else "gone"
                    conn.sendall(frames.encode_frame(
                        (frames.FR_NACK, sid, map_index, part, reason)))
                    self._count("nacks")
                    continue
                if not self._send_data(conn, data,
                                       f"{sid}:{map_index}:{part}"):
                    return  # truncation injected: stream is poisoned
        except (OSError, ValueError):
            return  # peer died / stalled out: it will reconnect and retry
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _send_data(self, conn: socket.socket, data: bytes,
                   key: str) -> bool:
        """Send one DATA frame, applying any armed transport fault.
        Returns False when the stream must close (truncation leaves the
        byte stream unframeable)."""
        verdict = transport_fault(f"frame:{key}")
        if verdict is not None and verdict[0] == "frame_corrupt":
            data = frames.corrupt_frame(data, seed=len(data))
            self._count("faults_corrupt")
        trunc = transport_fault(f"trunc:{key}")
        transport_fault(f"stall:{key}")  # peer_stall sleeps in-injector
        if trunc is not None and trunc[0] == "frame_truncate":
            self._count("faults_truncate")
            conn.sendall(frames.truncate_frame(data, seed=len(data)))
            return False
        conn.sendall(data)
        self._count("frames_sent")
        self._count("bytes_sent", len(data))
        return True

    # -- producing ---------------------------------------------------------
    def _spool_path(self, sid: int, m: int, p: int) -> str:
        return os.path.join(self.spool_dir, f"{sid}_{m}_{p}.frame")

    def produce(self, sid: int, m: int,
                partitions: List[Dict[str, np.ndarray]], *,
                rid: int = -1) -> Dict[int, int]:
        """Frame + store this map task's partitions (idempotent — a
        re-dispatched child overwrites bit-identical bytes), spool the
        same frames for same-host readers when configured, announce up
        the supervisor pipe, and return ``{part: nbytes}``."""
        encoded: Dict[int, bytes] = {}
        sizes: Dict[int, int] = {}
        total = 0
        for p, table in enumerate(partitions):
            names = sorted(table)
            rows = int(table[names[0]].shape[0]) if names else 0
            data = frames.encode_table(
                (frames.FR_DATA, sid, m, p, names, rows), table)
            encoded[p] = data
            sizes[p] = len(data)
            total += len(data)
        if self.spool_dir:
            os.makedirs(self.spool_dir, exist_ok=True)
            for p, data in encoded.items():
                tmp = self._spool_path(sid, m, p) + ".tmp"
                with open(tmp, "wb") as f:
                    f.write(data)
                os.replace(tmp, self._spool_path(sid, m, p))  # atomic
        with self._cond:
            self._store[(sid, m)] = encoded
            self._counters["produced"] = self._counters.get(
                "produced", 0) + 1
            self._cond.notify_all()
        _flight.record(_flight.EV_SHUFFLE_PRODUCE, -1,
                       detail=f"rid:{rid}:sid:{sid}:map:{m}:"
                              f"parts:{len(partitions)}", value=total)
        uplink = rpc.shuffle_uplink()
        if uplink is not None:
            send, wid, inc = uplink
            send((rpc.MSG_SHUFFLE_PRODUCED, wid, inc, sid, m, sizes,
                  self.endpoint))
        return sizes

    # -- the worker's partition-map view -----------------------------------
    def on_message(self, msg: tuple) -> None:
        """Sink for supervisor shuffle broadcasts (registered with
        serve/rpc.py's worker loop)."""
        tag = msg[0]
        if tag == rpc.MSG_SHUFFLE_MAP:
            _, sid, nparts, tasks = msg
            with self._cond:
                self._maps[sid] = {"nparts": int(nparts),
                                   "tasks": dict(tasks)}
                self._cond.notify_all()
        elif tag == rpc.MSG_SHUFFLE_CLEANUP:
            self.cleanup(msg[1])

    def cleanup(self, sid: int) -> None:
        """Free one shuffle's store + map + spool files."""
        with self._cond:
            self._maps.pop(sid, None)
            for k in [k for k in self._store if k[0] == sid]:
                self._store.pop(k)
            self._cond.notify_all()
        if self.spool_dir:
            # the spool dir is host-shared: unlink EVERY frame of this
            # sid, not just locally-produced ones, so a SIGKILLed
            # producer's leftovers are removed by whichever participant
            # receives the cleanup broadcast (nothing runs in the dead
            # process itself)
            for path in glob.glob(
                    os.path.join(self.spool_dir, f"{sid}_*.frame")):
                try:
                    os.unlink(path)
                except OSError:
                    pass  # another participant's cleanup won the race

    def task_info(self, sid: int, m: int) -> Optional[dict]:
        with self._cond:
            smap = self._maps.get(sid)
            if smap is None:
                return None
            info = smap["tasks"].get(m)
            return dict(info) if info is not None else None

    def advertised_size(self, sid: int, m: int, p: int) -> Optional[int]:
        """The produced byte size of (sid, m, p) per the current map (or
        the local store) — what the consumer's credit reservation uses."""
        with self._cond:
            local = self._store.get((sid, m))
            if local is not None and p in local:
                return len(local[p])
            smap = self._maps.get(sid)
            if smap is None:
                return None
            info = smap["tasks"].get(m)
            if info is None or info.get("state") != "produced":
                return None
            return info.get("sizes", {}).get(p)

    def wait_advertised(self, sid: int, m: int, p: int, *,
                        deadline: float) -> int:
        """Block (map updates wake early) until (sid, m, p) has an
        advertised size, so the consumer's credit reservation charges
        the EXACT in-flight bytes — never a blind full-window charge
        for a partition whose announcement has not arrived yet."""
        while True:
            n = self.advertised_size(sid, m, p)
            if n is not None:
                return n
            now = time.monotonic()
            if now >= deadline:
                raise ShuffleFetchStalled(
                    f"partition sid:{sid} map:{m} part:{p} never "
                    f"advertised (producer dead or still pending)")
            with self._cond:
                self._cond.wait(min(0.05, deadline - now))

    def wait_all_produced(self, sid: int, ntasks: int, *,
                          deadline: float) -> Dict[int, Dict[int, int]]:
        """Block until the broadcast map shows ALL ``ntasks`` map tasks
        produced; returns the full measured size map ``{m: {p: bytes}}``
        — what the adaptive reduce's partition-grouping step decides
        from.  Deterministic across consumers: sizes are a pure function
        of each shard's rows, so every participant (eventually) sees the
        same map even across producer deaths and re-produces."""
        while True:
            with self._cond:
                smap = self._maps.get(sid)
                if smap is not None:
                    infos = [smap["tasks"].get(t) for t in range(ntasks)]
                    if all(i is not None and i.get("state") == "produced"
                           for i in infos):
                        return {t: {int(p): int(b)
                                    for p, b in
                                    (infos[t].get("sizes") or {}).items()}
                                for t in range(ntasks)}
                now = time.monotonic()
                if now >= deadline:
                    raise ShuffleFetchStalled(
                        f"shuffle sid:{sid}: map tasks still unproduced "
                        f"past the fetch deadline (adaptive exchange "
                        f"needs every map side's sizes)")
                self._cond.wait(min(0.05, deadline - now))

    # -- fetching ----------------------------------------------------------
    def fetch(self, sid: int, m: int, p: int, *,
              deadline: Optional[float] = None,
              rid: int = -1) -> Dict[str, np.ndarray]:
        """Pull + CRC-verify one partition: local store, then same-host
        spool, then the producer's socket — retrying with seeded-jitter
        backoff across corrupt/truncated frames, stalled peers, refused
        connections, and map changes (a re-produced task's new endpoint
        is picked up mid-wait) until ``deadline``."""
        if deadline is None:
            deadline = time.monotonic() + float(
                config.get("serve_shuffle_fetch_timeout_s"))
        base_s = float(config.get("serve_shuffle_backoff_ms")) / 1e3
        # one int seed per (seed, sid, task, part): concurrent consumers
        # of one recovering producer de-phase deterministically
        rng = random.Random(
            int(config.get("serve_shuffle_jitter_seed")) * 1_000_003
            + sid * 8191 + m * 127 + p)
        attempt = 0
        while True:
            attempt += 1
            table, failure = self._fetch_once(sid, m, p)
            if table is not None:
                src, cols = table
                nbytes = frames.table_nbytes(cols)
                self._count("fetched")
                self._count("bytes_fetched", nbytes)
                _flight.record(_flight.EV_SHUFFLE_FETCH, -1,
                               detail=f"rid:{rid}:sid:{sid}:from:{m}:"
                                      f"part:{p}:src:{src}", value=nbytes)
                return cols
            self._count("fetch_retries")
            self._count(f"retry_{failure}")
            _flight.record(_flight.EV_SHUFFLE_RETRY, -1,
                           detail=f"rid:{rid}:sid:{sid}:from:{m}:"
                                  f"part:{p}:reason:{failure}",
                           value=attempt)
            now = time.monotonic()
            if now >= deadline:
                raise ShuffleFetchStalled(
                    f"partition sid:{sid} map:{m} part:{p} unavailable "
                    f"after {attempt} attempts (last: {failure})")
            # seeded-jitter backoff, woken early by any map update (a
            # re-produced partition should not wait out a full backoff)
            wait = min(base_s * min(attempt, 20) * rng.uniform(0.5, 1.5),
                       max(0.0, deadline - now))
            with self._cond:
                self._cond.wait(wait)

    def _fetch_once(self, sid: int, m: int, p: int):
        """One attempt; returns ((src, columns), None) or (None, reason)."""
        with self._cond:
            local = self._store.get((sid, m))
            data = local.get(p) if local is not None else None
        if data is not None:
            try:
                return self._decode(data, sid, m, p, "local"), None
            except frames.FrameError as e:  # cannot happen for own frames
                return None, e.reason
        info = self.task_info(sid, m)
        if info is None:
            return None, "unmapped"
        if info.get("state") != "produced":
            return None, "pending"
        if self.spool_dir:
            try:
                with open(self._spool_path(sid, m, p), "rb") as f:
                    raw = f.read()
                return self._decode(raw, sid, m, p, "spool"), None
            except OSError:
                pass  # not spooled here (remote host) — use the socket
            except frames.FrameError as e:
                return None, e.reason
        ep = info.get("ep")
        if not ep:
            return None, "no_endpoint"
        s = self._conn_acquire(tuple(ep))
        if s is None:
            return None, "stall"
        # one finally owns the socket on EVERY path out of the exchange:
        # a clean round trip returns the connection to the pool, anything
        # else — I/O error, EOF, a damaged frame that may leave the byte
        # stream unframeable (injected truncation closes it server-side
        # anyway), or an unexpected fault — drops it, so no path can
        # leak the fd or pool a poisoned stream
        keep = False
        try:
            try:
                s.settimeout(self.io_timeout_s)
                s.sendall(frames.encode_frame(
                    (frames.FR_FETCH, sid, m, p, -1)))
                raw = _read_frame_bytes(s)
            except (OSError, socket.timeout):
                return None, "stall"
            if raw is None:
                return None, "eof"
            try:
                meta, bufs = frames.decode_frame(raw)
            except frames.FrameError as e:
                return None, e.reason
            keep = True
        finally:
            if keep:
                self._conn_release(tuple(ep), s)
            else:
                self._conn_drop(s)
        tag = meta[0]
        if tag == frames.FR_NACK:
            _, _sid, _map_index, _part, reason = meta
            return None, str(reason)
        if tag != frames.FR_DATA or tuple(meta[1:4]) != (sid, m, p):
            return None, "mismatch"
        return ("socket", frames.decode_table(meta, bufs)), None

    def _conn_acquire(self, ep: tuple) -> Optional[socket.socket]:
        # resource: acquire socket
        """An idle pooled connection to ``ep``, or a fresh one; a socket
        is checked out exclusively (request/response framing must never
        interleave across handler threads).  Every checkout must reach
        :meth:`_conn_release` (pool it) or :meth:`_conn_drop` (close it)
        on all paths — the resource-lifecycle gate pins this."""
        with self._conn_lock:
            idle = self._conns.get(ep)
            if idle:
                return idle.pop()
        try:
            return socket.create_connection(ep,
                                            timeout=self.io_timeout_s)
        except (OSError, socket.timeout):
            return None

    def _conn_release(self, ep: tuple, s: socket.socket) -> None:
        # resource: release socket
        with self._conn_lock:
            idle = self._conns.setdefault(ep, [])
            if len(idle) < 2 and not self._stop.is_set():
                idle.append(s)
                return
        self._conn_drop(s)

    @staticmethod
    def _conn_drop(s: socket.socket) -> None:
        # resource: release socket
        try:
            s.close()
        except OSError:
            pass

    def _decode(self, raw: bytes, sid: int, m: int, p: int, src: str):
        meta, bufs = frames.decode_frame(raw)
        tag = meta[0]
        if tag != frames.FR_DATA or tuple(meta[1:4]) != (sid, m, p):
            raise frames.FrameError(
                f"frame identifies {meta[1:4]}, wanted {(sid, m, p)}",
                "header")
        return (src, frames.decode_table(meta, bufs))

    def ack(self, sid: int, m: int, p: int, *, rid: int = -1) -> None:
        """Record a verified fetch into the supervisor's partition map."""
        _flight.record(_flight.EV_SHUFFLE_ACK, -1,
                       detail=f"rid:{rid}:sid:{sid}:from:{m}:part:{p}")
        self._count("acks_sent")
        uplink = rpc.shuffle_uplink()
        if uplink is not None:
            send, wid, inc = uplink
            send((rpc.MSG_SHUFFLE_ACK, wid, inc, sid, m, p))

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> dict:
        """Transport gauges (registered as a flight telemetry source)."""
        with self._cond:
            store_bytes = sum(len(d) for parts in self._store.values()
                              for d in parts.values())
            return {
                "endpoint": list(self.endpoint),
                "counters": dict(self._counters),
                "store_partitions": sum(len(p)
                                        for p in self._store.values()),
                "store_bytes": store_bytes,
                "live_shuffles": len(self._maps),
            }


# --------------------------------------------------------------------------
# process singleton (one transport endpoint per executor process)
# --------------------------------------------------------------------------

_service_lock = threading.Lock()
_service: Optional[ShuffleService] = None


def service() -> ShuffleService:
    """The process's ShuffleService, started (and registered as the rpc
    shuffle-message sink) on first use — executor workers that never
    serve a shuffle handler never open the socket."""
    global _service
    with _service_lock:
        if _service is None:
            svc = ShuffleService().start()
            rpc.set_shuffle_sink(svc.on_message)
            _service = svc
        return _service


def reset_service_for_tests() -> None:
    global _service
    with _service_lock:
        svc, _service = _service, None
    if svc is not None:
        rpc.set_shuffle_sink(None)
        svc.close()



# --------------------------------------------------------------------------
# the executor-side handler: one shuffle child lease end to end
# --------------------------------------------------------------------------


def scan_table_names(plan) -> set:
    """Names of the plan's scan tables (what split_tables_n chunks)."""
    return {s.table for s in ir.scan_tables(plan)}


def split_tables_n(tables: Dict[str, Dict[str, np.ndarray]],
                   scan_names, n: int) -> List[dict]:
    """Split scan tables into ``n`` contiguous row chunks (dims ride whole
    into every chunk) -- the supervisor-side shard split."""
    out: List[dict] = [{} for _ in range(n)]
    for table, fields in tables.items():
        if table not in scan_names:
            for shard in out:
                shard[table] = fields
            continue
        rows = len(next(iter(fields.values())))
        for i, shard in enumerate(out):
            lo, hi = rows * i // n, rows * (i + 1) // n
            shard[table] = {k: v[lo:hi] for k, v in fields.items()}
    return out


def _reduce_tables(reduce_plan, received, exchange, tables) -> Dict[str, Any]:
    """The reduce half's inputs: the received partitions concatenated in
    fetch order as the synthetic exchange scan, plus the dims whole."""
    concat = (received[0] if len(received) == 1 else
              {f: np.concatenate([r[f] for r in received]) for f in exchange.fields})
    out: Dict[str, Any] = {EXCHANGE_SOURCE: concat}
    for dim in ir.dim_tables(reduce_plan):
        out[dim.table] = tables[dim.table]
    return out


def run_shuffle_piece(plan, payload: dict, ctx) -> Dict[str, np.ndarray]:
    """One shuffle child on this executor: map -> produce -> fetch/ack ->
    reduce, both halves on the executor's device (``ctx.device``).
    ``payload`` = ``{"sid", "m", "nparts", "rid", "data": <shard tables>,
    "reproduce": bool}`` (built by the supervisor's shuffle dispatch).
    Returns the PARTIAL sink outputs (summed by the supervisor's combine), or
    a marker dict for produce-only revivals and coalesced-away consumers."""
    sid = int(payload["sid"])
    m = int(payload["m"])
    nparts = int(payload["nparts"])
    rid = int(payload.get("rid", -1))
    tables = payload["data"]
    svc = service()
    exchange, reduce_plan = split_exchange_plan(plan)
    # adaptive exchange: over-partition the map side so the reduce side can
    # regroup by MEASURED bytes.  The factor is config, broadcast identically
    # to every worker, so all participants (revivals included) agree on the
    # emitted partition count with no wire change.
    adaptive = bool(config.get("serve_adaptive_exchange"))
    over = (max(1, int(config.get("serve_adaptive_overpartition")))
            if adaptive else 1)
    nemit = nparts * over
    parts = emit_exchange_partitions(exchange, tables, nemit, device=ctx.device)
    svc.produce(sid, m, parts, rid=rid)
    if payload.get("reproduce"):
        return {"reproduced": np.int64(m)}

    if adaptive:
        # every consumer waits for ALL map sides' measured sizes, then packs
        # partitions into at most nparts groups -- the same deterministic
        # grouping on every consumer, so each emitted partition is reduced
        # exactly once (exact for these plans' integer additive sinks)
        deadline = time.monotonic() + float(
            config.get("serve_shuffle_fetch_timeout_s"))
        sizes = svc.wait_all_produced(sid, nparts, deadline=deadline)
        totals = [sum(sizes[k].get(p, 0) for k in range(nparts))
                  for p in range(nemit)]
        groups = plan_adaptive_groups(
            totals, nparts, int(config.get("serve_adaptive_part_bytes")))
        nonempty = sum(1 for g in groups if g)
        strategy = ("broadcast" if nonempty == 1
                    else "coalesce" if nonempty < nemit else "shuffle")
        _flight.record(_flight.EV_ADAPT_EXCHANGE, rid,
                       detail=f"rid:{rid}:sid:{sid}:strategy:{strategy}:"
                              f"parts:{nemit}->{nonempty}",
                       value=sum(totals))
        group = groups[m]
        if not group:
            # this consumer's group coalesced away: a marker the combiner
            # skips -- its map-side partitions still served every fetch
            return {"adaptive_empty": np.int64(m)}
        received = _fetch_partitions(svc, sid, group, nparts, rid, ctx)
    else:
        received = _fetch_partitions(svc, sid, [m], nparts, rid, ctx)
    out = run_governed_plan(None, reduce_plan,
                            _reduce_tables(reduce_plan, received, exchange, tables),
                            budget=ctx.budget, task_id=ctx.task_id,
                            manage_task=False, device=ctx.device)
    return {k: np.asarray(v) for k, v in out.items()}


def plan_adaptive_groups(totals: List[int], nconsumers: int,
                         target: int) -> List[List[int]]:
    """Pack contiguous partition indices into at most ``nconsumers``
    groups, closing a group once its MEASURED bytes reach ``target``.
    Pure and deterministic -- every consumer derives the identical grouping
    from the identical broadcast sizes.  Always returns exactly
    ``nconsumers`` groups (trailing ones may be empty); total bytes under
    ``target`` collapse to a single broadcast-style group."""
    groups: List[List[int]] = []
    cur: List[int] = []
    acc = 0
    for p, b in enumerate(totals):
        cur.append(p)
        acc += int(b)
        if acc >= target and len(groups) < nconsumers - 1:
            groups.append(cur)
            cur = []
            acc = 0
    if cur or not groups:
        groups.append(cur)
    while len(groups) < nconsumers:
        groups.append([])
    return groups


def _fetch_partitions(svc, sid: int, parts: List[int], ntasks: int,
                      rid: int, ctx) -> List[Dict[str, np.ndarray]]:
    """Pull every partition index in ``parts`` from every map task, in
    (partition, map-task) order (the concat order correctness depends on),
    budget-reserved and acked -- the shared fetch half of the static,
    adaptive and range shuffle pieces."""
    credit = int(config.get("serve_shuffle_credit_bytes"))
    fetch_timeout = float(config.get("serve_shuffle_fetch_timeout_s"))
    received: List[Dict[str, np.ndarray]] = []
    for p in parts:
        for k in range(ntasks):
            # each PARTITION gets the full fetch budget: one slow-recovering
            # producer must not starve the fetches that follow it
            deadline = time.monotonic() + fetch_timeout
            with trace.maybe_span(trace.SPAN_TRANSPORT,
                                  extra=f"sid:{sid}:from:{k}:part:{p}"):
                # credit-based backpressure: reserve the advertised partition
                # bytes (clamped to the credit window) from the executor's
                # governed budget across the in-flight fetch+decode, so
                # transport memory competes with compute through the normal
                # protocol (a RetryOOM here re-runs the whole piece)
                nbytes = min(
                    svc.wait_advertised(sid, k, p, deadline=deadline),
                    credit)
                with reservation(ctx.budget, nbytes):
                    cols = svc.fetch(sid, k, p, deadline=deadline, rid=rid)
                svc.ack(sid, k, p, rid=rid)
                # this thread serves the consumer request, so its active
                # attribution record (if any) owns the fetched bytes
                _attrib.note_tx(nbytes)
            received.append(cols)
    return received


def make_shuffle_handler(plan) -> Callable:
    """The executor-side ``QueryHandler.fn`` for one Exchange plan."""

    def fn(payload, ctx):
        return run_shuffle_piece(plan, payload, ctx)

    return fn


# --------------------------------------------------------------------------
# supervisor-side helpers (combine) and the single-process oracle
# --------------------------------------------------------------------------


def combine_exchange_outputs(plan) -> Callable:
    """The supervisor-side join combiner: sum the children's partial sinks
    (the host analog of the in-mesh all_reduce), THEN evaluate the plan's
    post expressions.  Revival and coalesced-away children's marker results
    are skipped."""

    def combine(outs: List[Dict[str, np.ndarray]]):
        sums: Dict[str, np.ndarray] = {}
        for o in outs:
            if len(o) == 1 and ("reproduced" in o or "adaptive_empty" in o):
                continue
            for k, v in o.items():
                sums[k] = (sums[k] + v) if k in sums else np.asarray(v)
        return {k: np.asarray(v) for k, v in eval_post(plan, sums).items()}

    return combine


def run_exchange_plan_local(plan, tables, device: _device.DeviceLike = None
                            ) -> Dict[str, np.ndarray]:
    """The single-process oracle of the cross-process path: one shard, one
    partition, no transport -- map emit, identity 'shuffle', the same reduce
    plan, post over the sinks.  Both halves run on ``device``, the card
    unless the caller asks for the CPU."""
    exchange, reduce_plan = split_exchange_plan(plan)
    (part0,) = emit_exchange_partitions(exchange, tables, 1, device=device)
    out = execute_plan(None, reduce_plan,
                       _reduce_tables(reduce_plan, [part0], exchange, tables),
                       device=device)
    return {k: np.asarray(v) for k, v in eval_post(plan, out).items()}


# --------------------------------------------------------------------------
# the range shuffle: distributed sort / window / top-k
# --------------------------------------------------------------------------
# Splitters ride the shard payloads the supervisor retains, so a
# re-dispatched or revived map task re-produces bit-identical partitions.


def range_split_n(plan, tables: Dict[str, Dict[str, np.ndarray]], n: int,
                  sample_cap: int = 4096, device: _device.DeviceLike = None) -> List[dict]:
    """ShuffleSpec.split_n for a RangeExchange plan: choose splitters once
    from the WHOLE input (sampled, the map fragment emitted on ``device``),
    then chunk the scan tables into ``n`` contiguous row shards, each
    carrying the same splitters."""
    exchange, _reduce = split_exchange_plan(plan)
    splitters = sample_range_splitters(exchange, tables, n, sample_cap=sample_cap,
                                       device=device)
    shards = split_tables_n(tables, scan_table_names(plan), n)
    return [{"tables": s, "splitters": splitters} for s in shards]


def make_range_split(plan, sample_cap: int = 4096,
                     device: _device.DeviceLike = None) -> Callable:
    """A ShuffleSpec's ``split_n`` for a RangeExchange plan; its splitters
    are sampled on ``device`` in the supervisor's process."""
    def split_n(tables, n):
        return range_split_n(plan, tables, n, sample_cap=sample_cap, device=device)

    return split_n


def run_range_shuffle_piece(plan, payload: dict, ctx) -> Dict[str, np.ndarray]:
    """One RANGE-shuffle child: map (rank + splitter bucketing, partial top-k
    below the wire) -> produce -> fetch/ack -> ordered local reduce, both
    halves on the executor's device.  ``payload["data"]`` is ``{"tables":
    <shard>, "splitters": <dispatch-time splitters>}``.  Returns the sink's
    ordered field vectors sliced to the valid ``rows``, so the supervisor's
    combine concatenates without trimming."""
    sid = int(payload["sid"])
    m = int(payload["m"])
    nparts = int(payload["nparts"])
    rid = int(payload.get("rid", -1))
    shard = payload["data"]
    tables = shard["tables"]
    splitters = [tuple(s) for s in shard["splitters"]]
    svc = service()
    exchange, reduce_plan = split_exchange_plan(plan)
    parts = emit_range_partitions(exchange, tables, nparts, splitters, device=ctx.device)
    svc.produce(sid, m, parts, rid=rid)
    if payload.get("reproduce"):
        return {"reproduced": np.int64(m)}

    received = _fetch_partitions(svc, sid, [m], nparts, rid, ctx)
    out = run_governed_plan(None, reduce_plan,
                            _reduce_tables(reduce_plan, received, exchange, tables),
                            budget=ctx.budget, task_id=ctx.task_id,
                            manage_task=False, device=ctx.device)
    return _slice_order_output(reduce_plan, out)


def _slice_order_output(reduce_plan, out) -> Dict[str, np.ndarray]:
    """Trim an order sink's padded output vectors to the valid ``rows``
    prefix (invalid rows sort last by construction): exact-size rows are
    what crosses the wire and what the ordered combine glues."""
    sink = ir.order_sink(reduce_plan)
    rows = int(out["rows"])
    sliced = {f: np.asarray(out[f])[:rows] for f in sink.fields}
    sliced["rows"] = np.int64(rows)
    return sliced


def make_range_shuffle_handler(plan) -> Callable:
    """The executor-side ``QueryHandler.fn`` for one RangeExchange plan."""

    def fn(payload, ctx):
        return run_range_shuffle_piece(plan, payload, ctx)

    return fn


def combine_ordered_outputs(plan) -> Callable:
    """The join combiner of a range shuffle: results arrive in PARTITION
    order, each already sorted within its key range, so the global result is
    their concatenation -- plus the TopK truncation, since k rows per
    partition can still be nparts*k rows in all.  Produce-only revivals'
    marker results are skipped."""
    sink = ir.order_sink(plan)
    if sink is None:
        raise ValueError(
            f"plan {plan.name!r} has no Sort/TopK sink: use "
            f"combine_exchange_outputs for additive plans")

    def combine(outs: List[Dict[str, np.ndarray]]):
        parts = [o for o in outs
                 if o is not None and not ("reproduced" in o and len(o) == 1)]
        cat = {f: np.concatenate([np.asarray(p[f]) for p in parts]) for f in sink.fields}
        rows = sum(int(p["rows"]) for p in parts)
        if isinstance(sink, ir.TopK):
            k = int(sink.k)
            cat = {f: v[:k] for f, v in cat.items()}
            rows = min(rows, k)
        cat["rows"] = np.int64(rows)
        return cat

    return combine


def run_range_plan_local(plan, tables, device: _device.DeviceLike = None
                         ) -> Dict[str, np.ndarray]:
    """The single-process oracle of the range shuffle: one shard, one
    partition, no splitters, no transport -- the map emit, an identity
    'shuffle', the same reduce plan, sliced to the valid rows.  Both halves
    run on ``device``, the card unless the caller asks for the CPU.  A
    cluster's outputs must equal this bit for bit, row order included."""
    exchange, reduce_plan = split_exchange_plan(plan)
    (part0,) = emit_range_partitions(exchange, tables, 1, (), device=device)
    out = execute_plan(None, reduce_plan,
                       _reduce_tables(reduce_plan, [part0], exchange, tables),
                       device=device)
    return _slice_order_output(reduce_plan, out)
