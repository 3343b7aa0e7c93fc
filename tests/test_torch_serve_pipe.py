"""The serving tier's pipe under a large message (``serve/rpc.py`` ``SafeConn``,
``serve/supervisor.py``'s death path), on the CPU.

- A result of tens of MB crossing a ``SafeConn`` to a reader that drains a
  few MB/s leaves no gap between the heartbeats beside it longer than the
  supervisor's budget (6 misses of 0.05 s): the message goes in chunks and a
  beat waits for one chunk, never for the whole message.
- A worker declared dead while its 128 MB result is crossing the pipe is
  respawned; the respawn's HELLO and a later request are answered, a second
  kill is noticed and respawned, and no receive thread fails to unpickle (the
  dead incarnation's thread never reads the respawn's pipe).

Tolerance: exact (bytes and integers).
"""

import fcntl
import multiprocessing
import os
import signal
import struct
import termios
import threading
import time
from multiprocessing.reduction import ForkingPickler

import numpy as np

from spark_rapids_jni_tpu_torch.serve import Backpressure, Degraded, HandlerSpec, Supervisor
from spark_rapids_jni_tpu_torch.serve.rpc import SafeConn

BEAT_S = 0.05
BUDGET_S = 6 * BEAT_S  # serve_heartbeat_misses x serve_heartbeat_s
BIG = 16 << 20  # bytes of the throttled message
RATE = 8 << 20  # bytes/s the throttled reader drains
RESULT = 128 << 20  # bytes of the result cut off mid-pipe


class _Throttled:
    """A pipe end whose reader drains at most RATE bytes a second: each read
    of a frame (or of a whole pickled message) is followed by its share of
    sleep."""

    def __init__(self, conn):
        self._conn = conn

    def recv_bytes(self):
        data = self._conn.recv_bytes()
        time.sleep(len(data) / RATE)
        return data

    def recv(self):
        return ForkingPickler.loads(self.recv_bytes())

    def fileno(self):
        return self._conn.fileno()

    def close(self):
        self._conn.close()


def test_heartbeats_cross_a_large_message_within_the_budget():
    a, b = multiprocessing.Pipe(duplex=True)
    sender, reader = SafeConn(a, send_timeout_s=30.0), SafeConn(_Throttled(b), send_timeout_s=30.0)
    big = np.random.default_rng(12).integers(0, 256, BIG, dtype=np.uint8)
    stop = threading.Event()

    def beat():
        i = 0
        while not stop.is_set():
            sender.send(("beat", 0, 0, i, {}))
            i += 1
            time.sleep(BEAT_S)

    beats = threading.Thread(target=beat, daemon=True)
    result = threading.Thread(target=lambda: sender.send(("result", 7, "ok", big, None)),
                              daemon=True)
    seen, got = [], None
    try:
        beats.start()
        while len(seen) < 3:
            assert reader.recv()[0] == "beat"
            seen.append(time.monotonic())
        result.start()
        while got is None:
            msg = reader.recv()
            if msg[0] == "beat":
                seen.append(time.monotonic())
            else:
                got = msg
        for _ in range(3):  # beats after the result keep flowing
            assert reader.recv()[0] == "beat"
            seen.append(time.monotonic())
    finally:
        stop.set()
        beats.join(timeout=10)
        result.join(timeout=30)
        a.close()
        b.close()
    assert got[:3] == ("result", 7, "ok") and got[4] is None
    np.testing.assert_array_equal(got[3], big)
    gaps = np.diff(seen)
    assert len(seen) > 3 + BIG / RATE / BEAT_S / 4, f"{len(seen)} beats over the message"
    assert gaps.max() < BUDGET_S, f"longest gap between beats {gaps.max():.3f} s"


def _wait(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


def _alive(sup, incarnation):
    w = sup.snapshot()["workers"].get(0) or sup.snapshot()["workers"].get("0")
    return w is not None and w["state"] == "alive" and w["incarnation"] == incarnation


def _submit(sup, sess, handler, payload, timeout=60.0):
    """Submit, waiting out the ladder while a respawn brings it back up."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return sup.submit(sess, handler, payload)
        except (Backpressure, Degraded) as e:
            if time.monotonic() > deadline:
                raise
            time.sleep(min(0.2, getattr(e, "retry_after_s", 0.05)))


def _pending(conn) -> int:
    """Bytes waiting in a SafeConn's socket to be read."""
    buf = fcntl.ioctl(conn._conn.fileno(), termios.FIONREAD, b"\0\0\0\0")
    return struct.unpack("i", buf)[0]


def test_worker_declared_dead_mid_message_respawns_and_is_watched_again(tmp_path, monkeypatch):
    died = []
    monkeypatch.setattr(threading, "excepthook", lambda args: died.append(
        (args.thread.name if args.thread else "?", repr(args.exc_value))))
    sup = Supervisor(workers=1, factory="torch_cluster_worker:register_toy",
                     factory_kwargs={"device": "cpu"},
                     worker_cfg={"device": "cpu", "workers": 2, "queue_size": 8},
                     queue_size=8, default_deadline_s=120.0, lease_hang_s=120.0)
    for name in ("big", "echo_pid"):
        sup.register(HandlerSpec(name))
    sup.register(HandlerSpec("sum", nbytes_of=lambda p: 64 * len(p)))
    marker = tmp_path / "big_started"
    try:
        _wait(lambda: _alive(sup, 0), 120, "the first incarnation's HELLO")
        sess = sup.open_session("pipe")
        resp = sup.submit(sess, "big", (RESULT, str(marker)))
        _wait(marker.exists, 60, "the big handler")
        with sup._lock:
            h0 = sup._handles[0]
        # the result is crossing the pipe: declare the worker dead under it
        _wait(lambda: _pending(h0.conn) > 0, 60, "the result's first bytes")
        sup._worker_dead(h0, "test_mid_message")
        _wait(lambda: _alive(sup, 1), 120, "the respawn's HELLO")
        out = resp.result(timeout=120)  # re-dispatched to the respawn
        assert out.shape == (RESULT,) and out.dtype == np.uint8 and int(out.min()) == 7
        assert int(out.max()) == 7
        del out
        pid1 = _submit(sup, sess, "echo_pid", None).result(timeout=60)
        assert pid1 != h0.pid and pid1 != os.getpid()
        os.kill(pid1, signal.SIGKILL)
        _wait(lambda: sup.metrics.get("workers_dead") == 2, 60, "the second death")
        _wait(lambda: _alive(sup, 2), 120, "the second respawn's HELLO")
        assert _submit(sup, sess, "sum", [1, 2, 3]).result(timeout=60) == 6
        assert sup.metrics.get("workers_spawned") == 3
        assert sup.metrics.get("workers_dead") == 2
    finally:
        sup.shutdown(drain=False, timeout=10)
    assert not died, f"receive threads failed: {died}"
    assert not h0.recv_thread.is_alive()
