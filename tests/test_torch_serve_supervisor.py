"""The crash-only serving tier of the PyTorch port (``serve/supervisor.py``,
``serve/rpc.py``) on the CPU, mirroring ``test_serve_supervisor.py`` and
held against the JAX package.

- requests route through real executor worker processes (their engines on
  the CPU through ``worker_cfg["device"]``) and come back right; a
  SIGKILLed executor's lease re-dispatches exactly once; a hung one is
  recycled; fan-out joins across executors; ``hash32`` answers equal the
  JAX package's murmur3 bits;
- the lease table, the exactly-once result rule and the degradation ladder
  behave as the JAX package's do, and the ladder's ledger under one injected
  stress series is the JAX package's, entry for entry;
- the pipe protocol (``MESSAGE_FIELDS``, the ``MSG_*`` tags) is the JAX
  package's; a worker told to use a card where there is none raises before
  HELLO.

Tolerance: exact (every answer is an integer).  The process tests share one
module-scoped 2-executor cluster; the pool self-heals after the kill tests,
so each test first waits for live capacity.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

import spark_rapids_jni_tpu.serve.rpc as jrpc
import spark_rapids_jni_tpu.serve.supervisor as jsup
from spark_rapids_jni_tpu.columnar import Column as JColumn
from spark_rapids_jni_tpu.columnar import INT64 as JINT64
from spark_rapids_jni_tpu.ops import murmur_hash32 as jax_murmur_hash32

from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.serve import (
    DEGRADE_LEVELS,
    Degraded,
    HandlerSpec,
    RemoteExecutorError,
    SessionBudgetExceeded,
    Supervisor,
)
from spark_rapids_jni_tpu_torch.serve import rpc
from spark_rapids_jni_tpu_torch.serve.queue import OK, Request
from spark_rapids_jni_tpu_torch.serve.supervisor import (
    LEVEL_CACHED_ONLY,
    LEVEL_HEALTHY,
    LEVEL_REJECT,
    LEVEL_SHED_LOW,
    _ExecutorHandle,
    _Lease,
)


def _specs(sup):
    sup.register(HandlerSpec("sum", nbytes_of=lambda p: 64 * len(p),
                             split=lambda p: [p[:len(p) // 2], p[len(p) // 2:]],
                             combine=sum))
    for name in ("echo_pid", "sleep_n", "hang_once", "boom", "hash32"):
        sup.register(HandlerSpec(name))
    sup.register(HandlerSpec(
        "sum_fan", nbytes_of=lambda p: 64 * len(p),
        split=lambda p: [p[:len(p) // 2], p[len(p) // 2:]],
        combine=sum, fanout=2))


@pytest.fixture(scope="module")
def cluster():
    sup = Supervisor(workers=2, factory="torch_cluster_worker:register_toy",
                     factory_kwargs={"device": "cpu"},
                     worker_cfg={"device": "cpu", "workers": 2, "queue_size": 32},
                     queue_size=32, default_deadline_s=30.0, lease_hang_s=2.0)
    _specs(sup)
    yield sup
    sup.shutdown(drain=False, timeout=10)


def _wait_alive(sup, n=1, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = sup.snapshot()["workers"]
        if sum(1 for w in snap.values() if w["state"] == "alive") >= n:
            return snap
        time.sleep(0.05)
    raise AssertionError(f"cluster never reached {n} alive workers")


# ------------------------------------------------------- the pipe protocol


def test_message_fields_and_tags_equal_the_jax_package():
    assert rpc.MESSAGE_FIELDS == jrpc.MESSAGE_FIELDS
    tags = [n for n in jrpc.__all__ if n.startswith("MSG_")]
    assert tags == [n for n in rpc.__all__ if n.startswith("MSG_")]
    assert {n: getattr(rpc, n) for n in tags} == {n: getattr(jrpc, n) for n in tags}
    assert rpc.STATUS_BUSY == jrpc.STATUS_BUSY
    assert jsup.DEGRADE_LEVELS == DEGRADE_LEVELS


def test_resolve_factory_accepts_specs_and_callables():
    import torch_cluster_worker

    assert rpc.resolve_factory("torch_cluster_worker:register_toy") is (
        torch_cluster_worker.register_toy)
    assert rpc.resolve_factory(len) is len
    with pytest.raises(ValueError, match="module:function"):
        rpc.resolve_factory("torch_cluster_worker")


def test_worker_asked_for_a_missing_card_raises_before_hello(monkeypatch):
    """The worker's device defaults to the card; with no card it raises and
    sends nothing (no HELLO), never carrying on on the CPU."""
    import multiprocessing

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a, b = multiprocessing.Pipe(duplex=True)
    try:
        for cfg in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                rpc.executor_worker_main(0, 0, b, "torch_cluster_worker:register_toy",
                                         worker_cfg=cfg)
            assert not a.poll(0.1)
    finally:
        a.close()
        b.close()


def test_worker_pipe_buffers_are_widened():
    """Both ends of each worker pipe ask for PIPE_BUFFER_BYTES of socket
    buffer (shuffle shards cross it whole); the kernel may grant less, never
    less than its default."""
    import multiprocessing
    import socket

    from spark_rapids_jni_tpu_torch.serve.supervisor import _widen_pipe

    a, b = multiprocessing.get_context("spawn").Pipe(duplex=True)
    try:
        for conn in (a, b):
            s = socket.socket(fileno=os.dup(conn.fileno()))
            try:
                before = [s.getsockopt(socket.SOL_SOCKET, o)
                          for o in (socket.SO_SNDBUF, socket.SO_RCVBUF)]
                _widen_pipe(conn)
                after = [s.getsockopt(socket.SOL_SOCKET, o)
                         for o in (socket.SO_SNDBUF, socket.SO_RCVBUF)]
            finally:
                s.close()
            assert all(x >= y for x, y in zip(after, before))
        payload = np.arange(1 << 14, dtype=np.int64)  # fits the buffers: no reader thread
        a.send(payload)
        np.testing.assert_array_equal(b.recv(), payload)
    finally:
        a.close()
        b.close()


# ------------------------------------------------------- process tests


def test_cross_process_dispatch_and_result(cluster):
    _wait_alive(cluster, 2)
    s = cluster.open_session(priority=1)
    assert cluster.submit(s, "sum", list(range(100))).result(timeout=60) == 4950
    pid = cluster.submit(s, "echo_pid", None).result(timeout=60)
    assert pid != os.getpid()
    assert pid in {w["pid"] for w in cluster.snapshot()["workers"].values()}
    cluster.close_session(s)


def test_hash32_through_the_supervisor_equals_the_jax_package(cluster):
    """Seeded int64 payloads, log-uniform lengths, from 8 client threads:
    every answer is the JAX package's murmur3 (seed 42) bit for bit."""
    _wait_alive(cluster, 2)
    rng = np.random.default_rng(83)
    sizes = np.exp(rng.uniform(0.0, np.log(4096), 24)).astype(np.int64) + 1
    payloads = [rng.integers(-(1 << 63), (1 << 63) - 1, int(k), dtype=np.int64,
                             endpoint=True) for k in sizes]
    s = cluster.open_session(priority=1)
    got = [None] * len(payloads)

    def client(k):
        for i in range(k, len(payloads), 8):
            got[i] = cluster.submit(s, "hash32", payloads[i]).result(timeout=60)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    # murmur3 is row-wise: one JAX call over the concatenation (one compile)
    flat = np.concatenate(payloads)
    want = np.asarray(jax_murmur_hash32([JColumn(flat, None, JINT64)], seed=42).data)
    np.testing.assert_array_equal(np.concatenate(got), want)
    assert [len(g) for g in got] == [len(p) for p in payloads]
    cluster.close_session(s)


def test_remote_handler_error_propagates_with_type_name(cluster):
    _wait_alive(cluster, 1)
    s = cluster.open_session(priority=1)
    r = cluster.submit(s, "boom", "payload7")
    with pytest.raises(RemoteExecutorError, match="ValueError.*payload7"):
        r.result(timeout=60)
    cluster.close_session(s)


def test_killed_executor_lease_redispatches_exactly_once(cluster):
    """SIGKILL the executor holding a lease mid-request: the lease re-queues
    to the survivor and the client's response completes, once."""
    _wait_alive(cluster, 2)
    s = cluster.open_session(priority=1)
    before = cluster.metrics.get("leases_redispatched")
    r = cluster.submit(s, "sleep_n", 1.0)
    victim = None
    deadline = time.monotonic() + 10
    while victim is None and time.monotonic() < deadline:
        snap = cluster.snapshot()["workers"]
        victim = next((w for w in snap.values() if w["inflight"] > 0), None)
        time.sleep(0.02)
    assert victim is not None, "lease never granted"
    os.kill(victim["pid"], signal.SIGKILL)
    assert r.result(timeout=60) == 1.0
    assert cluster.metrics.get("leases_redispatched") >= before + 1
    # the rid token ends at a colon: "rid:1" must not match "rid:101"
    kinds = [e["kind"] for e in _flight.snapshot()
             if f"rid:{r.task_id}:" in e.get("detail", "") + ":"]
    assert "lease_redispatch" in kinds
    assert kinds.count("lease_done") == 1
    _wait_alive(cluster, 2, timeout=90)
    cluster.close_session(s)


def test_hung_executor_is_recycled_and_lease_redispatched(cluster, tmp_path):
    _wait_alive(cluster, 2)
    s = cluster.open_session(priority=1)
    before_dead = cluster.metrics.get("workers_dead")
    marker = str(tmp_path / "hang_marker")
    t0 = time.monotonic()
    assert cluster.submit(s, "hang_once", marker).result(timeout=60) == "recovered"
    assert time.monotonic() - t0 >= 1.5
    assert cluster.metrics.get("workers_dead") >= before_dead + 1
    assert os.path.exists(marker)
    _wait_alive(cluster, 2, timeout=90)
    cluster.close_session(s)


def test_fanout_split_joins_across_executors(cluster):
    _wait_alive(cluster, 2)
    s = cluster.open_session(priority=1)
    before = cluster.metrics.get("split_requeued")
    assert cluster.submit(s, "sum_fan", list(range(200))).result(timeout=60) == sum(range(200))
    assert cluster.metrics.get("split_requeued") >= before + 2
    cluster.close_session(s)


def test_session_budget_enforced_at_supervisor(cluster):
    _wait_alive(cluster, 1)
    s = cluster.open_session(priority=1, byte_budget=64 * 10)
    with pytest.raises(SessionBudgetExceeded):
        cluster.submit(s, "sum", list(range(100)))
    assert cluster.metrics.get("rejected_session", s.session_id) == 1
    cluster.close_session(s)


# ------------------------------------------------ supervision unit tests


@pytest.fixture
def sup_unit():
    sup = Supervisor(workers=2, factory=None, start=False)
    _specs(sup)
    yield sup
    sup.shutdown(drain=False, timeout=5)


def _mk_lease(sup, rid=101, handler="sum"):
    req = Request(handler=handler, payload=[1, 2], session_id="u",
                  priority=0, deadline=None, seq=0, task_id=rid)
    with sup._lock:
        lease = sup._leases[rid] = _Lease(rid, req)
    return lease, req


def test_duplicate_result_from_recycled_worker_is_dropped(sup_unit):
    sup = sup_unit
    old = _ExecutorHandle(0, 0, proc=None, conn=None)
    new = _ExecutorHandle(0, 1, proc=None, conn=None)
    lease, req = _mk_lease(sup)
    lease.state = "leased"
    lease.worker_id, lease.incarnation = 0, 1
    sup._on_result(old, lease.rid, OK, 99, None)
    assert req.response.status == "pending"
    assert sup.metrics.get("duplicate_results") == 1
    sup._on_result(new, lease.rid, OK, 3, None)
    assert req.response.status == OK and req.response.value == 3
    assert lease.completed
    sup._on_result(new, lease.rid, OK, 3, None)
    assert sup.metrics.get("duplicate_results") == 2
    assert sup.metrics.get("leases_completed") == 1


def test_worker_dead_is_idempotent_per_incarnation(sup_unit):
    sup = sup_unit

    class _FakeProc:
        pid = 0

        def kill(self):
            pass

    class _FakeConn:
        def close(self):
            pass

    h = _ExecutorHandle(0, 0, proc=_FakeProc(), conn=_FakeConn())
    lease, _req = _mk_lease(sup)
    lease.state = "leased"
    lease.worker_id, lease.incarnation = 0, 0
    h.inflight.add(lease.rid)
    sup._worker_dead(h, "heartbeat_lost")
    sup._worker_dead(h, "proc_exit")
    assert sup.metrics.get("leases_redispatched") == 1
    assert sup.metrics.get("workers_dead") == 1
    assert lease.redispatches == 1
    assert sup.queue.depth() == 1


def _tick_until(sup, stress, level, max_ticks=64):
    for _ in range(max_ticks):
        sup._ladder_tick(stress)
        if sup.level() == level:
            return
    raise AssertionError(f"never reached level {level} (at {sup.level()})")


def test_ladder_steps_down_and_recovers_with_ledger_and_events(sup_unit):
    sup = sup_unit
    _, mark = _flight.snapshot_since(0)
    _tick_until(sup, 1.0, LEVEL_REJECT)
    assert [e["to"] for e in sup.ledger] == ["shed_low", "cached_only", "reject"]
    _tick_until(sup, 0.0, LEVEL_HEALTHY)
    assert [e["to"] for e in sup.ledger] == ["shed_low", "cached_only", "reject",
                                             "cached_only", "shed_low", "healthy"]
    evs = [e for e in _flight.snapshot_since(mark)[0]
           if e["kind"] in ("degrade_enter", "degrade_exit")]
    assert [e["kind"] for e in evs] == ["degrade_enter"] * 3 + ["degrade_exit"] * 3
    assert [e["value"] for e in evs] == [1, 2, 3, 2, 1, 0]
    snap = sup.snapshot()["ladder"]
    assert snap["max_level_seen"] == LEVEL_REJECT
    assert snap["level_name"] == "healthy"


def test_ladder_ledger_equals_the_jax_package_under_one_stress_series():
    """The same seeded stress series through both packages' ladders (start
    =False, injected samples): the same transitions at the same ticks with
    the same EWMA, entry for entry (the monotonic stamps aside)."""
    rng = np.random.default_rng(29)
    series = np.concatenate([rng.uniform(0.0, 1.0, 40), np.ones(12),
                             rng.uniform(0.3, 0.7, 30), np.zeros(16)])
    ledgers = []
    for cls in (Supervisor, jsup.Supervisor):
        sup = cls(workers=2, factory=None, start=False, degrade_dwell_ticks=2)
        try:
            for x in series:
                sup._ladder_tick(float(x))
            ledgers.append([{k: v for k, v in e.items() if k != "t_ns"} for e in sup.ledger])
        finally:
            sup.shutdown(drain=False, timeout=5)
    assert len(ledgers[0]) >= 6
    assert ledgers[0] == ledgers[1]


def test_ladder_hysteresis_holds_between_bands(sup_unit):
    sup = sup_unit
    _tick_until(sup, 0.4, LEVEL_SHED_LOW)
    n = len(sup.ledger)
    for _ in range(32):
        sup._ladder_tick(0.4)
    assert sup.level() == LEVEL_SHED_LOW
    assert len(sup.ledger) == n


def test_gate_shed_low_rejects_only_low_priority(sup_unit):
    sup = sup_unit
    with sup._lock:
        sup._level = LEVEL_SHED_LOW
    lo = sup.open_session("lo", priority=0)
    hi = sup.open_session("hi", priority=1)
    with pytest.raises(Degraded) as ei:
        sup.submit(lo, "sum", [1])
    assert ei.value.level == LEVEL_SHED_LOW and ei.value.retry_after_s > 0
    assert sup.submit(hi, "sum", [1]) is not None
    assert lo.degrade_rejects == 1 and hi.degrade_rejects == 0
    assert sup.metrics.get("rejected_degraded", "lo") == 1


def test_gate_cached_only_admits_warm_and_cacheable(sup_unit):
    sup = sup_unit
    sup.register(HandlerSpec("warmed"))
    sup.register(HandlerSpec("plan_q", cacheable=True))
    with sup._lock:
        sup._level = LEVEL_CACHED_ONLY
        sup._warm.add("warmed")
    s = sup.open_session("t", priority=5)
    sup.submit(s, "warmed", [1])
    sup.submit(s, "plan_q", [1])
    with pytest.raises(Degraded):
        sup.submit(s, "sum", [1])


def test_gate_reject_rejects_everything_with_retry_after(sup_unit):
    sup = sup_unit
    with sup._lock:
        sup._level = LEVEL_REJECT
        sup._warm.add("sum")
    s = sup.open_session("t", priority=99)
    with pytest.raises(Degraded) as ei:
        sup.submit(s, "sum", [1])
    assert ei.value.level == LEVEL_REJECT and ei.value.retry_after_s > 0
    assert DEGRADE_LEVELS[LEVEL_REJECT] in str(ei.value)


def test_respawning_incarnation_counts_as_missing_capacity(sup_unit):
    sup = sup_unit
    h0 = _ExecutorHandle(0, 0, proc=None, conn=None)
    h1 = _ExecutorHandle(1, 0, proc=None, conn=None)
    h1.health = "alive"
    with sup._lock:
        sup._handles[0] = h0
        sup._handles[1] = h1
    assert sup._sample_stress()[0] == 0.0
    h0.incarnation = 2
    stress, src = sup._sample_stress()
    assert stress == pytest.approx(0.5) and src == "capacity"
    h0.health = "alive"
    assert sup._sample_stress()[0] == 0.0


class _RecConn:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)
        return True

    def close(self):
        pass


def test_redispatched_fanout_request_regrants_itself_not_fanout(sup_unit):
    sup = sup_unit
    a = _ExecutorHandle(0, 0, proc=None, conn=_RecConn())
    b = _ExecutorHandle(1, 0, proc=None, conn=_RecConn())
    a.health = b.health = "alive"
    with sup._lock:
        sup._handles[0] = a
        sup._handles[1] = b
    fresh = Request(handler="sum_fan", payload=list(range(8)), session_id="u",
                    priority=0, deadline=None, seq=1, task_id=201)
    sup._route(fresh)
    assert sup.queue.depth() == 2
    assert 201 not in sup._leases
    redisp = Request(handler="sum_fan", payload=list(range(8)), session_id="u",
                     priority=0, deadline=None, seq=2, task_id=202)
    with sup._lock:
        lease = sup._leases[202] = _Lease(202, redisp)
        lease.redispatches = 1
    depth_before = sup.queue.depth()
    sup._route(redisp)
    assert sup.queue.depth() == depth_before
    assert lease.state == "leased"
    sent = a.conn.sent + b.conn.sent
    assert any(m[0] == "dispatch" and m[1] == 202 for m in sent)


def test_completed_leases_retire_from_the_table(sup_unit):
    sup = sup_unit
    h = _ExecutorHandle(0, 0, proc=None, conn=None)
    lease, req = _mk_lease(sup, rid=301)
    with sup._lock:
        sup._leases_total += 1
    lease.state = "leased"
    lease.worker_id, lease.incarnation = 0, 0
    sup._on_result(h, 301, OK, 3, None)
    assert req.response.value == 3
    assert 301 not in sup._leases
    st = sup.lease_stats()
    assert st["completed"] == 1 and st["outstanding"] == 0
    sup._on_result(h, 301, OK, 3, None)
    assert sup.metrics.get("duplicate_results") == 1


def test_repeatedly_hung_lease_fails_instead_of_destroying_the_pool(sup_unit):
    sup = sup_unit
    lease, req = _mk_lease(sup, rid=401)
    lease.state = "leased"
    lease.worker_id, lease.incarnation = 0, 0
    lease.dispatches = sup.lease_max_dispatches
    lease.granted_ns = time.monotonic_ns() - int(60e9)
    sup._health_sweep()
    assert req.response.status == "error"
    assert "hung on" in str(req.response.error)
    assert 401 not in sup._leases
