"""The port's peer-to-peer shuffle data plane (``serve/shuffle.py``) on the
CPU, mirroring ``test_serve_shuffle.py`` and held against the JAX package.

- the map side's partitions (``emit_exchange_partitions``) frame into the
  JAX package's bytes, and a port ``ShuffleService`` and a JAX one fetch and
  CRC-verify each other's partitions over loopback, both ways;
- ``plan_adaptive_groups``, ``run_exchange_plan_local`` and the range
  oracle equal the JAX package's;
- the transport detects corrupt and truncated frames and re-fetches, stalled
  peers trip the I/O timeout into backoff, and the supervisor's partition
  map tracks producers, acks, revivals and cleanup;
- a 2-executor port cluster's q97 hash shuffle and q67 / top-k range
  shuffles equal the JAX package's single-process oracles, also with a
  producer SIGKILLed mid-exchange.

Tolerance: exact (every answer is an integer).  One module-scoped
2-executor cluster serves every process test.
"""

import os
import signal
import threading
import time

import numpy as np
import pytest

import spark_rapids_jni_tpu.serve.shuffle as jshuffle
from spark_rapids_jni_tpu.columnar import frames as jframes
from spark_rapids_jni_tpu.models.q67 import q67_plan as jax_q67_plan
from spark_rapids_jni_tpu.models.q67 import topk_sales_plan as jax_topk_plan
from spark_rapids_jni_tpu.models.q97 import q97_plan as jax_q97_plan
from spark_rapids_jni_tpu.plans.compiler import (
    emit_exchange_partitions as jax_emit_exchange_partitions,
)
from spark_rapids_jni_tpu.plans.compiler import split_exchange_plan as jax_split_exchange_plan

from spark_rapids_jni_tpu_torch.columnar import frames
from spark_rapids_jni_tpu_torch.models.q67 import make_q67_tables, q67_plan, topk_sales_plan
from spark_rapids_jni_tpu_torch.models.q97 import q97_plan
from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.obs.faultinj import FaultInjector
from spark_rapids_jni_tpu_torch.parallel.shuffle import partition_of
from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.compiler import (
    EXCHANGE_SOURCE,
    emit_exchange_partitions,
    split_exchange_plan,
)
from spark_rapids_jni_tpu_torch.plans.runtime import execute_plan
from spark_rapids_jni_tpu_torch.serve import ShuffleSpec, Supervisor
from spark_rapids_jni_tpu_torch.serve.queue import ERROR, OK
from spark_rapids_jni_tpu_torch.serve.rpc import SafeConn
from spark_rapids_jni_tpu_torch.serve.shuffle import (
    ShuffleFetchStalled,
    ShuffleService,
    combine_exchange_outputs,
    combine_ordered_outputs,
    make_range_split,
    plan_adaptive_groups,
    run_exchange_plan_local,
    run_range_plan_local,
    scan_table_names,
    split_tables_n,
)
from spark_rapids_jni_tpu_torch.serve.supervisor import _ExecutorHandle


def _q97_tables(seed, n):
    rng = np.random.RandomState(seed)
    return {"store": {"cust": rng.randint(1, 60, n).astype(np.int32),
                      "item": rng.randint(1, 25, n).astype(np.int32)},
            "catalog": {"cust": rng.randint(1, 60, n).astype(np.int32),
                        "item": rng.randint(1, 25, n).astype(np.int32)}}


def _out3(out):
    return (int(out["store_only"]), int(out["catalog_only"]), int(out["both"]))


def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


# ------------------------------------------ the map side against the JAX package


def test_split_exchange_plan_shape():
    exchange, reduce_plan = split_exchange_plan(q97_plan(64))
    assert isinstance(exchange, ir.Exchange)
    assert not ir.has_exchange(reduce_plan)
    scans = ir.scan_tables(reduce_plan)
    assert [s.table for s in scans] == [EXCHANGE_SOURCE]
    assert scans[0].fields == exchange.fields


def test_map_partitions_conserve_rows_and_follow_placement_hash():
    import torch

    tables = _q97_tables(3, 200)
    exchange, _ = split_exchange_plan(q97_plan(64))
    for nparts in (1, 2, 3, 5):
        parts = emit_exchange_partitions(exchange, tables, nparts, device="cpu")
        assert len(parts) == nparts
        assert sum(len(p["key"]) for p in parts) == 400
        for pi, part in enumerate(parts):
            owner = partition_of(torch.from_numpy(part["key"]), nparts).numpy()
            assert (owner == pi).all()


@pytest.mark.parametrize("nparts", [1, 3, 4])
def test_map_shard_frames_are_byte_identical_to_the_jax_package(nparts):
    """One q97 map shard through both packages' emitters, framed as the
    producer frames it: the same bytes on the wire."""
    tables = split_tables_n(_q97_tables(5, 3000), {"store", "catalog"}, 4)[1]
    exchange, _ = split_exchange_plan(q97_plan(64))
    jexchange, _ = jax_split_exchange_plan(jax_q97_plan(64))
    ours = emit_exchange_partitions(exchange, tables, nparts, device="cpu")
    theirs = jax_emit_exchange_partitions(jexchange, tables, nparts)
    for p, (a, b) in enumerate(zip(ours, theirs)):
        names = sorted(a)
        ea = frames.encode_table((frames.FR_DATA, 7, 1, p, names, len(a["key"])), a)
        eb = jframes.encode_table((jframes.FR_DATA, 7, 1, p, sorted(b),
                                   len(np.asarray(b["key"]))),
                                  {k: np.asarray(v) for k, v in b.items()})
        assert ea == eb


@pytest.mark.parametrize("n", [64, 300, 1000])
def test_local_exchange_oracle_equals_the_jax_package(n):
    tables = _q97_tables(n, n)
    _same(run_exchange_plan_local(q97_plan(64), tables, device="cpu"),
          jshuffle.run_exchange_plan_local(jax_q97_plan(64), tables))


@pytest.mark.parametrize("which", ["q67", "topk"])
def test_range_oracle_equals_the_jax_package(which):
    tables = make_q67_tables(3000, 40, 5, seed=7)
    plan, jplan = ((q67_plan(3, 40), jax_q67_plan(3, 40)) if which == "q67"
                   else (topk_sales_plan(5), jax_topk_plan(5)))
    _same(run_range_plan_local(plan, tables, device="cpu"),
          jshuffle.run_range_plan_local(jplan, tables))


@pytest.mark.parametrize("totals,n,target", [
    ([10, 20, 30, 40], 4, 1 << 20),
    ([500, 500, 500, 500, 500, 500, 500, 500], 4, 1000),
    ([3000, 1, 1, 1, 1, 1, 1, 4000], 2, 1000),
    ([0] * 12, 3, 1),
    (list(np.random.default_rng(3).integers(0, 5000, 64)), 8, 9000),
])
def test_plan_adaptive_groups_equals_the_jax_package(totals, n, target):
    got = plan_adaptive_groups(totals, n, target)
    assert got == jshuffle.plan_adaptive_groups(totals, n, target)
    assert len(got) == n and sorted(p for g in got for p in g) == list(range(len(totals)))


def test_combine_sums_partials_like_psum():
    tables = _q97_tables(11, 500)
    plan = q97_plan(64)
    exchange, reduce_plan = split_exchange_plan(plan)
    shards = split_tables_n(tables, scan_table_names(plan), 3)
    parts = [emit_exchange_partitions(exchange, s, 3, device="cpu") for s in shards]
    outs = []
    for p in range(3):
        concat = {f: np.concatenate([parts[m][p][f] for m in range(3)])
                  for f in exchange.fields}
        outs.append({k: np.asarray(v) for k, v in execute_plan(
            None, reduce_plan, {EXCHANGE_SOURCE: concat}, device="cpu").items()})
    _same(combine_exchange_outputs(plan)(outs),
          jshuffle.run_exchange_plan_local(jax_q97_plan(64), tables))


# ----------------------------------------------------- transport service


@pytest.fixture
def services():
    made = []

    def make(cls=ShuffleService, **kw):
        svc = cls(**kw).start()
        made.append(svc)
        return svc

    yield make
    for svc in made:
        svc.close()


def _produced_map(svc, sid, nparts, sizes=None):
    return ("shuffle_map", sid, nparts,
            {0: {"state": "produced", "ep": svc.endpoint,
                 "incarnation": 0, "sizes": dict(sizes or {})}})


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_services_interoperate_with_the_jax_package(services, direction):
    """Partitions produced by one package's service are fetched over the
    socket, CRC-verified and decoded by the other's."""
    prod_cls, cons_cls = ((jshuffle.ShuffleService, ShuffleService)
                          if direction == "jax_to_port"
                          else (ShuffleService, jshuffle.ShuffleService))
    prod, cons = services(prod_cls), services(cons_cls)
    exchange, _ = split_exchange_plan(q97_plan(64))
    parts = emit_exchange_partitions(exchange, _q97_tables(9, 700), 3, device="cpu")
    sizes = prod.produce(21, 0, parts)
    cons.on_message(_produced_map(prod, 21, 3, sizes))
    for p, want in enumerate(parts):
        got = cons.fetch(21, 0, p, deadline=time.monotonic() + 10)
        _same(got, want)
    assert cons.snapshot()["counters"]["fetched"] == 3
    assert cons.snapshot()["counters"].get("fetch_retries", 0) == 0


def test_socket_fetch_round_trip_and_gauges(services):
    prod, cons = services(), services()
    t = {"key": np.arange(64, dtype=np.int64), "tag": (np.arange(64) % 2).astype(np.int8)}
    sizes = prod.produce(5, 0, [t, t])
    assert set(sizes) == {0, 1} and all(v > 0 for v in sizes.values())
    cons.on_message(_produced_map(prod, 5, 2, sizes))
    cols = cons.fetch(5, 0, 1, deadline=time.monotonic() + 10)
    assert np.array_equal(cols["key"], t["key"]) and cols["tag"].dtype == np.int8
    snap = cons.snapshot()
    assert snap["counters"]["fetched"] == 1 and snap["counters"]["bytes_fetched"] > 0
    deadline = time.monotonic() + 5
    while (prod.snapshot()["counters"].get("frames_sent") != 1
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert prod.snapshot()["counters"]["frames_sent"] == 1
    assert prod.snapshot()["store_partitions"] == 2
    assert cons.advertised_size(5, 0, 1) == sizes[1]


def test_local_store_fast_path(services):
    svc = services()
    t = {"key": np.arange(8, dtype=np.int64)}
    svc.produce(6, 2, [t])
    _, mark = _flight.snapshot_since(0)
    cols = svc.fetch(6, 2, 0, deadline=time.monotonic() + 5)
    assert np.array_equal(cols["key"], t["key"])
    evs = [e for e in _flight.snapshot_since(mark)[0] if e["kind"] == "shuffle_fetch"]
    assert evs and ":src:local" in evs[-1]["detail"]


def test_fetch_waits_for_late_producer(services):
    prod, cons = services(), services()
    t = {"key": np.arange(16, dtype=np.int64)}

    def later():
        time.sleep(0.3)
        sizes = prod.produce(7, 0, [t])
        cons.on_message(_produced_map(prod, 7, 1, sizes))

    threading.Thread(target=later, daemon=True).start()
    cols = cons.fetch(7, 0, 0, deadline=time.monotonic() + 10)
    assert np.array_equal(cols["key"], t["key"])
    assert cons.snapshot()["counters"]["fetch_retries"] >= 1


def test_fetch_stalls_out_with_seeded_backoff(services):
    cons = services()
    cons.on_message(("shuffle_map", 8, 1, {0: {"state": "pending", "ep": None,
                                               "incarnation": 0, "sizes": {}}}))
    _, mark = _flight.snapshot_since(0)
    t0 = time.monotonic()
    with pytest.raises(ShuffleFetchStalled):
        cons.fetch(8, 0, 0, deadline=time.monotonic() + 0.5)
    assert time.monotonic() - t0 >= 0.4
    reasons = [e["detail"].rsplit("reason:", 1)[-1]
               for e in _flight.snapshot_since(mark)[0] if e["kind"] == "shuffle_retry"]
    assert reasons and set(reasons) == {"pending"}


@pytest.mark.parametrize("fault,rule,counter", [
    ("frame_corrupt", "frame:*", "retry_crc"),
    ("frame_truncate", "trunc:*", "retry_truncated"),
])
def test_damaged_frames_detected_and_refetched(services, fault, rule, counter):
    prod, cons = services(), services()
    t = {"key": np.arange(256, dtype=np.int64)}
    sizes = prod.produce(9, 0, [t])
    cons.on_message(_produced_map(prod, 9, 1, sizes))
    FaultInjector.install({"seed": 4, "shuffle": {rule: {
        "percent": 100.0, "injectionType": fault, "interceptionCount": 2}}})
    try:
        cols = cons.fetch(9, 0, 0, deadline=time.monotonic() + 30)
    finally:
        FaultInjector.uninstall()
    assert np.array_equal(cols["key"], t["key"])
    c = cons.snapshot()["counters"]
    assert c["fetched"] == 1
    if fault == "frame_corrupt":
        assert c[counter] == 2 and prod.snapshot()["counters"]["faults_corrupt"] == 2
    else:
        assert c.get(counter, 0) + c.get("retry_eof", 0) >= 1


def test_stalled_peer_trips_io_timeout_into_backoff(services):
    prod = services(io_timeout_s=0.3)
    cons = services(io_timeout_s=0.3)
    t = {"key": np.arange(32, dtype=np.int64)}
    sizes = prod.produce(11, 0, [t])
    cons.on_message(_produced_map(prod, 11, 1, sizes))
    FaultInjector.install({"seed": 4, "shuffle": {"stall:*": {
        "percent": 100.0, "injectionType": "peer_stall", "durationMs": 800.0,
        "interceptionCount": 1}}})
    try:
        cols = cons.fetch(11, 0, 0, deadline=time.monotonic() + 30)
    finally:
        FaultInjector.uninstall()
    assert np.array_equal(cols["key"], t["key"])
    assert cons.snapshot()["counters"].get("retry_stall", 0) >= 1


def test_spool_fast_path_same_host(services, tmp_path):
    spool = str(tmp_path / "spool")
    prod = services(spool_dir=spool)
    cons = services(spool_dir=spool)
    t = {"key": np.arange(64, dtype=np.int64)}
    sizes = prod.produce(12, 0, [t])
    cons.on_message(_produced_map(prod, 12, 1, sizes))
    _, mark = _flight.snapshot_since(0)
    cols = cons.fetch(12, 0, 0, deadline=time.monotonic() + 10)
    assert np.array_equal(cols["key"], t["key"])
    evs = [e for e in _flight.snapshot_since(mark)[0] if e["kind"] == "shuffle_fetch"]
    assert evs and ":src:spool" in evs[-1]["detail"]
    assert os.path.exists(os.path.join(spool, "12_0_0.frame"))
    prod.cleanup(12)
    assert not os.path.exists(os.path.join(spool, "12_0_0.frame"))


def test_cleanup_frees_store_and_nacks_gone(services):
    prod, cons = services(), services()
    t = {"key": np.arange(8, dtype=np.int64)}
    sizes = prod.produce(13, 0, [t])
    cons.on_message(_produced_map(prod, 13, 1, sizes))
    prod.cleanup(13)
    assert prod.snapshot()["store_partitions"] == 0
    with pytest.raises(ShuffleFetchStalled, match="gone"):
        cons.fetch(13, 0, 0, deadline=time.monotonic() + 0.4)


def test_safeconn_send_times_out_as_backpressure():
    import multiprocessing

    a, b = multiprocessing.Pipe()
    conn = SafeConn(a, send_timeout_s=0.3)
    payload = ("beat", b"x" * 64)
    _, mark = _flight.snapshot_since(0)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 20.0:
        if not conn.send(payload):
            break
    else:
        pytest.fail("send never surfaced backpressure on a full pipe")
    hung = [e for e in _flight.snapshot_since(mark)[0]
            if e["kind"] == "task_hung" and "pipe_send_stalled" in e["detail"]]
    assert hung
    b.close()
    a.close()


# --------------------------------------------- supervisor partition map


@pytest.fixture
def sup_unit():
    plan = q97_plan(64)
    scans = scan_table_names(plan)
    sup = Supervisor(workers=2, factory=None, start=False)
    sup.register(ShuffleSpec("q97_shuffle", split_n=lambda p, n: split_tables_n(p, scans, n),
                             combine=combine_exchange_outputs(plan), fanout=2))
    yield sup
    sup.shutdown(drain=False, timeout=5)


class _RecConn:
    def __init__(self):
        self.sent = []

    def send(self, msg):
        self.sent.append(msg)
        return True

    def close(self):
        pass


def _routed_shuffle(sup):
    """Two alive fake executors, one q97 shuffle submitted and both children
    routed; returns (handles, response, state)."""
    handles = []
    for wid in range(2):
        h = _ExecutorHandle(wid, 0, proc=None, conn=_RecConn())
        h.health = "alive"
        with sup._lock:
            sup._handles[wid] = h
        handles.append(h)
    resp = sup.submit(sup.open_session("t", priority=1), "q97_shuffle", _q97_tables(21, 120))
    sup._route(sup.queue.pop(timeout=1))
    assert sup.queue.depth() == 2
    for _ in range(2):
        child = sup.queue.pop(timeout=1)
        assert child.payload["nparts"] == 2 and child.payload["rid"] == child.task_id
        sup._route(child)
        sup.queue.task_done()
    with sup._lock:
        (state,) = sup._shuffles.values()
    return handles, resp, state


def test_shuffle_dispatch_builds_partition_map(sup_unit):
    handles, _resp, state = _routed_shuffle(sup_unit)
    assert state.nparts == 2 and state.handler == "q97_shuffle"
    with sup_unit._lock:
        assert {t["worker"] for t in state.tasks.values()} == {0, 1}
    maps = [m for h in handles for m in h.conn.sent if m[0] == "shuffle_map"]
    assert maps and maps[-1][2] == 2


def test_produced_and_acks_land_in_partition_map(sup_unit):
    sup = sup_unit
    handles, _resp, state = _routed_shuffle(sup)
    with sup._lock:
        h = handles[state.tasks[0]["worker"]]
    sup._on_shuffle_produced(h, state.sid, 0, {0: 100, 1: 120}, ("127.0.0.1", 9999))
    with sup._lock:
        assert state.tasks[0]["state"] == "produced"
        assert state.tasks[0]["sizes"] == {0: 100, 1: 120}
    sup._on_shuffle_ack(h, state.sid, 0, 1)
    snap = sup.snapshot()["shuffles"][str(state.sid)]
    assert snap["produced"] == 1 and snap["acks"] == 1
    stale = _ExecutorHandle(h.worker_id, 99, proc=None, conn=_RecConn())
    sup._on_shuffle_produced(stale, state.sid, 0, {0: 1}, ("x", 1))
    assert sup.metrics.get("shuffle_stale_produces") == 1


def test_dead_producer_with_completed_lease_is_revived(sup_unit):
    sup = sup_unit
    handles, _resp, state = _routed_shuffle(sup)
    with sup._lock:
        m0 = next(m for m, t in state.tasks.items() if t["worker"] == 0)
        old_rid = state.tasks[m0]["rid"]
    sup._on_result(handles[0], old_rid, OK, {"store_only": np.int64(0)}, None)
    handles[0].proc = type("P", (), {"pid": 0, "kill": lambda s: None,
                                     "is_alive": lambda s: False,
                                     "join": lambda s, timeout=None: None})()
    sup._stop.set()  # the dead path must not spawn a real replacement
    sup._worker_dead(handles[0], "proc_exit")
    assert sup.metrics.get("shuffle_revivals") == 1
    revival = sup.queue.pop(timeout=1)
    assert revival.payload.get("reproduce") is True and revival.payload["m"] == m0
    with sup._lock:
        assert state.tasks[m0]["rid"] == revival.task_id
        assert state.tasks[m0]["state"] == "pending"


def test_stalled_fetch_redispatches_not_terminal(sup_unit):
    sup = sup_unit
    _handles, _resp, state = _routed_shuffle(sup)
    rid = state.tasks[0]["rid"]
    with sup._lock:
        lease = sup._leases[rid]
    child = lease.req
    before = sup.queue.depth()
    sup._on_result(sup._handles[lease.worker_id], rid, ERROR, None,
                   ("ShuffleFetchStalled", "partition unavailable"))
    assert child.response.status == "pending"
    assert sup.queue.depth() == before + 1
    sup._route(sup.queue.pop(timeout=1))
    sup.queue.task_done()
    with sup._lock:
        lease = sup._leases[rid]
        lease.dispatches = sup.lease_max_dispatches
    sup._on_result(sup._handles[lease.worker_id], rid, ERROR, None,
                   ("ShuffleFetchStalled", "still unavailable"))
    assert child.response.status == ERROR


def test_parent_completion_retires_map_and_broadcasts_cleanup(sup_unit):
    sup = sup_unit
    handles, resp, state = _routed_shuffle(sup)
    zero = {"store_only": np.int64(0), "catalog_only": np.int64(0), "both": np.int64(0)}
    for _m, task in sorted(state.tasks.items()):
        sup._on_result(handles[task["worker"]], task["rid"], OK, zero, None)
    assert resp.wait(timeout=5)
    with sup._lock:
        assert not sup._shuffles
    cleanups = [m for h in handles for m in h.conn.sent if m[0] == "shuffle_cleanup"]
    assert cleanups and cleanups[0][1] == state.sid
    assert sup.metrics.get("shuffles_completed") == 1


# ------------------------------------------------------- process tests


def _wait_alive(sup, n, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = sup.snapshot()["workers"]
        if sum(1 for w in snap.values() if w["state"] == "alive") >= n:
            return snap
        time.sleep(0.05)
    raise AssertionError(f"cluster never reached {n} alive workers")


@pytest.fixture(scope="module")
def shuffle_cluster():
    plan = q97_plan(64)
    scans = scan_table_names(plan)
    sup = Supervisor(workers=2, factory="torch_cluster_worker:register_shuffle_tier",
                     factory_kwargs={"device": "cpu"},
                     worker_cfg={"device": "cpu", "workers": 4, "queue_size": 32},
                     worker_flags={"serve_shuffle_fetch_timeout_s": 20.0},
                     queue_size=32, default_deadline_s=120.0, lease_hang_s=60.0)
    for name in ("q97_shuffle", "q97_shuffle_slow"):
        sup.register(ShuffleSpec(name, split_n=lambda p, n: split_tables_n(p, scans, n),
                                 combine=combine_exchange_outputs(plan), fanout=2))
    for name, p in (("q67_shuffle", q67_plan(3, 40)), ("topk_shuffle", topk_sales_plan(3))):
        sup.register(ShuffleSpec(name, split_n=make_range_split(p, device="cpu"),
                                 combine=combine_ordered_outputs(p), fanout=2))
    yield sup
    sup.shutdown(drain=False, timeout=15)


def test_exchange_plan_spans_processes_equal_to_the_jax_oracle(shuffle_cluster):
    sup = shuffle_cluster
    _wait_alive(sup, 2)
    s = sup.open_session(priority=1)
    for seed, n in ((1, 200), (2, 555), (3, 1024)):
        tables = _q97_tables(seed, n)
        out = sup.submit(s, "q97_shuffle", tables).result(timeout=180)
        _same(out, jshuffle.run_exchange_plan_local(jax_q97_plan(64), tables))
    counters = sup.snapshot()["counters"]
    assert counters["shuffles_started"] >= 3
    assert counters["shuffle_produced"] >= 6 and counters["shuffle_acks"] >= 12
    sup.close_session(s)


@pytest.mark.parametrize("handler", ["q67_shuffle", "topk_shuffle"])
def test_range_shuffle_spans_processes_equal_to_the_jax_oracle(shuffle_cluster, handler):
    """Values AND row order: the ordered concat of the partitions is the
    JAX package's single-process answer."""
    sup = shuffle_cluster
    _wait_alive(sup, 2)
    s = sup.open_session(priority=1)
    tables = make_q67_tables(4000, 40, 5, seed=11)
    jplan = jax_q67_plan(3, 40) if handler == "q67_shuffle" else jax_topk_plan(3)
    out = sup.submit(s, handler, tables).result(timeout=180)
    _same(out, jshuffle.run_range_plan_local(jplan, tables))
    sup.close_session(s)


def test_producer_sigkill_mid_exchange_recovers_equal(shuffle_cluster):
    """A shuffle child's executor SIGKILLed mid-exchange: the lease
    re-dispatches, the map side re-produces, and the answer still equals
    the JAX package's oracle, every lease completed once."""
    sup = shuffle_cluster
    _wait_alive(sup, 2)
    s = sup.open_session(priority=1)
    tables = _q97_tables(9, 400)
    before = sup.metrics.get("leases_redispatched")
    dead_before = sup.metrics.get("workers_dead")
    resp = sup.submit(s, "q97_shuffle_slow", tables)
    victim = None
    deadline = time.monotonic() + 20
    while victim is None and time.monotonic() < deadline:
        snap = sup.snapshot()["workers"]
        victim = next((w for w in snap.values() if w["inflight"] > 0 and w["pid"]), None)
        time.sleep(0.02)
    assert victim is not None, "no map child ever leased"
    os.kill(victim["pid"], signal.SIGKILL)
    out = resp.result(timeout=180)
    _same(out, jshuffle.run_exchange_plan_local(jax_q97_plan(64), tables))
    assert sup.metrics.get("leases_redispatched") >= before + 1
    assert sup.metrics.get("workers_dead") >= dead_before + 1
    _wait_alive(sup, 2, timeout=120)
    assert sup.wait_drained(30)
    st = sup.lease_stats()
    assert st["completed"] == st["leases"] and st["outstanding"] == 0
    sup.close_session(s)
