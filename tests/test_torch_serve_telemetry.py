"""The port's live telemetry plane, SLO burn-rate engine and speculative
hedging (``serve/telemetry.py``, ``serve/slo.py``, the supervisor's hedge
sweep) on the CPU, mirroring ``test_telemetry.py`` and
``test_serve_hedging.py`` and held against the JAX package.

- the exporter ships rolling flight-ring deltas once, paces, skips (never
  blocks) on a stalled pipe and trims giant backlogs; the cluster timeline
  aligns, dedupes and groups, and its merged view over one set of deltas is
  the JAX package's; the endpoint serves one JSON view per connection;
- the SLO engine's burn needs both windows and recovers in pairs, and over
  one synthetic metric series its ledger and snapshot are the JAX
  package's; burn drives the degradation ladder;
- hedges: first result wins, the loser drops as a duplicate, a BUSY or dead
  hedge target retires only the attempt, shuffle participants are never
  hedged, the budget and sample floor bind;
- across processes: a port cluster's live endpoint reconstructs one
  request's waterfall, also after a SIGKILL re-dispatch, and carries the
  executors' metrics.

Tolerance: exact.  One module-scoped 2-executor cluster serves the process
tests.
"""

import dataclasses
import os
import signal
import time

import numpy as np
import pytest

import spark_rapids_jni_tpu.serve.slo as jslo
import spark_rapids_jni_tpu.serve.telemetry as jtelemetry

from spark_rapids_jni_tpu_torch.obs import flight, trace
from spark_rapids_jni_tpu_torch.serve import (
    SLO,
    BurnRateEngine,
    ClusterTimeline,
    HandlerSpec,
    Supervisor,
    TelemetryExporter,
    TelemetryServer,
    fetch_view,
)
from spark_rapids_jni_tpu_torch.serve import rpc
from spark_rapids_jni_tpu_torch.serve.controller import AdmissionController
from spark_rapids_jni_tpu_torch.serve.queue import OK, Request
from spark_rapids_jni_tpu_torch.serve.slo import parse_slo_config
from spark_rapids_jni_tpu_torch.serve.supervisor import _ExecutorHandle, _Lease


@pytest.fixture(autouse=True)
def _fresh_ring():
    flight.recorder().reset_for_tests()
    yield
    flight.recorder().reset_for_tests()


def _sends(dst):
    def send(msg):
        dst.append(msg)
        return True
    return send


# ---------------------------------------------------------------- exporter


def test_exporter_ships_rolling_deltas_exactly_once():
    ex = TelemetryExporter(0, 0, min_period_s=0.0)
    sent = []
    flight.record(flight.EV_TASK_ADMITTED, 1)
    assert ex.export(_sends(sent))
    flight.record(flight.EV_TASK_DONE, 1)
    assert ex.export(_sends(sent))
    assert [e["kind"] for e in sent[0][5]] == ["admitted"]
    k1 = [e["kind"] for e in sent[1][5]]
    assert "task_done" in k1 and "admitted" not in k1
    tag, wid, inc, wall_t, t_ns = sent[0][:5]
    assert tag == rpc.MSG_TELEMETRY and (wid, inc) == (0, 0)
    assert wall_t > 0 and t_ns > 0


def test_exporter_paces_but_force_flushes():
    ex = TelemetryExporter(0, 0, min_period_s=60.0)
    sent = []
    flight.record(flight.EV_TASK_ADMITTED, 1)
    assert ex.export(_sends(sent))
    flight.record(flight.EV_TASK_DONE, 1)
    assert ex.export(_sends(sent))
    assert len(sent) == 1 and ex.stats["paced"] == 1
    assert ex.export(_sends(sent), force=True)
    assert len(sent) == 2
    assert "task_done" in [e["kind"] for e in sent[1][5]]


def test_exporter_skips_never_blocks_on_stalled_pipe():
    ex = TelemetryExporter(3, 1, min_period_s=0.0)
    flight.record(flight.EV_TASK_ADMITTED, 7)
    t0 = time.monotonic()
    assert ex.export(lambda msg: False) is False
    assert time.monotonic() - t0 < 0.5
    assert ex.stats["skipped"] == 1
    assert any(e["kind"] == "telemetry_drop" and "send_failed" in e["detail"]
               for e in flight.snapshot())
    calls = []

    def counting_fail(msg):
        calls.append(msg)
        return False

    assert ex.export(counting_fail, force=True) is True
    assert calls == []
    sent = []
    assert ex.export(_sends(sent))
    assert "admitted" in [e["kind"] for e in sent[0][5]]
    sent2 = []
    flight.record(flight.EV_TASK_DONE, 7)
    assert ex.export(_sends(sent2), force=True)
    assert any(e["kind"] == "task_done" for e in sent2[0][5])


def test_exporter_trims_giant_backlog_loudly():
    ex = TelemetryExporter(0, 0, min_period_s=0.0, max_events=4)
    for i in range(10):
        flight.record(flight.EV_TASK_ADMITTED, i)
    sent = []
    assert ex.export(_sends(sent))
    events = sent[0][5]
    assert len(events) == 4 and ex.stats["trimmed"] == 6
    assert [e["task_id"] for e in events] == [6, 7, 8, 9]
    assert any(e["kind"] == "telemetry_drop" and "trimmed" in e["detail"]
               for e in flight.snapshot())


# ---------------------------------------------------------------- timeline


def _deltas():
    """Two processes' exports, one re-shipped (a held cursor after a stall),
    with rid:/sid: tokens: a deterministic set for both packages."""
    rng = np.random.default_rng(17)
    kinds = ["lease_grant", "span_open", "span_close", "shuffle_fetch", "lease_done"]
    out = []
    for pid, base in ((111, 1_000_000_000), (222, 5_000_000_000)):
        evs = [{"seq": i + 1, "t_ns": base + 1_000_000 * i, "kind": kinds[i % 5],
                "task_id": int(rng.integers(0, 9)), "tid": 1,
                "detail": f"rid:{int(rng.integers(1, 6))}:sid:{int(rng.integers(1, 3))}:part:0",
                "value": int(rng.integers(0, 100))} for i in range(30)]
        out.append((pid, 1000.0 + pid, base + 40_000_000, evs[:20], {"c": pid}))
        out.append((pid, 1001.0 + pid, base + 41_000_000, evs[10:], {"c": pid + 1}))
    return out


def test_timeline_merged_view_equals_the_jax_package():
    views = []
    for cls in (ClusterTimeline, jtelemetry.ClusterTimeline):
        tl = cls(max_events=48)
        for pid, wall_t, t_ns, evs, metrics in _deltas():
            tl.ingest(pid, wall_t, t_ns, [dict(e) for e in evs], incarnation=0,
                      worker_id=pid % 7, metrics=metrics)
        views.append((tl.merged(), tl.worker_metrics(), tl.stats()))
    assert len(views[0][0]["events"]) == 48
    assert views[0] == views[1]


def test_timeline_aligns_dedupes_and_groups():
    tl = ClusterTimeline(max_events=100)
    evs = [{"seq": 1, "t_ns": 1_000_000_000, "kind": "lease_grant", "task_id": 5,
            "tid": 1, "detail": "rid:5:worker:0", "value": 0},
           {"seq": 2, "t_ns": 2_000_000_000, "kind": "shuffle_fetch", "task_id": -1,
            "tid": 1, "detail": "rid:5:sid:9:part:0", "value": 10}]
    assert tl.ingest(111, wall_t=1000.0, t_ns=2_000_000_000, events=evs,
                     incarnation=0, worker_id=0, metrics={"x": 1}) == 2
    assert tl.ingest(111, 1001.0, 3_000_000_000, evs) == 0
    merged = tl.merged()
    assert merged["pids"] == [111]
    assert merged["events"][0]["wall_s"] == pytest.approx(999.0)
    assert merged["events"][1]["wall_s"] == pytest.approx(1000.0)
    assert set(merged["rids"]) == {"5"} and set(merged["sids"]) == {"9"}
    assert tl.worker_metrics()["111"]["metrics"] == {"x": 1}


def test_endpoint_serves_one_json_view_per_connection():
    view = {"schema": "srt-live-timeline-v1", "hello": [1, 2, 3]}
    srv = TelemetryServer(lambda: dict(view), port=0).start()
    try:
        assert fetch_view(*srv.endpoint) == view
        assert jtelemetry.fetch_view(*srv.endpoint) == view  # the JAX client reads it
        assert srv.served == 2
    finally:
        srv.close()


def test_endpoint_survives_failing_view_source():
    def boom():
        raise RuntimeError("gauges gone")

    srv = TelemetryServer(boom, port=0).start()
    try:
        assert "error" in fetch_view(*srv.endpoint)
        assert fetch_view(*srv.endpoint)["error"]
    finally:
        srv.close()


# --------------------------------------------------------------- SLO engine


def test_parse_slo_config_schema():
    text = ('[{"name": "svc", "handler": "*", "p99_ms": 50},'
            ' {"name": "t", "tenant": "acme", "error_frac": 0.01, "shed_frac": 0.05}]')
    slos = parse_slo_config(text)
    assert [s.name for s in slos] == ["svc", "t"]
    assert ([dataclasses.asdict(s) for s in slos]
            == [dataclasses.asdict(s) for s in jslo.parse_slo_config(text)])
    assert parse_slo_config("") == []
    with pytest.raises(ValueError):
        parse_slo_config('[{"name": "x"}]')
    with pytest.raises(ValueError):
        SLO(name="x", tenant="a", p99_ms=5.0)
    with pytest.raises(ValueError):
        SLO(name="x", handler="*")


def _latency_engine(engine_cls=BurnRateEngine, slo_cls=SLO, series=None):
    state = {"counts": [0] * 64}

    def src():
        return {"run_latency_counts": list(state["counts"]),
                "handler_latency_counts": {}, "counters": {}, "sessions": {}}

    clock = [0.0]
    eng = engine_cls([slo_cls(name="svc", handler="*", p99_ms=1.0)], src,
                     fast_window_s=2.0, slow_window_s=4.0, min_samples=4,
                     clock=lambda: clock[0])
    return eng, state, clock


def test_burn_rate_engine_equals_the_jax_package_over_one_series():
    """One seeded latency series (fast and violating buckets mixed, with a
    burst) through both packages' engines: the same ledger, the same
    snapshot, the same pressure at every tick."""
    rng = np.random.default_rng(41)
    fast = rng.integers(0, 60, 40)
    slow = np.where((np.arange(40) >= 10) & (np.arange(40) <= 22),
                    rng.integers(20, 80, 40), rng.integers(0, 3, 40))
    runs = []
    for ecls, scls in ((BurnRateEngine, SLO), (jslo.BurnRateEngine, jslo.SLO)):
        eng, state, clock = _latency_engine(ecls, scls)
        pressures = []
        for t in range(40):
            clock[0] = float(t)
            state["counts"][5] += int(fast[t])
            state["counts"][24] += int(slow[t])
            eng.tick()
            pressures.append((eng.pressure(), tuple(eng.burning())))
        snap = eng.snapshot()
        ledger, snap["ledger_tail"] = ([{k: v for k, v in e.items() if k != "t_ns"}
                                        for e in rows]
                                       for rows in (eng.ledger, snap["ledger_tail"]))
        runs.append((ledger, snap, pressures))
    assert [e["state"] for e in runs[0][0]] and runs[0][0][0]["state"] == "burn"
    assert runs[0] == runs[1]


def test_burn_requires_both_windows_and_recovery_pairs():
    eng, state, clock = _latency_engine()
    burned_at = None
    for t in range(16):
        clock[0] = float(t)
        state["counts"][24 if 4 <= t <= 8 else 5] += 50
        eng.tick()
        if t < 4:
            assert eng.burning() == []
        if burned_at is None and eng.burning():
            burned_at = t
    assert burned_at is not None and burned_at >= 4
    kinds = [e["kind"] for e in flight.snapshot()]
    assert kinds.count("slo_burn") == 1 and kinds.count("slo_ok") == 1
    assert eng.burning() == [] and eng.pressure() == 0.0
    assert [entry["state"] for entry in eng.ledger] == ["burn", "ok"]


def test_tenant_error_and_shed_objectives_read_session_counters():
    sessions = {"acme": {"completed": 0, "failed": 0, "submitted": 0,
                         "rejected_degraded": 0}}

    def src():
        return {"run_latency_counts": [], "handler_latency_counts": {},
                "counters": {}, "sessions": {"acme": dict(sessions["acme"])}}

    clock = [0.0]
    eng = BurnRateEngine([SLO(name="t", tenant="acme", error_frac=0.01, shed_frac=0.1)],
                         src, fast_window_s=2.0, slow_window_s=4.0, min_samples=4,
                         clock=lambda: clock[0])
    for t in range(10):
        clock[0] = float(t)
        sessions["acme"]["completed"] += 8
        if 4 <= t <= 7:
            sessions["acme"]["failed"] += 2
        sessions["acme"]["submitted"] += 10
        eng.tick()
    assert "t:error" in [e["slo"] + ":" + e["objective"] for e in eng.ledger]
    assert {o["objective"] for o in eng.snapshot()["objectives"]} == {"error", "shed"}


def test_slo_burn_drives_the_degradation_ladder():
    sup = Supervisor(workers=1, start=False, degrade_dwell_ticks=1)
    try:
        eng, state, clock = _latency_engine()
        sup.slo = eng
        for t in range(10):
            clock[0] = float(t)
            state["counts"][24] += 50
            eng.tick()
            sup._ladder_tick()
        assert sup.level() >= 1
        with sup._lock:
            entries = list(sup.ledger)
        assert entries and entries[0]["source"] == "slo"
        assert any(e["kind"] == "degrade_enter" for e in flight.snapshot())

        class _Eng:
            max_split_depth = 4
            static_queue_size = 8

        ctl = AdmissionController(_Eng())
        ctl.note_cluster_pressure({"slo_frac": sup.slo.pressure()})
        assert ctl._cluster_pressure() == pytest.approx(1.0)
    finally:
        sup.shutdown(drain=False, timeout=5)


# ------------------------------------------------------------- hedging


@pytest.fixture
def sup_unit():
    sup = Supervisor(workers=2, factory=None, start=False)
    sup.register(HandlerSpec("sum"))
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


def _mk_lease(sup, rid=101, *, shuffle_sid=None):
    req = Request(handler="sum", payload=[1, 2], session_id="u", priority=0,
                  deadline=None, seq=0, task_id=rid, shuffle_sid=shuffle_sid)
    with sup._lock:
        lease = sup._leases[rid] = _Lease(rid, req)
        sup._leases_total += 1
    return lease, req


def _alive(sup, wid, inc=0, conn=None):
    h = _ExecutorHandle(wid, inc, proc=None, conn=conn or _RecConn())
    h.health = "alive"
    with sup._lock:
        sup._handles[wid] = h
    return h


def _hedged(sup, lease, primary, target):
    with sup._lock:
        lease.state = "leased"
        lease.worker_id, lease.incarnation = primary.worker_id, primary.incarnation
        primary.inflight.add(lease.rid)
        lease.hedge_state = "launched"
        lease.hedge_worker_id, lease.hedge_incarnation = target.worker_id, target.incarnation
        target.inflight.add(lease.rid)
        sup._hedges_launched += 1


@pytest.mark.parametrize("winner", ["hedge", "primary"])
def test_first_result_wins_and_the_late_copy_drops(sup_unit, winner):
    sup = sup_unit
    primary, target = _alive(sup, 0), _alive(sup, 1)
    lease, req = _mk_lease(sup)
    _hedged(sup, lease, primary, target)
    first, late = (target, primary) if winner == "hedge" else (primary, target)
    sup._on_result(first, lease.rid, OK, 7, None)
    assert req.response.status == OK and req.response.value == 7
    assert lease.completed and lease.hedge_state == "none"
    assert sup.metrics.get("hedge_wins") == (1 if winner == "hedge" else 0)
    assert sup.metrics.get("hedge_losses") == (0 if winner == "hedge" else 1)
    sup._on_result(late, lease.rid, OK, 7, None)
    assert sup.metrics.get("duplicate_results") == 1
    assert sup.metrics.get("leases_completed") == 1
    assert lease.rid not in late.inflight


def test_hedge_busy_abandons_attempt_primary_runs_on(sup_unit):
    sup = sup_unit
    primary, target = _alive(sup, 0), _alive(sup, 1)
    lease, req = _mk_lease(sup, rid=103)
    _hedged(sup, lease, primary, target)
    sup._on_result(target, lease.rid, rpc.STATUS_BUSY, None, None)
    assert lease.state == "leased" and not lease.completed
    assert lease.worker_id == primary.worker_id and lease.hedge_state == "none"
    assert sup.queue.depth() == 0 and sup.metrics.get("hedge_losses") == 1
    sup._on_result(primary, lease.rid, OK, 3, None)
    assert req.response.status == OK and sup.metrics.get("leases_completed") == 1


def test_dead_hedge_target_clears_state_without_requeue(sup_unit):
    sup = sup_unit
    primary, target = _alive(sup, 0), _alive(sup, 1)
    lease, _req = _mk_lease(sup, rid=104)
    _hedged(sup, lease, primary, target)
    sup._stop.set()  # the dead path must not spawn a real replacement
    sup._worker_dead(target, "heartbeat_lost")
    assert lease.hedge_state == "none"
    assert lease.state == "leased" and not lease.completed
    assert sup.queue.depth() == 0
    assert sup.metrics.get("hedge_losses") == 1
    assert sup.metrics.get("leases_redispatched") == 0


def test_primary_death_requeues_while_hedge_stays_armed(sup_unit):
    sup = sup_unit
    primary, target = _alive(sup, 0), _alive(sup, 1)
    lease, req = _mk_lease(sup, rid=105)
    _hedged(sup, lease, primary, target)
    sup._stop.set()
    sup._worker_dead(primary, "proc_exit")
    assert lease.state == "queued" and lease.hedge_state == "launched"
    assert sup.queue.depth() == 1
    sup._on_result(target, lease.rid, OK, 11, None)
    assert req.response.status == OK and req.response.value == 11
    assert sup.metrics.get("hedge_wins") == 1 and sup.metrics.get("leases_completed") == 1


def _straggler(sup, rid, *, shuffle_sid=None):
    lease, _ = _mk_lease(sup, rid=rid, shuffle_sid=shuffle_sid)
    with sup._lock:
        lease.state = "leased"
        lease.worker_id, lease.incarnation = 0, 0
        lease.granted_ns = 1  # leased an eternity ago
        sup._handles[0].inflight.add(rid)
    return lease


def test_hedge_sweep_launches_on_straggler_and_dispatches(sup_unit):
    sup = sup_unit
    sup.hedge_budget_frac, sup.hedge_min_samples = 1.0, 4
    conn1 = _RecConn()
    _alive(sup, 0)
    target = _alive(sup, 1, conn=conn1)
    lease = _straggler(sup, 106)
    sup._windowed_p99_ns = lambda now: {"sum": (100, 1_000)}
    sup._hedge_sweep(time.monotonic(), time.monotonic_ns())
    assert lease.hedge_state == "launched" and lease.hedge_worker_id == 1
    assert lease.rid in target.inflight and lease.dispatches == 1
    assert conn1.sent and conn1.sent[0][:2] == (rpc.MSG_DISPATCH, lease.rid)
    assert sup.lease_stats()["hedged"] == 1
    sup._hedge_sweep(time.monotonic(), time.monotonic_ns())
    assert sup.metrics.get("hedges_launched") == 1


@pytest.mark.parametrize("case", ["few_samples", "no_budget", "shuffle", "no_target"])
def test_hedge_sweep_holds_back(sup_unit, case):
    """No hedge below the sample floor, with no budget, for a shuffle
    participant, or without a second alive executor."""
    sup = sup_unit
    _alive(sup, 0)
    if case != "no_target":
        _alive(sup, 1)
    sup.hedge_budget_frac = 0.0 if case == "no_budget" else 1.0
    lease = _straggler(sup, 107, shuffle_sid=7 if case == "shuffle" else None)
    n = sup.hedge_min_samples - 1 if case == "few_samples" else 100
    sup._windowed_p99_ns = lambda now: {"sum": (n, 1_000)}
    sup._hedge_sweep(time.monotonic(), time.monotonic_ns())
    assert lease.hedge_state == "none"
    assert sup.metrics.get("hedges_launched") == 0


# ------------------------------------------------- cross-process acceptance


@pytest.fixture(scope="module")
def cluster():
    sup = Supervisor(workers=2, factory="torch_cluster_worker:register_toy",
                     factory_kwargs={"device": "cpu"},
                     worker_cfg={"device": "cpu", "workers": 2, "queue_size": 32},
                     queue_size=32, default_deadline_s=30.0, lease_hang_s=5.0)
    sup.register(HandlerSpec("sum", nbytes_of=lambda p: 64 * len(p)))
    sup.register(HandlerSpec("sleep_n"))
    yield sup
    sup.shutdown(drain=False, timeout=10)


def _wait_alive(sup, n, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        snap = sup.snapshot()["workers"]
        if sum(1 for w in snap.values() if w["state"] == "alive") >= n:
            return
        time.sleep(0.05)
    raise AssertionError(f"never reached {n} alive workers")


def _live_waterfall(sup, rid, *, timeout=10.0):
    deadline = time.monotonic() + timeout
    rec = None
    while time.monotonic() < deadline:
        view = fetch_view(*sup.telemetry_endpoint())
        rec = trace.waterfall(view["timeline"]["events"]).get(str(rid))
        if rec is not None and rec["complete"]:
            return rec
        time.sleep(0.1)
    return rec


def test_live_endpoint_reconstructs_cross_process_waterfall(cluster):
    _wait_alive(cluster, 2)
    s = cluster.open_session(priority=1)
    resp = cluster.submit(s, "sum", list(range(50)))
    assert resp.result(timeout=60) == 1225
    rec = _live_waterfall(cluster, resp.task_id)
    assert rec is not None and rec["complete"]
    assert len(rec["pids"]) >= 2
    assert {"queue", "dispatch", "compute"} <= {x["kind"] for x in rec["spans"]}
    cluster.close_session(s)


def test_span_context_survives_sigkill_redispatch(cluster):
    _wait_alive(cluster, 2)
    s = cluster.open_session(priority=1)
    resp = cluster.submit(s, "sleep_n", 1.0)
    victim = None
    deadline = time.monotonic() + 10
    while victim is None and time.monotonic() < deadline:
        snap = cluster.snapshot()["workers"]
        victim = next((w for w in snap.values() if w["inflight"] > 0), None)
        time.sleep(0.02)
    assert victim is not None, "lease never granted"
    os.kill(victim["pid"], signal.SIGKILL)
    assert resp.result(timeout=60) == 1.0
    rec = _live_waterfall(cluster, resp.task_id, timeout=15.0)
    assert rec is not None and rec["complete"]
    dspans = [x for x in rec["spans"] if x["kind"] == "dispatch"]
    assert len(dspans) >= 2 and dspans[-1]["closed"]
    assert len(rec["pids"]) >= 2
    _wait_alive(cluster, 2, timeout=90)
    cluster.close_session(s)


def test_worker_telemetry_metrics_reach_the_view(cluster):
    """The view the JAX package's servetop reads: fetched with the JAX
    client, it carries the executors' counters and the sessions."""
    _wait_alive(cluster, 2)
    s = cluster.open_session(priority=1)
    assert cluster.submit(s, "sum", [1, 2, 3]).result(timeout=60) == 6
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        view = jtelemetry.fetch_view(*cluster.telemetry_endpoint())
        wt = view["workers_telemetry"]
        if any((w["metrics"].get("counters") or {}).get("completed", 0) for w in wt.values()):
            break
        time.sleep(0.1)
    assert view["schema"] == jtelemetry.TIMELINE_SCHEMA
    assert any(w["metrics"]["counters"]["completed"] >= 1 for w in wt.values())
    assert view["supervisor"]["telemetry"]["events"] > 0
    assert view["sessions"]
    cluster.close_session(s)
