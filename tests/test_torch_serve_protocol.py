"""The serving protocol's host modules, driven by one script in both packages.

Sessions (``serve/session.py``), the admission queue (``serve/queue.py``),
the metrics (``serve/metrics.py``) and the adaptive admission controller
(``serve/controller.py``) are copies of the JAX package's.  Each test runs
the same script against both packages, under a fake monotonic clock where
time matters, and asserts equal states, orders and percentiles.
"""

import types

import pytest

from spark_rapids_jni_tpu import mem as jax_mem
from spark_rapids_jni_tpu import serve as jax_serve
from spark_rapids_jni_tpu.serve import controller as jax_controller
from spark_rapids_jni_tpu.serve import queue as jax_queue
from spark_rapids_jni_tpu_torch import mem, serve
from spark_rapids_jni_tpu_torch.serve import controller, queue

PKGS = {"jax": (jax_serve, jax_queue, jax_controller, jax_mem),
        "port": (serve, queue, controller, mem)}


class FakeClock:
    """A monotonic clock that moves only when the script says so."""

    def __init__(self):
        self.ns = 10 ** 12

    def monotonic(self):
        return self.ns / 1e9

    def monotonic_ns(self):
        return self.ns

    def advance(self, seconds):
        self.ns += int(seconds * 1e9)


@pytest.fixture
def clock(monkeypatch):
    c = FakeClock()
    fake = types.SimpleNamespace(monotonic=c.monotonic, monotonic_ns=c.monotonic_ns,
                                 sleep=lambda s: c.advance(s))
    for mod in (queue, jax_queue, controller, jax_controller):
        monkeypatch.setattr(mod, "time", fake)
    return c


def _both(script):
    out = {pkg: script(*mods) for pkg, mods in PKGS.items()}
    assert out["port"] == out["jax"]
    return out["port"]


def test_sessions_equal_jax():
    def script(s, q, c, m):
        reg = s.SessionRegistry()
        log = []
        a = reg.open("a", priority=2, byte_budget=1000)
        b = reg.open(priority=1)
        log.append((a.session_id, b.session_id, [reg.next_task_id() for _ in range(3)]))
        for sess, n in ((a, 400), (a, 500), (a, 200), (b, 10 ** 9), (a, 2000)):
            try:
                sess.charge(n)
                log.append(("ok", sess.session_id, n))
            except s.SessionBudgetExceeded as e:
                log.append(("rejected", sess.session_id, n, str(e)))
        a.credit(400)
        a.set_budget_scale(0.5)
        log.append((a.effective_budget(), a.snapshot(), b.snapshot()))
        try:
            reg.open("a")
        except ValueError as e:
            log.append(("duplicate", str(e)))
        reg.close(a)
        try:
            a.charge(1)
        except RuntimeError as e:
            log.append(("closed", str(e)))
        log.append(sorted(x.session_id for x in reg.all_open()))
        log.append(reg.snapshot())
        return log

    log = _both(script)
    assert ("rejected", "a", 200) == log[3][:3]


def test_queue_equal_jax(clock):
    def script(s, q, c, m):
        log = []
        timed_out = []
        aq = q.AdmissionQueue(4, retry_after_hint=lambda depth: 0.01 * depth,
                              on_timeout=lambda r: timed_out.append(r.seq))
        now = clock.monotonic()

        def req(seq, priority=0, deadline=None, handler="h", no_batch=False):
            return q.Request(handler=handler, payload=seq, session_id=f"s{seq % 2}",
                             priority=priority, deadline=deadline, seq=seq, task_id=100 + seq,
                             no_batch=no_batch)

        for r in (req(0), req(1, 2), req(2, 0, now + 1.0), req(3, 2, handler="g")):
            aq.submit(r)
        try:
            aq.submit(req(4))
        except s.Backpressure as e:
            log.append(("backpressure", e.retry_after_s))
        aq.submit(req(5, 1, no_batch=True), force=True)
        log.append(("depth", aq.depth(), aq.outstanding()))
        clock.advance(2.0)
        popped = aq.pop(timeout=0)
        log.append(("pop", popped.seq))
        mates = aq.pop_compatible(lambda r: r.handler == "h" and not r.no_batch, 3)
        log.append(("mates", [r.seq for r in mates], timed_out))
        log.append(("waits", aq.session_waits()))
        aq.task_done(1 + len(mates))
        log.append(("maxsize", aq.set_maxsize(2), aq.depth()))
        rest = aq.close()
        log.append(("closed", sorted(r.seq for r in rest),
                    [r.response.status for r in rest]))
        log.append(("pop_after_close", aq.pop(timeout=0)))
        return log

    log = _both(script)
    assert log[2] == ("pop", 1)


def test_metrics_percentiles_equal_jax(clock):
    def script(s, q, c, m):
        met = s.ServeMetrics()
        for i in range(200):
            met.count("submitted", f"s{i % 3}")
            met.record_wait((i * 7919) % 5_000_000 + 1_000)
            met.record_run((i * 104729) % 90_000_000 + 50_000,
                           handler=("q97", "hash32")[i % 2])
            if i % 17 == 0:
                met.count("retried", f"s{i % 3}", n=2)
                met.count_batch_miss("cap")
        met.set_depth(7)
        snap = met.snapshot()
        # the process's governor-side gauges and flight task stats, not the script's
        snap.pop("gauges")
        snap.pop("tasks")
        hist = s.LatencyHistogram()
        for v in (1, 10, 100, 1_000, 10_000, 123_456_789, 5, 5, 5):
            hist.record(v)
        return (snap, met.batch_miss(), met.handler_latency_counts(),
                met.run_latency_counts(), hist.snapshot(),
                [hist.percentile_ns(p) for p in (0.0, 50.0, 90.0, 99.0, 100.0)])

    snap, *_, pcts = _both(script)
    assert snap["counters"]["submitted"] == 200 and snap["counters"]["retried"] == 24
    assert snap["handlers"]["q97"]["count"] == 100 and snap["run_latency"]["p99_ms"] > 0
    assert pcts == sorted(pcts) and pcts[-1] > pcts[0]


def test_controller_equal_jax(clock):
    def script(s, q, c, m):
        g = m.MemoryGovernor(watchdog_period_s=0.02)
        kw = {"device": "cpu"} if s is serve else {}
        eng = s.ServingEngine(gov=g, budget=m.BudgetedResource(g, 1 << 20), workers=1,
                              queue_size=16, default_deadline_s=60.0, adaptive=False, **kw)
        try:
            sess = eng.open_session("t", byte_budget=1000)
            ctl = c.AdmissionController(eng, dwell_ticks=1)
            trace = []

            def sig(p, **kw):
                base = {"mem_frac": p, "blocked_frac": 0.0, "counters": {},
                        "class_splits": {}, "session_waits": {}}
                base.update(kw)
                return base

            script_ = ([sig(1.0)] * 12 + [sig(0.0)] * 12
                       + [sig(0.5, class_splits={"q97": k}) for k in (1, 2, 3, 3, 3)]
                       + [sig(0.2, session_waits={"t": 5.0})] * 4
                       + [sig(0.95, counters={"retried": 3})] * 3 + [sig(0.0)] * 20)
            for signals in script_:
                ctl.tick(signals)
                clock.advance(0.05)
                trace.append((eng.queue.maxsize, sess.budget_scale, sess.age_boost,
                              eng.presplit_map()))
            snap = ctl.snapshot()
            ledger = [{k: v for k, v in d.items() if k != "t_ns"} for d in ctl.ledger]
            snap["ledger_tail"] = [{k: v for k, v in d.items() if k != "t_ns"}
                                   for d in snap["ledger_tail"]]
            ctl.stop()
            return trace, ledger, snap
        finally:
            eng.shutdown()
            g.close()

    trace, ledger, _ = _both(script)
    assert ledger and min(t[0] for t in trace) == 4 and trace[-1][0] == 16
