"""The port's serving engine against the JAX package's, on the CPU.

The same seeded payloads go through the JAX ``ServingEngine`` (a (1, 1) mesh
of the conftest's CPU devices) and the port's (``device="cpu"``, and for q97
a (1, 1) mesh over a one-rank gloo group made in this process): the answers
of the built-in handlers ``q97``, ``q5``, ``q3``, ``hash32`` and
``get_json_object`` are equal, and so are the split counts of a q97 under a
tight budget.  Then the serving protocol on the port: an injected RetryOOM
re-attempts in place, queued requests join one micro-batch, a full queue
raises ``Backpressure``, and governed byte·seconds roll up through the
``mem.governed._attrib`` hook onto each request's attribution record.
"""

import threading

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu import mem as jax_mem
from spark_rapids_jni_tpu import serve as jax_serve
from spark_rapids_jni_tpu.obs import faultinj as jax_faultinj
from spark_rapids_jni_tpu.parallel import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu_torch import mem
from spark_rapids_jni_tpu_torch import serve
from spark_rapids_jni_tpu_torch.mem import governed
from spark_rapids_jni_tpu_torch.models.q97 import (
    Q97Batch,
    default_q97_capacity,
    q97_host_oracle,
    q97_working_set_bytes,
)
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q3_data, generate_q5_data
from spark_rapids_jni_tpu_torch.obs import flight
from spark_rapids_jni_tpu_torch.obs.faultinj import FaultInjector
from spark_rapids_jni_tpu_torch.parallel import one_rank_mesh
from spark_rapids_jni_tpu_torch.serve import attribution

PKGS = {"jax": (jax_mem, jax_serve), "port": (mem, serve)}


@pytest.fixture(scope="module")
def meshes():
    """Both packages' (1, 1) meshes: the port's over a one-rank gloo group."""
    with one_rank_mesh("cpu") as port_mesh:
        yield {"jax": jax_make_mesh((1, 1), devices=jax.devices()[:1]), "port": port_mesh}


class _Engines:
    """One engine per package, each over its own governor; closed at exit."""

    def __init__(self, meshes, budget_bytes=1 << 30, **kw):
        self.govs, self.engines = [], {}
        kw.setdefault("workers", 2)
        kw.setdefault("queue_size", 64)
        kw.setdefault("default_deadline_s", 60.0)
        for pkg, (m, s) in PKGS.items():
            g = m.MemoryGovernor(watchdog_period_s=0.02)
            self.govs.append(g)
            extra = {"mesh": meshes[pkg]} if meshes is not None else {}
            if pkg == "port" and meshes is None:
                extra["device"] = "cpu"
            self.engines[pkg] = s.ServingEngine(
                gov=g, budget=m.BudgetedResource(g, budget_bytes), **extra, **kw)

    def run(self, handler, payloads, **submit):
        """Submit ``payloads`` to both engines; returns pkg -> results."""
        out = {}
        for pkg, eng in self.engines.items():
            sess = eng.open_session()
            resps = [eng.submit(sess, handler, p, **submit) for p in payloads]
            out[pkg] = [r.result(timeout=120) for r in resps]
        return out

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for eng in self.engines.values():
            eng.shutdown()
        for g in self.govs:
            g.close()


def _q97_tables(seed, n_store, n_catalog, cust=40, item=12):
    rng = np.random.RandomState(seed)
    store = (rng.randint(1, cust, n_store).astype(np.int32),
             rng.randint(1, item, n_store).astype(np.int32))
    catalog = (rng.randint(1, cust, n_catalog).astype(np.int32),
               rng.randint(1, item, n_catalog).astype(np.int32))
    return store, catalog


def _hash_payloads(seed, n, rows=None):
    """``n`` int64 payloads of ``rows`` rows each, or of rows log-uniform over
    1-300."""
    rng = np.random.RandomState(seed)
    sizes = [rows] * n if rows else np.exp(rng.uniform(0, np.log(300), n)).astype(int)
    return [rng.randint(-(1 << 62), 1 << 62, size=k, dtype=np.int64) for k in sizes]


def _json_payload():
    rows = ['{"a": {"b": %d}, "c": [%d, %d]}' % (i, i, i + 1) for i in range(20)]
    rows += [None, "junk", '{"a": 1.5}', "{'a': 'x'}"]
    return rows, ["$.a.b", "$.c[1]", "$.a", "$.c[*]"]


def _normal(handler, value):
    if handler == "q97":
        return (int(value.store_only), int(value.catalog_only), int(value.both))
    if handler in ("q5", "q3"):
        return [tuple(r) for r in value]
    if handler == "hash32":
        return value.tolist()
    return value


@pytest.mark.parametrize("handler", ["q97", "q5", "q3", "hash32", "get_json_object"])
def test_builtin_handlers_answer_as_jax(meshes, handler):
    payloads = {
        "q97": lambda: [_q97_tables(3, 300, 220), _q97_tables(6, 150, 400)],
        "q5": lambda: [generate_q5_data(sf=0.02, seed=8)],
        "q3": lambda: [generate_q3_data(sf=0.05, seed=9)],
        "hash32": lambda: _hash_payloads(79, 12),
        "get_json_object": lambda: [_json_payload()],
    }[handler]()
    with _Engines(meshes if handler == "q97" else None, builtin_handlers=True) as e:
        out = e.run(handler, payloads)
        budgets = [eng.budget.used for eng in e.engines.values()]
    got = [_normal(handler, v) for v in out["port"]]
    assert got == [_normal(handler, v) for v in out["jax"]]
    assert budgets == [0, 0]
    if handler == "q97":
        assert got == [q97_host_oracle(*p) for p in payloads]
    if handler in ("q5", "q3"):
        assert got[0], "the filter keeps no row at this size"


def test_tight_budget_splits_and_requeues_as_jax(meshes):
    """Under 0.55x of q97's working set the engine splits the key space and
    re-queues the halves: the same split count in both packages, and the
    oracle's answer."""
    store, catalog = _q97_tables(4, 1200, 1000, cust=300, item=20)
    cap0 = default_q97_capacity(2200, 1)
    full = q97_working_set_bytes(Q97Batch(*store, *catalog, capacity=cap0), 1)
    with _Engines(meshes, budget_bytes=int(full * 0.55), builtin_handlers=True) as e:
        out = e.run("q97", [(store, catalog)])
        splits = {pkg: eng.metrics.get("split_requeued") for pkg, eng in e.engines.items()}
        used = [eng.budget.used for eng in e.engines.values()]
    want = q97_host_oracle(store, catalog)
    assert [_normal("q97", v[0]) for v in out.values()] == [want, want]
    assert splits["port"] == splits["jax"] >= 2
    assert used == [0, 0]


def _record_handler(s, attempts):
    return s.QueryHandler(name="sum", fn=lambda p, ctx: attempts.append(1) or sum(p),
                          nbytes_of=lambda p: 64 * len(p))


def test_injected_retry_oom_reattempts_in_place():
    """An injected RetryOOM at the worker's reservation: the request retries
    in place and completes, with the same counts in both packages."""
    seen = {}
    for pkg, injector in (("jax", jax_faultinj.FaultInjector), ("port", FaultInjector)):
        m, s = PKGS[pkg]
        g = m.MemoryGovernor(watchdog_period_s=0.02)
        eng = s.ServingEngine(gov=g, budget=m.BudgetedResource(g, 1 << 30), workers=1,
                              device="cpu") if pkg == "port" else \
            s.ServingEngine(gov=g, budget=m.BudgetedResource(g, 1 << 30), workers=1)
        attempts = []
        try:
            eng.register(_record_handler(s, attempts))
            injector.install({"alloc": {"reserve:dev:*": {"injectionType": "retry_oom",
                                                          "interceptionCount": 1}}})
            value = eng.submit(eng.open_session(), "sum", [1, 2, 3]).result(timeout=30)
        finally:
            injector.uninstall()
            eng.shutdown()
            g.close()
        seen[pkg] = (value, len(attempts), eng.metrics.get("retried"), eng.budget.used)
    assert seen["port"] == seen["jax"] == (6, 1, 1, 0)


def _gated(s, gate):
    """A handler that holds the only worker until ``gate`` is set."""
    return s.QueryHandler(name="gate", fn=lambda p, ctx: gate.wait(30) and p)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_micro_batches_join(meshes, pkg):
    """hash32 requests queued behind a held worker share launches: batches of
    ``micro_batch_max`` (8), 8 and 4, with the answers of the requests run
    alone."""
    m, s = PKGS[pkg]
    g = m.MemoryGovernor(watchdog_period_s=0.02)
    kw = {"device": "cpu"} if pkg == "port" else {"mesh": meshes["jax"]}
    eng = s.ServingEngine(gov=g, budget=m.BudgetedResource(g, 1 << 30), workers=1,
                          builtin_handlers=True, **kw)
    gate = threading.Event()
    payloads = _hash_payloads(5, 20, rows=32)
    try:
        eng.register(_gated(s, gate))
        sess = eng.open_session()
        held = eng.submit(sess, "gate", 7)
        resps = [eng.submit(sess, "hash32", p) for p in payloads]
        gate.set()
        assert held.result(timeout=30) == 7
        batched = [r.result(timeout=60) for r in resps]
        assert eng.metrics.get("batched") == 20  # 8 + 8 + 4 riders
        alone = [eng.submit(sess, "hash32", p).result(timeout=60) for p in payloads]
    finally:
        gate.set()
        eng.shutdown()
        g.close()
    for a, b in zip(batched, alone):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_full_queue_raises_backpressure(pkg):
    m, s = PKGS[pkg]
    g = m.MemoryGovernor(watchdog_period_s=0.02)
    kw = {"device": "cpu"} if pkg == "port" else {}
    eng = s.ServingEngine(gov=g, budget=m.BudgetedResource(g, 1 << 30), workers=1,
                          queue_size=2, **kw)
    gate = threading.Event()
    try:
        eng.register(_gated(s, gate))
        sess = eng.open_session()
        first = eng.submit(sess, "gate", 0)
        while eng.queue.depth():  # wait for the worker to take the first
            gate.wait(0.001)
        queued = [eng.submit(sess, "gate", i) for i in (1, 2)]
        with pytest.raises(s.Backpressure) as exc:
            eng.submit(sess, "gate", 3)
        assert exc.value.retry_after_s > 0
        gate.set()
        assert [r.result(timeout=30) for r in [first] + queued] == [0, 1, 2]
        assert eng.metrics.get("rejected_full") == 1
    finally:
        gate.set()
        eng.shutdown()
        g.close()


def test_attribution_rolls_up_governed_byte_seconds():
    """Every governed release meters byte·ns through ``mem.governed._attrib``,
    bound to ``serve.attribution.note_reservation``: the process counter and
    each request's EV_ATTRIB record advance."""
    g = mem.MemoryGovernor(watchdog_period_s=0.02)
    eng = serve.ServingEngine(gov=g, budget=mem.BudgetedResource(g, 1 << 30), workers=1,
                              device="cpu")
    attribution.reset_worker_counters_for_tests()
    flight.recorder().reset_for_tests()
    try:
        eng.register(serve.QueryHandler(
            name="sum", fn=lambda p, ctx: (threading.Event().wait(0.01), sum(p))[1],
            nbytes_of=lambda p: 4096 * len(p)))
        sess = eng.open_session("tenant-a")
        assert [eng.submit(sess, "sum", [i, 1]).result(timeout=30) for i in range(3)] == \
            [1, 2, 3]
    finally:
        eng.shutdown()
        g.close()
    assert governed._attrib._fn is attribution.note_reservation
    gauges = attribution.worker_gauges()
    recs = [attribution.parse_detail(e["detail"]) for e in flight.snapshot()
            if e["kind"] == flight.EV_ATTRIB]
    assert len(recs) == 3 and all(r["tenant"] == "tenant-a" for r in recs)
    assert all(r["gbs"] >= 8192 * 10_000_000 for r in recs)  # 8 KiB for >= 10 ms
    assert gauges["attrib_gov_byte_ns"] >= sum(r["gbs"] for r in recs)
    assert gauges["attrib_busy_ns"] >= sum(r["comp_ns"] for r in recs) > 0
