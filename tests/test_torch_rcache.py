"""The port's governed result cache against the JAX package's, on the CPU.

- Keys: ``array_digest``, ``tables_fingerprint``, ``plan_result_key``,
  ``request_key`` and ``key_token`` of the same host numpy equal the JAX
  package's.
- ``run_governed_plan`` with ``serve_result_cache`` on: the second run is a
  hit equal to the first, with no admission and no launch; a table version
  bump invalidates.
- The disk tier drops a corrupt frame and the caller recomputes.
- The HBM tier (here the CPU device bound with the budget) holds its bytes
  through ``try_acquire``: reserved on insert, released on drop and on a
  pressure demotion, and host-side when the budget has no headroom.
- The engine consults the cache before its bracket, as the JAX engine does.
"""

import os

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.models import q3 as jax_q3
from spark_rapids_jni_tpu.models import tables as jax_tabreg
from spark_rapids_jni_tpu.plans import rcache as jax_rcache
from spark_rapids_jni_tpu_torch import config, mem, serve
from spark_rapids_jni_tpu_torch.mem.governed import attempt_once, task_context
from spark_rapids_jni_tpu_torch.models import q3
from spark_rapids_jni_tpu_torch.models import tables as tabreg
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q3_data
from spark_rapids_jni_tpu_torch.obs import flight
from spark_rapids_jni_tpu_torch.plans import plan_cache, run_governed_plan
from spark_rapids_jni_tpu_torch.plans import rcache
from spark_rapids_jni_tpu_torch.plans.rcache import request_key, result_cache


@pytest.fixture
def gov():
    g = mem.MemoryGovernor(watchdog_period_s=0.02)
    yield g
    g.close()


@pytest.fixture(autouse=True)
def _fresh_cache():
    for c, t in ((result_cache, tabreg), (jax_rcache.result_cache, jax_tabreg)):
        c.reset_for_tests()
        t.reset_for_tests()
    yield
    for c, t in ((result_cache, tabreg), (jax_rcache.result_cache, jax_tabreg)):
        c.reset_for_tests()
        t.reset_for_tests()


def _q3_case(mod, seed=1):
    data = generate_q3_data(sf=0.01, seed=seed)
    return mod.q3_plan(**mod._geometry(data)), mod._q3_tables(mod._facts(data), mod._dims(data))


@pytest.mark.parametrize("dp", [1, 4])
def test_keys_equal_jax(dp):
    plan, tables = _q3_case(q3)
    jax_plan, _ = _q3_case(jax_q3)
    for reg in (tabreg, jax_tabreg):
        reg.bump("store_sales")
        reg.bump("item")
    rng = np.random.RandomState(5)
    for a in (rng.randint(-9, 9, 37).astype(np.int32), rng.rand(5, 3), np.zeros(0, np.int64),
              np.arange(10, dtype=np.int64)[::2]):
        assert rcache.array_digest(a) == jax_rcache.array_digest(a)
    assert rcache.tables_fingerprint(tables, dp) == jax_rcache.tables_fingerprint(tables, dp)
    key, deps = rcache.plan_result_key(plan, dp, tables)
    assert (key, deps) == jax_rcache.plan_result_key(jax_plan, dp, tables)
    rk = rcache.request_key("hash32", ("d", rcache.array_digest(tables["item"]["brand"])),
                            ["item", "date_dim"])
    assert rk == jax_rcache.request_key(
        "hash32", ("d", jax_rcache.array_digest(tables["item"]["brand"])), ["item", "date_dim"])
    assert rcache.key_token(key) == jax_rcache.key_token(key)
    assert rcache.key_token(rk[0]) == jax_rcache.key_token(rk[0])


def _governed_q3(gov, plan, tables, task_id):
    return run_governed_plan(None, plan, tables, budget=mem.BudgetedResource(gov, 1 << 30),
                             task_id=task_id, device="cpu")


def test_governed_plan_hit_skips_the_bracket(gov):
    plan, tables = _q3_case(q3)
    with config.override(serve_result_cache=True):
        first = _governed_q3(gov, plan, tables, 11)
        execs = plan_cache.stats()["execute_calls"]
        flight.recorder().reset_for_tests()
        second = _governed_q3(gov, plan, tables, 12)
    assert list(second) == list(first)
    for k in first:
        np.testing.assert_array_equal(second[k], first[k])
    assert plan_cache.stats()["execute_calls"] == execs
    kinds = [e["kind"] for e in flight.snapshot()]
    assert flight.EV_RCACHE_HIT in kinds and flight.EV_TASK_ADMITTED not in kinds
    s = result_cache.stats()
    assert (s["hits"], s["misses"], s["stores"]) == (1, 1, 1)


def test_table_bump_invalidates(gov):
    plan, tables = _q3_case(q3)
    with config.override(serve_result_cache=True):
        first = _governed_q3(gov, plan, tables, 11)
        tabreg.bump("store_sales")
        assert result_cache.stats()["invalidated"] == 1
        execs = plan_cache.stats()["execute_calls"]
        again = _governed_q3(gov, plan, tables, 12)
    assert plan_cache.stats()["execute_calls"] == execs + 1  # recomputed
    for k in first:
        np.testing.assert_array_equal(again[k], first[k])
    assert result_cache.stats()["hits"] == 0


def test_corrupt_disk_frame_is_dropped_and_recomputed(tmp_path):
    value = {"v": np.arange(256, dtype=np.int64), "f": np.linspace(0, 1, 7)}
    with config.override(serve_result_cache_dir=str(tmp_path),
                         serve_result_cache_host_bytes=100):
        key, deps = request_key("h", "k", [])
        assert result_cache.put(key, value, deps)
        assert result_cache.stats()["disk_entries"] == 1
        (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)
                   if f.startswith("rc_")]
        raw = open(path, "rb").read()
        with open(path, "wb") as f:  # flip one payload byte
            f.write(raw[:40] + bytes([raw[40] ^ 0x10]) + raw[41:])
        assert result_cache.lookup(key) is None
        s = result_cache.stats()
        assert s["corrupt_drops"] == 1 and s["entries"] == 0
        assert not os.path.exists(path)
        assert result_cache.put(key, value, deps)
        hit = result_cache.lookup(key)
    assert all(np.array_equal(hit[k], value[k]) for k in value)


def test_hbm_tier_accounting_under_try_acquire(gov):
    budget = mem.BudgetedResource(gov, 1 << 20)
    result_cache.bind_budget(budget, device="cpu")
    vals = {}
    for i in range(6):  # 6 x 128 KiB cached against 1 MiB
        key, deps = request_key("h", f"k{i}", [])
        vals[i] = {"v": np.arange((1 << 17) // 8, dtype=np.int64) + i}
        assert result_cache.put(key, vals[i], deps)
    s = result_cache.stats()
    assert s["hbm_entries"] == 6 and budget.used == s["hbm_bytes"] == 6 << 17
    stored = result_cache._entries[request_key("h", "k0", [])[0]].value["v"]
    assert isinstance(stored, torch.Tensor) and stored.device.type == "cpu"
    hit = result_cache.lookup(request_key("h", "k0", [])[0])
    assert not hit["v"].flags.writeable and np.array_equal(hit["v"], vals[0]["v"])
    # a live reservation that does not fit beside the cache demotes it
    with task_context(gov, 1):
        assert attempt_once(gov, budget, None, lambda p: (1 << 20) - (1 << 17),
                            lambda p: "live") == "live"
    after = result_cache.stats()
    assert after["demotes_hbm_host"] >= 1 and budget.used == after["hbm_bytes"]
    for i in range(6):
        got = result_cache.lookup(request_key("h", f"k{i}", [])[0])
        assert np.array_equal(got["v"], vals[i]["v"])
    # no headroom: the entry stays host-side and reserves nothing
    small = mem.BudgetedResource(gov, 4096)
    result_cache.bind_budget(small, device="cpu")
    assert budget.used == 0  # rebinding demoted the old budget's entries
    key, deps = request_key("h", "big", [])
    assert result_cache.put(key, {"v": np.arange(4096, dtype=np.int64)}, deps)
    assert result_cache.stats()["hbm_entries"] == 0 and small.used == 0
    result_cache.clear()
    assert small.used == budget.used == 0


def test_refused_upload_hands_the_bytes_back(gov, monkeypatch):
    """A device that refuses the upload (an out-of-memory is a RuntimeError)
    leaves the entry host-side with its reservation returned."""
    budget = mem.BudgetedResource(gov, 1 << 20)
    result_cache.bind_budget(budget, device="cpu")

    def refuse(*args, **kwargs):
        raise RuntimeError("CUDA out of memory")

    monkeypatch.setattr(rcache.torch, "tensor", refuse)
    key, deps = request_key("h", "k", [])
    assert result_cache.put(key, {"v": np.arange(64, dtype=np.int64)}, deps)
    s = result_cache.stats()
    assert (s["hbm_entries"], s["host_entries"], budget.used) == (0, 1, 0)


def test_engine_consults_before_the_bracket(gov):
    calls = []
    with config.override(serve_result_cache=True):
        engine = serve.ServingEngine(gov=gov, budget=mem.BudgetedResource(gov, 1 << 26),
                                     workers=2, queue_size=16, device="cpu")
        try:
            engine.register(serve.QueryHandler(
                name="sum", fn=lambda p, ctx: calls.append(1) or int(np.sum(p)),
                nbytes_of=lambda p: 8 * len(p),
                cache_key=lambda p: rcache.array_digest(np.asarray(p)), cache_tables=("t",)))
            sess = engine.open_session("c")
            data = np.arange(500, dtype=np.int64)
            r1 = engine.submit(sess, "sum", data).result(10)
            r2 = engine.submit(sess, "sum", data).result(10)
            m = engine.metrics
            counts = (m.get("rcache_hits"), m.get("rcache_misses"), m.get("rcache_stores"))
            tabreg.bump("t")
            r3 = engine.submit(sess, "sum", data).result(10)
            gauges = engine.metrics.snapshot()["gauges"]
        finally:
            engine.shutdown()
    assert r1 == r2 == r3 == int(data.sum()) and len(calls) == 2
    assert counts == (1, 1, 1)
    assert gauges["rcache_entries"] == 1
