"""The port's plan path crosses the JAX package's seams, in the same order.

A fault-injector config or a profile filter written for one package must see
the same crossings in the other.  Each case records every ``(category,
name)`` crossing through the injector hook of each package while a plan runs
twice on the same tables under ``run_governed_plan`` (the first run builds
the executor, the second hits the plan cache): q3's plan locally, and q97's
plan, whose exchange crosses ``all_to_all_shuffle`` once per built executor,
on a (1, 1) mesh.  The port's plan cache is also the flight recorder's
``plan_cache`` telemetry source, as the JAX package's is.
"""

import contextlib

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu import mem as jax_mem
from spark_rapids_jni_tpu.models import q3 as jax_q3
from spark_rapids_jni_tpu.models import q97 as jax_q97
from spark_rapids_jni_tpu.obs import seam as jax_seam
from spark_rapids_jni_tpu.parallel import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu.plans import plan_cache as jax_plan_cache
from spark_rapids_jni_tpu.plans import runtime as jax_runtime
from spark_rapids_jni_tpu_torch import mem
from spark_rapids_jni_tpu_torch.models import q3, q97
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q3_data
from spark_rapids_jni_tpu_torch.obs import flight, seam
from spark_rapids_jni_tpu_torch.parallel import one_rank_mesh
from spark_rapids_jni_tpu_torch.plans import plan_cache, run_governed_plan


@contextlib.contextmanager
def _recorded(seam_mod):
    """Every crossing of ``seam_mod``'s seam, in order."""
    seen = []
    prev = seam_mod._injector
    seam_mod._set_injector(lambda category, name: seen.append((category, name)))
    try:
        yield seen
    finally:
        seam_mod._set_injector(prev)


def _q3_case(pkg):
    data = generate_q3_data(sf=0.01, seed=1)
    mod = q3 if pkg == "port" else jax_q3
    return mod.q3_plan(**mod._geometry(data)), mod._q3_tables(mod._facts(data), mod._dims(data))


def _q97_case(pkg):
    rng = np.random.RandomState(11)
    cols = [rng.randint(1, 50, 400).astype(np.int32) for _ in range(4)]
    mod = q97 if pkg == "port" else jax_q97
    tables = {"store": {"cust": cols[0], "item": cols[1]},
              "catalog": {"cust": cols[2], "item": cols[3]}}
    return mod.q97_plan(1024), tables


def _crossings(pkg, case, mesh):
    """The crossings of two governed runs of ``case``'s plan, and the outputs."""
    plan, tables = case(pkg)
    m, cache, run, sm = ((mem, plan_cache, run_governed_plan, seam) if pkg == "port" else
                         (jax_mem, jax_plan_cache, jax_runtime.run_governed_plan, jax_seam))
    cache.clear()
    g = m.MemoryGovernor(watchdog_period_s=0.02)
    kw = {"device": "cpu"} if pkg == "port" else {}
    try:
        budget = m.BudgetedResource(g, 1 << 30)
        with _recorded(sm) as seen:
            outs = [run(mesh, plan, tables, budget=budget, task_id=5, **kw) for _ in range(2)]
    finally:
        g.close()
    return seen, outs


@pytest.mark.parametrize("query", ["q3", "q97"])
def test_plan_runs_cross_the_jax_seams(query):
    case = _q3_case if query == "q3" else _q97_case
    with (one_rank_mesh("cpu") if query == "q97" else contextlib.nullcontext()) as mesh:
        port, port_outs = _crossings("port", case, mesh)
    jax_mesh = jax_make_mesh((1, 1), devices=jax.devices()[:1]) if query == "q97" else None
    want, jax_outs = _crossings("jax", case, jax_mesh)
    assert port == want
    names = [n for _c, n in port]
    plan = case("port")[0]
    sig = f"plan:{plan.name}:"
    assert sum(n.startswith(sig) for n in names) == 1  # built once, then a cache hit
    assert names.count(f"plan_upload:{plan.name}") == 2
    assert sum(n.startswith(f"launch:{sig}") for n in names) == 2
    assert names.count("all_to_all_shuffle") == (1 if query == "q97" else 0)
    for got, exp in zip(port_outs, jax_outs):
        assert list(got) == list(exp)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(exp[k]))


def test_plan_cache_is_a_flight_telemetry_source():
    plan, tables = _q3_case("port")
    g = mem.MemoryGovernor(watchdog_period_s=0.02)
    try:
        run_governed_plan(None, plan, tables, budget=mem.BudgetedResource(g, 1 << 30),
                          device="cpu")
    finally:
        g.close()
    sources = flight.recorder().unified_snapshot()
    assert sources["plan_cache"] == plan_cache.stats()
    assert sources["plan_cache"]["execute_calls"] >= 1
