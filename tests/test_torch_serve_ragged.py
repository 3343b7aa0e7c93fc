"""The port's ragged page-pool path against the JAX package's, on the CPU.

- ``pack_ragged``, ``scatter_ragged``, ``split_riders``, ``split_point`` and
  ``geometry_for`` give the JAX package's arrays and geometries on seeded
  mixes (zero-row riders and one giant rider included).
- Through the serving engine, ``hash32`` answers with ``serve_ragged`` on
  equal the micro-batcher's (the flag-off oracle) and the JAX ragged
  engine's, in as many ticks.
- The ragged programs in the plan cache are bounded by the page geometries
  the ticks used, not by request shapes.
- The page pool gets its buffers back after a launch fault injected between
  the upload and the launch, and the next tick that reuses them is exact.
"""

import threading

import jax
import numpy as np
import pytest

from spark_rapids_jni_tpu import mem as jax_mem
from spark_rapids_jni_tpu import serve as jax_serve
from spark_rapids_jni_tpu.columnar import pages as jax_pages
from spark_rapids_jni_tpu.parallel import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu_torch import mem
from spark_rapids_jni_tpu_torch import serve
from spark_rapids_jni_tpu_torch.columnar import pages
from spark_rapids_jni_tpu_torch.obs import flight
from spark_rapids_jni_tpu_torch.obs.faultinj import FaultInjector
from spark_rapids_jni_tpu_torch.plans.cache import plan_cache
from spark_rapids_jni_tpu_torch.plans.compiler import RaggedProgram
from spark_rapids_jni_tpu_torch.serve.ragged import RaggedSpec, run_rows_compiled

MIXES = [
    [0],                      # a single empty rider
    [0, 0, 0],                # all-empty tick
    [1],                      # minimal rider
    [5000],                   # single giant rider (> several pages)
    [0, 5, 1000, 3, 0, 257],  # mixed with zeros
    list(range(64)),          # max-rider page, tiny ragged lengths
    [4096] + [1] * 63,        # one giant + a swarm
]


def _rows(mix, seed=42, dtype=np.int64):
    rng = np.random.RandomState(seed)
    return [rng.randint(-1000, 1000, n).astype(dtype) for n in mix]


@pytest.mark.parametrize("floor", [1, 64], ids=["right_sized", "standing_pool"])
@pytest.mark.parametrize("mix", MIXES, ids=lambda m: f"{len(m)}riders_{sum(m)}rows")
def test_pack_scatter_split_equal_jax(mix, floor):
    rows = _rows(mix)
    got = pages.pack_ragged(rows, 256, min_pages=floor, min_riders=floor)
    want = jax_pages.pack_ragged(rows, 256, min_pages=floor, min_riders=floor)
    assert got.geometry.describe() == want.geometry.describe()
    for f in ("data", "valid", "rid", "offsets"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (got.n_riders, got.rows_packed) == (want.n_riders, want.rows_packed)
    back, ref = pages.scatter_ragged(got.data, got), jax_pages.scatter_ragged(want.data, want)
    assert len(back) == len(ref) == len(rows)
    assert all(np.array_equal(a, b) and np.array_equal(a, r) for a, b, r in
               zip(back, ref, rows))
    halves, ref_halves = pages.split_riders(rows), jax_pages.split_riders(rows)
    assert [len(h) for h in halves] == [len(h) for h in ref_halves]
    assert [len(a) for h in halves for a in h] == mix
    assert pages.split_point(mix) == jax_pages.split_point(mix)


def test_geometries_equal_jax():
    for total in range(0, 20_000, 37):
        for riders in (1, 7, 64, 100):
            for floor in (1, 64):
                args = (total, riders, 256, "int64")
                kw = {"min_pages": floor, "min_riders": floor}
                assert pages.geometry_for(*args, **kw).describe() == \
                    jax_pages.geometry_for(*args, **kw).describe()


def _payloads(seed=79):
    """hash32 payloads: rows log-uniform over 1-2^12, two empty riders and
    one giant one (several pages)."""
    rng = np.random.RandomState(seed)
    sizes = list(np.exp(rng.uniform(0, np.log(1 << 12), 40)).astype(int)) + [0, 0, 9000]
    return [rng.randint(-(1 << 62), 1 << 62, size=n, dtype=np.int64) for n in sizes]


def _hash_run(pkg, ragged, payloads, mesh=None):
    """``payloads`` through a one-worker engine held on a gate until all are
    queued; returns (answers, metrics, each ragged tick's geometry)."""
    m, s = (mem, serve) if pkg == "port" else (jax_mem, jax_serve)
    g = m.MemoryGovernor(watchdog_period_s=0.02)
    kw = {"device": "cpu"} if pkg == "port" else {"mesh": mesh}
    eng = s.ServingEngine(gov=g, budget=m.BudgetedResource(g, 1 << 30), workers=1,
                          queue_size=128, builtin_handlers=True, serve_ragged=ragged, **kw)
    gate = threading.Event()
    if pkg == "port":
        flight.recorder().reset_for_tests()
    try:
        eng.register(s.QueryHandler(name="gate", fn=lambda p, ctx: gate.wait(30)))
        sess = eng.open_session()
        held = eng.submit(sess, "gate", None)
        resps = [eng.submit(sess, "hash32", p) for p in payloads]
        gate.set()
        held.result(timeout=30)
        answers = [r.result(timeout=60) for r in resps]
        metrics = {k: eng.metrics.get(k) for k in ("ragged_launches", "ragged_batched",
                                                   "ragged_rows", "batched")}
    finally:
        gate.set()
        eng.shutdown()
        g.close()
    geoms = []
    if pkg == "port":
        geoms = [e["detail"].split(":geom:")[1] for e in flight.snapshot()
                 if e["kind"] == flight.EV_RAGGED_LAUNCH]
    return answers, metrics, geoms


def test_ragged_answers_equal_micro_batch_and_jax():
    payloads = _payloads()
    ragged, rm, geoms = _hash_run("port", True, payloads)
    micro, mm, _ = _hash_run("port", False, payloads)
    jax_ragged, jm, _ = _hash_run("jax", True, payloads,
                                  jax_make_mesh((1, 1), devices=jax.devices()[:1]))
    for a, b, c in zip(ragged, micro, jax_ragged):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, np.asarray(c))
    assert rm == jm
    assert rm["ragged_batched"] == len(payloads) and rm["ragged_rows"] == sum(map(len, payloads))
    assert rm["ragged_launches"] == len(geoms) >= 1
    assert mm["batched"] >= 2 and mm["ragged_launches"] == 0


def test_ragged_programs_bounded_by_page_geometry():
    """Heterogeneous ticks through the standing pool build one program per
    page geometry, however many request shapes flow through."""
    def ragged_keys():
        return {k for k in plan_cache._entries if isinstance(k[0], RaggedProgram)}

    before = ragged_keys()
    rng = np.random.RandomState(3)
    seen = set()
    for _ in range(4):
        payloads = [rng.randint(0, 1 << 30, int(n)).astype(np.int64)
                    for n in rng.randint(0, 2000, 12)]
        _, metrics, geoms = _hash_run("port", True, payloads)
        seen |= set(geoms)
        assert metrics["ragged_launches"] >= 1
    new = ragged_keys() - before
    assert {k[0].geometry.describe() for k in new} <= seen
    assert len(seen) <= 2  # the standing pool, and one larger for a big tick


def test_pool_released_after_injected_launch_fault():
    """A fault injected at the launch seam -- after the pool's buffers were
    uploaded -- still returns them to the pool, and the next tick that packs
    into the recycled buffers is exact."""
    def kernel(data, valid, rid, riders_cap):
        return data * 3 + valid.to(data.dtype)

    spec = RaggedSpec(rows_of=lambda p: np.asarray(p, np.int64), kernel=kernel,
                      kernel_key="test.torch_ragged_fault")
    first = np.arange(40, dtype=np.int64)
    run_rows_compiled(spec, first, 16, device="cpu")  # the geometry's buffers exist
    before = pages.page_pool.gauges()
    FaultInjector.install({"collective": {"launch:ragged:test.torch_ragged_fault:*": {
        "injectionType": "exception", "interceptionCount": 1}}})
    try:
        with pytest.raises(Exception, match="injected fault"):
            run_rows_compiled(spec, first, 16, device="cpu")
    finally:
        FaultInjector.uninstall()
    after = pages.page_pool.gauges()
    assert after["buffers_free"] == before["buffers_free"]
    assert after["reuses"] == before["reuses"] + 1
    nxt = np.arange(100, 140, dtype=np.int64)
    np.testing.assert_array_equal(run_rows_compiled(spec, nxt, 16, device="cpu"), nxt * 3 + 1)
    assert pages.page_pool.gauges()["reuses"] == before["reuses"] + 2
