"""The port's governed execution against the JAX package's, on the CPU.

- The split-and-retry driver (the six driver tests of
  ``tests/test_governed.py``), on the port's governor.
- ``default_device_budget``: sized from ``torch.cuda.mem_get_info`` on the
  card (monkeypatched here), from the ``device_budget_bytes`` flag on the CPU.
- Spill to host (after ``tests/test_spill.py``) and the monte-carlo stress
  harness (after ``tests/test_montecarlo.py``), its q97 arm on a one-rank
  gloo group.
- The governed runners ``run_distributed_q5``, ``run_distributed_q3`` and
  ``run_distributed_q3_columns`` with ``mesh=None`` on the CPU, under a
  budget that holds their working set and one that does not: rows equal to
  the JAX runners' under the same budget limit, and so are the split counts
  (the arbiter's per-task metric and the executions).
- ``run_governed_plan`` keeps no retry history: after a call that split, the
  next roomy call runs whole, with adaptive admission off or on.
- The repairs of the port's mesh and plan device (a rank on the wrong card),
  with ``torch.cuda`` monkeypatched.
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config as jax_config
from spark_rapids_jni_tpu import mem as jax_mem
from spark_rapids_jni_tpu.models import q3 as jax_q3
from spark_rapids_jni_tpu.models import q5 as jax_q5
from spark_rapids_jni_tpu.parallel import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu.plans import plan_cache as jax_plan_cache
from spark_rapids_jni_tpu.plans import runtime as jax_runtime
from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch import mem
from spark_rapids_jni_tpu_torch.mem import governed
from spark_rapids_jni_tpu_torch.mem.exceptions import GpuRetryOOM, GpuSplitAndRetryOOM
from spark_rapids_jni_tpu_torch.mem.governor import OutOfBudget
from spark_rapids_jni_tpu_torch.mem.montecarlo import (
    MonteCarloConfig,
    run_monte_carlo,
    run_q97_monte_carlo,
)
from spark_rapids_jni_tpu_torch.mem.spill import SpillPool
from spark_rapids_jni_tpu_torch.models import q3, q5
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q3_data, generate_q5_data
from spark_rapids_jni_tpu_torch.obs import flight, seam
from spark_rapids_jni_tpu_torch.parallel import mesh as mesh_mod
from spark_rapids_jni_tpu_torch.plans import (
    compiler,
    input_signature_raw,
    pad_tables,
    plan_cache,
    plan_inputs,
    plan_working_set_bytes,
    run_governed_plan,
)
from spark_rapids_jni_tpu_torch.plans import runtime


@pytest.fixture
def gov():
    g = mem.MemoryGovernor(watchdog_period_s=0.02)
    yield g
    g.close()


# --- the split-and-retry driver ---------------------------------------------------------


def _halves(b):
    return [b[: len(b) // 2], b[len(b) // 2:]]


def test_driver_processes_whole_batch(gov):
    budget = mem.BudgetedResource(gov, 1 << 20)
    with mem.task_context(gov, 1):
        out = mem.run_with_split_retry(budget, list(range(10)), nbytes_of=lambda b: 64 * len(b),
                                       run=sum, split=_halves, combine=sum)
    assert out == sum(range(10))
    assert gov.get_and_reset_num_split_retry(1) == 0


def test_driver_injected_split_and_retry(gov):
    budget = mem.BudgetedResource(gov, 1 << 20)
    seen = []
    with mem.task_context(gov, 1):
        gov.force_split_and_retry_oom(num_ooms=1)
        out = mem.run_with_split_retry(
            budget, list(range(8)), nbytes_of=lambda b: 64 * len(b),
            run=lambda b: seen.append(list(b)) or sum(b), split=_halves, combine=sum)
        splits = gov.get_and_reset_num_split_retry(1)
    assert out == sum(range(8))
    assert seen == [[0, 1, 2, 3], [4, 5, 6, 7]]  # two halves, each ran once
    assert splits == 1


def test_driver_oversized_batch_splits_until_fit(gov):
    """A reservation larger than the whole budget escalates through the
    arbiter (BLOCKED -> BUFN -> SPLIT_THROW via the watchdog) and splits."""
    budget = mem.BudgetedResource(gov, 1000)
    ran = []
    with mem.task_context(gov, 3):
        out = mem.run_with_split_retry(
            budget, list(range(16)), nbytes_of=lambda b: 200 * len(b),
            run=lambda b: ran.append(len(b)) or sum(b), split=_halves, combine=sum)
        splits = gov.get_and_reset_num_split_retry(3)
    assert out == sum(range(16))
    assert all(n * 200 <= 1000 for n in ran), ran
    assert splits >= 1
    assert budget.used == 0


def test_driver_unsplittable_raises(gov):
    budget = mem.BudgetedResource(gov, 100)
    with mem.task_context(gov, 1):
        with pytest.raises(mem.MaxSplitDepthExceeded):
            mem.run_with_split_retry(budget, [1], nbytes_of=lambda b: 1000, run=lambda b: 0,
                                     split=lambda b: [b], combine=sum)


def test_driver_injected_retry_oom_retries_same_piece(gov):
    budget = mem.BudgetedResource(gov, 1 << 20)
    attempts = []
    with mem.task_context(gov, 1):
        gov.force_retry_oom(num_ooms=1)
        out = mem.run_with_split_retry(
            budget, [5], nbytes_of=lambda b: 64,
            run=lambda b: attempts.append(1) or b[0], split=lambda b: [], combine=sum)
        retries = gov.get_and_reset_num_retry(1)
    assert out == 5
    assert len(attempts) == 1  # RetryOOM fired in acquire, before run
    assert retries == 1


def test_driver_grow_on_capacity_exceeded(gov):
    budget = mem.BudgetedResource(gov, 1 << 20)
    caps = []

    def run(piece):
        caps.append(piece)
        if piece < 4:
            raise mem.ShuffleCapacityExceeded(f"cap {piece}")
        return piece

    out = mem.run_with_split_retry(budget, 1, nbytes_of=lambda c: 64 * c, run=run,
                                   split=lambda c: [], combine=lambda r: r[0],
                                   grow=lambda c: c * 2)
    assert out == 4
    assert caps == [1, 2, 4]


def test_agreement_of_a_one_rank_group_needs_no_collective(monkeypatch):
    """A group of one rank agrees with itself: no all_reduce is issued."""
    monkeypatch.setattr(governed.dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(governed.dist, "all_reduce",
                        lambda *a, **k: pytest.fail("all_reduce on a one-rank group"))
    assert [governed.agreed_outcome(c, object()) for c in range(4)] == [0, 1, 2, 3]


# --- the default budget -----------------------------------------------------------------


@pytest.fixture
def fresh_default_budget():
    governed._reset_default_budget_for_tests()
    yield
    mem.MemoryGovernor.shutdown()
    governed._reset_default_budget_for_tests()


def test_default_budget_is_the_cards_memory(monkeypatch, fresh_default_budget):
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: asked.append(d) or (5 << 30, 80 << 30))
    assert mem.default_device_budget().limit == int((80 << 30) / governed.PEAK_OVER_RESERVATION)
    assert asked == [3]


def test_default_budget_on_the_cpu_is_the_flag(monkeypatch, fresh_default_budget):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with config.override(device_budget_bytes=123 << 20):
        budget = mem.default_device_budget()
    assert budget.limit == 123 << 20
    assert config.FLAGS["device_budget_bytes"].default == \
        jax_config.FLAGS["device_budget_bytes"].default
    assert mem.default_device_budget() is budget  # cached


def test_default_budget_rebuilt_after_governor_shutdown(fresh_default_budget):
    """A cached default budget bound to a shut-down governor is rebuilt,
    never driving a closed native arbiter."""
    mem.MemoryGovernor.initialize()
    b1 = mem.default_device_budget()
    mem.MemoryGovernor.shutdown()
    mem.MemoryGovernor.initialize()
    b2 = mem.default_device_budget()
    assert b2 is not b1
    b2.acquire(10)
    b2.release(10)
    with pytest.raises(RuntimeError, match="arbiter is closed"):
        b1.gov.arbiter.state_of(0)


def test_config_copies_every_flag_of_the_jax_package():
    assert config.FLAGS.keys() == jax_config.FLAGS.keys()
    for name, flag in config.FLAGS.items():
        ref = jax_config.FLAGS[name]
        assert (flag.default, flag.env) == (ref.default, ref.env), name


# --- spill to host ------------------------------------------------------------------------


def _budget(gov, nbytes):
    b = mem.BudgetedResource(gov, nbytes)
    gov.current_thread_is_dedicated_to_task(0)
    return b


def test_spill_roundtrip_and_lru(gov):
    budget = _budget(gov, 4096 + 512)  # room for ONE 4096-B buffer
    pool = SpillPool(budget, device="cpu")
    a = pool.add(torch.arange(1024, dtype=torch.float32))  # 4096 B
    b = pool.add(torch.arange(1024, 2048, dtype=torch.float32))
    with a.use() as t:
        assert float(t[3]) == 3.0 and t.device.type == "cpu"
    assert not a.spilled and budget.used == 4096
    with b.use() as t:  # admitting b exceeds the limit: the pool spills a
        assert float(t[0]) == 1024.0
        assert a.spilled, "LRU buffer must have been spilled to fit b"
    assert pool.spill_count == 1
    with a.use() as t:  # a comes back, spilling b in turn
        assert torch.equal(t, torch.arange(1024, dtype=torch.float32))
    assert b.spilled
    assert budget.used == pool.device_bytes() == 4096
    kinds = [e["kind"] for e in flight.snapshot()[-4:]]
    assert kinds == [flight.EV_SPILL_BEGIN, flight.EV_SPILL_END] * 2
    assert flight.unified_snapshot()["spill"]["spill_count"] >= 2


def test_spill_pinned_buffers_never_spill(gov):
    budget = _budget(gov, 4096 + 512)
    pool = SpillPool(budget, device="cpu")
    a = pool.add(torch.zeros(1024, dtype=torch.float32))
    with a.use():
        with pytest.raises((GpuRetryOOM, GpuSplitAndRetryOOM)):
            budget.acquire(4096)
    assert not a.spilled and pool.spill_count == 0


def test_spill_direct_reservation_reclaims_idle_cache(gov):
    budget = _budget(gov, 8192)
    pool = SpillPool(budget, device="cpu")
    a = pool.add(torch.zeros(1024, dtype=torch.float32))
    with a.use():
        pass  # resident, idle: 4096 of 8192 used
    budget.acquire(6000)  # does not fit beside the cache -> spills it
    assert a.spilled and pool.spill_count == 1
    budget.release(6000)
    with a.use():
        with pytest.raises(RuntimeError):
            pool.remove(a)
    pool.remove(a)
    assert budget.used == 0 and pool.device_bytes() == 0


def test_spill_close_detaches_and_oversized_request_spares_cache(gov):
    budget = _budget(gov, 8192)
    pool = SpillPool(budget, device="cpu")
    a = pool.add(torch.zeros(1024, dtype=torch.float32))
    with a.use():
        pass  # resident, idle
    with pytest.raises((GpuRetryOOM, GpuSplitAndRetryOOM, OutOfBudget)):
        budget.acquire(8192 + 1)  # can never fit: the warm cache is spared
    assert not a.spilled and pool.spill_count == 0
    pool.close()
    assert budget.used == 0 and budget._spill_handlers == []


def test_spill_concurrent_pins_single_admission(gov):
    budget = _budget(gov, 1 << 20)
    pool = SpillPool(budget, device="cpu")
    a = pool.add(torch.arange(2048, dtype=torch.int32))
    errs = []
    hold = threading.Barrier(2, timeout=30)

    def worker():
        try:
            gov.current_thread_is_dedicated_to_task(1)
            hold.wait()
            with a.use() as t:
                assert int(t[7]) == 7
        except Exception as e:  # noqa: BLE001 - reported below
            errs.append(repr(e))

    ts = [threading.Thread(target=worker) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errs, errs
    assert budget.used == a.nbytes  # exactly one admission


def test_spill_injected_fault_keeps_arbiter_protocol_consistent(gov):
    budget = _budget(gov, 4096 + 512)
    pool = SpillPool(budget, device="cpu")
    a = pool.add(torch.zeros(1024, dtype=torch.float32))
    with a.use():
        pass

    class Boom(Exception):
        pass

    def inject(cat, name):
        if cat == seam.SPILL and name.startswith("spill:"):
            raise Boom(name)

    seam._set_injector(inject)
    try:
        with pytest.raises(Boom):
            budget.acquire(4096)  # needs the cache spilled -> fault fires
    finally:
        seam._set_injector(None)
    assert gov.arbiter.state_of(mem.current_thread_id()) == mem.STATE_RUNNING
    budget.acquire(400)
    budget.release(400)
    assert not a.spilled


# --- the monte-carlo stress harness -----------------------------------------------------


def test_monte_carlo_short():
    cfg = MonteCarloConfig(
        n_tasks=12, n_threads=6, n_shuffle_threads=2, budget_bytes=4 << 20,
        task_max_bytes=3 << 20, allocs_per_task=30, skewed=True, inject_retry_pct=10.0,
        seed=42)
    stats = run_monte_carlo(cfg)
    assert stats.ok, stats.failures
    assert stats.tasks_completed == 12
    assert stats.injected > 0 and stats.retries >= stats.injected
    assert stats.leaked_bytes == 0 and stats.blocked_at_end == 0
    assert stats.peak_used <= cfg.budget_bytes


def test_monte_carlo_spillable_cache():
    cfg = MonteCarloConfig(
        n_tasks=6, n_threads=3, n_shuffle_threads=1, budget_bytes=4 << 20,
        task_max_bytes=6 << 20, allocs_per_task=20, skewed=True, inject_retry_pct=10,
        seed=3, spill_buffers=6, device="cpu")
    stats = run_monte_carlo(cfg)
    assert stats.ok, stats
    assert stats.cache_pins > 0
    assert stats.cache_spills > 0, "tight budget must force cache spills"


def test_monte_carlo_q97_on_one_rank():
    """Concurrent governed q97 tasks under a shared tight budget on a
    one-rank gloo group: every answer exact, nothing leaked, nobody
    blocked, and the group taken down again."""
    stats = run_q97_monte_carlo(n_tasks=3, budget_frac=0.6, seed=1, device="cpu")
    assert stats.tasks_completed == 3
    assert stats.ok, stats.failures
    assert not torch.distributed.is_initialized()


# --- the governed runners against the JAX package ----------------------------------------


def _q3_columns_data():
    """q3 data with 30% negative prices (the JAX package's columns case)."""
    base = generate_q3_data(sf=0.02, seed=5)
    rng = np.random.RandomState(2)
    price = base.ss_ext_sales_price.copy()
    neg = rng.rand(len(price)) < 0.3
    price[neg] = -price[neg] - 1
    return dataclasses.replace(base, ss_ext_sales_price=price)


def _case(query):
    """(data, working-set bytes, plan name or None) of a governed case."""
    if query == "q5":
        data = generate_q5_data(sf=0.05, seed=8)
        plan, tables = q5._plan_and_tables(data)
        return data, plan_working_set_bytes(plan, tables, 1), "q5"
    if query == "q3":
        data = generate_q3_data(sf=0.05, seed=9)
        return data, q3.q3_working_set_bytes(data), "q3"
    data = _q3_columns_data()
    hi, lo = q3._price_limbs(data.ss_ext_sales_price)
    facts = {**q3._facts(data), "price_hi": hi, "price_lo": lo}
    del facts["price"]
    return data, q3.q3_working_set_bytes(facts), None


def _governed(pkg, query, data, limit):
    """Run ``query``'s governed runner of ``pkg`` ("port", mesh None on the
    CPU; "jax", mesh None or, for the columns runner, a one-device mesh)
    under a fresh budget of ``limit`` bytes; returns (rows, the arbiter's
    split count, the executions)."""
    m = mem if pkg == "port" else jax_mem
    cache = plan_cache if pkg == "port" else jax_plan_cache
    g = m.MemoryGovernor(watchdog_period_s=0.02)
    try:
        budget = m.BudgetedResource(g, limit)
        before = cache.stats()["execute_calls"]
        with m.task_context(g, 9):
            if pkg == "port":
                run = {"q5": q5.run_distributed_q5, "q3": q3.run_distributed_q3,
                       "q3_columns": q3.run_distributed_q3_columns}[query]
                rows = run(None, data, budget=budget, task_id=9, manage_task=False,
                           device="cpu")
            elif query == "q3_columns":
                rows = jax_q3.run_distributed_q3_columns(
                    jax_make_mesh((1, 1), devices=jax.devices()[:1]), data, budget=budget,
                    task_id=9, manage_task=False)
            else:
                run = jax_q5.run_distributed_q5 if query == "q5" else jax_q3.run_distributed_q3
                rows = run(None, data, budget=budget, task_id=9, manage_task=False)
            splits = g.get_and_reset_num_split_retry(9)
        assert budget.used == 0
        return ([tuple(r) for r in rows], splits, cache.stats()["execute_calls"] - before)
    finally:
        g.close()


@pytest.mark.parametrize("tight", [False, True], ids=["default_budget", "tight_budget"])
@pytest.mark.parametrize("query", ["q5", "q3", "q3_columns"])
def test_governed_runner_matches_jax(query, tight):
    data, ws, name = _case(query)
    limit = int(ws * 0.6) if tight else int(jax_config.get("device_budget_bytes"))
    got = _governed("port", query, data, limit)
    want = _governed("jax", query, data, limit)
    assert got == want
    rows, splits, executions = got
    assert rows, "the filter keeps no row at this size"
    if query == "q5":
        assert rows == [tuple(r) for r in q5.q5_local(data, device="cpu")]
    elif query == "q3":
        assert rows == [tuple(r) for r in q3.q3_local(data, device="cpu")]
    else:
        assert rows == [tuple(r) for r in q3.q3_columns_host_oracle(data)]
    assert splits == (1 if tight else 0)
    if name is not None:
        assert executions == (2 if tight else 1)


@pytest.mark.parametrize("flag", ["plan_optimizer", "serve_result_cache"])
def test_governed_plan_refuses_unported_flags(gov, flag):
    """Both flags are ported: the plan optimizer's rewrites the plan with the
    same answer, and with the result cache's the second call is a cache hit
    equal to the first, with no launch."""
    data = generate_q3_data(sf=0.01, seed=1)
    plan = q3.q3_plan(**q3._geometry(data))
    tables = q3._q3_tables(q3._facts(data), q3._dims(data))

    def run():
        return run_governed_plan(None, plan, tables, budget=mem.BudgetedResource(gov, 1 << 30),
                                 device="cpu")

    if flag == "plan_optimizer":
        off = run()
        with config.override(plan_optimizer=True):
            on = run()
        assert list(on) == list(off)
        for k in off:
            np.testing.assert_array_equal(on[k], off[k])
        return
    from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

    result_cache.reset_for_tests()
    try:
        with config.override(**{flag: True}):
            first = run()
            execs = plan_cache.stats()["execute_calls"]
            second = run()
        assert plan_cache.stats()["execute_calls"] == execs
        assert result_cache.stats()["hits"] == 1
        assert list(second) == list(first)
        for k in first:
            np.testing.assert_array_equal(second[k], first[k])
    finally:
        result_cache.reset_for_tests()


def test_uploaded_dims_pass_through_with_the_jax_signature():
    """Dims uploaded once per bracket reach pad_tables and plan_inputs as
    tensors: passed through untouched, under the JAX package's signature."""
    data = generate_q3_data(sf=0.01, seed=1)
    plan = q3.q3_plan(**q3._geometry(data))
    tables = q3._q3_tables(q3._facts(data), q3._dims(data))
    up = runtime._upload_dims(plan, tables, None, "cpu")
    assert all(isinstance(v, torch.Tensor) for d in ("item", "date_dim")
               for v in up[d].values())
    padded = pad_tables(plan, up, 1)
    assert padded["item"]["brand"] is up["item"]["brand"]
    want = jax_runtime.input_signature_raw(plan_jax := jax_q3.q3_plan(**jax_q3._geometry(data)),
                                           tables, 1)
    assert input_signature_raw(plan, up, 1) == want
    assert compiler.input_signature(plan, padded) == \
        jax_runtime.input_signature_raw(plan_jax, tables, 1)
    compiled = runtime.compiled_plan_for(plan, None, up, device="cpu")
    flat = plan_inputs(compiled, padded)
    assert any(t is up["item"]["brand"] for t in flat)


@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "serve_adaptive"])
def test_a_split_leaves_no_presplit_for_the_next_call(gov, adaptive):
    """A tight call on q3 splits three times (the whole batch, its first
    half, then its second half once the first half's quarters ran); a roomy
    call after it runs whole, in one execution, whether adaptive admission
    is off or on: the plan runtime carries no retry history from one call
    to the next."""
    data = generate_q3_data(sf=0.05, seed=9)
    plan = q3.q3_plan(**q3._geometry(data))
    tables = q3._q3_tables(q3._facts(data), q3._dims(data))
    tight = int(q3.q3_working_set_bytes(data) * 0.3)
    got, outs = [], []
    with config.override(serve_adaptive=adaptive), mem.task_context(gov, 9):
        for limit in (tight, 1 << 30):
            before = plan_cache.stats()["execute_calls"]
            outs.append(run_governed_plan(None, plan, tables,
                                          budget=mem.BudgetedResource(gov, limit),
                                          task_id=9, manage_task=False, device="cpu"))
            got.append((gov.get_and_reset_num_split_retry(9),
                        plan_cache.stats()["execute_calls"] - before))
    assert got == [(3, 4), (0, 1)]  # (arbiter splits, executions) per call
    split, whole = outs
    assert list(split) == list(whole)
    for k in whole:
        np.testing.assert_array_equal(split[k], whole[k])


# --- the mesh's card and the plan's device --------------------------------------------------


@pytest.fixture
def cuda_group(monkeypatch):
    """A process group that looks like one NCCL rank on a card, up to the
    point where make_mesh would build the DeviceMesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(mesh_mod.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(mesh_mod.dist, "get_world_size", lambda: 1)
    monkeypatch.setattr(mesh_mod.dist, "get_backend", lambda: "nccl")
    monkeypatch.setattr(mesh_mod, "init_device_mesh", lambda *a, **k: ("mesh", a, k))


def test_make_mesh_refuses_a_rank_on_another_card(monkeypatch, cuda_group):
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(RuntimeError, match="LOCAL_RANK is 1 but the current CUDA device is cuda:0"):
        mesh_mod.make_mesh((1, 1))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    assert mesh_mod.make_mesh((1, 1))[0] == "mesh"
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 5)
    assert mesh_mod.make_mesh((1, 1))[0] == "mesh"  # no launcher: the caller's card


def test_plan_device_of_a_cuda_mesh_is_this_ranks_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)

    class FakeMesh:
        device_type = "cuda"

    assert compiler.plan_device(FakeMesh()) == torch.device("cuda", 3)
    FakeMesh.device_type = "cpu"
    assert compiler.plan_device(FakeMesh()) == torch.device("cpu")
