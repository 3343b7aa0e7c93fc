"""The port's native task arbiter and governor against the JAX package's.

Each arbiter scenario of ``tests/test_mem_governor.py`` runs as one script
on both packages: real threads simulate tasks over a budget-capped resource,
failures are injected, and the script returns what it observed (thread
states, exception types, metric values, the flight-event kinds recorded).
The port must observe exactly what the JAX package observes.  Every thread
join and future has a timeout, and every governor is closed in a
``finally``.

The port builds its own ``libtask_arbiter.so`` under ``build/native/`` from
``spark_rapids_jni_tpu_torch/csrc/task_arbiter.cpp``; the last tests check
where it lives and that the port never builds or loads the JAX package's.
"""

import os
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

import pytest

import spark_rapids_jni_tpu.mem as jax_mem
import spark_rapids_jni_tpu.mem.arbiter as jax_arbiter
import spark_rapids_jni_tpu.obs.flight as jax_flight
import spark_rapids_jni_tpu_torch.mem as port_mem
import spark_rapids_jni_tpu_torch.mem.arbiter as port_arbiter
import spark_rapids_jni_tpu_torch.obs.flight as port_flight

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "jax": types.SimpleNamespace(mem=jax_mem, flight=jax_flight),
    "port": types.SimpleNamespace(mem=port_mem, flight=port_flight),
}


def wait_for(pred, timeout=10.0, msg="condition"):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {msg}")


def _name(fn):
    """The type name of what ``fn()`` raises, or "ok"."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is the observation
        return type(e).__name__
    return "ok"


def _run(pkg, scenario):
    """``scenario(pkg, gov)`` on a fresh governor of ``pkg`` (watchdog every
    50 ms) with an empty flight ring; returns (its observations, the
    flight-event kinds it recorded)."""
    pkg.flight.recorder().reset_for_tests()
    gov = pkg.mem.MemoryGovernor(watchdog_period_s=0.05)
    try:
        seen = scenario(pkg, gov)
    finally:
        gov.close()
    return seen, [e["kind"] for e in pkg.flight.snapshot()]


# --- the scenarios ----------------------------------------------------------------------


def injected_retry_and_split(pkg, gov):
    m = pkg.mem
    arb, tid = gov.arbiter, m.current_thread_id()
    seen = []
    gov.current_thread_is_dedicated_to_task(1)
    seen.append(gov.state_of_current_thread())
    gov.start_retry_block()
    gov.force_retry_oom(num_ooms=2, oom_filter=m.OOM_GPU)
    seen += [_name(lambda: arb.pre_alloc(tid)) for _ in range(2)]
    seen.append(arb.pre_alloc(tid))
    arb.post_alloc_success(tid)
    gov.force_split_and_retry_oom(num_ooms=1)
    seen.append(_name(lambda: arb.pre_alloc(tid)))
    gov.force_retry_oom(num_ooms=1, oom_filter=m.OOM_CPU)
    seen.append(arb.pre_alloc(tid, is_cpu=False))  # the GPU alloc is unaffected
    arb.post_alloc_success(tid)
    seen.append(_name(lambda: arb.pre_alloc(tid, is_cpu=True)))
    gov.end_retry_block()
    seen += [gov.get_and_reset_num_retry(1), gov.get_and_reset_num_split_retry(1)]
    gov.task_done(1)
    seen.append(gov.state_of_current_thread())
    return seen


def recursive_alloc(pkg, gov):
    arb, tid = gov.arbiter, pkg.mem.current_thread_id()
    with pkg.mem.task_context(gov, 1):
        seen = [arb.pre_alloc(tid), gov.state_of_current_thread()]  # RUNNING -> ALLOC
        # an alloc while in ALLOC state is a spill-driven recursive alloc
        seen.append(arb.pre_alloc(tid, blocking=False))
        seen.append(_name(lambda: arb.pre_alloc(tid, is_cpu=True, blocking=True)))
        arb.post_alloc_success(tid)
        seen.append(gov.state_of_current_thread())
    return seen


def block_and_wake_priority(pkg, gov):
    """Task 1 holds the whole budget; a task thread blocks first, then a
    shuffle thread; the release wakes the shuffle thread first."""
    budget = pkg.mem.BudgetedResource(gov, limit_bytes=100)
    order = []
    ready = threading.Event()

    def holder():
        gov.current_thread_is_dedicated_to_task(1)
        budget.acquire(100)
        ready.set()
        wait_for(lambda: gov.arbiter.total_blocked_or_bufn() >= 2, msg="both blocked")
        budget.release(100)
        wait_for(lambda: len(order) == 2, msg="both finished")
        gov.remove_current_dedicated_thread_association()

    def task_waiter():
        ready.wait(timeout=10)
        gov.current_thread_is_dedicated_to_task(2)
        budget.acquire(100)
        order.append("task")
        budget.release(100)
        gov.remove_current_dedicated_thread_association()

    def shuffle_waiter():
        ready.wait(timeout=10)
        wait_for(lambda: gov.arbiter.total_blocked_or_bufn() >= 1, msg="task blocked")
        gov.shuffle_thread_working_on_tasks([2])
        budget.acquire(100)
        order.append("shuffle")
        budget.release(100)
        gov.arbiter.remove_thread_association(pkg.mem.current_thread_id(), -1)

    with ThreadPoolExecutor(max_workers=3) as ex:
        for f in [ex.submit(holder), ex.submit(task_waiter), ex.submit(shuffle_waiter)]:
            f.result(timeout=30)
    return order + [budget.used, gov.arbiter.total_blocked_or_bufn()]


def bufn_escalation_to_split(pkg, gov):
    """One task blocked on a request that cannot fit beside what it holds:
    the watchdog throws it a RetryOOM (BUFN_THROW); back at its rollback
    point it waits until ready, and with every task BUFN the arbiter
    escalates it to SplitAndRetryOOM."""
    m = pkg.mem
    budget = m.BudgetedResource(gov, limit_bytes=100)
    seen = []

    def task():
        gov.current_thread_is_dedicated_to_task(4)
        tid = m.current_thread_id()
        budget.acquire(60)
        try:
            seen.append(_name(lambda: budget.acquire(60)))
            seen.append(gov.arbiter.state_of(tid))
            seen.append(_name(lambda: gov.arbiter.block_thread_until_ready(tid)))
        finally:
            budget.release(60)
            seen.append(gov.get_and_reset_num_retry(4))
            seen.append(gov.get_and_reset_num_split_retry(4))
            gov.remove_current_dedicated_thread_association()

    t = threading.Thread(target=task)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "task hung"
    return seen + [budget.used]


def watchdog_breaks_deadlock(pkg, gov):
    """A single blocked task with nothing to wake it is broken by the
    watchdog: BLOCKED -> BUFN_THROW -> RetryOOM."""
    budget = pkg.mem.BudgetedResource(gov, limit_bytes=10)
    seen = []

    def task():
        gov.current_thread_is_dedicated_to_task(7)
        seen.append(_name(lambda: budget.acquire(50)))  # can never fit
        seen.append(gov.state_of_current_thread())
        gov.remove_current_dedicated_thread_association()

    t = threading.Thread(target=task)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "watchdog did not break the deadlock"
    return seen + [budget.used]


def thread_removed_while_blocked(pkg, gov):
    budget = pkg.mem.BudgetedResource(gov, limit_bytes=10)
    holder = {}
    seen = []
    started = threading.Event()

    def blocker():
        gov.current_thread_is_dedicated_to_task(3)
        holder["tid"] = pkg.mem.current_thread_id()
        started.set()
        seen.append(_name(lambda: budget.acquire(50)))

    gov.current_thread_is_dedicated_to_task(99)  # keeps the task set non-deadlocked
    t = threading.Thread(target=blocker)
    t.start()
    started.wait(timeout=10)
    wait_for(lambda: gov.arbiter.total_blocked_or_bufn() >= 1, msg="blocked")
    seen.append(gov.arbiter.state_of(holder["tid"]))
    gov.arbiter.remove_thread_association(holder["tid"], -1)
    t.join(timeout=30)
    assert not t.is_alive()
    gov.task_done(99)
    return seen + [gov.arbiter.total_blocked_or_bufn()]


def metrics(pkg, gov):
    arb, tid = gov.arbiter, pkg.mem.current_thread_id()
    budget = pkg.mem.BudgetedResource(gov, limit_bytes=100)
    gov.current_thread_is_dedicated_to_task(5)
    gov.start_retry_block()
    gov.force_retry_oom(num_ooms=3)
    raised = [_name(lambda: arb.pre_alloc(tid)) for _ in range(3)]
    gov.end_retry_block()
    seen = raised + [gov.get_and_reset_num_retry(5), gov.get_and_reset_num_retry(5),
                     gov.get_and_reset_compute_time_lost_ns(5) >= 0]
    done = threading.Event()

    def waiter():  # blocks behind task 5's reservation, then is woken
        gov.current_thread_is_dedicated_to_task(6)
        budget.acquire(50)
        budget.release(50)
        seen.append(gov.get_and_reset_block_time_ns(6) > 0)
        done.set()
        gov.remove_current_dedicated_thread_association()

    budget.acquire(90)
    t = threading.Thread(target=waiter)
    t.start()
    wait_for(lambda: gov.arbiter.total_blocked_or_bufn() >= 1, msg="waiter blocked")
    time.sleep(0.02)
    budget.release(90)
    t.join(timeout=30)
    assert not t.is_alive() and done.is_set()
    gov.task_done(5)
    return seen + [budget.used]


# scenario -> (what the scenario must observe, on both packages; whether the
# flight-event kinds are compared in order or as a set -- threads interleave)
SCENARIOS = {
    "injected_retry_and_split": (
        injected_retry_and_split,
        [0, "GpuRetryOOM", "GpuRetryOOM", False, "GpuSplitAndRetryOOM", False,
         "CpuRetryOOM", 3, 1, -1], "list"),
    "recursive_alloc": (recursive_alloc, [False, 1, True, "ValueError", 0], "list"),
    "block_and_wake_priority": (block_and_wake_priority, ["shuffle", "task", 0, 0], "set"),
    "bufn_escalation_to_split": (
        bufn_escalation_to_split,
        ["GpuRetryOOM", 5, "GpuSplitAndRetryOOM", 1, 1, 0], "list"),
    "watchdog_breaks_deadlock": (watchdog_breaks_deadlock, ["GpuRetryOOM", 5, 0], "list"),
    "thread_removed_while_blocked": (
        thread_removed_while_blocked, [3, "ThreadRemovedError", 0], "list"),
    "metrics": (metrics, ["GpuRetryOOM"] * 3 + [3, 0, True, True, 0], "set"),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_arbiter_scenario_matches_jax(name):
    scenario, want, kinds_as = SCENARIOS[name]
    port_seen, port_kinds = _run(PACKAGES["port"], scenario)
    jax_seen, jax_kinds = _run(PACKAGES["jax"], scenario)
    assert port_seen == jax_seen == want
    if kinds_as == "set":
        port_kinds, jax_kinds = sorted(set(port_kinds)), sorted(set(jax_kinds))
    assert port_kinds == jax_kinds
    assert port_kinds, "the scenario recorded no flight event"


def test_both_arbiters_run_side_by_side():
    """Both packages' governors at once in one process: two native
    libraries, two watchdogs, two flight rings, each budget on its own
    arbiter."""
    gj = jax_mem.MemoryGovernor(watchdog_period_s=0.05)
    gp = port_mem.MemoryGovernor(watchdog_period_s=0.05)
    try:
        assert gp.arbiter._lib._handle != gj.arbiter._lib._handle
        port_flight.recorder().reset_for_tests()
        jax_flight.recorder().reset_for_tests()
        gp.current_thread_is_dedicated_to_task(21)
        gj.current_thread_is_dedicated_to_task(22)
        with port_mem.task_context(gp, 23):
            pass
        bp = port_mem.BudgetedResource(gp, 64)
        bj = jax_mem.BudgetedResource(gj, 64)
        bp.acquire(64)
        bj.acquire(64)
        assert (bp.used, bj.used) == (64, 64)
        bp.release(64)
        bj.release(64)
        gp.task_done(21)
        gj.task_done(22)
        assert [e["task_id"] for e in port_flight.snapshot()] == [23, 23]
        assert jax_flight.snapshot() == []
    finally:
        gp.close()
        gj.close()


def test_port_library_lives_under_build_native():
    gov = port_mem.MemoryGovernor(watchdog_period_s=0.05)
    gov.close()
    lib = port_arbiter._LIB
    assert lib == port_arbiter.BUILD_DIR / "libtask_arbiter.so"
    assert port_arbiter.BUILD_DIR == (
        port_arbiter._PKG.parent / "build" / "native")
    assert os.path.commonpath([str(lib), REPO]) == REPO
    assert port_arbiter._SRC.name == "task_arbiter.cpp"
    assert port_arbiter._SRC.parent.name == "csrc"
    assert port_arbiter._lib._name == str(lib)
    assert lib.stat().st_mtime >= port_arbiter._SRC.stat().st_mtime


def test_port_never_builds_or_loads_the_jax_library(tmp_path):
    """In a fresh process the port builds and loads only its own library:
    the JAX package's ``native/libtask_arbiter.so`` is neither loaded nor
    touched."""
    jax_lib = jax_arbiter._LIB
    before = os.stat(jax_lib).st_mtime_ns if os.path.exists(jax_lib) else None
    code = (
        "import sys\n"
        "import spark_rapids_jni_tpu_torch.mem as m\n"
        "g = m.MemoryGovernor(watchdog_period_s=0.05)\n"
        "b = m.BudgetedResource(g, 8)\n"
        "with m.task_context(g, 1):\n"
        "    with m.reservation(b, 8):\n"
        "        pass\n"
        "maps = open('/proc/self/maps').read()\n"
        "g.close()\n"
        "assert 'spark_rapids_jni_tpu/native' not in maps, 'JAX library loaded'\n"
        "assert 'build/native/libtask_arbiter.so' in maps, 'port library not loaded'\n"
        "assert not any(k.split('.')[0] == 'spark_rapids_jni_tpu' or k == 'jax'\n"
        "               for k in sys.modules)\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
    after = os.stat(jax_lib).st_mtime_ns if os.path.exists(jax_lib) else None
    assert after == before
