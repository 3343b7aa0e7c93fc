"""Memory governor: the RmmSpark facade + device batch-admission resource
(PyTorch port of ``mem/governor.py``, framework-neutral as the JAX one).

Two layers, mirroring the reference split:

- :class:`MemoryGovernor` — the analog of RmmSpark.java's static facade +
  SparkResourceAdaptor.java's watchdog: thread/task registration, retry-block
  bracketing, OOM injection, per-task metrics, and a daemon polling
  ``checkAndBreakDeadlocks`` every 100ms (SparkResourceAdaptor.java:35-79).

- :class:`BudgetedResource` — where the reference interposes on RMM
  ``do_allocate`` (SparkResourceAdaptorJni.cpp:1731-1752), the port does
  not intercept PyTorch's CUDA caching allocator.  Governance instead
  happens at *batch admission*: a task reserves its working-set bytes from a budget before
  launching device work and releases them after.  The reserve/release calls
  drive the exact same native state machine (pre_alloc -> try -> post_alloc
  -> retry loop), so blocking, BUFN escalation, split-and-retry and deadlock
  breaking behave identically to the reference.
"""

from __future__ import annotations

import threading
import weakref
from typing import Optional

from spark_rapids_jni_tpu_torch.mem.arbiter import (
    Arbiter,
    OOM_ALL,
    OOM_CPU,
    OOM_GPU,
    STATE_RUNNING,
    STATE_UNKNOWN,
    current_thread_id,
)
from spark_rapids_jni_tpu_torch.obs import flight as _flight


class MemoryGovernor:
    """Singleton-style facade over one native arbiter + watchdog daemon."""

    _instance: Optional["MemoryGovernor"] = None
    _lock = threading.Lock()

    def __init__(self, log_path: str | None = None,
                 watchdog_period_s: float | None = None):
        if watchdog_period_s is None:
            from spark_rapids_jni_tpu_torch import config

            watchdog_period_s = config.get("watchdog_period_s")
        self.arbiter = Arbiter(log_path)
        _GOVERNORS.add(self)
        self._shutdown = threading.Event()
        self._watchdog = threading.Thread(
            target=self._watch, args=(watchdog_period_s,), daemon=True,
            name="memory-governor-watchdog",
        )
        self._watchdog.start()

    # -- lifecycle ----------------------------------------------------------
    @classmethod
    def initialize(cls, log_path: str | None = None) -> "MemoryGovernor":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(log_path)
            return cls._instance

    @classmethod
    def instance(cls) -> "MemoryGovernor":
        return cls.initialize()

    def close(self):
        """Stop the watchdog and release the native arbiter (instance-level
        teardown; `shutdown()` applies it to the singleton)."""
        self._shutdown.set()
        self._watchdog.join(timeout=2)
        self.arbiter.close()

    @classmethod
    def shutdown(cls):
        with cls._lock:
            if cls._instance is not None:
                cls._instance.close()
                cls._instance = None

    def _watch(self, period_s: float):
        # SparkResourceAdaptor.java:59-79 watchdog loop
        while not self._shutdown.wait(period_s):
            try:
                self.arbiter.check_and_break_deadlocks()
            # analyze: ignore[retry-protocol] - the watchdog daemon runs in
            # no task's retry bracket (a control signal here targets nobody)
            # and must survive everything, like the reference's daemon
            except Exception:  # pragma: no cover - defensive, mirrors daemon
                pass

    # -- thread/task association (RmmSpark.java:131-238) --------------------
    def current_thread_is_dedicated_to_task(self, task_id: int):
        self.arbiter.start_dedicated_task_thread(current_thread_id(), task_id)

    def shuffle_thread_working_on_tasks(self, task_ids):
        tid = current_thread_id()
        for task_id in task_ids:
            self.arbiter.pool_thread_working_on_task(tid, task_id, is_shuffle=True)

    def pool_thread_working_on_task(self, task_id: int):
        self.arbiter.pool_thread_working_on_task(current_thread_id(), task_id)

    def pool_thread_finished_for_task(self, task_id: int):
        self.arbiter.pool_thread_finished_for_task(current_thread_id(), task_id)

    def pool_thread_finished_for_tasks(self, task_ids):
        tid = current_thread_id()
        for task_id in task_ids:
            self.arbiter.pool_thread_finished_for_task(tid, task_id)

    # shuffle threads register/deregister through the same pool protocol
    shuffle_thread_finished_for_tasks = pool_thread_finished_for_tasks

    def remove_current_dedicated_thread_association(self, task_id: int = -1):
        self.arbiter.remove_thread_association(current_thread_id(), task_id)

    def remove_all_current_thread_association(self):
        """removeAllCurrentThreadAssociation (RmmSpark.java:323)."""
        self.arbiter.remove_thread_association(current_thread_id(), -1)

    # -- transitive pool blocking (RmmSpark.java:344-399) -------------------
    # A dedicated task thread that submits to / waits on a thread pool can be
    # transitively blocked by it; the deadlock detector must see it blocked.
    def submitting_to_pool(self):
        self.arbiter.set_pool_blocked(current_thread_id(), True)

    def waiting_on_pool(self):
        self.arbiter.set_pool_blocked(current_thread_id(), True)

    def done_waiting_on_pool(self):
        self.arbiter.set_pool_blocked(current_thread_id(), False)

    def task_done(self, task_id: int):
        self.arbiter.task_done(task_id)

    # -- retry blocks (RmmSpark.java:242-431) -------------------------------
    def start_retry_block(self):
        self.arbiter.start_retry_block(current_thread_id())

    def end_retry_block(self):
        self.arbiter.end_retry_block(current_thread_id())

    def block_thread_until_ready(self):
        self.arbiter.block_thread_until_ready(current_thread_id())

    # -- injection (RmmSpark.java:435-515) ----------------------------------
    def force_retry_oom(self, thread_id=None, num_ooms=1, oom_filter=OOM_GPU, skip_count=0):
        self.arbiter.force_retry_oom(
            thread_id if thread_id is not None else current_thread_id(),
            num_ooms, oom_filter, skip_count,
        )

    def force_split_and_retry_oom(self, thread_id=None, num_ooms=1, oom_filter=OOM_GPU,
                                  skip_count=0):
        self.arbiter.force_split_and_retry_oom(
            thread_id if thread_id is not None else current_thread_id(),
            num_ooms, oom_filter, skip_count,
        )

    def force_injected_exception(self, thread_id=None, num_times=1):
        self.arbiter.force_injected_exception(
            thread_id if thread_id is not None else current_thread_id(), num_times
        )

    # -- metrics (RmmSpark.java:533-590) ------------------------------------
    def get_and_reset_num_retry(self, task_id):
        return self.arbiter.get_and_reset_num_retry(task_id)

    def get_and_reset_num_split_retry(self, task_id):
        return self.arbiter.get_and_reset_num_split_retry(task_id)

    def get_and_reset_block_time_ns(self, task_id):
        return self.arbiter.get_and_reset_blocked_time_ns(task_id)

    def get_and_reset_compute_time_lost_ns(self, task_id):
        return self.arbiter.get_and_reset_compute_time_lost_ns(task_id)

    def state_of_current_thread(self):
        return self.arbiter.state_of(current_thread_id())


class OutOfBudget(MemoryError):
    """Raised by a budget when a reservation cannot be satisfied."""


# live budgets/governors, for memory-pressure gauges (serve metrics +
# flight dumps); weak so a dropped per-test instance never pins or
# double-counts
_BUDGETS: "weakref.WeakSet" = weakref.WeakSet()
_GOVERNORS: "weakref.WeakSet" = weakref.WeakSet()


def budget_gauges() -> dict:
    """Process-wide memory-pressure gauges: bytes in use / limits summed
    over live budgets (device vs host), plus the arbiters' parked-thread
    counts.  Non-destructive — safe for anomaly dumps and per-request
    metrics publishing."""
    out = {"device_bytes_in_use": 0, "device_bytes_limit": 0,
           "host_bytes_in_use": 0, "host_bytes_limit": 0,
           "blocked_or_bufn": 0, "blocked_ns_rolling": 0}
    for b in list(_BUDGETS):
        side = "host" if b.is_cpu else "device"
        out[f"{side}_bytes_in_use"] += b.used
        out[f"{side}_bytes_limit"] += b.limit
    for gov in list(_GOVERNORS):
        try:
            out["blocked_or_bufn"] += gov.arbiter.total_blocked_or_bufn()
        except RuntimeError:  # racing close(): this governor contributes 0
            pass
        out["blocked_ns_rolling"] += sum(
            gov.arbiter.rolling_blocked().values())
    return out


def rolling_blocked_gauges(window_s: float = 1.0) -> dict:
    """Per-task blocked-ns inside the trailing window, merged over live
    governors (the weak registry) — the trend gauge the admission
    controller subscribes to, also snapshotted into anomaly dumps."""
    per_task: dict = {}
    for gov in list(_GOVERNORS):
        for task, ns in gov.arbiter.rolling_blocked(window_s).items():
            per_task[task] = per_task.get(task, 0) + ns
    return {"window_s": window_s,
            "blocked_ns": sum(per_task.values()),
            "per_task": {str(t): n for t, n in per_task.items()}}


_flight.register_telemetry_source("governor", budget_gauges)
_flight.register_telemetry_source("blocked_rolling", rolling_blocked_gauges)


class BudgetedResource:
    """An HBM/host-memory budget driven through the arbiter's retry protocol.

    ``acquire(nbytes)`` is the analog of the reference's ``do_allocate`` loop
    (SparkResourceAdaptorJni.cpp:1731-1752): pre_alloc (injection + blocking),
    try the reservation, post_alloc_success on success; on OutOfBudget,
    post_alloc_failed (-> BLOCKED + BUFN escalation) and loop.  ``release``
    frees budget and wakes the highest-priority blocked thread, exactly like
    ``do_deallocate`` -> dealloc_core.
    """

    def __init__(self, governor: MemoryGovernor, limit_bytes: int, is_cpu: bool = False):
        self.gov = governor
        self.limit = limit_bytes
        self.used = 0
        self.peak = 0  # high-water mark of `used`; see reset_peak()
        self.is_cpu = is_cpu
        self._lock = threading.Lock()
        self._spill_handlers = []
        _BUDGETS.add(self)

    def register_spill_handler(self, handler) -> None:
        """``handler(shortfall_bytes) -> freed_bytes``: consulted between a
        failed reservation and the BLOCKED/BUFN escalation — the analog of
        the reference event handler's onAllocFailure spill ladder
        (RmmSpark.java:402-416 step 1: 'memory is freed by spilling')."""
        self._spill_handlers.append(handler)

    def unregister_spill_handler(self, handler) -> None:
        """Detach a handler (a closing SpillPool); missing is a no-op."""
        try:
            self._spill_handlers.remove(handler)
        except ValueError:
            pass

    def _try_reserve(self, nbytes: int) -> bool:
        with self._lock:
            if self.used + nbytes > self.limit:
                return False
            self.used += nbytes
            if self.used > self.peak:
                self.peak = self.used
            return True

    def try_acquire(self, nbytes: int) -> bool:
        """Opportunistic reservation: reserve ``nbytes`` if they fit RIGHT
        NOW, else return False — no arbiter bracket, no blocking, no
        Retry/Split escalation, no spill-handler consultation.  This is
        how CACHED residency (plans/rcache.py's HBM tier) takes budget:
        cached bytes must never park a thread or steal from live queries
        through the retry protocol — they squat on headroom and hand it
        back the moment pressure calls the spill handlers.  Pair every
        success with :meth:`release` (which wakes blocked tenants, so a
        cache demotion is immediately visible to parked live work)."""
        return self._try_reserve(int(nbytes))

    def try_admit(self, nbytes: int) -> bool:
        """One pass of :meth:`acquire`'s protocol that never parks: the
        arbiter's alloc bracket runs, so an injected RetryOOM or
        SplitAndRetryOOM fires here as it would in ``acquire``, and the
        spill handlers are asked for room; when the bytes still do not fit
        it returns False instead of blocking.  A thread the arbiter has
        parked or escalated (any state but running) returns False without
        trying: only ``acquire`` may serve its park."""
        arb = self.gov.arbiter
        tid = current_thread_id()
        if arb.state_of(tid) not in (STATE_RUNNING, STATE_UNKNOWN):
            return False
        likely_spill = arb.pre_alloc(tid, is_cpu=self.is_cpu, blocking=False)
        try:
            ok = self._try_reserve(nbytes) or (
                bool(self._spill_handlers) and self._spill_for(nbytes)
                and self._try_reserve(nbytes))
        except BaseException:
            arb.post_alloc_failed(tid, is_cpu=self.is_cpu, is_oom=False,
                                  blocking=False, was_recursive=likely_spill)
            raise
        if ok:
            arb.post_alloc_success(tid, is_cpu=self.is_cpu, was_recursive=likely_spill)
        else:
            arb.post_alloc_failed(tid, is_cpu=self.is_cpu, is_oom=False,
                                  blocking=False, was_recursive=likely_spill)
        return ok

    def reset_peak(self) -> int:
        """Return the reservation high-water mark and restart it from the
        current level (per-query peak reporting in the NDS harness)."""
        with self._lock:
            p = self.peak
            self.peak = self.used
            return p

    def _spill_for(self, nbytes: int) -> bool:
        """Ask registered spill handlers to free the shortfall; True if any
        bytes were reclaimed (caller then retries the reservation)."""
        if nbytes > self.limit:
            return False  # can never fit: don't wipe the cache for nothing
        with self._lock:
            shortfall = self.used + nbytes - self.limit
        if shortfall <= 0:
            return True
        freed = 0
        for h in self._spill_handlers:
            freed += h(shortfall - freed)
            if freed >= shortfall:
                break
        return freed > 0

    # Wasted block/wake cycles before a thread self-escalates to RetryOOM.
    # A woken thread that still cannot reserve re-blocks silently; a lively
    # low-footprint tenant (e.g. a shuffle thread cycling tiny buffers)
    # keeps every task looking "alive" to the deadlock detector while the
    # blocked threads hold-and-wait forever.  After this many futile wakes
    # the thread arms a RetryOOM injection and re-enters pre_alloc in
    # RUNNING state (post_alloc_failed(blocking=False)), so the throw uses
    # the normal, metric-counted injection path with no phantom-BLOCKED
    # entry left in the arbiter; the caller then rolls its held
    # allocations back to spillable state per the protocol
    # (RmmSpark.java:402-416 step 2) and the system can make progress.
    WASTED_WAKE_LIMIT = 50

    def acquire(self, nbytes: int) -> int:
        """Reserve ``nbytes``; blocks/raises RetryOOM per the state machine.

        Order on pressure matches the reference ladder: spill handlers
        first (reclaim idle cached data), then the arbiter's BLOCKED/BUFN
        escalation."""
        arb = self.gov.arbiter
        tid = current_thread_id()
        wasted = 0
        while True:
            likely_spill = arb.pre_alloc(tid, is_cpu=self.is_cpu, blocking=True)
            # True once post_alloc_failed has run for THIS pre_alloc (the
            # spill-failure path below); the outer OutOfBudget handler must
            # then re-raise instead of closing the bracket a second time —
            # a double post_alloc_failed corrupts arbiter thread state.
            bracket_closed = False
            try:
                if self._try_reserve(nbytes):
                    arb.post_alloc_success(tid, is_cpu=self.is_cpu, was_recursive=likely_spill)
                    return nbytes
                if self._spill_handlers:
                    try:
                        spilled = self._spill_for(nbytes)
                    except BaseException:
                        # a spill failure (incl. injected faults at the
                        # SPILL seam) must not escape mid-protocol: close
                        # the alloc bracket first so the thread returns to
                        # RUNNING and the next pre_alloc is not misread as
                        # a recursive/spill allocation
                        bracket_closed = True
                        arb.post_alloc_failed(
                            tid, is_cpu=self.is_cpu, is_oom=False,
                            blocking=False, was_recursive=likely_spill)
                        raise
                    if spilled and self._try_reserve(nbytes):
                        arb.post_alloc_success(tid, is_cpu=self.is_cpu,
                                               was_recursive=likely_spill)
                        return nbytes
                raise OutOfBudget(f"out of budget: {nbytes} requested, "
                                  f"{self.limit - self.used} available")
            except OutOfBudget:
                if bracket_closed:
                    # originated inside _spill_for (a handler that itself
                    # allocates budget, per the recursive-alloc protocol);
                    # the bracket is already closed — just propagate
                    raise
                wasted += 1
                escalate = wasted >= self.WASTED_WAKE_LIMIT
                if escalate:
                    self.gov.force_retry_oom(
                        thread_id=tid, num_ooms=1,
                        oom_filter=OOM_CPU if self.is_cpu else OOM_GPU)
                if not arb.post_alloc_failed(
                    tid, is_cpu=self.is_cpu, is_oom=True,
                    blocking=not escalate,  # escalation path must NOT park
                    was_recursive=likely_spill,
                ):
                    raise

    def release(self, nbytes: int):
        with self._lock:
            self.used -= nbytes
        self.gov.arbiter.dealloc(current_thread_id(), is_cpu=self.is_cpu)


__all__ = [
    "BudgetedResource",
    "MemoryGovernor",
    "OutOfBudget",
    "OOM_ALL",
    "OOM_CPU",
    "OOM_GPU",
]
