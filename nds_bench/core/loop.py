"""The closed loop of an executor's task threads.

Spark's shape: each task thread takes the next task, registers the task id
with the memory governor as its dedicated thread, hands the task's batch to
the port's governed entry point, and takes the next task only when the
answer is on the host.  A task's latency runs from the moment its thread
took it to the moment its answer is back.  The governor's per-task counters
are read inside the task, before it ends.
"""

from __future__ import annotations

import dataclasses
import itertools
import sys
import threading
import time
import traceback
from typing import Any, Callable, List, Optional


@dataclasses.dataclass
class Pool:
    """A cell's tasks, made in set-up from the seed, and what they share (a
    query's dimension tables)."""

    tasks: List[dict]
    shared: dict


@dataclasses.dataclass
class TaskRecord:
    thread: int
    seq: int  # order in which the task was taken
    pool_index: int
    task_id: int
    rows: int
    t0: float  # perf_counter seconds
    t1: float
    answer: Any = None
    error: Optional[str] = None
    splits: int = 0  # the arbiter's split-and-retry count for the task
    retries: int = 0
    block_ns: int = 0
    rank: int = 0
    least_bytes: int = 0  # the least bytes the task must move (the query's count)

    @property
    def latency_s(self) -> float:
        return self.t1 - self.t0


class TaskThreads:
    """``threads`` task threads over a pool, running ``run(thread, task,
    task_id)``; ``gov`` is the port's ``MemoryGovernor``.  ``thread_init``
    runs first in every thread (binding it to its card).  With ``agree``
    (one function a thread, for several ranks), thread ``t`` takes every
    ``threads``-th task of the pool's order from ``t`` on, as the same
    thread does on every rank, and takes one only where ``agree[t]`` says
    the window is open on every rank."""

    def __init__(self, run: Callable, pool: List[dict], threads: int, gov,
                 task_context: Callable, offset: int, rows_of: Callable,
                 thread_init: Optional[Callable[[], None]] = None,
                 agree: Optional[List[Callable[[bool], bool]]] = None):
        self.run, self.pool, self.threads, self.gov = run, pool, threads, gov
        self.task_context, self.offset, self.rows_of = task_context, offset, rows_of
        self.thread_init, self.agree = thread_init, agree
        self._lock = threading.Lock()
        self._next = 0  # guarded-by: _lock
        self.records: List[TaskRecord] = []  # guarded-by: _lock

    def _one(self, thread: int, seq: int, pool_index: int, task_id: int) -> TaskRecord:
        task = self.pool[pool_index]
        rec = TaskRecord(thread, seq, pool_index, task_id, self.rows_of(task), 0.0, 0.0)
        rec.t0 = time.perf_counter()
        with self.task_context(self.gov, task_id):
            try:
                rec.answer = self.run(thread, task, task_id)
            # analyze: ignore[retry-protocol] - the task's boundary, outside
            # the entry point's retry bracket: a control signal that escapes
            # it is the task failing, counted and reported as failed while
            # the loop goes on, as an executor's other tasks do
            except Exception:  # noqa: BLE001
                rec.error = traceback.format_exc(limit=8)
                sys.stderr.write(f"task {task_id} failed:\n{rec.error}\n")
            rec.t1 = time.perf_counter()
            rec.splits = int(self.gov.get_and_reset_num_split_retry(task_id))
            rec.retries = int(self.gov.get_and_reset_num_retry(task_id))
            rec.block_ns = int(self.gov.get_and_reset_block_time_ns(task_id))
        return rec

    def warm(self, per_thread: int, task_id_base: int) -> List[TaskRecord]:
        """Each thread runs ``per_thread`` consecutive tasks of the pool, all
        threads at once, so that every thread's executors, communicators and
        allocator blocks exist before the window."""
        out: List[TaskRecord] = []

        def body(thread):
            if self.thread_init is not None:
                self.thread_init()
            for k in range(per_thread):
                seq = thread * per_thread + k
                rec = self._one(thread, seq, (self.offset + seq) % len(self.pool),
                                task_id_base + seq)
                with self._lock:
                    out.append(rec)

        _run_threads(body, self.threads)
        return out

    def window(self, t_end: float, task_id_base: int) -> Callable:
        """Start the threads, which run until ``t_end`` (perf_counter): a
        thread takes no task after it; the tasks in flight then finish.
        Returns the function that joins the threads."""

        def body(thread):
            if self.thread_init is not None:
                self.thread_init()
            for k in itertools.count():
                if self.agree is not None:
                    if not self.agree[thread](time.perf_counter() < t_end):
                        return
                    seq = k * self.threads + thread
                else:
                    with self._lock:
                        if time.perf_counter() >= t_end:
                            return
                        seq = self._next
                        self._next += 1
                rec = self._one(thread, seq, (self.offset + seq) % len(self.pool),
                                task_id_base + seq)
                with self._lock:
                    self.records.append(rec)

        return _start_threads(body, self.threads)


def _run_threads(body: Callable[[int], None], n: int) -> None:
    _start_threads(body, n)()


def _start_threads(body: Callable[[int], None], n: int) -> Callable[..., None]:
    """Start ``n`` threads running ``body(i)``; returns their join, which
    raises the first error a thread raised."""
    errors: List[BaseException] = []

    def guarded(i):
        try:
            body(i)
        # analyze: ignore[retry-protocol] - not swallowed: re-raised in the
        # joining thread
        except BaseException as e:
            errors.append(e)

    ts = [threading.Thread(target=guarded, args=(i,), name=f"task-thread-{i}")
          for i in range(n)]
    for t in ts:
        t.start()

    def join(timeout_s: float = 300.0) -> None:
        deadline = time.monotonic() + timeout_s
        for t in ts:
            t.join(max(0.0, deadline - time.monotonic()))
        if any(t.is_alive() for t in ts):
            raise TimeoutError(f"a task thread is still running after {timeout_s} s")
        if errors:
            raise errors[0]

    return join
