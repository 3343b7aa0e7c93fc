"""ctypes bindings + lifecycle for the native task arbiter (PyTorch port of
``mem/arbiter.py``).

The native core (``csrc/task_arbiter.cpp``, a byte-for-byte copy of the JAX
package's ``native/task_arbiter.cpp``) is the re-expression of the
reference's SparkResourceAdaptorJni state machine; this module is the analog
of the JNI shim: build the library from the port's source on first use, load
it, map return codes onto the exception hierarchy, and pin the thread-id
convention (python ``threading.get_ident()``).

The port builds its own ``libtask_arbiter.so`` into ``build/native/`` at the
repository root and never reads, loads or writes the JAX package's.  It is
loaded with ctypes' default ``RTLD_LOCAL``, so both packages' arbiters can
live in one process without their C symbols clashing.  A build or load that
fails raises: nothing runs ungoverned.
"""

from __future__ import annotations

import collections
import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

from spark_rapids_jni_tpu_torch.mem import exceptions as exc
from spark_rapids_jni_tpu_torch.obs import flight as _flight

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "task_arbiter.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
_LIB = BUILD_DIR / "libtask_arbiter.so"

# return codes (task_arbiter.cpp arbiter_code)
OK = 0
RECURSIVE = 1
_CODE_TO_EXC = {
    -1: exc.GpuRetryOOM,
    -2: exc.GpuSplitAndRetryOOM,
    -3: exc.CpuRetryOOM,
    -4: exc.CpuSplitAndRetryOOM,
    -5: exc.InjectedException,
    -6: exc.GpuOOM,
    -7: exc.ThreadRemovedError,
    -8: ValueError,
    -9: RuntimeError,
}

# thread_state values (task_arbiter.cpp / RmmSparkThreadState.java)
STATE_UNKNOWN = -1
STATE_RUNNING = 0
STATE_ALLOC = 1
STATE_ALLOC_FREE = 2
STATE_BLOCKED = 3
STATE_BUFN_THROW = 4
STATE_BUFN_WAIT = 5
STATE_BUFN = 6
STATE_SPLIT_THROW = 7
STATE_REMOVE_THROW = 8

# throw codes that, returned from a *parked* native call, mean the deadlock
# detector escalated the waiting thread (the break verdict; see _parked)
_BREAK_CODES = frozenset({-1, -2, -3, -4})

# oom filter bits (OomInjectionType): CPU=1, GPU=2, ALL=3
OOM_CPU = 1
OOM_GPU = 2
OOM_ALL = 3

# metric selectors
METRIC_RETRY_COUNT = 0
METRIC_SPLIT_RETRY_COUNT = 1
METRIC_BLOCKED_NS = 2
METRIC_LOST_NS = 3

_build_lock = threading.Lock()
_lib = None


def _ensure_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # built under a per-process name and renamed into place, so
            # processes building at once never load a half-written file
            tmp = _LIB.with_suffix(f".{os.getpid()}.tmp")
            # analyze: ignore[blocking-under-lock] - one-shot native
            # build at first use, serialized BY DESIGN: _build_lock
            # exists precisely so concurrent first-callers wait for the
            # single g++ run instead of racing the .so write; no task,
            # arbiter, or serving thread exists yet to stall behind it
            subprocess.run(
                ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                 str(_SRC), "-lpthread"],
                check=True,
                capture_output=True,
            )
            os.replace(tmp, _LIB)
        lib = ctypes.CDLL(str(_LIB))
        lib.arbiter_create.restype = ctypes.c_void_p
        lib.arbiter_create.argtypes = [ctypes.c_char_p]
        lib.arbiter_destroy.argtypes = [ctypes.c_void_p]
        lib.arbiter_last_error.restype = ctypes.c_char_p
        i64 = ctypes.c_int64
        for name, args, res in [
            ("arbiter_start_dedicated_task_thread", [ctypes.c_void_p, i64, i64], ctypes.c_int),
            ("arbiter_pool_thread_working_on_task", [ctypes.c_void_p, i64, i64, ctypes.c_int], ctypes.c_int),  # noqa
            ("arbiter_pool_thread_finished_for_task", [ctypes.c_void_p, i64, i64], ctypes.c_int),
            ("arbiter_remove_thread_association", [ctypes.c_void_p, i64, i64], ctypes.c_int),
            ("arbiter_task_done", [ctypes.c_void_p, i64], ctypes.c_int),
            ("arbiter_set_pool_blocked", [ctypes.c_void_p, i64, ctypes.c_int], ctypes.c_int),
            ("arbiter_set_externally_blocked", [ctypes.c_void_p, i64, ctypes.c_int], ctypes.c_int),
            ("arbiter_start_retry_block", [ctypes.c_void_p, i64], ctypes.c_int),
            ("arbiter_end_retry_block", [ctypes.c_void_p, i64], ctypes.c_int),
            ("arbiter_force_retry_oom", [ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int], ctypes.c_int),  # noqa
            ("arbiter_force_split_and_retry_oom", [ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int], ctypes.c_int),  # noqa
            ("arbiter_force_cudf_exception", [ctypes.c_void_p, i64, ctypes.c_int], ctypes.c_int),
            ("arbiter_pre_alloc", [ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_int], ctypes.c_int),
            ("arbiter_post_alloc_success", [ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_int], ctypes.c_int),  # noqa
            ("arbiter_post_alloc_failed", [ctypes.c_void_p, i64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int], ctypes.c_int),  # noqa
            ("arbiter_dealloc", [ctypes.c_void_p, i64, ctypes.c_int], ctypes.c_int),
            ("arbiter_block_thread_until_ready", [ctypes.c_void_p, i64], ctypes.c_int),
            ("arbiter_check_and_break_deadlocks", [ctypes.c_void_p], ctypes.c_int),
            ("arbiter_get_state_of", [ctypes.c_void_p, i64], ctypes.c_int),
            ("arbiter_get_and_reset_metric", [ctypes.c_void_p, i64, ctypes.c_int], i64),
            ("arbiter_get_total_blocked_or_bufn", [ctypes.c_void_p], i64),
        ]:
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
        return _lib


def current_thread_id() -> int:
    return threading.get_ident()


class Arbiter:
    """Handle to one native arbiter instance."""

    def __init__(self, log_path: str | None = None):
        self._lib = _ensure_lib()
        self._h = self._lib.arbiter_create(
            log_path.encode() if log_path else None
        )
        if not self._h:
            raise RuntimeError("failed to create native arbiter")
        # thread -> task association mirror, so flight-recorder events can
        # carry task ids (the native map is not introspectable per thread)
        self._task_map_lock = threading.Lock()
        self._task_of: dict[int, int] = {}  # guarded-by: _task_map_lock
        # thread -> monotonic_ns at which post_alloc_failed parked it
        # (state BLOCKED): the park is *served* inside the thread's next
        # pre_alloc, which closes the window.  Keys are touched only by
        # the owning thread (GIL-atomic dict ops, no lock needed).
        self._blocked_at: dict[int, int] = {}
        # thread -> park start for block_thread_until_ready (closed in the
        # same call); same owning-thread-only discipline as _blocked_at
        self._until_ready_at: dict[int, int] = {}
        # rolling log of CLOSED blocked windows: (close_t_ns, task_id,
        # wait_ns).  Bounded deque, GIL-atomic appends — feeds the
        # rolling_blocked() trend gauge the admission controller steers
        # from (cumulative per-task totals live in the flight recorder;
        # a controller needs the trailing-window rate, not lifetime sums).
        self._recent_blocked: "collections.deque" = collections.deque(
            maxlen=1024)

    def close(self):
        # null the handle *before* destroying it: gauge samplers on other
        # threads (governor.budget_gauges -> total_blocked_or_bufn) guard
        # on the handle property, and must fail that guard rather than
        # race a native call against the free
        # analyze: ignore[unguarded-shared-state] - single-owner lifecycle
        # teardown, pre-dating the task-map lock (which guards only the
        # thread->task mirror, not the handle)
        h, self._h = self._h, None
        if h:
            self._lib.arbiter_destroy(h)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    @property
    def handle(self):
        """Native handle; raises instead of passing NULL into the C API
        after close() (a stale cached facade would otherwise segfault)."""
        h = self._h
        if not h:
            raise RuntimeError("arbiter is closed")
        return h

    def _check(self, code: int) -> int:
        if code >= 0:
            return code
        err = self._lib.arbiter_last_error().decode()
        e_cls = _CODE_TO_EXC.get(code, RuntimeError)
        # surface retry/split signal deliveries to the flight recorder:
        # the native machine returns throw codes to the calling thread, so
        # the current thread is the signal's target
        if e_cls in (exc.GpuRetryOOM, exc.CpuRetryOOM):
            _flight.record(_flight.EV_RETRY,
                           self.task_of(current_thread_id()),
                           detail=e_cls.__name__)
        elif e_cls in (exc.GpuSplitAndRetryOOM, exc.CpuSplitAndRetryOOM):
            _flight.record(_flight.EV_SPLIT_RETRY,
                           self.task_of(current_thread_id()),
                           detail=e_cls.__name__)
        raise e_cls(err)

    def task_of(self, thread_id) -> int:
        """Primary task associated with ``thread_id`` (-1 when none)."""
        with self._task_map_lock:
            return self._task_of.get(thread_id, -1)

    # registration ----------------------------------------------------------
    def start_dedicated_task_thread(self, thread_id, task_id):
        self._check(self._lib.arbiter_start_dedicated_task_thread(self.handle, thread_id, task_id))
        with self._task_map_lock:
            self._task_of[thread_id] = task_id

    def pool_thread_working_on_task(self, thread_id, task_id, is_shuffle=False):
        self._check(
            self._lib.arbiter_pool_thread_working_on_task(
                self.handle, thread_id, task_id, is_shuffle)
        )
        with self._task_map_lock:
            self._task_of[thread_id] = task_id

    def pool_thread_finished_for_task(self, thread_id, task_id):
        self._check(self._lib.arbiter_pool_thread_finished_for_task(
            self.handle, thread_id, task_id))
        with self._task_map_lock:
            if self._task_of.get(thread_id) == task_id:
                del self._task_of[thread_id]

    def remove_thread_association(self, thread_id, task_id=-1):
        self._check(self._lib.arbiter_remove_thread_association(self.handle, thread_id, task_id))
        with self._task_map_lock:
            if task_id == -1 or self._task_of.get(thread_id) == task_id:
                self._task_of.pop(thread_id, None)
        self._blocked_at.pop(thread_id, None)  # no pre_alloc will close it
        self._until_ready_at.pop(thread_id, None)

    def task_done(self, task_id):
        self._check(self._lib.arbiter_task_done(self.handle, task_id))
        with self._task_map_lock:
            for tid in [t for t, task in self._task_of.items()
                        if task == task_id]:
                del self._task_of[tid]

    def set_pool_blocked(self, thread_id, blocked):
        self._check(self._lib.arbiter_set_pool_blocked(self.handle, thread_id, blocked))

    def set_externally_blocked(self, thread_id, blocked):
        self._check(self._lib.arbiter_set_externally_blocked(self.handle, thread_id, blocked))

    # retry / injection -----------------------------------------------------
    def start_retry_block(self, thread_id):
        self._check(self._lib.arbiter_start_retry_block(self.handle, thread_id))

    def end_retry_block(self, thread_id):
        self._check(self._lib.arbiter_end_retry_block(self.handle, thread_id))

    def force_retry_oom(self, thread_id, num_ooms, oom_filter=OOM_GPU, skip_count=0):
        self._check(
            self._lib.arbiter_force_retry_oom(
                self.handle, thread_id, num_ooms, oom_filter, skip_count)
        )

    def force_split_and_retry_oom(self, thread_id, num_ooms, oom_filter=OOM_GPU, skip_count=0):
        self._check(
            self._lib.arbiter_force_split_and_retry_oom(
                self.handle, thread_id, num_ooms, oom_filter, skip_count
            )
        )

    def force_injected_exception(self, thread_id, num_times):
        self._check(self._lib.arbiter_force_cudf_exception(self.handle, thread_id, num_times))

    # alloc protocol --------------------------------------------------------
    def pre_alloc(self, thread_id, is_cpu=False, blocking=True) -> bool:
        """True if this is a recursive (spill) allocation."""
        code = self._lib.arbiter_pre_alloc(self.handle, thread_id, is_cpu,
                                           blocking)
        t0 = self._blocked_at.pop(thread_id, None)
        if t0 is not None:
            # this pre_alloc served the park the previous post_alloc_failed
            # opened (block_thread_until_ready_core runs inside it); close
            # the blocked window, and surface a deadlock-break verdict if
            # the wait ended in a retry/split throw — the detector's BUFN
            # escalation is the only source of those on a parked thread
            # (forced injections fire before the park and count as normal
            # retries via _check)
            now = time.monotonic_ns()
            wait_ns = now - t0
            task = self.task_of(thread_id)
            self._recent_blocked.append((now, task, wait_ns))
            broke = code in _BREAK_CODES
            if broke:
                _flight.record(_flight.EV_DEADLOCK_VERDICT, task,
                               detail=_CODE_TO_EXC[code].__name__)
            _flight.record(
                _flight.EV_TASK_WOKEN, task,
                detail=f"alloc:{'threw' if code < 0 else 'ready'}",
                value=wait_ns)
            if broke:
                _flight.anomaly("deadlock_broken",
                                detail=f"task={task} thread={thread_id} "
                                       f"{_CODE_TO_EXC[code].__name__}")
        return self._check(code) == RECURSIVE

    def post_alloc_success(self, thread_id, is_cpu=False, was_recursive=False):
        self._check(
            self._lib.arbiter_post_alloc_success(self.handle, thread_id, is_cpu, was_recursive)
        )

    def post_alloc_failed(self, thread_id, is_cpu=False, is_oom=True, blocking=True,
                          was_recursive=False) -> bool:
        """True if the allocation should be retried."""
        ret = self._check(self._lib.arbiter_post_alloc_failed(
            self.handle, thread_id, is_cpu, is_oom, blocking, was_recursive
        )) == 1
        if ret and blocking and is_oom:
            # the thread is now in state BLOCKED; the park itself is
            # served by the thread's next pre_alloc, which closes this
            # window with a WOKEN event (and possibly a break verdict).
            # analyze: ignore[unguarded-shared-state] - each key is
            # written/popped only by its owning thread (GIL-atomic dict
            # ops); the flight hot path must stay lock-free
            self._blocked_at[thread_id] = time.monotonic_ns()
            _flight.record(_flight.EV_TASK_BLOCKED,
                           self.task_of(thread_id),
                           detail=f"alloc:{'cpu' if is_cpu else 'dev'}")
        return ret

    def dealloc(self, thread_id, is_cpu=False):
        self._check(self._lib.arbiter_dealloc(self.handle, thread_id, is_cpu))

    def block_thread_until_ready(self, thread_id):
        """Park until the arbiter readies this thread, bracketed by
        BLOCKED / WOKEN flight events; a retry/split throw delivered into
        the park is the deadlock detector's break verdict, surfaced
        race-free on the victim's own thread (anomaly-dumped with the
        history already in the ring)."""
        task = self.task_of(thread_id)
        _flight.record(_flight.EV_TASK_BLOCKED, task, detail="until_ready")
        t0 = time.monotonic_ns()
        # analyze: ignore[unguarded-shared-state] - owning-thread-only key,
        # same GIL-atomic discipline as _blocked_at (lock-free park path)
        self._until_ready_at[thread_id] = t0
        try:
            code = self._lib.arbiter_block_thread_until_ready(
                self.handle, thread_id)
        finally:
            self._until_ready_at.pop(thread_id, None)
        now = time.monotonic_ns()
        wait_ns = now - t0
        self._recent_blocked.append((now, task, wait_ns))
        broke = code in _BREAK_CODES
        if broke:
            _flight.record(_flight.EV_DEADLOCK_VERDICT, task,
                           detail=_CODE_TO_EXC[code].__name__)
        _flight.record(
            _flight.EV_TASK_WOKEN, task,
            detail=f"until_ready:{'threw' if code < 0 else 'ready'}",
            value=wait_ns)
        if broke:
            _flight.anomaly("deadlock_broken",
                            detail=f"task={task} thread={thread_id} "
                                   f"{_CODE_TO_EXC[code].__name__}")
        self._check(code)

    def check_and_break_deadlocks(self):
        """Run the deadlock detector.  Break *verdicts* are surfaced by
        the victims themselves (see :meth:`_parked`): a woken thread knows
        it was escalated, while a post-hoc state sweep here would race the
        victims consuming their signals."""
        self._check(self._lib.arbiter_check_and_break_deadlocks(self.handle))

    # introspection ---------------------------------------------------------
    def rolling_blocked(self, window_s: float = 1.0) -> dict:
        """Per-task blocked-ns observed within the trailing window — the
        pressure TREND the admission controller steers from, as opposed to
        the flight recorder's cumulative lifetime accumulators.

        Closed windows contribute up to the portion inside the window
        (clamped by close time); parks still in progress (post_alloc_failed
        or block_thread_until_ready) contribute their elapsed time, so a
        hard stall reads as rising pressure instead of zero.  Pure python
        state — safe to sample from any thread, even mid-close."""
        now = time.monotonic_ns()
        cutoff = now - int(window_s * 1e9)
        out: dict = {}
        for t_close, task, ns in list(self._recent_blocked):
            if t_close >= cutoff:
                part = min(int(ns), t_close - cutoff)
                out[task] = out.get(task, 0) + part
        for open_map in (self._blocked_at, self._until_ready_at):
            for tid, t0 in list(open_map.items()):
                task = self.task_of(tid)
                out[task] = out.get(task, 0) + (now - max(t0, cutoff))
        return out

    def state_of(self, thread_id) -> int:
        return self._lib.arbiter_get_state_of(self.handle, thread_id)

    def get_and_reset_num_retry(self, task_id) -> int:
        return self._lib.arbiter_get_and_reset_metric(self.handle, task_id, METRIC_RETRY_COUNT)

    def get_and_reset_num_split_retry(self, task_id) -> int:
        return self._lib.arbiter_get_and_reset_metric(
            self.handle, task_id, METRIC_SPLIT_RETRY_COUNT)

    def get_and_reset_blocked_time_ns(self, task_id) -> int:
        return self._lib.arbiter_get_and_reset_metric(self.handle, task_id, METRIC_BLOCKED_NS)

    def get_and_reset_compute_time_lost_ns(self, task_id) -> int:
        return self._lib.arbiter_get_and_reset_metric(self.handle, task_id, METRIC_LOST_NS)

    def total_blocked_or_bufn(self) -> int:
        return self._lib.arbiter_get_total_blocked_or_bufn(self.handle)
