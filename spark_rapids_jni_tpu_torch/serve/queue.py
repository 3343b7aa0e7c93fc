"""Bounded admission queue with priorities, deadlines, and backpressure (a
copy of the JAX package's ``serve/queue.py``).

The front door of the serving engine (serve/executor.py).  Shape mirrors the
admission discipline the reference's resource adaptor applies *inside* the
device — task-priority ordering, bounded occupancy, reject-don't-collapse —
lifted to the request level, where a multi-tenant front end must apply it
first (Sparkle, arXiv:1708.05746 §3: admission control on shared-memory
analytics is the difference between graceful and collapsed overload).

Contract (what test_serve_queue.py pins):

- ``submit`` on a full queue raises :class:`Backpressure` carrying a
  ``retry_after_s`` hint — the request is REJECTED, never silently dropped
  or blocked (the caller owns its retry policy).
- ``pop`` returns the highest-priority (then oldest) live request; requests
  whose deadline has passed are completed as timed-out on the way (a clean
  terminal state, not a drop).
- ``close`` completes every still-queued request as cancelled: after
  shutdown every submitted request has reached a terminal state — the
  zero-lost-requests invariant the serve bench asserts.
- Requests re-queued by the executor (split halves) bypass the occupancy
  bound: rejecting them would LOSE an admitted request's work, and their
  parent's slot was already accounted at submit time.
"""

from __future__ import annotations

import dataclasses
import heapq
import threading
import time
from typing import Any, Callable, List, Optional

__all__ = ["AdmissionQueue", "Backpressure", "Request", "RequestTimeout",
           "Response"]


class Backpressure(Exception):
    """Queue full: retry after ``retry_after_s`` (HTTP 429 analog)."""

    def __init__(self, msg: str, retry_after_s: float):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class RequestTimeout(Exception):
    """The request's deadline expired before it finished."""


# terminal response statuses (PENDING is the only non-terminal one)
PENDING = "pending"
OK = "ok"
ERROR = "error"
TIMED_OUT = "timed_out"
CANCELLED = "cancelled"

# Request terminal-state machine, checked by the analyze gate: the ONLY
# legal move is pending -> one terminal, exactly once (_complete's
# first-completion-wins contract — the zero-lost invariant every chaos
# bench asserts reduces to "every request leaves pending exactly once").
# state-machine: response field=status
_RESPONSE_TRANSITIONS = {
    PENDING: (OK, ERROR, TIMED_OUT, CANCELLED),
    OK: (),
    ERROR: (),
    TIMED_OUT: (),
    CANCELLED: (),
}


class Response:
    """Completion handle for one submitted request (a minimal future)."""

    def __init__(self):
        self._done = threading.Event()
        self._lock = threading.Lock()
        self.status = PENDING
        self.value: Any = None
        self.error: Optional[BaseException] = None
        # lifecycle timestamps (monotonic ns): set by the queue/executor
        self.submitted_ns = 0
        self.admitted_ns = 0
        self.finished_ns = 0
        # the owning request's governor task id (stamped by Request):
        # cross-process callers (serve/rpc.py executor workers) correlate
        # this engine-local id with the supervisor's lease id in the
        # flight ring, keying the --cluster timeline merge
        self.task_id = 0
        # the request's trace context (obs/trace.py, stamped by Request):
        # clients holding only the Response can still find their span
        # chain in the live timeline
        self.trace = None

    def _complete(self, status: str, value: Any = None,
                  error: Optional[BaseException] = None) -> bool:
        """First completion wins (timeout vs. result races are benign)."""
        with self._lock:
            if self.status != PENDING:
                return False
            # transition: response pending->* (the != PENDING early
            # return above IS the from-state guard; status is whichever
            # terminal the caller reached first)
            self.status = status
            self.value = value
            self.error = error
            self.finished_ns = time.monotonic_ns()
        self._done.set()
        return True

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block for the result; raise the failure for non-OK terminals."""
        if not self._done.wait(timeout):
            raise TimeoutError("response not ready")
        if self.status == OK:
            return self.value
        if self.status == TIMED_OUT:
            raise RequestTimeout(str(self.error) if self.error else
                                 "request deadline expired")
        if self.status == CANCELLED:
            raise RuntimeError("request cancelled (engine shut down)")
        raise self.error  # ERROR: the handler's exception, unwrapped


@dataclasses.dataclass
class Request:
    """One queued unit of work (created by the engine's ``submit``)."""

    handler: str
    payload: Any
    session_id: str
    priority: int            # higher pops first (within: FIFO by seq)
    deadline: Optional[float]  # absolute time.monotonic(), None = none
    seq: int                 # global submit order; also the tiebreaker
    task_id: int             # governor task id (arbiter priority follows it)
    response: Response = dataclasses.field(default_factory=Response)
    boost: int = 0           # priority-aging bonus (controller-set; the
    #                          effective pop priority is priority + boost)
    split_depth: int = 0     # how many split-requeues produced this piece
    no_batch: bool = False   # excluded from micro-batching (post-split)
    join: Any = None         # _SplitJoin linking a half to its parent
    join_slot: int = 0
    session: Any = None      # set for client-facing requests (not halves):
    charge_bytes: int = 0    # session byte-budget charge to credit back
    # per-tenant attribution (round 21): the billing identity this
    # request's costs roll up under — defaults to the session id at
    # submit, crosses the pipe in MSG_DISPATCH, and lands in the
    # worker-side EV_ATTRIB record (serve/attribution.py); `attrib` is
    # the live AttributionRecord, created when the request first serves
    # and emitted as EV_ATTRIB by the terminal-state owner
    tenant: str = ""
    attrib: Any = None
    # cross-process shuffle lineage (serve/supervisor.py round 13): the
    # parent of a shuffle carries its sid (map_index -1); each child is
    # map task map_index of that sid, so lease grants keep the
    # supervisor's partition map pointed at the current incarnation
    shuffle_sid: Optional[int] = None
    shuffle_map_index: int = -1
    # distributed request spans (obs/trace.py, round 14): the request's
    # trace context (split/fan-out children carry a child context with
    # the SAME rid lineage), plus the open phase-span handles the
    # executor/supervisor bracket around queue wait and dispatch — the
    # live queue -> dispatch -> compute waterfall keys off these
    trace: Any = None            # Optional[obs.trace.TraceContext]
    qspan: Any = None            # open queue-wait SpanHandle (or None)
    dspan: Any = None            # open dispatch SpanHandle (supervisor)
    # result-cache lineage (plans/rcache.py, round 15): the key this
    # request missed on at admission, stamped so the completion path
    # stores the computed result under the SAME (content, version)
    # fingerprint the miss was judged on — put() revalidates rcache_deps
    # against the live registry, closing the bump-mid-flight window
    rcache_key: Any = None
    rcache_deps: Any = None

    def __post_init__(self):
        self.response.task_id = self.task_id
        self.response.trace = self.trace

    def expired(self, now: Optional[float] = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)


class AdmissionQueue:
    """Bounded priority queue; the only producer-facing surface is submit."""

    def __init__(self, maxsize: int,
                 retry_after_hint: Optional[Callable[[int], float]] = None,
                 on_timeout: Optional[Callable[[Request], None]] = None):
        if maxsize <= 0:
            raise ValueError("maxsize must be positive")
        self.maxsize = maxsize  # guarded-by: _cond
        # (-priority, seq, Request) entries  # guarded-by: _cond
        self._heap: List[tuple] = []
        self._cond = threading.Condition()
        self._closed = False  # guarded-by: _cond
        # requests handed to a consumer and not yet returned via
        # task_done(); outstanding() = queued + handed-out, the quantity
        # a drain must watch (a popped-but-unfinished request is neither
        # in the heap nor idle — the engine's shutdown race, review r1)
        self._handed_out = 0  # guarded-by: _cond
        # default hint: linear in occupancy — a full queue of slow requests
        # asks for a longer backoff than a just-full one (the engine
        # replaces this with an EWMA-of-service-time estimate)
        self._retry_after_hint = retry_after_hint or (
            lambda depth: min(1.0, 0.005 * max(depth, 1)))
        self._on_timeout = on_timeout or (lambda req: None)

    # -- producer side ------------------------------------------------------
    def submit(self, req: Request, *, force: bool = False) -> Response:
        """Enqueue or reject-with-backpressure.  ``force`` bypasses the
        occupancy bound (split-requeues only — see module doc)."""
        with self._cond:
            if self._closed:
                raise RuntimeError("admission queue is closed")
            if not force and len(self._heap) >= self.maxsize:
                raise Backpressure(
                    f"queue full ({self.maxsize} queued)",
                    retry_after_s=self._retry_after_hint(len(self._heap)))
            if req.response.submitted_ns == 0:  # re-submits (split halves,
                # disbanded mates) keep the original wait clock
                req.response.submitted_ns = time.monotonic_ns()
            heapq.heappush(
                self._heap, (-(req.priority + req.boost), req.seq, req))
            self._cond.notify()
        return req.response

    # -- consumer side ------------------------------------------------------
    def _timeout_locked(self, req: Request) -> None:
        req.response._complete(
            TIMED_OUT,
            error=RequestTimeout(f"deadline expired in queue "
                                 f"(handler={req.handler})"))
        self._on_timeout(req)

    def pop(self, timeout: Optional[float] = None) -> Optional[Request]:
        """Highest-priority live request; None on close-and-drained or
        timeout.  Expired requests are completed as timed-out in passing."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while True:
                now = time.monotonic()
                while self._heap:
                    _, _, req = heapq.heappop(self._heap)
                    if req.expired(now):
                        self._timeout_locked(req)
                        continue
                    self._handed_out += 1
                    return req
                if self._closed:
                    return None
                wait = None if deadline is None else deadline - now
                if wait is not None and wait <= 0:
                    return None
                self._cond.wait(wait)

    def pop_compatible(self, pred: Callable[[Request], bool],
                       limit: int) -> List[Request]:
        """Remove up to ``limit`` queued requests matching ``pred`` (the
        micro-batch gather).  Never blocks; skips/expires dead requests."""
        out: List[Request] = []
        if limit <= 0:
            return out
        with self._cond:
            now = time.monotonic()
            keep = []
            for entry in self._heap:
                req = entry[2]
                if len(out) < limit and req.expired(now):
                    self._timeout_locked(req)
                    continue
                if len(out) < limit and pred(req):
                    out.append(req)
                else:
                    keep.append(entry)
            if out:
                self._heap = keep
                heapq.heapify(self._heap)
                self._handed_out += len(out)
        return out

    def task_done(self, n: int = 1) -> None:
        """Return ``n`` handed-out requests (each has reached a terminal
        state or been re-submitted by now)."""
        with self._cond:
            self._handed_out -= n
            self._cond.notify_all()

    # -- controller knobs ---------------------------------------------------
    def set_maxsize(self, n: int) -> int:
        """Retune the occupancy bound (the admission controller's queue-
        depth knob).  Shrinking proactively completes deadline-expired
        queued requests as timed-out — they would otherwise occupy the
        now-scarcer slots until popped, shielding live work from the
        tighter bound the controller just asked for.  Live requests are
        NEVER purged (they were admitted; the bound governs new submits
        only).  Returns the number of purged entries."""
        n = max(1, int(n))
        with self._cond:
            shrinking = n < self.maxsize
            self.maxsize = n
            if not shrinking:
                return 0
            now = time.monotonic()
            keep, purged = [], 0
            for entry in self._heap:
                req = entry[2]
                if req.expired(now):
                    self._timeout_locked(req)
                    purged += 1
                else:
                    keep.append(entry)
            if purged:
                self._heap = keep
                heapq.heapify(self._heap)
            return purged

    def age_sessions(self, boosts: dict) -> int:
        """Apply priority-aging boosts (``{session_id: boost}``) to queued
        requests and re-order the heap.  Boosts are absolute levels, not
        increments — re-applying the same mapping is idempotent, and a
        session's boost only ever ratchets a queued request upward (a
        lowered boost applies to future submits via the session, never
        demotes work already in line).  Returns how many requests moved."""
        if not boosts:
            return 0
        changed = 0
        with self._cond:
            for entry in self._heap:
                req = entry[2]
                b = int(boosts.get(req.session_id, 0))
                if b > req.boost:
                    req.boost = b
                    changed += 1
            if changed:
                self._heap = [(-(r.priority + r.boost), r.seq, r)
                              for _, _, r in self._heap]
                heapq.heapify(self._heap)
        return changed

    def clear_boosts(self) -> int:
        """Reset every queued request's aging boost to 0 and re-order —
        the freeze path: after the kill switch, pop order must be exactly
        the static (priority, seq) order, including for entries boosted
        before the freeze.  Returns how many requests changed."""
        with self._cond:
            changed = 0
            for _, _, req in self._heap:
                if req.boost:
                    req.boost = 0
                    changed += 1
            if changed:
                self._heap = [(-r.priority, r.seq, r)
                              for _, _, r in self._heap]
                heapq.heapify(self._heap)
            return changed

    def session_waits(self) -> dict:
        """Oldest queued wait (seconds) per session — the starvation
        signal priority aging feeds on.  Sampled at controller tick rate,
        so the O(depth) scan is off every hot path."""
        now_ns = time.monotonic_ns()
        out: dict = {}
        with self._cond:
            for _, _, req in self._heap:
                wait_s = (now_ns - req.response.submitted_ns) / 1e9
                if wait_s > out.get(req.session_id, 0.0):
                    out[req.session_id] = wait_s
        return out

    # -- introspection / lifecycle ------------------------------------------
    def depth(self) -> int:
        with self._cond:
            return len(self._heap)

    def outstanding(self) -> int:
        """Queued + handed-out-unfinished (0 == fully idle)."""
        with self._cond:
            return len(self._heap) + self._handed_out

    def wait_idle(self, timeout: Optional[float] = None) -> bool:
        """Block until outstanding() == 0 (drain); False on timeout.
        One lock covers the heap AND the handed-out count, so there is
        no window where an in-flight request is invisible."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while len(self._heap) + self._handed_out > 0:
                wait = (None if deadline is None
                        else deadline - time.monotonic())
                if wait is not None and wait <= 0:
                    return False
                self._cond.wait(wait)
            return True

    def close(self) -> List[Request]:
        """Stop accepting work; every still-queued request completes as
        cancelled.  Returns the cancelled requests (tests/bench assert
        none are silently lost)."""
        with self._cond:
            self._closed = True
            dropped = [entry[2] for entry in self._heap]
            self._heap = []
            for req in dropped:
                req.response._complete(
                    CANCELLED, error=RuntimeError("queue closed"))
            self._cond.notify_all()
        return dropped
