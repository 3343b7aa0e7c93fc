"""Client sessions: identity, priority, and byte budgets over governor tasks
(a copy of the JAX package's ``serve/session.py``).

A session is the serving layer's tenant handle.  Each admitted request runs
as its OWN governor task (one task id per request, allocated monotonically),
so the arbiter's task-priority rule — older task wins the budget — applies
across every tenant's in-flight work exactly as it does for Spark tasks.
The session contributes:

- **priority**: queue ordering (higher pops first).  Arbiter-side priority
  stays submission-age-based via the monotonic task ids, mirroring the
  reference (lower task id = higher priority, SparkResourceAdaptor).
- **byte budget**: a cap on the session's *concurrently in-flight estimated
  working set*.  A request that would push the session past its budget —
  or that alone exceeds it — is rejected cleanly at submit
  (:class:`SessionBudgetExceeded`), before it can queue; the global device
  budget then only arbitrates work that some tenant was entitled to run.
"""

from __future__ import annotations

import itertools
import threading
from typing import Dict, Optional

__all__ = ["Session", "SessionBudgetExceeded", "SessionRegistry"]


class SessionBudgetExceeded(Exception):
    """The request's working set does not fit the session's byte budget."""


class Session:
    """One client's handle: created via :meth:`SessionRegistry.open`."""

    def __init__(self, session_id: str, priority: int,
                 byte_budget: Optional[int]):
        self.session_id = session_id
        self.priority = priority
        self.byte_budget = byte_budget  # None = uncapped (static config)
        self.closed = False  # guarded-by: _lock
        self._lock = threading.Lock()
        self.inflight_bytes = 0  # guarded-by: _lock
        self.inflight_requests = 0  # guarded-by: _lock
        # adaptive-admission knobs (serve/controller.py).  budget_scale
        # multiplies the STATIC byte_budget into the effective cap charge()
        # enforces — under pressure the controller shrinks every tenant's
        # concurrent working set without touching the configured budget,
        # and 1.0 restores static behavior exactly.  age_boost is added to
        # this session's queue priority at submit (and ratcheted onto
        # already-queued requests via AdmissionQueue.age_sessions), so a
        # starved low-priority tenant climbs instead of aging out.
        self.budget_scale = 1.0  # guarded-by: _lock
        self.age_boost = 0  # guarded-by: _lock
        # degradation-ladder shed count (serve/supervisor.py): which
        # tenants the brownout actually hit, surfaced per session so an
        # operator can tell "we shed the batch tier" from "we shed
        # everyone" in one snapshot
        self.degrade_rejects = 0  # guarded-by: _lock

    def note_degraded(self) -> None:
        with self._lock:
            self.degrade_rejects += 1

    def set_budget_scale(self, scale: float) -> None:
        with self._lock:
            self.budget_scale = min(1.0, max(0.05, float(scale)))

    def set_age_boost(self, boost: int) -> None:
        with self._lock:
            self.age_boost = max(0, int(boost))

    def _effective_cap(self) -> Optional[int]:
        """The byte cap charge() enforces right now (None = uncapped):
        the static budget scaled by the controller's knob, floored at one
        byte so a capped session can never become accidentally uncapped
        (or cap-zero) through scaling.  Lock-free; callers hold _lock or
        accept a racy read (effective_budget)."""
        if self.byte_budget is None:
            return None
        return max(1, int(self.byte_budget * self.budget_scale))

    def effective_budget(self) -> Optional[int]:
        with self._lock:
            return self._effective_cap()

    def charge(self, nbytes: int) -> None:
        """Reserve ``nbytes`` of the session budget for one request, or
        reject (called at submit; released via :meth:`credit` when the
        request reaches a terminal state)."""
        with self._lock:
            if self.closed:
                raise RuntimeError(f"session {self.session_id} is closed")
            if self.byte_budget is not None:
                cap = self._effective_cap()
                if nbytes > cap:
                    raise SessionBudgetExceeded(
                        f"request working set {nbytes} exceeds session "
                        f"budget {cap} (static {self.byte_budget} x "
                        f"scale {self.budget_scale:g})")
                if self.inflight_bytes + nbytes > cap:
                    raise SessionBudgetExceeded(
                        f"session budget exhausted: {self.inflight_bytes} "
                        f"in flight + {nbytes} > {cap}")
            self.inflight_bytes += nbytes
            self.inflight_requests += 1

    def credit(self, nbytes: int) -> None:
        with self._lock:
            self.inflight_bytes -= nbytes
            self.inflight_requests -= 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "session_id": self.session_id,
                "priority": self.priority,
                "byte_budget": self.byte_budget,
                "budget_scale": self.budget_scale,
                "age_boost": self.age_boost,
                "degrade_rejects": self.degrade_rejects,
                "inflight_bytes": self.inflight_bytes,
                "inflight_requests": self.inflight_requests,
                "closed": self.closed,
            }


class SessionRegistry:
    """Open/close sessions and allocate governor task ids.

    Task ids are engine-global and monotonic: a request admitted earlier
    always holds arbiter priority over a later one, regardless of which
    session submitted it (queue priority decides who gets POPPED first;
    arbiter age decides who wins MEMORY — the same two-level discipline
    the reference applies between Spark's scheduler and RmmSpark).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._sessions: Dict[str, Session] = {}  # guarded-by: _lock
        self._session_seq = itertools.count(1)
        self._task_seq = itertools.count(1)

    def open(self, name: Optional[str] = None, *, priority: int = 0,
             byte_budget: Optional[int] = None) -> Session:
        with self._lock:
            sid = name if name is not None else f"s{next(self._session_seq)}"
            if sid in self._sessions and not self._sessions[sid].closed:
                raise ValueError(f"session {sid!r} already open")
            sess = Session(sid, priority, byte_budget)
            self._sessions[sid] = sess
            return sess

    def close(self, session: Session) -> None:
        """New submits fail; in-flight requests run to completion (their
        bytes were charged at submit and credit back normally)."""
        with session._lock:
            session.closed = True

    def get(self, session_id: str) -> Session:
        with self._lock:
            return self._sessions[session_id]

    def all_open(self) -> list:
        """Live sessions (the controller's knob-application sweep)."""
        with self._lock:
            return [s for s in self._sessions.values() if not s.closed]

    def next_task_id(self) -> int:
        return next(self._task_seq)

    def snapshot(self) -> dict:
        with self._lock:
            return {sid: s.snapshot() for sid, s in self._sessions.items()}
