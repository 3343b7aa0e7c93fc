"""Governed execution: the retry/split-and-retry driver over the arbiter
(PyTorch port of ``mem/governed.py``).

This is the glue the reference expresses in its *protocol documentation*
(RmmSpark.java:402-416): task code brackets device work in a retry block,
reserves its working set before launching, and reacts to the two arbiter
signals —

- ``RetryOOM``: roll back and retry the same batch (the arbiter has already
  blocked the thread until memory was freed);
- ``SplitAndRetryOOM``: the thread holds the highest priority and still can't
  make progress — *split the input batch* into smaller disjoint pieces and
  process them sequentially, combining partial results.

On the reference GPU stack the reservation point is RMM ``do_allocate``
(SparkResourceAdaptorJni.cpp:1731); the port leaves allocation to PyTorch's
CUDA caching allocator, so the admission point is
:meth:`BudgetedResource.acquire` *before* the launch.  Everything else --
blocking, BUFN escalation, watchdog, metrics -- is the same native state
machine (csrc/task_arbiter.cpp).  Under a mesh each rank has its own
governor, so a ``group`` makes every admission outcome agreed across the
ranks that share collectives (:func:`attempt_once`).

Usage shape (what models/ goes through)::

    gov = MemoryGovernor.instance()
    budget = default_device_budget(gov)
    with task_context(gov, task_id=7):
        out = run_with_split_retry(
            budget, batch,
            nbytes_of=lambda b: b.nbytes * 3,   # working-set estimate
            run=step,                            # launches device work
            split=split_in_half,                 # -> [b0, b1] disjoint
            combine=sum_outputs,
        )
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from spark_rapids_jni_tpu_torch.mem.exceptions import RetryOOM, SplitAndRetryOOM
from spark_rapids_jni_tpu_torch.mem.governor import (
    BudgetedResource,
    MemoryGovernor,
    OutOfBudget,
)
from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.obs import seam as _seam

__all__ = [
    "task_context",
    "reservation",
    "run_with_split_retry",
    "attempt_once",
    "default_device_budget",
    "PEAK_OVER_RESERVATION",
    "agreed_outcome",
    "MaxSplitDepthExceeded",
    "ShuffleCapacityExceeded",
]


class _AttribHook:
    """Deferred binding of serve/attribution's ``note_reservation``
    (byte·seconds attribution at the one choke point every governed byte
    passes through: runtime, executor and shuffle-credit reservations
    alike).  mem/ loads long before the serve package can, so the hook
    resolves on the FIRST governed release instead of at import and caches
    the bound function, as the JAX package's does."""

    __slots__ = ("_fn",)

    def __init__(self):
        self._fn = None

    def note_reservation(self, nbytes: int, held_ns: int) -> None:
        fn = self._fn
        if fn is None:
            from spark_rapids_jni_tpu_torch.serve.attribution import note_reservation

            fn = self._fn = note_reservation
        fn(nbytes, held_ns)


_attrib = _AttribHook()


class MaxSplitDepthExceeded(MemoryError):
    """A batch could not be made small enough within the split-depth cap."""


class ShuffleCapacityExceeded(Exception):
    """Raised by a ``run`` callback when a fixed-capacity exchange overflowed
    (``ShuffleResult.dropped > 0``).  The driver responds by re-running the
    same piece after ``grow(piece)`` — the shuffle-spill retry the reference
    protocol describes for exchanges that outgrow their buffers."""


@contextlib.contextmanager
def task_context(gov: MemoryGovernor, task_id: int):
    """Register the current thread as the dedicated thread of ``task_id``
    for the duration (startDedicatedTaskThread / taskDone pairing).
    Admission and completion land in the governance flight recorder, so a
    task's lifetime brackets its blocked/retry history in the ring."""
    gov.current_thread_is_dedicated_to_task(task_id)
    _flight.record(_flight.EV_TASK_ADMITTED, task_id, detail="dedicated")
    try:
        yield gov
    finally:
        gov.task_done(task_id)
        _flight.record(_flight.EV_TASK_DONE, task_id)


@contextlib.contextmanager
def reservation(budget: BudgetedResource, nbytes: int):
    """Reserve ``nbytes`` of budget around a block of device work.

    ``acquire`` drives the arbiter's pre_alloc/post_alloc protocol: it may
    block (another task holds the budget), raise RetryOOM/SplitAndRetryOOM
    (escalation decided this thread must retry or split), or raise
    OutOfBudget (non-retryable; request exceeds the whole budget).

    The acquire crosses the ALLOC seam — the allocation-interception
    point of the reference's chaos/profiling stack (faultinj.cu hooks the
    allocator; CUPTI sees malloc activity): the profiler records the
    admission (including any blocked wait) as a range plus a budget-used
    counter, and a chaos rule on ``alloc``/``reserve:*`` injects an
    allocation failure INSIDE the retry protocol.
    """
    # lock-free hot-path gate, same flags seam() itself checks: with the
    # profiler and injector both inactive this adds zero locks/formatting
    # to the admission path (incl. the up-to-500 RetryOOM retry loop)
    if _seam._profiler_range is None and _seam._injector is None:
        t0 = 0
        budget.acquire(nbytes)
        try:
            t0 = time.monotonic_ns()
            yield
        finally:
            budget.release(nbytes)
            # byte·second attribution: reservation size x hold time,
            # stamped at the choke point so every governed byte is
            # metered exactly once (no lock on this path)
            if t0:
                _attrib.note_reservation(
                    nbytes, time.monotonic_ns() - t0)
        return

    from spark_rapids_jni_tpu_torch.obs.profiler import Profiler

    ctr = "cpu_budget_used" if budget.is_cpu else "device_budget_used"

    def _emit():
        # sample + timestamp under the budget lock so concurrent tenants'
        # counter points can never reorder against the values they carry
        with budget._lock:
            Profiler.counter(ctr, budget.used)

    acquired = False
    try:
        with _seam.seam(
                _seam.ALLOC,
                f"reserve:{'cpu' if budget.is_cpu else 'dev'}:{nbytes}"):
            budget.acquire(nbytes)
            acquired = True
    except BaseException:
        # the seam __exit__ (profiler range close) runs AFTER a
        # successful acquire: a fault there must hand the reservation
        # back before propagating, or the budget shrinks forever
        if acquired:
            budget.release(nbytes)
        raise
    t0 = 0
    try:
        # the admission counter point emits INSIDE the release bracket:
        # a profiler fault mid-emit used to leak the fresh reservation
        # (nothing released it) — the resource-lifecycle gate pins this.
        # _emit samples under the budget lock, so its ordering against
        # concurrent tenants is unchanged by sitting after the seam.
        t0 = time.monotonic_ns()
        _emit()
        yield
    finally:
        budget.release(nbytes)
        if t0:
            _attrib.note_reservation(nbytes, time.monotonic_ns() - t0)
        _emit()


_NO_BUDGET_LOCK = threading.Lock()
_DEFAULT_BUDGET: Optional[BudgetedResource] = None


#: How far a governed call's device peak may rise above its reservation: the
#: reservations count the JAX package's working-set estimates, and on the
#: H100 governed q97 peaks at 1.2414x its reservation and q3 at 1.1861x
#: (``chip_smoke.py``'s governed phase, which fails above this factor).
PEAK_OVER_RESERVATION = 1.25


def _card_bytes() -> Optional[int]:
    """Total memory of this process's current card, or None without one."""
    if not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(torch.cuda.current_device())[1])


def default_device_budget(gov: Optional[MemoryGovernor] = None) -> BudgetedResource:
    """Process-wide device budget.

    Sized like the reference sizes its RMM pool, from the card when there is
    one: the total of ``torch.cuda.mem_get_info`` on the current device over
    :data:`PEAK_OVER_RESERVATION`, so that a reservation the arbiter grants
    still fits the card at its peak.  Without a card it is the
    ``device_budget_bytes`` config flag.  The cached facade is rebuilt if the
    governor it was bound to has been shut down (a stale budget would
    otherwise drive a closed native arbiter).
    """
    global _DEFAULT_BUDGET
    with _NO_BUDGET_LOCK:
        stale = (
            _DEFAULT_BUDGET is not None
            and _DEFAULT_BUDGET.gov.arbiter._h is None
        )
        if _DEFAULT_BUDGET is None or stale:
            from spark_rapids_jni_tpu_torch import config

            card = _card_bytes()
            if card is None:
                limit = int(config.get("device_budget_bytes"))
            else:
                limit = int(card / PEAK_OVER_RESERVATION)
            _DEFAULT_BUDGET = BudgetedResource(
                gov or MemoryGovernor.instance(), limit
            )
        return _DEFAULT_BUDGET


def _reset_default_budget_for_tests():
    global _DEFAULT_BUDGET
    with _NO_BUDGET_LOCK:
        _DEFAULT_BUDGET = None


def run_with_split_retry(
    budget: BudgetedResource,
    batch: Any,
    *,
    nbytes_of: Callable[[Any], int],
    run: Callable[[Any], Any],
    split: Callable[[Any], Sequence[Any]],
    combine: Callable[[List[Any]], Any],
    grow: Optional[Callable[[Any], Any]] = None,
    max_split_depth: int = 8,
    max_grows: int = 8,
    initial_split_depth: int = 0,
    on_retry: Optional[Callable[[int], None]] = None,
    group: Optional[dist.ProcessGroup] = None,
) -> Any:
    """Process ``batch`` under the arbiter's retry protocol.

    Each (sub-)batch attempt is bracketed in a retry block; the working set
    ``nbytes_of(b)`` is reserved before ``run(b)`` launches device work and
    released after.  ``RetryOOM`` retries the same piece (the arbiter already
    blocked us until memory freed); ``SplitAndRetryOOM`` — and a first-level
    non-retryable ``OutOfBudget`` whose request exceeds the total budget —
    replaces the piece with ``split(b)`` (disjoint sub-batches), processed
    depth-first so partial results stay in input order for ``combine``.

    ``run`` may additionally raise :class:`ShuffleCapacityExceeded` to signal
    a fixed-capacity exchange overflow; the piece is re-attempted as
    ``grow(piece)`` (typically doubling the shuffle capacity), with the
    reservation recomputed for the bigger buffers.

    ``initial_split_depth`` pre-splits the batch BEFORE the first attempt
    (the adaptive controller's pre-emptive split sizing: a class whose
    history shows SplitAndRetryOOM skips the doomed full-size attempt and
    its blocked/retry churn).  Pieces start at that depth, so the
    ``max_split_depth`` cap covers pre-splits + reactive splits together.
    ``on_retry(count)`` is forwarded to every piece's retry bracket.

    ``group`` is the process group of the ranks that run ``batch`` together
    (their collectives span it).  With a group every admission outcome is
    agreed across its ranks (:func:`attempt_once`), and so is the choice
    between splitting and a real OOM below, so every rank retries, splits
    and grows in step and none enters a collective alone.  Without one
    (the default) the driver is the JAX package's, line for line.
    """
    gov = budget.gov
    results: List[Any] = []
    # depth-first work list of (piece, depth, grows) keeps combine() order ==
    # input order
    work: List[tuple] = [(batch, 0, 0)]
    for _ in range(max(0, min(initial_split_depth, max_split_depth))):
        nxt: List[tuple] = []
        for piece, depth, grows in work:
            parts = list(split(piece))
            if len(parts) <= 1:  # not splittable further: keep as-is
                nxt.append((piece, depth, grows))
            else:
                nxt.extend((p, depth + 1, grows) for p in parts)
        if len(nxt) == len(work):
            break  # nothing split this round; deeper rounds won't either
        work = nxt
    while work:
        piece, depth, grows = work.pop(0)
        try:
            results.append(_attempt(gov, budget, piece, nbytes_of, run,
                                    on_retry=on_retry, group=group))
            continue
        except ShuffleCapacityExceeded:
            if grow is None or grows >= max_grows:
                raise
            work.insert(0, (grow(piece), depth, grows + 1))
            continue
        except SplitAndRetryOOM as e:
            err = e
        except OutOfBudget as e:
            fits = int(nbytes_of(piece)) <= budget.limit
            if group is not None:
                fits = agreed_outcome(int(fits), group, gov) == 1
            if fits:
                # the arbiter declared this non-retryable (livelock cap /
                # unregistered thread): a real OOM, as in the reference
                raise
            err = e
        if depth >= max_split_depth:
            raise MaxSplitDepthExceeded(
                f"split depth {depth} reached and batch still does not fit"
            ) from err
        parts = list(split(piece))
        if len(parts) <= 1:
            raise MaxSplitDepthExceeded(
                "batch is not splittable further"
            ) from err
        work = [(p, depth + 1, grows) for p in parts] + work
    return combine(results)


def attempt_once(gov, budget, piece, nbytes_of, run, *,
                 on_retry: Optional[Callable[[int], None]] = None,
                 max_retries: int = 500,
                 group: Optional[dist.ProcessGroup] = None):
    """One retry-block around one piece.

    Returns run's result; raises SplitAndRetryOOM / terminal OutOfBudget
    (request larger than the whole budget) for the caller to split, and
    passes ShuffleCapacityExceeded through for the caller to grow.

    Public because it is the protocol bracket EVERY single-piece admission
    goes through — :func:`run_with_split_retry` for inline splitting, and
    the serving engine (serve/executor.py), which splits by re-queueing
    halves instead.  ``on_retry(count)`` is called after each RetryOOM
    (serve metrics / deadline checks); an exception it raises aborts the
    attempt with the retry block closed cleanly.

    With ``group``, every rank of the group makes its reservation attempt
    and then all take the MAX of their outcome codes (0 ok, 1 RetryOOM, 2
    SplitAndRetryOOM, 3 non-retryable OutOfBudget): on a non-zero code a
    rank that reserved releases its bytes, and every rank raises the agreed
    exception, so no rank runs the piece's collectives alone.  Every rank
    reserves the piece's global working set, as the JAX package does.
    """
    nbytes = int(nbytes_of(piece))
    admit = reservation if group is None or dist.get_world_size(group) == 1 \
        else functools.partial(_agreed_reservation, group=group)
    gov.start_retry_block()
    retries = 0
    try:
        while True:
            try:
                with admit(budget, nbytes):
                    return run(piece)
            except RetryOOM:
                # arbiter blocked us until ready; same piece, try again.
                # The native 500-cap counts BUFN-path throws only, so
                # injected/self-escalated RetryOOMs (the wasted-wake
                # livelock breaker) are bounded here, mirroring the
                # reference's retry limit -> real OOM.
                retries += 1
                if on_retry is not None:
                    on_retry(retries)
                if retries >= max_retries:
                    raise OutOfBudget(
                        f"retry limit exceeded ({max_retries}) for one piece")
                continue
    finally:
        gov.end_retry_block()


_attempt = attempt_once


# admission outcome codes agreed across a group: the worst (MAX) wins
_OK, _WAIT, _RETRY, _SPLIT, _OUT_OF_BUDGET = 0, 1, 2, 3, 4
_AGREED = {_RETRY: RetryOOM, _SPLIT: SplitAndRetryOOM, _OUT_OF_BUDGET: OutOfBudget}


def agreed_outcome(code: int, group: dist.ProcessGroup,
                   gov: Optional[MemoryGovernor] = None) -> int:
    """The MAX of every rank's ``code`` over ``group``: one ``all_reduce`` of
    one int32, on this rank's card for an NCCL group.  A group of one rank
    agrees with itself, with no collective.

    With ``gov``, the calling thread counts as blocked for ``gov``'s deadlock
    check while it waits on its peers (``waiting_on_pool``, as a task thread
    waiting on a pool).  When tasks of several ranks share each rank's
    budget, task A may wait here on rank 0 for its half parked in rank 1's
    arbiter while task B waits here on rank 1 for its half parked in rank
    0's: counted as running, the waiters would keep either arbiter from
    seeing all its tasks blocked, and neither would escalate."""
    if dist.get_world_size(group) == 1:
        return code
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    t = torch.tensor([code], dtype=torch.int32, device=dev)
    if gov is not None:
        gov.waiting_on_pool()
    try:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    finally:
        if gov is not None:
            gov.done_waiting_on_pool()
    return int(t.item())


def _outcome(fn) -> tuple:
    """(code, exception) of calling ``fn``: _OK, or the admission signal it
    raised."""
    try:
        fn()
        return _OK, None
    except RetryOOM as e:
        return _RETRY, e
    except SplitAndRetryOOM as e:
        return _SPLIT, e
    except OutOfBudget as e:
        return _OUT_OF_BUDGET, e


def _raise_agreed(agreed: int, code: int, err) -> None:
    if agreed == code:
        raise err
    raise _AGREED[agreed](
        f"admission outcome {agreed} agreed across the group "
        f"(this rank's was {code})")


@contextlib.contextmanager
def _agreed_reservation(budget: BudgetedResource, nbytes: int, group):
    """:func:`reservation` whose outcome every rank of ``group`` agrees on,
    without holding bytes while a peer waits in its arbiter.

    Each round, every rank first tries without parking
    (``BudgetedResource.try_admit``: injected signals fire, spill handlers
    run) and the outcomes are agreed.  All in: every rank holds its bytes
    and runs.  A signal anywhere: every rank gives its bytes back and raises
    the agreed signal.  Some rank short of room: every rank gives its bytes
    back, waits for room through the arbiter's full protocol (``acquire``,
    which may park, retry or split, then an immediate release), agrees on
    that outcome, and tries again.  A rank that holds bytes thus waits only
    for its peers' tries, never for a peer parked behind another task's
    bytes -- the cross-rank cycle that tasks sharing each rank's budget
    would otherwise close (:func:`agreed_outcome`)."""
    gov = budget.gov
    seam_on = _seam._profiler_range is not None or _seam._injector is not None
    site = f"reserve:{'cpu' if budget.is_cpu else 'dev'}:{nbytes}"
    while True:
        got = [False]

        def try_once():
            if seam_on:
                with _seam.seam(_seam.ALLOC, site):
                    got[0] = budget.try_admit(nbytes)
            else:
                got[0] = budget.try_admit(nbytes)

        code, err = _outcome(try_once)
        if code == _OK and not got[0]:
            code = _WAIT
        try:
            agreed = agreed_outcome(code, group)  # peers only try: a short wait
        except BaseException:
            if got[0]:
                budget.release(nbytes)  # a failed collective must not leak it
            raise
        if agreed == _OK:
            break
        if got[0]:
            budget.release(nbytes)
        if agreed != _WAIT:
            _raise_agreed(agreed, code, err)

        def wait_for_room():
            budget.acquire(nbytes)
            budget.release(nbytes)

        code, err = _outcome(wait_for_room)
        agreed = agreed_outcome(code, group, gov)
        if agreed != _OK:
            _raise_agreed(agreed, code, err)
    t0 = time.monotonic_ns()
    try:
        yield
    finally:
        budget.release(nbytes)
        _attrib.note_reservation(nbytes, time.monotonic_ns() - t0)
