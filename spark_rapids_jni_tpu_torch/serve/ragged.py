"""Continuous ragged batching: one fused page-pool launch per tick (PyTorch
port of ``serve/ragged.py``).

The micro-batcher (serve/executor.py) only merges requests whose handler
can concatenate payloads elementwise, caps the ride at ``max_batch``, and
compiles one program per merged total shape — heterogeneous row counts
walk the whole pow2 bucket lattice (the plan_cache miss gauges from
round 8 show it directly).  This module is the *Ragged Paged Attention*
idiom applied to query serving:

- a tick gathers ARBITRARY concurrent requests of one handler class
  (different row counts, zero-row requests, a single giant request) up to
  the standing pool's row capacity;
- :func:`columnar.pages.pack_ragged` packs them into the fixed-size page
  pool with a row-offset table (geometry floored at the pool size, so
  every steady-state tick shares ONE compiled program);
- ONE fused program per (kernel, page geometry) — compiled through the
  page-pool calling convention (:func:`plans.compiler.cached_ragged_compile`,
  the same process-global plan cache as query plans) — launches once;
- results scatter back per session, bit-identical to running each rider
  alone (padding is validity-masked; the fuzz parity tier pins it).

Retry/split semantics live at PAGE granularity: ``RetryOOM`` re-runs the
same pack inside the bracket (a cache hit — zero retrace);
``SplitAndRetryOOM`` halves the page count by partitioning riders into
two groups (``columnar.pages.split_riders``) and re-packing each into
half the pages — a rider is NEVER silently dropped: a group of one falls
back to the engine's per-request split protocol (``h.split`` re-queue or
a loud terminal MemoryError, exactly the classic path).

Gated on the ``serve_ragged`` flag; with it off the engine's micro-batch
path is bit-identical to round 11 and serves as the parity oracle.

The port runs each tick on the engine's device: the pool's host buffers are
uploaded with blocking copies, so the page pool may recycle them as soon as
the tick returns (an upload still in flight from a recycled buffer would
corrupt the next tick), and the output is downloaded before the pool's
buffers go back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar import pages as _pages
from spark_rapids_jni_tpu_torch.mem.exceptions import RetryOOM, SplitAndRetryOOM
from spark_rapids_jni_tpu_torch.mem.governed import (
    ShuffleCapacityExceeded,
    attempt_once,
    task_context,
)
from spark_rapids_jni_tpu_torch.mem.governor import OutOfBudget
from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.obs import trace as _trace
from spark_rapids_jni_tpu_torch.obs.seam import COLLECTIVE, SERVE, TRANSFER, seam
from spark_rapids_jni_tpu_torch.plans.cache import plan_cache
from spark_rapids_jni_tpu_torch.plans.compiler import (
    RaggedProgram,
    cached_ragged_compile,
)
from spark_rapids_jni_tpu_torch.serve.queue import (
    ERROR,
    OK,
    TIMED_OUT,
    Request,
    RequestTimeout,
)

__all__ = ["RaggedSpec", "RaggedDispatcher", "run_rows_compiled"]


@dataclasses.dataclass(frozen=True)
class RaggedSpec:
    """A handler's opt-in to ragged paged batching.

    - ``rows_of(payload)``: the payload as ONE 1-D typed row array (the
      unit the packer concatenates; all payloads of a handler class must
      agree on dtype);
    - ``kernel(data, valid, rid, riders_cap)``: torch code over the flat
      page-pool tensors on the engine's device (see
      :func:`plans.compiler.compile_ragged` for the contract);
    - ``out``: "rows" — the kernel's output is row-aligned and each
      rider's span is sliced back; "riders" — the output is indexed by
      rider id (per-rider reductions);
    - ``result_of(out, payload)``: rider output -> response value
      (default: the output array itself);
    - ``nrows_of(payload)``: row count WITHOUT materializing the row
      array (the gather predicate runs under the queue lock; default
      ``len(payload)``);
    - ``kernel_key``: cache identity override (defaults to the kernel's
      module-qualified name — needed only for closures whose qualname
      does not identify their behavior).
    """

    rows_of: Callable[[Any], np.ndarray]
    kernel: Callable
    out: str = "rows"
    result_of: Optional[Callable[[np.ndarray, Any], Any]] = None
    nrows_of: Optional[Callable[[Any], int]] = None
    kernel_key: str = ""

    def key(self) -> str:
        if self.kernel_key:
            return self.kernel_key
        k = self.kernel
        return f"{k.__module__}.{k.__qualname__}"

    def nrows(self, payload: Any) -> int:
        if self.nrows_of is not None:
            return int(self.nrows_of(payload))
        return len(payload)


def _launch_packed(prog: RaggedProgram, kernel: Callable,
                   packed: "_pages.PackedPages",
                   device: torch.device) -> np.ndarray:
    """Compile (cached), upload, launch ONCE, download.  The device half
    every ragged execution shares -- the dispatcher's fused tick and the
    per-request oracle (:func:`run_rows_compiled`) run the exact same
    code, so parity failures can only come from pack/scatter.

    The uploads are blocking copies (``copy=True``: a fresh tensor on the
    CPU too), so the pool's host buffers are free to go back to the pool
    the moment this returns, whatever is injected after them."""
    compiled = cached_ragged_compile(prog, kernel)
    with seam(TRANSFER, f"ragged_upload:{prog.kernel_key}"):
        data, valid, rid = (torch.from_numpy(a).to(device, copy=True)
                            for a in (packed.data, packed.valid, packed.rid))
    t0 = time.perf_counter()
    with seam(COLLECTIVE, f"launch:{prog.name}"):
        out = compiled.fn(data, valid, rid)[0].cpu().numpy()
    plan_cache.record_execute(time.perf_counter() - t0)
    return out


def _pool_nbytes(geom: "_pages.PageGeometry") -> int:
    """Admission estimate for one fused tick: pool buffers (data + valid
    + rid) x3 — inputs, device copies, and output/result headroom, the
    same margin the plan runtime reserves."""
    n = geom.total_rows
    return 3 * (n * np.dtype(geom.dtype).itemsize + n + 4 * n)


def run_rows_compiled(spec: RaggedSpec, rows: np.ndarray, page_rows: int,
                      device: _device.DeviceLike = None) -> np.ndarray:
    """The PER-REQUEST oracle: one rider, packed and launched through the
    identical kernel/convention as the fused tick, with the geometry
    quantized per request shape (min_pages=1) — exactly the compiled-
    variant-per-request-bucket behavior the ragged path replaces.  Used
    by handlers' classic ``fn`` so the micro-vs-ragged bench compares
    compile counts through one cache, and by the parity tests as the
    bit-identical reference.  Runs on ``device``, the card unless the caller
    asks for the CPU."""
    dev = _device.resolve(device)
    rows = np.asarray(rows)
    packed = _pages.pack_ragged([rows], page_rows, pool=_pages.page_pool)
    prog = RaggedProgram(spec.key(), packed.geometry, spec.out)
    try:
        # analyze: ignore[governed-allocation] - the device work happens
        # in _launch_packed, which is governed via the dispatcher's
        # attempt_once run callback; this oracle twin is itself invoked
        # from handler fn bodies the executor has already bracketed
        # (attempt_once reserves h.nbytes_of before fn runs)
        out = _launch_packed(prog, spec.kernel, packed, dev)
        if spec.out == "riders":
            return np.asarray(out)[0]
        return _pages.scatter_ragged(out, packed)[0]
    finally:
        # recycled on EVERY path: an injected launch fault must not turn
        # pool reuse off (the allocated-bytes gauge would read as a leak)
        _pages.page_pool.release(packed)


class RaggedDispatcher:
    """The engine's ragged dispatch path (one instance per engine,
    created when ``serve_ragged`` is on).

    Stateless beyond its config snapshot — all shared state lives in the
    engine (queue, metrics, governor) and the process-global page pool /
    plan cache, so the dispatcher adds no locks to the worker hot path.
    """

    def __init__(self, engine):
        from spark_rapids_jni_tpu_torch import config

        self.engine = engine
        self.page_rows = max(1, int(config.get("serve_page_rows")))
        self.pool_pages = max(1, int(config.get("serve_ragged_pool_pages")))
        self.max_riders = max(1, int(config.get("serve_ragged_max_riders")))
        # constant rider capacity: geometry then varies ONLY in its page
        # count, and only under split pressure — the variant bound
        from spark_rapids_jni_tpu_torch.columnar.column import next_pow2

        self.riders_floor = next_pow2(self.max_riders)

    # -- gather --------------------------------------------------------------
    def gather(self, req: Request, h) -> List[Request]:
        """Pull queued same-handler requests to fill the standing pool:
        riders accumulate until the pool's ROW capacity (not a count cap)
        or ``max_riders`` is reached; over-capacity candidates stay
        queued for the next tick — continuous batching, nobody dropped."""
        spec: RaggedSpec = h.ragged
        m = self.engine.metrics
        limit = self.max_riders - 1
        # miss accounting mirrors executor._gather_batch exactly (one
        # ledger, two paths): post_split/disabled for an unmergeable
        # primary, handler_mismatch/post_split per scanned candidate,
        # cap at most ONCE per tick when capacity was the binding
        # constraint — dashboards comparing micro vs ragged read
        # commensurable numbers
        if req.no_batch:
            m.count_batch_miss("post_split")
            return [req]
        if limit <= 0:
            m.count_batch_miss("disabled")
            return [req]
        cap_rows = self.page_rows * self.pool_pages
        state = {"rows": spec.nrows(req.payload),
                 "handler_mismatch": 0, "post_split": 0, "cap": 0}

        def pred(r: Request) -> bool:
            if r.handler != req.handler:
                state["handler_mismatch"] += 1
                return False
            if r.no_batch:
                state["post_split"] += 1
                return False
            n = spec.nrows(r.payload)
            if state["rows"] + n > cap_rows:
                state["cap"] += 1
                return False
            state["rows"] += n
            return True

        mates = self.engine.queue.pop_compatible(pred, limit)
        for reason in ("handler_mismatch", "post_split"):
            if state[reason]:
                m.count_batch_miss(reason, state[reason])
        if state["cap"] or (len(mates) == limit
                            and self.engine.queue.depth() > 0):
            m.count_batch_miss("cap")
        if mates:
            m.set_depth(self.engine.queue.depth())
        return [req] + mates

    # -- the tick ------------------------------------------------------------
    def serve_group(self, req: Request, h) -> List[Request]:
        """The ragged analog of the engine's ``_serve_group``: gather,
        then run the pack with the full page-granularity retry/split
        protocol.  Returns every popped member (the caller's task_done
        accounting)."""
        group = self.gather(req, h)
        now_ns = time.monotonic_ns()
        for r in group:
            _trace.close_span(r.qspan)  # queue-wait ends at this tick
            r.qspan = None
            if r.response.admitted_ns == 0:
                r.response.admitted_ns = now_ns
                self.engine.metrics.count("admitted", r.session_id)
                self.engine.metrics.record_wait(
                    now_ns - r.response.submitted_ns)
        # fresh ticks pack at the STANDING pool floor (one geometry for
        # every steady-state tick); split products pack right-sized
        # (min_pages=1) so halving a payload actually halves the
        # reservation — the floor would otherwise pin the working set
        # and the split protocol could never converge under pressure
        min_pages = (self.pool_pages
                     if (req.split_depth == 0 and not req.no_batch) else 1)
        # one compute span per rider, all covering this fused tick and
        # tagged with the pack's primary — pack membership reconstructs
        # from the shared token (riders of one launch share pack:<rid>)
        cspans = [_trace.open_span(
            r.trace, _trace.SPAN_COMPUTE, task_id=r.task_id,
            extra=f"handler:{h.name}:pack:{req.task_id}"
                  f":riders:{len(group)}")
            for r in group]
        try:
            if cspans[0] is not None:
                _trace.push_current(cspans[0].ctx)
            self._run_group(group, h, depth=0, min_pages=min_pages)
        finally:
            if cspans[0] is not None:
                _trace.pop_current()
            for cs in cspans:
                _trace.close_span(cs)
        return group

    def _run_group(self, group: List[Request], h, *, depth: int,
                   min_pages: int) -> None:
        """Pack -> one fused launch -> scatter, under one governed
        bracket (the primary's task context, like a micro-batch).  Every
        member reaches a terminal state or is re-queued — no path drops
        a rider."""
        eng = self.engine
        spec: RaggedSpec = h.ragged
        req = group[0]
        try:
            rows_list = [np.asarray(spec.rows_of(r.payload)) for r in group]
        except (RetryOOM, SplitAndRetryOOM, ShuffleCapacityExceeded) as e:
            # rows_of runs BEFORE any bracket opens: a control signal
            # here has no retry context — terminal, never swallowed
            for r in group:
                eng._finish(r, ERROR, error=e)
            return
        except Exception as e:  # noqa: BLE001 - a broken rows_of is a
            # handler bug: every popped member fails loudly, none hang
            for r in group:
                eng._finish(r, ERROR, error=e)
            return
        total = int(sum(a.shape[0] for a in rows_list))
        geom = _pages.geometry_for(
            total, len(group), self.page_rows, rows_list[0].dtype.name,
            min_pages=min_pages, min_riders=self.riders_floor)
        prog = RaggedProgram(spec.key(), geom, spec.out)

        def run(rl):
            packed = _pages.pack_ragged(
                rl, self.page_rows, pool=_pages.page_pool,
                min_pages=min_pages, min_riders=self.riders_floor)
            try:
                _flight.record(
                    _flight.EV_RAGGED_PACK, req.task_id,
                    detail=f"handler:{h.name}:riders:{packed.n_riders}"
                           f":pages:{packed.geometry.num_pages}",
                    value=packed.rows_packed)
                # the same SERVE seam label the classic path crosses, so
                # one chaos profile (handle:*) storms both paths — an
                # injected split_oom here drives the page-halving below
                with seam(SERVE, f"handle:{h.name}"):
                    out = _launch_packed(prog, spec.kernel, packed,
                                         eng.device)
                _flight.record(
                    _flight.EV_RAGGED_LAUNCH, req.task_id,
                    detail=f"handler:{h.name}"
                           f":geom:{packed.geometry.describe()}",
                    value=packed.rows_packed)
                m = eng.metrics
                m.count("ragged_launches")
                m.count("ragged_batched", n=packed.n_riders)
                m.count("ragged_pages", n=packed.geometry.num_pages)
                m.count("ragged_rows", n=packed.rows_packed)
                m.count("ragged_row_capacity", n=packed.geometry.total_rows)
                if spec.out == "riders":
                    return [np.asarray(out)[i]
                            for i in range(packed.n_riders)]
                return _pages.scatter_ragged(out, packed)
            finally:
                # recycled on EVERY path (incl. injected faults and
                # retries): pool reuse must survive the chaos tier
                _pages.page_pool.release(packed)

        def on_retry(count: int) -> None:
            eng.metrics.count("retried", req.session_id)
            if any(r.expired() for r in group):
                raise RequestTimeout(
                    f"deadline expired after {count} retries "
                    f"(handler={h.name}, ragged)")
            time.sleep(0.001)

        run_t0 = time.monotonic_ns()
        try:
            with task_context(eng.gov, req.task_id):
                results = attempt_once(eng.gov, eng.budget, rows_list,
                                       lambda _rl: _pool_nbytes(geom), run,
                                       on_retry=on_retry)
        except RequestTimeout as e:
            for r in group:
                if r.expired():
                    eng._finish(r, TIMED_OUT, error=e)
                else:  # a rider with time left re-runs alone (classic path)
                    eng._requeue(r, no_batch=True)
            return
        except (SplitAndRetryOOM, OutOfBudget) as e:
            if (isinstance(e, OutOfBudget)
                    and _pool_nbytes(geom) <= eng.budget.limit):
                # the arbiter declared the pack non-retryable at a size
                # that FITS the budget: a real OOM (retry-cap/livelock),
                # not memory pressure — splitting would mask it behind
                # up to max_split_depth more doomed retry loops (the
                # classic path's fits-probe, kept at pack granularity)
                for r in group:
                    eng._finish(r, ERROR, error=e)
                return
            self._split_group(group, h, e, depth=depth, min_pages=min_pages,
                              pages_now=geom.num_pages)
            return
        except RetryOOM as e:
            # attempt_once retries RetryOOM internally; one escaping here
            # is a protocol leak — fail loudly, never swallow
            eng.metrics.count("protocol_leaked", req.session_id)
            for r in group:
                eng._finish(r, ERROR, error=e)
            return
        except ShuffleCapacityExceeded as e:
            # ragged kernels have no exchange to grow: terminal, explicit
            for r in group:
                eng._finish(r, ERROR, error=e)
            return
        except Exception as e:  # noqa: BLE001 - handler/kernel failure:
            # every popped member must reach a terminal state
            for r in group:
                eng._finish(r, ERROR, error=e)
            return
        run_ns = time.monotonic_ns() - run_t0
        with _trace.span(group[0].trace, _trace.SPAN_SCATTER,
                         task_id=group[0].task_id,
                         extra=f"handler:{h.name}:riders:{len(group)}"):
            for r, rows_out in zip(group, results):
                try:
                    value = (spec.result_of(rows_out, r.payload)
                             if spec.result_of is not None else rows_out)
                except (RetryOOM, SplitAndRetryOOM,
                        ShuffleCapacityExceeded) as e:
                    # result_of runs outside any bracket; a control signal
                    # here cannot be retried — terminal, never swallowed
                    eng._finish(r, ERROR, error=e)
                    continue
                except Exception as e:  # noqa: BLE001 - per-rider failure
                    eng._finish(r, ERROR, error=e)
                    continue
                eng.metrics.record_run(run_ns, handler=h.name)
                eng._finish(r, OK, value=value)

    def _split_group(self, group: List[Request], h, err: BaseException, *,
                     depth: int, min_pages: int, pages_now: int) -> None:
        """SplitAndRetryOOM at page granularity: halve the page count by
        partitioning riders into two packs.  A single rider falls back to
        the engine's per-request split protocol (h.split re-queue, or a
        loud terminal error) — a rider is never silently dropped.
        ``pages_now`` is the page count the FAILING pack actually used
        (it can exceed the ``min_pages`` floor), so the flight narration
        reports the real walk-down."""
        eng = self.engine
        if len(group) == 1:
            req = group[0]
            # classic protocol, classic accounting (class-split history
            # feeds the admission controller exactly as before)
            eng._split_requeue([req], h, err, payload=req.payload)
            return
        if depth >= eng.max_split_depth:
            # page halving exhausted: disband to the classic path, where
            # each rider gets its own bracket and split lineage
            eng.metrics.count("split_requeued", n=len(group))
            for r in group:
                eng._requeue(r, no_batch=True)
            return
        halves = [g for g in _split_requests(group, h.ragged) if g]
        _flight.record(
            _flight.EV_RAGGED_SPLIT, group[0].task_id,
            detail=f"handler:{h.name}:riders:{len(group)}:"
                   f"pages:{pages_now}->{max(1, pages_now // 2)}",
            value=depth + 1)
        eng.metrics.count("ragged_splits")
        for sub in halves:
            self._run_group(sub, h, depth=depth + 1,
                            min_pages=max(1, min_pages // 2))


def _split_requests(group: List[Request],
                    spec: RaggedSpec) -> List[List[Request]]:
    """Partition riders into two groups of roughly half the packed rows
    each (request order preserved) — the request-level view of a pack
    halving, cut at the SAME rider :func:`columnar.pages.split_point`
    would cut the row arrays (one algorithm, one owner)."""
    cut = _pages.split_point([spec.nrows(r.payload) for r in group])
    return [group[:cut], group[cut:]]
