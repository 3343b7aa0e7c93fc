"""Plan execution: pad, look up the executor, upload, run, download, and the
governed bracket around it (PyTorch port of ``plans/runtime.py``).

:func:`run_governed_plan` admits a whole plan as ONE working set through the
memory arbiter: RetryOOM re-runs the plan on the same batch, SplitAndRetryOOM
halves every scan table and runs the plan per half (partials combine by
addition), and one flight-recorder task brackets the plan.  Under a mesh the
admission outcome is agreed across the data axis, so every rank retries and
splits together.

Padding discipline: scan tables are padded on the host, in numpy, to the
dp-aligned pow2-quantized length (``parallel.shuffle.quantized_rows`` -- the
bucket lattice the plan cache keys on) with an appended row-valid array,
False on pad rows, that the executor ANDs into the pipeline mask -- more
padding never changes results, and the padded signature is the JAX
package's.  Under a mesh every rank takes the same host tables and uploads
its data shard of each scan table: rows ``[d*m/dp, (d+1)*m/dp)`` of the
padded length ``m`` at data index ``d`` (the block ``P(DATA_AXIS)`` gives
JAX device ``d``); ranks along the model axis take the same block, and dims
are uploaded whole.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.mem.governed import ShuffleCapacityExceeded
from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.obs.seam import COLLECTIVE, seam
from spark_rapids_jni_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    axis_group,
    axis_index,
    axis_size,
)
from spark_rapids_jni_tpu_torch.parallel.shuffle import quantized_rows
from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.cache import CompiledPlan, plan_cache
from spark_rapids_jni_tpu_torch.plans.compiler import (
    VALID_FIELD,
    _arg_layout,
    cached_compile,
    cached_executor,
    dtype_name,
    plan_device,
)

__all__ = ["pad_tables", "plan_working_set_bytes", "execute_plan", "run_governed_plan",
           "split_scan_tables", "combine_outputs", "input_signature_raw",
           "compiled_plan_for", "plan_inputs", "plan_retry_stats",
           "suggested_presplit_depth", "reset_plan_retry_stats"]

Tables = Dict[str, Dict[str, np.ndarray]]


# --------------------------------------------------------------------------
# per-plan retry statistics (adaptive admission)
#
# Every governed plan execution records its retry/split history per PLAN
# NAME — the request-class granularity the admission controller steers on.
# ``suggested_presplit_depth`` turns that history into a pre-emptive split
# depth: a plan whose recent runs SplitAndRetried starts its next run
# already split, skipping the doomed full-size attempt (and its blocked
# windows).  The hint DECAYS — one depth level per ``_PRESPLIT_DECAY_S``
# without a new split — so a transient pressure episode doesn't pin small
# pieces forever.  Gated on the serve_adaptive flag (and the controller
# kill switch), so static configurations never pre-split.
# --------------------------------------------------------------------------

_PRESPLIT_DECAY_S = 30.0
_STATS_LOCK = threading.Lock()
_PLAN_STATS: Dict[str, dict] = {}


def _stats_entry(name: str) -> dict:
    st = _PLAN_STATS.get(name)
    if st is None:
        st = _PLAN_STATS[name] = {
            "runs": 0, "retries": 0, "split_retries": 0,
            "presplit_depth": 0, "last_split_t": 0.0,
        }
    return st


def _record_plan_retry(name: str) -> None:
    with _STATS_LOCK:
        _stats_entry(name)["retries"] += 1


def _note_plan_run(name: str, presplit: int, reactive_splits: int,
                   max_depth: int) -> None:
    """Record one completed run: the observed total depth (pre-splits plus
    the depth implied by REACTIVE split events — pre-split invocations of
    the split callback are excluded, or the hint could never decay)
    becomes the new hint when it exceeds the decayed current one."""
    observed = presplit
    if reactive_splits > 0:
        observed += max(1, (reactive_splits + 1).bit_length() - 1)
    now = time.monotonic()
    with _STATS_LOCK:
        st = _stats_entry(name)
        st["runs"] += 1
        if reactive_splits > 0:
            st["split_retries"] += reactive_splits
            st["last_split_t"] = now
        # collapse the stored hint to its decayed value first, so a long-
        # faded episode doesn't resurrect at full depth on the next split
        st["presplit_depth"] = min(
            max(observed, _decayed_depth(st, now)), max_depth)


def _decayed_depth(st: dict, now: float) -> int:
    if st["presplit_depth"] <= 0 or st["last_split_t"] <= 0.0:
        return 0
    faded = int((now - st["last_split_t"]) / _PRESPLIT_DECAY_S)
    return max(0, st["presplit_depth"] - faded)


def plan_retry_stats() -> Dict[str, dict]:
    """Per-plan retry/split history (non-destructive copy), with the
    decayed ``suggested_depth`` the next run would start at."""
    now = time.monotonic()
    with _STATS_LOCK:
        return {name: dict(st, suggested_depth=_decayed_depth(st, now))
                for name, st in _PLAN_STATS.items()}


def suggested_presplit_depth(name: str, max_depth: int = 8) -> int:
    """Pre-emptive split depth for the next run of plan ``name`` (0 =
    attempt full size).  Returns 0 unless adaptive admission is enabled
    AND the kill switch is clear — the static path must stay untouched."""
    if not config.get("serve_adaptive") or config.get(
            "serve_controller_freeze"):
        return 0
    now = time.monotonic()
    with _STATS_LOCK:
        st = _PLAN_STATS.get(name)
        if st is None:
            return 0
        return min(_decayed_depth(st, now), max_depth)


def reset_plan_retry_stats() -> None:
    with _STATS_LOCK:
        _PLAN_STATS.clear()


_flight.register_telemetry_source("plan_retry", plan_retry_stats)


def _dp(mesh) -> int:
    return 1 if mesh is None else axis_size(mesh, DATA_AXIS)


def pad_tables(plan: ir.Plan, tables: Tables, dp: int) -> Tables:
    """Pad every scan table onto the pow2 bucket lattice (dp-aligned) and
    append its row-valid array; dims pass through contiguous."""
    scans = {s.table for s in ir.scan_tables(plan)}
    out: Tables = {}
    for table, fields in tables.items():
        if table not in scans:
            # dims already on the plan's device (run_governed_plan's one
            # upload per bracket) pass through untouched
            out[table] = {k: v if isinstance(v, torch.Tensor) else np.ascontiguousarray(v)
                          for k, v in fields.items()}
            continue
        n = len(next(iter(fields.values())))
        m = quantized_rows(n, dp)
        padded = {}
        for k, v in fields.items():
            if len(v) != n:
                raise ValueError(
                    f"ragged scan table {table!r}: field {k!r} has "
                    f"{len(v)} rows, expected {n}")
            if m == n:
                padded[k] = np.ascontiguousarray(v)
            else:
                padded[k] = np.concatenate([v, np.zeros(m - n, dtype=v.dtype)])
        valid = np.zeros(m, bool)
        valid[:n] = True
        padded[VALID_FIELD] = valid
        out[table] = padded
    return out


def input_signature_raw(plan: ir.Plan, tables: Tables, dp: int):
    """The padded-input signature of RAW (unpadded) ``tables`` -- exactly
    what :func:`compiler.input_signature` returns for
    ``pad_tables(plan, tables, dp)``, computed from lengths and dtypes alone,
    with no data movement."""
    scans = {s.table for s in ir.scan_tables(plan)}
    sig = []
    for kind, table, field in _arg_layout(plan):
        if field == VALID_FIELD:
            n = len(next(iter(tables[table].values())))
            sig.append((kind, table, field, "bool", quantized_rows(n, dp)))
            continue
        a = tables[table][field]
        m = quantized_rows(len(a), dp) if table in scans else len(a)
        sig.append((kind, table, field, dtype_name(a), m))
    return tuple(sig)


def compiled_plan_for(plan: ir.Plan, mesh, tables: Tables,
                      device: _device.DeviceLike = None) -> CompiledPlan:
    """The cached executor for (plan, mesh, ``tables``' geometry, and the
    device of a local plan) -- built on a miss, O(1) host work on a hit
    (signature from lengths and dtypes, no padding copies)."""
    return cached_executor(plan, mesh, input_signature_raw(plan, tables, _dp(mesh)), device)


def plan_working_set_bytes(plan: ir.Plan, tables: Tables, dp: int) -> int:
    """Admission estimate for one execution: quantized input bytes x3
    (inputs + masks/buckets + partials headroom), plus exchange send/recv
    buffers for plans with a shuffle."""
    scans = {s.table for s in ir.scan_tables(plan)}
    total = 0
    for table, fields in tables.items():
        if table not in scans:
            continue
        for v in fields.values():
            total += quantized_rows(len(v), dp) * v.itemsize
    total *= 3
    for node in ir.exchange_nodes(plan):
        slots = dp * dp * node.capacity
        total += 2 * slots * (8 * len(node.fields) + 10)
    return total


def plan_inputs(compiled: CompiledPlan, padded: Tables) -> List[torch.Tensor]:
    """The flat input tensors of ``compiled`` on its device, from padded host
    tables: each scan field's block of this rank's data index (the whole
    field for a local plan), each dim field whole.  A tensor already on the
    executor's device (an uploaded dim) passes through untouched."""
    scans = {s.table for s in ir.scan_tables(compiled.plan)}
    mesh = compiled.mesh
    dp = _dp(mesh)
    d = 0 if mesh is None else axis_index(mesh, DATA_AXIS)
    flat = []
    for name in compiled.arg_names:
        table, field = name.split(".", 1)
        arr = padded[table][field]
        if isinstance(arr, torch.Tensor):
            flat.append(arr.to(compiled.device))
            continue
        if table in scans and dp > 1:
            m = len(arr) // dp
            arr = arr[d * m:(d + 1) * m]
        flat.append(torch.from_numpy(np.ascontiguousarray(arr)).to(compiled.device))
    return flat


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def execute_plan(mesh, plan: ir.Plan, tables: Tables,
                 device: _device.DeviceLike = None) -> Dict[str, np.ndarray]:
    """One execution: pad, look up the executor (cached), upload, run,
    download.  A local plan (``mesh`` None) runs on ``device``, the card
    unless the caller asks for the CPU; under a mesh every rank calls this
    with the same host tables and runs on the mesh's device.

    Raises :class:`mem.governed.ShuffleCapacityExceeded` when an Exchange
    overflowed (``dropped > 0``): the caller grows the capacity and re-runs.
    ``dropped`` is summed over the data axis before the check, so every rank
    raises together and none is left waiting in a collective.  The launch
    crosses the ``COLLECTIVE`` seam, where a caller that runs plans on one
    rank from several threads serializes them
    (``obs.seam.serialize_category``).  No governance here: callers bracket
    this (:func:`run_governed_plan`, or the model runners' own drivers).
    """
    padded = pad_tables(plan, tables, _dp(mesh))
    compiled = cached_compile(plan, mesh, padded, device)
    flat = plan_inputs(compiled, padded)
    t0 = time.perf_counter()
    with seam(COLLECTIVE, f"launch:plan:{plan.name}"):
        outputs = {name: _host(v) for name, v in zip(compiled.out_names, compiled.fn(*flat))}
    plan_cache.record_execute(time.perf_counter() - t0)
    if int(outputs.get("dropped", 0)) > 0:
        raise ShuffleCapacityExceeded(
            f"{int(outputs['dropped'])} rows overflowed the plan's exchange capacity")
    return outputs


def split_scan_tables(tables: Tables, scans) -> List[Tables]:
    """Halve every scan table's rows (dims replicated into both halves).
    Exact for plans whose sinks are additive aggregates -- every plan here."""
    halves: List[Tables] = [{}, {}]
    scan_names = {s.table for s in scans}
    for table, fields in tables.items():
        if table not in scan_names:
            halves[0][table] = fields
            halves[1][table] = fields
            continue
        n = len(next(iter(fields.values())))
        halves[0][table] = {k: v[: n // 2] for k, v in fields.items()}
        halves[1][table] = {k: v[n // 2:] for k, v in fields.items()}
    return halves


def combine_outputs(results: Sequence[Dict[str, np.ndarray]]) -> Dict:
    """Element-wise sum of output dicts (additive partials)."""
    out = dict(results[0])
    for r in results[1:]:
        for k, v in r.items():
            out[k] = out[k] + v
    return out


def _upload_dims(plan: ir.Plan, tables: Tables, mesh, device: _device.DeviceLike) -> Tables:
    """Upload the plan's dim tables to its device ONCE per governed bracket:
    the tensors pass through :func:`pad_tables` and :func:`plan_inputs`
    untouched, so retry and split pieces never re-pay the transfer."""
    dims = ir.dim_tables(plan)
    if not dims:
        return tables
    dev = plan_device(mesh, device)
    out = dict(tables)
    for d in dims:
        out[d.table] = {
            # analyze: ignore[governed-allocation] - small replicated dim
            # tables uploaded ONCE per governed bracket and shared by
            # every retry/split piece; uploading inside the bracket would
            # re-pay the transfer up to 2^max_split_depth times.  Their
            # bytes ride the working-set margin.
            k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in tables[d.table].items()}
    return out


def run_governed_plan(
    mesh,
    plan: ir.Plan,
    tables: Tables,
    *,
    budget=None,
    task_id: int = 0,
    manage_task: bool = True,
    device: _device.DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Execute ``plan`` under ONE governed bracket.

    The whole pipeline is admitted as one working set; RetryOOM re-runs the
    plan on the same batch, SplitAndRetryOOM halves every scan table and
    re-executes the plan per half, and partial outputs combine by addition.
    One flight-recorder task spans the plan.  A local plan (``mesh`` None)
    runs on ``device``, the card unless the caller asks for the CPU; under a
    mesh every rank calls this with the same host tables, and the admission
    outcome and the adaptive pre-split depth are agreed over the data axis.

    The plan optimizer and the result cache (the ``plan_optimizer`` and
    ``serve_result_cache`` flags) are not ported yet: either flag raises
    ``NotImplementedError`` rather than being ignored.
    """
    from spark_rapids_jni_tpu_torch.mem.governed import (
        agreed_outcome,
        default_device_budget,
        run_with_split_retry,
        task_context,
    )

    for flag, item in (("plan_optimizer", "A.12 (plans/optimizer.py)"),
                       ("serve_result_cache", "A.15 (plans/rcache.py)")):
        if config.get(flag):
            raise NotImplementedError(
                f"run_governed_plan: the {flag!r} flag is set, but the port has no "
                f"{item} yet")
    dp = _dp(mesh)
    group = None if mesh is None else axis_group(mesh, DATA_AXIS)
    if budget is None:
        budget = default_device_budget()
    scans = ir.scan_tables(plan)
    tables = _upload_dims(plan, tables, mesh, device)
    # ordered row vectors do not combine by addition, and a row-halved
    # re-execution would need a merge step this path doesn't have: under
    # pressure an order plan retries at full size (RetryOOM) but never
    # silently splits into wrong answers
    max_split_depth = 0 if ir.order_sink(plan) is not None else 8

    # plan-granularity adaptive presplit: this request class's recent
    # retry history decides whether to skip the full-size attempt (0 under
    # static config / kill switch).  Each rank keeps its own history and
    # clock, so under a mesh the ranks take the deepest of their hints:
    # a rank that ran a different number of pieces would be left alone in
    # a collective.
    presplit = suggested_presplit_depth(plan.name, max_split_depth)
    if group is not None:
        presplit = agreed_outcome(presplit, group)
    inline_splits = [0]
    attempted = [False]  # flips at the first run attempt: split() calls
    # before it are the pre-split phase (NOT reactive pressure -- counting
    # them would pin the hint against decay)

    def split_counted(t):
        if attempted[0]:
            inline_splits[0] += 1
        return split_scan_tables(t, scans)

    def run(piece: Tables):
        attempted[0] = True
        return execute_plan(mesh, plan, piece, device=device)

    def on_retry(_count: int) -> None:
        _record_plan_retry(plan.name)

    ctx = (task_context(budget.gov, task_id) if manage_task
           else contextlib.nullcontext())
    with ctx:
        out = run_with_split_retry(
            budget, tables,
            nbytes_of=lambda t: plan_working_set_bytes(plan, t, dp),
            run=run,
            split=split_counted,
            combine=combine_outputs,
            max_split_depth=max_split_depth,
            initial_split_depth=presplit,
            on_retry=on_retry,
            group=group,
        )
    _note_plan_run(plan.name, presplit, inline_splits[0], max_split_depth)
    return out
