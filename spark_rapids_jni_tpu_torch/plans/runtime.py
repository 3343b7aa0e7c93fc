"""Plan execution: look up the executor, upload, run, download, and the
governed bracket around it (PyTorch port of ``plans/runtime.py``).

:func:`run_governed_plan` admits a whole plan as ONE working set through the
memory arbiter: RetryOOM re-runs the plan on the same batch, SplitAndRetryOOM
halves every scan table and runs the plan per half (partials combine by
addition), and one flight-recorder task brackets the plan.  Under a mesh the
admission outcome is agreed across the data axis, so every rank retries and
splits together.  Splits are reactive only: every call starts at full size,
and nothing of one call's retries carries to the next.

Upload discipline: the executor takes each scan table at the dp-aligned
pow2-quantized length (``parallel.shuffle.quantized_rows`` -- the bucket
lattice the plan cache keys on) with an appended row-valid array, False on
pad rows, that it ANDs into the pipeline mask -- more padding never changes
results, and the padded signature is the JAX package's (:func:`pad_tables`
and :func:`plan_inputs` define that layout on the host).  Under a mesh every
rank takes the same host tables and holds its data shard of each scan
table: rows ``[d*m/dp, (d+1)*m/dp)`` of the padded length ``m`` at data
index ``d`` (the block ``P(DATA_AXIS)`` gives JAX device ``d``); ranks along
the model axis take the same block, and dims are uploaded whole.

:func:`upload_inputs` builds that layout on the executor's device without
padding on the host: each block is allocated at its padded length, its pad
tail zeroed and its row-valid array written there, and only the block's
real rows cross from the host.  To a card they cross once, unpadded,
through a pinned staging ring of the calling thread (``STAGING_CHUNKS``
chunks of ``STAGING_CHUNK_BYTES``): a chunk is filled from the caller's
array while the card reads the previous one, and refilled only after the
event of its last copy.  The copies, and the executor after them, run on
the thread's current stream.  To the CPU they are plain copies.  Nothing is
kept between uploads but the ring: every call moves its tables' bytes.
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
from spark_rapids_jni_tpu_torch.obs.phases import PhaseTimes, trace_range
from spark_rapids_jni_tpu_torch.obs.seam import COLLECTIVE, TRANSFER, seam
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
    cached_executor,
    dtype_name,
    plan_device,
)

__all__ = ["pad_tables", "plan_working_set_bytes", "execute_plan", "run_governed_plan",
           "split_scan_tables", "combine_outputs", "input_signature_raw",
           "compiled_plan_for", "plan_inputs", "upload_inputs", "plan_upload_stats",
           "reset_plan_upload_stats", "PHASES", "STAGING_CHUNK_BYTES", "STAGING_CHUNKS"]

Tables = Dict[str, Dict[str, np.ndarray]]

# execute_plan's two steps, on the host clock: ``upload`` is the executor
# lookup, the padded layout on the device and the inputs' transfer to it;
# ``launch`` is the run and the download of its outputs (which waits for the
# device).  Inside ``srt.plan.upload`` the spans ``srt.plan.build`` (a cache
# miss, plans/cache.py), ``srt.plan.pad`` (the blocks' allocation, pad tails
# and row-valid arrays) and ``srt.plan.transfer`` (the real rows' copies)
# bound its three parts
PHASES = PhaseTimes("upload", "launch", name="plan")

#: each thread's pinned staging ring for uploads to a card: STAGING_CHUNKS
#: chunks of STAGING_CHUNK_BYTES, allocated on its first such upload
STAGING_CHUNK_BYTES = 64 << 20
STAGING_CHUNKS = 2


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


# --------------------------------------------------------------------------
# the upload: the padded layout built on the device, real rows staged
#
# Counters of every upload in the process, the flight recorder's
# ``plan_upload`` telemetry source: bytes staged through a pinned ring,
# bytes copied without one (to a CPU target, or a dim tensor moved whole),
# pad bytes written on the device (pad tails and row-valid arrays), and the
# waits for a ring chunk's last copy before it could be refilled.
# --------------------------------------------------------------------------

_UPLOAD_LOCK = threading.Lock()
_UPLOAD_KEYS = ("pinned_bytes", "unpinned_bytes", "pad_bytes", "chunk_waits")
_UPLOAD_STATS = dict.fromkeys(_UPLOAD_KEYS, 0)  # guarded-by: _UPLOAD_LOCK


class _ThreadRings(threading.local):
    def __init__(self):
        self.by_size: Dict[int, "_StagingRing"] = {}  # chunk bytes -> this thread's ring


_RINGS = _ThreadRings()


def plan_upload_stats() -> dict:
    """The upload counters (a copy), with ``pinned_share`` of the bytes that
    crossed from the host (None before any)."""
    with _UPLOAD_LOCK:
        out = dict(_UPLOAD_STATS)
    moved = out["pinned_bytes"] + out["unpinned_bytes"]
    out["pinned_share"] = out["pinned_bytes"] / moved if moved else None
    return out


def reset_plan_upload_stats() -> None:
    with _UPLOAD_LOCK:
        _UPLOAD_STATS.update(dict.fromkeys(_UPLOAD_KEYS, 0))


_flight.register_telemetry_source("plan_upload", plan_upload_stats)


class _StagingRing:
    """One thread's pinned host chunks (equal uint8 buffers), and for each
    the event of the last device copy that read it."""

    def __init__(self, chunks: List[torch.Tensor]):
        self.chunks = chunks
        self.events: List = [None] * len(chunks)
        self.turn = 0

    def copy(self, dst: torch.Tensor, src: torch.Tensor, stream) -> int:
        """``dst`` (1-D, on the card) from ``src`` (1-D, host, any stride),
        chunk by chunk; returns the waits for a chunk's last copy."""
        waits = 0
        step = self.chunks[0].numel() // src.element_size()
        for at in range(0, src.numel(), step):
            k = self.turn
            self.turn = (k + 1) % len(self.chunks)
            done = self.events[k]
            if done is not None and not done.query():
                waits += 1
                done.synchronize()
            part = src[at:at + step]
            stage = self.chunks[k][:part.numel() * part.element_size()].view(part.dtype)
            stage.copy_(part)  # on the host, without the interpreter lock
            dst[at:at + step].copy_(stage, non_blocking=True)
            done = self.events[k] = torch.cuda.Event()
            done.record(stream)
        return waits


def _ring(chunk_bytes: int) -> _StagingRing:
    ring = _RINGS.by_size.get(chunk_bytes)
    if ring is None:
        ring = _RINGS.by_size[chunk_bytes] = _StagingRing(
            [torch.empty(chunk_bytes, dtype=torch.uint8, pin_memory=True)
             for _ in range(STAGING_CHUNKS)])
    return ring


def _host_tensor(v) -> torch.Tensor:
    """A caller's host column as a tensor over the same memory (a copy only
    for a numpy array with a negative stride, which torch cannot view)."""
    a = np.asarray(v)
    if any(st < 0 for st in a.strides):
        a = np.ascontiguousarray(a)
    return torch.from_numpy(a)


def _scan_rows(table: str, fields) -> int:
    n = len(next(iter(fields.values())))
    for k, v in fields.items():
        if len(v) != n:
            raise ValueError(
                f"ragged scan table {table!r}: field {k!r} has {len(v)} rows, expected {n}")
    return n


def upload_inputs(compiled: CompiledPlan, tables: Tables, *,
                  chunk_bytes: int = STAGING_CHUNK_BYTES) -> List[torch.Tensor]:
    """The flat input tensors of ``compiled`` on its device, from RAW (unpadded)
    ``tables``: element for element and dtype for dtype
    ``plan_inputs(compiled, pad_tables(plan, tables, dp))``, with no padded
    host copy.  Each scan field's block of this rank's data index is
    allocated on the device at its padded length and its pad tail zeroed
    there; its row-valid array is written there; only the block's real rows
    are copied in.  Dims are copied whole, and a tensor already on the
    executor's device passes through untouched.  Copies to a card go
    through the calling thread's pinned ring of ``chunk_bytes`` chunks on
    its current stream; copies to the CPU are plain.  The allocation and
    fills are the span ``srt.plan.pad``, the copies ``srt.plan.transfer``
    inside the ``TRANSFER`` seam ``plan_upload:<name>``."""
    plan = compiled.plan
    scans = {s.table for s in ir.scan_tables(plan)}
    dev = compiled.device
    dp = _dp(compiled.mesh)
    d = 0 if compiled.mesh is None else axis_index(compiled.mesh, DATA_AXIS)
    flat, copies, passing = [], [], []
    pad_bytes = 0
    with trace_range("srt.plan.pad"):
        blocks = {}  # scan table -> (block rows, first real row, real rows)
        for name in compiled.arg_names:
            table, field = name.split(".", 1)
            fields = tables[table]
            if table not in scans:
                v = fields[field]
                if isinstance(v, torch.Tensor):
                    passing.append(len(flat))  # moved, if elsewhere, with the copies
                    flat.append(v)
                    continue
                src = _host_tensor(v)
                out = torch.empty(src.shape, dtype=src.dtype, device=dev)
                copies.append((out, src))
                flat.append(out)
                continue
            if table not in blocks:
                n = _scan_rows(table, fields)
                b = quantized_rows(n, dp) // dp
                lo = min(d * b, n)
                blocks[table] = (b, lo, min(lo + b, n) - lo)
            b, lo, real = blocks[table]
            if field == VALID_FIELD:
                out = torch.empty(b, dtype=torch.bool, device=dev)
                out[:real].fill_(True)
                out[real:].fill_(False)
                pad_bytes += b
            else:
                src = _host_tensor(fields[field])
                out = torch.empty(b, dtype=src.dtype, device=dev)
                out[real:].zero_()
                pad_bytes += (b - real) * out.element_size()
                copies.append((out[:real], src[lo:lo + real]))
            flat.append(out)
    pinned = unpinned = waits = 0
    with seam(TRANSFER, f"plan_upload:{plan.name}"), trace_range("srt.plan.transfer"):
        for i in passing:
            v = flat[i]
            flat[i] = v.to(dev)
            if flat[i] is not v:
                unpinned += v.numel() * v.element_size()
        ring = stream = None
        for dst, src in copies:
            nbytes = dst.numel() * dst.element_size()
            if dev.type == "cuda":
                if ring is None:
                    ring, stream = _ring(chunk_bytes), torch.cuda.current_stream(dev)
                waits += ring.copy(dst, src, stream)
                pinned += nbytes
            else:
                dst.copy_(src)
                unpinned += nbytes
    with _UPLOAD_LOCK:
        _UPLOAD_STATS["pinned_bytes"] += pinned
        _UPLOAD_STATS["unpinned_bytes"] += unpinned
        _UPLOAD_STATS["pad_bytes"] += pad_bytes
        _UPLOAD_STATS["chunk_waits"] += waits
    return flat


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def execute_plan(mesh, plan: ir.Plan, tables: Tables,
                 device: _device.DeviceLike = None) -> Dict[str, np.ndarray]:
    """One execution: look up the executor (cached), upload
    (:func:`upload_inputs`), run, download.  A local plan (``mesh`` None) runs on ``device``, the card
    unless the caller asks for the CPU; under a mesh every rank calls this
    with the same host tables and runs on the mesh's device.

    Raises :class:`mem.governed.ShuffleCapacityExceeded` when an Exchange
    overflowed (``dropped > 0``): the caller grows the capacity and re-runs.
    ``dropped`` is summed over the data axis before the check, so every rank
    raises together and none is left waiting in a collective.  The launch
    crosses the ``COLLECTIVE`` seam, where a caller that runs plans on one
    rank from several threads serializes them
    (``obs.seam.serialize_category``), as
    ``launch:plan:<signature>``; the upload crosses ``TRANSFER``
    ``plan_upload:<name>`` and building an executor on a cache miss crosses
    ``COMPILE`` ``plan:<signature>``, the JAX package's seams.  No governance here: callers bracket
    this (:func:`run_governed_plan`, or the model runners' own drivers).
    """
    with PHASES.phase("upload"):
        compiled = compiled_plan_for(plan, mesh, tables, device)
        flat = upload_inputs(compiled, tables)
    t0 = time.perf_counter()
    with PHASES.phase("launch"), seam(COLLECTIVE, f"launch:plan:{ir.plan_signature(plan)}"):
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
    the tensors pass through :func:`upload_inputs` untouched, so retry and
    split pieces never re-pay the transfer."""
    dims = ir.dim_tables(plan)
    if not dims:
        return tables
    dev = plan_device(mesh, device)
    out = dict(tables)
    with trace_range("srt.plan.transfer"):
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
    An order plan (Sort/TopK sink) never splits: it retries at full size.
    One flight-recorder task spans the plan.  A local plan (``mesh`` None)
    runs on ``device``, the card unless the caller asks for the CPU; under a
    mesh every rank calls this with the same host tables, and the admission
    outcome is agreed over the data axis.  Every call starts at full size: a
    split follows only an admission that refused the piece.

    With the ``plan_optimizer`` flag set, the stats of ``tables`` are
    recorded (models/tables.py) and the plan is rewritten first
    (plans/optimizer.py).  With the ``serve_result_cache`` flag set, the
    governed result cache (plans/rcache.py) is consulted before admission: a
    hit returns the cached outputs without a reservation, a retry bracket or
    a launch, and a computed result is stored after the bracket.
    """
    from spark_rapids_jni_tpu_torch.mem.governed import (
        default_device_budget,
        run_with_split_retry,
        task_context,
    )

    dp = _dp(mesh)
    group = None if mesh is None else axis_group(mesh, DATA_AXIS)
    if budget is None:
        budget = default_device_budget()
    # the stats-driven rewriter runs first: stats observed from this upload
    # seed its join-reorder rule.  Memoized per (plan, stats); off by default
    if config.get("plan_optimizer"):
        from spark_rapids_jni_tpu_torch.models import tables as _tabreg
        from spark_rapids_jni_tpu_torch.plans.optimizer import optimize_plan

        _tabreg.observe_tables(tables)
        plan = optimize_plan(plan)
    # the result cache consults BEFORE admission: a hit costs a fingerprint
    # pass over the raw host tables -- never a reservation, a retry bracket
    # or a launch.  Fingerprinted here, before the dim upload below moves
    # anything to the device; the canonicalized plan keys it
    ckey = cdeps = None
    if config.get("serve_result_cache"):
        from spark_rapids_jni_tpu_torch.obs import trace as _trace
        from spark_rapids_jni_tpu_torch.plans.rcache import plan_result_key, result_cache

        ckey, cdeps = plan_result_key(plan, dp, tables)
        hit = result_cache.lookup(ckey)
        if hit is not None:
            with _trace.maybe_span(_trace.SPAN_CACHE, extra=f"plan:{plan.name}"):
                return hit
    scans = ir.scan_tables(plan)
    tables = _upload_dims(plan, tables, mesh, device)
    # ordered row vectors do not combine by addition, and a row-halved
    # re-execution would need a merge step this path doesn't have: under
    # pressure an order plan retries at full size (RetryOOM) but never
    # silently splits into wrong answers
    max_split_depth = 0 if ir.order_sink(plan) is not None else 8

    ctx = (task_context(budget.gov, task_id) if manage_task
           else contextlib.nullcontext())
    with ctx:
        out = run_with_split_retry(
            budget, tables,
            nbytes_of=lambda t: plan_working_set_bytes(plan, t, dp),
            run=lambda piece: execute_plan(mesh, plan, piece, device=device),
            split=lambda t: split_scan_tables(t, scans),
            combine=combine_outputs,
            max_split_depth=max_split_depth,
            group=group,
        )
    if ckey is not None:
        from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

        # put() revalidates cdeps against the live version registry: a table
        # bumped while this plan computed drops the insert
        result_cache.put(ckey, out, cdeps, label=plan.name)
    return out
