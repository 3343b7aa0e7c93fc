"""Plan execution: pad, look up the executor, upload, run, download (PyTorch
port of ``plans/runtime.py``, without its governed bracket).

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

import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.mem.governed import ShuffleCapacityExceeded
from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, axis_index, axis_size
from spark_rapids_jni_tpu_torch.parallel.shuffle import quantized_rows
from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.cache import CompiledPlan, plan_cache
from spark_rapids_jni_tpu_torch.plans.compiler import (
    VALID_FIELD,
    _arg_layout,
    cached_compile,
    cached_executor,
)

__all__ = ["pad_tables", "plan_working_set_bytes", "execute_plan", "split_scan_tables",
           "combine_outputs", "input_signature_raw", "compiled_plan_for", "plan_inputs"]

Tables = Dict[str, Dict[str, np.ndarray]]


def _dp(mesh) -> int:
    return 1 if mesh is None else axis_size(mesh, DATA_AXIS)


def pad_tables(plan: ir.Plan, tables: Tables, dp: int) -> Tables:
    """Pad every scan table onto the pow2 bucket lattice (dp-aligned) and
    append its row-valid array; dims pass through contiguous."""
    scans = {s.table for s in ir.scan_tables(plan)}
    out: Tables = {}
    for table, fields in tables.items():
        if table not in scans:
            out[table] = {k: np.ascontiguousarray(v) for k, v in fields.items()}
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
        sig.append((kind, table, field, str(a.dtype), m))
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
    field for a local plan), each dim field whole."""
    scans = {s.table for s in ir.scan_tables(compiled.plan)}
    mesh = compiled.mesh
    dp = _dp(mesh)
    d = 0 if mesh is None else axis_index(mesh, DATA_AXIS)
    flat = []
    for name in compiled.arg_names:
        table, field = name.split(".", 1)
        arr = padded[table][field]
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
    raises together and none is left waiting in a collective.
    """
    padded = pad_tables(plan, tables, _dp(mesh))
    compiled = cached_compile(plan, mesh, padded, device)
    flat = plan_inputs(compiled, padded)
    t0 = time.perf_counter()
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
