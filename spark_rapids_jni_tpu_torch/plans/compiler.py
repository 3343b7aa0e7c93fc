"""Plan executor: build a whole query plan into one callable over its flat
inputs (PyTorch port of ``plans/compiler.py``).

Where the JAX package traces a plan into one jitted (``shard_map``'d)
program, the port builds a plain Python closure once per (plan, mesh, input
signature) and keeps it in the plan cache (plans/cache.py).  Calling it runs
the emitters eagerly on tensors: every IR node maps onto the torch ops of
the port's per-op model bodies, so a plan's results equal the per-op path
bit for bit.  Under a mesh the closure runs on each rank over that rank's
data shard and sums every sink output over the data axis (one
``all_reduce`` per dtype) before ``post`` runs, as the JAX program psums
before ``post``.

The order tier runs here too: Window, Sort and TopK emitters sort rows by
their canonical u64 ranks (plans/window.py), and a plan with a RangeExchange
splits at it (:func:`split_exchange_plan`) into a map side that emits range
partitions (:func:`emit_range_partitions`) and a local reduce plan.

Building an executor crosses ``seam(COMPILE, "plan:<signature>")`` and, once
per Exchange node inside it, ``seam(COLLECTIVE, "all_to_all_shuffle")``:
the JAX package crosses the shuffle's seam while it traces the program, once
per compiled plan, so the port crosses it once per built executor, not on
every run.  The ragged calling convention (:class:`RaggedProgram`,
:func:`cached_ragged_compile`) closes a handler kernel over its page
geometry for the serving tier's page-pool ticks (serve/ragged.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.obs.phases import PhaseTimes
from spark_rapids_jni_tpu_torch.obs.seam import COLLECTIVE, COMPILE, seam
from spark_rapids_jni_tpu_torch.ops.agg_cuda import segment_sum
from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_size
from spark_rapids_jni_tpu_torch.parallel.shuffle import all_to_all_shuffle, partition_of
from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans import window as win
from spark_rapids_jni_tpu_torch.plans.cache import CompiledPlan, plan_cache

__all__ = ["compile_plan", "cached_compile", "cached_executor", "input_signature",
           "output_names", "emitter", "plan_device", "segment_sum", "window_index", "DTYPES",
           "EXCHANGE_SOURCE", "split_exchange_plan", "emit_exchange_partitions",
           "emit_range_partitions", "sample_range_splitters", "eval_post", "RANGE_PHASES",
           "RaggedProgram", "compile_ragged", "cached_ragged_compile"]

DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "int32": torch.int32,
    "int64": torch.int64,
    "float32": torch.float32,
    "float64": torch.float64,
}

#: the implicit per-scan row-validity input the executor appends
VALID_FIELD = "__valid__"

#: emit_range_partitions' steps, on the host clock, each ended by a wait for
#: the device: the upload and the exchange's child subtree (``emit``), the
#: ranks, the key-order sort and the partition bounds (``rank_sort``), and
#: the partitions' transfer to host numpy (``download``)
RANGE_PHASES = PhaseTimes("emit", "rank_sort", "download", name="range")


def _dtype(name: str) -> torch.dtype:
    if name == "uint64":
        # torch's uint64 lacks +, <, >> and %: comparing or adding the int64
        # bits as if they were signed would give wrong answers silently
        raise ValueError("the port's executor does not support uint64 casts or "
                         "aggregates: torch's uint64 lacks +, <, >> and %")
    if name not in DTYPES:
        raise ValueError(f"unknown plan dtype {name!r}")
    return DTYPES[name]


# ---------------------------------------------------------------- expressions


def _min_max(op: str, a, b):
    """``jnp.minimum``/``jnp.maximum``, which take python ints: a python
    bound clamps the tensor and keeps its dtype."""
    a_t, b_t = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
    if not a_t and not b_t:
        return min(a, b) if op == "min" else max(a, b)
    if not a_t:
        a, b = b, a
    if not isinstance(b, torch.Tensor):
        return torch.clamp(a, max=b) if op == "min" else torch.clamp(a, min=b)
    return torch.minimum(a, b) if op == "min" else torch.maximum(a, b)


_BIN = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "and": lambda a, b: a & b,
    "or": lambda a, b: a | b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "ge": lambda a, b: a >= b,
    "gt": lambda a, b: a > b,
    "le": lambda a, b: a <= b,
    "lt": lambda a, b: a < b,
    "min": lambda a, b: _min_max("min", a, b),
    "max": lambda a, b: _min_max("max", a, b),
    "shl": lambda a, b: a << b,
    "band": lambda a, b: a & b,
    "bor": lambda a, b: a | b,
}


def _eval(expr, env: Dict[str, object]):
    """Evaluate an IR expression against an environment of tensors (or, for
    Plan.post, of aggregate output vectors).  Literals stay python scalars,
    so they take the other operand's dtype as JAX's weak types do; two
    tensors of different dtypes first promote to a common one, as JAX
    arrays do (torch would keep a dimensioned tensor's dtype against a
    0-d one)."""
    if isinstance(expr, ir.Col):
        return env[expr.name]
    if isinstance(expr, ir.Lit):
        return expr.value
    if isinstance(expr, ir.Cast):
        return torch.as_tensor(_eval(expr.x, env)).to(_dtype(expr.dtype))
    if isinstance(expr, ir.Unary):
        x = _eval(expr.x, env)
        return (~x) if expr.op == "not" else (-x)
    if isinstance(expr, ir.Bin):
        a = _eval(expr.lhs, env)
        b = _eval(expr.rhs, env)
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor) and a.dtype != b.dtype:
            dt = torch.promote_types(a.dtype, b.dtype)
            a, b = a.to(dt), b.to(dt)
        return _BIN[expr.op](a, b)
    raise TypeError(f"not an IR expression: {expr!r}")


# ------------------------------------------------------------------- emitters


class _Ctx:
    """One execution: bound input tensors + exchange-drop accumulation."""

    def __init__(self, inputs, rowvalid, mesh):
        self.inputs = inputs      # table -> field -> tensor
        self.rowvalid = rowvalid  # scan table -> bool tensor
        self.mesh = mesh
        self.dropped: List[torch.Tensor] = []


class _Rows:
    """A row-level pipeline state: named columns + the AND'd mask."""

    def __init__(self, cols: Dict[str, object], mask: torch.Tensor):
        self.cols = cols
        self.mask = mask


_EMITTERS: Dict[type, Callable] = {}


def emitter(node_cls):
    """Register the emit function of one IR node type."""

    def deco(fn):
        _EMITTERS[node_cls] = fn
        return fn

    return deco


def _emit(node, ctx: _Ctx):
    return _EMITTERS[type(node)](node, ctx)


@emitter(ir.Scan)
def _emit_scan(node: ir.Scan, ctx: _Ctx) -> _Rows:
    cols = {f: ctx.inputs[node.table][f] for f in node.fields}
    return _Rows(cols, ctx.rowvalid[node.table])


@emitter(ir.Filter)
def _emit_filter(node: ir.Filter, ctx: _Ctx) -> _Rows:
    rows = _emit(node.child, ctx)
    return _Rows(rows.cols, rows.mask & _eval(node.pred, rows.cols))


@emitter(ir.Project)
def _emit_project(node: ir.Project, ctx: _Ctx) -> _Rows:
    rows = _emit(node.child, ctx)
    cols = dict(rows.cols)
    for name, expr in node.cols:
        cols[name] = _eval(expr, cols)
    return _Rows(cols, rows.mask)


@emitter(ir.GatherJoin)
def _emit_gather_join(node: ir.GatherJoin, ctx: _Ctx) -> _Rows:
    rows = _emit(node.child, ctx)
    dim = ctx.inputs[node.dim.table]
    key = _eval(node.key, rows.cols)
    base = _eval(node.base, rows.cols)
    n_dim = dim[node.fields[0][0]].shape[0]
    idx = torch.clamp(key - base, 0, n_dim - 1)
    cols = dict(rows.cols)
    for dfield, out in node.fields:
        cols[out] = dim[dfield][idx]
    return _Rows(cols, rows.mask)


@emitter(ir.SemiJoinWindow)
def _emit_semi_join_window(node: ir.SemiJoinWindow, ctx: _Ctx) -> _Rows:
    rows = _emit(node.child, ctx)
    dim_sk = ctx.inputs[node.dim.table][node.sk_field]
    dim_days = ctx.inputs[node.dim.table][node.days_field]
    date = _eval(node.key, rows.cols)
    valid = _eval(node.key_valid, rows.cols)
    lo = _eval(node.lo, rows.cols)
    hi = _eval(node.hi, rows.cols)
    idx = window_index(dim_sk, date)
    hit = dim_sk[idx] == date
    in_win = (dim_days[idx] >= lo) & (dim_days[idx] < hi)
    return _Rows(rows.cols, rows.mask & valid & hit & in_win)


def window_index(dim_sk: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """``clip(searchsorted(dim_sk, keys), 0, len - 1)``: torch's searchsorted
    wants the boundaries and the values in one dtype."""
    dt = torch.promote_types(dim_sk.dtype, keys.dtype)
    idx = torch.searchsorted(dim_sk.to(dt), keys.to(dt))
    return torch.clamp(idx, 0, dim_sk.shape[0] - 1)


@emitter(ir.SegmentAgg)
def _emit_segment_agg(node: ir.SegmentAgg, ctx: _Ctx) -> Dict[str, object]:
    rows = _emit(node.child, ctx)
    # masked rows take id -1, which segment_sum drops like every id outside
    # [0, num_segments): bit-identical to the JAX drop-bucket form.  It is
    # looked up here, as this module's global, on every call.
    ids = torch.where(rows.mask, _eval(node.key, rows.cols), -1)
    out = {}
    for name, value_expr, dtype in node.aggs:
        vals = torch.where(rows.mask, _eval(value_expr, rows.cols), 0).to(_dtype(dtype))
        out[name] = segment_sum(vals, ids, node.num_segments)
    return out


@emitter(ir.Union)
def _emit_union(node: ir.Union, ctx: _Ctx) -> _Rows:
    parts = [_emit(c, ctx) for c in node.children]
    fields = [f for f in parts[0].cols if all(f in p.cols for p in parts)]
    cols = {f: torch.cat([p.cols[f] for p in parts]) for f in fields}
    cols[node.tag] = torch.cat([
        torch.full(p.mask.shape, tv, dtype=torch.int8, device=p.mask.device)
        for p, tv in zip(parts, node.tag_values)
    ])
    return _Rows(cols, torch.cat([p.mask for p in parts]))


@emitter(ir.Exchange)
def _emit_exchange(node: ir.Exchange, ctx: _Ctx) -> _Rows:
    rows = _emit(node.child, ctx)
    part = partition_of(_eval(node.key, rows.cols), axis_size(ctx.mesh, DATA_AXIS))
    ex = all_to_all_shuffle({f: rows.cols[f] for f in node.fields}, part, node.capacity,
                            ctx.mesh, axis=DATA_AXIS, row_valid=rows.mask)
    ctx.dropped.append(ex.dropped)
    return _Rows(dict(ex.columns), ex.valid)


@emitter(ir.RangeExchange)
def _emit_range_exchange(node: ir.RangeExchange, ctx: _Ctx):
    # registered so that split_exchange_plan knows the node; there is no
    # in-process body -- summing over the data axis cannot merge ordered row
    # vectors, so a range shuffle only exists split at the exchange
    raise ValueError(
        "RangeExchange has no in-process emitter: split the plan "
        "(split_exchange_plan) and run it on the serve shuffle plane, or "
        "through its single-process oracle (serve.shuffle."
        "run_range_plan_local)")


def _order_env(keys, cols, mask):
    """(permutation, sorted per-key ranks) for ``(expr, ascending)`` sort keys
    over a row environment -- the shared front half of every order-sensitive
    emitter."""
    ranks = [win.sort_rank(torch.as_tensor(_eval(e, cols)), asc) for e, asc in keys]
    order = win.order_permutation(ranks, mask)
    return order, [r[order] for r in ranks]


def _gather_cols(cols, order):
    return {k: v[order] if isinstance(v, torch.Tensor) and v.dim() else v
            for k, v in cols.items()}


@emitter(ir.Window)
def _emit_window(node: ir.Window, ctx: _Ctx) -> _Rows:
    rows = _emit(node.child, ctx)
    pkeys = tuple((e, True) for e in node.partition_by)
    order, sranks = _order_env(pkeys + node.order_by, rows.cols, rows.mask)
    cols = _gather_cols(rows.cols, order)
    mask = rows.mask[order]
    np_keys = len(node.partition_by)
    run_start = win.run_boundaries(sranks[:np_keys], mask)
    ochange = (win.change_points(sranks[np_keys:]) if node.order_by
               else torch.zeros_like(run_start))
    for f in node.funcs:
        if f.kind == "row_number":
            out = win.row_number(run_start)
        elif f.kind == "rank":
            out = win.rank(run_start, ochange)
        elif f.kind == "dense_rank":
            out = win.dense_rank(run_start, ochange)
        else:
            v = torch.as_tensor(_eval(f.arg, cols)).to(_dtype(f.dtype))
            # invalid rows sort last and open their own run (run_boundaries),
            # so they never reach a valid segment; zeroing keeps even the
            # masked outputs finite
            v = torch.where(mask, v, torch.zeros((), dtype=v.dtype, device=v.device))
            if f.kind == "sum":
                out = win.framed_sum(v, run_start, f.preceding)
            else:
                out = win.framed_minmax(v, run_start, f.kind, f.preceding)
        if f.kind in ("rank", "dense_rank", "row_number"):
            out = out.to(_dtype(f.dtype))
        cols[f.name] = out
    return _Rows(cols, mask)


def _order_sink_outputs(node, ctx: _Ctx, k=None) -> Dict[str, object]:
    """Shared Sort/TopK sink body: order rows (invalid last), emit the named
    field vectors plus the implicit valid-``rows`` count; TopK keeps the first
    ``min(k, n)`` rows."""
    rows = _emit(node.child, ctx)
    order, _ranks = _order_env(node.keys, rows.cols, rows.mask)
    cols = _gather_cols(rows.cols, order)
    nvalid = rows.mask.to(torch.int64).sum()
    out = {}
    for f in node.fields:
        v = cols[f]
        out[f] = v[:min(int(k), v.shape[0])] if k is not None else v
    out["rows"] = torch.clamp(nvalid, max=k) if k is not None else nvalid
    return out


@emitter(ir.Sort)
def _emit_sort(node: ir.Sort, ctx: _Ctx) -> Dict[str, object]:
    return _order_sink_outputs(node, ctx)


@emitter(ir.TopK)
def _emit_topk(node: ir.TopK, ctx: _Ctx) -> Dict[str, object]:
    return _order_sink_outputs(node, ctx, k=int(node.k))


@emitter(ir.PresenceCount)
def _emit_presence_count(node: ir.PresenceCount, ctx: _Ctx) -> Dict[str, object]:
    # lazy: models.q97 imports plans at module level; _count_runs stays
    # single-owner over there
    from spark_rapids_jni_tpu_torch.models.q97 import _count_runs

    rows = _emit(node.child, ctx)
    so, co, b = _count_runs(rows.cols[node.key], rows.cols[node.tag] == 1, rows.mask)
    return dict(zip(node.names, (so, co, b)))


# ------------------------------------------------------------------ compiling


def output_names(plan: ir.Plan) -> Tuple[str, ...]:
    """Static output order of a compiled plan: sink outputs in sink/agg
    order, then the implicit ``dropped`` (plans with an Exchange), then post
    outputs -- filtered/ordered by ``plan.outputs`` when set."""
    names: List[str] = []
    ir.order_sink(plan)  # validates that an order sink is the plan's only sink
    for sink in plan.sinks:
        if isinstance(sink, ir.SegmentAgg):
            names.extend(name for name, _e, _d in sink.aggs)
        elif isinstance(sink, ir.PresenceCount):
            names.extend(sink.names)
        elif isinstance(sink, (ir.Sort, ir.TopK)):
            # ordered field vectors plus the implicit valid-row count
            names.extend(sink.fields)
            names.append("rows")
        else:
            raise TypeError(f"not a sink node: {sink!r}")
    if ir.has_exchange(plan):
        names.append("dropped")
    names.extend(name for name, _e in plan.post)
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate output names in plan {plan.name!r}")
    if plan.outputs:
        missing = set(plan.outputs) - set(names)
        if missing:
            raise ValueError(f"unknown plan outputs {sorted(missing)}")
        if ir.has_exchange(plan) and "dropped" not in plan.outputs:
            # the runtime's overflow guard reads 'dropped' from the outputs;
            # filtering it away would silently disable ShuffleCapacityExceeded
            # and return wrong counts on overflow
            raise ValueError(
                f"plan {plan.name!r} contains an Exchange: its 'outputs' "
                f"must include 'dropped' (the overflow retry signal)")
        return tuple(plan.outputs)
    return tuple(names)


def _arg_layout(plan: ir.Plan):
    """Flat argument order: scans (table-sorted; fields then the implicit
    row-valid), then dims (table-sorted)."""
    layout = []
    for scan in ir.scan_tables(plan):
        for f in scan.fields:
            layout.append(("scan", scan.table, f))
        layout.append(("scan", scan.table, VALID_FIELD))
    for dim in ir.dim_tables(plan):
        for f in dim.fields:
            layout.append(("dim", dim.table, f))
    return layout


def input_signature(plan: ir.Plan, tables) -> Tuple:
    """The dtype+bucket signature of already-padded host input ``tables``
    (table -> field -> numpy array, row-valid included) in flat arg order --
    the variable half of the plan-cache key."""
    sig = []
    for kind, table, field in _arg_layout(plan):
        a = tables[table][field]
        sig.append((kind, table, field, dtype_name(a), int(a.shape[0])))
    return tuple(sig)


def dtype_name(a) -> str:
    """The numpy name of ``a``'s dtype, for a numpy array or a tensor (an
    uploaded dim), so a signature is the JAX package's either way."""
    return str(a.dtype).removeprefix("torch.")


def plan_device(mesh, device: _device.DeviceLike = None) -> torch.device:
    """Where a plan runs: on its mesh's device (this rank's current card for a
    CUDA mesh), else on ``device`` (the card unless the caller asks for the
    CPU)."""
    if mesh is not None:
        if mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(mesh.device_type)
    return _device.resolve(device)


def _sum_over(outputs: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """Every output summed over ``group``: one ``all_reduce`` per dtype, over
    the outputs of that dtype flattened into one buffer."""
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for name, v in outputs.items():
        by_dtype.setdefault(v.dtype, []).append(name)
    summed = {}
    for names in by_dtype.values():
        flat = torch.cat([outputs[n].reshape(-1) for n in names])
        dist.all_reduce(flat, group=group)
        at = 0
        for n in names:
            size = outputs[n].numel()
            summed[n] = flat[at:at + size].reshape(outputs[n].shape)
            at += size
    return {name: summed[name] for name in outputs}


def compile_plan(plan: ir.Plan, mesh, signature: Tuple,
                 device: _device.DeviceLike = None) -> CompiledPlan:
    """Build the executor of ``plan`` for one input signature.  Uncached --
    go through :func:`cached_compile`."""
    layout = _arg_layout(plan)
    if len(signature) != len(layout):
        raise ValueError("signature does not match the plan's arg layout")
    out_names = output_names(plan)
    local = mesh is None
    if local and ir.has_exchange(plan):
        raise ValueError(f"plan {plan.name!r} contains an Exchange: mesh required")
    if ir.range_exchange_nodes(plan):
        raise ValueError(
            f"plan {plan.name!r} contains a RangeExchange: it only runs "
            f"split across the serve shuffle plane (split_exchange_plan)")
    if not local and ir.order_sink(plan) is not None:
        # the mesh path sums every sink output over the data axis: right for
        # additive partials, wrong for ordered row vectors, which a range
        # shuffle distributes instead
        raise ValueError(
            f"plan {plan.name!r} has an order-sensitive sink: compile "
            f"locally (per shuffle partition), not under a mesh")
    group = None if local else axis_group(mesh, DATA_AXIS)

    def run(*flat):
        inputs: Dict[str, Dict[str, torch.Tensor]] = {}
        rowvalid: Dict[str, torch.Tensor] = {}
        for (_kind, table, field), t in zip(layout, flat):
            if field == VALID_FIELD:
                rowvalid[table] = t
            else:
                inputs.setdefault(table, {})[field] = t
        ctx = _Ctx(inputs, rowvalid, mesh)
        outputs: Dict[str, object] = {}
        for sink in plan.sinks:
            outputs.update(_emit(sink, ctx))
        if ctx.dropped:
            outputs["dropped"] = sum(ctx.dropped[1:], ctx.dropped[0])
        if not local:
            outputs = _sum_over(outputs, group)
        for name, expr in plan.post:
            outputs[name] = _eval(expr, outputs)
        return tuple(outputs[n] for n in out_names)

    with seam(COMPILE, f"plan:{ir.plan_signature(plan)}"):
        for _node in ir.exchange_nodes(plan):
            # the JAX package's trace-time crossing of the shuffle's seam
            with seam(COLLECTIVE, "all_to_all_shuffle"):
                pass
        return CompiledPlan(run, plan, mesh, signature, out_names,
                            tuple(f"{t}.{f}" for _k, t, f in layout),
                            plan_device(mesh, device))


def cached_executor(plan: ir.Plan, mesh, signature: Tuple,
                    device: _device.DeviceLike = None) -> CompiledPlan:
    """The executor for (plan, mesh, input signature, and the device of a
    local plan) from the process-global plan cache, built on a miss.  A mesh
    plan's key also holds the data axis's process group, the one its
    executor sums over: equal meshes over a group made again (after
    ``destroy_process_group``) build a new executor, not one bound to the
    destroyed group."""
    dev = plan_device(mesh, device)
    key = ((plan, mesh, axis_group(mesh, DATA_AXIS), signature) if mesh is not None
           else (plan, None, signature, dev))
    return plan_cache.get_or_compile(key, lambda: compile_plan(plan, mesh, signature, dev))


def cached_compile(plan: ir.Plan, mesh, tables,
                   device: _device.DeviceLike = None) -> CompiledPlan:
    """The front door: the executor for (plan, mesh, padded host inputs
    ``tables``, and the device of a local plan), via the process-global plan
    cache."""
    return cached_executor(plan, mesh, input_signature(plan, tables), device)


# ------------------------------------------- cross-process exchange split
# A plan whose exchange runs as a real shuffle between processes splits at
# the exchange node into two halves that reuse this executor unchanged:
#
# - the **map fragment** -- the exchange's child subtree -- runs eagerly on
#   the plan's device over one shard of the scan tables (the same emitter
#   bodies, so values are bit-identical); rows partition by the placement
#   hash (Exchange) or by range against shared splitters (RangeExchange),
#   and masked rows drop;
# - the **reduce plan** -- the original plan with the exchange replaced by a
#   Scan of the synthetic ``EXCHANGE_SOURCE`` table -- runs as a local plan
#   over the concatenated received partitions.  Its sinks are partials (summed
#   across executors, or concatenated in partition order for a range
#   shuffle), so ``post`` moves out of it and runs once over the combined
#   sinks (:func:`eval_post`).


#: the synthetic scan table the reduce half reads received rows from
EXCHANGE_SOURCE = "__exchange__"


def split_exchange_plan(plan: ir.Plan):
    """``(exchange_node, reduce_plan)`` for a plan with exactly ONE Exchange
    or RangeExchange.  The reduce plan is local (no exchange, no mesh), reads
    the shuffled fields from ``Scan(EXCHANGE_SOURCE, fields)``, keeps the
    sinks, and drops ``post``/``outputs``: partials must be combined across
    executors before post expressions run."""
    exchanges = ir.exchange_nodes(plan) + ir.range_exchange_nodes(plan)
    if len(exchanges) != 1:
        raise ValueError(
            f"plan {plan.name!r} has {len(exchanges)} Exchange nodes; the "
            f"cross-process shuffle supports exactly one")
    exchange = exchanges[0]

    def rebuild(node):
        if node is exchange or node == exchange:
            return ir.Scan(EXCHANGE_SOURCE, node.fields)
        kw = {}
        changed = False
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            if isinstance(v, tuple) and v and all(type(item) in _EMITTERS for item in v):
                nv = tuple(rebuild(item) for item in v)
                changed = changed or nv != v
                kw[f.name] = nv
            elif type(v) in _EMITTERS:
                nv = rebuild(v)
                changed = changed or nv is not v
                kw[f.name] = nv
            else:
                kw[f.name] = v
        return dataclasses.replace(node, **kw) if changed else node

    sinks = tuple(rebuild(s) for s in plan.sinks)
    reduce_plan = ir.Plan(f"{plan.name}:reduce", sinks)
    extra = [s.table for s in ir.scan_tables(reduce_plan) if s.table != EXCHANGE_SOURCE]
    if extra:
        raise ValueError(
            f"plan {plan.name!r} scans {extra} ABOVE its Exchange: the "
            f"reduce half would re-read whole fact tables per executor "
            f"and double-count -- every Scan must feed the Exchange")
    return exchange, reduce_plan


def _emit_host_rows(exchange, tables, device: _device.DeviceLike = None) -> _Rows:
    """Eagerly emit an exchange node's child subtree over host shard tables,
    uploaded to ``device`` (the card unless the caller asks for the CPU) --
    the shared map-side front half of the hash and range partition
    emitters."""
    dev = _device.resolve(device)
    inputs: Dict[str, Dict[str, torch.Tensor]] = {}
    rowvalid: Dict[str, torch.Tensor] = {}
    for table, fields in tables.items():
        inputs[table] = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                         for k, v in fields.items()}
        n = len(next(iter(fields.values())))
        rowvalid[table] = torch.ones((n,), dtype=torch.bool, device=dev)
    return _emit(exchange.child, _Ctx(inputs, rowvalid, None))


def _rank_cols(exchange: ir.RangeExchange, rows: _Rows) -> List[torch.Tensor]:
    """The rank columns (u64 bits as int64, on the rows' device) of a range
    exchange's sort keys -- the same canonical transform the order emitters
    apply, so partition placement and reduce-side order cannot disagree.
    (The JAX package's ``_host_rank_cols`` ranks the same keys in numpy.)"""
    return [win.sort_rank(torch.as_tensor(_eval(e, rows.cols)), asc) for e, asc in exchange.keys]


def emit_exchange_partitions(exchange: ir.Exchange, tables, nparts: int,
                             device: _device.DeviceLike = None) -> list:
    """The map side of one shard of a hash shuffle: emit the exchange's child
    subtree on ``device``, place rows with the placement hash the in-mesh
    all_to_all uses, and return ``nparts`` host partition tables of the
    exchange fields (masked rows dropped)."""
    rows = _emit_host_rows(exchange, tables, device)
    part = partition_of(_eval(exchange.key, rows.cols), nparts)
    out = []
    for p in range(nparts):
        sel = rows.mask & (part == p)
        out.append({f: rows.cols[f][sel].cpu().numpy() for f in exchange.fields})
    return out


def sample_range_splitters(exchange: ir.RangeExchange, tables, nparts: int,
                           sample_cap: int = 4096,
                           device: _device.DeviceLike = None) -> list:
    """Driver-side splitter choice for one range shuffle: emit the map
    fragment over the full input once (on ``device``), sample the valid
    rows' composite ranks evenly, take quantile boundaries
    (:func:`window.choose_splitters`).  Every map shard must get the same
    splitters.  The sample is drawn on the device, so only it reaches the
    host; the splitters are the JAX package's python ints."""
    rows = _emit_host_rows(exchange, tables, device)
    ranks = _rank_cols(exchange, rows)
    sel = torch.nonzero(rows.mask).flatten()
    if sel.numel() > sample_cap:
        at = np.linspace(0, sel.numel() - 1, sample_cap).astype(np.int64)
        sel = sel[torch.from_numpy(at).to(sel.device)]
    sample = [r[sel].cpu().numpy().view(np.uint64) for r in ranks]
    return win.choose_splitters(sample, np.ones(sel.numel(), bool), nparts,
                                sample_cap=sample_cap)


def emit_range_partitions(exchange: ir.RangeExchange, tables, nparts: int, splitters,
                          device: _device.DeviceLike = None) -> list:
    """The map side of one shard of a RANGE shuffle: emit the child subtree
    on ``device``, rank rows by the exchange's sort keys, sort the valid rows
    by them (stable: ties keep their input order) and bucket them against
    the dispatch-time ``splitters``.  Partition ``p``'s every row orders
    before partition ``p+1``'s, so the reduce side's sorted outputs
    concatenate into global order with no merge.  The partitions are host
    numpy tables, equal to the JAX package's.

    With ``exchange.limit`` set (partial top-k pushdown), only this shard's
    first ``limit`` ordered valid rows are partitioned at all: the global
    top-k is a subset of the per-shard top-k's."""
    if len(splitters) != nparts - 1:
        raise ValueError(
            f"range shuffle wants {nparts - 1} splitters, got {len(splitters)}")
    with RANGE_PHASES.phase("emit"):
        rows = _emit_host_rows(exchange, tables, device)
        nvalid = int(rows.mask.sum())  # waits for the emit
    with RANGE_PHASES.phase("rank_sort"):
        ranks = _rank_cols(exchange, rows)
        # valid rows in key order, invalid ones after them
        sel = win.order_permutation(ranks, rows.mask)[:nvalid]
        if exchange.limit is not None:
            sel = sel[:int(exchange.limit)]
        keys = [win.signed_key(r[sel]) for r in ranks]
        # the partition is the count of splitters the row's composite rank
        # orders strictly after; it never falls along the sorted rows, so
        # each partition is one contiguous slice of them
        part = torch.zeros(sel.shape[0], dtype=torch.int64, device=sel.device)
        for s in splitters:
            gt = torch.zeros_like(part, dtype=torch.bool)
            eq = torch.ones_like(part, dtype=torch.bool)
            for k, sv in zip(keys, s):
                sv = win.signed_splitter(sv)
                gt |= eq & (k > sv)
                eq &= k == sv
            part += gt
        counts = torch.bincount(part, minlength=nparts).tolist()  # waits for the sort
    with RANGE_PHASES.phase("download"):
        cols = {f: rows.cols[f][sel].cpu().numpy() for f in exchange.fields}
        out, at = [], 0
        for c in counts:
            out.append({f: np.ascontiguousarray(v[at:at + c]) for f, v in cols.items()})
            at += c
    return out


def eval_post(plan: ir.Plan, sums: Dict[str, object]) -> Dict[str, np.ndarray]:
    """Post expressions over the cross-executor combined sink outputs -- the
    host twin of the in-mesh path's sum-then-post ordering.  Returns sinks and
    posts as numpy, filtered and ordered like :func:`output_names` (minus the
    in-mesh path's implicit ``dropped``, which exact-size partitions cannot
    produce)."""
    env = {k: torch.as_tensor(np.asarray(v)) for k, v in sums.items()}
    for name, expr in plan.post:
        env[name] = torch.as_tensor(_eval(expr, env))
    names = [n for n in output_names(plan) if n != "dropped"]
    return {n: env[n].numpy() for n in names}


# ----------------------------------------------- ragged calling convention


@dataclasses.dataclass(frozen=True)
class RaggedProgram:
    """The hashable identity of one page-pool-shaped program: the plan-cache
    key the ragged serving path builds under (the analog of an
    :class:`ir.Plan` value for a handler kernel).  ``geometry`` is a
    :class:`columnar.pages.PageGeometry`; equal (kernel, geometry, out) ticks
    share one cached program, so a long-lived engine's cache holds one entry
    per PAGE GEOMETRY, not one per request shape.

    ``kernel_key`` names the kernel (module-qualified by default): handler
    registration is per engine, but the plan cache is process global, so the
    key identifies the FUNCTION, not the handler name a second engine may
    rebind.
    """

    kernel_key: str
    geometry: object  # columnar.pages.PageGeometry (frozen, hashable)
    out: str          # "rows" (row-aligned) | "riders" (per-rider vector)

    @property
    def name(self) -> str:
        return f"ragged:{self.kernel_key}:{self.geometry.describe()}"


def _ragged_signature(prog: RaggedProgram) -> Tuple:
    """The flat input signature of the page-pool calling convention:
    ``(data[total_rows] dtype, valid[total_rows] bool, rid[total_rows]
    int32)``, entirely geometry-derived."""
    g = prog.geometry
    n = g.total_rows
    return (("pages", "pool", "data", g.dtype, n),
            ("pages", "pool", VALID_FIELD, "bool", n),
            ("pages", "pool", "rid", "int32", n))


def compile_ragged(prog: RaggedProgram, kernel: Callable) -> CompiledPlan:
    """Build the program of ``kernel`` under the page-pool calling convention.

    ``kernel(data, valid, rid, riders_cap)`` runs eagerly on the flat pool
    tensors (``riders_cap`` is the geometry's, closed over here as the JAX
    package bakes it into its trace); it returns ONE tensor, either
    row-aligned (``out="rows"``: the executor scatters slices back per
    rider) or per rider (``out="riders"``: padding rows carry ``rid ==
    riders_cap``, so segment outputs are sized ``riders_cap + 1`` and drop
    the tail).  Nothing is traced or compiled ahead of time, so the JAX
    package's ``_try_aot_flat`` has no counterpart.  The program runs on the
    device of the tensors it is given.  Uncached -- go through
    :func:`cached_ragged_compile`.
    """
    riders_cap = prog.geometry.riders_cap

    def run(data, valid, rid):
        return (kernel(data, valid, rid, riders_cap),)

    with seam(COMPILE, prog.name):
        return CompiledPlan(run, prog, None, _ragged_signature(prog), ("out",),
                            ("pool.data", "pool.__valid__", "pool.rid"))


def cached_ragged_compile(prog: RaggedProgram, kernel: Callable) -> CompiledPlan:
    """The ragged front door: one program per (kernel, page geometry, out
    kind), via the SAME process-global plan cache as query plans, under the
    JAX package's key ``(prog, None, signature)`` -- ragged programs show up
    in the same hit, miss and trace counters."""
    return plan_cache.get_or_compile(
        (prog, None, _ragged_signature(prog)),
        lambda: compile_ragged(prog, kernel))
