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

The order tier (Window, Sort, TopK, RangeExchange), the cross-process
exchange split and the ragged calling convention are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch
import torch.distributed as dist

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_size
from spark_rapids_jni_tpu_torch.parallel.shuffle import all_to_all_shuffle, partition_of
from spark_rapids_jni_tpu_torch.plans import ir
from spark_rapids_jni_tpu_torch.plans.cache import CompiledPlan, plan_cache

__all__ = ["compile_plan", "cached_compile", "cached_executor", "input_signature",
           "output_names", "emitter", "plan_device", "segment_sum", "window_index", "DTYPES"]

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

#: nodes of the order tier, which the port's executor does not run yet
_ORDER_TIER = (ir.Window, ir.Sort, ir.TopK, ir.RangeExchange)


def _dtype(name: str) -> torch.dtype:
    if name == "uint64":
        # torch's uint64 lacks +, <, >> and %: comparing or adding the int64
        # bits as if they were signed would give wrong answers silently
        raise ValueError("the port's executor does not support uint64 casts or "
                         "aggregates: torch's uint64 lacks +, <, >> and %")
    if name not in DTYPES:
        raise ValueError(f"unknown plan dtype {name!r}")
    return DTYPES[name]


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: sums of ``values`` by segment id, where ids
    outside ``[0, num_segments)`` are dropped (``index_add_`` would raise on
    them): they go to one spare bucket past the end, which is cut off."""
    if ids.dtype not in (torch.int32, torch.int64):
        ids = ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    out = torch.zeros((num_segments + 1,), dtype=values.dtype, device=values.device)
    out.index_add_(0, torch.where(ok, ids, num_segments), values)
    return out[:-1]


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
    # [0, num_segments): bit-identical to the JAX drop-bucket form
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
    for sink in plan.sinks:
        if isinstance(sink, ir.SegmentAgg):
            names.extend(name for name, _e, _d in sink.aggs)
        elif isinstance(sink, ir.PresenceCount):
            names.extend(sink.names)
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
    order = sorted({type(n).__name__ for n in ir.walk(plan) if isinstance(n, _ORDER_TIER)})
    if order:
        raise ValueError(
            f"plan {plan.name!r} contains {order}: the order-tier nodes (Window, "
            f"Sort, TopK, RangeExchange) come with the port's order tier")
    layout = _arg_layout(plan)
    if len(signature) != len(layout):
        raise ValueError("signature does not match the plan's arg layout")
    out_names = output_names(plan)
    local = mesh is None
    if local and ir.has_exchange(plan):
        raise ValueError(f"plan {plan.name!r} contains an Exchange: mesh required")
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

    return CompiledPlan(run, plan, mesh, signature, out_names,
                        tuple(f"{t}.{f}" for _k, t, f in layout), plan_device(mesh, device))


def cached_executor(plan: ir.Plan, mesh, signature: Tuple,
                    device: _device.DeviceLike = None) -> CompiledPlan:
    """The executor for (plan, mesh, input signature, and the device of a
    local plan) from the process-global plan cache, built on a miss."""
    dev = plan_device(mesh, device)
    key = (plan, mesh, signature) if mesh is not None else (plan, None, signature, dev)
    return plan_cache.get_or_compile(key, lambda: compile_plan(plan, mesh, signature, dev))


def cached_compile(plan: ir.Plan, mesh, tables,
                   device: _device.DeviceLike = None) -> CompiledPlan:
    """The front door: the executor for (plan, mesh, padded host inputs
    ``tables``, and the device of a local plan), via the process-global plan
    cache."""
    return cached_executor(plan, mesh, input_signature(plan, tables), device)
