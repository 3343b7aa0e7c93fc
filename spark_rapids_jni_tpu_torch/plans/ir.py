"""Query-plan IR: structural, hashable descriptions of whole pipelines (a
copy of the JAX package's ``plans/ir.py``, which imports no framework).

Every node is a frozen dataclass whose fields are static python scalars,
strings, tuples or other nodes, so a plan is hashable and
equality-comparable, and (plan, dtype signature, pow2 batch bucket) can key
a compiled-plan cache (plans/cache.py).  The classes, their fields and
their order are the JAX package's, so :func:`plan_signature` (a digest of
``repr(plan)``) gives the same id for the same plan in both packages.

Two layers:

- **expressions** (:class:`Col`/:class:`Lit`/:class:`Bin`/:class:`Unary`/
  :class:`Cast`) -- elementwise column math, evaluated by the executor
  against an environment of tensors;
- **nodes** -- the relational operators the NDS queries need:
  :class:`Scan` (sharded fact input), :class:`Dim` (replicated dimension
  input), :class:`Filter`, :class:`Project`, :class:`GatherJoin` (dense
  surrogate-key join = replicated-table gather), :class:`SemiJoinWindow`
  (date-dim membership via searchsorted -- q5's broadcast-join analog),
  :class:`SegmentAgg` (masked segment sums into a dense group space),
  :class:`Union` (tagged row concat), :class:`Exchange` (the all_to_all
  hash shuffle), :class:`PresenceCount` (q97's sort-merge presence
  counting) -- and the order-sensitive tier: :class:`RangeExchange` (the
  range shuffle a distributed sort rides), :class:`Window` (rank,
  dense_rank, row_number and framed sum/min/max over sorted runs,
  plans/window.py), and the :class:`Sort`/:class:`TopK` sinks that emit
  ordered row vectors.

A :class:`Plan` bundles sink nodes (aggregate producers) with post
expressions over their outputs; under a mesh the executor sums the sink
outputs over the data axis before ``post`` runs.  Row-level validity is
implicit: every Scan carries a runtime row-valid input (pad rows the
executor appends are False) AND'd into the pipeline mask, so padding to the
pow2 bucket lattice never changes results.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple, Union as _U

__all__ = [
    "Expr", "Col", "Lit", "Bin", "Unary", "Cast",
    "Node", "Scan", "Dim", "Filter", "Project", "GatherJoin",
    "SemiJoinWindow", "SegmentAgg", "Union", "Exchange", "PresenceCount",
    "RangeExchange", "WinFunc", "Window", "Sort", "TopK",
    "Plan", "col", "lit", "band_all", "plan_signature",
    "order_sink", "range_exchange_nodes", "has_any_exchange",
]


# --------------------------------------------------------------- expressions

BIN_OPS = ("add", "sub", "mul", "and", "or", "eq", "ne", "ge", "gt", "le",
           "lt", "min", "max", "shl", "band", "bor")
UNARY_OPS = ("not", "neg")


@dataclasses.dataclass(frozen=True)
class Col:
    """Reference to a column of the current row environment (or, in a
    Plan's ``post`` expressions, to a named sink output vector)."""

    name: str


@dataclasses.dataclass(frozen=True)
class Lit:
    """A static scalar literal.  Part of the plan *structure*: two plans
    differing only in a literal are different plans (and cache entries),
    exactly like the lru keys of the per-query step caches they replace."""

    value: _U[int, bool]


@dataclasses.dataclass(frozen=True)
class Bin:
    op: str  # one of BIN_OPS
    lhs: "Expr"
    rhs: "Expr"

    def __post_init__(self):
        if self.op not in BIN_OPS:
            raise ValueError(f"unknown binary op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class Unary:
    op: str  # one of UNARY_OPS
    x: "Expr"

    def __post_init__(self):
        if self.op not in UNARY_OPS:
            raise ValueError(f"unknown unary op {self.op!r}")


@dataclasses.dataclass(frozen=True)
class Cast:
    x: "Expr"
    dtype: str  # "int8" | "int32" | "int64" | "uint64" | "bool"


Expr = _U[Col, Lit, Bin, Unary, Cast]


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    # geometry scalars arrive as numpy ints from array mins/lens; normalize
    # so equal geometries always build EQUAL plans (the q5 step-cache
    # geometry-keying fix: a np.int64-keyed and an int-keyed plan must be
    # one cache entry, never two)
    if isinstance(value, bool):
        return Lit(value)
    return Lit(int(value))


def band_all(*exprs: Expr) -> Expr:
    """AND-fold a non-empty list of boolean expressions."""
    out = exprs[0]
    for e in exprs[1:]:
        out = Bin("and", out, e)
    return out


# --------------------------------------------------------------------- nodes


@dataclasses.dataclass(frozen=True)
class Scan:
    """Sharded fact input: ``fields`` of host table ``table`` ride the
    data axis.  The executor appends an implicit row-valid bool array
    (False on pad rows) that seeds the pipeline mask."""

    table: str
    fields: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Dim:
    """Replicated dimension input (small table, uploaded whole)."""

    table: str
    fields: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class Filter:
    child: "Node"
    pred: Expr  # AND'd into the row mask


@dataclasses.dataclass(frozen=True)
class Project:
    child: "Node"
    cols: Tuple[Tuple[str, Expr], ...]  # (out_name, expr), added to the env


@dataclasses.dataclass(frozen=True)
class GatherJoin:
    """Dense surrogate-key inner-join: gather ``dim`` fields at
    ``clip(key - base, 0, len-1)``.  Out-of-range / null keys must be
    excluded by a Filter on the pipeline mask (the gather itself clips,
    matching the per-op device bodies bit for bit)."""

    child: "Node"
    dim: Dim
    key: Expr
    base: Expr  # usually lit(1) (1-based sks) or lit(date_sk0)
    fields: Tuple[Tuple[str, str], ...]  # (dim_field, out_name)


@dataclasses.dataclass(frozen=True)
class SemiJoinWindow:
    """q5's date-dim membership: mask &= (key found in dim.sk_field via
    searchsorted) AND (dim.days_field in [lo, hi)) AND key_valid."""

    child: "Node"
    dim: Dim
    key: Expr
    key_valid: Expr
    sk_field: str
    days_field: str
    lo: Expr
    hi: Expr


@dataclasses.dataclass(frozen=True)
class SegmentAgg:
    """Masked segment sums into ``num_segments`` dense buckets.

    ``key`` is the 0-based segment id; masked rows scatter-drop.  Each
    agg is ``(output_name, value_expr, dtype)`` — the classic additive
    partial vector, exact over any disjoint row partition (what the
    plan-level SplitAndRetry relies on)."""

    child: "Node"
    key: Expr
    num_segments: int
    aggs: Tuple[Tuple[str, Expr, str], ...]


@dataclasses.dataclass(frozen=True)
class Union:
    """Tagged row concat of pipelines sharing column names; adds an int8
    ``tag`` column carrying ``tag_values[i]`` for child ``i``."""

    children: Tuple["Node", ...]
    tag: str
    tag_values: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Exchange:
    """The all_to_all hash shuffle (parallel/shuffle.py): co-locate rows
    by ``partition_of(key) % ndev`` into fixed ``capacity`` buckets.
    Capacity is static plan structure (one compiled variant per pow2
    capacity, as before); overflow surfaces through the plan's implicit
    ``dropped`` output for the grow retry.  Mesh-only: a local plan must
    not contain an Exchange."""

    child: "Node"
    key: Expr
    capacity: int
    fields: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class RangeExchange:
    """The cross-process RANGE shuffle (serve/shuffle.py): co-locate rows
    into CONTIGUOUS key ranges so partition ``p``'s every row orders
    before partition ``p+1``'s — the shape that makes a distributed sort
    a per-shard sort plus an ordered concatenation (the classic
    sample -> splitters -> shuffle-by-range plan Flare compiles).

    ``keys`` are ``(expr, ascending)`` sort keys; splitters are NOT plan
    structure — they are sampled from the data at dispatch time and ride
    the shard payloads, so one compiled reduce program serves every
    dataset.  ``limit`` pushes a partial top-k below the shuffle: each
    map shard sends only its ``limit`` first-ordered rows, so at most
    ``limit * shards`` rows cross the wire.

    Cross-process only: there is no in-mesh emitter (psum cannot merge
    ordered row vectors) — compile_plan refuses a plan containing one;
    execution goes through split_exchange_plan + the serve shuffle
    plane (or its single-process oracle)."""

    child: "Node"
    keys: Tuple[Tuple[Expr, bool], ...]  # (key expr, ascending)
    fields: Tuple[str, ...]
    limit: _U[int, None] = None


WINDOW_FUNCS = ("rank", "dense_rank", "row_number", "sum", "min", "max")


@dataclasses.dataclass(frozen=True)
class WinFunc:
    """One window function column: ``rank``/``dense_rank``/``row_number``
    need no argument; ``sum``/``min``/``max`` aggregate ``arg`` over the
    ROWS frame ``[current - preceding, current]`` (``preceding=None`` =
    UNBOUNDED PRECEDING) within the partition, in order."""

    name: str
    kind: str  # one of WINDOW_FUNCS
    arg: _U[Col, Lit, Bin, Unary, Cast, None] = None
    dtype: str = "int64"
    preceding: _U[int, None] = None

    def __post_init__(self):
        if self.kind not in WINDOW_FUNCS:
            raise ValueError(f"unknown window function {self.kind!r}")
        if self.kind in ("sum", "min", "max") and self.arg is None:
            raise ValueError(f"window {self.kind} requires an arg expr")
        if self.preceding is not None and self.kind in (
                "rank", "dense_rank", "row_number"):
            raise ValueError(f"window {self.kind} takes no frame")


@dataclasses.dataclass(frozen=True)
class Window:
    """Window functions over sorted runs: rows reorder by
    ``(partition_by, order_by)`` (invalid rows last), every run of equal
    partition keys becomes one segment, and each :class:`WinFunc` appends
    a column computed by segment-scan primitives (plans/window.py).
    Downstream nodes (Filter on a rank, a Sort sink) see the reordered
    row environment."""

    child: "Node"
    partition_by: Tuple[Expr, ...]
    order_by: Tuple[Tuple[Expr, bool], ...]  # (expr, ascending)
    funcs: Tuple[WinFunc, ...]


@dataclasses.dataclass(frozen=True)
class Sort:
    """Order-sensitive SINK: emit ``fields`` as row vectors ordered by
    ``keys`` (invalid rows sort last and are excluded from the implicit
    ``rows`` count output).  Local-compile only — a distributed sort is
    a RangeExchange below this sink plus an ordered concatenation of the
    per-partition results."""

    child: "Node"
    keys: Tuple[Tuple[Expr, bool], ...]
    fields: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class TopK:
    """Order-sensitive SINK: the first ``k`` rows by ``keys``.  Output
    vectors are ``min(k, padded_rows)`` long; ``rows`` counts the valid
    ones (``K > total rows`` simply returns them all)."""

    child: "Node"
    keys: Tuple[Tuple[Expr, bool], ...]
    k: int
    fields: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class PresenceCount:
    """q97's sort-merge presence counting over co-located tagged rows:
    for every distinct valid key, which sources appear?  Emits the three
    scalar outputs named in ``names``."""

    child: "Node"
    key: str
    tag: str
    names: Tuple[str, str, str] = ("store_only", "catalog_only", "both")


Node = _U[Scan, Dim, Filter, Project, GatherJoin, SemiJoinWindow,
          SegmentAgg, Union, Exchange, PresenceCount,
          RangeExchange, Window, Sort, TopK]

#: the concrete node classes _walk recurses into (single source of truth
#: — a node type missing here is invisible to scan/dim/exchange discovery)
NODE_TYPES = (Scan, Dim, Filter, Project, GatherJoin, SemiJoinWindow,
              SegmentAgg, Union, Exchange, PresenceCount,
              RangeExchange, Window, Sort, TopK)


# ---------------------------------------------------------------------- plan


@dataclasses.dataclass(frozen=True)
class Plan:
    """A whole query pipeline: sink nodes produce named aggregate arrays
    (psum'd over the data axis under a mesh), then ``post`` expressions
    compute derived outputs over those vectors — all inside ONE jitted
    program.  ``outputs`` orders/filters what the compiled program
    returns (empty = every sink output, then every post output)."""

    name: str
    sinks: Tuple[Node, ...]
    post: Tuple[Tuple[str, Expr], ...] = ()
    outputs: Tuple[str, ...] = ()


def _walk(node) -> list:
    out = [node]
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if dataclasses.is_dataclass(v) and isinstance(v, NODE_TYPES):
            out.extend(_walk(v))
        elif isinstance(v, tuple):
            for item in v:
                if dataclasses.is_dataclass(item) and isinstance(
                        item, NODE_TYPES):
                    out.extend(_walk(item))
    return out


def walk(plan: Plan) -> list:
    """Every node of every sink, preorder (duplicates preserved)."""
    out = []
    for sink in plan.sinks:
        out.extend(_walk(sink))
    return out


@functools.lru_cache(maxsize=256)
def scan_tables(plan: Plan) -> Tuple[Scan, ...]:
    """Distinct Scan nodes, ordered by table name (the executor's stable
    argument order).  Cached — plans are immutable values and this runs
    on the per-request hot path (execute_plan + upload_inputs)."""
    seen = {}
    for n in walk(plan):
        if isinstance(n, Scan):
            prev = seen.setdefault(n.table, n)
            if prev != n:
                raise ValueError(
                    f"conflicting Scan field sets for table {n.table!r}")
    return tuple(seen[t] for t in sorted(seen))


@functools.lru_cache(maxsize=256)
def dim_tables(plan: Plan) -> Tuple[Dim, ...]:
    """Distinct Dim nodes, ordered by table name.  Cached (hot path)."""
    seen = {}
    for n in walk(plan):
        if isinstance(n, (GatherJoin, SemiJoinWindow)):
            prev = seen.setdefault(n.dim.table, n.dim)
            if prev != n.dim:
                raise ValueError(
                    f"conflicting Dim field sets for table {n.dim.table!r}")
    return tuple(seen[t] for t in sorted(seen))


@functools.lru_cache(maxsize=256)
def exchange_nodes(plan: Plan) -> Tuple[Exchange, ...]:
    """Every Exchange in the plan, preorder.  Cached (hot path: the
    working-set estimate runs per governed admission)."""
    return tuple(n for n in walk(plan) if isinstance(n, Exchange))


def has_exchange(plan: Plan) -> bool:
    return bool(exchange_nodes(plan))


@functools.lru_cache(maxsize=256)
def range_exchange_nodes(plan: Plan) -> Tuple[RangeExchange, ...]:
    """Every RangeExchange in the plan, preorder.  Cached (hot path)."""
    return tuple(n for n in walk(plan) if isinstance(n, RangeExchange))


def has_any_exchange(plan: Plan) -> bool:
    """Hash OR range exchange: either makes the plan non-local (the hash
    kind needs a mesh, the range kind needs the cross-process split)."""
    return bool(exchange_nodes(plan)) or bool(range_exchange_nodes(plan))


@functools.lru_cache(maxsize=256)
def order_sink(plan: Plan):
    """The plan's Sort/TopK sink, or None.  Ordered row output cannot
    coexist with additive sinks (they combine by summation, ordered rows
    by concatenation — one plan, one combine discipline), so mixing or
    repeating order sinks is a structural error."""
    order = [s for s in plan.sinks if isinstance(s, (Sort, TopK))]
    if not order:
        return None
    if len(order) > 1 or len(plan.sinks) > 1:
        raise ValueError(
            f"plan {plan.name!r} mixes an order-sensitive sink with other "
            f"sinks; a Sort/TopK sink must be the plan's only sink")
    return order[0]


@functools.lru_cache(maxsize=256)
def plan_signature(plan: Plan) -> str:
    """Short stable id for telemetry/seam labels (not the cache key — the
    cache keys on the plan value itself).  Deterministic ACROSS processes
    (hashlib over the canonical repr, not salted ``hash()``): a faultinj
    rule or cross-run trace correlation pinned to a label from one run's
    flight dump must match the next run's."""
    import hashlib

    digest = hashlib.sha1(repr(plan).encode()).hexdigest()[:8]
    return f"{plan.name}:{digest}"  # lru-cached: repr+sha1 paid once
