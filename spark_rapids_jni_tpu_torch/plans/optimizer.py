"""Stats-driven rule rewriter over the plan IR (a copy of the JAX package's
``plans/optimizer.py``, which imports no framework).

Plans used to compile exactly as written — every join order, every
filter position fixed at construction time.  *Flare* (PAPERS.md) pairs
whole-plan compilation with relational optimization; this module is that
missing middle: a FIXED-POINT rewrite engine over the frozen-dataclass
IR (plans/ir.py) whose every rule is an exact algebraic identity of the
compiler's masked-row semantics, so the rewritten plan is bit-identical
to the unrewritten oracle by construction (tests/test_optimizer.py
fuzzes exactly this claim).

Rules (applied bottom-up until a bounded fixed point):

- **filter_fuse** — ``Filter(Filter(x, p), q)`` folds to one AND'd
  predicate: the pipeline mask is a boolean AND chain, associativity is
  exact.
- **filter_below_gather** — a Filter whose predicate reads none of a
  GatherJoin's output columns slides below it: the gather neither
  reorders rows nor touches the mask, so AND-ing the predicate before
  or after gathers identical bits.
- **filter_below_exchange** — a Filter whose predicate reads only the
  Exchange's wire fields slides below the shuffle, so masked rows are
  dropped BEFORE they cross the wire (the classic pushdown byte win);
  applied only when every additive sink aggregates an integer dtype —
  integer segment sums are order-exact over any row placement, which
  keeps the in-mesh bucket path bit-identical too.
- **project_fuse** — adjacent Projects fold into one by substituting
  the inner definitions into the outer expressions (the env is built
  sequentially, so the fold preserves shadowing).
- **join_reorder** — adjacent independent GatherJoins (disjoint outputs,
  the upper key reads nothing the lower gather produced) are ordered by
  the table-stats registry's ROW COUNTS (models/tables.py,
  ``stats_of``), smallest dim first, table name as the deterministic
  tie-break.  Gathers commute exactly, so this is simultaneously a cost
  rule and a CANONICALIZATION: two queries written with different join
  orders rewrite to the same tree.
- **common-subplan extraction** — the canonicalized plan's subtree
  signatures land in a process registry; when another plan already
  registered the same subtree, the optimizer narrates the shared prefix
  (``EV_PLAN_REWRITE rule:common_subplan``).  Because the result cache
  keys on the canonical plan signature (plans/rcache.py
  ``plan_result_key``), two different queries that canonicalize to the
  same tree literally hit each other's cached work.

Every applied rewrite is recorded as ``EV_PLAN_REWRITE`` in the flight
ring (``tools/flightdump.py --control`` renders the decision ledger).
The optimizer is memoized per (plan, dim-stats) — rewriting is paid once
per plan shape, not per request — and gated behind the
``plan_optimizer`` config flag at its callers (plans/runtime.py), so
static configurations stay byte-for-byte on the round-18 path.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Dict, FrozenSet, List, Tuple

from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.plans import ir

__all__ = ["optimize_plan", "rewrite_plan", "expr_columns",
           "subplan_signatures", "common_subplan_tokens",
           "reset_for_tests", "MAX_PASSES"]

#: fixed-point bound: every rule strictly shrinks a well-founded measure
#: (filter depth, inversions against the canonical join order), so real
#: plans converge in 2-3 passes; the bound only guards against a buggy
#: oscillating rule pair turning the optimizer into a spin loop.
MAX_PASSES = 8

_NO_STATS_ROWS = 1 << 62  # unknown-size dims order after every known one


# --------------------------------------------------------------------------
# expression helpers
# --------------------------------------------------------------------------


def expr_columns(expr) -> FrozenSet[str]:
    """Every column name an expression reads."""
    if isinstance(expr, ir.Col):
        return frozenset((expr.name,))
    if isinstance(expr, ir.Lit):
        return frozenset()
    if isinstance(expr, ir.Bin):
        return expr_columns(expr.lhs) | expr_columns(expr.rhs)
    if isinstance(expr, ir.Unary):
        return expr_columns(expr.x)
    if isinstance(expr, ir.Cast):
        return expr_columns(expr.x)
    raise TypeError(f"not an expression: {expr!r}")


def _substitute(expr, env: Dict[str, object]):
    """Replace ``Col(name)`` reads by ``env[name]`` definitions (the
    project-fuse inlining step)."""
    if isinstance(expr, ir.Col):
        return env.get(expr.name, expr)
    if isinstance(expr, ir.Bin):
        return ir.Bin(expr.op, _substitute(expr.lhs, env),
                      _substitute(expr.rhs, env))
    if isinstance(expr, ir.Unary):
        return ir.Unary(expr.op, _substitute(expr.x, env))
    if isinstance(expr, ir.Cast):
        return ir.Cast(_substitute(expr.x, env), expr.dtype)
    return expr


def _int_sinks_only(plan: ir.Plan) -> bool:
    """True when every additive sink aggregates an integer dtype —
    the precondition for rules that move rows relative to an in-mesh
    Exchange's bucket scatter (integer sums are placement-exact)."""
    for sink in plan.sinks:
        for node in ir._walk(sink):
            if isinstance(node, ir.SegmentAgg):
                for _name, _expr, dtype in node.aggs:
                    if "int" not in dtype and dtype != "bool":
                        return False
    return True


# --------------------------------------------------------------------------
# the rules: each takes a node, returns the rewrite or None
# --------------------------------------------------------------------------


def _rule_filter_fuse(node, _stats, _intish):
    if isinstance(node, ir.Filter) and isinstance(node.child, ir.Filter):
        inner = node.child
        return ir.Filter(inner.child,
                         ir.Bin("and", inner.pred, node.pred))
    return None


def _rule_filter_below_gather(node, _stats, _intish):
    if not (isinstance(node, ir.Filter)
            and isinstance(node.child, ir.GatherJoin)):
        return None
    join = node.child
    produced = {out for _dim_field, out in join.fields}
    if expr_columns(node.pred) & produced:
        return None
    return dataclasses.replace(
        join, child=ir.Filter(join.child, node.pred))


def _rule_filter_below_exchange(node, _stats, intish):
    if not (intish and isinstance(node, ir.Filter)
            and isinstance(node.child, ir.Exchange)):
        return None
    ex = node.child
    if not expr_columns(node.pred) <= set(ex.fields):
        return None
    return dataclasses.replace(ex, child=ir.Filter(ex.child, node.pred))


def _rule_project_fuse(node, _stats, _intish):
    if not (isinstance(node, ir.Project)
            and isinstance(node.child, ir.Project)):
        return None
    inner = node.child
    env = {name: expr for name, expr in inner.cols}
    fused = tuple(inner.cols) + tuple(
        (name, _substitute(expr, env)) for name, expr in node.cols)
    return ir.Project(inner.child, fused)


def _dim_rows(stats: Dict[str, int], dim: ir.Dim) -> Tuple[int, str]:
    return (stats.get(dim.table, _NO_STATS_ROWS), dim.table)


def _rule_join_reorder(node, stats, _intish):
    """Bubble one inversion of the canonical (rows, name) dim order in a
    stack of independent GatherJoins; the fixed-point loop sorts the
    whole stack."""
    if not (isinstance(node, ir.GatherJoin)
            and isinstance(node.child, ir.GatherJoin)):
        return None
    upper, lower = node, node.child
    upper_out = {out for _f, out in upper.fields}
    lower_out = {out for _f, out in lower.fields}
    if upper_out & lower_out:
        return None
    # the upper gather must not consume anything the lower one produced
    if (expr_columns(upper.key) | expr_columns(upper.base)) & lower_out:
        return None
    if _dim_rows(stats, upper.dim) >= _dim_rows(stats, lower.dim):
        return None  # already canonical (smaller dim applies first)
    return dataclasses.replace(
        lower, child=dataclasses.replace(upper, child=lower.child))


_RULES = (
    ("filter_fuse", _rule_filter_fuse),
    ("filter_below_gather", _rule_filter_below_gather),
    ("filter_below_exchange", _rule_filter_below_exchange),
    ("project_fuse", _rule_project_fuse),
    ("join_reorder", _rule_join_reorder),
)


# --------------------------------------------------------------------------
# the fixed-point engine
# --------------------------------------------------------------------------


def _rewrite_node(node, stats, intish, applied: List[Tuple[str, str]]):
    """One bottom-up pass: rebuild children, then try every rule at this
    node (repeating while any fires — a slid filter may fuse at once)."""
    kw = {}
    changed = False
    for f in dataclasses.fields(node):
        v = getattr(node, f.name)
        if isinstance(v, ir.NODE_TYPES):
            nv = _rewrite_node(v, stats, intish, applied)
            changed = changed or nv is not v
            kw[f.name] = nv
        elif isinstance(v, tuple) and v and all(
                isinstance(item, ir.NODE_TYPES) for item in v):
            nv = tuple(_rewrite_node(item, stats, intish, applied)
                       for item in v)
            changed = changed or nv != v
            kw[f.name] = nv
        else:
            kw[f.name] = v
    out = dataclasses.replace(node, **kw) if changed else node
    fired = True
    while fired:
        fired = False
        for name, rule in _RULES:
            nv = rule(out, stats, intish)
            if nv is not None:
                applied.append((name, type(out).__name__))
                out = nv
                fired = True
    return out


def rewrite_plan(plan: ir.Plan, stats: Dict[str, int]
                 ) -> Tuple[ir.Plan, Tuple[Tuple[str, str], ...]]:
    """Rewrite ``plan`` to a fixed point under ``stats`` (dim table ->
    row count).  Returns (rewritten plan, applied (rule, node) log).
    Pure: no flight events, no registry — the memoized/narrating front
    door is :func:`optimize_plan`."""
    applied: List[Tuple[str, str]] = []
    intish = _int_sinks_only(plan)
    for _pass in range(MAX_PASSES):
        before = len(applied)
        sinks = tuple(_rewrite_node(s, stats, intish, applied)
                      for s in plan.sinks)
        if sinks != plan.sinks:
            plan = dataclasses.replace(plan, sinks=sinks)
        if len(applied) == before:
            break
    return plan, tuple(applied)


# --------------------------------------------------------------------------
# common-subplan registry + the memoized, narrating front door
# --------------------------------------------------------------------------

class _SubplanRegistry:
    """Process ledger of canonical subtree signatures: which plan first
    registered each shared subtree (a class, not module globals, so the
    guarded-by pass checks every access site)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # signature -> first plan name that registered it: the
        # cross-query shared-prefix ledger
        self._seen: Dict[str, str] = {}  # guarded-by: _lock

    def note(self, sigs: Dict[str, str], plan_name: str
             ) -> List[Tuple[str, str, str]]:
        """Register ``sigs`` under ``plan_name``; return the subtrees
        some OTHER plan already registered."""
        shared: List[Tuple[str, str, str]] = []
        with self._lock:
            for sig, ntype in sigs.items():
                first = self._seen.setdefault(sig, plan_name)
                if first != plan_name:
                    shared.append((sig, ntype, first))
        return shared

    def reset(self) -> None:
        with self._lock:
            self._seen.clear()


_csp_registry = _SubplanRegistry()


def subplan_signatures(plan: ir.Plan) -> Dict[str, str]:
    """Canonical signature per non-leaf subtree (sha1 of the frozen
    repr, like ir.plan_signature) -> node type name.  Leaves (Scan/Dim)
    are excluded: every query over a table shares those trivially."""
    import hashlib

    out: Dict[str, str] = {}
    for node in ir.walk(plan):
        if isinstance(node, (ir.Scan, ir.Dim)):
            continue
        digest = hashlib.sha1(repr(node).encode()).hexdigest()[:12]
        out[digest] = type(node).__name__
    return out


def common_subplan_tokens(plan: ir.Plan) -> List[Tuple[str, str, str]]:
    """Register ``plan``'s canonical subtrees and return the (signature,
    node type, first-seen plan name) of every subtree some OTHER plan
    already registered — the shared join prefixes the result cache will
    serve across queries."""
    return _csp_registry.note(subplan_signatures(plan), plan.name)


def reset_for_tests() -> None:
    _csp_registry.reset()
    _optimize_cached.cache_clear()


@functools.lru_cache(maxsize=256)
def _optimize_cached(plan: ir.Plan,
                     stats_items: Tuple[Tuple[str, int], ...]) -> ir.Plan:
    """The cached rewrite (plans are immutable values; stats ride the key
    so a registry update re-optimizes).  Narration happens HERE — once
    per distinct (plan, stats), never per request."""
    out, applied = rewrite_plan(plan, dict(stats_items))
    for passno, (rule, ntype) in enumerate(applied, 1):
        _flight.record(_flight.EV_PLAN_REWRITE, -1,
                       detail=f"plan:{plan.name}:rule:{rule}:node:{ntype}",
                       value=passno)
    for sig, ntype, first in common_subplan_tokens(out):
        _flight.record(_flight.EV_PLAN_REWRITE, -1,
                       detail=f"plan:{plan.name}:rule:common_subplan:"
                              f"node:{ntype}:sig:{sig}:with:{first}")
    if applied:
        _flight.record(_flight.EV_PLAN_REWRITE, -1,
                       detail=f"plan:{plan.name}:rule:done",
                       value=len(applied))
    return out


def optimize_plan(plan: ir.Plan) -> ir.Plan:
    """Rewrite ``plan`` under the live table-stats registry.  Memoized
    per (plan, relevant stats); emits one EV_PLAN_REWRITE per applied
    rule on first rewrite.  Callers gate on the ``plan_optimizer``
    config flag — this function itself is unconditional so tests and
    benches can exercise it directly."""
    from spark_rapids_jni_tpu_torch.models import tables as _tables

    stats_items = []
    for dim in ir.dim_tables(plan):
        st = _tables.stats_of(dim.table)
        if st is not None:
            stats_items.append((dim.table, int(st["rows"])))
    return _optimize_cached(plan, tuple(sorted(stats_items)))
