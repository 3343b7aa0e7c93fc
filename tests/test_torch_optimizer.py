"""The port's plan optimizer (``spark_rapids_jni_tpu_torch/plans/optimizer.py``,
a copy of the JAX package's) and its table-stats registry
(``models/tables.py``), against the JAX package's, on the CPU.

Every rule is unit-pinned, then fuzzed: for random small plans the port's
rewrite has the same ``plan_signature`` and the same applied-rule log as the
JAX package's, and the rewritten plan gives bit-identical outputs to the
unrewritten one through the port's executor (``device="cpu"``).  The
``run_governed_plan`` hook is gated on the ``plan_optimizer`` flag and changes
results by nothing.  The JAX package's result-cache key test needs
``plans/rcache.py`` (ROADMAP A.15) and is not mirrored.
"""

import numpy as np
import pytest

from spark_rapids_jni_tpu.models import tables as jax_tabreg
from spark_rapids_jni_tpu.plans import ir as jax_ir
from spark_rapids_jni_tpu.plans import optimizer as jax_opt
from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.models import tables as tabreg
from spark_rapids_jni_tpu_torch.obs import flight
from spark_rapids_jni_tpu_torch.plans import (
    EXCHANGE_SOURCE,
    emit_exchange_partitions,
    eval_post,
    execute_plan,
    ir,
    run_governed_plan,
    split_exchange_plan,
)
from spark_rapids_jni_tpu_torch.plans.optimizer import (
    MAX_PASSES,
    common_subplan_tokens,
    expr_columns,
    optimize_plan,
    reset_for_tests,
    rewrite_plan,
    subplan_signatures,
)


@pytest.fixture(autouse=True)
def _fresh():
    reset_for_tests()
    tabreg.reset_for_tests()
    yield
    reset_for_tests()
    tabreg.reset_for_tests()


def _facts(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "facts": {"ka": rng.integers(0, 4, n).astype(np.int32),
                  "kb": rng.integers(0, 3, n).astype(np.int32),
                  "qty": rng.integers(0, 9, n).astype(np.int64)},
        "dim_a": {"w": rng.integers(1, 9, 4).astype(np.int64)},
        "dim_b": {"v": rng.integers(1, 9, 3).astype(np.int64)},
    }


def _two_join_plan(m=ir, a_first=True, name="q"):
    node = m.Scan("facts", ("ka", "kb", "qty"))
    ja = (m.Dim("dim_a", ("w",)), m.col("ka"), (("w", "wa"),))
    jb = (m.Dim("dim_b", ("v",)), m.col("kb"), (("v", "vb"),))
    for dim, key, fields in ([ja, jb] if a_first else [jb, ja]):
        node = m.GatherJoin(node, dim, key, m.lit(0), fields)
    node = m.Filter(node, m.Bin("gt", m.col("qty"), m.lit(2)))
    sink = m.SegmentAgg(node, m.col("ka"), 4,
                        (("s", m.Bin("mul", m.col("wa"), m.col("vb")), "int64"),))
    return m.Plan(name, (sink,))


def _assert_same_outputs(p1, p2, tables):
    o1 = execute_plan(None, p1, tables, device="cpu")
    o2 = execute_plan(None, p2, tables, device="cpu")
    assert sorted(o1) == sorted(o2)
    for k in o1:
        np.testing.assert_array_equal(o1[k], o2[k])


def _same_rewrite_as_jax(plan, jplan, stats):
    """Rewrite both plans; the results' signatures and the rule logs must be
    the JAX package's.  Returns the port's rewrite."""
    out, applied = rewrite_plan(plan, stats)
    jout, japplied = jax_opt.rewrite_plan(jplan, stats)
    assert ir.plan_signature(out) == jax_ir.plan_signature(jout)
    assert applied == japplied
    return out, applied


# ------------------------------------------------------------ rule units


def test_expr_columns_walks_every_expression_shape():
    e = ir.Bin("add", ir.Cast(ir.col("a"), "int64"),
               ir.Unary("neg", ir.Bin("mul", ir.col("b"), ir.lit(2))))
    assert expr_columns(e) == frozenset({"a", "b"}) == jax_opt.expr_columns(
        jax_ir.Bin("add", jax_ir.Cast(jax_ir.col("a"), "int64"),
                   jax_ir.Unary("neg", jax_ir.Bin("mul", jax_ir.col("b"), jax_ir.lit(2)))))


def test_filter_pushes_below_independent_gather():
    plan = _two_join_plan()
    out, applied = _same_rewrite_as_jax(plan, _two_join_plan(jax_ir), {})
    assert [r for r, _ in applied].count("filter_below_gather") == 2
    node = out.sinks[0].child
    assert isinstance(node, ir.GatherJoin) and isinstance(node.child, ir.GatherJoin)
    assert isinstance(node.child.child, ir.Filter)
    assert isinstance(node.child.child.child, ir.Scan)
    _assert_same_outputs(plan, out, _facts())


def _dep_plan(m):
    node = m.Scan("facts", ("ka", "kb", "qty"))
    node = m.GatherJoin(node, m.Dim("dim_a", ("w",)), m.col("ka"), m.lit(0), (("w", "wa"),))
    node = m.Filter(node, m.Bin("gt", m.col("wa"), m.lit(3)))
    sink = m.SegmentAgg(node, m.col("ka"), 4, (("s", m.col("qty"), "int64"),))
    return m.Plan("dep", (sink,))


def test_filter_reading_gathered_column_stays_put():
    out, applied = _same_rewrite_as_jax(_dep_plan(ir), _dep_plan(jax_ir), {})
    assert applied == () and out == _dep_plan(ir)


def _ff_plan(m):
    node = m.Scan("facts", ("ka", "kb", "qty"))
    node = m.Filter(node, m.Bin("gt", m.col("qty"), m.lit(1)))
    node = m.Filter(node, m.Bin("lt", m.col("qty"), m.lit(7)))
    sink = m.SegmentAgg(node, m.col("ka"), 4, (("s", m.col("qty"), "int64"),))
    return m.Plan("ff", (sink,))


def test_adjacent_filters_fuse_to_one_and():
    plan = _ff_plan(ir)
    out, applied = _same_rewrite_as_jax(plan, _ff_plan(jax_ir), {})
    assert [r for r, _ in applied] == ["filter_fuse"]
    fused = out.sinks[0].child
    assert isinstance(fused, ir.Filter) and isinstance(fused.child, ir.Scan)
    assert fused.pred.op == "and"
    _assert_same_outputs(plan, out, _facts())


def _pp_plan(m):
    node = m.Scan("facts", ("ka", "kb", "qty"))
    node = m.Project(node, (("d", m.Bin("add", m.col("qty"), m.lit(1))),))
    node = m.Project(node, (("e", m.Bin("mul", m.col("d"), m.lit(3))),))
    sink = m.SegmentAgg(node, m.col("ka"), 4, (("s", m.col("e"), "int64"),))
    return m.Plan("pp", (sink,))


def test_projects_fuse_with_inner_substitution():
    plan = _pp_plan(ir)
    out, applied = _same_rewrite_as_jax(plan, _pp_plan(jax_ir), {})
    assert [r for r, _ in applied] == ["project_fuse"]
    proj = out.sinks[0].child
    assert isinstance(proj, ir.Project) and isinstance(proj.child, ir.Scan)
    assert dict(proj.cols)["e"] == ir.Bin(
        "mul", ir.Bin("add", ir.col("qty"), ir.lit(1)), ir.lit(3))
    _assert_same_outputs(plan, out, _facts())


def test_join_reorder_puts_smaller_dim_first_by_stats():
    plan = _two_join_plan()
    out, applied = _same_rewrite_as_jax(plan, _two_join_plan(jax_ir),
                                        {"dim_a": 1000, "dim_b": 3})
    assert "join_reorder" in [r for r, _ in applied]
    upper = out.sinks[0].child
    assert upper.dim.table == "dim_a" and upper.child.dim.table == "dim_b"
    _assert_same_outputs(plan, out, _facts())


@pytest.mark.parametrize("stats", [{}, {"dim_a": 1000, "dim_b": 3}])
def test_join_reorder_canonicalizes_equivalent_queries(stats):
    out1, _ = rewrite_plan(_two_join_plan(a_first=True), stats)
    out2, _ = rewrite_plan(_two_join_plan(a_first=False), stats)
    assert out1 == out2
    assert ir.plan_signature(out1) == ir.plan_signature(out2)


def _exchange_plan(m, dtype="int64"):
    node = m.Scan("facts", ("ka", "kb", "qty"))
    node = m.Exchange(node, key=m.col("ka"), capacity=64, fields=("ka", "qty"))
    node = m.Filter(node, m.Bin("gt", m.col("qty"), m.lit(2)))
    sink = m.SegmentAgg(node, m.col("ka"), 4, (("s", m.col("qty"), dtype),))
    return m.Plan("ex", (sink,))


def _exchange_local(plan, tables):
    """One shard, one partition: the hash exchange's single-process run."""
    exchange, reduce_plan = split_exchange_plan(plan)
    (part0,) = emit_exchange_partitions(exchange, tables, 1, device="cpu")
    return eval_post(plan, execute_plan(None, reduce_plan, {EXCHANGE_SOURCE: part0},
                                        device="cpu"))


def test_filter_pushes_below_exchange_for_integer_sinks():
    plan = _exchange_plan(ir)
    out, applied = _same_rewrite_as_jax(plan, _exchange_plan(jax_ir), {})
    assert "filter_below_exchange" in [r for r, _ in applied]
    ex = out.sinks[0].child
    assert isinstance(ex, ir.Exchange) and isinstance(ex.child, ir.Filter)
    tables = _facts()
    o1, o2 = _exchange_local(plan, tables), _exchange_local(out, tables)
    for k in o1:
        np.testing.assert_array_equal(o1[k], o2[k])


def test_filter_stays_above_exchange_for_float_sinks():
    _out, applied = _same_rewrite_as_jax(_exchange_plan(ir, "float64"),
                                         _exchange_plan(jax_ir, "float64"), {})
    assert "filter_below_exchange" not in [r for r, _ in applied]


# ------------------------------------------------------- fixed point + fuzz


def _random_plan(rng, m) -> object:
    """A random small plan over Scan/Filter/Project/GatherJoin stacks with an
    integer SegmentAgg sink -- the node set the rewriter moves.  The draws do
    not depend on ``m``, so equal seeds give one plan in both packages."""
    cols = ["ka", "kb", "qty"]
    node = m.Scan("facts", ("ka", "kb", "qty"))
    gathers = [("dim_a", "w", "ka"), ("dim_b", "v", "kb")]
    n_new = 0
    for _ in range(int(rng.integers(1, 6))):
        choice = rng.integers(0, 3)
        if choice == 0:
            c = cols[int(rng.integers(0, len(cols)))]
            op = ("gt", "le", "ne")[int(rng.integers(0, 3))]
            node = m.Filter(node, m.Bin(op, m.col(c), m.lit(int(rng.integers(0, 6)))))
        elif choice == 1:
            c = cols[int(rng.integers(0, len(cols)))]
            n_new += 1
            name = f"p{n_new}"
            node = m.Project(node, ((name, m.Bin(
                "add", m.col(c), m.lit(int(rng.integers(1, 4))))),))
            cols.append(name)
        elif gathers:
            table, field, key = gathers.pop(int(rng.integers(0, len(gathers))))
            out_name = f"g_{field}"
            node = m.GatherJoin(node, m.Dim(table, (field,)), m.col(key), m.lit(0),
                                ((field, out_name),))
            cols.append(out_name)
    vcol = cols[int(rng.integers(0, len(cols)))]
    sink = m.SegmentAgg(node, m.col("ka"), 4,
                        (("s", m.col(vcol), "int64"), ("c", m.lit(1), "int64")))
    return m.Plan("fuzz", (sink,))


def test_rewrite_equivalence_fuzz():
    """Random plans: the port's rewrite is the JAX package's (signature and
    rule log), bit-identical in outputs to the unrewritten plan, and a fixed
    point within the bounded pass budget."""
    rng, jrng = np.random.default_rng(1234), np.random.default_rng(1234)
    stats_cases = ({}, {"dim_a": 1000, "dim_b": 3}, {"dim_a": 2, "dim_b": 900})
    for i in range(30):
        plan, jplan = _random_plan(rng, ir), _random_plan(jrng, jax_ir)
        assert ir.plan_signature(plan) == jax_ir.plan_signature(jplan)
        stats = stats_cases[i % len(stats_cases)]
        out, applied = _same_rewrite_as_jax(plan, jplan, stats)
        assert len(applied) < 64, "rewriter did not converge"
        again, reapplied = rewrite_plan(out, stats)
        assert reapplied == () and again == out
        _assert_same_outputs(plan, out, _facts(n=96, seed=i))
    assert MAX_PASSES == jax_opt.MAX_PASSES >= 2


# -------------------------------------- memoization, events, common subplans


def test_optimize_plan_memoizes_and_narrates_once():
    flight.recorder().reset_for_tests()
    tabreg.record_stats("dim_a", rows=1000)
    tabreg.record_stats("dim_b", rows=3)
    plan = _two_join_plan()
    out1 = optimize_plan(plan)
    assert optimize_plan(plan) is out1
    evs = [e for e in flight.snapshot() if e["kind"] == flight.EV_PLAN_REWRITE]
    assert evs and any(":rule:done" in e["detail"] for e in evs)
    assert len([e for e in flight.snapshot() if e["kind"] == flight.EV_PLAN_REWRITE]) == len(evs)


def test_stats_change_reoptimizes():
    plan = _two_join_plan()
    tabreg.record_stats("dim_a", rows=1000)
    tabreg.record_stats("dim_b", rows=3)
    small_b = optimize_plan(plan)
    tabreg.record_stats("dim_a", rows=3)
    tabreg.record_stats("dim_b", rows=1000)
    small_a = optimize_plan(plan)
    assert small_b != small_a
    assert small_b.sinks[0].child.dim.table == "dim_a"
    assert small_a.sinks[0].child.dim.table == "dim_b"


def test_common_subplan_tokens_report_shared_prefix():
    p1, _ = rewrite_plan(_two_join_plan(a_first=True, name="q_one"), {})
    p2, _ = rewrite_plan(_two_join_plan(a_first=False, name="q_two"), {})
    assert common_subplan_tokens(p1) == []
    shared = common_subplan_tokens(p2)
    assert shared and all(first == "q_one" for _sig, _ntype, first in shared)
    jp1, _ = jax_opt.rewrite_plan(_two_join_plan(jax_ir, True, "q_one"), {})
    assert jax_opt.subplan_signatures(jp1) == subplan_signatures(p1)


def test_observe_tables_records_rows_and_versioned_stats():
    t = _facts()
    tabreg.observe_tables(t)
    jax_tabreg.reset_for_tests()
    jax_tabreg.observe_tables(t)
    for name in t:
        assert tabreg.stats_of(name) == jax_tabreg.stats_of(name)
    jax_tabreg.reset_for_tests()
    assert tabreg.stats_of("dim_a")["rows"] == 4
    assert tabreg.stats_of("facts")["rows"] == 64
    tabreg.bump("dim_a")
    assert tabreg.stats_of("dim_a") is None
    tabreg.observe_tables(t)
    assert tabreg.stats_of("dim_a")["rows"] == 4


def test_run_governed_plan_gate_is_bit_identical():
    plan = _two_join_plan()
    tables = _facts()
    flight.recorder().reset_for_tests()
    off = run_governed_plan(None, plan, tables, device="cpu")
    assert tabreg.stats_of("dim_a") is None  # the flag is off: no stats recorded
    with config.override(plan_optimizer=True):
        on = run_governed_plan(None, plan, tables, device="cpu")
    assert tabreg.stats_of("dim_a")["rows"] == 4
    assert any(e["kind"] == flight.EV_PLAN_REWRITE for e in flight.snapshot())
    for k in off:
        np.testing.assert_array_equal(off[k], on[k])


def test_result_cache_flag_still_raises():
    """The result cache is ported: with its flag on, the second call of the
    optimized plan is a cache hit equal to the first."""
    from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

    result_cache.reset_for_tests()
    try:
        with config.override(serve_result_cache=True, plan_optimizer=True):
            first = run_governed_plan(None, _two_join_plan(), _facts(), device="cpu")
            second = run_governed_plan(None, _two_join_plan(), _facts(), device="cpu")
        assert result_cache.stats()["hits"] == 1
        assert list(second) == list(first)
        for k in first:
            np.testing.assert_array_equal(second[k], first[k])
    finally:
        result_cache.reset_for_tests()
