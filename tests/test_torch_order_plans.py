"""The port's order tier on plans (Window/Sort/TopK emitters, the range
exchange split, ``serve/shuffle``'s range driver, q67 and q64) against the
JAX package's, on the CPU.

Inputs are made with numpy from a seed; the JAX package runs them through its
own compiler and ``run_range_plan_local``, the port through its executor with
``device="cpu"``.  Every comparison is exact, values, dtypes AND row order:
q67, q64 and the global top-k against the JAX package and the pure-numpy
oracles, the multi-shard path (map emit -> range partitions -> per-partition
reduce -> ordered concat) against the local run, the map side's partitions
and splitters, and the reduce plan's signature.  The cluster tests of the JAX
package's ``tests/test_order_plans.py`` need the serving layer (ROADMAP A.15)
and are not mirrored.  Last, ``chip_smoke.py``'s vectorized oracles -- what
the card's full-size runs are held to -- are held against the per-row
oracles here.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from spark_rapids_jni_tpu.models import q64 as jax_q64
from spark_rapids_jni_tpu.models import q67 as jax_q67
from spark_rapids_jni_tpu.plans import compiler as jax_compiler
from spark_rapids_jni_tpu.plans import ir as jax_ir
from spark_rapids_jni_tpu.plans import runtime as jax_runtime
from spark_rapids_jni_tpu.serve import shuffle as jax_shuffle
from spark_rapids_jni_tpu_torch.models import (
    make_q64_tables,
    make_q67_tables,
    naive_sort_limit_plan,
    q64_oracle,
    q64_plan,
    q67_oracle,
    q67_plan,
    topk_oracle,
    topk_sales_plan,
)
from spark_rapids_jni_tpu_torch.plans import (
    EXCHANGE_SOURCE,
    compile_plan,
    emit_exchange_partitions,
    emit_range_partitions,
    eval_post,
    execute_plan,
    ir,
    plan_cache,
    run_governed_plan,
    sample_range_splitters,
    split_exchange_plan,
)
from spark_rapids_jni_tpu_torch.plans.compiler import _arg_layout
from spark_rapids_jni_tpu_torch.plans.ir import col
from spark_rapids_jni_tpu_torch.serve.shuffle import (
    combine_ordered_outputs,
    make_range_split,
    range_split_n,
    run_range_plan_local,
)


@pytest.fixture(autouse=True)
def _fresh_plan_cache():
    plan_cache.clear()
    yield


def _eq(got, want):
    """Equal output dicts: the same keys, and per key the same dtype and
    values in the same order."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def _local(plan, tables):
    return run_range_plan_local(plan, tables, device="cpu")


# ------------------------------------------------------------ local parity


@pytest.mark.parametrize("seed,rows,k", [(1, 5000, 3), (2, 900, 5), (3, 64, 2)])
def test_q67_local_equals_jax_and_oracle(seed, rows, k):
    tables = make_q67_tables(rows, 40, 5, seed=seed)
    got = _local(q67_plan(k, 40), tables)
    _eq(got, q67_oracle(tables, k))
    _eq(got, jax_shuffle.run_range_plan_local(jax_q67.q67_plan(k, 40), tables))


@pytest.mark.parametrize("seed,rows,k,band0", [(2, 4000, 4, 2), (5, 1200, 3, 0)])
def test_q64_local_equals_jax_and_oracle(seed, rows, k, band0):
    tables = make_q64_tables(rows, 30, 25, seed=seed)
    got = _local(q64_plan(k, 30, 25, band0), tables)
    _eq(got, q64_oracle(tables, k, band0))
    _eq(got, jax_shuffle.run_range_plan_local(jax_q64.q64_plan(k, 30, 25, band0), tables))


@pytest.mark.parametrize("k", [1, 7, 100])
def test_topk_local_equals_jax_including_k_beyond_rows(k):
    tables = make_q67_tables(60, 40, 5, seed=4)
    for plan, jplan in ((topk_sales_plan(k), jax_q67.topk_sales_plan(k)),
                        (naive_sort_limit_plan(k), jax_q67.naive_sort_limit_plan(k))):
        got = _local(plan, tables)
        _eq(got, topk_oracle(tables, k))
        _eq(got, jax_shuffle.run_range_plan_local(jplan, tables))
    assert int(got["rows"]) == min(k, 60)


def test_empty_input_yields_zero_rows():
    tables = {"store_sales": {"price": np.zeros(0, np.int64), "sid": np.zeros(0, np.int64)}}
    out = _local(topk_sales_plan(3), tables)
    assert int(out["rows"]) == 0 and len(out["price"]) == 0
    _eq(out, jax_shuffle.run_range_plan_local(jax_q67.topk_sales_plan(3), tables))


def test_filter_above_window_filters_on_window_output():
    """QUALIFY: the rank filter sits above the Window, so rank is computed
    over all rows and the cut comes after."""
    tables = make_q67_tables(400, 40, 5, seed=6)
    out = _local(q67_plan(1, 40), tables)
    assert (np.asarray(out["rk"]) == 1).all()
    _eq(out, q67_oracle(tables, 1))


@pytest.mark.parametrize("which", ["q67", "q64", "topk", "naive"])
def test_plan_and_reduce_plan_signatures_equal_jax(which):
    plan, jplan = {
        "q67": lambda: (q67_plan(3, 40), jax_q67.q67_plan(3, 40)),
        "q64": lambda: (q64_plan(3, 40, 25, 2), jax_q64.q64_plan(3, 40, 25, 2)),
        "topk": lambda: (topk_sales_plan(7), jax_q67.topk_sales_plan(7)),
        "naive": lambda: (naive_sort_limit_plan(7), jax_q67.naive_sort_limit_plan(7)),
    }[which]()
    assert ir.plan_signature(plan) == jax_ir.plan_signature(jplan)
    ex, reduce_plan = split_exchange_plan(plan)
    jex, jreduce = jax_compiler.split_exchange_plan(jplan)
    assert repr(ex) == repr(jex)
    assert ir.plan_signature(reduce_plan) == jax_ir.plan_signature(jreduce)
    assert EXCHANGE_SOURCE == jax_compiler.EXCHANGE_SOURCE


# ----------------------------------------------------------- the map side


@pytest.mark.parametrize("nparts", [1, 2, 5])
def test_splitters_and_range_partitions_equal_jax(nparts):
    tables = make_q64_tables(3000, 30, 25, seed=8)
    plan = q64_plan(3, 30, 25, 2)
    ex, _ = split_exchange_plan(plan)
    jex, _ = jax_compiler.split_exchange_plan(jax_q64.q64_plan(3, 30, 25, 2))
    for cap in (64, 4096):
        spl = sample_range_splitters(ex, tables, nparts, sample_cap=cap, device="cpu")
        assert spl == jax_compiler.sample_range_splitters(jex, tables, nparts, sample_cap=cap)
        assert all(type(v) is int for s in spl for v in s)
    parts = emit_range_partitions(ex, tables, nparts, spl, device="cpu")
    jparts = jax_compiler.emit_range_partitions(jex, tables, nparts, spl)
    assert len(parts) == len(jparts) == nparts
    for p, jp in zip(parts, jparts):
        _eq(p, jp)


def test_limit_pushdown_partitions_equal_jax():
    tables = make_q67_tables(2000, 40, 5, seed=3)
    ex, _ = split_exchange_plan(topk_sales_plan(7))
    jex, _ = jax_compiler.split_exchange_plan(jax_q67.topk_sales_plan(7))
    spl = sample_range_splitters(ex, tables, 3, device="cpu")
    parts = emit_range_partitions(ex, tables, 3, spl, device="cpu")
    assert sum(len(p["price"]) for p in parts) == 7
    for p, jp in zip(parts, jax_compiler.emit_range_partitions(jex, tables, 3, spl)):
        _eq(p, jp)


def test_range_split_n_equals_jax():
    tables = make_q67_tables(1001, 40, 5, seed=2)
    plan = q67_plan(3, 40)
    got = make_range_split(plan, device="cpu")(tables, 3)
    want = jax_shuffle.make_range_split(jax_q67.q67_plan(3, 40))(tables, 3)
    assert [s["splitters"] for s in got] == [s["splitters"] for s in want]
    for g, w in zip(got, want):
        for table in w["tables"]:
            _eq(g["tables"][table], w["tables"][table])


def test_range_partitions_refuse_a_wrong_splitter_count():
    ex, _ = split_exchange_plan(q67_plan(3, 40))
    with pytest.raises(ValueError, match="splitters"):
        emit_range_partitions(ex, make_q67_tables(10, 40, 5), 3, [(0,)], device="cpu")


# ----------------------------------------------- multi-shard simulation


def _run_multiparts(plan, tables, nshards, nparts):
    """The cluster's steps in one process (``chip_smoke._multiparts``, which
    the card's multi-shard runs use): map shards with shared splitters, each
    shard's range partitions, a reduce per partition, the ordered concat.
    Returns (result, bytes crossing the 'wire')."""
    return chip_smoke._multiparts(plan, tables, nshards, nparts, "cpu")


@pytest.mark.parametrize("nshards,nparts", [(1, 1), (2, 3), (4, 4), (3, 2)])
def test_q67_multi_shard_ordered_concat_is_merge_free(nshards, nparts):
    tables = make_q67_tables(5000, 40, 5, seed=1)
    plan = q67_plan(3, 40)
    got, _ = _run_multiparts(plan, tables, nshards, nparts)
    _eq(got, q67_oracle(tables, 3))
    _eq(got, _local(plan, tables))
    _eq(got, jax_shuffle.run_range_plan_local(jax_q67.q67_plan(3, 40), tables))


@pytest.mark.parametrize("nshards,nparts", [(2, 2), (3, 4)])
def test_q64_multi_shard_framed_aggs_survive_the_split(nshards, nparts):
    tables = make_q64_tables(4000, 30, 25, seed=2)
    got, _ = _run_multiparts(q64_plan(4, 30, 25, 2), tables, nshards, nparts)
    _eq(got, q64_oracle(tables, 4, 2))


def test_skewed_categories_empty_partitions_still_exact():
    tables = make_q67_tables(3000, 40, 5, seed=7)
    item = tables["item"]
    item["category"] = np.where(np.arange(40) < 36, 0, item["category"]).astype(np.int64)
    got, _ = _run_multiparts(q67_plan(3, 40), tables, 3, 6)
    _eq(got, q67_oracle(tables, 3))


def test_topk_limit_pushdown_cuts_shuffle_bytes():
    """The same answer, but the pushdown plan ships at most nshards*k rows
    while the naive sort-then-limit plan ships them all."""
    tables = make_q67_tables(20000, 40, 5, seed=3)
    k, nshards, nparts = 7, 4, 4
    want = topk_oracle(tables, k)
    got_p, bytes_push = _run_multiparts(topk_sales_plan(k), tables, nshards, nparts)
    got_n, bytes_naive = _run_multiparts(naive_sort_limit_plan(k), tables, nshards, nparts)
    _eq(got_p, want)
    _eq(got_n, want)
    row_bytes = 16  # price + sid, int64 each
    assert bytes_push <= nshards * k * row_bytes
    assert bytes_naive >= 20000 * row_bytes
    assert bytes_push * 20 < bytes_naive


def test_combine_ordered_outputs_skips_markers_and_refuses_additive_plans():
    plan = topk_sales_plan(2)
    parts = [{"price": np.array([9, 8]), "sid": np.array([1, 2]), "rows": np.int64(2)},
             {"reproduced": np.int64(1)},
             {"price": np.array([7]), "sid": np.array([3]), "rows": np.int64(1)}]
    got = combine_ordered_outputs(plan)(parts)
    want = jax_shuffle.combine_ordered_outputs(jax_q67.topk_sales_plan(2))(parts)
    _eq(got, want)
    assert int(got["rows"]) == 2
    agg = ir.Plan("agg", (ir.SegmentAgg(ir.Scan("t", ("k",)), col("k"), 4,
                                        (("c", ir.lit(1), "int64"),)),))
    with pytest.raises(ValueError, match="Sort/TopK"):
        combine_ordered_outputs(agg)


# ------------------------------------------------------- the hash half


def test_hash_exchange_partitions_and_post_equal_jax():
    """The hash exchange's map side and the post expressions over combined
    sinks, on a plan with a post."""
    rng = np.random.RandomState(12)
    tables = {"t": {"k": rng.randint(0, 50, 700).astype(np.int64),
                    "v": rng.randint(-9, 99, 700).astype(np.int64)}}

    def plan_of(m):
        node = m.Filter(m.Scan("t", ("k", "v")), m.Bin("ge", m.col("v"), m.lit(0)))
        node = m.Exchange(node, key=m.col("k"), capacity=256, fields=("k", "v"))
        sink = m.SegmentAgg(node, key=m.col("k"), num_segments=50,
                            aggs=(("s", m.col("v"), "int64"), ("c", m.lit(1), "int64")))
        return m.Plan("hx", (sink,), post=(("mean_num", m.Bin("mul", m.col("s"), m.lit(2))),))

    plan, jplan = plan_of(ir), plan_of(jax_ir)
    ex, reduce_plan = split_exchange_plan(plan)
    jex, jreduce = jax_compiler.split_exchange_plan(jplan)
    assert ir.plan_signature(reduce_plan) == jax_ir.plan_signature(jreduce)
    parts = emit_exchange_partitions(ex, tables, 3, device="cpu")
    jparts = jax_compiler.emit_exchange_partitions(jex, tables, 3)
    for p, jp in zip(parts, jparts):
        _eq(p, jp)
    sums = None
    for p in parts:
        out = execute_plan(None, reduce_plan, {EXCHANGE_SOURCE: p}, device="cpu")
        sums = out if sums is None else {k: sums[k] + out[k] for k in out}
    got = eval_post(plan, sums)
    want = jax_compiler.eval_post(jplan, sums)
    assert list(got) == list(want) == ["s", "c", "mean_num"]
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ------------------------------------------------- the refusal boundaries


def _sig_for(plan):
    return (None,) * len(_arg_layout(plan))


def test_range_exchange_refuses_in_process_compilation():
    plan = q67_plan(3, 40)
    with pytest.raises(ValueError, match="RangeExchange"):
        compile_plan(plan, None, _sig_for(plan), device="cpu")
    with pytest.raises(ValueError, match="RangeExchange"):
        execute_plan(None, plan, make_q67_tables(10, 40, 5), device="cpu")


def test_order_sink_refuses_mesh_lowering():
    plan = ir.Plan("local_sort", (ir.Sort(ir.Scan("t", ("k",)), keys=((col("k"), True),),
                                          fields=("k",)),))
    with pytest.raises(ValueError, match="order-sensitive"):
        compile_plan(plan, object(), _sig_for(plan))


def test_order_sink_must_be_the_only_sink():
    scan = ir.Scan("t", ("k", "v"))
    sort = ir.Sort(scan, keys=((col("k"), True),), fields=("k",))
    agg = ir.SegmentAgg(scan, key=col("k"), num_segments=4, aggs=(("s", col("v"), "int64"),))
    with pytest.raises(ValueError, match="only sink"):
        compile_plan(ir.Plan("mixed", (sort, agg)), None, (None,) * 3, device="cpu")


def _window_plan(m):
    scan = m.Scan("t", ("g", "v", "sid"))
    node = m.Window(
        scan, partition_by=(m.col("g"),),
        order_by=((m.col("v"), False), (m.col("sid"), True)),
        funcs=(m.WinFunc("rn", "row_number", dtype="int32"),
               m.WinFunc("rs", "sum", arg=m.col("v"), dtype="int64"),
               m.WinFunc("lo", "min", arg=m.col("v"), dtype="int64", preceding=2)))
    sink = m.Sort(node, keys=((m.col("g"), True), (m.col("rn"), True)),
                  fields=("g", "v", "sid", "rn", "rs", "lo"))
    return m.Plan("local_window", (sink,))


def test_governed_local_window_plan_runs_whole_and_equals_jax():
    """A Sort/Window plan with no RangeExchange is a plain local plan: the
    governed runner serves it whole (split depth forced to 0)."""
    rng = np.random.RandomState(9)
    tables = {"t": {"g": rng.randint(0, 4, 500).astype(np.int64),
                    "v": rng.randint(-100, 100, 500).astype(np.int64),
                    "sid": np.arange(500, dtype=np.int64)}}
    before = plan_cache.stats()["execute_calls"]
    out = run_governed_plan(None, _window_plan(ir), tables, device="cpu")
    assert plan_cache.stats()["execute_calls"] == before + 1
    want = jax_runtime.run_governed_plan(None, _window_plan(jax_ir), tables)
    _eq(out, want)
    n = int(out["rows"])
    order = np.lexsort((tables["t"]["sid"], -tables["t"]["v"], tables["t"]["g"]))
    assert n == 500 and len(out["g"]) == 512  # the padded bucket, invalid rows last
    np.testing.assert_array_equal(out["sid"][:n], tables["t"]["sid"][order])
    g, v, rn, rs = (out[f][:n] for f in ("g", "v", "rn", "rs"))
    start = 0
    for i in range(1, n + 1):
        if i == n or g[i] != g[start]:
            np.testing.assert_array_equal(rn[start:i], np.arange(1, i - start + 1))
            np.testing.assert_array_equal(rs[start:i], np.cumsum(v[start:i]))
            start = i


def test_range_driver_times_its_steps():
    """run_range_plan_local's steps land in the entry points' phase timers:
    the map emit, rank and sort and download (compiler.RANGE_PHASES), the
    reduce's upload and launch (runtime.PHASES) -- what the card's order
    line reads from its timed calls."""
    from spark_rapids_jni_tpu_torch.plans import compiler, runtime

    tables = make_q67_tables(3000, 40, 5, seed=2)
    run_range_plan_local(q67_plan(3, 40), tables, device="cpu")
    compiler.RANGE_PHASES.reset()
    runtime.PHASES.reset()
    run_range_plan_local(q67_plan(3, 40), tables, device="cpu")
    steps = {**compiler.RANGE_PHASES.snapshot(), **runtime.PHASES.snapshot()}
    assert set(steps) == {"emit", "rank_sort", "download", "upload", "launch"}
    assert all(v > 0 for v in steps.values()), steps


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tables = make_q67_tables(50, 40, 5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_range_plan_local(q67_plan(3, 40), tables)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        range_split_n(q67_plan(3, 40), tables, 2)


# --------------------------------------- the card's full-size oracles


@pytest.mark.parametrize("seed,rows,k", [(1, 5000, 3), (2, 900, 5), (3, 64, 2), (4, 0, 3)])
def test_chip_smoke_q67_oracle_equals_per_row_oracle(seed, rows, k):
    tables = make_q67_tables(rows, 40, 5, seed=seed)
    _eq(chip_smoke.q67_vector_oracle(tables, k), q67_oracle(tables, k))


@pytest.mark.parametrize("seed,rows,k,band0", [(2, 4000, 4, 2), (5, 1200, 3, 0),
                                               (6, 3000, 50, 4)])
def test_chip_smoke_q64_oracle_equals_per_row_oracle(seed, rows, k, band0):
    tables = make_q64_tables(rows, 30, 25, seed=seed)
    _eq(chip_smoke.q64_vector_oracle(tables, k, band0), q64_oracle(tables, k, band0))


@pytest.mark.parametrize("k", [1, 7, 100])
def test_chip_smoke_topk_oracle_equals_oracle(k):
    tables = make_q67_tables(3000, 40, 5, seed=4)
    tables["store_sales"]["price"][::7] = 9999  # a tie across the cut
    _eq(chip_smoke.topk_vector_oracle(tables, k), topk_oracle(tables, k))


def test_governed_order_plan_never_splits_under_pressure():
    """Under a budget below its working set an order plan does not split
    (the additive halving would scramble its rows): it fails without running
    a piece and gives its reservation back.  At a budget that holds it, it
    runs whole and equals the ungoverned run."""
    from spark_rapids_jni_tpu_torch import mem
    from spark_rapids_jni_tpu_torch.plans.runtime import plan_working_set_bytes

    rng = np.random.RandomState(4)
    tables = {"t": {"g": rng.randint(0, 4, 400).astype(np.int64),
                    "v": rng.randint(-100, 100, 400).astype(np.int64),
                    "sid": np.arange(400, dtype=np.int64)}}
    plan = _window_plan(ir)
    whole = execute_plan(None, plan, tables, device="cpu")
    need = plan_working_set_bytes(plan, tables, 1)

    gov = mem.MemoryGovernor(watchdog_period_s=0.02)
    try:
        tight = mem.BudgetedResource(gov, need // 2)
        before = plan_cache.stats()["execute_calls"]
        with pytest.raises(mem.MaxSplitDepthExceeded):
            run_governed_plan(None, plan, tables, budget=tight, device="cpu")
        assert plan_cache.stats()["execute_calls"] == before
        assert tight.used == 0
        roomy = mem.BudgetedResource(gov, need)
        out = run_governed_plan(None, plan, tables, budget=roomy, device="cpu")
        assert plan_cache.stats()["execute_calls"] == before + 1
        assert roomy.used == 0
    finally:
        gov.close()
    _eq(out, whole)
