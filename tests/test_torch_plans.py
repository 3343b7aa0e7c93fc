"""The port's plan executor (``spark_rapids_jni_tpu_torch/plans``) and its
local q5 and q3 against the JAX package, on the CPU.

Inputs are made once with numpy from a seed; the JAX package runs them
through its own plan compiler on the CPU, the port through its eager
executor with ``device="cpu"``.  Comparisons are exact (integer data): every
output's values and dtype, and the formatted result rows.  The mesh cases
are in ``tests/test_torch_plan_ranks.py``.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.models import q3 as jax_q3
from spark_rapids_jni_tpu.models import q5 as jax_q5
from spark_rapids_jni_tpu.models import q97 as jax_q97
from spark_rapids_jni_tpu.plans import compiler as jax_compiler
from spark_rapids_jni_tpu.plans import ir as jax_ir
from spark_rapids_jni_tpu.plans import runtime as jax_runtime
from spark_rapids_jni_tpu_torch.models import q3, q5, q97
from spark_rapids_jni_tpu_torch.models.tpcds import (
    CHANNELS,
    generate_q3_data,
    generate_q5_data,
)
from spark_rapids_jni_tpu_torch.parallel import quantized_rows
from spark_rapids_jni_tpu_torch.plans import (
    CompiledPlan,
    PlanCache,
    compile_plan,
    execute_plan,
    input_signature,
    input_signature_raw,
    ir,
    output_names,
    pad_tables,
    plan_cache,
)
from spark_rapids_jni_tpu_torch.plans.compiler import _eval

SFS = [0.01, 0.05, 0.2]  # three pow2 batch buckets of q5's and q3's facts


@pytest.fixture(autouse=True)
def _fresh_plan_cache():
    """Deterministic hit/miss counting per test (the cache is process-global
    by design)."""
    plan_cache.clear()
    plan_cache.reset_stats()
    yield


def _check_outputs(got, want):
    """Equal output dicts: the same names, and per output the same dtype,
    shape and values."""
    assert list(got) == list(want)
    for name, w in want.items():
        w = np.asarray(w)
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


# --- IR mechanics ----------------------------------------------------------------------


def _toy_plan(m=ir, num_segments=4):
    node = m.Scan("t", ("k", "v"))
    node = m.Filter(node, m.Bin("ge", m.col("v"), m.lit(0)))
    sink = m.SegmentAgg(node, key=m.col("k"), num_segments=num_segments,
                        aggs=(("s", m.col("v"), "int64"), ("c", m.lit(1), "int32")))
    return m.Plan("toy", (sink,))


def _toy_tables(n, seed=0):
    rng = np.random.RandomState(seed)
    return {"t": {"k": rng.randint(0, 4, n).astype(np.int32),
                  "v": rng.randint(-5, 100, n).astype(np.int64)}}


def _toy_oracle(tables):
    k, v = tables["t"]["k"], tables["t"]["v"]
    ok = v >= 0
    s = np.bincount(k[ok], weights=v[ok], minlength=4).astype(np.int64)
    c = np.bincount(k[ok], minlength=4).astype(np.int32)
    return s, c


def _geo5(data):
    return (tuple(len(data.channels[n].dim_sk) for n in CHANNELS),
            data.sales_date_lo, data.sales_date_hi)


@pytest.mark.parametrize("which", ["q97", "q5", "q3", "toy"])
def test_plan_signature_equals_jax(which):
    """The IR is a faithful copy: a port plan and the JAX plan of the same
    structure have the same repr, hence the same signature."""
    d5 = generate_q5_data(sf=0.02, seed=5)
    geo3 = q3._geometry(generate_q3_data(sf=0.05, seed=17))
    got, want = {
        "q97": lambda: (q97.q97_plan(64), jax_q97.q97_plan(64)),
        "q5": lambda: (q5.q5_plan(*_geo5(d5)), jax_q5.q5_plan(*_geo5(d5))),
        "q3": lambda: (q3.q3_plan(**geo3), jax_q3.q3_plan(**geo3)),
        "toy": lambda: (_toy_plan(ir), _toy_plan(jax_ir)),
    }[which]()
    assert repr(got) == repr(want)
    assert ir.plan_signature(got) == jax_ir.plan_signature(want)


def test_lit_normalizes_numpy_scalars():
    assert ir.lit(np.int64(7)) == ir.lit(7)
    assert q5.q5_plan((np.int64(3), np.int32(4), 5), np.int64(10), 20) == \
        q5.q5_plan((3, 4, 5), 10, 20)


def test_toy_plan_matches_numpy_oracle_and_jax():
    tables = _toy_tables(100)
    out = execute_plan(None, _toy_plan(), tables, device="cpu")
    s, c = _toy_oracle(tables)
    np.testing.assert_array_equal(out["s"], s)
    np.testing.assert_array_equal(out["c"], c)
    _check_outputs(out, jax_runtime.execute_plan(None, _toy_plan(jax_ir), tables))


def test_plan_cache_hit_miss_across_pow2_lattice():
    """Same pow2 bucket = cache hit (no rebuild); a new bucket = exactly one
    new build.  Results stay exact at every length (pad rows are masked out
    by the implicit row-valid input)."""
    plan = _toy_plan()
    lengths = [100, 120, 128, 200, 512, 700]
    buckets = [quantized_rows(n, 1) for n in lengths]
    assert len(set(buckets)) == 4
    seen = set()
    for n, bucket in zip(lengths, buckets):
        before = plan_cache.stats()
        tables = _toy_tables(n, seed=n)
        out = execute_plan(None, plan, tables, device="cpu")
        s, c = _toy_oracle(tables)
        np.testing.assert_array_equal(out["s"], s)
        np.testing.assert_array_equal(out["c"], c)
        after = plan_cache.stats()
        if bucket in seen:
            assert after["traces"] == before["traces"], f"length {n} rebuilt a cached executor"
            assert after["hits"] == before["hits"] + 1
        else:
            assert after["traces"] == before["traces"] + 1
            seen.add(bucket)
    stats = plan_cache.stats()
    assert stats["entries"] == 4 and stats["execute_calls"] == len(lengths)


def test_raw_signature_matches_padded_signature_and_jax():
    """The O(1) raw-tables signature equals the padded-tables one, so
    execute_plan and make_distributed_* share one entry per geometry; both
    equal the JAX package's."""
    plan = _toy_plan()
    for n, dp in ((100, 1), (100, 8), (129, 8)):
        tables = _toy_tables(n, seed=n)
        raw = input_signature_raw(plan, tables, dp)
        assert raw == input_signature(plan, pad_tables(plan, tables, dp))
        assert raw == jax_runtime.input_signature_raw(_toy_plan(jax_ir), tables, dp)
        padded, jpadded = pad_tables(plan, tables, dp), jax_runtime.pad_tables(
            _toy_plan(jax_ir), tables, dp)
        for f in padded["t"]:
            np.testing.assert_array_equal(padded["t"][f], jpadded["t"][f])


def test_working_set_estimates_match_jax():
    from spark_rapids_jni_tpu_torch.plans import plan_working_set_bytes

    data = generate_q3_data(sf=0.05, seed=17)
    tables = q3._q3_tables(q3._facts(data), q3._dims(data))
    plan, jplan = q3.q3_plan(**q3._geometry(data)), jax_q3.q3_plan(**q3._geometry(data))
    for dp in (1, 8):
        want = jax_runtime.plan_working_set_bytes(jplan, tables, dp)
        assert plan_working_set_bytes(plan, tables, dp) == want == \
            q3.q3_working_set_bytes(q3._facts(data), dp)
    qp = q97.q97_plan(256)
    q97_tables = {"store": {"cust": np.ones(300, np.int32), "item": np.ones(300, np.int32)},
                  "catalog": {"cust": np.ones(70, np.int32), "item": np.ones(70, np.int32)}}
    assert plan_working_set_bytes(qp, q97_tables, 4) == \
        jax_runtime.plan_working_set_bytes(jax_q97.q97_plan(256), q97_tables, 4)


def test_split_and_combine_are_additive():
    from spark_rapids_jni_tpu_torch.plans import combine_outputs, split_scan_tables

    plan = _toy_plan()
    tables = _toy_tables(301, seed=3)
    halves = split_scan_tables(tables, ir.scan_tables(plan))
    assert [len(h["t"]["k"]) for h in halves] == [150, 151]
    outs = [execute_plan(None, plan, h, device="cpu") for h in halves]
    _check_outputs(combine_outputs(outs), execute_plan(None, plan, tables, device="cpu"))


# --- the cache -------------------------------------------------------------------------


def _dummy():
    return CompiledPlan(lambda: None, None, None, (), (), ())


def test_cache_builds_dedup_per_key_without_global_stall():
    """A slow build of one key must neither start twice for concurrent
    same-key callers NOR block a different key's build or stats()."""
    cache = PlanCache(maxsize=8)
    a_started, a_release = threading.Event(), threading.Event()
    a_builds = []

    def build_a():
        a_builds.append(1)
        a_started.set()
        assert a_release.wait(timeout=30)
        return _dummy()

    results = {}
    t1 = threading.Thread(target=lambda: results.update(a1=cache.get_or_compile("A", build_a)))
    t2 = threading.Thread(target=lambda: results.update(a2=cache.get_or_compile("A", build_a)))
    t1.start()
    assert a_started.wait(timeout=30)
    t2.start()  # same key: must wait for t1's build, not start a second
    results["b"] = cache.get_or_compile("B", _dummy)
    assert cache.stats()["misses"] == 1  # B done; A still building
    a_release.set()
    t1.join(timeout=30)
    t2.join(timeout=30)
    assert not t1.is_alive() and not t2.is_alive()
    assert len(a_builds) == 1, "same-key concurrent build must dedup"
    assert results["a1"] is results["a2"]
    s = cache.stats()
    assert s["misses"] == 2 and s["hits"] == 1  # t2's wait resolved as hit


def test_cache_failed_build_releases_waiters():
    cache = PlanCache(maxsize=8)
    calls = []

    def failing_then_ok():
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("injected build fault")
        return _dummy()

    with pytest.raises(RuntimeError):
        cache.get_or_compile("K", failing_then_ok)
    assert cache.get_or_compile("K", failing_then_ok) is not None
    assert len(calls) == 2


def test_cache_lru_evicts_the_oldest_and_defaults_to_64():
    assert PlanCache()._maxsize == 64
    cache = PlanCache(maxsize=2)
    a = cache.get_or_compile("a", _dummy)
    cache.get_or_compile("b", _dummy)
    assert cache.get_or_compile("a", _dummy) is a  # a is now the newest
    cache.get_or_compile("c", _dummy)  # evicts b
    s = cache.stats()
    assert (s["entries"], s["evictions"], s["hits"], s["misses"]) == (2, 1, 1, 3)
    assert cache.get_or_compile("a", _dummy) is a
    cache.get_or_compile("b", _dummy)
    assert cache.stats()["misses"] == 4


# --- refusals --------------------------------------------------------------------------


def _exchange_sink():
    node = ir.Project(ir.Scan("t", ("k",)), (("key", ir.col("k")),))
    node = ir.Exchange(node, key=ir.col("key"), capacity=8, fields=("key",))
    return ir.SegmentAgg(node, key=ir.lit(0), num_segments=1, aggs=(("s", ir.lit(1), "int64"),))


def test_exchange_plan_outputs_must_keep_dropped():
    sink = _exchange_sink()
    assert output_names(ir.Plan("ex", (sink,), outputs=("s", "dropped"))) == ("s", "dropped")
    with pytest.raises(ValueError, match="dropped"):
        output_names(ir.Plan("ex", (sink,), outputs=("s",)))


def test_local_exchange_plan_is_refused():
    plan = ir.Plan("ex", (_exchange_sink(),))
    with pytest.raises(ValueError, match="mesh required"):
        execute_plan(None, plan, {"t": {"k": np.arange(8, dtype=np.int64)}}, device="cpu")


def _order_plan(kind, m=ir):
    scan = m.Scan("t", ("k", "v"))
    keys = ((m.col("k"), True),)
    return {
        "Window": m.Plan("w", (m.SegmentAgg(
            m.Window(scan, (m.col("k"),), keys, (m.WinFunc("r", "rank"),)),
            key=m.col("k"), num_segments=4, aggs=(("s", m.col("r"), "int64"),)),)),
        "Sort": m.Plan("s", (m.Sort(scan, keys, ("v",)),)),
        "TopK": m.Plan("t", (m.TopK(scan, keys, 3, ("v",)),)),
        "RangeExchange": m.Plan("r", (m.SegmentAgg(
            m.RangeExchange(scan, keys, ("k", "v")), key=m.col("k"), num_segments=4,
            aggs=(("s", m.col("v"), "int64"),)),)),
    }[kind]


@pytest.mark.parametrize("kind", ["Window", "Sort", "TopK", "RangeExchange"])
def test_order_tier_is_refused(kind):
    """The order tier is refused only where the JAX package refuses it: a
    RangeExchange compiled in process, and an order sink (Sort, TopK) under a
    mesh.  Locally, Window, Sort and TopK plans run and equal the JAX
    package's (tests/test_torch_order_plans.py holds the rest)."""
    plan, tables = _order_plan(kind), _toy_tables(16)
    if kind == "RangeExchange":
        with pytest.raises(ValueError, match="RangeExchange"):
            execute_plan(None, plan, tables, device="cpu")
        return
    _check_outputs(execute_plan(None, plan, tables, device="cpu"),
                   jax_runtime.execute_plan(None, _order_plan(kind, jax_ir), tables))
    if kind != "Window":
        with pytest.raises(ValueError, match="order-sensitive"):
            compile_plan(plan, object(), input_signature(plan, pad_tables(plan, tables, 1)))


def test_uint64_cast_is_refused():
    with pytest.raises(ValueError, match="uint64"):
        _eval(ir.Cast(ir.col("a"), "uint64"), {"a": torch.arange(4)})


# --- _eval against JAX's, value and dtype ------------------------------------------------


def _env():
    rng = np.random.RandomState(61)
    n = 64
    return {
        "a8": rng.randint(-128, 128, n).astype(np.int8),
        "b8": rng.randint(-128, 128, n).astype(np.int8),
        "a32": rng.randint(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32),
        "a64": rng.randint(-(2**63), 2**63, n, dtype=np.int64),
        "b64": rng.randint(-(2**63), 2**63, n, dtype=np.int64),
        "s32": rng.randint(0, 32, n).astype(np.int32),  # shift amounts
        "s8": rng.randint(0, 8, n).astype(np.int8),
        "p": rng.rand(n) < 0.5,
        "q": rng.rand(n) < 0.5,
    }


C, L = ir.col, ir.lit
ARITH = [("a8", "a32"), ("a32", "a64"), ("a64", L(3)), (L(-2), "a8"), ("a8", "b8"),
         ("a64", "b64"), ("p", "a32"), (L(5), L(-7))]
PAIRS = {
    **{op: ARITH for op in ("add", "sub", "mul")},
    **{op: [("a8", "a32"), ("a64", L(0x0F0F)), ("p", "q"), ("p", L(True)), ("a32", "a64"),
            ("a8", "p"), (L(6), L(3))]
       for op in ("and", "or", "band", "bor")},
    **{op: [("a8", "a32"), ("a64", L(0)), (L(7), "a32"), ("a64", "b64"), ("p", "q"),
            ("a8", "b8"), (L(1), L(2))]
       for op in ("eq", "ne", "ge", "gt", "le", "lt")},
    **{op: [("a8", "a32"), ("a32", L(5)), (L(-9), "a64"), ("a64", "b64"), ("a8", L(-3)),
            (L(4), L(1))]
       for op in ("min", "max")},
    "shl": [("a64", L(32)), ("a32", L(3)), ("a8", L(9)), ("a32", "s32"), ("a64", "s8"),
            ("a8", "s8")],
}
BIN_CASES = [(op, lhs, rhs) for op in ir.BIN_OPS for lhs, rhs in PAIRS[op]]
UNARY_CASES = [("not", "a8"), ("not", "a32"), ("not", "p"), ("not", L(True)), ("neg", "a8"),
               ("neg", "a64"), ("neg", "a32"), ("neg", L(4))]
CAST_CASES = [(src, dt) for dt in ("bool", "int8", "int32", "int64", "float32", "float64")
              for src in ("a8", "a32", "a64", "p", L(300))]


def _e(x, m):
    return m.col(x) if isinstance(x, str) else m.Lit(x.value)


def _compare_eval(expr_of):
    env = _env()
    got = _eval(expr_of(ir), {k: torch.from_numpy(v) for k, v in env.items()})
    want = jax_compiler._eval(expr_of(jax_ir), {k: jnp.asarray(v) for k, v in env.items()})
    if not isinstance(got, torch.Tensor):
        # literals only: JAX gives the same python value, or a weakly typed
        # array of it (which takes the other operand's dtype, as a python
        # scalar does)
        if isinstance(want, jax.Array):
            assert want.weak_type
            want = want.item()
        assert got == want and type(got) is type(want)
        return
    assert isinstance(want, jax.Array) and not want.weak_type
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("op,lhs,rhs", BIN_CASES,
                         ids=[f"{o}-{l}-{r}" for o, l, r in BIN_CASES])
def test_eval_bin_matches_jax(op, lhs, rhs):
    _compare_eval(lambda m: m.Bin(op, _e(lhs, m), _e(rhs, m)))


@pytest.mark.parametrize("op,x", UNARY_CASES, ids=[f"{o}-{x}" for o, x in UNARY_CASES])
def test_eval_unary_matches_jax(op, x):
    _compare_eval(lambda m: m.Unary(op, _e(x, m)))


@pytest.mark.parametrize("src,dtype", CAST_CASES, ids=[f"{s}-{d}" for s, d in CAST_CASES])
def test_eval_cast_matches_jax(src, dtype):
    _compare_eval(lambda m: m.Cast(_e(src, m), dtype))


def test_eval_nested_promotion_matches_jax():
    """A cast of a literal is a typed 0-d value, which promotes like an
    array in JAX (torch alone would keep the other tensor's dtype)."""
    _compare_eval(lambda m: m.Bin("add", m.col("a8"), m.Cast(m.lit(3), "int32")))
    _compare_eval(lambda m: m.Bin("min", m.Bin("max", m.Cast(m.Bin("sub", m.col("a64"),
                                                                   m.lit(5)), "int32"),
                                               m.lit(0)), m.lit(99)))


# --- SegmentAgg's dropped keys ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_segment_agg_drops_masked_negative_and_large_keys_like_jax(dtype):
    rng = np.random.RandomState(7)
    n, nseg = 300, 6
    tables = {"t": {"k": rng.randint(-4, nseg + 4, n).astype(dtype),
                    "v": rng.randint(-50, 100, n).astype(np.int64),
                    "f": rng.rand(n) < 0.7}}

    def plan(m):
        node = m.Filter(m.Scan("t", ("k", "v", "f")), m.col("f"))
        return m.Plan("seg", (m.SegmentAgg(node, key=m.col("k"), num_segments=nseg, aggs=(
            ("s", m.col("v"), "int64"), ("c", m.lit(1), "int32"),
            ("w", m.Bin("mul", m.col("v"), m.lit(3)), "int32"))),))

    got = execute_plan(None, plan(ir), tables, device="cpu")
    _check_outputs(got, jax_runtime.execute_plan(None, plan(jax_ir), tables))
    k, v, f = (tables["t"][x] for x in ("k", "v", "f"))
    ok = f & (k >= 0) & (k < nseg)
    np.testing.assert_array_equal(got["c"], np.bincount(k[ok], minlength=nseg))


# --- q5 and q3, local ------------------------------------------------------------------


def test_parity_buckets_actually_distinct():
    q3_buckets = {quantized_rows(len(generate_q3_data(sf=sf, seed=11).ss_item_sk), 1)
                  for sf in SFS}
    q5_buckets = {quantized_rows(len(generate_q5_data(sf=sf, seed=12).channels["store"]
                                     .sales_sk), 1) for sf in SFS}
    assert len(q3_buckets) == len(q5_buckets) == 3


@pytest.mark.parametrize("sf", SFS)
def test_q5_local_matches_jax_and_unfused(sf):
    data = generate_q5_data(sf=sf, seed=12)
    got = [tuple(r) for r in q5.q5_local(data, device="cpu")]
    assert got == [tuple(r) for r in jax_q5.q5_local(data)]
    assert got == [tuple(r) for r in q5.q5_local_unfused(data, device="cpu")]
    plan, tables = q5._plan_and_tables(data)
    _check_outputs(execute_plan(None, plan, tables, device="cpu"),
                   jax_runtime.execute_plan(None, jax_q5.q5_plan(*_geo5(data)), tables))


@pytest.mark.parametrize("sf", SFS)
def test_q3_local_matches_jax_and_unfused(sf):
    data = generate_q3_data(sf=sf, seed=11)
    got = q3.q3_local(data, device="cpu")
    assert [tuple(r) for r in got] == [tuple(r) for r in jax_q3.q3_local(data)]
    assert got == q3.q3_local_unfused(data, device="cpu")
    tables = q3._q3_tables(q3._facts(data), q3._dims(data))
    geo = q3._geometry(data)
    _check_outputs(execute_plan(None, q3.q3_plan(**geo), tables, device="cpu"),
                   jax_runtime.execute_plan(None, jax_q3.q3_plan(**geo), tables))


def test_second_execution_does_not_rebuild():
    data = generate_q3_data(sf=0.05, seed=42)
    first = q3.q3_local(data, device="cpu")
    t0 = plan_cache.stats()["traces"]
    second = q3.q3_local(data, device="cpu")
    stats = plan_cache.stats()
    assert stats["traces"] == t0 == 1, "same-shape re-execution must not rebuild"
    assert stats["hits"] >= 1
    assert first == second


def test_local_plan_cache_key_holds_the_device():
    data = generate_q5_data(sf=0.01, seed=3)
    plan, tables = q5._plan_and_tables(data)
    padded = pad_tables(plan, tables, 1)
    from spark_rapids_jni_tpu_torch.plans import cached_compile

    a = cached_compile(plan, None, padded, device="cpu")
    assert cached_compile(plan, None, padded, device=torch.device("cpu")) is a
    assert a.device == torch.device("cpu") and a.mesh is None
    assert compile_plan(plan, None, a.signature, device="cpu").out_names == a.out_names


def test_mesh_plan_rebuilt_for_a_group_made_again():
    """A mesh plan's executor sums over its data axis's process group, so
    the cache key holds that group: an equal (1, 1) mesh over a group made
    again after destroy_process_group builds a new executor instead of one
    bound to the destroyed group (whose NCCL communicator is aborted)."""
    from spark_rapids_jni_tpu_torch.models.tpcds import generate_q97_tables
    from spark_rapids_jni_tpu_torch.parallel import axis_group, one_rank_mesh

    store, catalog = generate_q97_tables(sf=0.01, seed=42)
    answers, groups = [], []
    for _ in range(2):
        with one_rank_mesh("cpu") as mesh:
            traces = plan_cache.stats()["traces"]
            for _ in range(2):
                out = q97.run_distributed_q97(mesh, store, catalog)
                answers.append((int(out.store_only), int(out.catalog_only), int(out.both)))
            assert plan_cache.stats()["traces"] == traces + 1  # one build per group
            groups.append(axis_group(mesh, "data"))
    assert len(set(answers)) == 1
    assert groups[0] is not groups[1]


def test_unfused_bodies_match_jax_with_out_of_range_groups():
    """q3's per-op body scatters like ``.at[group].add(mode="drop")``: a
    group of -1 (brand id 0) counts from the end, as in JAX, and q5's masked
    segments drop their masked rows."""
    data = generate_q3_data(sf=0.05, seed=23)
    data.item_brand_id[::5] = 0  # group = year_off * n_brands - 1
    geo = q3._geometry(data)
    facts, dims = q3._facts(data), q3._dims(data)
    got = q3._partials(*(torch.from_numpy(v) for v in facts.values()),
                       **{k: torch.from_numpy(v) for k, v in dims.items()}, **geo)
    want = jax_q3._partials(*(jnp.asarray(v) for v in facts.values()),
                            **{k: jnp.asarray(v) for k, v in dims.items()}, **geo)
    for g, w in zip(got, want):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got.counts[-1]) > 0


def test_q5_host_channel_partials_match_jax():
    data = generate_q5_data(sf=0.05, seed=4)
    for name in CHANNELS:
        facts = q5._facts_of(data.channels[name])
        args = (facts, len(data.channels[name].dim_sk), data.date_sk, data.date_days,
                data.sales_date_lo, data.sales_date_hi)
        got = q5.q5_host_channel_partials(*args)
        want = jax_q5.q5_host_channel_partials(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    per = {n: q5.q5_host_channel_partials(
        q5._facts_of(data.channels[n]), len(data.channels[n].dim_sk), data.date_sk,
        data.date_days, data.sales_date_lo, data.sales_date_hi) for n in CHANNELS}
    assert q5.q5_rollup(per, q5._dim_ids(data)) == q5.q5_local(data, device="cpu")
