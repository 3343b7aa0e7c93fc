"""The port's plan executor under a mesh against the JAX package, on the CPU:
q97's plan form, q5's and q3's plans, their ``make_distributed_*``
executors and q3's decimal-columns step.

The port runs on gloo ranks (``tests/torch_mesh_ranks.py``, one spawn per
mesh shape, (8, 1) and (4, 2)), every rank passing the same host tables; the
JAX package runs them on its 8-device CPU mesh.  Table lengths are not
multiples of dp, so the padding and the shard blocks are exercised.
Comparisons are exact: every output's values and dtype, the 128-bit limbs,
and the overflow refusal (``ShuffleCapacityExceeded`` on every rank).
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_jni_tpu.columnar.column import (
    Column as JaxColumn,
    Decimal128Column as JaxDecimal128Column,
)
from spark_rapids_jni_tpu.columnar.dtypes import INT32 as JAX_INT32, decimal as jax_decimal
from spark_rapids_jni_tpu.mem.governed import ShuffleCapacityExceeded as JaxShuffleCapacity
from spark_rapids_jni_tpu.models import q3 as jax_q3
from spark_rapids_jni_tpu.models import q5 as jax_q5
from spark_rapids_jni_tpu.models import q97 as jax_q97
from spark_rapids_jni_tpu.parallel import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu.plans import ir as jax_ir
from spark_rapids_jni_tpu.plans import runtime as jax_runtime
from spark_rapids_jni_tpu_torch.models import q3, q5
from spark_rapids_jni_tpu_torch.models.q97 import q97_host_oracle
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q3_data, generate_q5_data
from spark_rapids_jni_tpu_torch.parallel import quantized_rows
from torch_mesh_ranks import run_ranks

SHAPES = [(8, 1), (4, 2)]
Q97_SIZES = [120, 600, 2500]  # three pow2 buckets of the q97 plan on either shape
PLAN_CASES = {"q5": (0.0123, 7), "q3": (0.0123, 9)}  # (sf, seed): lengths % 8 != 0
Q3_COLS = (0.02, 5)  # (sf, seed) of the decimal-columns case
BIG = 1 << 62  # prices whose int64 sums wrap


def _q97_tables(n, seed):
    rng = np.random.RandomState(seed)
    m = max(1, n - n // 4)
    return {"s_cust": rng.randint(1, 40, n).astype(np.int32),
            "s_item": rng.randint(1, 12, n).astype(np.int32),
            "c_cust": rng.randint(1, 40, m).astype(np.int32),
            "c_item": rng.randint(1, 12, m).astype(np.int32)}


def _q97_cases(dp):
    """label -> (tables, capacity): three sizes at a capacity that holds all
    of a sender's rows (the real rows fill the leading shards, so the default
    capacity can overflow), and one key on every row at a capacity of 4,
    which overflows."""
    cases = {}
    for n in Q97_SIZES:
        t = _q97_tables(n, seed=n)
        rows = quantized_rows(len(t["s_cust"]), dp) + quantized_rows(len(t["c_cust"]), dp)
        cases[f"q97_{n}"] = (t, rows // dp)
    ones = np.ones(256, np.int32)
    cases["q97_overflow"] = ({"s_cust": ones, "s_item": ones, "c_cust": ones, "c_item": ones}, 4)
    return cases


def _q3_columns_data():
    """q3 data whose prices include values near +-2**62, so per-group sums
    pass the int64 range and only the 128-bit limbs hold them."""
    data = generate_q3_data(sf=Q3_COLS[0], seed=Q3_COLS[1])
    price = data.ss_ext_sales_price.copy()
    rng = np.random.RandomState(5)
    pick = rng.rand(len(price)) < 0.8
    price[pick] = rng.randint(BIG - 1000, BIG, pick.sum()) * rng.choice([1, -1, 1], pick.sum())
    return dataclasses.replace(data, ss_ext_sales_price=price)


def _q3_columns_inputs(dp):
    data = _q3_columns_data()
    hi, lo = jax_q3._price_limbs(data.ss_ext_sales_price)
    facts = jax_q3._pad_facts(dict(
        ss_item=data.ss_item_sk, ss_item_v=data.ss_item_sk_valid,
        ss_date=data.ss_sold_date_sk, ss_date_v=data.ss_sold_date_sk_valid,
        price_hi=hi, price_lo=lo.view(np.int64)), dp)
    return data, {**facts, **jax_q3._dims(data)}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request, tmp_path_factory):
    """Every case of this file on one spawn of gloo ranks per mesh shape:
    (shape, per-rank outputs)."""
    shape = request.param
    dp = shape[0]
    jobs = [(label, "q97_piece", tables, {"capacity": cap})
            for label, (tables, cap) in _q97_cases(dp).items()]
    for query, (sf, seed) in PLAN_CASES.items():
        jobs.append((query, "plan", {"_": np.zeros(1)}, {"query": query, "sf": sf,
                                                         "seed": seed}))
    data, arrays = _q3_columns_inputs(dp)
    jobs.append(("q3_columns", "q3_columns", arrays, {"geo": q3._geometry(data)}))
    ranks = run_ranks(shape, jobs, tmp_path_factory.mktemp(f"planranks{dp}x{shape[1]}"))
    return shape, ranks


def _jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


def _rank_out(ranks, label):
    """One label's outputs, equal on every rank."""
    outs = [r[label] for r in ranks]
    for o in outs[1:]:
        assert o.keys() == outs[0].keys()
        for name, v in o.items():
            np.testing.assert_array_equal(v, outs[0][name], err_msg=f"{label}.{name}")
    return outs[0]


def _check(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=what)


# --- q97's plan form ---------------------------------------------------------------------


@pytest.mark.parametrize("n", Q97_SIZES)
def test_run_q97_piece_matches_jax_and_oracle(mesh_run, n):
    shape, ranks = mesh_run
    tables, cap = _q97_cases(shape[0])[f"q97_{n}"]
    got = _rank_out(ranks, f"q97_{n}")
    assert int(got["raised"]) == 0
    piece = jax_q97.Q97Batch(tables["s_cust"], tables["s_item"], tables["c_cust"],
                             tables["c_item"], capacity=cap)
    want = jax_q97.run_q97_piece(_jax_mesh(shape), piece)
    for name, w in zip(want._fields, want):
        _check(got[name], w, name)
    assert int(got["dropped"]) == 0
    assert (int(got["store_only"]), int(got["catalog_only"]), int(got["both"])) == \
        q97_host_oracle((tables["s_cust"], tables["s_item"]), (tables["c_cust"], tables["c_item"]))


def test_run_q97_piece_overflow_raises_on_every_rank(mesh_run):
    shape, ranks = mesh_run
    assert all(int(r["q97_overflow"]["raised"]) == 1 for r in ranks)
    tables, cap = _q97_cases(shape[0])["q97_overflow"]
    with pytest.raises(JaxShuffleCapacity):
        jax_q97.run_q97_piece(_jax_mesh(shape), jax_q97.Q97Batch(
            tables["s_cust"], tables["s_item"], tables["c_cust"], tables["c_item"],
            capacity=cap))


# --- q5 and q3 plans and their executors --------------------------------------------------


def _jax_plan_and_tables(query):
    sf, seed = PLAN_CASES[query]
    if query == "q5":
        data = generate_q5_data(sf=sf, seed=seed)
        _plan, tables = q5._plan_and_tables(data)
        n_dims = tuple(len(data.channels[n].dim_sk) for n in ("store", "catalog", "web"))
        return data, jax_q5.q5_plan(n_dims, data.sales_date_lo, data.sales_date_hi), tables, \
            jax_q5.make_distributed_q5
    data = generate_q3_data(sf=sf, seed=seed)
    tables = q3._q3_tables(q3._facts(data), q3._dims(data))
    return data, jax_q3.q3_plan(**q3._geometry(data)), tables, jax_q3.make_distributed_q3


def _jax_fn_outputs(mesh, compiled, plan, tables):
    """The JAX executor's fn on its padded inputs, placed as execute_plan
    places them."""
    dp = mesh.shape["data"]
    padded = jax_runtime.pad_tables(plan, tables, dp)
    scans = {s.table for s in jax_ir.scan_tables(plan)}
    flat = []
    for name in compiled.arg_names:
        table, field = name.split(".", 1)
        spec = P("data") if table in scans else P()
        flat.append(jax.device_put(padded[table][field], NamedSharding(mesh, spec)))
    return dict(zip(compiled.out_names, (np.asarray(v) for v in compiled.fn(*flat))))


@pytest.mark.parametrize("query", list(PLAN_CASES))
def test_execute_plan_matches_jax(mesh_run, query):
    shape, ranks = mesh_run
    got = _rank_out(ranks, query)
    data, jplan, tables, _make = _jax_plan_and_tables(query)
    assert any(len(t[next(iter(t))]) % shape[0] for t in tables.values())  # uneven lengths
    want = jax_runtime.execute_plan(_jax_mesh(shape), jplan, tables)
    assert sorted(k[5:] for k in got if k.startswith("plan.")) == sorted(want)
    for name, w in want.items():
        _check(got[f"plan.{name}"], w, name)
    assert int(got["retraces"]) == 0 and int(got["hits"]) >= 1


@pytest.mark.parametrize("query", list(PLAN_CASES))
def test_make_distributed_executor_matches_jax(mesh_run, query):
    shape, ranks = mesh_run
    got = _rank_out(ranks, query)
    assert int(got["same"]) == 1  # the identical cached executor on every call
    data, jplan, tables, make = _jax_plan_and_tables(query)
    mesh = _jax_mesh(shape)
    want = _jax_fn_outputs(mesh, make(mesh, data), jplan, tables)
    assert sorted(k[3:] for k in got if k.startswith("fn.")) == sorted(want)
    for name, w in want.items():
        _check(got[f"fn.{name}"], w, name)
    if query == "q5":
        rows = q5.q5_rollup(q5._partials_of({k[3:]: v for k, v in got.items()
                                             if k.startswith("fn.")}), q5._dim_ids(data))
        assert rows == q5.q5_local(data, device="cpu")
    else:
        rows = q3._format(q3._Partials(got["fn.sums"], got["fn.counts"]), data,
                          q3._geometry(data)["year0"])
        assert rows == q3.q3_local(data, device="cpu") and rows


# --- q3's decimal-columns step ---------------------------------------------------------


def test_q3_columns_step_matches_jax_and_host_oracle(mesh_run):
    shape, ranks = mesh_run
    got = _rank_out(ranks, "q3_columns")
    assert int(got["same"]) == 1
    data, arrays = _q3_columns_inputs(shape[0])
    mesh = _jax_mesh(shape)

    def put(name):
        return jax.device_put(arrays[name], NamedSharding(mesh, P("data")))

    dims = [jax.device_put(arrays[n], NamedSharding(mesh, P()))
            for n in ("item_brand", "item_manufact", "date_year", "date_moy")]
    step = jax_q3._q3_columns_step_cached(mesh, tuple(sorted(q3._geometry(data).items())))
    want = step(JaxColumn(put("ss_item"), put("ss_item_v"), JAX_INT32),
                JaxColumn(put("ss_date"), put("ss_date_v"), JAX_INT32),
                JaxDecimal128Column(put("price_hi"), jax.device_put(
                    arrays["price_lo"].view(np.uint64), NamedSharding(mesh, P("data"))),
                    None, jax_decimal(38, 2)), *dims)
    _check(got["hi"], want.hi, "hi")
    _check(got["lo"].view(np.uint64), want.lo, "lo")
    _check(got["counts"], want.counts, "counts")

    sums = [int(h) * (1 << 64) + int(x) for h, x in zip(got["hi"], got["lo"].view(np.uint64))]
    geo = q3._geometry(data)
    rows = q3._assemble_rows(got["counts"], lambda g: sums[g], geo["year0"],
                             len(data.brand_names), lambda idx: [data.brand_names[i] for i in idx])
    assert rows == q3.q3_columns_host_oracle(data) == jax_q3.q3_columns_host_oracle(data)
    assert rows and any(abs(r.sum_agg) >= 1 << 63 for r in rows)  # past int64: limbs carried
