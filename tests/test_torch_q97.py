"""The port's q97, its nullable-key form, its host helpers and the TPC-DS
generators against the JAX package, on the CPU.

The distributed forms run on gloo ranks (``tests/torch_mesh_ranks.py``, one
spawn per mesh shape) and the JAX package on its 8-device CPU mesh, over the
same global inputs made once in numpy, with the cases of
``tests/test_q97.py`` and ``tests/test_q97_columns.py``.  Counts and drops
must be equal (tolerance 0), and equal to the host oracles.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_jni_tpu.columnar.column import Column as JaxColumn
from spark_rapids_jni_tpu.columnar.dtypes import INT32 as JAX_INT32
from spark_rapids_jni_tpu.models import q97 as jax_q97
from spark_rapids_jni_tpu.models import tpcds as jax_tpcds
from spark_rapids_jni_tpu.parallel import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu_torch.models import key_split
from spark_rapids_jni_tpu_torch.models import q97 as q97
from spark_rapids_jni_tpu_torch.models import tpcds
from torch_mesh_ranks import run_ranks

SHAPES = [(8, 1), (4, 2)]


def _gen(rng, n, n_cust, n_item):
    return (rng.randint(1, n_cust + 1, n).astype(np.int32),
            rng.randint(1, n_item + 1, n).astype(np.int32))


def _full_range_keys(rng, n):
    """(cust, item) int32 keys over the whole int32 range, negatives included."""
    return tuple(rng.randint(-(1 << 31), 1 << 31, n, dtype=np.int32) for _ in range(2))


def _counts(out):
    return int(out.store_only), int(out.catalog_only), int(out.both)


def _t(arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# --- cases of the plain form: (store, catalog, capacity) -----------------------


def _plain_cases(dp):
    rng = np.random.RandomState(3)
    n = 1024
    same = np.random.RandomState(11)  # the dry run's identical tables
    cust = same.randint(1, 40, 64 * dp).astype(np.int32)
    item = same.randint(1, 20, 64 * dp).astype(np.int32)
    ones = np.ones(256, np.int32)
    return {
        "random": (_gen(rng, n, 60, 40), _gen(rng, n, 60, 40), 2 * n),
        "identical": ((cust, item), (cust, item), 2 * 64 * dp),
        "overflow": ((ones, ones), (ones, ones), 4),  # one key: every row on one rank
    }


def _padded_case(dp):
    """Tables of uneven lengths padded to the quantized dp multiple, the pad
    rows (key (0, 0)) marked invalid."""
    rng = np.random.RandomState(12)
    store, catalog = _gen(rng, 301, 30, 20), _gen(rng, 157, 30, 20)
    out = {}
    for side, (cust, item) in (("s", store), ("c", catalog)):
        out[f"{side}_cust"], out[f"{side}_valid"] = jax_q97._pad_to_multiple(cust, dp)
        out[f"{side}_item"], _ = jax_q97._pad_to_multiple(item, dp)
    return store, catalog, out


# --- cases of the nullable form: (store, catalog) as lists with None ------------


def _null_gen(rng, n, null_pct=0.15, hi=40):
    cust = [None if rng.rand() < null_pct else int(v) for v in rng.randint(1, hi, n)]
    item = [None if rng.rand() < null_pct else int(v) for v in rng.randint(1, 12, n)]
    return cust, item


def _column_cases():
    rng = np.random.RandomState(21)
    cases = {"random": (_null_gen(rng, 40 * 8), _null_gen(rng, 30 * 8))}
    rng = np.random.RandomState(22)
    cases["no_nulls"] = (_null_gen(rng, 16 * 8, null_pct=0.0),
                         _null_gen(rng, 16 * 8, null_pct=0.0))
    rng = np.random.RandomState(23)
    cases["all_null_side"] = (([None] * 64, [1] * 64), _null_gen(rng, 64, null_pct=0.0))
    base = ([10, None] * 32, [7, 7] * 32)
    cases["same_null_pair"] = (base, base)
    return cases


def _column_arrays(store, catalog):
    out = {}
    for side, table in (("s", store), ("c", catalog)):
        for name, vals in zip(("cust", "item"), table):
            out[f"{side}_{name}"] = np.array([0 if v is None else v for v in vals], np.int32)
            if any(v is None for v in vals):
                out[f"{side}_{name}_valid"] = np.array([v is not None for v in vals])
        out[f"{side}_rv"] = np.ones(len(table[0]), bool)
    return out


def _garbage_arrays(n=64):
    """Null customer slots whose data bits are all different."""
    out = {}
    for side in ("s", "c"):
        out.update({f"{side}_cust": np.arange(1, n + 1, dtype=np.int32),
                    f"{side}_cust_valid": np.zeros(n, bool),
                    f"{side}_item": np.full(n, 7, np.int32), f"{side}_rv": np.ones(n, bool)})
    return out


def _dry_run_arrays(dp):
    """The dry run's nullable case: identical sides, 10% null customers."""
    same = np.random.RandomState(11)
    n = 64 * dp
    cust = same.randint(1, 40, n).astype(np.int32)
    item = same.randint(1, 20, n).astype(np.int32)
    valid = same.rand(n) >= 0.1
    out = {}
    for side in ("s", "c"):
        out.update({f"{side}_cust": cust, f"{side}_cust_valid": valid, f"{side}_item": item,
                    f"{side}_rv": np.ones(n, bool)})
    return out


def _columns_inputs(dp):
    """label -> (arrays, capacity)."""
    out = {}
    for name, (store, catalog) in _column_cases().items():
        arrays = _column_arrays(store, catalog)
        out[f"cols_{name}"] = (arrays, 2 * (len(store[0]) + len(catalog[0])) // dp)
    out["cols_garbage"] = (_garbage_arrays(), 2 * 64)
    out["cols_dry_run"] = (_dry_run_arrays(dp), 2 * 64 * dp)
    arrays, cap = out["cols_random"]
    out["cols_overflow"] = (arrays, cap // 16)
    return out


def _sql_oracle(store, catalog):
    """Pairs with None keys: distinct per side, never matching across."""
    s = set(zip(store[0], store[1]))
    c = set(zip(catalog[0], catalog[1]))
    s_null = {p for p in s if None in p}
    c_null = {p for p in c if None in p}
    s_nn, c_nn = s - s_null, c - c_null
    return len(s_nn - c_nn) + len(s_null), len(c_nn - s_nn) + len(c_null), len(s_nn & c_nn)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request, tmp_path_factory):
    """Every distributed case of this file on one spawn of gloo ranks per mesh
    shape: (shape, inputs by label, per-rank outputs)."""
    shape = request.param
    dp = shape[0]
    inputs, jobs = {}, []
    for label, (store, catalog, cap) in _plain_cases(dp).items():
        inputs[label] = ({"s_cust": store[0], "s_item": store[1], "c_cust": catalog[0],
                          "c_item": catalog[1]}, cap)
        jobs.append((label, "q97", inputs[label][0], {"capacity": cap}))
    padded = _padded_case(dp)[2]
    inputs["padded"] = (padded, 2 * len(padded["s_cust"]))
    jobs.append(("padded", "q97", padded, {"capacity": inputs["padded"][1],
                                           "with_validity": True}))
    for label, (arrays, cap) in _columns_inputs(dp).items():
        inputs[label] = (arrays, cap)
        jobs.append((label, "q97_columns", arrays, {"capacity": cap}))
    ranks = run_ranks(shape, jobs, tmp_path_factory.mktemp(f"q97ranks{dp}x{shape[1]}"))
    return shape, inputs, ranks


def _jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


def _rank_out(ranks, label):
    """The global Q97Out fields, equal on every rank."""
    outs = [r[label] for r in ranks]
    for o in outs[1:]:
        for name, v in o.items():
            np.testing.assert_array_equal(v, outs[0][name], err_msg=f"{label}.{name}")
    return outs[0]


def _check_equal(got, want):
    for name, w in zip(want._fields, want):
        w = np.asarray(w)
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        assert int(got[name]) == int(w), name


def _jax_q97(shape, arrays, cap, with_validity=False):
    mesh = _jax_mesh(shape)
    sharding = NamedSharding(mesh, P("data"))
    names = ["s_cust", "s_item", "c_cust", "c_item"]
    if with_validity:
        names += ["s_valid", "c_valid"]
    args = [jax.device_put(jnp.asarray(arrays[n]), sharding) for n in names]
    return jax_q97.make_distributed_q97(mesh, cap, with_validity=with_validity)(*args)


def _jax_q97_columns(shape, arrays, cap):
    mesh = _jax_mesh(shape)
    sharding = NamedSharding(mesh, P("data"))

    def put(a):
        return jax.device_put(jnp.asarray(a), sharding)

    cols = [JaxColumn(put(arrays[n]), put(arrays[n + "_valid"]) if n + "_valid" in arrays
                      else None, JAX_INT32)
            for n in ("s_cust", "s_item", "c_cust", "c_item")]
    return jax_q97.make_distributed_q97_columns(mesh, cap)(
        *cols, put(arrays["s_rv"]), put(arrays["c_rv"]))


# --- the plain form -------------------------------------------------------------------


def test_q97_local_matches_jax_and_oracle():
    rng = np.random.RandomState(7)
    store, catalog = _gen(rng, 500, 40, 25), _gen(rng, 700, 40, 25)
    got = q97.q97_local(_t(store), _t(catalog))
    want = jax_q97.q97_local(tuple(map(jnp.asarray, store)), tuple(map(jnp.asarray, catalog)))
    _check_equal({k: v.numpy() for k, v in got._asdict().items()}, want)
    assert _counts(got) == q97.q97_host_oracle(store, catalog) == \
        jax_q97.q97_host_oracle(store, catalog)


def test_q97_local_empty_and_disjoint():
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32))
    one = (np.array([1], np.int32), np.array([2], np.int32))
    assert _counts(q97.q97_local(_t(one), _t(empty))) == (1, 0, 0)
    assert _counts(q97.q97_local(_t(empty), _t(empty))) == (0, 0, 0)
    # duplicates collapse; (1,2) store-only, (1,3) catalog-only
    dup = (np.array([1, 1], np.int32), np.array([2, 2], np.int32))
    other = (np.array([1], np.int32), np.array([3], np.int32))
    assert _counts(q97.q97_local(_t(dup), _t(other))) == (1, 1, 0)


@pytest.mark.parametrize("label", ["random", "identical", "overflow"])
def test_distributed_q97_matches_jax_and_oracle(mesh_run, label):
    shape, inputs, ranks = mesh_run
    arrays, cap = inputs[label]
    got = _rank_out(ranks, label)
    _check_equal(got, _jax_q97(shape, arrays, cap))
    store = (arrays["s_cust"], arrays["s_item"])
    catalog = (arrays["c_cust"], arrays["c_item"])
    if label == "overflow":  # the retry-with-a-bigger-capacity signal fires
        assert int(got["dropped"]) > 0
        return
    assert int(got["dropped"]) == 0
    assert (int(got["store_only"]), int(got["catalog_only"]), int(got["both"])) == \
        q97.q97_host_oracle(store, catalog)
    if label == "identical":  # the dry run: every distinct key counts as both
        assert int(got["store_only"]) == int(got["catalog_only"]) == 0


def test_distributed_q97_padding_rows_do_not_count(mesh_run):
    shape, inputs, ranks = mesh_run
    arrays, cap = inputs["padded"]
    got = _rank_out(ranks, "padded")
    _check_equal(got, _jax_q97(shape, arrays, cap, with_validity=True))
    store, catalog, _ = _padded_case(shape[0])
    assert (int(got["store_only"]), int(got["catalog_only"]), int(got["both"])) == \
        q97.q97_host_oracle(store, catalog)
    assert len(arrays["s_cust"]) > len(store[0])  # padding was added


# --- the nullable form ---------------------------------------------------------------


@pytest.mark.parametrize("name", list(_column_cases()))
def test_q97_columns_matches_jax_and_sql_oracle(mesh_run, name):
    shape, inputs, ranks = mesh_run
    arrays, cap = inputs[f"cols_{name}"]
    got = _rank_out(ranks, f"cols_{name}")
    _check_equal(got, _jax_q97_columns(shape, arrays, cap))
    store, catalog = _column_cases()[name]
    assert int(got["dropped"]) == 0
    counts = (int(got["store_only"]), int(got["catalog_only"]), int(got["both"]))
    assert counts == _sql_oracle(store, catalog)
    if name == "no_nulls":  # agrees with the plain path
        local = q97.q97_local(_t([np.array(v, np.int32) for v in store]),
                              _t([np.array(v, np.int32) for v in catalog]))
        assert counts == _counts(local)
    if name == "all_null_side":  # one (NULL, 1) group, nothing joins
        assert counts[0] == 1 and counts[2] == 0
    if name == "same_null_pair":  # (10, 7) joins itself; (NULL, 7) never joins
        assert counts == (1, 1, 1)


def test_q97_columns_null_slots_with_garbage_data(mesh_run):
    """Logically-(NULL, 7) rows with different garbage bits form one group per
    side, and the two never join."""
    shape, inputs, ranks = mesh_run
    arrays, cap = inputs["cols_garbage"]
    got = _rank_out(ranks, "cols_garbage")
    _check_equal(got, _jax_q97_columns(shape, arrays, cap))
    assert (int(got["store_only"]), int(got["catalog_only"]), int(got["both"])) == (1, 1, 0)


def test_q97_columns_dry_run_and_overflow(mesh_run):
    """The dry run's identical nullable sides (null groups stay one-sided, so
    store_only == catalog_only), and a capacity below need reports drops, as
    the JAX package does."""
    shape, inputs, ranks = mesh_run
    for label in ("cols_dry_run", "cols_overflow"):
        arrays, cap = inputs[label]
        _check_equal(_rank_out(ranks, label), _jax_q97_columns(shape, arrays, cap))
    dry = _rank_out(ranks, "cols_dry_run")
    assert int(dry["dropped"]) == 0 and int(dry["store_only"]) == int(dry["catalog_only"]) > 0
    assert int(_rank_out(ranks, "cols_overflow")["dropped"]) > 0


def test_pair_key_and_two_limb_runs_match_jax():
    """The pair key's limbs, and run counting over keys that differ in either
    limb only, equal the JAX package's."""
    rng = np.random.RandomState(31)
    n = 300
    cust = rng.randint(-3, 3, n).astype(np.int32)
    item = rng.randint(-3, 3, n).astype(np.int32)
    cv, iv = rng.rand(n) >= 0.2, rng.rand(n) >= 0.2
    for side in (0, 1):
        got = q97._pair_key(*_t([cust, cv, item, iv]), side=side)
        want = jax_q97._pair_key(*map(jnp.asarray, (cust, cv, item, iv)), side=side)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kh, kl = rng.randint(0, 3, n).astype(np.int64), rng.randint(0, 3, n).astype(np.int64)
    kl[:5] = 0x7FFFFFFFFFFFFFFF  # the sentinel in one limb only is a real key
    store, valid = rng.rand(n) < 0.5, rng.rand(n) >= 0.1
    got = q97._count_runs_pair(*_t([kh, kl, store, valid]))
    want = jax_q97._count_runs_pair(*map(jnp.asarray, (kh, kl, store, valid)))
    assert [int(g) for g in got] == [int(w) for w in want]


# --- host helpers ----------------------------------------------------------------------


def test_split_q97_batch_children_sum_to_parent():
    rng = np.random.RandomState(41)
    store, catalog = _gen(rng, 900, 50, 30), _gen(rng, 700, 50, 30)
    batch = q97.Q97Batch(*store, *catalog, capacity=1024)
    jbatch = jax_q97.Q97Batch(*store, *catalog, capacity=1024)
    parent = q97.q97_local(_t(store), _t(catalog))
    pieces = [batch]
    for _ in range(2):  # two levels: four key-space pieces
        pieces = [c for p in pieces for c in q97.split_q97_batch(p)]
    jpieces = [jbatch]
    for _ in range(2):
        jpieces = [c for p in jpieces for c in jax_q97.split_q97_batch(p)]
    for p, jp in zip(pieces, jpieces):
        for f in ("s_cust", "s_item", "c_cust", "c_item"):
            np.testing.assert_array_equal(getattr(p, f), getattr(jp, f))
        assert (p.capacity, p.split_depth) == (jp.capacity, jp.split_depth) == (256, 2)
    outs = [q97.q97_local(_t((p.s_cust, p.s_item)), _t((p.c_cust, p.c_item))) for p in pieces]
    assert _counts(q97.combine_q97_outs(outs)) == _counts(parent)
    assert sum(p.rows for p in pieces) == batch.rows
    jcombined = jax_q97.combine_q97_outs(outs)
    assert _counts(jcombined) == _counts(q97.combine_q97_outs(outs))


def _assert_same_children(pieces, jpieces):
    assert len(pieces) == len(jpieces)
    for p, jp in zip(pieces, jpieces):
        for f in ("s_cust", "s_item", "c_cust", "c_item"):
            got, want = getattr(p, f), getattr(jp, f)
            assert got.dtype == want.dtype == np.int32 and got.flags.c_contiguous, f
            np.testing.assert_array_equal(got, want)
        assert (p.capacity, p.split_depth) == (jp.capacity, jp.split_depth)


# 0 rows, 1, odd, and more than one of the native split's row ranges (4 Mi rows)
@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("depth", [0, 1, 7, 8])
@pytest.mark.parametrize("rows", [0, 1, 999, (1 << 22) + 3])
def test_native_split_matches_jax_split(rows, depth, levels):
    rng = np.random.RandomState(rows % 1000 + depth)
    store, catalog = _full_range_keys(rng, rows), _full_range_keys(rng, rows // 2 + 1)
    pieces = [q97.Q97Batch(*store, *catalog, capacity=1 << 12, split_depth=depth)]
    jpieces = [jax_q97.Q97Batch(*store, *catalog, capacity=1 << 12, split_depth=depth)]
    for _ in range(levels):  # a second level splits the native split's children
        pieces = [c for p in pieces for c in q97.split_q97_batch(p)]
        jpieces = [c for p in jpieces for c in jax_q97.split_q97_batch(p)]
    _assert_same_children(pieces, jpieces)
    assert sum(p.rows for p in pieces) == len(store[0]) + len(catalog[0])


def test_key_split_library_builds_once_under_four_concurrent_first_splits(monkeypatch,
                                                                        tmp_path):
    real_run, builds = key_split.subprocess.run, []

    def slow_gxx(cmd, **kwargs):
        builds.append(cmd[cmd.index("-o") + 1])
        time.sleep(0.3)
        return real_run(cmd, **kwargs)

    monkeypatch.setattr(key_split, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(key_split.subprocess, "run", slow_gxx)
    monkeypatch.setattr(key_split, "_library", None)

    rng = np.random.RandomState(47)
    tables = [(_full_range_keys(rng, 500 + k), _full_range_keys(rng, 300 + k)) for k in range(4)]
    start = threading.Barrier(4)
    got, errors = [None] * 4, []

    def first_split(k):
        start.wait()
        try:
            got[k] = q97.split_q97_batch(q97.Q97Batch(*tables[k][0], *tables[k][1],
                                                      capacity=64))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=first_split, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(builds) == 1
    assert list((tmp_path / "native").iterdir()) == [key_split.library_path()]
    for k, (store, catalog) in enumerate(tables):
        _assert_same_children(got[k], jax_q97.split_q97_batch(
            jax_q97.Q97Batch(*store, *catalog, capacity=64)))


def test_sizing_helpers_match_jax():
    rng = np.random.RandomState(43)
    for n_s, n_c, dp, cap in ((1000, 700, 1, 64), (1001, 3, 4, 1 << 10), (5, 0, 8, 16)):
        store, catalog = _gen(rng, n_s, 9, 9), _gen(rng, n_c, 9, 9)
        b = q97.Q97Batch(*store, *catalog, capacity=cap)
        jb = jax_q97.Q97Batch(*store, *catalog, capacity=cap)
        assert q97.q97_working_set_bytes(b, dp) == jax_q97.q97_working_set_bytes(jb, dp)
        for total in (0, 1, n_s + n_c, 56_000_000):
            assert q97.default_q97_capacity(total, dp) == \
                jax_q97.default_q97_capacity(total, dp)
        got, gv = q97._pad_to_multiple(store[0], dp)
        want, wv = jax_q97._pad_to_multiple(store[0], dp)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(gv, wv)
    # the native split's side is the JAX package's split hash's bit, at every bit
    cust, item = _full_range_keys(rng, 64)
    h = jax_q97._split_hash(cust, item)
    for bit in range(64):
        ones = ((h >> np.uint64(bit)) & np.uint64(1)).astype(bool)
        (c0, i0), (c1, i1) = key_split.partition(cust, item, bit)
        for got, want in ((c0, cust[~ones]), (i0, item[~ones]), (c1, cust[ones]),
                          (i1, item[ones])):
            np.testing.assert_array_equal(got, want)


# --- the TPC-DS generators ------------------------------------------------------------


def _assert_same(got, want, path="data"):
    if dataclasses.is_dataclass(got):
        assert type(got).__name__ == type(want).__name__, path
        for f in dataclasses.fields(got):
            _assert_same(getattr(got, f.name), getattr(want, f.name), f"{path}.{f.name}")
    elif isinstance(got, dict):
        assert got.keys() == want.keys(), path
        for k in got:
            _assert_same(got[k], want[k], f"{path}[{k}]")
    elif isinstance(got, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{path}[{i}]")
    elif isinstance(got, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


@pytest.mark.parametrize("which", ["q97", "q5", "q3", "q5_dims"])
def test_tpcds_generators_reproduce_jax(which):
    make = {
        "q97": lambda m: m.generate_q97_tables(sf=0.01, seed=42),
        "q5": lambda m: m.generate_q5_data(sf=0.02, seed=3),
        "q3": lambda m: m.generate_q3_data(sf=0.05, seed=5),
        "q5_dims": lambda m: m.q5_dims(),
    }[which]
    got, want = make(tpcds), make(jax_tpcds)
    _assert_same(got, want)
    if which == "q97":
        assert len(got[0][0]) == 28_000 and got[0][0].dtype == np.int32
