"""The port's distributed layer against the JAX package, on the CPU.

The port runs on gloo ranks, one process per device of a (data, model) mesh
(``tests/torch_mesh_ranks.py``, one spawn per mesh shape); the JAX package
runs the same global inputs, made once in numpy, on its 8-device CPU mesh.
Every output is compared exactly (tolerance 0: integer data): the distributed
step's every field, whole receive buffers of the shuffle with ``row_valid``,
and the table shuffle's columns.  The single-process pieces (placement,
bucketing, padded strings) are compared directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_jni_tpu import config
from spark_rapids_jni_tpu.columnar.column import (
    Column as JaxColumn,
    Decimal128Column as JaxDecimal128Column,
    column as jax_column_of,
    decimal128_column as jax_decimal128_column,
    strings_column as jax_strings_column,
    strings_from_padded as jax_strings_from_padded,
)
from spark_rapids_jni_tpu.columnar.dtypes import INT32 as JAX_INT32
from spark_rapids_jni_tpu.models import nds as jax_nds
from spark_rapids_jni_tpu.ops.hashing import partition_mix32 as jax_partition_mix32
from spark_rapids_jni_tpu.parallel import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu.parallel import shard_map
from spark_rapids_jni_tpu.parallel import shuffle as jax_shuffle
from spark_rapids_jni_tpu.parallel import table_shuffle as jax_table_shuffle
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch.ops import partition_mix32
from spark_rapids_jni_tpu_torch.parallel import (
    bucket_by_partition,
    make_mesh,
    partition_of,
)
from torch_mesh_ranks import run_ranks

SHAPES = [(8, 1), (4, 2)]
ROWS_PER_DEV = 64  # the dry run's step size per data shard
STEP_CFGS = {"step": (64, 1 << 10, 3, 0), "step_overflow": (64, 1 << 10, 3, 4)}
SHUFFLE_LOCAL, SHUFFLE_CAP = 16, 5
TABLE_LOCAL = 16  # the dry run's table rows per data shard


def _step_inputs(dp):
    """Keys mostly in [0, 2**20) with some over the whole int64 range, and
    values in [0, 1000)."""
    rng = np.random.RandomState(100 + dp)
    n = ROWS_PER_DEV * dp
    keys = rng.randint(0, 1 << 20, n, dtype=np.int64)
    keys[::9] = rng.randint(-(2**63), 2**63, len(keys[::9]), dtype=np.int64)
    return {"keys": keys, "values": rng.randint(0, 1000, n, dtype=np.int64)}


def _shuffle_inputs(dp):
    """Half the rows on partition 0, so buckets overflow; a fifth of the rows
    invalid."""
    rng = np.random.RandomState(200 + dp)
    n = SHUFFLE_LOCAL * dp
    part = np.where(rng.rand(n) < 0.5, 0, rng.randint(0, dp, n)).astype(np.int32)
    return {"k": rng.randint(-1000, 1000, n, dtype=np.int64),
            "rows": rng.randint(-(2**31), 2**31, (n, 3), dtype=np.int64).astype(np.int32),
            "flag": rng.rand(n) < 0.5, "part": part, "row_valid": rng.rand(n) >= 0.2}


def _table_rows(dp):
    """The dry run's table: keys, decimals and strings, with nulls."""
    nt = TABLE_LOCAL * dp
    keys = np.random.RandomState(5).randint(0, 97, nt).astype(np.int32)
    decs = [None if i % 5 == 0 else (i << 32) + 7 for i in range(nt)]
    strs = [None if i % 7 == 0 else f"row{i}" * (1 + i % 3) for i in range(nt)]
    return keys, decs, strs


def _table_inputs(dp):
    keys, decs, strs = _table_rows(dp)
    raw = [b"" if s is None else s.encode() for s in strs]
    offsets = np.zeros(len(raw) + 1, np.int32)
    offsets[1:] = np.cumsum([len(b) for b in raw])
    return {"key": keys, "dec_hi": np.zeros(len(decs), np.int64),
            "dec_lo": np.array([0 if d is None else d for d in decs], np.int64),
            "dec_valid": np.array([d is not None for d in decs]),
            "s_chars": np.frombuffer(b"".join(raw), np.uint8),
            "s_offsets": offsets, "s_valid": np.array([s is not None for s in strs])}


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def mesh_run(request, tmp_path_factory):
    """Every job of this file on one spawn of gloo ranks per mesh shape:
    (shape, inputs by label, per-rank outputs)."""
    shape = request.param
    dp = shape[0]
    inputs = {label: _step_inputs(dp) for label in STEP_CFGS}
    inputs["shuffle"] = _shuffle_inputs(dp)
    inputs["table"] = _table_inputs(dp)
    jobs = [(label, "step", inputs[label], {"cfg": cfg}) for label, cfg in STEP_CFGS.items()]
    jobs += [("shuffle", "shuffle", inputs["shuffle"], {"capacity": SHUFFLE_CAP}),
             ("table", "table", inputs["table"], {"capacity": TABLE_LOCAL})]
    ranks = run_ranks(shape, jobs, tmp_path_factory.mktemp(f"ranks{dp}x{shape[1]}"))
    return shape, inputs, ranks


def _jax_mesh(shape):
    return jax_make_mesh(shape, devices=jax.devices()[:shape[0] * shape[1]])


def _put(mesh, *arrays):
    sharding = NamedSharding(mesh, P("data"))
    return [jax.device_put(jnp.asarray(a), sharding) for a in arrays]


def _replicas(ranks, label, shape, name, axis):
    """One output per coordinate along ``axis``, checked equal over the other
    axis (the replicas the mesh layout promises)."""
    dp, mp = shape
    grid = [[ranks[d * mp + m][label][name] for m in range(mp)] for d in range(dp)]
    if axis == "model":
        grid = [list(col) for col in zip(*grid)]
    for row in grid:
        for x in row[1:]:
            np.testing.assert_array_equal(x, row[0], err_msg=f"{label}.{name}")
    return [row[0] for row in grid]


# --- the distributed query step ----------------------------------------------


@pytest.mark.parametrize("label", list(STEP_CFGS))
def test_distributed_step_matches_jax(mesh_run, label):
    shape, inputs, ranks = mesh_run
    mesh = _jax_mesh(shape)
    nb, bits, k, cap = STEP_CFGS[label]
    want = jax_nds.make_distributed_query_step(
        mesh, jax_nds.QueryStepConfig(nb, bits, k, cap))(
            *_put(mesh, inputs[label]["keys"], inputs[label]["values"]))
    got = {
        "bucket_sums": np.concatenate(_replicas(ranks, label, shape, "bucket_sums", "data")),
        "bucket_counts": np.concatenate(_replicas(ranks, label, shape, "bucket_counts",
                                                  "data")),
        "bloom_bits": np.concatenate(_replicas(ranks, label, shape, "bloom_bits", "model")),
    }
    for name in ("probe_hits", "total_rows", "dropped"):
        vals = [r[label][name] for r in ranks]
        assert all(v == vals[0] for v in vals), (name, vals)
        got[name] = vals[0]
    for name, w in zip(want._fields, want):
        w = np.asarray(w)
        assert got[name].dtype == w.dtype and got[name].shape == w.shape, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)


def test_distributed_step_dry_run_invariants(mesh_run):
    """The dry run's assertions: rows conserved, no drops, every row through
    the aggregation and past its own bloom probe; the overflow config
    reports its drops."""
    shape, inputs, ranks = mesh_run
    rows = ROWS_PER_DEV * shape[0]
    out = ranks[0]["step"]
    assert int(out["total_rows"]) == rows and int(out["dropped"]) == 0
    assert int(out["probe_hits"]) == rows
    counts = _replicas(ranks, "step", shape, "bucket_counts", "data")
    sums = _replicas(ranks, "step", shape, "bucket_sums", "data")
    assert sum(int(c.sum()) for c in counts) == rows
    assert sum(int(s.sum()) for s in sums) == int(inputs["step"]["values"].sum())
    over = ranks[0]["step_overflow"]
    kept = sum(int(c.sum()) for c in _replicas(ranks, "step_overflow", shape,
                                               "bucket_counts", "data"))
    assert int(over["dropped"]) > 0 and kept + int(over["dropped"]) == rows


# --- the shuffle -----------------------------------------------------------------


def _jax_shuffle(shape, inp):
    mesh = _jax_mesh(shape)

    def body(k, rows, flag, part, row_valid):
        res = jax_shuffle.all_to_all_shuffle({"k": k, "rows": rows, "flag": flag}, part,
                                             SHUFFLE_CAP, axis="data", row_valid=row_valid)
        return res.columns, res.valid, res.dropped[None]

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * 5,
                           out_specs=(P("data"), P("data"), P("data")), check_vma=False))
    cols, valid, dropped = fn(*_put(mesh, inp["k"], inp["rows"], inp["flag"], inp["part"],
                                    inp["row_valid"]))
    return {n: np.asarray(c) for n, c in cols.items()}, np.asarray(valid), np.asarray(dropped)


def test_all_to_all_shuffle_matches_jax(mesh_run):
    """Whole receive buffers (padding slots included), slot occupancy and
    per-rank drops equal the JAX package's, with invalid rows and overflowing
    buckets."""
    shape, inputs, ranks = mesh_run
    dp, mp = shape
    cols, valid, dropped = _jax_shuffle(shape, inputs["shuffle"])
    slots = dp * SHUFFLE_CAP
    for rank, r in enumerate(ranks):
        d = rank // mp
        got = r["shuffle"]
        sl = slice(d * slots, (d + 1) * slots)
        for name, c in cols.items():
            assert got[f"col.{name}"].dtype == c.dtype, name
            np.testing.assert_array_equal(got[f"col.{name}"], c[sl], err_msg=name)
        np.testing.assert_array_equal(got["valid"], valid[sl])
        assert got["dropped"].dtype == np.int32 and int(got["dropped"]) == int(dropped[d])
    inp = inputs["shuffle"]
    assert int(dropped.sum()) > 0, "the case must overflow a bucket"
    assert int(valid.sum()) + int(dropped.sum()) == int(inp["row_valid"].sum())


# --- the table shuffle -------------------------------------------------------------


def _jax_table(shape):
    mesh = _jax_mesh(shape)
    dp = shape[0]
    keys, decs, strs = _table_rows(dp)
    kcol = jax_column_of([int(k) for k in keys], JAX_INT32)
    dcol = jax_decimal128_column(decs, precision=38, scale=2)
    ps = jax_table_shuffle.pad_strings(jax_strings_column(strs))

    def body(kd, dhi, dlo, dva, sbytes, slens, svalid):
        ex = jax_table_shuffle.shuffle_table(
            {"k": JaxColumn(kd, None, JAX_INT32),
             "d": JaxDecimal128Column(dhi, dlo, dva, dcol.dtype),
             "s": jax_table_shuffle.PaddedStrings(sbytes, slens, svalid)},
            (kd % dp).astype(jnp.int32), TABLE_LOCAL, axis="data")
        d, s = ex.columns["d"], ex.columns["s"]
        return (ex.columns["k"].data, ex.columns["k"].validity, ex.valid, d.hi, d.lo,
                d.validity, s.bytes, s.lengths, s.validity,
                jax.lax.psum(ex.dropped, "data"))

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"),) * 7,
                           out_specs=(P("data"),) * 9 + (P(),), check_vma=False))
    res = fn(*_put(mesh, kcol.data, dcol.hi, dcol.lo, dcol.is_valid(), ps.bytes, ps.lengths,
                   ps.validity))
    names = ("k", "k_valid", "valid", "d_hi", "d_lo", "d_valid", "s_bytes", "s_lengths",
             "s_valid", "dropped")
    return dict(zip(names, (np.asarray(x) for x in res)))


def test_shuffle_table_matches_jax(mesh_run):
    """Keys, decimal limbs and validity, padded string bytes, lengths and
    validity arrive in the JAX package's slots, bit for bit."""
    shape, _, ranks = mesh_run
    dp, mp = shape
    want = _jax_table(shape)
    slots = dp * TABLE_LOCAL
    for rank, r in enumerate(ranks):
        d = rank // mp
        got = r["table"]
        for name, w in want.items():
            w = w if name == "dropped" else w[d * slots:(d + 1) * slots]
            g = got[name].view(np.uint64) if name == "d_lo" else got[name]
            assert g.dtype == w.dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert int(want["dropped"]) == 0 and int(want["valid"].sum()) == TABLE_LOCAL * dp


def test_table_shuffle_rows_arrive_and_materialize(mesh_run):
    """Every sent row arrives on its key's owner with its payload intact, and
    materialize_strings gives back the sent strings, as the JAX package's
    materialize_strings does on the same slots."""
    shape, _, ranks = mesh_run
    dp, mp = shape
    keys, decs, strs = _table_rows(dp)
    got_rows = []
    for rank, r in enumerate(ranks):
        t = r["table"]
        d = rank // mp
        live = t["valid"]
        assert (t["k"][live] % dp == d).all()
        back = tc.strings_from_arrays(t["m_chars"], t["m_offsets"], t["m_valid"], device="cpu")
        ps = jax_table_shuffle.PaddedStrings(jnp.asarray(t["s_bytes"]),
                                             jnp.asarray(t["s_lengths"]),
                                             jnp.asarray(t["s_valid"]))
        jax_back = jax_table_shuffle.materialize_strings(ps)
        np.testing.assert_array_equal(t["m_offsets"], np.asarray(jax_back.offsets))
        assert back.to_list() == jax_back.to_list()
        strings = back.to_list()
        if rank % mp == 0:  # one model replica of each data shard
            for i in np.nonzero(live)[0]:
                dec = (int(t["d_hi"][i]) << 64 | int(t["d_lo"][i]) & (2**64 - 1)) \
                    if t["d_valid"][i] else None
                got_rows.append((int(t["k"][i]), dec, strings[i]))
    want = sorted(zip(keys.tolist(), decs, strs), key=repr)
    assert sorted(got_rows, key=repr) == want


# --- single-process pieces -----------------------------------------------------------


def _keys(n, seed):
    rng = np.random.RandomState(seed)
    k = rng.randint(-(2**63), 2**63, n, dtype=np.int64)
    k[:4] = [0, -1, -(2**63), 2**63 - 1]
    return k


@pytest.mark.parametrize("placement", ["murmur3", "mix32"])
@pytest.mark.parametrize("n_parts", [1, 3, 8, 1000])
def test_partition_of_matches_jax(placement, n_parts):
    keys = _keys(4096, 7)
    with config.override(partition_hash=placement):
        want = np.asarray(jax_shuffle.partition_of(jnp.asarray(keys), n_parts))
    got = partition_of(torch.from_numpy(keys), n_parts, placement=placement).numpy()
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("placement", ["murmur3", "mix32"])
def test_partition_of_follows_the_shared_partition_hash_setting(monkeypatch, placement):
    """With no placement given, the port places rows by the SRT_PARTITION_HASH
    setting that places the JAX package's rows."""
    monkeypatch.setenv("SRT_PARTITION_HASH", placement)
    keys = _keys(4096, 9)
    want = np.asarray(jax_shuffle.partition_of(jnp.asarray(keys), 8))
    np.testing.assert_array_equal(partition_of(torch.from_numpy(keys), 8).numpy(), want)
    other = {"murmur3": "mix32", "mix32": "murmur3"}[placement]
    assert not np.array_equal(
        partition_of(torch.from_numpy(keys), 8, placement=other).numpy(), want)


def test_partition_of_reduces_the_unsigned_hash():
    """Hashes with the top bit set (negative as int32) take the partition of
    their unsigned value."""
    from spark_rapids_jni_tpu_torch.ops import murmur3_raw_int64

    keys = torch.from_numpy(_keys(4096, 8))
    h = murmur3_raw_int64(keys, 42)
    assert bool((h < 0).any())
    want = (h.to(torch.int64) & 0xFFFFFFFF) % 7
    np.testing.assert_array_equal(partition_of(keys, 7).numpy(), want.numpy())
    with pytest.raises(ValueError, match="placement"):
        partition_of(keys, 7, placement="xxhash")


def test_partition_mix32_matches_jax():
    keys = _keys(4096, 9)
    want = np.asarray(jax_partition_mix32(jnp.asarray(keys)))
    got = partition_mix32(torch.from_numpy(keys)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)


BUCKET_CASES = {
    "ranks": ([2, 0, 2, 1, 2, 0], 3, 4),
    "overflow": ([0, 0, 0, 0, 0], 2, 3),
    "out_of_range": ([0, 2, 1, 2, 0], 2, 4),  # the invalid-row partition, ndev
    "random": (list(np.random.RandomState(4).randint(0, 8, 200)), 8, 20),
}


@pytest.mark.parametrize("case", list(BUCKET_CASES))
def test_bucket_by_partition_matches_jax(case):
    part, n_parts, cap = BUCKET_CASES[case]
    part = np.asarray(part, np.int32)
    want = jax_shuffle.bucket_by_partition(jnp.asarray(part), n_parts, cap)
    got = bucket_by_partition(torch.from_numpy(part), n_parts, cap)
    for name, g, w in zip(("slot", "in_cap", "counts"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if case == "overflow":
        assert int(got[1].sum()) == cap
    if case == "ranks":  # unique slots, each in its row's bucket
        assert len(set(got[0].tolist())) == len(part)
        assert (got[0].numpy() // cap == part).all()


STRINGS = ["a", "", None, "row12row12", "été", "x" * 37, None, "B\nc"]


@pytest.mark.parametrize("width", [None, 4, 40])
def test_padded_strings_match_jax(width):
    """StringColumn.padded and strings_from_padded against the JAX package's,
    the rebuilt column compared by rows and offsets (the port's chars hold
    exactly offsets[-1] bytes, the JAX package's a power of two)."""
    jcol = jax_strings_column(STRINGS)
    pcol = tc.strings_column(STRINGS, device="cpu")
    wb, wl = jcol.padded(width)
    gb, gl = pcol.padded(width)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))
    lens = np.minimum(np.asarray(wl), gb.shape[1])
    back = tc.strings_from_padded(gb, torch.from_numpy(lens), pcol.validity)
    jback = jax_strings_from_padded(wb, jnp.asarray(lens), jcol.validity)
    np.testing.assert_array_equal(back.offsets.numpy(), np.asarray(jback.offsets))
    assert back.chars.numel() == int(back.offsets[-1])
    np.testing.assert_array_equal(back.chars.numpy(),
                                  np.asarray(jback.chars)[:back.chars.numel()])
    if width is None or width >= 37:  # no row cut, so every row decodes
        assert back.to_list() == jback.to_list() == STRINGS


def test_padded_strings_edges():
    empty = tc.strings_column([], device="cpu")
    b, lens = empty.padded()
    assert b.shape == (0, 1) and lens.numel() == 0
    assert tc.strings_from_padded(b, lens).size == 0
    nulls = tc.strings_column([None, ""], device="cpu")
    b, lens = nulls.padded()
    assert b.tolist() == [[0], [0]]
    with pytest.raises(ValueError, match="lengths"):
        tc.strings_from_padded(b, torch.tensor([0, 2], dtype=torch.int32))


def test_make_mesh_needs_an_initialised_group(monkeypatch):
    """No group is made up: without init_process_group make_mesh raises, and
    its default device is the card."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh((1, 1), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh((1, 1))
