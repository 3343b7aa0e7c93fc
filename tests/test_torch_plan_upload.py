"""The plan runtime's upload (``plans/runtime.upload_inputs``) against the
padded layout it builds on the device, on the CPU.

The padded layout is defined on the host by ``pad_tables`` and
``plan_inputs``; ``upload_inputs`` must give the same flat inputs from the
raw tables, value for value, dtype for dtype and shape for shape, for every
data index of a one- and a two-way data axis.  ``execute_plan`` must reach
the executor without the host pad, and count what it moved in the flight
recorder's ``plan_upload`` source.  The pinned staging ring's chunking runs
here over plain host chunks; the case marked ``cuda`` runs the real ring and
skips without a card.  No JAX here: the oracle is the port's own host pad.
"""

import dataclasses

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.models import q3, q97
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q3_data
from spark_rapids_jni_tpu_torch.obs import flight
from spark_rapids_jni_tpu_torch.parallel import one_rank_mesh
from spark_rapids_jni_tpu_torch.plans import (
    CompiledPlan,
    compiled_plan_for,
    execute_plan,
    pad_tables,
    plan_cache,
    plan_inputs,
    plan_upload_stats,
    runtime,
    upload_inputs,
)
from spark_rapids_jni_tpu_torch.plans.compiler import _arg_layout


@dataclasses.dataclass
class _DataIndex:
    """What ``parallel.mesh.axis_size`` and ``axis_index`` read of a mesh:
    ``dp`` ranks along the data axis, this one at ``d``."""

    dp: int
    d: int
    mesh_dim_names = ("data", "model")

    @property
    def shape(self):
        return (self.dp, 1)

    def get_local_rank(self, name):
        return self.d if name == "data" else 0


def _compiled(plan, dp, d, device="cpu"):
    """The call metadata of ``plan``'s executor at data index ``d`` of
    ``dp`` (no executor: only the upload is under test)."""
    names = tuple(f"{t}.{f}" for _k, t, f in _arg_layout(plan))
    return CompiledPlan(None, plan, _DataIndex(dp, d), None, (), names, torch.device(device))


def _q3(n=None, seed=3):
    data = generate_q3_data(sf=0.01, seed=seed)
    tables = q3._q3_tables(q3._facts(data), q3._dims(data))
    if n is not None:
        tables["store_sales"] = {k: v[:n] for k, v in tables["store_sales"].items()}
    return q3.q3_plan(**q3._geometry(data)), tables


def _q97(n_store, n_catalog, seed=5):
    rng = np.random.RandomState(seed)

    def side(n):
        return {"cust": rng.randint(1, 400, n).astype(np.int32),
                "item": rng.randint(1, 60, n).astype(np.int32)}

    plan = q97.q97_plan(q97.default_q97_capacity(n_store + n_catalog, 1))
    return plan, {"store": side(n_store), "catalog": side(n_catalog)}


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and g.device == w.device
        assert torch.equal(g, w)


def _oracle(compiled, tables):
    return plan_inputs(compiled, pad_tables(compiled.plan, tables, compiled.mesh.dp))


# (query, rows of each scan table): n < m, n == m (1,024 and 2,048 are a
# dp-aligned pow2), one row, and lengths where a two-way axis's second
# block is partly real (1,500 -> blocks of 1,024) or wholly pad (1 -> 1)
CASES = [("q3", 1200), ("q3", 1024), ("q3", 1), ("q3", 700),
         ("q97", (1500, 2048)), ("q97", (1, 1024)), ("q97", (700, 3))]


def _tables(query, rows):
    return _q3(rows) if query == "q3" else _q97(*rows)


@pytest.mark.parametrize("dp", [1, 2])
@pytest.mark.parametrize("query,rows", CASES)
def test_upload_equals_the_padded_host_layout(query, rows, dp):
    plan, tables = _tables(query, rows)
    for d in range(dp):
        compiled = _compiled(plan, dp, d)
        _assert_same(upload_inputs(compiled, tables), _oracle(compiled, tables))


def test_blocks_wholly_pad_and_partly_real():
    """One row over a two-way axis: block 0 holds it, block 1 is all pad
    (zeros, valid False); 1,500 rows: block 1 holds 476 real rows."""
    plan, tables = _q97(1, 1500)
    names = _compiled(plan, 2, 0).arg_names
    for d, real in ((0, {"store": 1, "catalog": 1024}), (1, {"store": 0, "catalog": 476})):
        flat = dict(zip(names, upload_inputs(_compiled(plan, 2, d), tables)))
        for table, n in real.items():
            valid = flat[f"{table}.__valid__"]
            assert valid.dtype == torch.bool and int(valid.sum()) == n
            assert bool(valid[:n].all())
            for f in ("cust", "item"):
                col = flat[f"{table}.{f}"]
                assert not bool(col[n:].any())
                want = tables[table][f][d * len(col):d * len(col) + n]
                np.testing.assert_array_equal(col[:n].numpy(), want)


@pytest.mark.parametrize("stride", [2, -1, -3])
def test_strided_numpy_columns(stride):
    """Columns that are strided views of larger arrays (forward and
    backward) upload as their contiguous copies would."""
    plan, tables = _q3()
    wide = {k: np.repeat(v, 3) for k, v in tables["store_sales"].items()}
    tables["store_sales"] = {k: v[::stride][:700] for k, v in wide.items()}
    assert not tables["store_sales"]["price"].flags.c_contiguous
    dense = dict(tables, store_sales={k: np.ascontiguousarray(v)
                                      for k, v in tables["store_sales"].items()})
    for dp in (1, 2):
        for d in range(dp):
            compiled = _compiled(plan, dp, d)
            got = upload_inputs(compiled, tables)
            _assert_same(got, _oracle(compiled, tables))
            _assert_same(got, _oracle(compiled, dense))


def test_field_dtypes_are_kept():
    """q3's scan fields are bool, int32 and int64, and keep their dtype."""
    plan, tables = _q3()
    compiled = _compiled(plan, 1, 0)
    flat = dict(zip(compiled.arg_names, upload_inputs(compiled, tables)))
    assert flat["store_sales.ss_item_v"].dtype == torch.bool
    assert flat["store_sales.ss_item"].dtype == torch.int32
    assert flat["store_sales.price"].dtype == torch.int64
    assert flat["item.brand"].dtype == torch.int32


def test_dims_already_on_the_device_pass_through():
    plan, tables = _q3()
    up = runtime._upload_dims(plan, tables, None, "cpu")
    compiled = _compiled(plan, 1, 0)
    flat = dict(zip(compiled.arg_names, upload_inputs(compiled, up)))
    for table in ("item", "date_dim"):
        for f, t in up[table].items():
            assert flat[f"{table}.{f}"] is t
    _assert_same(list(flat.values()), _oracle(compiled, up))


def test_ragged_scan_table_raises():
    plan, tables = _q3()
    tables["store_sales"]["price"] = tables["store_sales"]["price"][:-1]
    with pytest.raises(ValueError, match="ragged scan table 'store_sales'"):
        upload_inputs(_compiled(plan, 1, 0), tables)


class _Event:
    """A stand-in for ``torch.cuda.Event`` on the CPU: busy until it has
    been asked once, so every refill of a chunk counts a wait."""

    made = []

    def __init__(self):
        self.synced = False
        _Event.made.append(self)

    def record(self, stream):
        self.stream = stream

    def query(self):
        return self.synced

    def synchronize(self):
        self.synced = True


@pytest.mark.parametrize("chunk_bytes", [8, 24, 4096])
def test_staging_ring_chunks_a_column(monkeypatch, chunk_bytes):
    """The ring's copy over chunks smaller than the column (and over one
    chunk larger): every element arrives, the two chunks take turns, and a
    chunk is refilled only after its last copy's event."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    _Event.made = []
    ring = runtime._StagingRing([torch.empty(chunk_bytes, dtype=torch.uint8)
                                 for _ in range(runtime.STAGING_CHUNKS)])
    rng = np.random.RandomState(chunk_bytes)
    src = torch.from_numpy(rng.randint(-2**40, 2**40, 301, dtype=np.int64)[::-1].copy())
    dst = torch.empty(301, dtype=torch.int64)
    waits = ring.copy(dst[:250], src[:250], "stream")
    waits += ring.copy(dst[250:], src[250:], "stream")
    assert torch.equal(dst, src)
    per = chunk_bytes // 8
    n_chunks = -(-250 // per) + -(-51 // per)
    assert len(_Event.made) == n_chunks
    assert waits == max(0, n_chunks - runtime.STAGING_CHUNKS)
    assert all(e.stream == "stream" for e in _Event.made)


def _no_host_pad(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("execute_plan padded on the host")

    monkeypatch.setattr(runtime, "pad_tables", refuse)
    monkeypatch.setattr(runtime, "plan_inputs", refuse)


def _padded_run(compiled, tables):
    """The executor's outputs on the host-padded inputs."""
    outs = compiled.fn(*plan_inputs(compiled, pad_tables(compiled.plan, tables,
                                                         runtime._dp(compiled.mesh))))
    return {k: v.cpu().numpy() for k, v in zip(compiled.out_names, outs)}


def _equal_outputs(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_execute_plan_never_pads_on_the_host(monkeypatch):
    plan_cache.clear()
    plan, tables = _q3(700)
    want = _padded_run(compiled_plan_for(plan, None, tables, "cpu"), tables)
    qplan, qtables = _q97(1500, 700)
    with one_rank_mesh("cpu") as mesh:
        qwant = _padded_run(compiled_plan_for(qplan, mesh, qtables), qtables)
        _no_host_pad(monkeypatch)
        _equal_outputs(execute_plan(mesh, qplan, qtables), qwant)
    _equal_outputs(execute_plan(None, plan, tables, device="cpu"), want)


def test_plan_upload_counts_each_path(monkeypatch):
    """The ``plan_upload`` telemetry source counts a CPU upload's bytes as
    copied without pinning, with the pad tails and valid arrays written."""
    runtime.reset_plan_upload_stats()
    plan, tables = _q3(700)
    execute_plan(None, plan, tables, device="cpu")
    facts = tables["store_sales"]
    real = sum(v.nbytes for v in facts.values())
    dims = sum(v.nbytes for t in ("item", "date_dim") for v in tables[t].values())
    pad = sum((1024 - 700) * v.itemsize for v in facts.values()) + 1024
    stats = flight.unified_snapshot()["plan_upload"]
    assert stats == plan_upload_stats()
    assert stats == {"pinned_bytes": 0, "unpinned_bytes": real + dims, "pad_bytes": pad,
                     "chunk_waits": 0, "pinned_share": 0.0}
    runtime.reset_plan_upload_stats()
    assert plan_upload_stats()["pinned_share"] is None


@pytest.mark.cuda
@pytest.mark.parametrize("chunk_bytes", [4096, runtime.STAGING_CHUNK_BYTES])
def test_pinned_upload_on_the_card(chunk_bytes):
    """On a card: the staged upload equals the host-padded one for q3 and
    q97 (a chunk smaller than each column, and the default), every byte
    crosses through the pinned ring, and the caller's arrays are unchanged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned ring stages uploads to a card only")
    for plan, tables in (_q3(1200), _q97(1500, 700)):
        before = {t: {f: v.copy() for f, v in fs.items()} for t, fs in tables.items()}
        for dp in (1, 2):
            for d in range(dp):
                compiled = _compiled(plan, dp, d, device="cuda")
                runtime.reset_plan_upload_stats()
                got = upload_inputs(compiled, tables, chunk_bytes=chunk_bytes)
                stats = plan_upload_stats()
                _assert_same(got, _oracle(compiled, tables))
                assert stats["pinned_share"] == 1.0 and stats["unpinned_bytes"] == 0
        for t, fs in tables.items():
            for f, v in fs.items():
                np.testing.assert_array_equal(v, before[t][f])
        torch.cuda.synchronize()
