"""The port's out-of-core NDS path (``spark_rapids_jni_tpu_torch/models/
streaming.py``, ``models/nds_harness.py``) against the JAX package's, on the
CPU, and the card's default budget (C.3).

- The chunk streams of ``generate_q97_chunks`` and ``generate_q5_chunks``
  equal the JAX package's chunk for chunk; ``bucket_of_pairs`` equals it.
- Streamed q97 and q5 on a (1, 1) mesh over a one-rank gloo group, at a
  small scale factor with 4 buckets: the totals, the stats (rows, largest
  bucket, capacity, host peak) and every bucket's rows and result equal the
  JAX package's run on the same chunks (one run of each query per file:
  the JAX side compiles on XLA:CPU), and the answers equal
  ``q97_host_oracle`` and ``q5_local``.  The sort-based per-bucket oracle
  equals ``q97_host_oracle``.
- Two bucket owners in process sum to the global answer; two tenants on
  one host budget; an oversized bucket split on disk; ``split_bucket``'s
  refinement (the JAX package's fast streaming tests, on the port).
- The harness ``main`` streamed and in memory at a small scale factor: q97
  counts equal ``q97_host_oracle`` of the JAX package over its own
  generators, and the streamed q5 rows the JAX streamed run's; a launch of
  more than one rank is refused.
"""

import json
import os
import tempfile
import threading

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from spark_rapids_jni_tpu.mem import BudgetedResource as JaxBudget
from spark_rapids_jni_tpu.mem import MemoryGovernor as JaxGovernor
from spark_rapids_jni_tpu.models import q5 as jax_q5_mod
from spark_rapids_jni_tpu.models import q97 as jax_q97_mod
from spark_rapids_jni_tpu.models import streaming as jst
from spark_rapids_jni_tpu.models.q97 import q97_host_oracle as jax_q97_host_oracle
from spark_rapids_jni_tpu.models.tpcds import generate_q97_tables as jax_generate_q97_tables
from spark_rapids_jni_tpu.parallel.mesh import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu_torch import config, mem
from spark_rapids_jni_tpu_torch.columnar import INT32, Column
from spark_rapids_jni_tpu_torch.mem import BudgetedResource, MemoryGovernor, governed
from spark_rapids_jni_tpu_torch.models import nds_harness
from spark_rapids_jni_tpu_torch.models import q5 as q5_mod
from spark_rapids_jni_tpu_torch.models import q97 as q97_mod
from spark_rapids_jni_tpu_torch.models import streaming as st
from spark_rapids_jni_tpu_torch.models.q97 import q97_host_oracle
from spark_rapids_jni_tpu_torch.models.tpcds import CHANNELS, ChannelTables, Q5Data, q5_dims
from spark_rapids_jni_tpu_torch.parallel import make_mesh

SF, SEED, CHUNK, BUCKETS = 0.01, 42, 2000, 4  # 28,000 q97 rows a side; 1,402 q5 rows


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) CPU mesh over a one-rank gloo group, taken down after the
    file (another file in this process may need no group)."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            yield make_mesh((1, 1), device="cpu")
        finally:
            dist.destroy_process_group()


def _recording(monkeypatch, module, name, log, key):
    """Wrap ``module.name`` so that each call appends ``key(args, result)``
    to ``log``."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        out = fn(*args, **kw)
        log.append(key(args, out))
        return out

    monkeypatch.setattr(module, name, wrapped)


def _q97_bucket(args, out):
    """(store rows, catalog rows, counts) of one bucket's run."""
    _mesh, store, catalog = args[:3]
    return (len(store[0]), len(catalog[0]),
            (int(out.store_only), int(out.catalog_only), int(out.both)))


def _q5_bucket(args, per):
    """Every channel's partial vectors of one bucket's run, as lists."""
    return {name: [np.asarray(v, np.int64).tolist() for v in per[name]] for name in CHANNELS}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's streamed q97 and q5 on one CPU device at (SF, SEED,
    CHUNK, BUCKETS), verified, with every bucket's rows and result."""
    mp = pytest.MonkeyPatch()
    q97_log, q5_log = [], []
    _recording(mp, jax_q97_mod, "run_distributed_q97", q97_log, _q97_bucket)
    _recording(mp, jax_q5_mod, "run_q5_partials", q5_log, _q5_bucket)
    mesh1 = jax_make_mesh((1, 1), devices=jax.devices()[:1])
    gov = JaxGovernor(watchdog_period_s=0.02)
    tmp = tmp_path_factory.mktemp("jax_streams")
    try:
        q97 = jst.run_streaming_q97(
            mesh1, jst.generate_q97_chunks(SF, SEED, CHUNK), tmpdir=str(tmp / "q97"),
            n_buckets=BUCKETS, budget=JaxBudget(gov, 1 << 30),
            host_budget=JaxBudget(gov, 1 << 30, is_cpu=True), task_id=5, verify=True)
        q5 = jst.run_streaming_q5(
            mesh1, jst.generate_q5_chunks(SF, SEED, CHUNK), tmpdir=str(tmp / "q5"),
            n_buckets=BUCKETS, budget=JaxBudget(gov, 1 << 30),
            host_budget=JaxBudget(gov, 1 << 30, is_cpu=True), task_id=6, verify=True)
    finally:
        gov.close()
        mp.undo()
    assert q97[1] is True and q5[1] is True
    return {"q97": q97, "q5": q5, "q97_buckets": q97_log, "q5_buckets": q5_log}


def _budgets(watchdog=0.02, host=1 << 30):
    gov = MemoryGovernor(watchdog_period_s=watchdog)
    return gov, BudgetedResource(gov, 1 << 30), BudgetedResource(gov, host, is_cpu=True)


def _q97_sides(chunks):
    def side(name):
        return (np.concatenate([c for s, c, _ in chunks if s == name]),
                np.concatenate([i for s, _, i in chunks if s == name]))

    return side("store"), side("catalog")


# --- chunk streams, bucketing, the per-bucket oracle --------------------------------------


@pytest.mark.parametrize("sf,seed,chunk", [(0.003, 3, 1500), (0.002, 42, 7), (0.01, 11, 100_000)])
def test_q97_chunk_stream_equals_jax(sf, seed, chunk):
    got = list(st.generate_q97_chunks(sf, seed, chunk))
    want = list(jst.generate_q97_chunks(sf, seed, chunk))
    assert len(got) == len(want)
    for (gs, gc, gi), (ws, wc, wi) in zip(got, want):
        assert gs == ws and gc.dtype == wc.dtype == np.int32 and len(gc) <= chunk
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("sf,seed,chunk", [(0.05, 6, 300), (0.5, 8, 3000)])
def test_q5_chunk_stream_equals_jax(sf, seed, chunk):
    got = list(st.generate_q5_chunks(sf, seed, chunk))
    want = list(jst.generate_q5_chunks(sf, seed, chunk))
    assert len(got) == len(want)
    for (gc, gk, ga), (wc, wk, wa) in zip(got, want):
        assert (gc, gk) == (wc, wk) and list(ga) == list(wa)
        for field in ga:
            assert ga[field].dtype == wa[field].dtype
            np.testing.assert_array_equal(ga[field], wa[field])


def test_bucket_of_pairs_equals_jax_and_spreads():
    rng = np.random.RandomState(0)
    cust = rng.randint(1, 5000, 20_000).astype(np.int32)
    item = rng.randint(1, 18_000, 20_000).astype(np.int32)
    for n in (2, 16, 128, 1000):
        got = st.bucket_of_pairs(cust, item, n)
        np.testing.assert_array_equal(got, jst.bucket_of_pairs(cust, item, n))
        assert got.dtype == np.int64 and got.min() >= 0 and got.max() < n
    counts = np.bincount(st.bucket_of_pairs(cust, item, 16), minlength=16)
    assert counts.max() < 2 * (len(cust) / 16)  # dense keys still spread


@pytest.mark.parametrize("seed,n_store,n_cat,span", [
    (1, 0, 0, 10), (2, 0, 50, 10), (3, 50, 0, 10), (4, 3000, 2500, 40), (5, 20_000, 20_000, 3000)])
def test_sorted_distinct_counts_equal_host_oracle(seed, n_store, n_cat, span):
    """The per-bucket oracle of the streamed runs: equal to the host-set
    oracle, duplicates and negative keys included."""
    rng = np.random.RandomState(seed)

    def side(n):
        return (rng.randint(-span, span, n).astype(np.int32),
                rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32) % span)

    store, catalog = side(n_store), side(n_cat)
    assert st._distinct_counts(store, catalog) == q97_host_oracle(store, catalog)


# --- streamed q97 and q5 against the JAX package ------------------------------------------


def test_streamed_q97_equals_jax_and_oracle(mesh, jax_runs, tmp_path, monkeypatch):
    log = []
    _recording(monkeypatch, q97_mod, "run_distributed_q97", log, _q97_bucket)
    chunks = list(st.generate_q97_chunks(SF, SEED, CHUNK))
    gov, budget, host = _budgets()
    try:
        st.reset_timers()
        counts, verified, stats = st.run_streaming_q97(
            mesh, iter(chunks), tmpdir=str(tmp_path / "q97"), n_buckets=BUCKETS,
            budget=budget, host_budget=host, task_id=5, verify=True)
    finally:
        gov.close()
    want_counts, _, want_stats = jax_runs["q97"]
    assert verified is True
    assert counts == tuple(want_counts) == q97_host_oracle(*_q97_sides(chunks))
    assert stats == want_stats
    assert log == jax_runs["q97_buckets"] and len(log) == BUCKETS
    assert host.used == 0 and budget.used == 0
    assert os.listdir(tmp_path / "q97") == []  # every spill file removed
    phases = st.PHASES.snapshot()
    assert phases["bucket_run"] > 0 and st.device_seconds() == 0.0  # no card here
    assert st._spill.PHASES.snapshot()["route_encode"] > 0


def _q5_data(chunks):
    """The streamed q5 chunks concatenated into one Q5Data."""
    dims = q5_dims()
    acc = {}
    for channel, kind, ch in chunks:
        acc.setdefault((channel, kind), []).append(ch)

    def cat(channel, kind, field):
        return np.concatenate([c[field] for c in acc[(channel, kind)]])

    channels = {}
    for name in CHANNELS:
        channels[name] = ChannelTables(
            *(cat(name, kind, f) for kind in ("sales", "ret")
              for f in ("sk", "sk_valid", "date", "date_valid", "m1", "m2")),
            dim_sk=dims.dim_sk[name], dim_id=dims.dim_id[name])
    return Q5Data(channels, dims.date_sk, dims.date_days, dims.sales_date_lo,
                  dims.sales_date_hi)


def test_streamed_q5_equals_jax_and_q5_local(mesh, jax_runs, tmp_path, monkeypatch):
    log = []
    _recording(monkeypatch, q5_mod, "run_q5_partials", log, _q5_bucket)
    chunks = list(st.generate_q5_chunks(SF, SEED, CHUNK))
    gov, budget, host = _budgets()
    try:
        rows, verified, stats = st.run_streaming_q5(
            mesh, iter(chunks), tmpdir=str(tmp_path / "q5"), n_buckets=BUCKETS,
            budget=budget, host_budget=host, task_id=6, verify=True)
    finally:
        gov.close()
    want_rows, _, want_stats = jax_runs["q5"]
    assert verified is True
    assert [tuple(r) for r in rows] == [tuple(r) for r in want_rows]
    assert rows == q5_mod.q5_local(_q5_data(chunks), device="cpu")
    assert stats == want_stats
    assert log == jax_runs["q5_buckets"] and len(log) == BUCKETS
    assert host.used == 0


def test_two_bucket_owners_sum_to_the_global_answer(mesh, jax_runs, tmp_path):
    gov, budget, host = _budgets()
    parts = []
    try:
        for owner in ((0, 2), (1, 2)):
            counts, verified, stats = st.run_streaming_q97(
                mesh, st.generate_q97_chunks(SF, SEED, CHUNK),
                tmpdir=str(tmp_path / f"own{owner[0]}"), n_buckets=BUCKETS, budget=budget,
                host_budget=host, task_id=40 + owner[0], verify=True, bucket_owner=owner)
            assert verified is True
            parts.append(counts)
    finally:
        gov.close()
    assert tuple(map(sum, zip(*parts))) == tuple(jax_runs["q97"][0])
    with pytest.raises(ValueError, match="bucket_owner"):
        st.run_streaming_q97(mesh, iter([]), tmpdir=str(tmp_path / "bad"), budget=budget,
                             bucket_owner=(2, 2))


# --- the JAX package's fast streaming tests, on the port ----------------------------------


def test_two_tenants_contend_on_host_budget(mesh, tmp_path):
    """Two streamed q97 tenants share ONE tight host budget (CPU arbiter
    path): pressure resolves by blocking and waking -- both finish with the
    right counts, nothing leaks, no hang, no split.  32 KB fits one
    tenant's ~22 KB bucket but not two."""
    gov, dev_budget, host_budget = _budgets(host=32 << 10)
    results = {}

    def tenant(tid):
        chunks = list(st.generate_q97_chunks(sf=0.001, seed=tid, chunk_rows=700))
        counts, _v, stats = st.run_streaming_q97(
            mesh, iter(chunks), tmpdir=str(tmp_path / f"t{tid}"), n_buckets=4,
            budget=dev_budget, host_budget=host_budget, task_id=tid)
        results[tid] = (counts, q97_host_oracle(*_q97_sides(chunks)), stats)

    try:
        threads = [threading.Thread(target=tenant, args=(t,)) for t in (21, 22)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert all(not t.is_alive() for t in threads), "tenant hung"
    finally:
        gov.close()
    assert set(results) == {21, 22}
    for tid, (counts, want, stats) in results.items():
        assert counts == want, f"tenant {tid}"
        assert stats["host_peak_reserved"] > 0
        assert stats["bucket_splits"] == 0
    assert host_budget.used == 0


def test_oversized_bucket_splits_on_disk(mesh, tmp_path):
    """2 buckets of ~90 KB against a 24 KB host budget: two recursive split
    levels on disk, and still the exact answer."""
    chunks = list(st.generate_q97_chunks(sf=0.002, seed=9, chunk_rows=2000))
    gov, dev_budget, host_budget = _budgets(host=24 << 10)
    try:
        counts, verified, stats = st.run_streaming_q97(
            mesh, iter(chunks), tmpdir=str(tmp_path / "shuf"), n_buckets=2,
            budget=dev_budget, host_budget=host_budget, task_id=31, verify=True)
    finally:
        gov.close()
    assert counts == q97_host_oracle(*_q97_sides(chunks))
    assert verified is True
    assert stats["bucket_splits"] >= 2, stats
    assert host_budget.used == 0
    assert host_budget.peak <= 24 << 10


def _pair_cols(cust, item):
    return [Column(torch.from_numpy(a), None, INT32) for a in (cust, item)]


def test_split_bucket_disk_refinement(tmp_path):
    """split_bucket on the q97 pair shuffle: rows re-partition consistently,
    nothing lost, both sides agree on placement."""
    shuffle = st.q97_spill_shuffle(str(tmp_path), 2)
    rng = np.random.RandomState(4)
    sent = {}
    for side in ("store", "catalog"):
        cust = rng.randint(1, 500, 4000).astype(np.int32)
        item = rng.randint(1, 300, 4000).astype(np.int32)
        shuffle.append(side, _pair_cols(cust, item))
        sent[side] = set(zip(cust.tolist(), item.tolist()))
    b0_rows = shuffle.rows[("store", 0)]
    assert shuffle.split_bucket(0, chunk_rows=512) == (0, 2)
    assert shuffle.rows[("store", 0)] + shuffle.rows[("store", 2)] == b0_rows
    for side in ("store", "catalog"):
        got = set()
        for b in (0, 1, 2):
            cols = shuffle.read(side, b, device="cpu")
            cust_b, item_b = cols[0].data.numpy(), cols[1].data.numpy()
            if b in (0, 2):  # refined placement: hash % 4 is the bucket id
                assert np.all(st.bucket_of_pairs(cust_b, item_b, 4) == b)
            got |= set(zip(cust_b.tolist(), item_b.tolist()))
        assert got == sent[side], "split must move rows, never lose them"
    shuffle.close()


# --- the harness ---------------------------------------------------------------------------


def _harness(capsys, monkeypatch, *extra):
    """Run the port's harness at (SF, SEED) on the CPU; returns its JSON line
    and the streamed q5 rows (None in memory)."""
    rows = []
    run_q5 = st.run_streaming_q5

    def keep_rows(*a, **kw):
        out = run_q5(*a, **kw)
        rows.append(out[0])
        return out

    monkeypatch.setattr(st, "run_streaming_q5", keep_rows)
    rc = nds_harness.main(["--sf", str(SF), "--seed", str(SEED), "--verify", *extra],
                          device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert all(out["queries"][q]["verified"] is True for q in ("q5", "q97", "q3"))
    assert set(out) == {"sf", "ndev", "queries", "total_wall_s"} and out["ndev"] == 1
    return out, (rows[0] if rows else None)


def test_harness_streamed_equals_jax(mesh, jax_runs, capsys, monkeypatch):
    out, q5_rows = _harness(capsys, monkeypatch, "--stream-chunk-rows", str(CHUNK),
                            "--buckets", str(BUCKETS))
    q97, q5 = out["queries"]["q97"], out["queries"]["q5"]
    store, catalog = _q97_sides(list(jst.generate_q97_chunks(SF, SEED, CHUNK)))
    assert tuple(q97["counts"]) == jax_q97_host_oracle(store, catalog)
    assert q97["fact_rows"] == q97["streamed"]["rows_in"] == 2 * int(2_800_000 * SF)
    assert q97["streamed"]["bucket_splits"] == 0 and q97["streamed"]["host_peak_reserved"] > 0
    assert [tuple(r) for r in q5_rows] == [tuple(r) for r in jax_runs["q5"][0]]
    assert q5["result_rows"] == len(q5_rows) and q5["streamed"] == jax_runs["q5"][2]
    for q in ("q5", "q97", "q3"):
        assert out["queries"][q]["peak_reserved_bytes"] > 0


def test_harness_in_memory_equals_jax(mesh, capsys, monkeypatch):
    out, _ = _harness(capsys, monkeypatch)
    assert tuple(out["queries"]["q97"]["counts"]) == \
        jax_q97_host_oracle(*jax_generate_q97_tables(SF, SEED))
    assert "streamed" not in out["queries"]["q97"]


def test_harness_refuses_more_than_one_rank(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="A.16"):
        nds_harness.main(["--sf", "0.001"], device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    with pytest.raises(SystemExit):
        nds_harness.main(["--sf", "0.001", "--ndev", "2"], device="cpu")


# --- C.3: the card's default budget leaves headroom ----------------------------------------


@pytest.mark.parametrize("total", [80 << 30, 94 << 30, 12345 << 20])
def test_default_budget_on_a_card_is_its_total_over_the_peak_factor(monkeypatch, total):
    assert governed.PEAK_OVER_RESERVATION >= 1.25
    governed._reset_default_budget_for_tests()
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (1 << 30, total))
        limit = mem.default_device_budget().limit
        assert limit == int(total / governed.PEAK_OVER_RESERVATION)
        assert limit * governed.PEAK_OVER_RESERVATION <= total
        governed._reset_default_budget_for_tests()
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with config.override(device_budget_bytes=777 << 20):
            assert mem.default_device_budget().limit == 777 << 20  # no card: the flag
    finally:
        MemoryGovernor.shutdown()
        governed._reset_default_budget_for_tests()
