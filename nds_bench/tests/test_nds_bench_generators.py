"""The generators: the same seed gives the same pool, and every domain is the
configuration's (the TPC-DS specification's)."""

import numpy as np
import pytest

from nds_bench.core import registry
from nds_bench.tests.nds_bench_tiny import tiny_cell


def _pool(workload, seed):
    cell = tiny_cell(workload)
    return cell, cell.query.make_pool(cell.config, cell.traffic, seed, "cpu")


@pytest.mark.parametrize("workload", ["q97.tasks", "q97.pressure", "q3.tasks"])
def test_same_seed_same_pool(workload):
    seed = 2**33 + 5  # wider than 32 bits: seeds may exceed a signed int
    _, a = _pool(workload, seed)
    _, b = _pool(workload, seed)
    _, c = _pool(workload, seed + 1)
    assert len(a.tasks) == len(b.tasks) == len(c.tasks)
    for ta, tb, tc in zip(a.tasks, b.tasks, c.tasks):
        assert ta["rows"] == tb["rows"] == tc["rows"]
        for k in ta:
            if k != "rows":
                np.testing.assert_array_equal(ta[k], tb[k])
    assert any(not np.array_equal(ta[k], tc[k])
               for ta, tc in zip(a.tasks, c.tasks) for k in ta if k != "rows")


def test_q97_task_sizes_are_the_specifications():
    cell = registry.load_cell("q97.tasks")
    q, cfg = cell.query, cell.config
    assert q.task_rows(cfg) == (8_639_936, 4_320_079)
    assert sum(q.task_rows(cfg)) == 12_960_015
    assert sum(q.task_rows(cfg, 3.0)) == 38_880_045
    assert cfg["shuffle_partitions"] // cfg["deployment_executors"] == cell.traffic["pool_tasks"]
    pressure = registry.load_cell("q97.pressure")
    scales = q.pool_scales(pressure.traffic)
    assert scales.count(3.0) == 6 and scales.count(1.0) == 18
    assert all(s == 3.0 for i, s in enumerate(scales) if i % 4 == 3)


def test_q97_keys_in_domain():
    cell, pool = _pool("q97.tasks", 11)
    cfg = cell.config
    parts = cfg["shuffle_partitions"]
    for i, t in enumerate(pool.tasks):
        assert t["rows"] == len(t["s_cust"]) + len(t["c_cust"])
        for k, hi in (("s_cust", cfg["customers"]), ("c_cust", cfg["customers"]),
                      ("s_item", cfg["items"]), ("c_item", cfg["items"])):
            assert t[k].dtype == np.int32
            assert t[k].min() >= 1 and t[k].max() <= hi
        for c, it in ((t["s_cust"], t["s_item"]), (t["c_cust"], t["c_item"])):
            # the task's shuffle partition's share of the pairs
            assert np.all((c.astype(np.int64) - 1 + it - 1) % parts == i % parts)
            # every item residue of the partition is drawn
            assert len(np.unique(it % parts)) == parts


def test_q97_partition_share_density():
    """A task holds 1/partitions of the pairs, so its sides overlap as a
    hash partition's do: about store x catalog / (customers x items /
    partitions) pairs in both."""
    cell = registry.load_cell("q97.tasks")
    cfg, tr = cell.config, cell.traffic
    per = cfg["sales_years"] * cfg["shuffle_partitions"]
    cfg.update(store_sales_rows=40_000 * per, catalog_sales_rows=20_000 * per,
               customers=200_000, items=1_000)
    tr["pool_tasks"] = 3
    pool = cell.query.make_pool(cfg, tr, 2**32 + 17, "cpu")
    expect = 40_000 * 20_000 / (200_000 * 1_000 / cfg["shuffle_partitions"])  # 800
    for t in pool.tasks:
        both = cell.reference.answer(t, cfg, "cpu")[2]
        assert 0.8 * expect < both < 1.2 * expect


def test_q3_task_is_one_gpu_batch():
    cell = registry.load_cell("q3.tasks")
    cfg = cell.config
    assert cfg["batch_size_bytes"] == 2**30  # spark.rapids.sql.batchSizeBytes's default
    assert cfg["batch_row_bytes"] == 3 * 4 + 3 / 8  # three 32-bit columns and their validity
    assert cell.traffic["task_rows"] == int(cfg["batch_size_bytes"] // cfg["batch_row_bytes"])


def test_q3_domains():
    cell, pool = _pool("q3.tasks", 12)
    cfg, sh = cell.config, pool.shared
    assert len(sh["date_sk"]) == 73_049 and sh["date_sk"][0] == 2_415_022
    assert sh["date_year"].min() == 1900 and sh["date_year"].max() == 2100
    assert set(np.unique(sh["date_moy"])) == set(range(1, 13))
    lo, hi = cell.query.sales_date_sks(cfg)
    assert (lo, hi) == (2_450_816, 2_452_642)  # 1998-01-02 .. 2003-01-02
    assert sh["date_year"][lo - 2_415_022] == 1998
    assert sh["item_brand"].min() >= 1 and sh["item_brand"].max() <= cfg["brands"]
    assert len(sh["item_manufact"]) == cfg["items"]
    for t in pool.tasks:
        assert t["rows"] == cell.traffic["task_rows"] == len(t["price"])
        assert t["ss_item"].min() >= 1 and t["ss_item"].max() <= cfg["items"]
        assert t["ss_date"].min() >= lo and t["ss_date"].max() <= hi
        assert t["price"].dtype == np.int64
        assert t["price"].min() >= 0 and t["price"].max() <= 9_999_999  # DECIMAL(7,2)
        for v in ("ss_item_v", "ss_date_v"):
            assert 0.9 < t[v].mean() < 0.99  # 4% nulls
