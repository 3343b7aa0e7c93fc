"""Each query's plain reference against the port's entry point, and against
a brute force, at tiny sizes on the CPU; and the control reads wrong."""

import numpy as np
import pytest
import torch.distributed as dist

from nds_bench.core import harness
from nds_bench.tests.nds_bench_tiny import tiny_cell


@pytest.fixture
def q97_pool():
    cell = tiny_cell("q97.tasks")
    return cell, cell.query.make_pool(cell.config, cell.traffic, 2**32 + 3, "cpu")


def test_q97_reference_is_set_semantics(q97_pool):
    cell, pool = q97_pool
    for t in pool.tasks[:5]:
        s = set(zip(t["s_cust"].tolist(), t["s_item"].tolist()))
        c = set(zip(t["c_cust"].tolist(), t["c_item"].tolist()))
        want = (len(s - c), len(c - s), len(s & c))
        assert cell.reference.answer(t, cell.config, "cpu") == want
        assert want[2] > 0  # the tiny domains make the sides overlap


def test_q97_reference_matches_the_port(q97_pool):
    from spark_rapids_jni_tpu_torch.mem.governor import MemoryGovernor

    cell, pool = q97_pool
    harness.init_group("cpu")
    meshes = harness.thread_meshes(2, "cpu")
    try:
        runner = cell.query.open_runner(cell.config, cell.traffic, pool, meshes, "cpu",
                                        MemoryGovernor.instance())
        for i, t in enumerate(pool.tasks[:4]):
            assert runner.run(i % 2, t, 900 + i) == \
                cell.reference.answer(t, cell.config, "cpu")
    finally:
        dist.destroy_process_group()


def test_q3_reference_matches_the_port():
    from spark_rapids_jni_tpu_torch.mem.governor import MemoryGovernor

    cell = tiny_cell("q3.tasks")
    pool = cell.query.make_pool(cell.config, cell.traffic, 5, "cpu")
    runner = cell.query.open_runner(cell.config, cell.traffic, pool, [None], "cpu",
                                    MemoryGovernor.instance())
    for i, t in enumerate(pool.tasks[:3]):
        got = runner.run(0, t, 950 + i)
        want = cell.reference.answer(t, pool.shared, cell.config)
        assert got == want and len(want) > 10


def test_q3_reference_brute_force():
    cell = tiny_cell("q3.tasks")
    pool = cell.query.make_pool(cell.config, cell.traffic, 6, "cpu")
    cfg, sh, t = cell.config, pool.shared, pool.tasks[0]
    sums = {}
    for i in range(t["rows"]):
        if not (t["ss_item_v"][i] and t["ss_date_v"][i]):
            continue
        item, day = int(t["ss_item"][i]) - 1, int(t["ss_date"][i]) - cfg["d_date_sk_first"]
        if sh["item_manufact"][item] != cfg["manufact_id"] or sh["date_moy"][day] != cfg["moy"]:
            continue
        key = (int(sh["date_year"][day]), int(sh["item_brand"][item]))
        sums[key] = sums.get(key, 0) + int(t["price"][i])
    want = sorted(((y, b, f"brand #{b}", s) for (y, b), s in sums.items()),
                  key=lambda r: (r[0], -r[3], r[1]))
    assert cell.reference.answer(t, sh, cfg) == tuple(want)


def test_controls_read_wrong_at_full_domains():
    """The controls fail on every task at the configurations' own domains
    (a q97 task of 300,000 rows over 30,000,000 x 360,000 pairs collides in
    32 bits; q3's nulls carry keys that pass the filter)."""
    for workload, rows in (("q97.tasks", None), ("q3.tasks", 1 << 20)):
        from nds_bench.core import registry

        cell = registry.load_cell(workload)
        if rows is None:
            per = cell.config["sales_years"] * cell.config["shuffle_partitions"]
            cell.config.update(store_sales_rows=200_000 * per, catalog_sales_rows=100_000 * per)
            cell.traffic["pool_tasks"] = 3
        else:
            cell.traffic.update(task_rows=rows, pool_tasks=2)
        pool = cell.query.make_pool(cell.config, cell.traffic, 2**31 + 99, "cpu")
        want = cell.reference.answers(pool.tasks, pool.shared, cell.config, "cpu")
        got = cell.reference.answers(pool.tasks, pool.shared, cell.config, "cpu", control=True)
        assert all(a != b for a, b in zip(want, got))
        assert np.all([len(a) > 0 for a in want])
