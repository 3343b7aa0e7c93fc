"""The check must see a broken timed path: a run on the CPU, with the
harness's look for a card skipped and the port broken underneath, comes out
``correct: false`` for each fault these cells can have, and ``true`` when
nothing is broken."""

import pytest
import torch

from nds_bench.tests.nds_bench_tiny import run_tiny, tiny_cell

WORKLOADS = ["q97.tasks", "q3.tasks", "q97.pressure"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    res = run_tiny(tiny_cell(workload))
    assert res["correct"] is True
    assert res["checks"]["wrong_answers"]["value"] == 0
    assert res["attempted"] >= res["checks"]["tasks_answered_in_window"]["value"] >= 1


def test_pressure_cell_splits():
    """Under its fixed budget the pressure cell's large tasks split by key
    space and its plain ones wait; the answers stay right."""
    res = run_tiny(tiny_cell("q97.pressure"), trace=True)
    assert res["correct"] is True
    assert res["metrics"]["gov_splits"]["value"] > 0


def _half_the_batch(monkeypatch):
    """Every plan execution sees only the first half of each scan table's
    rows, the answer taken over the rest."""
    from spark_rapids_jni_tpu_torch.plans import ir, runtime

    real = runtime.execute_plan

    def halved(mesh, plan, tables, device=None):
        scans = {s.table for s in ir.scan_tables(plan)}
        cut = {t: ({k: v[:len(v) // 2] for k, v in f.items()} if t in scans else f)
               for t, f in tables.items()}
        return real(mesh, plan, cut, device=device)

    monkeypatch.setattr(runtime, "execute_plan", halved)


def _answer_altered(monkeypatch):
    """The answer is altered where the device produces it: q97's presence
    counts and q3's grouped sums each gain one."""
    from spark_rapids_jni_tpu_torch.models import q97
    from spark_rapids_jni_tpu_torch.plans import compiler

    real_runs, real_sum = q97._count_runs, compiler.segment_sum

    def runs(*a):
        so, co, b = real_runs(*a)
        return so + 1, co, b

    def seg(values, ids, n):
        out = real_sum(values, ids, n)
        return out + (torch.arange(n, device=out.device) == 0).to(out.dtype)

    monkeypatch.setattr(q97, "_count_runs", runs)
    monkeypatch.setattr(compiler, "segment_sum", seg)


def _control_in_place(monkeypatch, cell):
    """The control (the reference with a guarantee broken) answers in the
    program's place."""
    ref, cfg = cell.reference, cell.config
    real_open = cell.query.open_runner

    def open_runner(config, traffic, pool, meshes, device, gov):
        runner = real_open(config, traffic, pool, meshes, device, gov)
        runner.run = lambda thread, task, task_id: ref.answers(
            [task], pool.shared, cfg, device, control=True)[0]
        return runner

    monkeypatch.setattr(cell.query, "open_runner", open_runner)


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("fault", ["half_the_batch", "answer_altered", "control"])
def test_fault_is_not_correct(workload, fault, monkeypatch):
    cell = tiny_cell(workload)
    if fault == "half_the_batch":
        _half_the_batch(monkeypatch)
    elif fault == "answer_altered":
        _answer_altered(monkeypatch)
    else:
        if cell.config["query"] == "q97":  # 32-bit pairs collide at the full domains
            per = cell.config["sales_years"] * cell.config["shuffle_partitions"]
            cell.config.update(customers=30_000_000, items=360_000,
                               store_sales_rows=200_000 * per, catalog_sales_rows=100_000 * per)
            cell.traffic["pool_tasks"] = 4
        _control_in_place(monkeypatch, cell)
    res = run_tiny(cell)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0
