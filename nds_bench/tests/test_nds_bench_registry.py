"""The harness finds configurations, traffic mixes, queries and metrics by
their names in BENCHMARK.json, and a new cell is new files plus new entries:
no file that exists changes."""

import hashlib
import json
import shutil
from pathlib import Path

from nds_bench.core import harness, registry
from nds_bench.tests.nds_bench_tiny import run_tiny, shrink

ROOT = registry.ROOT


def test_every_cell_loads_by_name():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = registry.load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.config["name"] == w["config"]
        names = [m.name for m in cell.metrics]
        e2e = [m.name for m in cell.end_to_end()]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer(), w["name"]
        for m in cell.per_layer():
            entry = next(x for x in bench["per_layer"] if x["name"] == m.name)
            assert w["name"] in entry["workloads"]
            assert entry["moves"] in names


def test_files_named_in_benchmark_exist():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert set(c["reduced"]) <= set(cfg) and set(c["reduced"]) <= set(cfg["reduced"])
    for w in bench["workloads"]:
        assert (ROOT / "nds_bench" / "traffic" / f"{w['traffic']}.json").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (ROOT / "nds_bench" / "metrics" / f"{m['name']}.py").is_file()


_QUERY = '''
"""A throwaway query: the sum of each task's values, through the port's
segment sum."""
import dataclasses
import numpy as np
import torch

NEEDS_MESH = False
HASH_KERNEL = None


@dataclasses.dataclass
class Pool:
    tasks: list
    shared: dict


def make_pool(config, traffic, seed, device, rank=0, world=1):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    v = torch.randint(0, config["max_value"], (traffic["pool_tasks"], traffic["task_rows"]),
                      generator=g, device=device).cpu().numpy()
    return Pool([{"v": row, "rows": len(row)} for row in v], {})


def least_bytes(task, config):
    return task["rows"] * 8 + 8


class Runner:
    def __init__(self, device):
        from spark_rapids_jni_tpu_torch.plans.compiler import segment_sum
        self.segment_sum, self.device = segment_sum, device

    def run(self, thread, task, task_id):
        v = torch.from_numpy(task["v"]).to(self.device)
        return int(self.segment_sum(v, torch.zeros_like(v), 1)[0])

    def close(self):
        pass


def open_runner(config, traffic, pool, meshes, device, gov):
    return Runner(device)
'''

_REFERENCE = '''
def answers(tasks, shared, config, device, control=False):
    return [sum(int(x) for x in t["v"].tolist()) for t in tasks]
'''

_METRIC = '''
def read(run):
    return float(len(run.done))
'''


def _digests(base: Path) -> dict:
    return {p.relative_to(base): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in base.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_is_new_files_only(tmp_path):
    base = tmp_path / "nds_bench"
    shutil.copytree(ROOT / "nds_bench", base, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(base)
    (base / "queries" / "tinysum.py").write_text(_QUERY)
    (base / "reference" / "tinysum.py").write_text(_REFERENCE)
    (base / "metrics" / "tasks_done.py").write_text(_METRIC)
    (base / "configs" / "tiny_sum.json").write_text(json.dumps(
        {"name": "tiny_sum", "query": "tinysum", "max_value": 1000}))
    (base / "traffic" / "tiny_sum_2t.json").write_text(json.dumps(
        {"threads": 2, "pool_tasks": 3, "task_rows": 500}))
    # and a data-only cell: a new traffic mix for an existing query
    (base / "traffic" / "q97_one_thread.json").write_text(json.dumps(
        {"threads": 1, "pool_tasks": 2, "warmup_tasks_per_thread": 1}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_sum", "source": "a test", "reduced": [],
                             "file": "nds_bench/configs/tiny_sum.json", "why": "a test"})
    bench["workloads"] += [
        {"name": "tiny.sum", "config": "tiny_sum", "traffic": "tiny_sum_2t", "chips": 1,
         "why": "a test"},
        {"name": "q97.one", "config": "tpcds_q97_sf3000", "traffic": "q97_one_thread",
         "chips": 1, "why": "a test"}]
    for m in bench["end_to_end"]:
        if m["name"] == "rows_per_s":
            m["workloads"] += ["tiny.sum", "q97.one"]
    bench["per_layer"].append({"name": "tasks_done", "unit": "tasks", "better": "higher",
                               "source": "host_clock", "layer": "a test",
                               "moves": "rows_per_s", "workloads": ["tiny.sum", "q97.one"]})
    assert _digests(base).items() >= before.items()  # nothing that was there changed
    for workload in ("tiny.sum", "q97.one"):
        cell = shrink(registry.load_cell(workload, bench, base=base))
        res = run_tiny(cell)
        assert res["correct"] is True, res
        traced = run_tiny(cell, trace=True)
        assert traced["metrics"]["tasks_done"]["value"] >= 1
        assert set(res["metrics"]) == {"rows_per_s", "setup_s"} | (
            {"task_p95_ms"} if workload in {"q97.tasks"} else set())


def test_result_line_keys():
    cell = shrink(registry.load_cell("q3.tasks"))
    res = run_tiny(cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"rows_per_s", "task_p95_ms", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    lines = harness._check_lines(res["checks"])
    assert lines[0] == "check wrong_answers 0 <= 0"


def test_benchmark_json_keeps_the_contracts_forms():
    import re

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    cells = {w["name"] for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert name.match(w["name"]) and name.match(w["traffic"]) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in bench["end_to_end"])
    assert 1 <= bench["run_seconds"] <= 51
