"""A cell over several ranks is new files too: a traffic mix with
``"ranks"`` runs the cell as that many processes, rank 0 starting the
others, every task's collective finding every rank, and rank 0 alone
printing the result over all ranks' tasks.  On the CPU, two gloo ranks."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from nds_bench.core import harness, registry

ROOT = registry.ROOT

_QUERY = '''
"""A throwaway query across ranks: each rank holds its share of a task's
values, and the answer is the sum over every rank's share (an all-reduce
over the thread's data axis)."""
import dataclasses
import os
import torch
import torch.distributed as dist

NEEDS_MESH = True
HASH_KERNEL = None


@dataclasses.dataclass
class Pool:
    tasks: list
    shared: dict


def make_pool(config, traffic, seed, device, rank=0, world=1):
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    v = torch.randint(0, 1000, (world, traffic["pool_tasks"], traffic["task_rows"]),
                      generator=g, device=device).cpu().numpy()
    return Pool([{"v": v[rank, i], "index": i, "rows": v.shape[2]}
                 for i in range(v.shape[1])], {"all": v})


def least_bytes(task, config):
    return task["rows"] * 8


class Runner:
    def __init__(self, meshes):
        self.meshes = meshes
        self.off = int(os.environ.get("RANKS_TEST_FAULT", "0")) * dist.get_rank()

    def run(self, thread, task, task_id):
        total = torch.tensor([int(task["v"].sum())], dtype=torch.int64)
        dist.all_reduce(total, group=self.meshes[thread].get_group("data"))
        return int(total) + self.off

    def close(self):
        self.meshes = None


def open_runner(config, traffic, pool, meshes, device, gov):
    return Runner(meshes)
'''

_REFERENCE = '''
def answers(tasks, shared, config, device, control=False):
    return [int(shared["all"][:, t["index"]].sum()) for t in tasks]
'''

_RANK_MAIN = '''
import json, os, sys, time
sys.path.insert(0, {root!r})
from pathlib import Path
from nds_bench.core import harness, registry
from nds_bench.tests.nds_bench_tiny import CPU_RATES
bench = json.loads(Path({bench!r}).read_text())
cell = registry.load_cell("tiny.ranks", bench, base=Path({base!r}))
rank = int(os.environ.get(harness.RANK_ENV, "0"))
children = harness.launch_ranks([sys.executable, __file__], 2) if rank == 0 else []
res = harness.run_cell(cell, 2**31 + 11, 1.0, {trace}, time.monotonic(), device="cpu",
                       rates=CPU_RATES, rank=rank, world=2)
codes = harness._stop(children, 60.0)
if rank == 0:
    print(json.dumps({{"result": res, "codes": codes}}))
'''


def _run(tmp_path, trace: bool, fault: bool) -> dict:
    base = tmp_path / "nds_bench"
    shutil.copytree(ROOT / "nds_bench", base, ignore=shutil.ignore_patterns("__pycache__"))
    (base / "queries" / "tinyranks.py").write_text(_QUERY)
    (base / "reference" / "tinyranks.py").write_text(_REFERENCE)
    (base / "configs" / "tiny_ranks.json").write_text(json.dumps(
        {"name": "tiny_ranks", "query": "tinyranks"}))
    (base / "traffic" / "tiny_ranks_2x2.json").write_text(json.dumps(
        {"threads": 2, "ranks": 2, "pool_tasks": 3, "task_rows": 100}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_ranks", "source": "a test", "reduced": [],
                             "file": "nds_bench/configs/tiny_ranks.json", "why": "a test"})
    bench["workloads"].append({"name": "tiny.ranks", "config": "tiny_ranks",
                               "traffic": "tiny_ranks_2x2", "chips": 2, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("rows_per_s", "task_p95_ms", "plan_roofline", "device_idle_pct"):
            m["workloads"] = m.get("workloads", []) + ["tiny.ranks"]
    (tmp_path / "bench.json").write_text(json.dumps(bench))
    script = tmp_path / "rank_main.py"
    script.write_text(_RANK_MAIN.format(root=str(ROOT), bench=str(tmp_path / "bench.json"),
                                        base=str(base), trace=trace))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", harness.RANK_ENV)}
    if fault:
        env["RANKS_TEST_FAULT"] = "1"
    out = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True])
def test_two_ranks_agree_and_rank0_reports_all(tmp_path, trace):
    got = _run(tmp_path, trace, fault=False)
    res = got["result"]
    assert got["codes"] == [0]
    assert res["correct"] is True, res
    assert res["device"]["count"] == 2
    # both ranks ran the same tasks: every task is counted once a rank
    assert res["attempted"] % 2 == 0 and res["attempted"] >= 4
    done = res["checks"]["tasks_answered_in_window"]["value"]
    assert res["metrics"] and done >= 2
    if trace:
        assert "device_idle_pct" in res["metrics"]
        assert res["device"]["window_s"] > 0
    else:
        assert res["metrics"]["rows_per_s"]["value"] == pytest.approx(done * 100 / 1.0)


def test_a_wrong_rank_makes_the_run_not_correct(tmp_path):
    res = _run(tmp_path, False, fault=True)["result"]
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0


def test_launch_ranks_gives_each_rank_its_environment(tmp_path, monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(os, "environ", dict(os.environ))
    code = ("import os, sys; sys.exit(0 if (os.environ['WORLD_SIZE'], os.environ['RANK']) == "
            "('3', os.environ['LOCAL_RANK']) and os.environ['RANK'] in ('1', '2') and "
            "os.environ['NDS_BENCH_RANK'] == os.environ['RANK'] else 7)")
    children = harness.launch_ranks([sys.executable, "-c", code], 3)
    assert os.environ["RANK"] == "0" and os.environ["WORLD_SIZE"] == "3"
    assert harness._stop(children, 60.0) == [0, 0]
