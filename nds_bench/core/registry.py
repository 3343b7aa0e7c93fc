"""Finds everything a cell needs by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  The configuration's file
(``configs/<config>.json``) names its query; the query's code is
``queries/<query>.py`` and its plain reference ``reference/<query>.py``; the
traffic mix is the data file ``traffic/<traffic>.json``; each metric is read
by ``metrics/<metric>.py``.  Adding any of these is adding files."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    kind: str  # "end_to_end" or "per_layer"
    reader: ModuleType


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    query: ModuleType
    reference: ModuleType
    metrics: List[Metric]  # the cell's metrics, end-to-end first

    def end_to_end(self) -> List[Metric]:
        return [m for m in self.metrics if m.kind == "end_to_end"]

    def per_layer(self) -> List[Metric]:
        return [m for m in self.metrics if m.kind == "per_layer"]


def load_module(path: Path, name: str) -> ModuleType:
    """Import the file ``path`` as module ``name`` (once per process)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def reader(name: str, base: Path = BENCH_DIR) -> ModuleType:
    """The reader of metric ``name``: ``metrics/<name>.py``."""
    return load_module(base / "metrics" / f"{name}.py",
                       f"nds_bench_metric_{name.replace('.', '_')}")


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str, reported: set) -> bool:
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def load_cell(workload: str, bench: Dict = None, base: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``bench`` (``BENCHMARK.json`` at the root when
    None), with its files found under ``base``."""
    if bench is None:
        bench = _read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _read_json(base.parent / cfg_entry["file"]) if "file" in cfg_entry \
        else _read_json(base / "configs" / f"{entry['config']}.json")
    traffic = _read_json(base / "traffic" / f"{entry['traffic']}.json")
    query = config["query"]
    q = load_module(base / "queries" / f"{query}.py", f"nds_bench_query_{query}")
    ref = load_module(base / "reference" / f"{query}.py", f"nds_bench_reference_{query}")
    metrics: List[Metric] = []
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    for kind, group in (("end_to_end", e2e), ("per_layer", per_layer)):
        for m in group:
            metrics.append(Metric(m["name"], m["unit"], kind, reader(m["name"], base)))
    return Cell(workload, int(entry["chips"]), config, traffic, q, ref, metrics)
