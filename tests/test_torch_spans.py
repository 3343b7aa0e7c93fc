"""The port's spans on the profiler's clock (``obs/phases.py``), on the CPU.

Governed q3 and q97 run on a task thread under the capture a traced
benchmark run makes (CPU activity, input shapes, ``profile_all_threads``),
made here.  The spans ``srt.<layer>.<step>`` must appear on the task thread
with their names and nesting; the governance spans under a budget small
enough to split; each copy of a plan's inputs inside a transfer span, and
each pad fill inside a pad span; and
with no capture running, no range is opened at all while the host-clock
phase sums keep their keys and their sums.
"""

import dataclasses
import importlib
import threading
import time

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch import mem
from spark_rapids_jni_tpu_torch.models import q3, q97
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q3_data
from spark_rapids_jni_tpu_torch.obs import phases
from spark_rapids_jni_tpu_torch.parallel import one_rank_mesh
from spark_rapids_jni_tpu_torch.plans import plan_cache

TASK = "test.task"  # the range the task thread opens around its whole body
_RANGE = torch.profiler.record_function  # the tests' own, counted by none


@dataclasses.dataclass
class Span:
    name: str
    start: int  # ns, the profiler's clock
    end: int
    thread: int

    def holds(self, other: "Span") -> bool:
        return (self.thread == other.thread and self.start <= other.start
                and other.end <= self.end)


def _capture():
    """The benchmark's capture: CPU activity, input shapes, every thread."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                  record_shapes=True, experimental_config=cfg)


def _on_task_thread(fn):
    """Run ``fn`` on a thread of its own, inside the range ``test.task``;
    returns its result."""
    out, errors = [], []

    def body():
        try:
            with _RANGE(TASK):
                out.append(fn())
        except BaseException as e:  # re-raised on the caller's thread
            errors.append(e)

    t = threading.Thread(target=body, name="task-thread")
    t.start()
    t.join(120.0)
    assert not t.is_alive()
    if errors:
        raise errors[0]
    return out[0]


def _traced(fn):
    """(fn's result on a task thread under the capture, the task thread's
    spans and its ``aten::to``, ``aten::copy_`` and ``aten::fill_`` events,
    the task range)."""
    with _capture() as prof:
        result = _on_task_thread(fn)
    evs = [Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
           for e in prof.profiler.kineto_results.events()]
    task = next(e for e in evs if e.name == TASK)
    mine = [e for e in evs if task.holds(e) and e is not task
            and (e.name.startswith("srt.") or e.name in _OPS)]
    return result, mine, task


_OPS = ("aten::to", "aten::copy_", "aten::fill_")


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _q3_data():
    return generate_q3_data(sf=0.05, seed=9)


def _run_q3(data, limit):
    gov = mem.MemoryGovernor(watchdog_period_s=0.02)
    try:
        budget = mem.BudgetedResource(gov, limit)
        with mem.task_context(gov, 11):
            rows = q3.run_distributed_q3(None, data, budget=budget, task_id=11,
                                         manage_task=False, device="cpu")
            splits = gov.get_and_reset_num_split_retry(11)
        assert budget.used == 0
        return [tuple(r) for r in rows], splits
    finally:
        gov.close()


def _q97_batch():
    rng = np.random.RandomState(7)
    n_s, n_c = 3000, 2000
    return ((rng.randint(1, 400, n_s).astype(np.int32), rng.randint(1, 60, n_s).astype(np.int32)),
            (rng.randint(1, 400, n_c).astype(np.int32), rng.randint(1, 60, n_c).astype(np.int32)))


def _q97_working_set(store, catalog):
    total = len(store[0]) + len(catalog[0])
    batch = q97.Q97Batch(*store, *catalog, capacity=q97.default_q97_capacity(total, 1))
    return q97.q97_working_set_bytes(batch, 1)


def _run_q97(mesh, store, catalog, limit):
    gov = mem.MemoryGovernor(watchdog_period_s=0.02)
    try:
        budget = mem.BudgetedResource(gov, limit)
        with mem.task_context(gov, 12):
            out = q97.run_distributed_q97(mesh, store, catalog, budget=budget, task_id=12,
                                          manage_task=False)
            splits = gov.get_and_reset_num_split_retry(12)
        assert budget.used == 0
        return (int(out.store_only), int(out.catalog_only), int(out.both)), splits
    finally:
        gov.close()


def test_plan_spans_nest_on_the_task_thread():
    """A governed q3 whose executor is built in the capture: admission, the
    dims' transfer, then ``srt.plan.upload`` holding the build, the pad and
    the scan tables' transfer in that order, then ``srt.plan.launch``; the
    answer is the untraced run's."""
    data = _q3_data()
    plan_cache.clear()
    (rows, splits), spans, task = _traced(lambda: _run_q3(data, 1 << 34))
    assert splits == 0
    assert rows == _run_q3(data, 1 << 34)[0]
    assert all(s.thread == task.thread for s in spans)
    names = {s.name for s in spans if s.name.startswith("srt.")}
    assert names == {"srt.gov.admit", "srt.plan.upload", "srt.plan.launch", "srt.plan.pad",
                     "srt.plan.build", "srt.plan.transfer"}
    [admit], [upload], [launch] = (_named(spans, n) for n in (
        "srt.gov.admit", "srt.plan.upload", "srt.plan.launch"))
    [pad], [build] = _named(spans, "srt.plan.pad"), _named(spans, "srt.plan.build")
    dims, inputs = sorted(_named(spans, "srt.plan.transfer"), key=lambda s: s.start)
    assert dims.end <= admit.start  # the dims go up once a bracket, before admission
    assert admit.end <= upload.start and upload.end <= launch.start
    assert not upload.holds(dims)
    for inner in (pad, build, inputs):
        assert upload.holds(inner)
    assert build.end <= pad.start and pad.end <= inputs.start


@pytest.mark.parametrize("query", ["q3", "q97"])
def test_governance_spans_under_a_splitting_budget(query):
    """Under a budget below the working set the task splits: every split
    call is a ``srt.gov.split`` span and every attempt a ``srt.gov.admit``
    span, neither inside a plan span, and the answer is the roomy run's."""
    if query == "q3":
        data = _q3_data()
        tight = q3.q3_working_set_bytes(data) * 6 // 10
        roomy = _run_q3(data, 1 << 34)[0]
        (got, splits), spans, _ = _traced(lambda: _run_q3(data, tight))
    else:
        store, catalog = _q97_batch()
        tight = _q97_working_set(store, catalog) * 6 // 10
        with one_rank_mesh("cpu") as mesh:
            roomy = _run_q97(mesh, store, catalog, 1 << 34)[0]
            (got, splits), spans, _ = _traced(lambda: _run_q97(mesh, store, catalog, tight))
    assert got == roomy
    assert splits >= 1
    split_spans = _named(spans, "srt.gov.split")
    admits = _named(spans, "srt.gov.admit")
    uploads = _named(spans, "srt.plan.upload")
    assert len(split_spans) >= splits
    assert len(admits) >= len(uploads) + 1 >= 3  # the attempt that split, then each piece
    plan_spans = uploads + _named(spans, "srt.plan.launch")
    for s in split_spans + admits:
        assert not any(p.holds(s) or s.holds(p) for p in plan_spans)


@pytest.mark.parametrize("query", ["q3", "q97"])
def test_upload_copies_lie_in_transfer_spans(query):
    """Every ``aten::to`` or ``aten::copy_`` that uploads a plan's inputs
    lies inside a ``srt.plan.transfer`` span on the same clock: each one
    inside ``srt.plan.upload`` and outside a build, and the dims' before
    admission.  Every ``aten::fill_`` of the upload (the pad tails and the
    row-valid arrays) lies inside ``srt.plan.pad``."""
    if query == "q3":
        data = _q3_data()
        _, spans, _ = _traced(lambda: _run_q3(data, 1 << 34))
    else:
        store, catalog = _q97_batch()
        with one_rank_mesh("cpu") as mesh:
            _, spans, _ = _traced(lambda: _run_q97(mesh, store, catalog, 1 << 34))
    transfers = _named(spans, "srt.plan.transfer")
    builds = _named(spans, "srt.plan.build")
    [upload] = _named(spans, "srt.plan.upload")
    first_admit = min(s.start for s in _named(spans, "srt.gov.admit"))
    copies = [c for c in _named(spans, "aten::to") + _named(spans, "aten::copy_")
              if (upload.holds(c) or c.end <= first_admit)
              and not any(b.holds(c) for b in builds)]
    # q3: five fact columns, four dim columns uploaded before admission and
    # passed through; q97: four keys (row-valid arrays are written in place)
    assert len(copies) >= (5 + 4 + 4 if query == "q3" else 4)
    for c in copies:
        assert any(t.holds(c) for t in transfers), c
    pads = _named(spans, "srt.plan.pad")
    fills = [f for f in _named(spans, "aten::fill_")
             if upload.holds(f) and not any(b.holds(f) for b in builds)]
    # the row-valid arrays' fills at least: q3 scans one table, q97 two
    assert len(fills) >= (1 if query == "q3" else 2)
    for f in fills:
        assert any(p.holds(f) for p in pads), f


def _fail_if_entered(monkeypatch):
    """Count the ranges the port opens: the names it passes."""
    entered = []
    real = phases._range

    def counting(*args, **kwargs):
        entered.append(args)
        return real(*args, **kwargs)

    monkeypatch.setattr(phases, "_range", counting)
    return entered


def test_no_capture_enters_no_range(monkeypatch):
    """With no capture running, neither governed query, split or not,
    opens a range; under a capture the same calls do."""
    entered = _fail_if_entered(monkeypatch)
    data = _q3_data()
    store, catalog = _q97_batch()
    tight = q3.q3_working_set_bytes(data) * 6 // 10
    with one_rank_mesh("cpu") as mesh:
        for _ in range(2):
            _on_task_thread(lambda: _run_q3(data, tight))
            _on_task_thread(lambda: _run_q97(mesh, store, catalog,
                                             _q97_working_set(store, catalog) * 6 // 10))
    assert entered == []
    with _capture():
        _on_task_thread(lambda: _run_q3(data, tight))
    assert {a[0] for a in entered} >= {"srt.gov.admit", "srt.gov.split", "srt.plan.upload",
                                       "srt.plan.pad", "srt.plan.transfer", "srt.plan.launch"}


TIMERS = [  # (module, timer, name, keys)
    ("plans.runtime", "PHASES", "plan", ("upload", "launch")),
    ("plans.compiler", "RANGE_PHASES", "range", ("emit", "rank_sort", "download")),
    ("ops.row_conversion", "PHASES", "row_conversion", ("plan", "lanes", "gather", "emit")),
    ("ops.float_to_string", "PHASES", "float_to_string", ("bucket", "ryu", "emit")),
    ("ops.cast_string_to_float", "PHASES", "cast_string_to_float",
     ("bucket", "parse", "assemble")),
    ("models.streaming", "PHASES", "streaming", ("generate", "hash", "bucket_run", "verify")),
    ("io.spill", "PHASES", "spill", ("route_encode", "write", "read_decode")),
]


@pytest.mark.parametrize("module,attr,name,keys", TIMERS, ids=[t[2] for t in TIMERS])
def test_every_timer_is_named_after_its_module(module, attr, name, keys):
    timer = getattr(importlib.import_module(f"spark_rapids_jni_tpu_torch.{module}"), attr)
    assert timer.name == name
    assert tuple(timer.snapshot()) == keys


@pytest.mark.parametrize("captured", [False, True], ids=["no_capture", "capture"])
def test_phase_sums_are_the_host_clock_with_or_without_a_capture(monkeypatch, captured):
    """A phase adds its host-clock time to its key's sum, the same with a
    capture running as without one, keys undeclared included; a capture
    records each as the span ``srt.<name>.<key>``, and only then."""
    entered = _fail_if_entered(monkeypatch)
    timer = phases.PhaseTimes("a", "b", name="unit")
    capture = _capture() if captured else None
    if capture is not None:
        capture.__enter__()
    try:
        t0 = time.perf_counter()
        with timer.phase("a"):
            time.sleep(0.02)
        with timer.phase("a"):
            time.sleep(0.01)
        with timer.phase("c"):
            pass
        wall = time.perf_counter() - t0
    finally:
        if capture is not None:
            capture.__exit__(None, None, None)
    got = timer.snapshot()
    assert set(got) == {"a", "b", "c"}
    assert 0.03 <= got["a"] <= wall
    assert got["b"] == 0.0 and 0.0 <= got["c"] < got["a"]
    assert [a[0] for a in entered] == (["srt.unit.a", "srt.unit.a", "srt.unit.c"]
                                       if captured else [])
    timer.reset()
    assert timer.snapshot() == {"a": 0.0, "b": 0.0, "c": 0.0}


def test_gate_is_the_process_wide_flag():
    """On a thread the capture did not start, the thread-local check reads
    False while the capture records; the process-wide flag, which
    ``trace_range`` reads, reads True there and False after the capture."""
    seen = {}

    def probe():
        seen["local"] = torch.autograd._profiler_enabled()
        seen["global"] = torch.autograd.profiler._is_profiler_enabled
        return phases.trace_range("srt.test.probe")

    with _capture():
        inside = _on_task_thread(probe)
    assert seen == {"local": False, "global": True}
    assert isinstance(inside, phases._range)
    assert _on_task_thread(probe) is phases.trace_range("srt.test.other")
