"""The readers of the program's spans (``core/spans.py``) on made-up traces:
clipping to the window, division by rank 0's tasks, nothing without a trace
or without the program's spans, and the untraced idle share on hand-made
idle and span intervals; then a traced run of each cell on the CPU."""

import json

import pytest

from nds_bench.core.harness import RunData
from nds_bench.core.loop import TaskRecord
from nds_bench.core.registry import BENCH_DIR, ROOT, load_module
from nds_bench.core.trace import WINDOW_RANGE, Ev, summarize
from nds_bench.tests.nds_bench_tiny import run_tiny, tiny_cell

NEW = ("plan_pad_ms", "plan_transfer_ms", "plan_builds", "gov_split_ms", "idle_untraced_pct")


def _reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"nds_bench_metric_{name.replace('.', '_')}")


def _trace():
    """A window of 10 s on rank 0: two task threads (2 and 3), the card busy
    over [1, 3] and [6, 7]."""
    return [
        Ev(WINDOW_RANGE, 0.0, 10.0, False, thread=1),
        # thread 2: an upload that began before the window, holding a pad
        # that is cut at the window's start, then the transfer
        Ev("srt.plan.upload", -1.0, 2.0, False, thread=2),
        Ev("srt.plan.pad", -1.0, 0.5, False, thread=2),
        Ev("srt.plan.transfer", 0.5, 2.0, False, thread=2),
        Ev("aten::to", 0.6, 1.9, False, thread=2),
        Ev("srt.plan.launch", 2.0, 3.0, False, thread=2),
        Ev("srt.gov.split", 4.0, 4.5, False, thread=2),
        # a build on thread 2 that starts in the window, one before it
        Ev("srt.plan.build", 4.5, 5.0, False, thread=2),
        Ev("srt.plan.build", -3.0, -2.0, False, thread=2),
        # thread 3: a pad at the same time as thread 2's split, and one cut
        # at the window's end
        Ev("srt.plan.pad", 4.0, 4.5, False, thread=3),
        Ev("srt.plan.pad", 9.0, 11.0, False, thread=3),
        Ev("srt.gov.admit", 7.5, 8.0, False, thread=3),
        Ev("aten::sort", 8.0, 8.5, False, thread=3),  # not a span of the program
        Ev("copy", 1.0, 3.0, True),
        Ev("kernel", 6.0, 7.0, True),
    ]


def _run(trace, ranks=(0, 0, 0, 0, 1, 1)):
    recs = [TaskRecord(i % 2, i, 0, 100 + i, 1000, float(i), float(i) + 0.5, rank=r)
            for i, r in enumerate(ranks)]
    return RunData(window_s=10.0, setup_s=3.0, done=recs, phases={"upload": 4.0},
                   peak_alloc_bytes=None, trace=trace, rates=(3.35e12, None),
                   hash_kernel=None)


def test_spans_clipped_to_the_window_per_rank0_task():
    run = _run(summarize(_trace()))
    # pads: 0.5 s (thread 2, from the window's start) + 0.5 + 1.0 (thread 3,
    # to its end) over the 4 tasks of rank 0, not the 6 of every rank
    assert _reader("plan_pad_ms").read(run) == pytest.approx(2000.0 / 4)
    assert _reader("plan_transfer_ms").read(run) == pytest.approx(1500.0 / 4)
    assert _reader("gov_split_ms").read(run) == pytest.approx(500.0 / 4)
    assert _reader("plan_builds").read(run) == 1  # the one that started in the window


def test_a_span_nested_in_one_of_its_name_counts_once():
    evs = _trace() + [Ev("srt.plan.pad", 4.1, 4.2, False, thread=3)]
    assert _reader("plan_pad_ms").read(_run(summarize(evs))) == pytest.approx(2000.0 / 4)


def test_idle_untraced_share():
    # idle: [0, 1], [3, 6], [7, 10]; spans cover [0, 3] (thread 2), [4, 5]
    # (both threads), [7.5, 8] and [9, 10]: untraced idle [3, 4], [5, 6],
    # [7, 7.5] and [8, 9], 3.5 s of 10 (aten::sort explains nothing)
    run = _run(summarize(_trace()))
    assert _reader("idle_untraced_pct").read(run) == pytest.approx(35.0)
    assert _reader("device_idle_pct").read(run) == pytest.approx(70.0)
    # with no span of the program in the window, it is the idle share
    quiet = [e for e in _trace() if not e.name.startswith("srt.")]
    quiet.append(Ev("srt.plan.pad", -5.0, -4.0, False, thread=2))
    assert _reader("idle_untraced_pct").read(_run(summarize(quiet))) == pytest.approx(70.0)
    assert _reader("plan_pad_ms").read(_run(summarize(quiet))) == 0.0
    assert _reader("plan_builds").read(_run(summarize(quiet))) == 0


def test_nothing_without_a_trace_or_the_programs_spans():
    older = summarize([e for e in _trace() if not e.name.startswith("srt.")])
    for name in NEW:
        assert _reader(name).read(_run(None)) is None, name
        assert _reader(name).read(_run(older)) is None, name
    # no task of rank 0: nothing per task
    for name in ("plan_pad_ms", "plan_transfer_ms", "gov_split_ms"):
        assert _reader(name).read(_run(summarize(_trace()), ranks=(1, 1))) is None, name


def _applies(workload):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench["per_layer"]
            if m["name"] in NEW and workload in m["workloads"]}


@pytest.mark.parametrize("workload", ["q97.tasks", "q3.tasks", "q97.pressure"])
def test_traced_run_reads_every_span_metric(workload):
    """A traced run on the CPU reports each new metric where its workloads
    list says, and the pad and the scan tables' transfer nest inside the
    upload's host sum (q3's dims go up outside it, once a bracket: at these
    sizes more bytes than its facts)."""
    res = run_tiny(tiny_cell(workload), trace=True)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert _applies(workload) <= set(got)
    inside = got["plan_pad_ms"] + (got["plan_transfer_ms"] if workload != "q3.tasks" else 0)
    assert inside <= 1.05 * got["runtime_host_ms"]
    assert 0.0 <= got["idle_untraced_pct"] <= 100.0
    if workload == "q97.pressure":
        assert got["gov_split_ms"] > 0
