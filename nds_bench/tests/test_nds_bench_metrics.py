"""The metric arithmetic: the percentile over every task, the union of device
intervals and the idle share, the bound of a launch, and the trace's
reduction, on made-up events."""

import math

import pytest

from nds_bench.core import bounds, stats
from nds_bench.core.harness import RunData
from nds_bench.core.loop import TaskRecord
from nds_bench.core.registry import BENCH_DIR, load_module
from nds_bench.core.trace import WINDOW_RANGE, Ev, summarize


def test_percentile_is_over_every_value():
    values = list(range(1, 101))  # 1..100
    assert stats.percentile(values, 95) == 95
    assert stats.percentile(values, 100) == 100
    assert stats.percentile([5.0], 95) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    # not a percentile of per-chunk medians
    chunks = [[1] * 19 + [100], [1] * 19 + [100]]
    assert stats.percentile([v for c in chunks for v in c], 95) == 1
    assert stats.percentile([v for c in chunks for v in c], 96) == 100


def test_union_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (-1.0, -0.5)]
    assert stats.union(iv, 0.0, 10.0) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.union(iv, 1.5, 3.5) == [(1.5, 2.0), (3.0, 3.5)]
    assert stats.gaps(stats.union(iv, 0, 10), 0.0, 10.0) == [(2.0, 3.0), (4.0, 10.0)]


def test_kernel_bound():
    rates = (3.35e12, 132 * 64 * 1.98e9)
    n = 1 << 26
    want = max(n * 12 / 3.35e12, n * 21 / rates[1])
    assert bounds.kernel_bound_s("mm_hash_long", n, rates) == pytest.approx(want)
    assert bounds.kernel_bound_s("mm_hash_long", n, (3.35e12, None)) == pytest.approx(
        n * 12 / 3.35e12)
    assert bounds.mem_rate("NVIDIA H100 80GB HBM3") == 3.35e12
    assert bounds.mem_rate("NVIDIA H100 PCIe") == 2.0e12
    with pytest.raises(RuntimeError):
        bounds.mem_rate("some other card")


def _trace():
    """A window of 10 s: three kernels (one a hash over 1000 rows launched
    through a library's own CUDA runtime, so that CUPTI names another thread
    for the launch than the one whose casts bracket it) and host operations
    on two threads."""
    return [
        Ev(WINDOW_RANGE, 0.0, 10.0, False, thread=1),
        Ev("aten::sort", 0.5, 2.5, False, thread=2, corr=50),
        Ev("cudaLaunchKernel", 0.6, 0.61, False, thread=2, corr=7),
        Ev("sort_kernel", 1.0, 3.0, True, corr=7),
        Ev("aten::to", 3.9990, 3.9991, False, thread=2, corr=60, shapes=[[1000], []],
           dtypes=["long int", "Scalar"]),
        Ev("aten::empty", 3.9995, 3.9996, False, thread=2, corr=61),
        Ev("cudaLaunchKernel", 4.0, 4.00001, False, thread=1, corr=8),
        Ev("aten::to", 4.00002, 4.03, False, thread=2, corr=51, shapes=[[1000], []],
           dtypes=["int", "Scalar"]),
        Ev("cudaLaunchKernel", 4.021, 4.022, False, thread=2, corr=11),
        Ev("copy_kernel", 5.0, 5.1, True, corr=11),
        Ev("(anonymous namespace)::mm_hash_long_kernel(long)", 4.5, 5.0, True, corr=8),
        Ev("all_reduce_kernel", 6.0, 6.5, True, corr=9),
        Ev("aten::cat", 5.5, 8.0, False, thread=3, corr=52),
        Ev("before_window_kernel", -2.0, -1.0, True, corr=10),
    ]


def test_summary_busy_idle_and_breakdown():
    s = summarize(_trace())
    assert s.window_s == 10.0
    assert s.busy_s == pytest.approx(2.0 + 0.5 + 0.1 + 0.5)
    assert s.device_ops[0] == ("sort_kernel", pytest.approx(2.0))
    labels = dict(s.idle_gaps)
    # each gap goes by the innermost host operation at its middle
    assert labels == pytest.approx({"aten::sort": 1.0, "aten::cat": 0.9,
                                    "host:untraced": 5.0})
    hash_ev = next(e for e in s.device if "mm_hash_long" in e.name)
    assert s.launch_rows(hash_ev) == 1000


def _run(trace=None, **over):
    recs = [TaskRecord(0, i, i % 2, 100 + i, 1000, float(i), float(i) + 0.1 * (i + 1),
                       splits=i % 2, retries=1, block_ns=2_000_000, least_bytes=3350)
            for i in range(10)]
    base = dict(window_s=10.0, setup_s=3.0, done=recs, phases={"upload": 0.5, "launch": 1.0},
                peak_alloc_bytes=3 * 2 ** 30, trace=trace, rates=(3.35e12, None),
                hash_kernel="mm_hash_long")
    base.update(over)
    return RunData(**base)


def _reader(name):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       f"nds_bench_metric_{name.replace('.', '_')}")


def test_metric_readers():
    run = _run(summarize(_trace()))
    assert _reader("rows_per_s").read(run) == 1000.0
    assert _reader("task_p95_ms").read(run) == pytest.approx(1000.0)
    assert _reader("task_p95_ms.pressure").read(run) == pytest.approx(1000.0)
    assert _reader("setup_s").read(run) == 3.0
    assert _reader("gov_block_ms").read(run) == pytest.approx(2.0)
    assert _reader("gov_splits").read(run) == pytest.approx(1.5)
    assert _reader("runtime_host_ms").read(run) == pytest.approx(50.0)
    assert _reader("peak_alloc_gib").read(run) == pytest.approx(3.0)
    assert _reader("device_idle_pct").read(run) == pytest.approx(69.0)
    assert _reader("plan_roofline").read(run) == pytest.approx(
        100.0 * 10 * 3350 / 3.35e12 / 3.1)
    assert _reader("mm_hash_long_roofline").read(run) == pytest.approx(
        100.0 * 1000 * 12 / 3.35e12 / 0.5)


def test_readers_find_nothing_without_their_source():
    run = _run(None, done=[])
    for name in ("task_p95_ms", "gov_block_ms", "gov_splits", "runtime_host_ms",
                 "plan_roofline", "mm_hash_long_roofline", "device_idle_pct"):
        assert _reader(name).read(run) is None, name
    assert _reader("rows_per_s").read(run) == 0.0
    no_launch = [e for e in _trace() if e.corr != 8 or e.device]
    assert _reader("mm_hash_long_roofline").read(_run(summarize(no_launch))) is None
    assert not math.isnan(_reader("device_idle_pct").read(_run(summarize(_trace()))))


def test_launch_rows_reads_nothing_when_unsure():
    evs = _trace()
    # a second thread brackets the same launch with casts of another length
    evs += [Ev("aten::to", 3.9992, 3.9993, False, thread=3, corr=70, shapes=[[7], []],
               dtypes=["long int", "Scalar"]),
            Ev("aten::to", 4.00003, 4.0001, False, thread=3, corr=71, shapes=[[7], []],
               dtypes=["int", "Scalar"])]
    s = summarize(evs)
    hash_ev = next(e for e in s.device if "mm_hash_long" in e.name)
    assert s.launch_rows(hash_ev) is None
    # a widening cast of int32 keys with no int64 cast before it is not a hash's
    evs = [e for e in _trace() if e.corr != 60]
    s = summarize(evs)
    assert s.launch_rows(next(e for e in s.device if "mm_hash_long" in e.name)) is None
