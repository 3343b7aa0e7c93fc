"""The device trace of a traced run, reduced to what the metrics read.

``torch.profiler`` (CUPTI on the card) records the window; its raw events are
read once (``kineto_results``), not through the profiler's own tables.  The
window's bounds are the host range ``nds_bench.window`` that the main thread
holds open, in the profiler's own time base, and every device interval is
clipped to it.  A device event is any activity on the card: kernels, copies
and fills."""

from __future__ import annotations

import bisect
import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from nds_bench.core import stats

WINDOW_RANGE = "nds_bench.window"
TOP = 10
SHORT_GAP_S = 50e-6  # gaps shorter than this are the spacing of launches, pooled
_LAUNCH_OPS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


@dataclasses.dataclass
class Ev:
    name: str
    start: float  # seconds in the profiler's time base
    end: float
    device: bool
    thread: int = 0
    corr: int = 0
    shapes: Sequence = ()
    dtypes: Sequence = ()


@dataclasses.dataclass
class Summary:
    window: Tuple[float, float]
    busy_s: float
    device: List[Ev]  # device events that overlap the window
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    host: Dict[int, List[Ev]]  # host events by thread, sorted by start
    launches: Dict[int, Ev]  # host launch events by correlation id
    brackets: List[Tuple[float, float, int]] = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def launch_rows(self, kernel_ev: Ev) -> Optional[int]:
        """The row count of a placement-hash launch, or None where the trace
        does not show it.  The caller brackets the launch with two widening
        casts of one length on its thread: ``keys.to(int64)`` (int64 already,
        so nothing runs) just before, and the output's ``h.to(int64)`` (from
        int32) just after, with only the output's allocation between.  A
        bracket whose gap holds the launch gives its length.  CUPTI does not
        give the thread of a launch made through a library's own CUDA
        runtime, so every thread's brackets count, and a launch that the
        brackets of more than one length hold reads nothing."""
        launch = self.launches.get(kernel_ev.corr)
        if launch is None:
            return None
        found = {n for lo, hi, n in self.brackets
                 if lo <= launch.start and launch.end <= hi}
        return found.pop() if len(found) == 1 else None


def _brackets(host: Dict[int, List[Ev]]) -> List[Tuple[float, float, int]]:
    """(end of the int64 cast, start of the int32 widening, length) of every
    bracket of casts on every thread (:meth:`Summary.launch_rows`)."""
    out = []
    for evs in host.values():
        for i, e in enumerate(evs):
            n = _cast_length(e, "int") if e.name == "aten::to" else None
            if n is None:
                continue
            j = i - 1
            while j >= 0 and (evs[j].name == "aten::empty" or evs[j].name.startswith("cu")):
                j -= 1
            if j >= 0 and evs[j].name == "aten::to" and _cast_length(evs[j], "long int") == n:
                out.append((evs[j].end, e.start, n))
    return out


def _cast_length(e: Ev, dtype: str) -> Optional[int]:
    """The length of a 1-D ``dtype`` source of an ``aten::to``, else None."""
    if e.shapes and len(e.shapes[0]) == 1 and (not e.dtypes or e.dtypes[0] == dtype):
        return int(e.shapes[0][0])
    return None


def _get(e, ns_name: str, us_name: str) -> float:
    if hasattr(e, ns_name):
        return getattr(e, ns_name)() * 1e-9
    return getattr(e, us_name)() * 1e-6


def profiler(cuda: bool):
    """A ``torch.profiler.profile`` of the CPU (and the card) that records
    input shapes and, where this torch offers it, the operations of every
    thread: the task threads are not the thread that starts it."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        cfg = None
    return torch.profiler.profile(activities=acts, record_shapes=True,
                                  experimental_config=cfg)


def events_of(prof) -> List[Ev]:
    """The profiler's raw events as :class:`Ev` (seconds)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = _get(e, "start_ns", "start_us")
        dur = _get(e, "duration_ns", "duration_us")
        device = "CUDA" in str(e.device_type())
        shapes = dtypes = ()
        if not device:
            try:
                shapes, dtypes = e.shapes(), e.dtypes()
            except RuntimeError:
                pass
        out.append(Ev(e.name(), start, start + dur, device, e.start_thread_id(),
                      e.correlation_id(), shapes, dtypes))
    return out


def summarize(events: Sequence[Ev]) -> Summary:
    """Busy time, the heaviest device operations and the idle gaps by what the
    host was doing, over the window that the ``nds_bench.window`` range
    marks."""
    marks = [e for e in events if not e.device and e.name == WINDOW_RANGE]
    if not marks:
        raise RuntimeError(f"the trace holds no {WINDOW_RANGE!r} range")
    lo, hi = marks[0].start, marks[0].end
    device = [e for e in events if e.device and e.end > lo and e.start < hi]
    merged = stats.union(((e.start, e.end) for e in device), lo, hi)
    busy = sum(b - a for a, b in merged)
    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        by_name[e.name[:160]] += min(e.end, hi) - max(e.start, lo)
    host: Dict[int, List[Ev]] = defaultdict(list)
    launches: Dict[int, Ev] = {}
    for e in events:
        if e.device:
            continue
        if e.name in _LAUNCH_OPS:
            launches[e.corr] = e
        elif e.name != WINDOW_RANGE:
            host[e.thread].append(e)
    for evs in host.values():
        evs.sort(key=lambda e: e.start)
    idle: Dict[str, float] = defaultdict(float)
    flat = sorted((e for evs in host.values() for e in evs), key=lambda e: e.start)
    starts = [e.start for e in flat]
    for a, b in stats.gaps(merged, lo, hi):
        label = ("gaps under 50 us" if b - a < SHORT_GAP_S
                 else _host_label(flat, starts, (a + b) / 2))
        idle[label] += b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary((lo, hi), busy, device, top, gaps_top, dict(host), launches,
                   _brackets(host))


def _host_label(flat: List[Ev], starts: List[float], t: float) -> str:
    """The innermost host operation running at ``t`` on any thread, or
    ``host:untraced`` where none is (Python outside torch: numpy, the GIL)."""
    best = None
    i = bisect.bisect_right(starts, t)
    for e in reversed(flat[max(0, i - 512):i]):
        if e.end >= t and (best is None or e.end - e.start < best.end - best.start):
            best = e
    return "host:untraced" if best is None else best.name[:160]
