"""The program's own spans in a traced run: the ``record_function`` ranges
named ``srt.<layer>.<step>`` that the port opens at its layer boundaries
while a capture runs (``obs/phases.py`` of the port), recorded on rank 0's
threads on the clock of the device's activity.  A program without such
spans gives a trace in which these readers find nothing."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from nds_bench.core import stats
from nds_bench.core.trace import Summary

PREFIX = "srt."


def intervals(summary: Summary, names=None) -> Dict[int, List[Tuple[float, float]]]:
    """Per thread, the intervals of the spans named in ``names`` (every
    ``srt.`` span where None)."""
    out: Dict[int, List[Tuple[float, float]]] = {}
    for thread, evs in summary.host.items():
        iv = [(e.start, e.end) for e in evs
              if (e.name in names if names is not None else e.name.startswith(PREFIX))]
        if iv:
            out[thread] = iv
    return out


def has_spans(summary: Optional[Summary]) -> bool:
    return summary is not None and any(
        e.name.startswith(PREFIX) for evs in summary.host.values() for e in evs)


def rank0_tasks(run) -> int:
    """Rank 0's tasks completed in the window: the threads whose spans the
    trace holds."""
    return sum(1 for r in run.done if r.rank == 0)


def ms_per_task(run, *names: str) -> Optional[float]:
    """Milliseconds that rank 0's threads spent inside the spans ``names``,
    clipped to the window, per rank-0 task completed in it: on each thread
    the union of the spans' intervals (a span inside another counts once),
    summed over the threads.  None without a trace, without the program's
    spans or without a task."""
    tasks = rank0_tasks(run)
    if not tasks or not has_spans(run.trace):
        return None
    lo, hi = run.trace.window
    total = sum(b - a for iv in intervals(run.trace, names).values()
                for a, b in stats.union(iv, lo, hi))
    return total * 1e3 / tasks


def started(run, name: str) -> Optional[int]:
    """How many spans ``name`` started inside the window on rank 0's
    threads; None without a trace or without the program's spans."""
    if not has_spans(run.trace):
        return None
    lo, hi = run.trace.window
    return sum(1 for iv in intervals(run.trace, (name,)).values()
               for a, _ in iv if lo <= a < hi)


def untraced_idle_s(summary: Summary) -> float:
    """Seconds of the window in which the card ran nothing and no thread
    was inside any of the program's spans."""
    lo, hi = summary.window
    busy = [(e.start, e.end) for e in summary.device]
    busy += [x for iv in intervals(summary).values() for x in iv]
    return (hi - lo) - sum(b - a for a, b in stats.union(busy, lo, hi))
