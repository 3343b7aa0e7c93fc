"""Milliseconds rank 0's threads spent in the plan runtime's host pad of the
scan tables (the span ``srt.plan.pad`` inside ``srt.plan.upload``), clipped
to the traced window, per rank-0 task completed in it."""

from nds_bench.core.spans import ms_per_task


def read(run):
    return ms_per_task(run, "srt.plan.pad")
