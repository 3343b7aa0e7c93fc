"""Milliseconds rank 0's threads spent copying a plan's inputs to the card
(the spans ``srt.plan.transfer``: the scan tables inside
``srt.plan.upload``, and a governed plan's dimension tables once a
bracket), clipped to the traced window, per rank-0 task completed in it."""

from nds_bench.core.spans import ms_per_task


def read(run):
    return ms_per_task(run, "srt.plan.transfer")
