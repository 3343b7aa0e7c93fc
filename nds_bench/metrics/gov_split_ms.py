"""Milliseconds rank 0's threads spent splitting a batch that did not fit
its budget (the spans ``srt.gov.split`` around each ``split`` call of the
port's ``run_with_split_retry``, pre-split and reactive), clipped to the
traced window, per rank-0 task completed in it."""

from nds_bench.core.spans import ms_per_task


def read(run):
    return ms_per_task(run, "srt.gov.split")
