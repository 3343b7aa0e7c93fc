"""Executors the plan cache built inside the traced window: the spans
``srt.plan.build`` (a cache miss) that started in it on rank 0's threads.
Every shape is warmed before the window, so a build here is one that runs
again."""

from nds_bench.core.spans import started


def read(run):
    return started(run, "srt.plan.build")
