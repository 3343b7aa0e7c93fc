"""The 95th percentile (nearest rank) of the latency of every task completed
inside the window, on every thread: from the moment its thread took it to
the moment its answer was on the host (host clock)."""

from nds_bench.core.stats import percentile


def read(run):
    if not run.done:
        return None
    return percentile([r.latency_s for r in run.done], 95) * 1e3
