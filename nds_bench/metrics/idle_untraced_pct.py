"""The share of the traced window in which the card ran nothing and no
thread of rank 0 was inside any of the program's spans (``srt.``): the idle
time that the program's own spans do not put down to a layer."""

from nds_bench.core.spans import has_spans, untraced_idle_s


def read(run):
    if not has_spans(run.trace) or run.trace.window_s <= 0:
        return None
    return 100.0 * untraced_idle_s(run.trace) / run.trace.window_s
