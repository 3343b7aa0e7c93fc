"""The share of the traced window in which no operation ran on the card: 100
minus the union of every device interval (kernels, copies, fills)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
