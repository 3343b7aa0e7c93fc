"""The exchange's placement-hash launches (``srt_mm_hash_long``) in the
traced window: the summed least time of each launch at its own row count
(``core/bounds.py``) over their summed device time.  It reads the launches
whose row count the trace shows (``Summary.launch_rows``), and nothing where
it shows none."""

from nds_bench.core.bounds import kernel_bound_s


def read(run):
    if run.trace is None or run.hash_kernel is None:
        return None
    lo, hi = run.trace.window
    tag = f"{run.hash_kernel}_kernel"
    bound = spent = 0.0
    for e in run.trace.device:
        if tag not in e.name or e.start < lo or e.end > hi:
            continue
        n = run.trace.launch_rows(e)
        if n is not None:
            bound += kernel_bound_s(run.hash_kernel, n, run.rates)
            spent += e.end - e.start
    if spent <= 0:
        return None
    return 100.0 * bound / spent
