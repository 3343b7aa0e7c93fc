"""Mean milliseconds a task spent blocked in the memory arbiter, from the
arbiter's per-task counter (``get_and_reset_block_time_ns``) read inside
each task completed in the window."""


def read(run):
    if not run.done:
        return None
    return sum(r.block_ns for r in run.done) / len(run.done) / 1e6
