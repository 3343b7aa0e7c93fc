"""Host milliseconds a task spent in the plan runtime's upload step (pad,
executor lookup and transfer: ``plans.runtime.PHASES["upload"]``), summed
over the window on every thread, per task completed in it."""


def read(run):
    if not run.done or "upload" not in run.phases:
        return None
    return run.phases["upload"] * 1e3 / len(run.done)
