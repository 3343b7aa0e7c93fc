"""Input fact rows of every task completed inside the window, over all task
threads (and ranks), per second of the window (host clock)."""


def read(run):
    return sum(r.rows for r in run.done) / run.window_s
