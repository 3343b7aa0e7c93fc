"""Mean split-and-retry plus retry signals a task took from the arbiter
(``get_and_reset_num_split_retry`` + ``get_and_reset_num_retry``), over the
tasks completed in the window."""


def read(run):
    if not run.done:
        return None
    return sum(r.splits + r.retries for r in run.done) / len(run.done)
