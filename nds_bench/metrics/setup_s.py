"""From the process's start to the first timed task: interpreter, torch, the
CUDA context, the process groups, the kernel libraries, the task pool made
from the seed, and every shape of the cell warmed once (host clock)."""


def read(run):
    return run.setup_s
