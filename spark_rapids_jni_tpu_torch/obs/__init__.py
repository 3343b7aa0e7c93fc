"""Observability and chaos (PyTorch port of ``obs/``): the dispatch seam, the
governance flight recorder, the per-op phase timers, the profiler with its
device timeline and the offline converter, the fault injector, request spans
and steady-state timing."""

from spark_rapids_jni_tpu_torch.obs import flight, phases, seam
from spark_rapids_jni_tpu_torch.obs.faultinj import FaultInjector, install_from_env
from spark_rapids_jni_tpu_torch.obs.profiler import Profiler
from spark_rapids_jni_tpu_torch.obs.seam import (
    ALLOC,
    COLLECTIVE,
    OP,
    SERVE,
    TRANSFER,
    instrument,
)

# NB: the `seam` context manager stays at obs.seam.seam: re-exporting it here
# would shadow the submodule attribute of the package.

__all__ = [
    "ALLOC",
    "COLLECTIVE",
    "FaultInjector",
    "OP",
    "Profiler",
    "SERVE",
    "TRANSFER",
    "flight",
    "install_from_env",
    "instrument",
    "phases",
    "seam",
]
