"""The retry protocol's control-flow exceptions (a copy of the JAX package's
``mem/exceptions.py``).

Mirrors the reference's OOM exception hierarchy thrown from native code
(GpuRetryOOM.java / GpuSplitAndRetryOOM.java / CpuRetryOOM.java /
CpuSplitAndRetryOOM.java / GpuOOM.java; SparkResourceAdaptorJni.cpp:36-41
cached class names).  The query engine catches RetryOOM to roll back to a
spillable state and retry, and SplitAndRetryOOM to additionally split the
input batch before retrying (RmmSpark.java:402-416 protocol doc).
"""


class RetryOOM(MemoryError):
    """Roll back to a spillable state and retry the operation."""


class SplitAndRetryOOM(MemoryError):
    """Roll back, split the input, and retry the operation."""


class GpuRetryOOM(RetryOOM):
    pass


class GpuSplitAndRetryOOM(SplitAndRetryOOM):
    pass


class CpuRetryOOM(RetryOOM):
    pass


class CpuSplitAndRetryOOM(SplitAndRetryOOM):
    pass


class GpuOOM(MemoryError):
    """A real out-of-memory (including the 500-retry livelock cap)."""


class OffHeapOOM(MemoryError):
    """A real host/off-heap out-of-memory (OffHeapOOM.java)."""


class ThreadRemovedError(RuntimeError):
    """The thread's task was removed while it was blocked."""


class InjectedException(RuntimeError):
    """forceCudfException analog: an injected framework error."""
