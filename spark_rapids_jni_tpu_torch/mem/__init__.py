"""Memory governance: the multi-tenant task arbiter (PyTorch port of
``mem/``; SURVEY.md §2.2 analog).

See mem.governor for the facade and the batch-admission resource, mem.arbiter
for the native bindings, csrc/task_arbiter.cpp for the state machine core,
mem.governed for the retry/split-and-retry driver and mem.spill for the
spill-to-host rung.
"""

from spark_rapids_jni_tpu_torch.mem.arbiter import (
    Arbiter,
    OOM_ALL,
    OOM_CPU,
    OOM_GPU,
    STATE_ALLOC,
    STATE_ALLOC_FREE,
    STATE_BLOCKED,
    STATE_BUFN,
    STATE_BUFN_THROW,
    STATE_BUFN_WAIT,
    STATE_REMOVE_THROW,
    STATE_RUNNING,
    STATE_SPLIT_THROW,
    STATE_UNKNOWN,
    current_thread_id,
)
from spark_rapids_jni_tpu_torch.mem.spill import (
    SpillableBuffer,
    SpillPool,
)
from spark_rapids_jni_tpu_torch.mem.exceptions import (
    CpuRetryOOM,
    CpuSplitAndRetryOOM,
    GpuOOM,
    GpuRetryOOM,
    GpuSplitAndRetryOOM,
    InjectedException,
    OffHeapOOM,
    RetryOOM,
    SplitAndRetryOOM,
    ThreadRemovedError,
)
from spark_rapids_jni_tpu_torch.mem.governed import (
    MaxSplitDepthExceeded,
    ShuffleCapacityExceeded,
    attempt_once,
    default_device_budget,
    reservation,
    run_with_split_retry,
    task_context,
)
from spark_rapids_jni_tpu_torch.mem.governor import (
    BudgetedResource,
    MemoryGovernor,
    OutOfBudget,
)

__all__ = [
    "Arbiter",
    "BudgetedResource",
    "MaxSplitDepthExceeded",
    "ShuffleCapacityExceeded",
    "attempt_once",
    "default_device_budget",
    "reservation",
    "run_with_split_retry",
    "task_context",
    "CpuRetryOOM",
    "CpuSplitAndRetryOOM",
    "GpuOOM",
    "GpuRetryOOM",
    "GpuSplitAndRetryOOM",
    "InjectedException",
    "MemoryGovernor",
    "OffHeapOOM",
    "OOM_ALL",
    "OOM_CPU",
    "OOM_GPU",
    "OutOfBudget",
    "RetryOOM",
    "SplitAndRetryOOM",
    "STATE_ALLOC",
    "STATE_ALLOC_FREE",
    "STATE_BLOCKED",
    "STATE_BUFN",
    "STATE_BUFN_THROW",
    "STATE_BUFN_WAIT",
    "STATE_REMOVE_THROW",
    "STATE_RUNNING",
    "STATE_SPLIT_THROW",
    "STATE_UNKNOWN",
    "SpillPool",
    "SpillableBuffer",
    "ThreadRemovedError",
    "current_thread_id",
]
