"""Memory governance (PyTorch port of ``mem/``).  For now only the
exceptions that the plan runtime raises; the budgets, the arbiter and the
retry loop come with the rest of the port's memory governance."""

from spark_rapids_jni_tpu_torch.mem.governed import (
    MaxSplitDepthExceeded,
    ShuffleCapacityExceeded,
)

__all__ = ["MaxSplitDepthExceeded", "ShuffleCapacityExceeded"]
