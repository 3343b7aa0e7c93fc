from spark_rapids_jni_tpu_torch.models.nds import (
    QueryStepConfig,
    local_query_step,
    make_example_batch,
)

__all__ = ["QueryStepConfig", "local_query_step", "make_example_batch"]
