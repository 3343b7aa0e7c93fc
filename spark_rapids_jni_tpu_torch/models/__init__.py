from spark_rapids_jni_tpu_torch.models.nds import (
    QueryStepConfig,
    QueryStepOut,
    local_query_step,
    make_distributed_query_step,
    make_example_batch,
)
from spark_rapids_jni_tpu_torch.models.q97 import (
    Q97Batch,
    Q97Out,
    combine_q97_outs,
    make_distributed_q97,
    make_distributed_q97_columns,
    q97_local,
    split_q97_batch,
)
from spark_rapids_jni_tpu_torch.models.tpcds import (
    Q3Data,
    Q5Data,
    generate_q3_data,
    generate_q5_data,
)

__all__ = [
    "QueryStepConfig",
    "QueryStepOut",
    "Q3Data",
    "Q5Data",
    "Q97Batch",
    "Q97Out",
    "generate_q3_data",
    "generate_q5_data",
    "make_distributed_q97_columns",
    "local_query_step",
    "make_distributed_query_step",
    "make_distributed_q97",
    "make_example_batch",
    "combine_q97_outs",
    "q97_local",
    "split_q97_batch",
]
