from spark_rapids_jni_tpu_torch.models.nds import (
    QueryStepConfig,
    QueryStepOut,
    local_query_step,
    make_distributed_query_step,
    make_example_batch,
)
from spark_rapids_jni_tpu_torch.models.q3 import (
    Q3Row,
    make_distributed_q3,
    q3_local,
)
from spark_rapids_jni_tpu_torch.models.q5 import (
    Q5Row,
    make_distributed_q5,
    q5_local,
)
from spark_rapids_jni_tpu_torch.models.q97 import (
    Q97Batch,
    Q97Out,
    combine_q97_outs,
    make_distributed_q97,
    make_distributed_q97_columns,
    q97_local,
    q97_plan,
    run_q97_piece,
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
    "Q3Row",
    "Q5Data",
    "Q5Row",
    "Q97Batch",
    "Q97Out",
    "generate_q3_data",
    "generate_q5_data",
    "make_distributed_q3",
    "make_distributed_q5",
    "make_distributed_q97_columns",
    "q3_local",
    "q5_local",
    "local_query_step",
    "make_distributed_query_step",
    "make_distributed_q97",
    "make_example_batch",
    "combine_q97_outs",
    "q97_local",
    "q97_plan",
    "run_q97_piece",
    "split_q97_batch",
]
