from spark_rapids_jni_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    axis_group,
    axis_index,
    axis_size,
    make_mesh,
    one_rank_mesh,
)
from spark_rapids_jni_tpu_torch.parallel.shuffle import (
    ShuffleResult,
    all_to_all_shuffle,
    bucket_by_partition,
    partition_of,
    quantized_rows,
)
from spark_rapids_jni_tpu_torch.parallel.table_shuffle import (
    PaddedStrings,
    ShuffledTable,
    materialize_strings,
    pad_strings,
    shuffle_table,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "axis_group",
    "axis_index",
    "axis_size",
    "make_mesh",
    "one_rank_mesh",
    "PaddedStrings",
    "ShuffleResult",
    "ShuffledTable",
    "all_to_all_shuffle",
    "bucket_by_partition",
    "materialize_strings",
    "pad_strings",
    "partition_of",
    "quantized_rows",
    "shuffle_table",
]
