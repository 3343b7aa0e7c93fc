"""Host-side IO tooling (PyTorch port of ``io/``): parquet footer
parse/filter/serialize, the split-planned reader that consumes the filtered
footer, and the JCUDF-row disk shuffle (``io.spill``, imported by its
users)."""

from spark_rapids_jni_tpu_torch.io.parquet_footer import (
    ListElement,
    MapElement,
    ParquetFooter,
    StructBuilder,
    StructElement,
    ValueElement,
)
from spark_rapids_jni_tpu_torch.io.parquet_read import (
    iter_split_batches,
    plan_byte_splits,
    plan_split,
    read_split,
)

__all__ = [
    "ListElement",
    "MapElement",
    "ParquetFooter",
    "StructBuilder",
    "StructElement",
    "ValueElement",
    "iter_split_batches",
    "plan_byte_splits",
    "plan_split",
    "read_split",
]
