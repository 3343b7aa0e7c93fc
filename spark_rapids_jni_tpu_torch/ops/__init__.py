from spark_rapids_jni_tpu_torch.ops.hashing import (
    DEFAULT_XXHASH64_SEED,
    murmur3_raw_int64,
    murmur_hash32,
    partition_mix32,
    xxhash64,
    xxhash64_raw_int64,
)
from spark_rapids_jni_tpu_torch.ops.bloom_filter import (
    BloomFilter,
    bloom_filter_create,
    bloom_filter_deserialize,
    bloom_filter_merge,
    bloom_filter_probe,
    bloom_filter_put,
    bloom_filter_serialize,
)
from spark_rapids_jni_tpu_torch.ops.cast_string import (
    CastException,
    from_integers_with_base,
    string_to_decimal,
    string_to_integer,
    to_integers_with_base,
)
from spark_rapids_jni_tpu_torch.ops.cast_string_to_float import string_to_float
from spark_rapids_jni_tpu_torch.ops.decimal128 import (
    multiply128,
    divide128,
    integer_divide128,
    remainder128,
    add128,
    subtract128,
)
from spark_rapids_jni_tpu_torch.ops.cast_decimal_to_string import decimal_to_string
from spark_rapids_jni_tpu_torch.ops.float_to_string import float_to_string
from spark_rapids_jni_tpu_torch.ops.format_float import format_float
from spark_rapids_jni_tpu_torch.ops.row_conversion import (
    convert_from_rows,
    convert_from_rows_fixed_width_optimized,
    convert_to_rows,
    convert_to_rows_fixed_width_optimized,
)
from spark_rapids_jni_tpu_torch.ops.from_json import JsonParsingException, from_json
from spark_rapids_jni_tpu_torch.ops.get_json_object import (
    get_json_object,
    get_json_object_multiple_paths,
    parse_path,
)

__all__ = [
    "DEFAULT_XXHASH64_SEED",
    "murmur3_raw_int64",
    "murmur_hash32",
    "partition_mix32",
    "xxhash64",
    "xxhash64_raw_int64",
    "BloomFilter",
    "bloom_filter_create",
    "bloom_filter_deserialize",
    "bloom_filter_merge",
    "bloom_filter_probe",
    "bloom_filter_put",
    "bloom_filter_serialize",
    "CastException",
    "from_integers_with_base",
    "string_to_decimal",
    "string_to_integer",
    "to_integers_with_base",
    "string_to_float",
    "multiply128",
    "divide128",
    "integer_divide128",
    "remainder128",
    "add128",
    "subtract128",
    "decimal_to_string",
    "float_to_string",
    "format_float",
    "convert_from_rows",
    "convert_from_rows_fixed_width_optimized",
    "convert_to_rows",
    "convert_to_rows_fixed_width_optimized",
    "from_json",
    "get_json_object",
    "get_json_object_multiple_paths",
    "parse_path",
    "JsonParsingException",
]
