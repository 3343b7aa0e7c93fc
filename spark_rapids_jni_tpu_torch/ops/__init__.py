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
from spark_rapids_jni_tpu_torch.ops.datetime_rebase import (
    rebase_gregorian_to_julian,
    rebase_julian_to_gregorian,
)
from spark_rapids_jni_tpu_torch.ops.histogram import (
    create_histogram_if_valid,
    percentile_from_histogram,
)
from spark_rapids_jni_tpu_torch.ops.timezones import (
    TimeZoneDB,
    convert_timestamp_to_utc,
    convert_utc_timestamp_to_timezone,
)
from spark_rapids_jni_tpu_torch.ops.regex_rewrite import literal_range_pattern
from spark_rapids_jni_tpu_torch.ops.parse_uri import (
    parse_uri_host,
    parse_uri_path,
    parse_uri_protocol,
    parse_uri_query,
    parse_uri_query_column,
    parse_uri_query_literal,
)
from spark_rapids_jni_tpu_torch.ops.zorder import hilbert_index, interleave_bits
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
    "literal_range_pattern",
    "parse_uri_host",
    "parse_uri_path",
    "parse_uri_protocol",
    "parse_uri_query",
    "parse_uri_query_column",
    "parse_uri_query_literal",
    "create_histogram_if_valid",
    "percentile_from_histogram",
    "TimeZoneDB",
    "convert_timestamp_to_utc",
    "convert_utc_timestamp_to_timezone",
    "hilbert_index",
    "interleave_bits",
    "rebase_gregorian_to_julian",
    "rebase_julian_to_gregorian",
]

# Route every public op function through the dispatch seam: the boundary
# where the profiler records ranges and the fault injector may raise
# (obs/seam.py; the CUPTI-subscription analog, zero changes to op code).
import spark_rapids_jni_tpu_torch.obs.faultinj as _faultinj  # noqa: E402
import spark_rapids_jni_tpu_torch.obs.seam as _seam_mod  # noqa: E402

for _name in __all__:
    _fn = globals()[_name]
    if callable(_fn) and not isinstance(_fn, type):
        globals()[_name] = _seam_mod.instrument(_seam_mod.OP, _name)(_fn)
del _name, _fn

# CUDA_INJECTION64_PATH-style auto-arming via env var; a broken config must
# not make the library unimportable
try:
    _faultinj.install_from_env()
except Exception as _e:  # noqa: BLE001
    import warnings as _warnings

    _warnings.warn(
        f"fault injector config ({_faultinj.ENV_CONFIG_PATH}) ignored: {_e!r}",
        RuntimeWarning,
        stacklevel=2,
    )
