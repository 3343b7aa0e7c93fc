from spark_rapids_jni_tpu_torch.ops.hashing import (
    DEFAULT_XXHASH64_SEED,
    murmur3_raw_int64,
    murmur_hash32,
    partition_mix32,
    xxhash64,
    xxhash64_raw_int64,
)

__all__ = [
    "DEFAULT_XXHASH64_SEED",
    "murmur3_raw_int64",
    "murmur_hash32",
    "partition_mix32",
    "xxhash64",
    "xxhash64_raw_int64",
]
