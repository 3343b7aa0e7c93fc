"""The PyTorch port's fixed-width hashes against the JAX package, on the CPU.

Inputs are seeded numpy arrays handed to both packages; every comparison is
bit-exact (tolerance 0: integer hashing).  The JAX side runs under both hash
backends: ``xla`` and ``pallas`` (Pallas interpret mode off-TPU).  The port's
wrappers take their plain PyTorch versions here because the tensors lie on the
CPU; the CUDA kernels themselves are held against the same plain versions on
the card by ``chip_smoke.py``.
"""

import os
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu import config
from spark_rapids_jni_tpu.ops import hashing as jh
from spark_rapids_jni_tpu.ops import murmur_hash32 as jax_murmur_hash32
from spark_rapids_jni_tpu.ops import xxhash64 as jax_xxhash64
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import hash_cuda, murmur_hash32, xxhash64

import spark_oracles as oracle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ["xla", "pallas"]

# kernel -> (JAX contribution, port plain version, value dtype, seed dtype,
#            edge values of test_hash_pallas.py)
KERNELS = {
    "mm_hash_int": (jh._mm_hash_int, hash_cuda.mm_hash_int_torch, np.int32, np.uint32,
                    [0, -1, -(2**31), 2**31 - 1]),
    "mm_hash_long": (jh._mm_hash_long, hash_cuda.mm_hash_long_torch, np.int64, np.uint32,
                     [0, -1, -(2**63), 2**63 - 1]),
    "xx_hash_fixed4": (jh._xx_hash_fixed4, hash_cuda.xx_hash_fixed4_torch, np.uint32,
                       np.uint64, [0, 0xFFFFFFFF, 1]),
    "xx_hash_fixed8": (jh._xx_hash_fixed8, hash_cuda.xx_hash_fixed8_torch, np.uint64,
                       np.uint64, [0, (1 << 64) - 1, 1 << 63]),
}


def _draw(rng, dtype, n):
    info = np.iinfo(dtype)
    return rng.randint(info.min, int(info.max) + 1, n, dtype=dtype)


def _t(a):
    return interop.tensor_from_numpy(a, "cpu")


def _unsigned(t, like):
    """Port output bits viewed as the JAX output's unsigned dtype."""
    return t.numpy().view(like.dtype)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [0, 1, 255, 4096])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_contribution_matches_jax(kernel, n, backend):
    jfn, plain, vdt, sdt, edges = KERNELS[kernel]
    rng = np.random.RandomState(n + len(kernel))
    v = _draw(rng, vdt, n)
    if n >= len(edges):
        v[:len(edges)] = np.array(edges, dtype=np.uint64 if vdt == np.uint64 else None) \
            .astype(vdt)
    seed = _draw(rng, sdt, n)
    with config.override(hash_backend=backend):
        want = np.asarray(jfn(jnp.asarray(v), jnp.asarray(seed)))
    got = plain(_t(v), _t(seed))
    np.testing.assert_array_equal(_unsigned(got, want), want)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_contribution_scalar_seed_and_edges(kernel, backend):
    jfn, plain, vdt, sdt, edges = KERNELS[kernel]
    v = np.array(edges, dtype=np.uint64 if vdt == np.uint64 else None).astype(vdt)
    for seed in (0, 42, int(np.iinfo(sdt).max)):
        with config.override(hash_backend=backend):
            want = np.asarray(jfn(jnp.asarray(v), sdt(seed)))
        got = plain(_t(v), seed)
        np.testing.assert_array_equal(_unsigned(got, want), want)


# --- Spark vectors (tests/test_hash.py, from HashTest.java) --------------------

_F32 = lambda bits: struct.unpack("<f", struct.pack("<I", bits))[0]  # noqa: E731
_F64 = lambda bits: struct.unpack("<d", struct.pack("<Q", bits))[0]  # noqa: E731
F32_SPECIAL = [_F32(0x00800000), _F32(0x7F7FFFFF), None, _F32(0x7F800001),
               _F32(0x7FFFFFFF), _F32(0xFF800001), _F32(0xFFFFFFFF)]
F64_SPECIAL = [_F64(0x0010000000000000), _F64(0x7FEFFFFFFFFFFFFF),
               _F64(0x7FFFFFFFFFFFFFFF), _F64(0x7FF0000000000001),
               _F64(0xFFFFFFFFFFFFFFFF), _F64(0xFFF0000000000001)]
INF = [float("inf"), float("-inf")]
INTS = ([0, 100, None, None, -(2**31), None], [0, None, -100, None, None, 2**31 - 1])
TS = [0, None, 100, -100, 0x123456789ABCDEF, None, -0x123456789ABCDEF]
DEC64 = [0, 100, -100, 0x123456789ABCDEF, -0x123456789ABCDEF]
DEC32 = [0, 100, -100, 0x12345678, -0x12345678]
DATES = [0, None, 100, -100, 0x12345678, None, -0x12345678]
DOUBLES = [0.0, None, 100.0, -100.0] + F64_SPECIAL + INF
FLOATS = [0.0, 100.0, -100.0] + F32_SPECIAL + INF
BOOLS = ([None, True, False, True, None, False], [None, True, False, None, False, True])

# (hash, [(values, dtype)], seed or None for the default, expected)
SPARK_VECTORS = {
    "murmur_ints": ("mm", [(INTS[0], tc.INT32), (INTS[1], tc.INT32)], 42,
                    [59727262, 751823303, -1080202046, 42, 723455942, 133916647]),
    "murmur_doubles": ("mm", [(DOUBLES, tc.FLOAT64)], 0,
                       [1669671676, 0, -544903190, -1831674681, 150502665, 474144502,
                        1428788237, 1428788237, 1428788237, 1428788237, 420913893,
                        1915664072]),
    "murmur_timestamps": ("mm", [(TS, tc.TIMESTAMP_MICROS)], 42,
                          [-1670924195, 42, 1114849490, 904948192, 657182333, 42,
                           -57193045]),
    "murmur_decimal64": ("mm", [(DEC64, tc.decimal(18, 7))], 42,
                         [-1670924195, 1114849490, 904948192, 657182333, -57193045]),
    "murmur_decimal32": ("mm", [(DEC32, tc.decimal(9, 3))], 42,
                         [-1670924195, 1114849490, 904948192, -958054811, -1447702630]),
    "murmur_dates": ("mm", [(DATES, tc.DATE32)], 42,
                     [933211791, 42, 751823303, -1080202046, -1721170160, 42,
                      1852996993]),
    "murmur_floats": ("mm", [(FLOATS, tc.FLOAT32)], 411,
                      [-235179434, 1812056886, 2028471189, 1775092689, -1531511762, 411,
                       -1053523253, -1053523253, -1053523253, -1053523253, -1526256646,
                       930080402]),
    "murmur_bools": ("mm", [(BOOLS[0], tc.BOOL), (BOOLS[1], tc.BOOL)], 0,
                     [0, -1589400010, -239939054, -68075478, 593689054, -1194558265]),
    "xxhash64_ints": ("xx", [(INTS[0], tc.INT32), (INTS[1], tc.INT32)], None,
                      [1151812168208346021, -7987742665087449293, 8990748234399402673,
                       42, 2073849959933241805, 1508894993788531228]),
    "xxhash64_doubles": ("xx", [(DOUBLES, tc.FLOAT64)], None,
                         [-5252525462095825812, 42, -7996023612001835843,
                          5695175288042369293, 6181148431538304986, -4222314252576420879,
                          -3127944061524951246, -3127944061524951246, -3127944061524951246,
                          -3127944061524951246, 5810986238603807492, 5326262080505358431]),
    "xxhash64_timestamps": ("xx", [(TS, tc.TIMESTAMP_MICROS)], None,
                            [-5252525462095825812, 42, 8713583529807266080,
                             5675770457807661948, 1941233597257011502, 42,
                             -1318946533059658749]),
    "xxhash64_decimal64": ("xx", [(DEC64, tc.decimal(18, 7))], None,
                           [-5252525462095825812, 8713583529807266080, 5675770457807661948,
                            1941233597257011502, -1318946533059658749]),
    "xxhash64_decimal32": ("xx", [(DEC32, tc.decimal(9, 3))], None,
                           [-5252525462095825812, 8713583529807266080, 5675770457807661948,
                            -7728554078125612835, 3142315292375031143]),
    "xxhash64_dates": ("xx", [(DATES, tc.DATE32)], None,
                       [3614696996920510707, 42, -7987742665087449293, 8990748234399402673,
                        6954428822481665164, 42, -4294222333805341278]),
    "xxhash64_floats": ("xx", [(FLOATS, tc.FLOAT32)], None,
                        [3614696996920510707, -8232251799677946044, -6625719127870404449,
                         -6699704595004115126, -1065250890878313112, 42,
                         2692338816207849720, 2692338816207849720, 2692338816207849720,
                         2692338816207849720, -5940311692336719973, -7580553461823983095]),
    "xxhash64_bools": ("xx", [(BOOLS[0], tc.BOOL), (BOOLS[1], tc.BOOL)], None,
                       [42, 9083826852238114423, 1151812168208346021, -6698625589789238999,
                        3614696996920510707, 7945966957015589024]),
}


@pytest.mark.parametrize("case", list(SPARK_VECTORS))
def test_spark_vectors(case):
    which, specs, seed, expected = SPARK_VECTORS[case]
    cols = [tc.column(values, dtype, device="cpu") for values, dtype in specs]
    fn = murmur_hash32 if which == "mm" else xxhash64
    out = fn(cols) if seed is None else fn(cols, seed=seed)
    assert out.dtype == (tc.INT32 if which == "mm" else tc.INT64)
    assert out.to_list() == expected


MIXED_LONG_STR = (
    "A very long (greater than 128 bytes/char string) to test a multi hash-step data point "
    "in the MD5 hash function. This string needed to be longer."
)


@pytest.mark.parametrize("which", ["mm", "xx"])
def test_spark_mixed_vector_after_string_prefix(which):
    """HashTest's mixed row, the strings column first, hashed by the port
    alone: the strings give the running hash that the four fixed-width
    columns chain onto."""
    cols = [
        tc.strings_column(["a", "B\n", "dE\"Ā\tā 휠휡", MIXED_LONG_STR, None, None],
                          device="cpu"),
        tc.column([0, 100, -100, -(2**31), 2**31 - 1, None], tc.INT32, device="cpu"),
        tc.column([0.0, 100.0, -100.0, _F64(0x7FF0000000000001),
                   _F64(0x7FFFFFFFFFFFFFFF), None], tc.FLOAT64, device="cpu"),
        tc.column([0.0, 100.0, -100.0, _F32(0xFF800001), _F32(0xFFFFFFFF), None],
                  tc.FLOAT32, device="cpu"),
        tc.column([True, False, None, False, True, None], tc.BOOL, device="cpu"),
    ]
    if which == "mm":
        got = murmur_hash32(cols, seed=1868).to_list()
        expected = [1936985022, 720652989, 339312041, 1400354989, 769988643, 1868]
    else:
        got = xxhash64(cols).to_list()
        expected = [7451748878409563026, 6024043102550151964, 3380664624738534402,
                    8444697026100086329, -5888679192448042852, 42]
    assert got == expected


def test_random_longs_vs_oracle():
    rng = np.random.RandomState(99)
    vals = [int(v) for v in rng.randint(-(2**63), 2**63, 256, dtype=np.int64)]
    col = tc.column(vals, tc.INT64, device="cpu")
    mm = murmur_hash32([col], seed=3).to_list()
    xx = xxhash64([col], seed=3).to_list()
    assert mm == [oracle.to_signed32(oracle.murmur32_long(v, 3)) for v in vals]
    assert xx == [oracle.to_signed64(oracle.xxh64_long(v, 3)) for v in vals]


@pytest.mark.parametrize("backend", BACKENDS)
def test_columns_with_nulls_match_jax(backend):
    """murmur_hash32 / xxhash64 over an INT32 column with nulls and an INT64
    column, crossed through interop from the JAX package's own columns."""
    rng = np.random.RandomState(3)
    n = 1000
    jcols = [
        jc.Column(jnp.asarray(rng.randint(-(2**31), 2**31, n).astype(np.int32)),
                  jnp.asarray(rng.rand(n) < 0.9), jc.INT32),
        jc.Column(jnp.asarray(rng.randint(-(2**63), 2**63, n, dtype=np.int64)),
                  None, jc.INT64),
    ]
    pcols = [interop.column_from_numpy(
        np.asarray(c.data), None if c.validity is None else np.asarray(c.validity),
        c.dtype, device="cpu") for c in jcols]
    with config.override(hash_backend=backend):
        want_mm = jax_murmur_hash32(jcols, seed=42).to_list()
        want_xx = jax_xxhash64(jcols, seed=42).to_list()
    assert murmur_hash32(pcols, seed=42).to_list() == want_mm
    assert xxhash64(pcols, seed=42).to_list() == want_xx


def test_unported_and_unsupported_inputs_raise():
    """Strings hash now (the column-hash slice); what still raises: a LIST of
    STRUCT (as Spark refuses it), unsupported kinds, an empty column list,
    and wrapper arguments of the wrong type, shape or device."""
    assert murmur_hash32([tc.strings_column(["a"], device="cpu")], seed=42).to_list() == \
        [1485273170]
    child = tc.StructColumn((tc.column([1, 2], tc.INT32, device="cpu"),), None)
    lst = tc.ListColumn(torch.tensor([0, 1, 2], dtype=torch.int32), child, None)
    with pytest.raises(ValueError, match="LIST of STRUCT"):
        murmur_hash32([lst])
    with pytest.raises(ValueError, match="LIST of STRUCT"):
        xxhash64([tc.ListColumn(torch.tensor([0, 2], dtype=torch.int32), lst, None)])
    with pytest.raises(ValueError, match="unsupported"):
        murmur_hash32([tc.column([1], tc.TIMESTAMP_MILLIS, device="cpu")])
    with pytest.raises(ValueError, match="at least one column"):
        xxhash64([])
    with pytest.raises(TypeError, match="int64"):
        hash_cuda.xx_hash_fixed8_cuda(torch.zeros(4, dtype=torch.int32), 42)
    with pytest.raises(TypeError, match="seed/hash"):
        hash_cuda.mm_hash_int_cuda(torch.zeros(4, dtype=torch.int32),
                                   torch.zeros(3, dtype=torch.int32))
    chars = torch.zeros(8, dtype=torch.uint8)
    spans = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError, match="uint8"):
        hash_cuda.mm_hash_bytes_cuda(chars.to(torch.int32), spans, spans, 0)
    with pytest.raises(TypeError, match="int32"):
        hash_cuda.mm_hash_bytes_cuda(chars, spans.to(torch.int64), spans, 0)
    with pytest.raises(TypeError, match="lens of shape"):
        hash_cuda.mm_hash_bytes_cuda(chars, spans, spans[:3], 0)
    with pytest.raises(TypeError, match="seed/hash"):
        hash_cuda.mm_hash_bytes_cuda(chars, spans, spans, torch.zeros(4, dtype=torch.int64))
    with pytest.raises(ValueError, match="on meta"):
        hash_cuda.mm_hash_bytes_cuda(chars, spans, spans.to("meta"), 0)


# --- interop ------------------------------------------------------------------


@pytest.mark.parametrize("values,dtype", [
    ([1, None, -(2**31), 2**31 - 1], "INT32"),
    ([0.0, -0.0, None, float("inf"), 1.5], "FLOAT64"),
    ([0.5, None, -2.25], "FLOAT32"),
    ([True, None, False], "BOOL"),
    ([0, -(2**63), 2**63 - 1, None], "TIMESTAMP_MICROS"),
    ([12345, -1, None], "DECIMAL64"),
])
def test_interop_round_trip(values, dtype):
    jdt = getattr(jc, dtype) if dtype != "DECIMAL64" else jc.decimal(18, 2)
    jcol = jc.column(values, jdt)
    data, validity = np.asarray(jcol.data), np.asarray(jcol.validity)
    pcol = interop.column_from_numpy(data, validity, jcol.dtype, device="cpu")
    assert pcol.dtype.kind.value == jdt.kind.value
    assert (pcol.dtype.precision, pcol.dtype.scale) == (jdt.precision, jdt.scale)
    assert pcol.to_list() == [v for v in jcol.to_list()]
    back, back_valid = interop.column_to_numpy(pcol)
    np.testing.assert_array_equal(back, data)
    np.testing.assert_array_equal(back_valid, validity)
    assert pcol.to_list() == tc.column(values, pcol.dtype, device="cpu").to_list()


def test_interop_unsigned_bits_round_trip():
    u64 = np.array([0, 1, (1 << 64) - 1, 1 << 63], dtype=np.uint64)
    pcol = interop.column_from_numpy(u64, None, tc.UINT64, device="cpu")
    assert pcol.data.dtype == torch.int64
    back, valid = interop.column_to_numpy(pcol)
    assert valid is None and back.dtype == np.uint64
    np.testing.assert_array_equal(back, u64)
    u32 = np.array([0, 0xFFFFFFFF, 0x80000000], dtype=np.uint32)
    np.testing.assert_array_equal(interop.tensor_from_numpy(u32, "cpu").numpy().view(np.uint32),
                                  u32)


# --- package boundary and devices ---------------------------------------------


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import spark_rapids_jni_tpu_torch.device, spark_rapids_jni_tpu_torch.interop\n"
        "import spark_rapids_jni_tpu_torch.columnar, spark_rapids_jni_tpu_torch.ops\n"
        "import spark_rapids_jni_tpu_torch.columnar.buckets\n"
        "import spark_rapids_jni_tpu_torch.columnar.column\n"
        "import spark_rapids_jni_tpu_torch.columnar.dtypes\n"
        "import spark_rapids_jni_tpu_torch.ops.hashing\n"
        "import spark_rapids_jni_tpu_torch.ops._build, spark_rapids_jni_tpu_torch.ops.hash_cuda\n"
        "import spark_rapids_jni_tpu_torch.parallel, spark_rapids_jni_tpu_torch.models\n"
        "import spark_rapids_jni_tpu_torch.parallel.mesh\n"
        "import spark_rapids_jni_tpu_torch.parallel.shuffle\n"
        "import spark_rapids_jni_tpu_torch.parallel.table_shuffle\n"
        "import spark_rapids_jni_tpu_torch.models.nds, spark_rapids_jni_tpu_torch.models.q97\n"
        "import spark_rapids_jni_tpu_torch.models.tpcds\n"
        "import spark_rapids_jni_tpu_torch.models.q5, spark_rapids_jni_tpu_torch.models.q3\n"
        "import spark_rapids_jni_tpu_torch.plans, spark_rapids_jni_tpu_torch.plans.ir\n"
        "import spark_rapids_jni_tpu_torch.plans.cache, spark_rapids_jni_tpu_torch.plans.compiler\n"
        "import spark_rapids_jni_tpu_torch.plans.runtime\n"
        "import spark_rapids_jni_tpu_torch.mem, spark_rapids_jni_tpu_torch.mem.governed\n"
        "import spark_rapids_jni_tpu_torch.config, spark_rapids_jni_tpu_torch.obs\n"
        "import spark_rapids_jni_tpu_torch.obs.seam, spark_rapids_jni_tpu_torch.obs.flight\n"
        "import spark_rapids_jni_tpu_torch.mem.exceptions, spark_rapids_jni_tpu_torch.mem.arbiter\n"
        "import spark_rapids_jni_tpu_torch.mem.governor, spark_rapids_jni_tpu_torch.mem.spill\n"
        "import spark_rapids_jni_tpu_torch.mem.montecarlo\n"
        "import spark_rapids_jni_tpu_torch.utils, spark_rapids_jni_tpu_torch.utils.int128\n"
        "import spark_rapids_jni_tpu_torch.utils.int256, spark_rapids_jni_tpu_torch.utils.bitmask\n"
        "import spark_rapids_jni_tpu_torch.utils.floatbits, spark_rapids_jni_tpu_torch.obs.phases\n"
        "import spark_rapids_jni_tpu_torch.ops.decimal128\n"
        "import spark_rapids_jni_tpu_torch.ops.bloom_filter\n"
        "import spark_rapids_jni_tpu_torch.ops.row_conversion\n"
        "import spark_rapids_jni_tpu_torch.utils.u64, spark_rapids_jni_tpu_torch.utils.softfloat\n"
        "import spark_rapids_jni_tpu_torch.utils.ryu_tables\n"
        "import spark_rapids_jni_tpu_torch.ops.cast_string\n"
        "import spark_rapids_jni_tpu_torch.ops.cast_string_to_float\n"
        "import spark_rapids_jni_tpu_torch.ops.float_to_string\n"
        "import spark_rapids_jni_tpu_torch.ops.format_float\n"
        "import spark_rapids_jni_tpu_torch.ops.cast_decimal_to_string\n"
        "import spark_rapids_jni_tpu_torch.plans.window\n"
        "import spark_rapids_jni_tpu_torch.plans.optimizer\n"
        "import spark_rapids_jni_tpu_torch.models.q67, spark_rapids_jni_tpu_torch.models.q64\n"
        "import spark_rapids_jni_tpu_torch.models.tables\n"
        "import spark_rapids_jni_tpu_torch.serve, spark_rapids_jni_tpu_torch.serve.shuffle\n"
        "from spark_rapids_jni_tpu_torch.columnar.buckets import count_subbuckets\n"
        "import spark_rapids_jni_tpu_torch.ops.json_tokenizer\n"
        "import spark_rapids_jni_tpu_torch.ops.json_scan\n"
        "import spark_rapids_jni_tpu_torch.ops.json_render_device\n"
        "import spark_rapids_jni_tpu_torch.ops.get_json_object\n"
        "import spark_rapids_jni_tpu_torch.ops.from_json\n"
        "import spark_rapids_jni_tpu_torch.io, spark_rapids_jni_tpu_torch.io.parquet_footer\n"
        "import spark_rapids_jni_tpu_torch.io.parquet_read, spark_rapids_jni_tpu_torch.io.spill\n"
        "import spark_rapids_jni_tpu_torch.models.streaming\n"
        "import spark_rapids_jni_tpu_torch.models.nds_harness\n"
        "import spark_rapids_jni_tpu_torch.utils.utf8, spark_rapids_jni_tpu_torch.utils.tzif\n"
        "import spark_rapids_jni_tpu_torch.ops.regex_rewrite\n"
        "import spark_rapids_jni_tpu_torch.ops.datetime_rebase\n"
        "import spark_rapids_jni_tpu_torch.ops.timezones, spark_rapids_jni_tpu_torch.ops.zorder\n"
        "import spark_rapids_jni_tpu_torch.ops.histogram\n"
        "import spark_rapids_jni_tpu_torch.ops.parse_uri\n"
        "import spark_rapids_jni_tpu_torch.obs.timing, spark_rapids_jni_tpu_torch.obs.profiler\n"
        "import spark_rapids_jni_tpu_torch.obs.convert, spark_rapids_jni_tpu_torch.obs.faultinj\n"
        "import spark_rapids_jni_tpu_torch.obs.trace, spark_rapids_jni_tpu_torch.version\n"
        "from spark_rapids_jni_tpu_torch.ops import parse_uri_host, percentile_from_histogram\n"
        "from spark_rapids_jni_tpu_torch.obs import Profiler, FaultInjector, install_from_env\n"
        "import spark_rapids_jni_tpu_torch.columnar.frames\n"
        "import spark_rapids_jni_tpu_torch.columnar.pages\n"
        "import spark_rapids_jni_tpu_torch.serve.session, spark_rapids_jni_tpu_torch.serve.queue\n"
        "import spark_rapids_jni_tpu_torch.serve.metrics\n"
        "import spark_rapids_jni_tpu_torch.serve.attribution\n"
        "import spark_rapids_jni_tpu_torch.serve.controller\n"
        "import spark_rapids_jni_tpu_torch.serve.ragged\n"
        "import spark_rapids_jni_tpu_torch.serve.executor\n"
        "import spark_rapids_jni_tpu_torch.plans.rcache\n"
        "from spark_rapids_jni_tpu_torch.plans.compiler import cached_ragged_compile\n"
        "from spark_rapids_jni_tpu_torch.serve import ServingEngine, RaggedSpec, Knob\n"
        "import spark_rapids_jni_tpu_torch.serve.rpc, spark_rapids_jni_tpu_torch.serve.slo\n"
        "import spark_rapids_jni_tpu_torch.serve.telemetry\n"
        "import spark_rapids_jni_tpu_torch.serve.supervisor\n"
        "from spark_rapids_jni_tpu_torch.serve.shuffle import ShuffleService, run_shuffle_piece\n"
        "from spark_rapids_jni_tpu_torch.serve import Supervisor, ShuffleSpec, TelemetryServer\n"
        "sys.path.insert(0, 'tests')\n"
        "import uri_oracle  # the parse_url oracle the card's smoke run imports\n"
        "import torch_mesh_ranks  # what spawned gloo ranks import\n"
        "import torch_cluster_worker  # what spawned executor workers import\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'spark_rapids_jni_tpu')\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_cpu_tensors_take_plain_versions_and_launch_nothing():
    hash_cuda.reset_launches()
    rng = np.random.RandomState(5)
    v32 = _t(_draw(rng, np.int32, 64))
    v64 = _t(_draw(rng, np.int64, 64))
    h32 = _t(_draw(rng, np.int32, 64))
    s64 = _t(_draw(rng, np.int64, 64))
    pairs = [
        (hash_cuda.mm_hash_int_cuda(v32, h32), hash_cuda.mm_hash_int_torch(v32, h32)),
        (hash_cuda.mm_hash_long_cuda(v64, 7), hash_cuda.mm_hash_long_torch(v64, 7)),
        (hash_cuda.xx_hash_fixed4_cuda(v32, s64), hash_cuda.xx_hash_fixed4_torch(v32, s64)),
        (hash_cuda.xx_hash_fixed8_cuda(v64, 42), hash_cuda.xx_hash_fixed8_torch(v64, 42)),
    ]
    for got, want in pairs:
        assert torch.equal(got, want)
    murmur_hash32([tc.column([1, None, 3], tc.INT32, device="cpu")])
    assert set(hash_cuda.launches.values()) == {0}


def test_default_device_is_the_card(monkeypatch):
    from spark_rapids_jni_tpu_torch import device
    from spark_rapids_jni_tpu_torch.models import make_example_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.column([1, 2], tc.INT32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_example_batch(8, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.tensor_from_numpy(np.zeros(2, np.int32))
    assert device.resolve("cpu") == torch.device("cpu")
    assert tc.column([1, 2], tc.INT32, device="cpu").data.device.type == "cpu"
