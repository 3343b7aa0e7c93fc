"""The port's JCUDF spill codec and disk grace-hash shuffle
(``spark_rapids_jni_tpu_torch/io/spill.py``) against the JAX package's, on the
CPU.

The same tables, made with numpy from seeds and built as columns of both
packages (``interop.port_column``), go through both codecs: the row bytes
and row sizes must be equal, for fixed-width and for string schemas, and
equal to the port's ``convert_to_rows``.  The key hashes must be the same
uint64 words.  Two shuffles, one per package, fed the same chunks must write
the same spill files byte for byte, after ``append`` and after
``split_bucket``, with the same row accounting.
"""

import os

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu.io import spill as jspill
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.io import spill
from spark_rapids_jni_tpu_torch.ops.row_conversion import convert_to_rows


def _jax_rich(n, seed):
    """A JAX table of every spillable shape, ``n`` rows: nullable INT32,
    strings (empty, multibyte, null), DECIMAL(38,4) past 64 bits, BOOL,
    FLOAT64 bits with specials, FLOAT32, INT16, INT64, DATE32."""
    rng = np.random.RandomState(seed)

    def nul(vals, p=0.1):
        return [None if rng.rand() < p else v for v in vals]

    words = ["", "héllo", "x" * 37, "tail", "píñata", "a"]
    floats = rng.randn(n) * 1e3
    floats[:4] = [np.inf, -0.0, np.nan, 3.25e300][:min(4, n)]
    return [
        jc.column(nul(rng.randint(-2**31, 2**31, n, dtype=np.int64).tolist()), jc.INT32),
        jc.strings_column(nul([words[i % 6] + str(i) * (i % 3) for i in range(n)])),
        jc.decimal128_column(nul([int(v) * 10**21 - 7 for v in rng.randint(-10**6, 10**6, n)]),
                             38, 4),
        jc.column(nul((rng.rand(n) < 0.5).tolist()), jc.BOOL),
        jc.column(nul(floats.tolist()), jc.FLOAT64),
        jc.column(nul((rng.randn(n) * 10).astype(np.float32).tolist()), jc.FLOAT32),
        jc.column(nul(rng.randint(-2**15, 2**15, n).tolist()), jc.INT16),
        jc.column(nul(rng.randint(-2**62, 2**62, n, dtype=np.int64).tolist()), jc.INT64),
        jc.column(nul(rng.randint(0, 20000, n).tolist()), jc.DATE32),
    ]


def _both(jax_cols):
    return jax_cols, [interop.port_column(c, "cpu") for c in jax_cols]


FIXED = [0, 2, 3, 4, 5, 6, 7, 8]  # the rich table without its strings


@pytest.mark.parametrize("n", [0, 1, 7, 300])
@pytest.mark.parametrize("schema", ["fixed", "strings"])
def test_encode_bytes_equal_jax_and_convert_to_rows(n, schema):
    jcols = _jax_rich(n, seed=n + 1)
    if schema == "fixed":
        jcols = [jcols[i] for i in FIXED]
    jcols, pcols = _both(jcols)
    got, sizes = spill.encode_jcudf_rows(pcols)
    want, want_sizes = jspill.encode_jcudf_rows(jcols)
    assert got.dtype == np.uint8 and sizes.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(sizes, want_sizes)
    if n:
        (rows,) = convert_to_rows(pcols)
        np.testing.assert_array_equal(got, rows.child.data.numpy())
        np.testing.assert_array_equal(np.diff(rows.offsets.numpy()), sizes)


def _col_fields(col):
    return [None if a is None else np.asarray(a) for a in interop.column_to_numpy(col)]


def _same_column(got, jax_col):
    """Values, validity and dtype of a decoded port column equal to the JAX
    package's decoding of the same bytes (strings cut to offsets[-1])."""
    assert got.dtype == interop.port_dtype(jax_col.dtype)
    g = _col_fields(got)
    w = [None if a is None else np.asarray(a) for a in
         (interop.column_to_numpy(interop.port_column(jax_col, "cpu")))]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("select", [None, (0, 2, 8)])
def test_decode_equals_jax_on_the_device_asked(select):
    jcols, pcols = _both(_jax_rich(200, seed=5))
    buf, sizes = spill.encode_jcudf_rows(pcols)
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    dtypes = [c.dtype for c in pcols]
    got = spill.decode_jcudf_rows(buf, offsets, dtypes, select=select, device="cpu")
    want = jspill.decode_jcudf_rows(buf, offsets, [c.dtype for c in jcols], select=select)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None)
        if g is not None:
            assert g.device.type == "cpu"
            _same_column(g, w)
            _same_column(g, jcols[i])  # the round trip is exact


def test_decode_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spill.decode_jcudf_rows(np.zeros(0, np.uint8), np.zeros(1, np.int64), [tc.INT32])


def test_key_hashes_equal_jax():
    rng = np.random.RandomState(8)
    a = rng.randint(-2**31, 2**31, 5000, dtype=np.int64).astype(np.int32)
    b = rng.randint(-2**31, 2**31, 5000, dtype=np.int64).astype(np.int32)
    np.testing.assert_array_equal(spill.pair_mix64(a, b), jspill.pair_mix64(a, b))
    x = rng.randint(0, 2**63, 5000, dtype=np.int64).astype(np.uint64)
    np.testing.assert_array_equal(spill.splitmix64(x), jspill.splitmix64(x))
    jcols, pcols = _both(_jax_rich(500, seed=9))
    for keys in ([0], [2, 3], FIXED):
        np.testing.assert_array_equal(spill.chained_key_hash([pcols[i] for i in keys]),
                                      jspill.chained_key_hash([jcols[i] for i in keys]))
    with pytest.raises(TypeError, match="string key"):
        spill.chained_key_hash([pcols[1]])


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _pair_shuffles(tmp_path, schema, n_buckets):
    """One shuffle per package over the same schema and key."""
    if schema == "pair":
        return (spill.ExternalTableShuffle(str(tmp_path / "port"), n_buckets,
                                           [tc.INT32, tc.INT32], key_indices=(0, 1)),
                jspill.ExternalTableShuffle(str(tmp_path / "jax"), n_buckets,
                                            [jc.INT32, jc.INT32], key_indices=(0, 1)))
    jd = [jc.INT32, jc.STRING, jc.decimal(38, 4), jc.BOOL]
    return (spill.ExternalTableShuffle(str(tmp_path / "port"), n_buckets,
                                       [interop.port_dtype(d) for d in jd], key_indices=(0, 2)),
            jspill.ExternalTableShuffle(str(tmp_path / "jax"), n_buckets, jd,
                                        key_indices=(0, 2)))


def _chunk(schema, seed, n):
    if schema == "pair":
        rng = np.random.RandomState(seed)
        return [jc.Column(rng.randint(1, 400, n).astype(np.int32), None, jc.INT32),
                jc.Column(rng.randint(1, 300, n).astype(np.int32), None, jc.INT32)]
    return _jax_rich(n, seed)[:4]


@pytest.mark.parametrize("schema", ["pair", "strings"])
def test_shuffle_files_equal_jax_after_append_and_split(tmp_path, schema):
    port, jax = _pair_shuffles(tmp_path, schema, 4)
    for i in range(6):
        for side in ("store", "catalog"):
            jcols = _chunk(schema, seed=10 * i + (side == "store"), n=250 + 37 * i)
            port.append(side, [interop.port_column(c, "cpu") for c in jcols])
            jax.append(side, jcols)
    assert _files(port.dir) == _files(jax.dir)
    assert port.rows == jax.rows
    assert (schema == "strings") == any(n.endswith(".len") for n in os.listdir(port.dir))
    assert [port.bucket_nbytes(b) for b in range(4)] == [jax.bucket_nbytes(b) for b in range(4)]
    assert port.max_bucket_rows() == jax.max_bucket_rows()
    for bucket in (1, 5, 1):  # a refined bucket splits again at the doubled modulus
        assert port.split_bucket(bucket, chunk_rows=97) == jax.split_bucket(bucket, chunk_rows=97)
        assert _files(port.dir) == _files(jax.dir)
        assert port.rows == jax.rows
    for b in range(4 * 4):
        for side in ("store", "catalog"):
            got = port.read(side, b, device="cpu")
            want = jax.read(side, b)
            for g, w in zip(got, want):
                _same_column(g, w)
    with pytest.raises(ValueError, match="append after split_bucket"):
        port.append("store", [interop.port_column(c, "cpu") for c in _chunk(schema, 1, 5)])
    port.close()
    jax.close()
    assert os.listdir(port.dir) == []
    assert len(port.read("store", 0, device="cpu")[0]) == 0


def test_shuffle_takes_columns_from_any_device_and_reads_to_the_card(tmp_path, monkeypatch):
    """Appended columns come to the host with an explicit copy; ``read``
    without a device asks for the card."""
    shuffle = spill.ExternalTableShuffle(str(tmp_path), 2, [tc.INT64], key_indices=(0,))
    col = tc.Column(torch.arange(10, dtype=torch.int64), None, tc.INT64)
    shuffle.append("s", [col])
    assert sum(len(shuffle.read("s", b, device="cpu")[0]) for b in range(2)) == 10
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        shuffle.read("s", 0)
    shuffle.close()
