"""The PyTorch port's Spark bloom filter against the JAX package and Spark's
``BloomFilterImpl``, on the CPU.

Inputs are seeded (numpy) and handed to both packages; every comparison is
bit-exact (tolerance 0): the filter's longs, the probe flags false positives
included, and the serialized bytes.  The oracle is the python transcription
of ``BloomFilterImpl`` in ``tests/test_bloom_filter.py``.  The port's hashes
go through the ``mm_hash_long`` wrapper, which takes its plain PyTorch version
here because the tensors lie on the CPU; the CUDA kernel is held against that
plain version on the card by ``chip_smoke.py``.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu.ops import bloom_filter as jbf
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import (
    BloomFilter,
    bloom_filter_create,
    bloom_filter_deserialize,
    bloom_filter_merge,
    bloom_filter_probe,
    bloom_filter_put,
    bloom_filter_serialize,
)
from spark_rapids_jni_tpu_torch.ops import bloom_filter as tbf
from spark_rapids_jni_tpu_torch.ops import hash_cuda

from test_bloom_filter import SparkBloomOracle

MASK64 = (1 << 64) - 1


def _values(seed, n, null_frac=0.0, lo=-(2**63), hi=2**63):
    rng = np.random.RandomState(seed)
    vals = rng.randint(lo, hi, size=n, dtype=np.int64)
    vals[:4] = [0, -1, -(2**63), 2**63 - 1][: min(4, n)]
    valid = rng.rand(n) >= null_frac if null_frac else None
    return vals, valid


def _cols(vals, valid):
    """The same INT64 column in both packages."""
    jcol = jc.column([None if valid is not None and not valid[i] else int(v)
                      for i, v in enumerate(vals)], jc.INT64)
    return jcol, interop.column_from_numpy(vals, valid, tc.INT64, device="cpu")


def _longs(f):
    """A filter's words as python ints (either package)."""
    if isinstance(f, BloomFilter):
        return [int(x) for x in interop.bloom_filter_to_numpy(f)]
    return [int(x) for x in np.asarray(f.longs)]


def _oracle(num_hashes, num_longs, vals, valid=None):
    o = SparkBloomOracle(num_hashes, num_longs)
    for i, v in enumerate(vals):
        if valid is None or valid[i]:
            o.put(int(v))
    return o


def test_bit_indices_equal_jax():
    vals, _ = _values(3, 513)
    for num_hashes, num_longs in ((1, 1), (3, 16), (6, 131072), (12, 1048576)):
        got = tbf._bit_indices(torch.from_numpy(vals), num_hashes, num_longs * 64)
        want = np.asarray(jbf._bit_indices(jnp.asarray(vals), num_hashes, num_longs * 64))
        np.testing.assert_array_equal(got.numpy(), want)


def test_put_probe_match_jax_and_spark_including_false_positives():
    ins, ins_valid = _values(23, 200, null_frac=0.05)
    probes, probe_valid = _values(24, 700, null_frac=0.1)
    probes[:50] = ins[:50]
    j_ins, t_ins = _cols(ins, ins_valid)
    j_probe, t_probe = _cols(probes, probe_valid)
    # a small filter, so false positives are certain
    jf = jbf.bloom_filter_put(jbf.bloom_filter_create(3, 16), j_ins)
    tf = bloom_filter_put(bloom_filter_create(3, 16, device="cpu"), t_ins)
    oracle = _oracle(3, 16, ins, ins_valid)
    assert _longs(tf) == _longs(jf) == [x & MASK64 for x in oracle.longs]
    got = bloom_filter_probe(t_probe, tf)
    want = jbf.bloom_filter_probe(j_probe, jf)
    assert got.to_list() == want.to_list()
    spark = [oracle.might_contain(int(v)) for v in probes]
    assert got.data.tolist() == spark  # the flags under the nulls too
    assert got.to_list().count(False) > 0 and sum(spark[50:]) > 0  # false positives
    assert torch.equal(got.validity, t_probe.validity)
    assert all(bool(got.data[i]) for i in range(50) if ins_valid[i])  # no false negative


def test_serialized_bytes_equal_jax_and_cross_deserialize():
    vals, valid = _values(5, 300, null_frac=0.05)
    jcol, tcol = _cols(vals, valid)
    jf = jbf.bloom_filter_put(jbf.bloom_filter_create(5, 8), jcol)
    tf = bloom_filter_put(bloom_filter_create(5, 8, device="cpu"), tcol)
    tbuf, jbuf = bloom_filter_serialize(tf), jbf.bloom_filter_serialize(jf)
    assert tbuf == jbuf == _oracle(5, 8, vals, valid).serialize()
    assert struct.unpack(">iii", tbuf[:12]) == (1, 5, 8) and len(tbuf) == 12 + 8 * 8
    # the JAX package's bytes read by the port, and the port's read by JAX
    back = bloom_filter_deserialize(jbuf, device="cpu")
    assert (back.num_hashes, back.num_longs, back.device.type) == (5, 8, "cpu")
    assert _longs(back) == _longs(jf)
    assert _longs(jbf.bloom_filter_deserialize(tbuf)) == _longs(tf)
    assert bloom_filter_serialize(back) == jbuf


def test_merge_equals_jax_and_put_of_all():
    parts = [_values(40 + i, 100, null_frac=0.05) for i in range(4)]
    jfs, tfs = [], []
    for vals, valid in parts:
        jcol, tcol = _cols(vals, valid)
        jfs.append(jbf.bloom_filter_put(jbf.bloom_filter_create(4, 32), jcol))
        tfs.append(bloom_filter_put(bloom_filter_create(4, 32, device="cpu"), tcol))
    merged = bloom_filter_merge(tfs)
    assert _longs(merged) == _longs(jbf.bloom_filter_merge(jfs))
    all_vals = np.concatenate([p[0] for p in parts])
    all_valid = np.concatenate([p[1] for p in parts])
    whole = bloom_filter_put(bloom_filter_create(4, 32, device="cpu"),
                             interop.column_from_numpy(all_vals, all_valid, tc.INT64, "cpu"))
    assert _longs(merged) == _longs(whole)
    with pytest.raises(ValueError, match="Mismatch"):
        bloom_filter_merge([tfs[0], bloom_filter_create(4, 16, device="cpu")])
    with pytest.raises(ValueError, match="Mismatch"):
        bloom_filter_merge([tfs[0], bloom_filter_create(5, 32, device="cpu")])
    with pytest.raises(ValueError, match="at least one"):
        bloom_filter_merge([])


def test_nulls_set_no_bits_and_probe_null():
    vals = np.array([7, 8, 9], np.int64)
    none_valid = interop.column_from_numpy(vals, np.zeros(3, bool), tc.INT64, "cpu")
    f = bloom_filter_put(bloom_filter_create(3, 4, device="cpu"), none_valid)
    assert _longs(f) == [0, 0, 0, 0]
    f = bloom_filter_put(f, interop.column_from_numpy(vals[:1], None, tc.INT64, "cpu"))
    out = bloom_filter_probe(interop.column_from_numpy(
        vals, np.array([True, False, True]), tc.INT64, "cpu"), f)
    assert out.to_list()[:2] == [True, None]
    jf = jbf.bloom_filter_put(jbf.bloom_filter_create(3, 4), jc.column([7], jc.INT64))
    assert _longs(f) == _longs(jf)


def test_reput_is_idempotent():
    vals, valid = _values(9, 64, null_frac=0.1)
    col = interop.column_from_numpy(vals, valid, tc.INT64, "cpu")
    once = bloom_filter_put(bloom_filter_create(3, 4, device="cpu"), col)
    twice = bloom_filter_put(once, col)
    assert _longs(once) == _longs(twice)
    half = interop.column_from_numpy(vals[:32], valid[:32], tc.INT64, "cpu")
    assert _longs(bloom_filter_put(once, half)) == _longs(once)


@pytest.mark.parametrize("buf, match", [
    (b"\x00" * 11, "truncated"),
    (struct.pack(">iii", 2, 3, 1) + b"\x00" * 8, "version"),
    (struct.pack(">iii", 1, 3, 0), "empty"),
    (struct.pack(">iii", 1, 0, 1) + b"\x00" * 8, "hashes"),
    (struct.pack(">iii", 1, 3, 2) + b"\x00" * 8, "mismatched"),
])
def test_deserialize_validation_matches_jax(buf, match):
    with pytest.raises(ValueError, match=match):
        bloom_filter_deserialize(buf, device="cpu")
    with pytest.raises(ValueError, match=match):
        jbf.bloom_filter_deserialize(buf)


def test_create_and_column_type_validation():
    with pytest.raises(ValueError, match="empty"):
        bloom_filter_create(3, 0, device="cpu")
    with pytest.raises(ValueError, match="hashes"):
        bloom_filter_create(0, 4, device="cpu")
    f = bloom_filter_create(3, 4, device="cpu")
    i32 = tc.column([1, 2], tc.INT32, device="cpu")
    with pytest.raises(TypeError, match="INT64"):
        bloom_filter_put(f, i32)
    with pytest.raises(TypeError, match="INT64"):
        bloom_filter_probe(i32, f)


def test_create_and_deserialize_default_to_the_card():
    buf = struct.pack(">iii", 1, 3, 1) + b"\x00" * 8
    if torch.cuda.is_available():
        assert bloom_filter_create(3, 1).device.type == "cuda"
        assert bloom_filter_deserialize(buf).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bloom_filter_create(3, 1)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bloom_filter_deserialize(buf)


# (num_hashes, num_longs, rows, path): the scatter path while num_bits <= 8 *
# indices (ADVICE.md:3), the sorted path above, both sides of the boundary
PUT_PATHS = [
    (3, 8, 512, "scatter"),  # a dense insert
    (3, 1 << 15, 60, "sorted"),  # 2^21 bits, 180 indices
    (3, 32, 256 // 3 + 1, "scatter"),  # 2048 bits <= 8 * 258
    (4, 32, 64, "scatter"),  # exactly at the boundary: 2048 == 8 * 256
    (4, 32, 63, "sorted"),  # one row short: 2048 > 8 * 252
]


@pytest.mark.parametrize("num_hashes, num_longs, n, path", PUT_PATHS)
def test_put_paths_match_jax_and_spark(num_hashes, num_longs, n, path):
    vals, valid = _values(77 + n, n, null_frac=0.1)
    jcol, tcol = _cols(vals, valid)
    before = dict(tbf.put_paths)
    tf = bloom_filter_put(bloom_filter_create(num_hashes, num_longs, device="cpu"), tcol)
    assert tbf.put_paths[path] == before[path] + 1
    jf = jbf.bloom_filter_put(jbf.bloom_filter_create(num_hashes, num_longs), jcol)
    want = [x & MASK64 for x in _oracle(num_hashes, num_longs, vals, valid).longs]
    assert _longs(tf) == _longs(jf) == want
    got = bloom_filter_probe(tcol, tf).to_list()
    assert got == jbf.bloom_filter_probe(jcol, jf).to_list()
    assert all(g for g in got if g is not None)  # no false negatives


def test_both_put_paths_agree_word_for_word():
    vals, valid = _values(31, 400, null_frac=0.2)
    for num_hashes, num_longs in ((3, 8), (5, 1 << 12)):
        num_bits = num_longs * 64
        idx = tbf._bit_indices(torch.from_numpy(vals), num_hashes, num_bits)
        idx = torch.where(torch.from_numpy(valid)[None, :], idx, num_bits).reshape(-1)
        sorted_ = tbf._put_sorted(idx, num_bits)
        assert torch.equal(sorted_, tbf._put_scatter_bits(idx, num_bits))
        jidx = jbf._bit_indices(jnp.asarray(vals), num_hashes, num_bits)
        jidx = jnp.where(jnp.asarray(valid)[None, :], jidx, num_bits).reshape(-1)
        np.testing.assert_array_equal(sorted_.numpy().view(np.uint64),
                                      np.asarray(jbf._put_sorted(jidx, num_bits)))


def test_cpu_filters_launch_no_kernel():
    hash_cuda.reset_launches()
    vals, _ = _values(2, 32)
    col = interop.column_from_numpy(vals, None, tc.INT64, "cpu")
    f = bloom_filter_put(bloom_filter_create(2, 2, device="cpu"), col)
    bloom_filter_probe(col, f)
    assert hash_cuda.launches["mm_hash_long"] == 0


def test_interop_port_bloom_filter():
    vals, valid = _values(12, 150, null_frac=0.05)
    jcol, tcol = _cols(vals, valid)
    jf = jbf.bloom_filter_put(jbf.bloom_filter_create(6, 16), jcol)
    tf = interop.port_bloom_filter(jf, device="cpu")
    assert (tf.num_hashes, tf.num_longs, tf.longs.dtype) == (6, 16, torch.int64)
    back = interop.bloom_filter_to_numpy(tf)
    assert back.dtype == np.uint64
    np.testing.assert_array_equal(back, np.asarray(jf.longs))
    assert bloom_filter_probe(tcol, tf).to_list() == jbf.bloom_filter_probe(jcol, jf).to_list()
