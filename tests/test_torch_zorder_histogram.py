"""The PyTorch port's z-order ops (``interleave_bits``, ``hilbert_index``)
and percentile ops (``create_histogram_if_valid``,
``percentile_from_histogram``) against the JAX package on the CPU, bit for
bit, and against the python oracles of tests/test_zorder.py and
tests/test_histogram.py.

Inputs are made from numpy seeds: interleave over 1-4 columns of INT8,
INT16, INT32, INT64 and FLOAT32 with nulls; hilbert at 1-10 bits per entry
over 1-6 dimensions; histograms of INT32, INT64, FLOAT32 and FLOAT64 values
with null values, null and empty lists and duplicate values, at percentages
0, 1 and between, as lists and as scalars.  Tolerance 0 everywhere (the
percentile's interpolation runs in numpy binary64 in both packages).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu.ops import histogram as jh
from spark_rapids_jni_tpu.ops import zorder as jz
from spark_rapids_jni_tpu_torch import ops
from spark_rapids_jni_tpu_torch.columnar import (
    FLOAT32,
    FLOAT64,
    INT8,
    INT16,
    INT32,
    INT64,
    Column,
    ListColumn,
    StructColumn,
    column,
)
from spark_rapids_jni_tpu_torch.ops import histogram as ph
from spark_rapids_jni_tpu_torch.ops import zorder as pz
from tests.test_histogram import percentile_oracle
from tests.test_zorder import hilbert_oracle, interleave_oracle

_NP = {"INT8": np.int8, "INT16": np.int16, "INT32": np.int32, "INT64": np.int64,
       "FLOAT32": np.float32}
_PORT_DT = {"INT8": INT8, "INT16": INT16, "INT32": INT32, "INT64": INT64, "FLOAT32": FLOAT32,
            "FLOAT64": FLOAT64}


def _values(kind, n, rng):
    if kind == "FLOAT32":
        v = (rng.standard_normal(n) * 1e3).astype(np.float32)
        v[:4] = [0.0, -0.0, np.inf, -np.inf]
        return v
    info = np.iinfo(_NP[kind])
    v = rng.integers(info.min, info.max, n, endpoint=True, dtype=np.int64).astype(_NP[kind])
    v[:3] = [info.min, -1, info.max]
    return v


def _pair(data, valid, kind):
    """A port Column (CPU) and a JAX column of the same values; FLOAT64 data
    is given as its int64 bits."""
    pv = None if valid is None else torch.from_numpy(valid.copy())
    jv = None if valid is None else jnp.asarray(valid)
    return (Column(torch.from_numpy(np.ascontiguousarray(data).copy()), pv, _PORT_DT[kind]),
            jc.Column(jnp.asarray(data), jv, getattr(jc, kind)))


def _same_fixed(p, j):
    np.testing.assert_array_equal(p.data.numpy(), np.asarray(j.data))
    if j.validity is None:
        assert p.validity is None
    else:
        np.testing.assert_array_equal(p.validity.numpy(), np.asarray(j.validity))


@pytest.mark.parametrize("kind", ["INT8", "INT16", "INT32", "INT64", "FLOAT32"])
@pytest.mark.parametrize("ncols", [1, 2, 3, 4])
def test_interleave_bits_matches_jax(kind, ncols):
    rng = np.random.default_rng(ncols * 10 + len(kind))
    n = 97
    pcols, jcols, raw = [], [], []
    for c in range(ncols):
        data = _values(kind, n, rng)
        valid = rng.random(n) > 0.1 if c != 1 else None
        p, j = _pair(data, valid, kind)
        pcols.append(p)
        jcols.append(j)
        ints = data.view(np.int32) if kind == "FLOAT32" else data
        raw.append([None if valid is not None and not valid[i] else int(ints[i])
                    for i in range(n)])
    got, want = pz.interleave_bits(pcols), jz.interleave_bits(jcols)
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    np.testing.assert_array_equal(got.child.data.numpy(), np.asarray(want.child.data))
    assert got.child.dtype.kind.value == "uint8" and got.validity is None
    width = np.dtype(_NP[kind]).itemsize * 8
    oracle = interleave_oracle(list(zip(*raw)), width)
    assert got.to_list() == oracle


@pytest.mark.parametrize("nb", range(1, 11))
def test_hilbert_index_matches_jax(nb):
    rng = np.random.default_rng(nb)
    n = 257
    for ndims in range(1, min(6, 64 // nb) + 1):
        pcols, jcols, pts = [], [], []
        for d in range(ndims):
            data = rng.integers(-(1 << 31), (1 << 31) - 1, n).astype(np.int32)
            valid = rng.random(n) > 0.1 if d % 2 == 0 else None
            p, j = _pair(data, valid, "INT32")
            pcols.append(p)
            jcols.append(j)
            pts.append([0 if valid is not None and not valid[i] else int(data[i])
                        for i in range(n)])
        got, want = pz.hilbert_index(nb, pcols), jz.hilbert_index(nb, jcols)
        _same_fixed(got, want)
        assert got.to_list() == [hilbert_oracle(nb, p) for p in zip(*pts)]


def test_hilbert_index_wide_points():
    """32 bits x 2 dims: the distance uses all 64 bits, the top one included."""
    rng = np.random.default_rng(5)
    data = [rng.integers(-(1 << 31), (1 << 31) - 1, 64).astype(np.int32) for _ in range(2)]
    pairs = [_pair(d, None, "INT32") for d in data]
    got = pz.hilbert_index(32, [p for p, _ in pairs])
    _same_fixed(got, jz.hilbert_index(32, [j for _, j in pairs]))
    assert got.to_list() == [hilbert_oracle(32, (int(a), int(b))) for a, b in zip(*data)]
    assert min(got.to_list()) < 0  # the top bit reaches the int64 sign


@pytest.mark.parametrize("nb,ndims", [(1, 2), (2, 2), (3, 2), (2, 3)])
def test_hilbert_is_a_true_hilbert_curve(nb, ndims):
    side = 1 << nb
    pts = list(itertools.product(range(side), repeat=ndims))
    cols = [column([p[d] for p in pts], INT32, device="cpu") for d in range(ndims)]
    idx = ops.hilbert_index(nb, cols).to_list()
    assert sorted(idx) == list(range(side ** ndims))
    by_idx = {i: p for i, p in zip(idx, pts)}
    for i in range(side ** ndims - 1):
        a, b = by_idx[i], by_idx[i + 1]
        assert sum(abs(x - y) for x, y in zip(a, b)) == 1


def test_zorder_validation_like_jax():
    i32 = column([1, 2], INT32, device="cpu")
    with pytest.raises(ValueError):
        pz.interleave_bits([])
    with pytest.raises(TypeError):
        pz.interleave_bits([i32, column([1, 2], INT64, device="cpu")])
    with pytest.raises(ValueError):
        pz.interleave_bits([i32, column([3], INT32, device="cpu")])
    with pytest.raises(ValueError):
        pz.hilbert_index(0, [i32])
    with pytest.raises(ValueError):
        pz.hilbert_index(33, [i32])
    with pytest.raises(ValueError):
        pz.hilbert_index(32, [i32, i32, i32])
    with pytest.raises(TypeError):
        pz.hilbert_index(4, [column([1, 2], INT64, device="cpu")])
    with pytest.raises(ValueError):
        pz.hilbert_index(4, [i32, column([3], INT32, device="cpu")])


# ---- histograms ------------------------------------------------------------

def _hist_values(kind, n, rng):
    """Seeded values with duplicates: drawn from a small pool."""
    if kind in ("FLOAT64", "FLOAT32"):
        pool = np.array([-2.5, -0.0, 0.0, 1.0, 1.5, 3.25, 1e10, -7.0, np.inf])
        v = pool[rng.integers(0, len(pool), n)]
        return v.astype(np.float32) if kind == "FLOAT32" else v
    return rng.integers(-50, 50, n).astype(_NP[kind])


def histograms(kind, n_hist, seed):
    """(port ListColumn, JAX ListColumn, python hists) of ``n_hist`` seeded
    histograms: 0-12 bins each (empty lists included), duplicate values, 10%
    null values, every fifth list row null, counts 1-9."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 13, n_hist)
    sizes[:2] = [0, 1]
    total = int(sizes.sum())
    vals = _hist_values(kind, total, rng)
    vvalid = rng.random(total) > 0.1
    counts = rng.integers(1, 10, total).astype(np.int64)
    lvalid = np.arange(n_hist) % 5 != 3
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    data = vals.view(np.int64) if kind == "FLOAT64" else vals
    pv, jv = _pair(data, vvalid, kind)
    pc, jcnt = _pair(counts, None, "INT64")
    port = ListColumn(torch.from_numpy(offsets), StructColumn((pv, pc), None),
                      torch.from_numpy(lvalid))
    jax_col = jc.ListColumn(jnp.asarray(offsets), jc.StructColumn((jv, jcnt), None),
                            jnp.asarray(lvalid))
    hists = []
    for h in range(n_hist):
        s, e = offsets[h], offsets[h + 1]
        hists.append(None if not lvalid[h] else [
            (float(vals[i]) if vvalid[i] else None, int(counts[i])) for i in range(s, e)])
    return port, jax_col, hists


PCTS = [0.0, 0.25, 0.5, 0.75, 1.0, 0.1, 0.999]


@pytest.mark.parametrize("kind", ["INT32", "INT64", "FLOAT32", "FLOAT64"])
def test_percentile_matches_jax_and_oracle(kind):
    port, jax_col, hists = histograms(kind, 64, seed=len(kind))
    for as_list in (True, False):
        got = ph.percentile_from_histogram(port, PCTS, as_list)
        want = jh.percentile_from_histogram(jax_col, PCTS, as_list)
        if as_list:
            np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
            _same_fixed(got.child, want.child)
        else:
            _same_fixed(got, want)
    lists = ph.percentile_from_histogram(port, PCTS, True).to_list()
    for h, g in zip(hists, lists):
        o = None if h is None else percentile_oracle(h, PCTS)
        if o is None or all(x is None for x in o):
            assert g == []
        else:
            assert g == o


def test_percentile_edges_like_jax():
    port, jax_col, _ = histograms("INT32", 8, seed=3)
    for pcts in ([], [0.5]):
        for as_list in (True, False):
            got = ph.percentile_from_histogram(port, pcts, as_list)
            want = jh.percentile_from_histogram(jax_col, pcts, as_list)
            if as_list:
                np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
                got, want = got.child, want.child
            _same_fixed(got, want)
    empty = ListColumn(torch.zeros(3, dtype=torch.int32),
                       StructColumn((column([], INT32, device="cpu"),
                                     column([], INT64, device="cpu")), None), None)
    assert ph.percentile_from_histogram(empty, [0.5], False).to_list() == [None, None]
    with pytest.raises(TypeError):
        ph.percentile_from_histogram(column([1], INT32, device="cpu"), [0.5], True)
    with pytest.raises(TypeError):
        ph.percentile_from_histogram(
            ListColumn(torch.tensor([0, 1], dtype=torch.int32),
                       StructColumn((column([1], INT32, device="cpu"),
                                     column([2], INT32, device="cpu")), None), None),
            [0.5], True)


@pytest.mark.parametrize("as_lists", [False, True])
@pytest.mark.parametrize("with_zero", [False, True])
def test_create_histogram_matches_jax(as_lists, with_zero):
    rng = np.random.default_rng(17 + with_zero)
    n = 200
    vals = rng.integers(-9, 9, n).astype(np.int32)
    valid = rng.random(n) > 0.15
    freqs = rng.integers(0 if with_zero else 1, 5, n).astype(np.int64)
    pv, jv = _pair(vals, valid, "INT32")
    pf, jf = _pair(freqs, None, "INT64")
    got = ph.create_histogram_if_valid(pv, pf, as_lists)
    want = jh.create_histogram_if_valid(jv, jf, as_lists)
    if as_lists:
        np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
        got, want = got.child, want.child
    for g, w in zip(got.children, want.children):
        _same_fixed(g, w)
    # and the histogram feeds the percentile the same way in both packages
    if as_lists:
        hist_p = ph.create_histogram_if_valid(pv, pf, True)
        hist_j = jh.create_histogram_if_valid(jv, jf, True)
        assert ph.percentile_from_histogram(hist_p, [0.5, 1.0], False).to_list() == \
            jh.percentile_from_histogram(hist_j, [0.5, 1.0], False).to_list()


def test_create_histogram_validation_like_jax():
    i32 = column([1], INT32, device="cpu")
    with pytest.raises(TypeError):
        ops.create_histogram_if_valid(i32, column([1], INT32, device="cpu"), False)
    with pytest.raises(ValueError):
        ops.create_histogram_if_valid(i32, column([None], INT64, device="cpu"), False)
    with pytest.raises(ValueError):
        ops.create_histogram_if_valid(i32, column([-1], INT64, device="cpu"), False)
    with pytest.raises(ValueError):
        ops.create_histogram_if_valid(column([1, 2], INT32, device="cpu"),
                                      column([1], INT64, device="cpu"), False)
    out = ops.create_histogram_if_valid(column([1, None, 7], INT32, device="cpu"),
                                        column([2, 3, 0], INT64, device="cpu"), False)
    assert out.children[1].to_list() == [2, 1, 1]
