"""The port's order-tier primitives (``spark_rapids_jni_tpu_torch/plans/
window.py``) against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and go through both packages.  Ranks
are compared as bits: the port carries them as int64 tensors, the JAX package
as ``uint64``, and numpy's ``.view(np.uint64)`` makes them one type.
Permutations, run starts, ranks and integer window sums must be equal; float
running sums add in XLA:CPU's order (a base-16 blocked scan) and are held bit
for bit too, at the scan's block edges, with signed zeros and infinities (a
NaN only has to be a NaN: XLA:CPU leaves its sign to operand order).  Min and
max are exact in any order and are held bit for bit, signed zeros and NaNs
included.  Splitters must be the same python
ints, and range partitions the same.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spark_rapids_jni_tpu.plans.window as jwin
import spark_rapids_jni_tpu_torch.plans.window as win

INT_DTYPES = [np.int8, np.int16, np.int32, np.int64]
FLOAT_DTYPES = [np.float32, np.float64]
SPECIALS = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -1.5]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(t):
    """A port rank tensor as the JAX package's uint64."""
    return t.numpy().view(np.uint64)


def _column(dtype, n, seed):
    """``n`` values of ``dtype`` from a seed; floats carry every special value
    and repeats, integers their extremes and repeats."""
    rng = np.random.RandomState(seed)
    if dtype == np.bool_:
        return rng.rand(n) < 0.5
    if np.issubdtype(dtype, np.floating):
        x = (rng.randn(n) * 100).astype(dtype)
        at = rng.choice(n, 3 * len(SPECIALS), replace=False)
        x[at] = np.array(SPECIALS * 3, dtype)
        x[rng.choice(n, n // 4)] = x[: n // 4]  # ties
        return x
    info = np.iinfo(dtype)
    x = rng.randint(info.min, int(info.max) + 1, n).astype(dtype)
    x[:2] = [info.min, info.max]
    x[rng.choice(n, n // 4)] = x[: n // 4]
    return x


ALL_DTYPES = INT_DTYPES + [np.bool_] + FLOAT_DTYPES


# ------------------------------------------------------------- sort ranks


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("ascending", [True, False])
def test_sort_rank_bits_equal_jax(dtype, ascending):
    x = _column(dtype, 257, seed=7)
    want = np.asarray(jwin.sort_rank(jnp.asarray(x), ascending))
    assert want.dtype == np.uint64
    got = win.sort_rank(_t(x), ascending)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(win.sort_rank_np(x, ascending), want)
    np.testing.assert_array_equal(win.sort_rank_np(x, ascending),
                                  jwin.sort_rank_np(x, ascending))


def test_sort_rank_float_special_values_total_order():
    """Spark's float order: -inf < ... < -0.0 == +0.0 < ... < +inf < NaN,
    every NaN payload one value."""
    weird_nan = np.frombuffer(np.uint64(0x7FF0000000000001).tobytes(), np.float64)[0]
    x = np.array([np.nan, np.inf, 1.5, 0.0, -0.0, -1.5, -np.inf, np.nan, weird_nan])
    r = _bits(win.sort_rank(_t(x)))
    np.testing.assert_array_equal(r, np.asarray(jwin.sort_rank(jnp.asarray(x))))
    assert r[0] == r[7] == r[8]
    assert (r[0] > np.delete(r, [0, 7, 8])).all()
    assert r[3] == r[4]
    assert r[6] < r[5] < r[3] < r[2] < r[1] < r[0]


def test_signed_key_orders_like_unsigned_ranks():
    x = _column(np.int64, 300, seed=3)
    r = win.sort_rank(_t(x), False)
    by_signed = torch.sort(win.signed_key(r), stable=True).indices.numpy()
    np.testing.assert_array_equal(by_signed, np.argsort(_bits(r), kind="stable"))
    for v in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1):
        want = np.array([v], np.uint64).view(np.int64) ^ np.int64(-(1 << 63))
        assert win.signed_splitter(v) == int(want[0])


# --------------------------------------------------------- permutations


@pytest.mark.parametrize("dtype", ALL_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("ascending", [True, False])
def test_order_permutation_equals_jax_lexsort(dtype, ascending):
    rng = np.random.RandomState(11)
    major = rng.randint(0, 4, 300).astype(np.int64)
    minor = _column(dtype, 300, seed=12)
    valid = rng.rand(300) > 0.2
    jranks = [jwin.sort_rank(jnp.asarray(major)), jwin.sort_rank(jnp.asarray(minor), ascending)]
    ranks = [win.sort_rank(_t(major)), win.sort_rank(_t(minor), ascending)]
    want = np.asarray(jwin.order_permutation(jranks, jnp.asarray(valid)))
    got = win.order_permutation(ranks, _t(valid))
    np.testing.assert_array_equal(got.numpy(), want)


def test_order_permutation_stable_and_invalid_last():
    keys = np.array([5, 1, 5, 1, 5], np.int64)
    valid = np.array([True, True, False, True, True])
    perm = win.order_permutation([win.sort_rank(_t(keys))], _t(valid))
    np.testing.assert_array_equal(perm.numpy(), [1, 3, 0, 4, 2])


# ------------------------------------------------------------ sorted runs


def _sorted_case(seed, n=200):
    """Sorted partition and order keys with ties and trailing invalid rows, as
    the emitters see them after their sort."""
    rng = np.random.RandomState(seed)
    part = np.sort(rng.randint(0, 6, n)).astype(np.int64)
    order = rng.randint(0, 5, n).astype(np.int64)
    valid = np.ones(n, bool)
    valid[-n // 8:] = False
    return part, order, valid


def _runs_both(part, order, valid):
    pr_j = [jwin.sort_rank(jnp.asarray(part))]
    or_j = [jwin.sort_rank(jnp.asarray(order), False)]
    rs_j = jwin.run_boundaries(pr_j, jnp.asarray(valid))
    oc_j = jwin.change_points(or_j)
    pr = [win.sort_rank(_t(part))]
    orr = [win.sort_rank(_t(order), False)]
    rs = win.run_boundaries(pr, _t(valid))
    oc = win.change_points(orr)
    return (rs_j, oc_j), (rs, oc)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_runs_and_rank_functions_equal_jax(seed):
    (rs_j, oc_j), (rs, oc) = _runs_both(*_sorted_case(seed))
    np.testing.assert_array_equal(rs.numpy(), np.asarray(rs_j))
    np.testing.assert_array_equal(oc.numpy(), np.asarray(oc_j))
    pairs = [
        (win.segment_start_indices(rs), jwin.segment_start_indices(rs_j)),
        (win.row_number(rs), jwin.row_number(rs_j)),
        (win.rank(rs, oc), jwin.rank(rs_j, oc_j)),
        (win.dense_rank(rs, oc), jwin.dense_rank(rs_j, oc_j)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_invalid_rows_open_their_own_runs():
    part = np.array([3, 3, 3, 3], np.int64)
    valid = np.array([True, True, False, False])
    rs = win.run_boundaries([win.sort_rank(_t(part))], _t(valid))
    np.testing.assert_array_equal(rs.numpy(), [True, False, True, False])


def test_rank_and_dense_rank_tie_semantics():
    ovals = np.array([9, 9, 7, 7, 7, 4], np.int64)
    run_start = _t(np.array([1, 0, 0, 0, 0, 0], bool))
    ochange = win.change_points([win.sort_rank(_t(ovals), False)])
    np.testing.assert_array_equal(win.rank(run_start, ochange).numpy(), [1, 1, 3, 3, 3, 6])
    np.testing.assert_array_equal(win.dense_rank(run_start, ochange).numpy(),
                                  [1, 1, 2, 2, 2, 3])


def test_zero_rows():
    empty = torch.zeros(0, dtype=torch.int64)
    rs = win.change_points([empty])
    assert rs.shape == (0,) and rs.dtype == torch.bool
    assert win.row_number(rs).shape == (0,)
    assert win.dense_rank(rs, rs).shape == (0,)
    assert win.framed_sum(empty, rs).shape == (0,)
    assert win.framed_minmax(empty, rs, "max").shape == (0,)
    assert win.framed_minmax(empty, rs, "min", 3).shape == (0,)
    assert win.order_permutation([empty], rs).shape == (0,)


# ------------------------------------------------------ framed aggregates


def _starts(n, at):
    s = np.zeros(n, bool)
    s[list(at)] = True
    return s


@pytest.mark.parametrize("dtype", INT_DTYPES + [np.bool_], ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("preceding", [None, 0, 1, 3, 10])
def test_framed_sum_integers_equal_jax(dtype, preceding):
    v = _column(dtype, 40, seed=5)
    starts = _starts(40, (0, 7, 8, 30))
    want = np.asarray(jwin.framed_sum(jnp.asarray(v), jnp.asarray(starts), preceding))
    got = win.framed_sum(_t(v), _t(starts), preceding).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if dtype == np.int64:  # and the window slices themselves (wrapping as int64)
        for i in range(40):
            s = int(np.flatnonzero(starts[:i + 1])[-1])
            lo = s if preceding is None else max(s, i - preceding)
            assert got[i] == v[lo:i + 1].sum(), (i, preceding)


def _assert_float_bits_equal(got, want):
    """Bit for bit, NaN signs aside: XLA:CPU leaves a NaN's sign to its vector
    units' operand order, so NaN rows only have to be NaN in both."""
    assert got.dtype == want.dtype and got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(_float_bits(got)[~nan], _float_bits(want)[~nan])


def _float_bits(a):
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


# float sums add in XLA:CPU's order (a base-16 blocked scan), so they equal
# the JAX package bit for bit
@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("preceding", [None, 0, 1, 3, 10])
def test_framed_sum_floats_within_rounding_of_jax(dtype, preceding):
    rng = np.random.RandomState(9)
    v = (rng.randn(60) * 100).astype(dtype)
    starts = _starts(60, (0, 5, 6, 33))
    want = np.asarray(jwin.framed_sum(jnp.asarray(v), jnp.asarray(starts), preceding))
    got = win.framed_sum(_t(v), _t(starts), preceding).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(_float_bits(got), _float_bits(want))


SCAN_LENGTHS = [1, 2, 15, 16, 17, 255, 256, 257, 4097]


def _scan_input(dtype, n, case):
    """Wide-magnitude floats of length ``n``; ``case`` puts a -0.0 first and
    at the start of a later block, or sprinkles +-inf and NaN."""
    rng = np.random.RandomState(1000 + n)
    v = (rng.randn(n) * 10.0 ** rng.randint(-3, 6, n)).astype(dtype)
    if case == "neg_zero":
        v[0] = -0.0
        v[16 * (n // 32)] = -0.0  # a later block's first row (row 0 when n < 32)
    elif case == "specials":
        k = max(1, n // 7)
        v[rng.randint(0, n, k)] = rng.choice(
            np.array([np.inf, -np.inf, np.nan, -0.0], dtype), k)
    return v


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n", SCAN_LENGTHS)
@pytest.mark.parametrize("case", ["plain", "neg_zero", "specials"])
def test_framed_sum_float_scan_order_equals_jax(dtype, n, case):
    """Unbounded and bounded frames over one run and over several, at the
    block edges of XLA:CPU's scan."""
    v = _scan_input(dtype, n, case)
    for starts in (_starts(n, (0,)), _starts(n, sorted({0, n // 3, n // 2}))):
        for preceding in (None, 3):
            want = np.asarray(jwin.framed_sum(jnp.asarray(v), jnp.asarray(starts), preceding))
            got = win.framed_sum(_t(v), _t(starts), preceding).numpy()
            _assert_float_bits_equal(got, want)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES, ids=lambda d: np.dtype(d).name)
def test_framed_sum_signed_zeros_as_xla(dtype):
    """One row comes back as it is (-0.0 stays); from two rows on the fold
    starts from a zero, so a leading -0.0 comes back as +0.0."""
    starts1, starts2 = _starts(1, (0,)), _starts(2, (0,))
    one = win.framed_sum(_t(np.array([-0.0], dtype)), _t(starts1)).numpy()
    two = win.framed_sum(_t(np.array([-0.0, 1.0], dtype)), _t(starts2)).numpy()
    assert np.signbit(one[0]) and not np.signbit(two[0])
    for v, s in ((np.array([-0.0], dtype), starts1), (np.array([-0.0, 1.0], dtype), starts2)):
        want = np.asarray(jwin.framed_sum(jnp.asarray(v), jnp.asarray(s)))
        _assert_float_bits_equal(win.framed_sum(_t(v), _t(s)).numpy(), want)


@pytest.mark.parametrize("dtype", INT_DTYPES + FLOAT_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("kind", ["min", "max"])
@pytest.mark.parametrize("preceding", [None, 0, 2, 64])
def test_framed_minmax_bits_equal_jax(dtype, kind, preceding):
    v = _column(dtype, 50, seed=6)
    starts = _starts(50, (0, 1, 17, 44))
    want = np.asarray(jwin.framed_minmax(jnp.asarray(v), jnp.asarray(starts), kind,
                                         preceding))
    got = win.framed_minmax(_t(v), _t(starts), kind, preceding).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got.view(f"u{got.itemsize}"), want.view(f"u{want.itemsize}"))


@pytest.mark.parametrize("kind", ["min", "max"])
def test_framed_minmax_signed_zeros_as_xla(kind):
    """XLA orders -0.0 before +0.0 in min and max; every mix of zeros gives
    XLA's sign, in both frame forms."""
    v = np.array([0.0, -0.0, 0.0, -0.0, -0.0, 0.0, 0.0, -0.0], np.float64)
    starts = _starts(8, (0, 4))
    for preceding in (None, 1, 3):
        want = np.asarray(jwin.framed_minmax(jnp.asarray(v), jnp.asarray(starts), kind,
                                             preceding))
        got = win.framed_minmax(_t(v), _t(starts), kind, preceding).numpy()
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))


# --------------------------------------------------------- the splitters


def _ranks_of(x):
    return [win.sort_rank_np(np.asarray(x, np.int64), True)]


def _same_splitters(rank_cols, valid, nparts, **kw):
    got = win.choose_splitters(rank_cols, valid, nparts, **kw)
    want = jwin.choose_splitters(rank_cols, valid, nparts, **kw)
    assert got == want
    assert all(type(v) is int for s in got for v in s)
    np.testing.assert_array_equal(win.range_partition(rank_cols, got),
                                  jwin.range_partition(rank_cols, want))
    return got


@pytest.mark.parametrize("nparts", [1, 2, 4, 7])
@pytest.mark.parametrize("sample_cap", [16, 4096])
def test_splitters_and_partitions_equal_jax(nparts, sample_cap):
    rng = np.random.RandomState(3)
    keys = rng.randint(-1000, 1000, 5000)
    valid = rng.rand(5000) > 0.1
    spl = _same_splitters(_ranks_of(keys), valid, nparts, sample_cap=sample_cap)
    assert len(spl) == nparts - 1


def test_range_partition_concat_is_globally_sorted():
    rng = np.random.RandomState(4)
    keys = rng.randint(-500, 500, 2000).astype(np.int64)
    rk = _ranks_of(keys)
    parts = win.range_partition(rk, _same_splitters(rk, np.ones(2000, bool), 5))
    chunks = [np.sort(keys[parts == p]) for p in range(5)]
    np.testing.assert_array_equal(np.concatenate(chunks), np.sort(keys))


def test_heavy_skew_duplicate_splitters_still_partition_correctly():
    keys = np.concatenate([np.full(9000, 42, np.int64), np.arange(1000, dtype=np.int64)])
    rk = _ranks_of(keys)
    parts = win.range_partition(rk, _same_splitters(rk, np.ones(len(keys), bool), 8))
    assert len(np.unique(parts[keys == 42])) == 1


def test_empty_and_all_invalid_inputs_yield_usable_splitters():
    rk = _ranks_of(np.zeros(0, np.int64))
    assert len(_same_splitters(rk, np.zeros(0, bool), 3)) == 2
    assert win.range_partition(rk, [(0,), (0,)]).shape == (0,)
    assert len(_same_splitters(_ranks_of(np.arange(10)), np.zeros(10, bool), 3)) == 2


def test_float_and_multi_key_splitters_equal_jax():
    keys = _column(np.float64, 700, seed=21)
    b = np.random.RandomState(8).randint(0, 1000, 700).astype(np.int64)
    rk = [win.sort_rank_np(keys, True), win.sort_rank_np(b, False)]
    _same_splitters(rk, np.ones(700, bool), 4)
    np.testing.assert_array_equal(_bits(win.sort_rank(_t(keys))), rk[0])
