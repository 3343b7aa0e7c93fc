"""The PyTorch port's 128/256-bit integer helpers and DECIMAL128 arithmetic
against the JAX package, Spark's algorithms re-run in python ints
(``tests/spark_oracles.py``) and the ``DecimalUtilsTest`` vectors, on the CPU.

Inputs are seeded (numpy or python's ``random``) and handed to both packages;
every comparison is bit-exact (tolerance 0): overflow flags, the (hi, lo)
words, validity.  The JAX package compiles one program per (op, scales,
interim) configuration, so each configuration gets one call over many rows.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.columnar.column import decimal128_column as jdecimal128_column
from spark_rapids_jni_tpu.ops import decimal128 as jdec
from spark_rapids_jni_tpu.utils import int128 as j128
from spark_rapids_jni_tpu.utils import int256 as j256
from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch import interop
from spark_rapids_jni_tpu_torch.ops import decimal128 as tdec
from spark_rapids_jni_tpu_torch.utils import int128 as t128
from spark_rapids_jni_tpu_torch.utils import int256 as t256

from spark_oracles import dec_add_sub, dec_divide, dec_multiply, dec_remainder

M64 = (1 << 64) - 1
# the carry, borrow and sign edges of 128-bit words
EDGES = [0, 1, -1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63, -(1 << 63),
         (1 << 64) - 1, 1 << 64, -(1 << 64), (1 << 127) - 1, -(1 << 127), -(1 << 127) + 1,
         10**38, -(10**38), 10**38 - 1, -(10**38) + 1, 10**19, -(10**19)]


def _words(vals):
    """python ints -> (hi int64, lo uint64) numpy words (two's complement)."""
    hi = np.array([((v & ((1 << 128) - 1)) >> 64) for v in vals], dtype=np.uint64)
    lo = np.array([v & M64 for v in vals], dtype=np.uint64)
    return hi.view(np.int64), lo


def _t(a):
    return interop.tensor_from_numpy(a, "cpu")


def _edge_values(seed, n):
    rng = random.Random(seed)
    vals = list(EDGES)
    while len(vals) < n:
        bits = rng.choice([8, 31, 32, 33, 63, 64, 65, 96, 126, 127])
        vals.append(rng.randrange(-(1 << bits), 1 << bits))
    return vals


def _eq(got, want):
    """A torch tensor (u64 bits in int64 where ``want`` is uint64) equals a
    JAX or numpy array exactly."""
    want = np.asarray(want)
    g = got.numpy()
    if want.dtype == np.uint64:
        g = g.view(np.uint64)
    elif want.dtype == np.uint32:
        g = g.astype(np.uint32)
    np.testing.assert_array_equal(g, want)


# --- int128 --------------------------------------------------------------------


def test_int128_helpers_equal_jax_at_the_edges():
    vals = _edge_values(1, 96)
    hi, lo = _words(vals)
    th, tl = _t(hi), _t(lo)
    jh, jl = jnp.asarray(hi), jnp.asarray(lo)
    ds = np.array([0, 1, 2, 7, (1 << 32) - 1, (1 << 62)] * 16, dtype=np.int64)
    for fn in ("add_small", "sub_small"):
        g = getattr(t128, fn)(th, tl, _t(ds))
        w = getattr(j128, fn)(jh, jl, jnp.asarray(ds))
        _eq(g[0], w[0]), _eq(g[1], w[1])
    for fn in ("neg", "abs_"):
        g, w = getattr(t128, fn)(th, tl), getattr(j128, fn)(jh, jl)
        _eq(g[0], w[0]), _eq(g[1], w[1])
    for k in (1, 10, 1000000007, (1 << 32) - 1):
        g, w = t128.mul_small(th, tl, k), j128.mul_small(jh, jl, k)
        _eq(g[0], w[0]), _eq(g[1], w[1])
    # every value against every edge, and against itself
    order = np.random.RandomState(2).permutation(len(vals))
    for bh, bl in ((hi[order], lo[order]), (hi, lo)):
        for fn in ("lt", "gt", "eq"):
            _eq(getattr(t128, fn)(th, tl, _t(bh), _t(bl)),
                getattr(j128, fn)(jh, jl, jnp.asarray(bh), jnp.asarray(bl)))
    _eq(t128.count_digits(th, tl), j128.count_digits(jh, jl))
    for v in (0, 1, -1, 1 << 63, -(1 << 127), 10**38):
        h, lw = t128.const128(v)
        jh_, jl_ = j128.const128(v)
        assert (h, lw & M64) == (int(jh_), int(jl_))


# --- int256 --------------------------------------------------------------------


def _limbs(vals):
    hi, lo = _words(vals)
    return (t256.from_i128(_t(hi), _t(lo)), j256.from_i128(jnp.asarray(hi), jnp.asarray(lo)),
            hi, lo)


def test_int256_helpers_equal_jax_at_the_edges():
    vals = _edge_values(3, 64)
    ta, ja, hi, lo = _limbs(vals)
    tb, jb, _, _ = _limbs(vals[::-1])
    _eq(ta, ja)
    for fn in ("add", "multiply", "lt_unsigned", "gte_unsigned", "eq256"):
        _eq(getattr(t256, fn)(ta, tb), getattr(j256, fn)(ja, jb))
    for fn in ("negate", "abs256", "is_negative", "precision10",
               "is_greater_than_decimal_38", "to_i64"):
        _eq(getattr(t256, fn)(ta), getattr(j256, fn)(ja))
    sq_t, sq_j = t256.multiply(ta, ta), j256.multiply(ja, ja)  # up to 2**254
    _eq(sq_t, sq_j)
    _eq(t256.precision10(sq_t), j256.precision10(sq_j))
    _eq(t256.add_small(ta, -7), j256.add_small(ja, -7))
    g, w = t256.to_i128(ta), j256.to_i128(ja)
    _eq(g[0], w[0]), _eq(g[1], w[1])
    ks = np.array([0, 1, 38, 76, 77, -3] * 11, dtype=np.int32)[:64]
    _eq(t256.pow_ten(torch.from_numpy(ks), ta), j256.pow_ten(jnp.asarray(ks), ja))
    _eq(t256.pow_ten(38, ta), j256.pow_ten(38, ja))
    np.testing.assert_array_equal(t256.const256(-(10**40)),
                                  j256.const256(-(10**40)).astype(np.int64))


def test_int256_division_equals_jax():
    vals = _edge_values(5, 48)
    n_t, n_j, _, _ = _limbs(vals)
    n_t, n_j = t256.multiply(n_t, n_t), j256.multiply(n_j, n_j)  # 256-bit numerators
    rng = random.Random(6)
    ds = [rng.choice([1, -1, 3, 10**19, -(10**38) + 7, (1 << 126) + 5, -(1 << 64)])
          for _ in vals]
    dh, dl = _words(ds)
    tdh, tdl, jdh, jdl = _t(dh), _t(dl), jnp.asarray(dh), jnp.asarray(dl)
    q_t, rh_t, rl_t = t256.divide(n_t, tdh, tdl)
    q_j, rh_j, rl_j = j256.divide(n_j, jdh, jdl)
    _eq(q_t, q_j), _eq(rh_t, rh_j), _eq(rl_t, rl_j)
    _eq(t256.divide_and_round(n_t, tdh, tdl), j256.divide_and_round(n_j, jdh, jdl))
    _eq(t256.integer_divide(n_t, tdh, tdl), j256.integer_divide(n_j, jdh, jdl))
    # unsigned: |n| by |d|
    ad = [abs(d) for d in ds]
    ah, al = _words(ad)
    q_t, rh_t, rl_t = t256.divide_unsigned(t256.abs256(n_t), _t(ah), _t(al))
    q_j, rh_j, rl_j = j256.divide_unsigned(j256.abs256(n_j), jnp.asarray(ah), jnp.asarray(al))
    _eq(q_t, q_j), _eq(rh_t, rh_j), _eq(rl_t, rl_j)
    # rounding from remainders at the doubled-remainder overflow edges
    rs = [rng.choice([0, 1, -1, (1 << 126), -(1 << 126), (1 << 127) - 1, d // 2, -(d // 2)])
          for d in ds]
    rh, rl = _words(rs)
    neg = np.array([r < 0 for r in rs])
    _eq(t256.round_from_remainder(n_t, _t(rh), _t(rl), torch.from_numpy(neg), tdh, tdl),
        j256.round_from_remainder(n_j, jnp.asarray(rh), jnp.asarray(rl), jnp.asarray(neg),
                                  jdh, jdl))


# --- decimal entry points against JAX --------------------------------------------


def _unscaled(rng, n, max_digits, zero_every=0):
    out = []
    for i in range(n):
        if zero_every and i % zero_every == 3:
            out.append(0)
            continue
        v = rng.randint(0, 10 ** rng.randint(1, max_digits) - 1)
        out.append(-v if rng.random() < 0.5 else v)
    return out


SPECIALS = [0, 1, -1, 10**38 - 1, -(10**38) + 1, 10**37, -(10**37), 10**19, 5, -5]


def _pair(seed, n, sa, sb, b_digits=38, zero_every=0, null_every=0):
    """Decimal(38, sa) and (38, sb) columns in both packages; specials first,
    every ``null_every``-th row null in a."""
    rng = random.Random(seed)
    ua = SPECIALS + _unscaled(rng, n - len(SPECIALS), 38)
    ub = SPECIALS[::-1] + _unscaled(rng, n - len(SPECIALS), b_digits, zero_every)
    if zero_every:
        ub[0] = 0
    a_vals = [None if null_every and i % null_every == 1 else v for i, v in enumerate(ua)]
    ja = jdecimal128_column(a_vals, 38, sa)
    jb = jdecimal128_column(ub, 38, sb)
    return ja, jb, interop.port_column(ja, "cpu"), interop.port_column(jb, "cpu"), ua, ub


def _same(got, want):
    """Two (overflow, result) pairs equal: flags, words and validity."""
    for g, w in zip(got, want):
        wf = interop.port_column(w, "cpu")
        if hasattr(g, "hi"):
            assert torch.equal(g.hi, wf.hi) and torch.equal(g.lo, wf.lo)
            assert g.dtype == wf.dtype
        else:
            assert torch.equal(g.data, wf.data) and g.dtype == wf.dtype
        assert g.to_list() == w.to_list()


@pytest.mark.parametrize("interim", [True, False])
def test_multiply128_equals_jax(interim):
    ja, jb, ta, tb, _, _ = _pair(11 + interim, 160, 10, 10, null_every=20)
    _same(tdec.multiply128(ta, tb, 6, interim), jdec.multiply128(ja, jb, 6, interim))


# (a scale, b scale, quotient scale, branch of dec128_divider)
DIVIDE_BRANCHES = [
    (4, 2, 0, "shift <= 38"),  # n_shift_exp = -2
    (2, 2, 0, "no shift"),
    (10, 0, 0, "n_shift_exp > 0"),
    (0, 38, 2, "shift > 38"),
]


@pytest.mark.parametrize("sa, sb, qs, branch", DIVIDE_BRANCHES)
def test_divide128_branches_equal_jax(sa, sb, qs, branch):
    ja, jb, ta, tb, _, _ = _pair(20 + qs + sa, 96, sa, sb, b_digits=18, zero_every=17,
                                 null_every=30)
    _same(tdec.divide128(ta, tb, qs), jdec.divide128(ja, jb, qs))


@pytest.mark.parametrize("sa, sb", [(6, 3), (0, 4)])
def test_integer_divide128_equals_jax(sa, sb):
    ja, jb, ta, tb, _, _ = _pair(30 + sa, 96, sa, sb, b_digits=12, zero_every=13,
                                 null_every=25)
    _same(tdec.integer_divide128(ta, tb), jdec.integer_divide128(ja, jb))


# (a scale, b scale, remainder scale): d_shift_exp > 0, then <= 0 with the
# numerator shifted down, not at all and up
REMAINDER_BRANCHES = [(3, 5, 1), (6, 3, 3), (3, 3, 3), (3, 3, 6)]


@pytest.mark.parametrize("sa, sb, rs", REMAINDER_BRANCHES)
def test_remainder128_branches_equal_jax(sa, sb, rs):
    ja, jb, ta, tb, _, _ = _pair(40 + sa + sb + rs, 96, sa, sb, b_digits=15, zero_every=19,
                                 null_every=23)
    _same(tdec.remainder128(ta, tb, rs), jdec.remainder128(ja, jb, rs))


@pytest.mark.parametrize("sub", [False, True])
def test_add_sub128_equal_jax(sub):
    ja, jb, ta, tb, _, _ = _pair(50 + sub, 128, 2, 6, null_every=16)
    fn_t, fn_j = (tdec.subtract128, jdec.subtract128) if sub else (tdec.add128, jdec.add128)
    _same(fn_t(ta, tb, 4), fn_j(ja, jb, 4))


# --- a wider sweep against the python oracles ------------------------------------


def _check_oracle(result, expected):
    ov, res = result
    got_ov = ov.to_list()
    got = res.unscaled_to_list() if hasattr(res, "hi") else res.to_list()
    for i, (eov, ev) in enumerate(expected):
        assert got_ov[i] == eov, (i, got_ov[i], eov)
        if not eov and ev is not None:
            assert got[i] == ev, (i, got[i], ev)


@pytest.mark.parametrize("interim, sa, sb, ps", [
    (True, 2, 3, 4), (False, 2, 3, 4), (True, 18, 18, 36), (False, 10, 10, 6),
    (True, 0, 1, 6)])
def test_multiply128_sweep_against_oracle(interim, sa, sb, ps):
    rng = random.Random(100 + sa + ps + interim)
    ua, ub = _unscaled(rng, 300, 38), _unscaled(rng, 300, 38)
    a, b = tc.decimal128_column(ua, 38, sa, "cpu"), tc.decimal128_column(ub, 38, sb, "cpu")
    _check_oracle(tdec.multiply128(a, b, ps, interim),
                  [dec_multiply(x, y, sa, sb, ps, interim) for x, y in zip(ua, ub)])


@pytest.mark.parametrize("sa, sb, qs", [(4, 2, 0), (4, 2, 5), (4, 2, 10), (0, 38, 2),
                                        (10, 0, 0), (17, 17, 17)])
def test_divide128_sweep_against_oracle(sa, sb, qs):
    rng = random.Random(200 + sa + qs)
    ua, ub = _unscaled(rng, 200, 38), _unscaled(rng, 200, 18, zero_every=29)
    a, b = tc.decimal128_column(ua, 38, sa, "cpu"), tc.decimal128_column(ub, 38, sb, "cpu")
    _check_oracle(tdec.divide128(a, b, qs),
                  [dec_divide(x, y, sa, sb, qs) for x, y in zip(ua, ub)])
    ov, q = tdec.integer_divide128(a, b)
    for i, (x, y) in enumerate(zip(ua, ub)):
        eov, ev = dec_divide(x, y, sa, sb, 0, int_div=True)
        assert ov.to_list()[i] == eov
        if not eov:
            assert q.to_list()[i] == ((ev + 2**63) % 2**64) - 2**63  # low-64-bit wrap


@pytest.mark.parametrize("sa, sb, rs", [(3, 3, 0), (3, 3, 2), (3, 3, 6), (3, 5, 1),
                                        (0, 1, 1), (2, 3, 3)])
def test_remainder128_sweep_against_oracle(sa, sb, rs):
    rng = random.Random(300 + sa + sb + rs)
    ua, ub = _unscaled(rng, 200, 38), _unscaled(rng, 200, 15, zero_every=31)
    a, b = tc.decimal128_column(ua, 38, sa, "cpu"), tc.decimal128_column(ub, 38, sb, "cpu")
    _check_oracle(tdec.remainder128(a, b, rs),
                  [dec_remainder(x, y, sa, sb, rs) for x, y in zip(ua, ub)])


@pytest.mark.parametrize("sub, sa, sb, ts", [(False, 2, 6, 4), (True, 2, 6, 4),
                                             (False, 10, 0, 9), (True, 0, 0, 0)])
def test_add_sub128_sweep_against_oracle(sub, sa, sb, ts):
    rng = random.Random(400 + sa + sb + ts + sub)
    ua, ub = _unscaled(rng, 300, 38), _unscaled(rng, 300, 38)
    a, b = tc.decimal128_column(ua, 38, sa, "cpu"), tc.decimal128_column(ub, 38, sb, "cpu")
    fn = tdec.subtract128 if sub else tdec.add128
    _check_oracle(fn(a, b, ts), [dec_add_sub(x, y, sa, sb, ts, sub) for x, y in zip(ua, ub)])


def test_nulls_and_scale_errors():
    a = tc.decimal128_column([10**37, None, 5], 38, 0, "cpu")
    b = tc.decimal128_column([10**2, 3, None], 38, 0, "cpu")
    ov, res = tdec.multiply128(a, b, 0)
    assert ov.to_list() == [True, None, None] and res.unscaled_to_list()[1:] == [None, None]
    assert res.dtype == tc.DType(tc.Kind.DECIMAL128, 38, 0)
    with pytest.raises(ValueError, match="too far apart"):
        tdec.add128(tc.decimal128_column([1], 38, 0, "cpu"),
                    tc.decimal128_column([1], 38, 78, "cpu"), 0)
    ov, res = tdec.add128(tc.decimal128_column([25, -25], 38, 2, "cpu"),
                          tc.decimal128_column([0, 0], 38, 2, "cpu"), 1)
    assert res.unscaled_to_list() == [3, -3]  # HALF_UP ties


# --- DecimalUtilsTest vectors (tests/test_decimal128.py) ---------------------------


def _dstr(s):
    """Java BigDecimal string -> (unscaled int, scale)."""
    from decimal import Decimal

    sign, digits, exp = Decimal(s).as_tuple()
    return int("".join(map(str, digits))) * (-1 if sign else 1), -exp


def _dcol(strings):
    vs = [_dstr(s) for s in strings]
    (scale,) = {sc for _, sc in vs}
    return tc.decimal128_column([v for v, _ in vs], 38, scale, "cpu")


DECIMAL_UTILS_VECTORS = [
    ("remainder2", "remainder128",
     ["-80968577325845461854951721352418610.13", "-80968577325845461854951721352418610.13",
      "-66686472768705331734321352506496901.71"],
     ["6749200345857154099505910298895800952.1", "-6749200345857154099505910298895800952.1",
      "-43880265997097383351377368851255372.5"], 2,
     ["-80968577325845461854951721352418610.13", "-80968577325845461854951721352418610.13",
      "-22806206771607948382943983655241529.21"]),
    ("remainder7", "remainder128", ["5776949384953805890688943467625198736"],
     ["-67337920196996830.354487679299"], 7, ["16310460742282291.8108019"]),
    ("remainder10", "remainder128", ["5776949384953805890688943467625198736"],
     ["-6733792019699683035.4487679299"], 10, ["3585222007130884413.9709383255"]),
    ("div21", "divide128",
     ["60250054953505368.439892586764888491018", "91910085134512953.335347579448489062875",
      "51312633107598808.869351260608653423886"],
     ["97982875273794447.385070145919990343867", "94478503341597285.814104936062234698349",
      "92266075543848323.800466593082956765923"], 6, ["0.614904", "0.972815", "0.556138"]),
    ("addPrecision38ScaleNeg10WithOverflow", "add128",
     ["9191008513307131620269245301.1615457290", "-9191008513307131620269245301.1615457290"],
     ["9447850332473678680446404122.5624623187", "-9447850332473678680446404122.5624623187"],
     10, [None, None]),
    ("addDifferentScales", "add128",
     ["9191008513307131620269245301.1615457290", "-9191008513307131620269245301.1615457290",
      "577694938495380589068894346.7625198736", "-7949989536398283250841565918.6123449781",
      "-569260079419403643627836417.1451349695", "4268696962649098725873162852.3422176564",
      "948521076935839001259204571.1574829065", "-9299778357834801251892834048.0026057082",
      "8127384240098008972235509102.7063990819", "-1012433127481465711031073593.0625063701"],
     ["451635271134476686911387864.48", "-9037370400215680718822505020.06",
      "-200173438757934601210092407.67", "3022290197578200820919308997.64",
      "388221337108432989001879408.73", "-9119163961520067341639997328.82",
      "7732813484881363300406806463.83", "5941454871287785414686091453.79",
      "-357209139972312354271434821.33", "-857448828702886587693936536.21"], 9,
     ["9642643784441608307180633165.641545729", "-18228378913522812339091750321.221545729",
      "377521499737445987858801939.092519874", "-4927699338820082429922256920.972344978",
      "-181038742310970654625957008.415134970", "-4850466998870968615766834476.477782344",
      "8681334561817202301666011034.987482907", "-3358323486547015837206742594.212605708",
      "7770175100125696617964074281.376399082", "-1869881956184352298725010129.272506370"]),
    ("mulTestOverflow", "multiply128", ["50000000000000000000000000000000000000"], ["2"], 0,
     [None]),
    ("addTestOverflow", "add128", ["99999999999999999999999999999999999999"], ["1"], 0,
     [None]),
    ("subTestOverflow", "subtract128", ["-99999999999999999999999999999999999999"], ["1"], 0,
     [None]),
]


@pytest.mark.parametrize("name, op, lhs, rhs, scale, expected", DECIMAL_UTILS_VECTORS,
                         ids=[v[0] for v in DECIMAL_UTILS_VECTORS])
def test_decimal_utils_vectors(name, op, lhs, rhs, scale, expected):
    ov, res = getattr(tdec, op)(_dcol(lhs), _dcol(rhs), scale)
    # None marks an overflow row, whose value is not checked
    assert ov.to_list() == [e is None for e in expected]
    got = res.unscaled_to_list()
    for g, e in zip(got, expected):
        if e is not None:
            assert (g, scale) == _dstr(e)


def test_decimal_utils_divide_and_remainder_singles():
    # divComplex, div17, intDivideNotOverflow, remainder1 (tests/test_decimal128.py)
    a = tc.decimal128_column([100000000000000000000000000000000], 38, 0, "cpu")
    b = tc.decimal128_column([30000000000000000000000000000000000000], 38, 37, "cpu")
    ov, q = tdec.divide128(a, b, 6)
    assert ov.to_list() == [False]
    assert q.unscaled_to_list() == [33333333333333333333333333333333333333]
    a = tc.decimal128_column([145448287885760884146, 365554438423288356646], 38, 17, "cpu")
    b = tc.decimal128_column([10000000000000000000] * 2, 38, 17, "cpu")
    assert tdec.divide128(a, b, 17)[1].unscaled_to_list() == [1454482878857608841,
                                                               3655544384232883566]
    a = tc.decimal128_column([45163527113447668691138786448,
                              531367597027056008632983715318], 38, 2, "cpu")
    b = tc.decimal128_column([-961110, 181958], 38, 3, "cpu")
    ov, q = tdec.integer_divide128(a, b)
    assert ov.to_list() == [False, False]
    assert q.to_list() == [2284624887606872042, -2928582767902049472]
    lv, rv = 2775750723350045263458396405825339066, 48909906375893403075126224011491788141
    a = tc.decimal128_column([lv, lv, -lv, -lv], 38, 0, "cpu")
    b = tc.decimal128_column([-rv, rv, -rv, rv], 38, 1, "cpu")
    ov, r = tdec.remainder128(a, b, 1)
    assert ov.to_list() == [False] * 4
    assert r.unscaled_to_list() == [lv * 10, lv * 10, -lv * 10, -lv * 10]
    ov, r = tdec.remainder128(tc.decimal128_column([45163527113447668691138786448], 38, 2,
                                                   "cpu"),
                              tc.decimal128_column([-961110], 38, 3, "cpu"), 3)
    assert r.unscaled_to_list() == [268860]
