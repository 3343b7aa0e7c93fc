"""The PyTorch port's integer binary64 arithmetic (``utils.softfloat``), its
unsigned-64 lane helpers (``utils.u64``) and its copy of the Ryu tables,
against the JAX package and python ints on the CPU.

Seeded numpy inputs go through both packages; every comparison is bit-exact
(tolerance 0).  The u64 edges (2**63 - 1, 2**63, 10**19 - 1, 2**64 - 1) and
the shift counts 0, 1, 63 and 64 are covered where a call site can reach
them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu.utils import ryu_tables as jrt
from spark_rapids_jni_tpu.utils import softfloat as jsf
from spark_rapids_jni_tpu_torch.utils import int256 as t256
from spark_rapids_jni_tpu_torch.utils import ryu_tables as trt
from spark_rapids_jni_tpu_torch.utils import softfloat as tsf
from spark_rapids_jni_tpu_torch.utils import u64

M64 = (1 << 64) - 1
U64_EDGES = [0, 1, 2, 9, 10, 2**32 - 1, 2**32, 2**52, 2**53 - 1, 2**53, 2**53 + 1, 2**62,
             2**63 - 1, 2**63, 2**63 + 1, 10**19 - 1, 10**19, 2**64 - 2, 2**64 - 1]


def _t(a):
    """numpy -> CPU tensor, u64 as int64 bits."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int64) if a.dtype == np.uint64 else a.copy())


def _u64_inputs(seed, n=3000):
    rng = np.random.RandomState(seed)
    bits = rng.randint(-(2**63), 2**63, n, dtype=np.int64).view(np.uint64)
    narrow = rng.randint(0, 2**53, n // 4, dtype=np.int64).view(np.uint64)
    around = (np.uint64(1) << rng.randint(1, 64, n // 4).astype(np.uint64)) + \
        rng.randint(-3, 4, n // 4).astype(np.int64).view(np.uint64)
    return np.concatenate([np.array(U64_EDGES, dtype=np.uint64), bits, narrow, around])


def _f64_bits(seed, n=3000):
    """Finite doubles of every magnitude, subnormals, zeros, infs and NaN."""
    rng = np.random.RandomState(seed)
    with np.errstate(over="ignore"):
        vals = np.concatenate([
            rng.uniform(-1e3, 1e3, n // 3),
            rng.uniform(1, 10, n // 3) * 10.0 ** rng.randint(-320, 309, n // 3),
            [0.0, -0.0, 5e-324, -5e-324, 2.2250738585072014e-308, 1.7976931348623157e308,
             np.inf, -np.inf, np.nan, 1.0, 0.1, 3.4028235e38, 3.5e38, 1.401298464324817e-45,
             7.006492321624085e-46, 1e-46]])
    bits = vals.view(np.int64)
    return np.concatenate([bits, rng.randint(-(2**63), 2**63, n // 3, dtype=np.int64)])


def _eq(got: torch.Tensor, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(got.numpy().dtype))


def test_u64_to_f64_bits_equals_jax_reading_inputs_unsigned():
    x = _u64_inputs(1)
    got = tsf.u64_to_f64_bits(_t(x))
    _eq(got, jsf.u64_to_f64_bits(jnp.asarray(x)))
    # 2**63 and above read as large positive values, never negative
    for v in (2**63, 10**19 - 1, 2**64 - 1):
        (g,) = tsf.u64_to_f64_bits(torch.tensor([u64.s64(v)])).view(torch.float64).tolist()
        assert g == float(v)


@pytest.mark.parametrize("op", ["mul", "div"])
def test_mul_and_div_bits_equal_jax(op):
    a = _f64_bits(2)
    b = np.roll(_f64_bits(3), 7)
    t_fn, j_fn = {"mul": (tsf.f64_mul_bits, jsf.f64_mul_bits),
                  "div": (tsf.f64_div_bits, jsf.f64_div_bits)}[op]
    _eq(t_fn(_t(a), _t(b)), j_fn(jnp.asarray(a), jnp.asarray(b)))


def test_f64_bits_to_f32_bits_equals_jax_and_the_hardware_cast():
    a = _f64_bits(4)
    got = tsf.f64_bits_to_f32_bits(_t(a))
    _eq(got, jsf.f64_bits_to_f32_bits(jnp.asarray(a)))
    with np.errstate(over="ignore"):
        hw = a.view(np.float64).astype(np.float32)
    finite = ~np.isnan(hw)
    np.testing.assert_array_equal(got.numpy()[finite], hw.view(np.int32)[finite])


def test_from_parts_rounds_like_jax_at_the_subnormal_edge():
    rng = np.random.RandomState(5)
    n = 512
    sign = rng.randint(0, 2, n).astype(np.int64)
    e_unb = rng.randint(-1100, 1100, n).astype(np.int32)
    mant = (rng.randint(0, 2**52, n, dtype=np.int64) | (1 << 52)).view(np.uint64)
    guard = rng.randint(0, 2, n).astype(np.uint64)
    sticky = rng.rand(n) < 0.5
    got = tsf.f64_from_parts(_t(sign), _t(e_unb), _t(mant), _t(guard), _t(sticky))
    want = jsf.f64_from_parts(jnp.asarray(sign), jnp.asarray(e_unb), jnp.asarray(mant),
                              jnp.asarray(guard), jnp.asarray(sticky))
    _eq(got, want)


def test_u64_helpers_equal_python_ints():
    x = _u64_inputs(6, 200)
    xs = [int(v) for v in x]
    tx = _t(x)
    for k in (0, 1, 4, 19, 32, 63, 64):
        assert [v & M64 for v in u64.shr(tx, k).tolist()] == [v >> k for v in xs]
        assert [v & M64 for v in u64.shl(tx, k).tolist()] == \
            [(v << k) & M64 if k < 64 else 0 for v in xs]
    # per-lane counts, 0 past 63 and below 0 (the XLA semantics)
    ks = torch.tensor([0, 1, 63, 64, 65, -1] * (len(xs) // 6 + 1))[:len(xs)]
    want_r = [v >> k if 0 <= k < 64 else 0 for v, k in zip(xs, ks.tolist())]
    want_l = [(v << k) & M64 if 0 <= k < 64 else 0 for v, k in zip(xs, ks.tolist())]
    assert [v & M64 for v in u64.shr(tx, ks).tolist()] == want_r
    assert [v & M64 for v in u64.shl(tx, ks).tolist()] == want_l
    for d in (1, 5, 10, 10**9, 5**19, 2**62 + 1, 2**63 - 1):
        q, r = u64.divmod_const(tx, d)
        assert [v & M64 for v in q.tolist()] == [v // d for v in xs]
        assert [v & M64 for v in r.tolist()] == [v % d for v in xs]
    ds = np.resize(np.array([1, 10, 5**23, 10**18, 10**19, 2**63, 2**64 - 1], dtype=np.uint64),
                   len(xs))
    q, r = u64.divmod_tensor(tx, _t(ds))
    assert [v & M64 for v in q.tolist()] == [v // int(d) for v, d in zip(xs, ds)]
    assert [v & M64 for v in r.tolist()] == [v % int(d) for v, d in zip(xs, ds)]
    ys = xs[::-1]
    ty = _t(np.array(ys, dtype=np.uint64))
    assert u64.ult(tx, ty).tolist() == [a < b for a, b in zip(xs, ys)]
    assert u64.uge(tx, ty).tolist() == [a >= b for a, b in zip(xs, ys)]
    hi, lo = u64.umul128(tx, ty)
    assert [((h & M64) << 64) | (lo_ & M64) for h, lo_ in zip(hi.tolist(), lo.tolist())] == \
        [a * b for a, b in zip(xs, ys)]


def test_int256_divide_reads_a_top_bit_divisor_unsigned():
    """10**19 is above 2**63: the limb divider must read its low word as
    unsigned (the JAX package's decimal -> string split divides by it)."""
    rng = np.random.RandomState(8)
    vals = [10**38 - 1, 10**19, 10**19 - 1, 2**127 - 1, 0, 1] + \
        [int(v) * 10**19 + int(w) for v, w in zip(rng.randint(0, 2**62, 26, dtype=np.int64),
                                                   rng.randint(0, 2**62, 26, dtype=np.int64))]
    n = torch.stack([torch.from_numpy(t256.const256(v)) for v in vals])
    d_lo = torch.full((len(vals),), u64.s64(10**19), dtype=torch.int64)
    q, r_hi, r_lo = t256.divide_unsigned(n, torch.zeros_like(d_lo), d_lo)
    q_hi, q_lo = t256.to_i128(q)
    got_q = [((h & M64) << 64) | (lo & M64) for h, lo in zip(q_hi.tolist(), q_lo.tolist())]
    got_r = [((h & M64) << 64) | (lo & M64) for h, lo in zip(r_hi.tolist(), r_lo.tolist())]
    assert got_q == [v // 10**19 for v in vals]
    assert got_r == [v % 10**19 for v in vals]


def test_ryu_tables_are_the_jax_packages():
    for name in ("DOUBLE_POW5_SPLIT_LO", "DOUBLE_POW5_SPLIT_HI", "DOUBLE_POW5_INV_SPLIT_LO",
                 "DOUBLE_POW5_INV_SPLIT_HI", "FLOAT_POW5_SPLIT", "FLOAT_POW5_INV_SPLIT"):
        np.testing.assert_array_equal(getattr(trt, name), getattr(jrt, name))
    assert (trt.DOUBLE_POW5_BITCOUNT, trt.FLOAT_POW5_INV_BITCOUNT) == (125, 61)
