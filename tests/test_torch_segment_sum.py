"""The port's ``segment_sum`` (``ops/agg_cuda.py``) on CPU tensors: the
device dispatch and the plain version, against numpy's ``np.add.at`` over the
kept rows and against ``jax.ops.segment_sum``, the reference's kernel.  int8,
which the kernel does not take, still sums on the CPU as the reference sums
it; the kernel's own check of its inputs is run here on CPU tensors.

Ids are drawn around the grid, so every case holds negative ids, ids equal
to ``num_segments`` and above it, and masked rows (id -1, as the plan
emitter gives them).  Float values are multiples of 1/4 with small sums, so
every order of adding gives the same bits.  The kernel itself runs on the
card only: ``tests/test_torch_agg_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu_torch.ops import agg_cuda, hash_cuda
from spark_rapids_jni_tpu_torch.plans import compiler

jax.config.update("jax_enable_x64", True)  # as the JAX package sets it: int64 stays int64

N = 3000


def _case(id_dtype, value_dtype, num_segments, seed=5):
    rng = np.random.RandomState(seed)
    ids = rng.randint(-4, num_segments + 4, N).astype(np.int64)
    ids[:6] = [-1, -num_segments - 1, num_segments, num_segments + 1,
               np.iinfo(np.int32).max, np.iinfo(np.int32).min]
    masked = rng.rand(N) < 0.3
    ids = np.where(masked, -1, ids).astype(id_dtype)
    if np.dtype(value_dtype).kind == "f":
        vals = (rng.randint(-400, 400, N) / 4).astype(value_dtype)
    else:
        vals = rng.randint(-(1 << 20), 1 << 20, N).astype(value_dtype)
    return ids, vals


@pytest.mark.parametrize("num_segments", [1, 6, 201_000])
@pytest.mark.parametrize("value_dtype", [np.int8, np.int32, np.int64, np.float32,
                                         np.float64])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_segment_sum_on_cpu_drops_out_of_range_ids_like_numpy_and_jax(
        id_dtype, value_dtype, num_segments):
    ids, vals = _case(id_dtype, value_dtype, num_segments)
    hash_cuda.reset_launches()
    got = compiler.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), num_segments)
    assert got.dtype == torch.from_numpy(vals).dtype and got.shape == (num_segments,)

    keep = (ids >= 0) & (ids < num_segments)
    want = np.zeros(num_segments, value_dtype)
    np.add.at(want, ids[keep], vals[keep])
    np.testing.assert_array_equal(got.numpy(), want)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(ids),
                                         num_segments=num_segments))
    assert ref.dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(agg_cuda.segment_sum_torch(
        torch.from_numpy(vals), torch.from_numpy(ids), num_segments).numpy(), want)

    # the check the card's branch makes before any launch: a dtype the kernel
    # does not take, a strided input
    t_vals, t_ids = torch.from_numpy(vals), torch.from_numpy(ids)
    if value_dtype == np.int8:
        with pytest.raises(TypeError, match="int32, int64, float32 or float64"):
            agg_cuda._check(t_vals, t_ids, num_segments)
        vals, t_vals = vals.astype(np.int32), t_vals.to(torch.int32)
    agg_cuda._check(t_vals, t_ids, num_segments)
    with pytest.raises(TypeError, match="int32, int64, float32 or float64"):
        agg_cuda._check(t_vals.to(torch.int16), t_ids, num_segments)
    with pytest.raises(ValueError, match="contiguous"):
        agg_cuda._check(torch.from_numpy(np.repeat(vals, 2))[::2], t_ids, num_segments)
    with pytest.raises(ValueError, match="contiguous"):
        agg_cuda._check(t_vals, torch.from_numpy(np.repeat(ids, 2))[::2], num_segments)
    assert hash_cuda.launches["segment_sum"] == 0
