"""The PyTorch port's flagship query step against the JAX package, on the CPU.

Both packages get the same seeded numpy batch; sums, counts, bloom bits and
probe hits must agree exactly (tolerance 0: integer aggregation).  The JAX
side runs under both hash backends, ``xla`` and ``pallas`` (interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config
from spark_rapids_jni_tpu.models import nds as jax_nds
from spark_rapids_jni_tpu.parallel.shuffle import quantized_rows as jax_quantized_rows
from spark_rapids_jni_tpu_torch.models import QueryStepConfig, local_query_step
from spark_rapids_jni_tpu_torch.models import make_example_batch
from spark_rapids_jni_tpu_torch.models.nds import _umod
from spark_rapids_jni_tpu_torch.ops import xxhash64_raw_int64
from spark_rapids_jni_tpu_torch.parallel import quantized_rows

# the config __graft_entry__.entry() compile-checks, and one whose bucket and
# bit counts are not powers of two
CONFIGS = {
    "entry": (256, 1 << 12, 3),
    "non_pow2": (1000, 5003, 4),
}


def _batch(n, seed):
    """Keys mostly in [0, 2**20) like make_example_batch, plus full-range and
    negative keys; values in [0, 1000)."""
    rng = np.random.RandomState(seed)
    keys = rng.randint(0, 1 << 20, n, dtype=np.int64)
    keys[: n // 8] = rng.randint(-(2**63), 2**63, n // 8, dtype=np.int64)
    values = rng.randint(0, 1000, n, dtype=np.int64)
    return keys, values


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
@pytest.mark.parametrize("logical", [700, 1500])
def test_local_query_step_matches_jax(logical, cfg_name, backend):
    n = quantized_rows(logical, 1)
    nb, bits, k = CONFIGS[cfg_name]
    keys, values = _batch(n, seed=logical)
    with config.override(hash_backend=backend):
        want = jax_nds.local_query_step(
            jnp.asarray(keys), jnp.asarray(values),
            jax_nds.QueryStepConfig(n_buckets=nb, bloom_bits=bits, bloom_hashes=k))
    got = local_query_step(torch.from_numpy(keys), torch.from_numpy(values),
                           QueryStepConfig(n_buckets=nb, bloom_bits=bits, bloom_hashes=k))
    for name, g, w in zip(("sums", "counts", "bits", "probe_hits"), got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert int(got[1].sum()) == n and int(got[3]) == n
    assert int(got[0].sum()) == int(values.sum())
    # the unsigned bucket reduction is exercised: some hashes have the top bit set
    assert bool((xxhash64_raw_int64(torch.from_numpy(keys)) < 0).any())


@pytest.mark.parametrize("m", [1, 3, 1000, 1024, 5003, 2**31 - 1])
def test_umod_is_unsigned(m):
    vals = [0, 1, 2**63 - 1, 2**63, 2**64 - 1, 0x9E3779B185EBCA87, 12345678901234567]
    h = torch.tensor([v - (1 << 64) if v >> 63 else v for v in vals], dtype=torch.int64)
    assert _umod(h, m).tolist() == [v % m for v in vals]


def test_umod_rejects_out_of_range_moduli():
    h = torch.zeros(2, dtype=torch.int64)
    for m in (0, -1, 2**31):
        with pytest.raises(ValueError, match="modulus"):
            _umod(h, m)


def test_quantized_rows_matches_jax():
    for n in (0, 1, 700, 1500, 4096, 4097):
        for mult in (1, 3, 8):
            assert quantized_rows(n, mult) == jax_quantized_rows(n, mult), (n, mult)
    assert (quantized_rows(700, 1), quantized_rows(1500, 1)) == (1024, 2048)


def test_make_example_batch_is_seeded_and_in_range():
    k1, v1 = make_example_batch(4096, seed=3, device="cpu")
    k2, v2 = make_example_batch(4096, seed=3, device="cpu")
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert k1.dtype == v1.dtype == torch.int64 and k1.device.type == "cpu"
    assert 0 <= int(k1.min()) and int(k1.max()) < (1 << 20)
    assert 0 <= int(v1.min()) and int(v1.max()) < 1000
    k3, _ = make_example_batch(4096, seed=4, device="cpu")
    assert not torch.equal(k1, k3)
