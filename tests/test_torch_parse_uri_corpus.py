"""The PyTorch port's ``parse_url`` core (``_parse``: validation, the host
machines and chunk selection over one padded byte rectangle) against the JAX
package's on the CPU, over the reference corpora of tests/test_parse_uri.py
(ParseURITest.java: the Spark, UTF-8, IPv4 and IPv6 rows) and a seeded fuzz.

All rows go into ONE rectangle of 256 bytes (the JAX package compiles its
``_parse`` once per shape, so the bucket driver is left out here; it is held
to the JAX package in tests/test_torch_parse_uri.py), with the query keys
padded to one width.  Tolerance 0 on the gathered bytes within each output's
length, the lengths and the validity.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from spark_rapids_jni_tpu.ops import parse_uri as jpu
from spark_rapids_jni_tpu_torch.ops import parse_uri as pu
from tests.test_parse_uri import IP4_DATA, IP6_DATA, SPARK_DATA, SPARK_QUERIES, UTF8_DATA
from tests.test_torch_parse_uri import fuzz_urls

WIDTH = 256
KEY_WIDTH = 16


def _rect(values, width):
    """(bytes[n, width] uint8, lengths int32, valid bool) of ``values``."""
    raw = [b"" if v is None else v.encode("utf-8", "surrogatepass") for v in values]
    assert max(len(r) for r in raw) < width
    out = np.zeros((len(raw), width), np.uint8)
    for i, r in enumerate(raw):
        out[i, :len(r)] = np.frombuffer(r, np.uint8)
    return out, np.array([len(r) for r in raw], np.int32), np.array(
        [v is not None for v in values])


def corpus_rows():
    rows = SPARK_DATA + UTF8_DATA + IP4_DATA + IP6_DATA + fuzz_urls(300, seed=7)
    keys = (SPARK_QUERIES + ["query"] * (len(UTF8_DATA) + len(IP4_DATA) + len(IP6_DATA))
            + [("a", "bb", "", "x", None)[i % 5] for i in range(300)])
    assert len(rows) == len(keys)
    return rows, keys


@pytest.fixture(scope="module")
def rect():
    rows, keys = corpus_rows()
    b, lens, valid = _rect(rows, WIDTH)
    kb, kl, kv = _rect(keys, KEY_WIDTH)
    lit_b, lit_l, lit_v = _rect(["query"], KEY_WIDTH)
    lit = (np.repeat(lit_b, len(rows), 0), np.repeat(lit_l, len(rows)),
           np.repeat(lit_v, len(rows)))
    return (b, lens, valid), {"none": None, "column": (kb, kl, kv), "literal": lit}


CASES = [("PROTOCOL", "none"), ("HOST", "none"), ("QUERY", "none"), ("PATH", "none"),
         ("QUERY", "literal"), ("QUERY", "column")]
_WANT = {"PROTOCOL": pu._PROTOCOL, "HOST": pu._HOST, "QUERY": pu._QUERY, "PATH": pu._PATH}


@pytest.mark.parametrize("part,needle", CASES)
def test_parse_matches_jax(rect, part, needle):
    import torch

    (b, lens, valid), needles = rect
    n = len(lens)
    nd = needles[needle]
    if nd is None:  # the placeholder key the entry points pass without one
        nd = (np.zeros((n, 1), np.uint8), np.zeros(n, np.int32), np.ones(n, bool))
    want = _WANT[part]
    jg, jl, jv = jpu._parse(jnp.asarray(b), jnp.asarray(lens), jnp.asarray(valid), want,
                            needle != "none", *(jnp.asarray(a) for a in nd))
    pg, pl, pv = pu._parse(torch.from_numpy(b), torch.from_numpy(lens),
                           torch.from_numpy(valid), want, needle != "none",
                           *(torch.from_numpy(a) for a in nd))
    jl, jv, jg = np.asarray(jl), np.asarray(jv), np.asarray(jg)
    np.testing.assert_array_equal(pv.numpy(), jv)
    np.testing.assert_array_equal(pl.numpy(), jl)
    inside = np.arange(WIDTH)[None, :] < jl[:, None]
    np.testing.assert_array_equal(np.where(inside, pg.numpy(), 0), np.where(inside, jg, 0))
    assert jv.sum() > 0
