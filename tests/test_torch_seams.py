"""The port's entry points cross the JAX package's seams, in the same order.

The fault injector and the profiler act only at seams, keyed by category and
name, so a chaos config or a profile filter written for one package must see
the same crossings in the other.  Each case records every ``(category,
name)`` crossing through each package's injector hook while the same numpy
inputs (seeded) go through both packages, and holds the ordered lists equal
and the outputs bit-equal (tolerance 0):

- the four column constructors, each crossing its own TRANSFER seam;
- ``parse_uri_query_literal``, whose needle is a ``strings_column``;
- the flagship distributed step, q97 and q97 over nullable columns, each
  built once and called twice on a (1, 1) mesh: the JAX package crosses
  ``all_to_all_shuffle`` while jit traces the step, once per signature;
- ``run_distributed_q3_columns`` twice on the same data: its step is built
  once (COMPILE), and each run uploads (TRANSFER) and launches (COLLECTIVE).

The internal callers of the constructors (a parquet split's strings, the
serving engine's ``get_json_object`` handler) cross the same seams too.  An
injected fault at a crossing raises in both packages alike.  No rank is
spawned: the port's meshes are one-rank gloo groups.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_jni_tpu import columnar as jax_columnar
from spark_rapids_jni_tpu import io as jax_io
from spark_rapids_jni_tpu import mem as jax_mem
from spark_rapids_jni_tpu import serve as jax_serve
from spark_rapids_jni_tpu.models import nds as jax_nds
from spark_rapids_jni_tpu.models import q3 as jax_q3
from spark_rapids_jni_tpu.models import q97 as jax_q97
from spark_rapids_jni_tpu.obs import seam as jax_seam
from spark_rapids_jni_tpu.obs.faultinj import FaultInjector as JaxFaultInjector
from spark_rapids_jni_tpu.ops import parse_uri as jax_parse_uri
from spark_rapids_jni_tpu.parallel import make_mesh as jax_make_mesh
from spark_rapids_jni_tpu_torch import columnar, mem
from spark_rapids_jni_tpu_torch import io as port_io
from spark_rapids_jni_tpu_torch import serve as port_serve
from spark_rapids_jni_tpu_torch.models import nds, q3, q97
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q3_data
from spark_rapids_jni_tpu_torch.obs import seam
from spark_rapids_jni_tpu_torch.obs.faultinj import FaultInjector
from spark_rapids_jni_tpu_torch.ops import parse_uri
from spark_rapids_jni_tpu_torch.parallel import one_rank_mesh

COLLECTIVE_SHUFFLE = ("collective", "all_to_all_shuffle")
STEP_CFG = (64, 1 << 10, 3, 0)  # n_buckets, bloom_bits, bloom_hashes, shuffle_capacity


class _Pkg:
    """One package's side of a case: its modules, and how it makes a mesh, a
    step input and a column, so that a case is written once for both."""

    def __init__(self, name):
        self.port = name == "port"
        self.seam = seam if self.port else jax_seam
        self.columnar = columnar if self.port else jax_columnar
        self.nds, self.q3, self.q97 = (nds, q3, q97) if self.port else (jax_nds, jax_q3, jax_q97)
        self.mem = mem if self.port else jax_mem
        self.parse_uri = parse_uri if self.port else jax_parse_uri
        self.injector = FaultInjector if self.port else JaxFaultInjector
        self.kw = {"device": "cpu"} if self.port else {}

    @contextlib.contextmanager
    def mesh(self):
        if self.port:
            with one_rank_mesh("cpu") as m:
                yield m
        else:
            yield jax_make_mesh((1, 1), devices=jax.devices()[:1])

    def put(self, mesh, a):
        """A data-sharded step input."""
        if self.port:
            return torch.from_numpy(np.ascontiguousarray(a))
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("data")))

    def int32_column(self, mesh, data, valid):
        c = self.columnar
        return c.Column(self.put(mesh, data), None if valid is None else self.put(mesh, valid),
                        c.INT32)


PKGS = {"port": _Pkg("port"), "jax": _Pkg("jax")}


@contextlib.contextmanager
def _recorded(seam_mod):
    """Every crossing of ``seam_mod``'s seam, in order, passed on to the
    injector installed before (if any)."""
    seen = []
    prev = seam_mod._injector

    def record(category, name):
        seen.append((category, name))
        if prev is not None:
            prev(category, name)

    seam_mod._set_injector(record)
    try:
        yield seen
    finally:
        seam_mod._set_injector(prev)


@contextlib.contextmanager
def _injecting(pkg, config):
    pkg.injector.install(config)
    try:
        yield
    finally:
        pkg.injector.uninstall()


def _numpy(x):
    """A port or JAX output as plain data: tensors and arrays as numpy, named
    tuples and columns field by field."""
    if hasattr(x, "_fields"):
        return {f: _numpy(getattr(x, f)) for f in x._fields}
    if isinstance(x, list):
        return [_numpy(v) for v in x]
    return np.asarray(x) if hasattr(x, "dtype") else x


def _require_same(got, want, what=""):
    if isinstance(want, dict):
        assert list(got) == list(want), what
        for k in want:
            _require_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _require_same(g, w, f"{what}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what


# --- the cases: (package) -> (crossings, outputs) ------------------------------


def _values(seed, n=200):
    rng = np.random.RandomState(seed)
    nulls = rng.rand(n) < 0.1
    return rng, nulls


def _column_case(pkg):
    rng, nulls = _values(1)
    vals = [None if z else int(v) for z, v in zip(nulls, rng.randint(-2**31, 2**31, 200))]
    with _recorded(pkg.seam) as seen:
        col = pkg.columnar.column(vals, pkg.columnar.INT32, **pkg.kw)
    return seen, col.to_list()


def _decimal128_case(pkg):
    rng, nulls = _values(2)
    his = rng.randint(-2**62, 2**62, 200, dtype=np.int64)
    vals = [None if z else int(h) * (1 << 64) + int(lo)
            for z, h, lo in zip(nulls, his, rng.randint(0, 2**63, 200, dtype=np.int64))]
    with _recorded(pkg.seam) as seen:
        col = pkg.columnar.decimal128_column(vals, 38, 2, **pkg.kw)
    return seen, col.to_list()


def _strings(seed, n=200):
    rng, nulls = _values(seed, n)
    return [None if z else "".join(chr(c) for c in rng.randint(32, 0x3000, rng.randint(0, 12)))
            for z in nulls]


def _strings_from_bytes_case(pkg):
    vals = [None if s is None else s.encode("utf-8") for s in _strings(3)]
    with _recorded(pkg.seam) as seen:
        col = pkg.columnar.strings_from_bytes(vals, **pkg.kw)
    return seen, col.to_list()


def _strings_column_case(pkg):
    vals = _strings(4)
    with _recorded(pkg.seam) as seen:
        col = pkg.columnar.strings_column(vals, **pkg.kw)
    return seen, col.to_list()


def _urls(seed, n=64):
    """``n`` seeded URLs of at most 32 bytes: one bucket shape in the JAX
    package."""
    rng = np.random.RandomState(seed)
    keys, hosts = ["id", "q", "a", "idx"], ["a.io", "x.org", "h.com"]
    out = []
    for _ in range(n):
        q = "&".join(f"{keys[rng.randint(4)]}={rng.randint(100)}" for _ in range(rng.randint(3)))
        out.append(f"http://{hosts[rng.randint(3)]}/p?{q}"[:32] if rng.rand() > 0.1 else None)
    return out


def _parse_uri_case(pkg):
    col = pkg.columnar.strings_column(_urls(5), **pkg.kw)
    with _recorded(pkg.seam) as seen:
        out = pkg.parse_uri.parse_uri_query_literal(col, "id")
    return seen, out.to_list()


def _twice(pkg, build, args):
    """Build a step on a (1, 1) mesh, then call it twice with the arrays
    ``args(pkg, mesh)`` gives."""
    with pkg.mesh() as mesh, _recorded(pkg.seam) as seen:
        step = build(mesh)
        inputs = args(pkg, mesh)
        outs = [_numpy(step(*inputs)) for _ in range(2)]
    return seen, outs


def _step_inputs(pkg, mesh):
    rng = np.random.RandomState(6)
    keys = rng.randint(0, 1 << 20, 256, dtype=np.int64)
    keys[::9] = rng.randint(-(2**63), 2**63, len(keys[::9]), dtype=np.int64)
    return [pkg.put(mesh, keys), pkg.put(mesh, rng.randint(0, 1000, 256, dtype=np.int64))]


def _query_step_case(pkg):
    return _twice(pkg, lambda mesh: pkg.nds.make_distributed_query_step(
        mesh, pkg.nds.QueryStepConfig(*STEP_CFG)), _step_inputs)


def _q97_arrays(seed, n_store=300, n_catalog=400):
    rng = np.random.RandomState(seed)
    return {"s_cust": rng.randint(1, 40, n_store).astype(np.int32),
            "s_item": rng.randint(1, 25, n_store).astype(np.int32),
            "c_cust": rng.randint(1, 40, n_catalog).astype(np.int32),
            "c_item": rng.randint(1, 25, n_catalog).astype(np.int32),
            "s_valid": rng.rand(n_store) < 0.9, "c_valid": rng.rand(n_catalog) < 0.9}


def _q97_case(pkg, with_validity):
    a = _q97_arrays(7)
    names = ["s_cust", "s_item", "c_cust", "c_item"] + (["s_valid", "c_valid"]
                                                        if with_validity else [])
    return _twice(pkg, lambda mesh: pkg.q97.make_distributed_q97(mesh, 1024, with_validity),
                  lambda pkg, mesh: [pkg.put(mesh, a[n]) for n in names])


def _q97_columns_args(pkg, mesh):
    a = _q97_arrays(8)
    rng = np.random.RandomState(9)
    valid = {"s_cust": rng.rand(300) < 0.85, "c_item": rng.rand(400) < 0.85}
    cols = [pkg.int32_column(mesh, a[n], valid.get(n)) for n in ("s_cust", "s_item", "c_cust",
                                                                  "c_item")]
    return cols + [pkg.put(mesh, a["s_valid"]), pkg.put(mesh, a["c_valid"])]


def _q97_columns_case(pkg):
    return _twice(pkg, lambda mesh: pkg.q97.make_distributed_q97_columns(mesh, 1024),
                  _q97_columns_args)


def _q3_columns_case(pkg):
    data = generate_q3_data(sf=0.02, seed=10)
    pkg.q3._q3_columns_step_cached.cache_clear()  # another file's build must not hit
    g = pkg.mem.MemoryGovernor(watchdog_period_s=0.02)
    try:
        budget = pkg.mem.BudgetedResource(g, 1 << 30)
        with pkg.mesh() as mesh, _recorded(pkg.seam) as seen:
            outs = [pkg.q3.run_distributed_q3_columns(mesh, data, budget=budget, task_id=3,
                                                      **pkg.kw) for _ in range(2)]
    finally:
        g.close()
    return seen, [[tuple(r) for r in rows] for rows in outs]


CASES = {
    "column": _column_case,
    "decimal128_column": _decimal128_case,
    "strings_from_bytes": _strings_from_bytes_case,
    "strings_column": _strings_column_case,
    "parse_uri_query_literal": _parse_uri_case,
    "query_step": _query_step_case,
    "q97": lambda pkg: _q97_case(pkg, False),
    "q97_with_validity": lambda pkg: _q97_case(pkg, True),
    "q97_columns": _q97_columns_case,
    "q3_columns": _q3_columns_case,
}
CONSTRUCTORS = ("column", "decimal128_column", "strings_from_bytes", "strings_column")
EAGER_STEPS = ("query_step", "q97", "q97_with_validity", "q97_columns")


@pytest.mark.parametrize("case", list(CASES))
def test_crossings_match_jax(case):
    port, port_out = CASES[case](PKGS["port"])
    want, jax_out = CASES[case](PKGS["jax"])
    assert port == want
    _require_same(port_out, _numpy(jax_out), case)
    if case in CONSTRUCTORS:  # each constructor crosses exactly its own seam
        assert port == [("transfer", case)]
    if case in EAGER_STEPS:  # traced once: two calls with one signature
        assert port == [COLLECTIVE_SHUFFLE]
    if case == "q3_columns":
        names = [n for _c, n in port]
        assert port.count(("compile", "q3_columns_step")) == 1
        assert port.count(("transfer", "q3_columns_batch_upload")) == 2
        assert port.count(("collective", "launch:q3_columns_step")) == 2
        assert names.index("q3_columns_step") < names.index("strings_column") \
            < names.index("q3_columns_batch_upload") < names.index("launch:q3_columns_step")


def test_strings_column_crosses_only_its_own_seam():
    """The port's strings_column and strings_from_bytes share an unseamed
    body: neither crosses the other's seam."""
    with _recorded(seam) as seen:
        columnar.strings_column(["a", None, "é"], device="cpu")
        columnar.strings_from_bytes([b"a", None], device="cpu")
    assert seen == [("transfer", "strings_column"), ("transfer", "strings_from_bytes")]


@pytest.mark.parametrize("pkg", list(PKGS))
def test_transfer_rule_on_column_raises(pkg):
    """A TRANSFER rule keyed on "column" fails every ``column`` call, and no
    other constructor's."""
    p = PKGS[pkg]
    with _injecting(p, {"transfer": {"column": {"injectionType": "exception"}}}):
        with pytest.raises(Exception, match="injected fault in column") as err:
            p.columnar.column([1, 2], p.columnar.INT32, **p.kw)
        assert type(err.value).__name__ == "InjectedException"
        assert p.columnar.strings_column(["x"], **p.kw).to_list() == ["x"]


def _faulted_shuffle(pkg):
    """A step whose first call meets a fault at its shuffle crossing: the
    call raises before any work, and the next call crosses again (a failed
    trace is traced again) and runs."""
    rule = {"all_to_all_shuffle": {"injectionType": "exception", "interceptionCount": 1}}
    with pkg.mesh() as mesh, _injecting(pkg, {"collective": rule}), \
            _recorded(pkg.seam) as seen:
        step = pkg.nds.make_distributed_query_step(mesh, pkg.nds.QueryStepConfig(*STEP_CFG))
        inputs = _step_inputs(pkg, mesh)
        with pytest.raises(Exception, match="injected fault in all_to_all_shuffle"):
            step(*inputs)
        out = _numpy(step(*inputs))
    return seen, out


def test_fault_at_the_shuffle_crossing_aborts_the_call_as_in_jax():
    port, port_out = _faulted_shuffle(PKGS["port"])
    want, jax_out = _faulted_shuffle(PKGS["jax"])
    assert port == want == [COLLECTIVE_SHUFFLE] * 2
    _require_same(port_out, _numpy(jax_out))


def _new_signature(pkg):
    """q97 built once, called with 300 + 400 rows, then with 200 + 400: a new
    signature crosses again, as a new shape is traced again."""
    a = _q97_arrays(11)
    names = ["s_cust", "s_item", "c_cust", "c_item"]
    with pkg.mesh() as mesh, _recorded(pkg.seam) as seen:
        step = pkg.q97.make_distributed_q97(mesh, 1024)
        outs = [_numpy(step(*[pkg.put(mesh, a[n][:cut] if n[0] == "s" else a[n])
                              for n in names])) for cut in (300, 300, 200)]
    return seen, outs


def test_new_signature_crosses_again_as_in_jax():
    port, port_out = _new_signature(PKGS["port"])
    want, jax_out = _new_signature(PKGS["jax"])
    assert port == want == [COLLECTIVE_SHUFFLE] * 2
    _require_same(port_out, _numpy(jax_out))


# --- internal callers of the constructors -------------------------------------


def _parquet_file(path):
    """A seeded file of an INT32, a STRING and a DECIMAL(12, 2) column with
    nulls, in two row groups."""
    import decimal

    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.RandomState(12)
    n = 300
    null = rng.rand(3, n) < 0.1
    words = ["", "a", "héllo", "x" * 20]
    pq.write_table(pa.table({
        "id": pa.array(rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32),
                       mask=null[0]),
        "name": pa.array([None if z else words[rng.randint(4)] + str(i)
                          for i, z in enumerate(null[1])]),
        "dec": pa.array([None if z else decimal.Decimal(int(v)).scaleb(-2)
                         for z, v in zip(null[2], rng.randint(-10**11, 10**11, n))],
                        pa.decimal128(12, 2)),
    }), path, row_group_size=150)


def _read_split(io_pkg, path, kw):
    b = io_pkg.StructElement.builder()
    for name in ("id", "name", "dec"):
        b = b.add_child(name, io_pkg.ValueElement())
    off, length = io_pkg.plan_byte_splits(path, 1)[0]
    return io_pkg.read_split(path, off, length, b.build(), **kw)


def test_read_split_crosses_the_jax_seams(tmp_path):
    """A parquet split's string column is built by ``strings_from_bytes`` in
    both packages."""
    path = str(tmp_path / "t.parquet")
    _parquet_file(path)
    with _recorded(seam) as port:
        got = _read_split(port_io, path, {"device": "cpu"})
    with _recorded(jax_seam) as want:
        exp = _read_split(jax_io, path, {})
    assert port == want and ("transfer", "strings_from_bytes") in port
    assert list(got) == list(exp)
    for name in got:
        assert got[name].to_list() == exp[name].to_list(), name


def _json_handler(pkg):
    """One ``get_json_object`` request through a one-worker engine with the
    built-in handlers."""
    p = PKGS[pkg]
    s = port_serve if p.port else jax_serve
    rows = ['{"a": {"b": %d}, "c": [%d, 1]}' % (i, i) for i in range(12)] + [None, "junk"]
    g = p.mem.MemoryGovernor(watchdog_period_s=0.02)
    eng = s.ServingEngine(gov=g, budget=p.mem.BudgetedResource(g, 1 << 30), workers=1,
                          builtin_handlers=True, **p.kw)
    try:
        sess = eng.open_session()
        with _recorded(p.seam) as seen:
            out = eng.submit(sess, "get_json_object", (rows, ["$.a.b", "$.c[*]"])).result(
                timeout=120)
    finally:
        eng.shutdown()
        g.close()
    return seen, out


def test_json_handler_crosses_the_jax_seams():
    """The engine's ``get_json_object`` handler builds its column with
    ``strings_column`` inside the request's governed bracket, in both
    packages."""
    port, got = _json_handler("port")
    want, exp = _json_handler("jax")
    assert port == want and ("transfer", "strings_column") in port
    assert got == exp


def test_q3_columns_step_is_built_again_for_a_new_group():
    """Two one-rank groups made in turn give equal ``DeviceMesh`` values; the
    second gets a step of its own (a COMPILE crossing, then a run over its
    live group), not the first's step over a destroyed group."""
    data = generate_q3_data(sf=0.01, seed=13)
    answers, compiles = [], []
    g = mem.MemoryGovernor(watchdog_period_s=0.02)
    try:
        budget = mem.BudgetedResource(g, 1 << 30)
        for _ in range(2):
            with one_rank_mesh("cpu") as mesh, _recorded(seam) as seen:
                answers.append(q3.run_distributed_q3_columns(mesh, data, budget=budget))
            compiles.append(seen.count(("compile", "q3_columns_step")))
    finally:
        g.close()
    assert compiles == [1, 1]
    assert answers[0] == answers[1] == q3.q3_columns_host_oracle(data)
