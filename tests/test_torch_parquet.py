"""The port's parquet footer and split reader (``spark_rapids_jni_tpu_torch/io/
parquet_footer.py``, ``io/parquet_read.py``) against the JAX package's, on the
CPU.

The same pyarrow-written files (multi-row-group, with nulls, strings,
DECIMAL of every storage width, FLOAT64, DATE32 and TIMESTAMP columns) go
through both packages: every split's filtered, pruned footer must serialize
to the same bytes and keep the same row groups, and every split must decode
to the same column values, validity and dtypes.  ``write_q97_parquet`` must
write the same files, and the harness's parquet chunk stream must be the
same arrays.  Importing the port's ``io`` and ``models`` packages must not
import pyarrow: the card's host has none.
"""

import decimal
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from spark_rapids_jni_tpu import io as jio
from spark_rapids_jni_tpu.io.parquet_read import footer_bytes as jax_footer_bytes
from spark_rapids_jni_tpu.models import nds_harness as jax_harness
from spark_rapids_jni_tpu.models.tpcds import write_q97_parquet as jax_write_q97_parquet
from spark_rapids_jni_tpu_torch import io as tio
from spark_rapids_jni_tpu_torch.io.parquet_read import footer_bytes
from spark_rapids_jni_tpu_torch.models import nds_harness
from spark_rapids_jni_tpu_torch.models.tpcds import write_q97_parquet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 3000
COLUMNS = ["id", "name", "dec9", "dec18", "dec38", "price", "day", "ts"]


def _table(seed=31):
    rng = np.random.RandomState(seed)
    n = N_ROWS

    def nulls(p):
        return rng.rand(n) < p

    def decimals(digits, scale, null):
        vals = [None if null[i] else decimal.Decimal(int(v)).scaleb(-scale)
                for i, v in enumerate(rng.randint(-10**min(digits, 18), 10**min(digits, 18), n,
                                                  dtype=np.int64))]
        if digits > 18:  # reach past 64 bits
            vals = [None if v is None else v * (10 ** 19) for v in vals]
        return pa.array(vals, pa.decimal128(digits, scale))

    words = ["", "a", "héllo", "píñata", "x" * 40, "tail"]
    return pa.table({
        "id": pa.array(rng.randint(-2**31, 2**31, n, dtype=np.int64).astype(np.int32),
                       mask=nulls(0.05)),
        "name": pa.array([None if m else words[rng.randint(len(words))] + str(i)
                          for i, m in enumerate(nulls(0.1))]),
        "dec9": decimals(9, 2, nulls(0.05)),
        "dec18": decimals(18, 4, nulls(0.05)),
        "dec38": decimals(38, 6, nulls(0.05)),
        "price": pa.array(rng.randn(n) * 1e3, pa.float64(), mask=nulls(0.05)),
        "day": pa.array(rng.randint(0, 20000, n).astype(np.int32), pa.date32()),
        "ts": pa.array(rng.randint(0, 2**50, n, dtype=np.int64), pa.timestamp("us"),
                       mask=nulls(0.05)),
    })


@pytest.fixture(scope="module")
def rich_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_parquet") / "rich.parquet")
    pq.write_table(_table(), path, row_group_size=400)
    assert pq.ParquetFile(path).num_row_groups >= 7
    return path


@pytest.fixture(scope="module")
def q97_dirs(tmp_path_factory):
    port = str(tmp_path_factory.mktemp("q97_port"))
    jax = str(tmp_path_factory.mktemp("q97_jax"))
    write_q97_parquet(port, sf=0.002, seed=7, rows_per_group=1024)
    jax_write_q97_parquet(jax, sf=0.002, seed=7, rows_per_group=1024)
    return port, jax


def _schema(pkg, names, upper=False):
    b = pkg.StructElement.builder()
    for name in names:
        b = b.add_child(name.upper() if upper else name, pkg.ValueElement())
    return b.build()


SCHEMAS = {
    "full": (COLUMNS, False, False),
    "pruned": (["dec38", "id", "no_such_column"], False, False),
    "case_insensitive": (["NAME", "ts"], True, True),
}


@pytest.mark.parametrize("n_splits", [1, 2, 3, 7])
@pytest.mark.parametrize("schema", sorted(SCHEMAS))
def test_filtered_footers_equal_jax(rich_file, n_splits, schema):
    """Each split's filtered, pruned footer: the same bytes, row groups,
    columns and row count as the JAX package's."""
    names, upper, ignore_case = SCHEMAS[schema]
    fb = footer_bytes(rich_file)
    assert fb == jax_footer_bytes(rich_file)
    splits = tio.plan_byte_splits(rich_file, n_splits)
    assert splits == jio.plan_byte_splits(rich_file, n_splits)
    kept = []
    for off, length in splits:
        got = tio.ParquetFooter.read_and_filter(fb, off, length, _schema(tio, names, upper),
                                                ignore_case)
        want = jio.ParquetFooter.read_and_filter(fb, off, length, _schema(jio, names, upper),
                                                 ignore_case)
        assert got.serialize_thrift_file() == want.serialize_thrift_file()
        assert got.kept_group_indexes == want.kept_group_indexes
        assert got.column_names == want.column_names
        assert got.num_rows == want.num_rows
        assert tio.ParquetFooter.split_group_indexes(fb, off, length) == \
            jio.ParquetFooter.split_group_indexes(fb, off, length)
        kept += got.kept_group_indexes
    assert sorted(kept) == list(range(pq.ParquetFile(rich_file).num_row_groups))


def _values(col):
    """(kind, values or unscaled values with None for nulls) of a column of
    either package."""
    if hasattr(col, "hi"):
        return col.dtype.kind.name, col.unscaled_to_list()
    if hasattr(col, "chars"):
        return "STRING", col.to_list()
    data = np.asarray(col.data.numpy() if hasattr(col.data, "numpy") else col.data)
    valid = None if col.validity is None else np.asarray(
        col.validity.numpy() if hasattr(col.validity, "numpy") else col.validity)
    vals = data.tolist()
    if valid is not None:
        vals = [v if ok else None for v, ok in zip(vals, valid)]
    return (col.dtype.kind.name, col.dtype.precision, col.dtype.scale), vals


@pytest.mark.parametrize("n_splits", [1, 3])
def test_read_split_columns_equal_jax(rich_file, n_splits):
    """Every split decodes to the same values, nulls and dtypes (DECIMAL at
    each storage width, FLOAT64 as int64 bits, strings, dates, timestamps),
    on the CPU."""
    total = 0
    for off, length in tio.plan_byte_splits(rich_file, n_splits):
        got = tio.read_split(rich_file, off, length, _schema(tio, COLUMNS), device="cpu")
        want = jio.read_split(rich_file, off, length, _schema(jio, COLUMNS))
        assert list(got) == list(want) == COLUMNS
        for name in COLUMNS:
            assert got[name].device.type == "cpu"
            gk, gv = _values(got[name])
            wk, wv = _values(want[name])
            assert gk == wk, name
            assert gv == wv, name
        total += len(got["id"])
    assert total == N_ROWS


def test_iter_split_batches_equal_jax(rich_file):
    """One batch per surviving row group, as Columns and as numpy pairs."""
    schema = ["id", "dec38", "name", "price"]
    for off, length in tio.plan_byte_splits(rich_file, 2):
        got = list(tio.iter_split_batches(rich_file, off, length, _schema(tio, schema),
                                          device="cpu"))
        want = list(jio.iter_split_batches(rich_file, off, length, _schema(jio, schema)))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for name in schema:
                assert _values(g[name]) == _values(w[name])
        got_np = list(tio.iter_split_batches(rich_file, off, length, _schema(tio, schema),
                                             as_numpy=True))
        want_np = list(jio.iter_split_batches(rich_file, off, length, _schema(jio, schema),
                                              as_numpy=True))
        for g, w in zip(got_np, want_np):
            for name in schema:
                (gv, gm), (wv, wm) = g[name], w[name]
                assert list(gv) == list(wv)
                assert (gm is None and wm is None) or np.array_equal(gm, wm)


def test_read_split_defaults_to_the_card(rich_file, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    off, length = tio.plan_byte_splits(rich_file, 1)[0]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.read_split(rich_file, off, length, _schema(tio, ["id"]))
    # the numpy form touches no device
    assert tio.read_split(rich_file, off, length, _schema(tio, ["id"]), as_numpy=True)


def test_write_q97_parquet_equals_jax(q97_dirs):
    port, jax = q97_dirs
    for name in ("store_sales.parquet", "catalog_sales.parquet"):
        with open(os.path.join(port, name), "rb") as a, open(os.path.join(jax, name), "rb") as b:
            assert a.read() == b.read(), name
    assert pq.ParquetFile(os.path.join(port, "store_sales.parquet")).num_row_groups >= 3


@pytest.mark.parametrize("n_splits", [1, 2, 5])
def test_q97_parquet_chunks_equal_jax(q97_dirs, n_splits):
    """The harness's footer-planned chunk stream: the same (side, cust, item)
    arrays in the same order, and the in-memory form their concatenation."""
    port, _ = q97_dirs
    got = list(nds_harness.q97_parquet_chunks(port, n_splits))
    want = list(jax_harness.q97_parquet_chunks(port, n_splits))
    assert len(got) == len(want) > 2
    for (gs, gc, gi), (ws, wc, wi) in zip(got, want):
        assert gs == ws
        assert gc.dtype == wc.dtype == np.int32
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gi, wi)
    g_store, g_cat = nds_harness._q97_tables_from_parquet(port, n_splits)
    w_store, w_cat = jax_harness._q97_tables_from_parquet(port, n_splits)
    for g, w in zip(g_store + g_cat, w_store + w_cat):
        np.testing.assert_array_equal(g, w)


def test_importing_io_and_models_needs_no_pyarrow():
    code = (
        "import sys\n"
        "import spark_rapids_jni_tpu_torch.io, spark_rapids_jni_tpu_torch.io.parquet_read\n"
        "import spark_rapids_jni_tpu_torch.io.spill, spark_rapids_jni_tpu_torch.models\n"
        "import spark_rapids_jni_tpu_torch.models.tpcds\n"
        "import spark_rapids_jni_tpu_torch.models.streaming\n"
        "import spark_rapids_jni_tpu_torch.models.nds_harness\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] == 'pyarrow')\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"
