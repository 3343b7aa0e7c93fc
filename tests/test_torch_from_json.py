"""The PyTorch port's ``from_json`` (raw MAP<STRING,STRING>) against the JAX
package on the CPU.

The cases of tests/test_from_json.py (the reference's MapUtilsTest) and a
seeded fuzz of objects (nested values, escapes, single quotes, whitespace
inside containers, non-object rows, nulls) go through both packages in one
call each; tolerance 0 on the list offsets, the key and value chars and
offsets, and the validity.  Malformed rows must raise JsonParsingException
at the same row in both.
"""

import numpy as np
import pytest

from spark_rapids_jni_tpu import columnar as jc
from spark_rapids_jni_tpu.ops.from_json import JsonParsingException as JJsonParsingException
from spark_rapids_jni_tpu.ops.from_json import from_json as jfrom_json
from spark_rapids_jni_tpu_torch.columnar.column import strings_column
from spark_rapids_jni_tpu_torch.ops import JsonParsingException, from_json

_S1 = ('{"Zipcode" : 704 , "ZipCodeType" : "STANDARD" , "City" : "PARC'
       ' PARQUE" , "State" : "PR"}')
_S3 = ('{"category": "reference", "index": [4,{},null,{"a":[{ }, {}] } '
       '], "author": "Nigel Rees", "title": "{}[], '
       '<=semantic-symbols-string", "price": 8.95}')
_U1 = ('{"Zipcóde" : 704 , "ZípCodeTypé" : "STANDARD" ,'
       ' "City" : "PARC PARQUE" , "Stâte" : "PR"}')
_U3 = ('{"Zipcóde" : 704 , "ZípCodeTypé" : "\U00029E3D" , "City" : "\U0001F3F3" ,'
       ' "Stâte" : "\U0001F3F3"}')

CASES = {
    "basic": [_S1, "{}", None, _S3],
    "utf8": [_U1, "{}", None, _U3],
    "nested_keys_not_extracted": ['{"a":{"x":1,"y":2},"b":[{"z":3}],"c":7}'],
    "non_object_rows": ["[1,2,3]", '"str"', "42", "true", "{}"],
    "escapes_stay_raw": ['{"k\\t1":"v\\n2"}', "{'s':'q\\'x','n':-0}"],
    "skewed_lengths": ['{"a":1}', '{"k":"' + "x" * 3000 + '"}', "{}"],
    "null_rows": [None, '{"a":1}', None],
}

_VALUES = ["1", "-0", "2.5e-3", "true", "null", '"s"', "'q'", '"a\\"b"', '"\\u00e9"',
           "[1, 2 ]", "{ }", '{"x": [ {"y": null} ]}', "[[],{}]", '"{}[]"']


def fuzz_rows(seed=5, n=160):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        if i % 11 == 3:
            rows.append(None)
            continue
        if i % 13 == 4:
            rows.append("[" + ",".join(_VALUES[:3]) + "]")
            continue
        k = int(rng.integers(0, 6))
        sep = " , " if rng.random() < 0.3 else ","
        rows.append("{" + sep.join(f'"k{j}{"x" * int(rng.integers(0, 3))}":'
                                   + _VALUES[rng.integers(len(_VALUES))] for j in range(k)) + "}")
    return rows


CASES["fuzz"] = fuzz_rows()
ROWS = [r for rows in CASES.values() for r in rows]
_OUT = {}


def _materialize(lst):
    offs = np.asarray(lst.offsets.cpu() if hasattr(lst.offsets, "cpu") else lst.offsets)
    valid = lst.is_valid()
    valid = np.asarray(valid.cpu() if hasattr(valid, "cpu") else valid)
    kids = []
    for k in lst.child.children:
        koffs = np.asarray(k.offsets.cpu() if hasattr(k.offsets, "cpu") else k.offsets)
        kchars = np.asarray(k.chars.cpu() if hasattr(k.chars, "cpu") else k.chars)
        kids.append((koffs.astype(np.int64), kchars[:int(koffs[-1])]))
    return offs.astype(np.int64), valid, kids


def _both():
    if not _OUT:
        _OUT["jax"] = _materialize(jfrom_json(jc.strings_column(ROWS)))
        _OUT["port"] = _materialize(from_json(strings_column(ROWS, device="cpu")))
    return _OUT


@pytest.mark.parametrize("part", ["list_offsets", "validity", "keys", "values"])
def test_whole_column_matches_jax(part):
    j, p = _both()["jax"], _both()["port"]
    if part == "list_offsets":
        np.testing.assert_array_equal(p[0], j[0])
    elif part == "validity":
        np.testing.assert_array_equal(p[1], j[1])
    else:
        k = 0 if part == "keys" else 1
        np.testing.assert_array_equal(p[2][k][0], j[2][k][0])
        np.testing.assert_array_equal(p[2][k][1], j[2][k][1])


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_jax(case):
    """Each case's rows alone: the port's pairs equal the JAX package's
    pairs for the same rows of the whole-column run."""
    start = 0
    for name, rows in CASES.items():
        if name == case:
            break
        start += len(rows)
    rows = CASES[case]
    got = from_json(strings_column(rows, device="cpu")).to_list()
    j_offs, j_valid, (jk, jv) = _both()["jax"]

    def s(kid, i):
        return bytes(kid[1][kid[0][i]:kid[0][i + 1]]).decode()

    want = [None if not j_valid[start + r] else
            [(s(jk, i), s(jv, i)) for i in range(j_offs[start + r], j_offs[start + r + 1])]
            for r in range(len(rows))]
    assert got == want


def test_reference_vectors():
    got = from_json(strings_column(CASES["basic"], device="cpu")).to_list()
    assert got[0] == [("Zipcode", "704"), ("ZipCodeType", "STANDARD"),
                      ("City", "PARC PARQUE"), ("State", "PR")]
    assert got[1] == [] and got[2] is None
    assert got[3] == [("category", "reference"), ("index", '[4,{},null,{"a":[{ }, {}] } ]'),
                      ("author", "Nigel Rees"), ("title", "{}[], <=semantic-symbols-string"),
                      ("price", "8.95")]


@pytest.mark.parametrize("rows", [
    ['{"a":1}', "{bad"],
    ['{"a":1} xyz'],
    ['{"a":1}', '{"b":', "x" * 40 + "{", "{}"],
    [None, "[1,", '{"a":1}', "{'a':}"],
], ids=["invalid_row", "trailing_garbage", "two_buckets", "null_first"])
def test_raises_at_the_same_row_as_jax(rows):
    with pytest.raises(JJsonParsingException) as je:
        jfrom_json(jc.strings_column(rows))
    with pytest.raises(JsonParsingException) as te:
        from_json(strings_column(rows, device="cpu"))
    assert str(te.value) == str(je.value)
    assert f"row {te.value.row}" in str(te.value)


def test_null_rows_skip_validation():
    got = from_json(strings_column([None, '{"a":1}'], device="cpu")).to_list()
    assert got == [None, [("a", "1")]]


def test_empty_column():
    lst = from_json(strings_column([], device="cpu"))
    assert lst.size == 0 and lst.to_list() == []


def test_chunked_buckets_change_nothing(monkeypatch):
    import importlib

    tg = importlib.import_module("spark_rapids_jni_tpu_torch.ops.get_json_object")
    col = strings_column(ROWS, device="cpu")
    whole = from_json(col).to_list()
    monkeypatch.setattr(tg, "CHUNK_BYTES", 32 * 5)
    assert from_json(col).to_list() == whole
