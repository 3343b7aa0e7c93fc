"""The PyTorch port's ``get_json_object`` on the CPU: both arms against the
GetJsonObjectTest corpus, the JAX package's host arm and the sequential
oracle.

The port's arms: the host arm (the numpy machine and render), which
``"auto"`` picks for CPU columns, and the device arm (the torch tokenizer
path, the stacked torch machine of ops/json_scan.py and the torch render),
pinned on CPU tensors with ``json_device_render=True``.  The corpus cases
(tests/test_get_json_object.py, the reference's JUnit suite) check literal
strings and run no JAX; a seeded fuzz (nesting, escapes, ``\\uXXXX``, single
quotes, ``-0``, floats with exponents, malformed rows, nulls) is held bit
for bit (chars, offsets, validity) against the JAX package's host arm, in
one multi-path call per package.  Tolerance 0 throughout.
"""

import importlib

import numpy as np
import pytest
import torch

from spark_rapids_jni_tpu import config as jconfig
from spark_rapids_jni_tpu.columnar.column import strings_column as jstrings_column
from spark_rapids_jni_tpu.obs import seam as jseam
from spark_rapids_jni_tpu_torch import config
from spark_rapids_jni_tpu_torch.columnar.column import strings_column
from spark_rapids_jni_tpu_torch.obs import seam as tseam

import json_oracle as jo

jg = importlib.import_module("spark_rapids_jni_tpu.ops.get_json_object")
tg = importlib.import_module("spark_rapids_jni_tpu_torch.ops.get_json_object")
tscan = importlib.import_module("spark_rapids_jni_tpu_torch.ops.json_scan")

NAMED, INDEX, WILDCARD = tg.NAMED, tg.INDEX, tg.WILDCARD
WC = (WILDCARD,)
ARMS = {"host": False, "device": True}


def named(n):
    return (NAMED, n.encode() if isinstance(n, str) else n)


def idx(i):
    return (INDEX, i)


def run(rows, path, arm):
    with config.override(json_device_render=ARMS[arm]):
        return tg.get_json_object(strings_column(rows, device="cpu"), path).to_list()


# ---------------------------------------------------------------- corpus ---
# (name, rows, path, expected): every case of tests/test_get_json_object.py

_BAIDU = (
    '{"brand":"ssssss","duratRon":15,"eqTosuresurl":"","RsZxarthrl":false,'
    '"xonRtorsurl":"","xonRtorsurlstOTe":0,"TRctures":[{"RxaGe":'
    r'"VttTs:\/\/feed-RxaGe.baRdu.cox\/0\/TRc\/-196588744s840172444s-773690137.zTG"}],'
    r'"Toster":"VttTs:\/\/feed-RxaGe.baRdu.cox\/0\/TRc\/-196588744s840172444s-773690137.zTG",'
    '"reserUed":{"bRtLate":391.79,"xooUZRke":26876,"nahrlIeneratRonNOTe":0,'
    '"useJublRc":6,"URdeoRd":821284086},"tRtle":"ssssssssssmMsssssssssssssssssss",'
    '"url":"s{storehrl}","usersTortraRt":'
    r'"VttTs:\/\/feed-RxaGe.baRdu.cox\/0\/TRc\/-6971178959s-664926866s-6096674871.zTG",'
    r'"URdeosurl":"http:\/\/nadURdeo2.baRdu.cox\/'
    r'5fa3893aed7fc0f8231dab7be23efc75s820s6240.xT3",'
    '"URdeoRd":821284086}'
)
_BAIDU2 = (
    '{"brand":"ssssss","duratgzn":17,"eSyzsuresurl":"","gswUartWrl":false,'
    '"Uzngtzrsurl":"","UzngtzrsurlstJye":0,"ygctures":[{"gUaqe":'
    r'"Ittys:\/\/feed-gUaqe.bagdu.czU\/0\/ygc\/63025364s-376461312s7528698939.Qyq"}],'
    r'"yzster":"Ittys:\/\/feed-gUaqe.bagdu.czU\,"url":"s{stHreqrl}",'
    r'"usersPHrtraIt":"LttPs:\/\/feed-IUaxe.baIdu.cHU\/0\/PIc\/-1043913002s489796992s-1505641721.Pnx",'  # noqa
    r'"kIdeHsurl":"LttP:\/\/nadkIdeH9.baIdu.cHU\/4d7d308bd7c04e63069fd343adfa792as1790s1080.UP3",'  # noqa
    '"kIdeHId":852890923}'
)
_K2 = "k1_" + "1" * 96
_V2 = "v1_" + "1" * 96
_IDX = "[ [0, 1, 2] , [10, [11], [121, 122, 123], 13] ,  [20, 21, 22]]"
_ROW6 = r"""['中国\"\'\\\/\b\f\n\r\t\b']"""
_MIXED = ['{"k": "%s", "pad": "%s"}' % (f"v{i}", "x" * (i * 7 % 120)) for i in range(50)]

CORPUS = [
    ("named_simple", ['{"k": "v"}'], [named("k")], ["v"]),
    ("long_names", ['{"%s":"%s"}' % (_K2, _V2)] * 7, [named(_K2)], [_V2] * 7),
    ("nested_named", ['{"k1":{"k2":"v2"}}'] * 7, [named("k1"), named("k2")], ["v2"] * 7),
    ("depth8_names", ['{"k1":{"k2":{"k3":{"k4":{"k5":{"k6":{"k7":{"k8":"v8"}}}}}}}}'] * 7,
     [named(f"k{i}") for i in range(1, 9)], ["v8"] * 7),
    ("baidu_unescape_backslash", [_BAIDU] * 7, [named("URdeosurl")],
     ["http://nadURdeo2.baRdu.cox/5fa3893aed7fc0f8231dab7be23efc75s820s6240.xT3"] * 7),
    ("baidu_unexist_field", [_BAIDU2] * 7, [named("Vgdezsurl")], [None] * 7),
    ("escapes", ['{ "a": "A" }', '{\'a\':\'A"\'}', "{'a':\"B'\"}", "['a','b','\"C\"']",
                 r"""'中国\"\'\\\/\b\f\n\r\t\b'"""], [],
     ['{"a":"A"}', '{"a":"A\\""}', '{"a":"B\'"}', '["a","b","\\"C\\""]',
      "中国\"'\\/\b\f\n\r\t\b"]),
    ("escapes_in_array", [_ROW6], [], [jo.get_json_object(_ROW6, [])]),
    ("number_normalization",
     ["[100.0,200.000,351.980]", "[12345678900000000000.0]", "[0.0]", "[-0.0]", "[-0]",
      "[12345678999999999999999999]", "[9.299999257686047e-0005603333574677677]",
      "9.299999257686047e0005603333574677677", "[1E308]", "[1.0E309,-1E309,1E5000]", "0.3",
      "0.03", "0.003", "0.0003", "0.00003"], [],
     ["[100.0,200.0,351.98]", "[1.23456789E19]", "[0.0]", "[-0.0]", "[0]",
      "[12345678999999999999999999]", "[0.0]", '"Infinity"', "[1.0E308]",
      '["Infinity","-Infinity","Infinity"]', "0.3", "0.03", "0.003", "3.0E-4", "3.0E-5"]),
    ("leading_zeros_invalid", ["00", "01", "02", "000", "-01", "-00", "-02"], [], [None] * 7),
    ("index", [_IDX], [idx(1)], ["[10,[11],[121,122,123],13]"]),
    ("index_index", [_IDX], [idx(1), idx(2)], ["[121,122,123]"]),
    ("case_path1", ["'abc'"], [], ["abc"]),
    ("case_path2_flatten", ["[ [11, 12], [21, [221, [2221, [22221, 22222]]]], [31, 32] ]"],
     [WC, WC], ["[11,12,21,221,2221,22221,22222,31,32]"]),
    ("case_path3", ["123"], [], ["123"]),
    ("case_path4", ["{ 'k' : 'v'  }"], [named("k")], ["v"]),
    ("case_path5", ["[  [[[ {'k': 'v1'} ], {'k': 'v2'}]], [[{'k': 'v3'}], "
                    "{'k': 'v4'}], {'k': 'v5'}  ]"], [WC, WC, named("k")], ['["v5"]']),
    ("case_path6", ["[1, [21, 22], 3]", "[1]"], [WC], ["[1,[21,22],3]", "1"]),
    ("case_path7_quoted_mode", ["[ {'k': [0, 1, 2]}, {'k': [10, 11, 12]}, {'k': [20, 21, 22]}  ]"],
     [WC, named("k"), WC], ["[[0,1,2],[10,11,12],[20,21,22]]"]),
    ("case_path8", ["[ [0], [10, 11, 12], [2] ]"], [idx(1), WC], ["[10,11,12]"]),
    ("case_path9", ["[[0, 1, 2], [10, [111, 112, 113], 12], [20, 21, 22]]",
                    "[[0, 1, 2], [10, [], 12], [20, 21, 22]]"], [idx(1), idx(1), WC],
     ["[111,112,113]", None]),
    ("case_path10", ["{'k' : [0,1,2]}", "{'k' : null}"], [named("k"), idx(1)], ["1", None]),
    ("case_path11_object_wildcard", ["{'k' : [0,1,2]}", "{'k' : null}"], [WC], [None, None]),
    ("case_path12", ["123"], [WC], [None]),
    ("insert_comma_insert_outer_array", ["[ [11, 12], [21, 22]]", "[ [11], [22] ]"],
     [WC, WC, WC], ["[[11,12],[21,22]]", "[11,22]"]),
    ("15_invalid_quote_in_string", ["{'a':'v1'}", "{'a':\"b\"c\"}"], [named("a")],
     ["v1", None]),
    ("null_rows_and_path_string", ['{"a": {"b": 7}}', None, "junk"], "$.a.b",
     ["7", None, None]),
    ("empty_and_whitespace", ["", "   ", "null", "true"], [], [None, None, "null", "true"]),
    ("mixed_length_buckets", _MIXED, [named("k")], [f"v{i}" for i in range(50)]),
]


@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("case", CORPUS, ids=[c[0] for c in CORPUS])
def test_corpus(case, arm):
    _name, rows, path, expected = case
    assert run(rows, path, arm) == expected


# ------------------------------------------------------------------ fuzz ---

_SCALARS = ["123", "-5", "0", "-0", "1.5", "2e3", "-0.25", "6.02E+23", "-1.5e-7", "1e999",
            "3.14159", "true", "false", "null", "'s'", '"t"', '"a b"', "'q\\'x'",
            '"\\u0041\\u00e9"', '"\\n\\t"', '"\\u4e2d\\/"', '"c\\"d"', "00", "01", "1."]
_NAMES = ["a", "b", "k", "x y", "\\u0041", "a\\tb"]

FUZZ_PATHS = ["$", "$.a", "$.a.b", "$[0]", "$[1]", "$[*]", "$[*][*]", "$.a[*]", "$[0][*]",
              "$[*].k", "$.k[1][*]", "$.b[*].a[0]", "$['x y']"]


def _fuzz_json(rng, depth=0):
    r = rng.random()
    if depth > 4 or r < 0.3:
        return _SCALARS[rng.integers(len(_SCALARS))]
    k = int(rng.integers(0, 4))
    if r < 0.6:
        return "[" + ",".join(_fuzz_json(rng, depth + 1) for _ in range(k)) + "]"
    q = "'" if rng.random() < 0.2 else '"'
    return "{" + ",".join(f"{q}{_NAMES[rng.integers(len(_NAMES))]}{q}" + (" : " if
                          rng.random() < 0.3 else ":") + _fuzz_json(rng, depth + 1)
                          for _ in range(k)) + "}"


def fuzz_rows(seed=7, n=300):
    rng = np.random.default_rng(seed)
    rows = [_fuzz_json(rng) for _ in range(n)]
    for i in range(0, n, 17):  # malformed rows
        rows[i] = rows[i][:-1] if rows[i] else "{"
    for i in range(5, n, 29):  # null rows
        rows[i] = None
    rows[3] = rows[3] + " trailing" if rows[3] else "[]"
    return rows


ROWS = fuzz_rows()
_JAX = {}


def _jax_host():
    """The JAX package's host arm over the fuzz, every path in one call."""
    if "out" not in _JAX:
        with jconfig.override(json_device_render=False):
            outs = jg.get_json_object_multiple_paths(jstrings_column(ROWS), FUZZ_PATHS)
        _JAX["out"] = [(np.asarray(o.offsets).astype(np.int64),
                        np.asarray(o.chars)[:int(np.asarray(o.offsets)[-1])],
                        np.asarray(o.is_valid())) for o in outs]
    return _JAX["out"]


_PORT = {}


def _port(arm):
    if arm not in _PORT:
        with config.override(json_device_render=ARMS[arm]):
            _PORT[arm] = tg.get_json_object_multiple_paths(
                strings_column(ROWS, device="cpu"), FUZZ_PATHS)
    return _PORT[arm]


@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("pi", range(len(FUZZ_PATHS)), ids=FUZZ_PATHS)
def test_fuzz_matches_jax_host_arm(pi, arm):
    offs, chars, valid = _jax_host()[pi]
    got = _port(arm)[pi]
    np.testing.assert_array_equal(got.offsets.numpy().astype(np.int64), offs)
    np.testing.assert_array_equal(got.chars.numpy(), chars)
    np.testing.assert_array_equal(got.is_valid().numpy(), valid)


@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("pi", range(len(FUZZ_PATHS)), ids=FUZZ_PATHS)
def test_fuzz_matches_oracle(pi, arm):
    path = tg.parse_path(FUZZ_PATHS[pi])
    want = [jo.get_json_object(r, path) for r in ROWS]
    assert _port(arm)[pi].to_list() == want


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_multiple_paths_equal_single_calls(arm):
    col = strings_column(ROWS[:60], device="cpu")
    with config.override(json_device_render=ARMS[arm]):
        multi = tg.get_json_object_multiple_paths(col, FUZZ_PATHS)
        for p, m in zip(FUZZ_PATHS, multi):
            assert tg.get_json_object(col, p).to_list() == m.to_list(), p


def test_multiple_paths_empty():
    assert tg.get_json_object_multiple_paths(strings_column(ROWS, device="cpu"), []) == []
    outs = tg.get_json_object_multiple_paths(strings_column([], device="cpu"), ["$.a", "$[0]"])
    assert [o.to_list() for o in outs] == [[], []]


# ------------------------------------------------- schedules, not semantics ---

def _deep_rows():
    rng = np.random.default_rng(3)
    rows = list(ROWS[:40])
    for i in range(300):
        inner = str(i) if i % 3 else '{"b": %d}' % i
        for _ in range(int(rng.integers(0, 5))):
            inner = "[%s, %d]" % (inner, i)
        rows.append('{"a": %s, "pad": "%s"}' % (inner, "x" * (i % 40)))
    return rows


@pytest.mark.parametrize("cfg", [
    dict(json_compact=False, json_subbucket_min_rows=512),
    dict(json_compact=True, json_subbucket_min_rows=1 << 30),
    dict(json_compact=False, json_subbucket_min_rows=1 << 30),
    dict(json_compact=True, json_subbucket_min_rows=1),
], ids=["no_compact", "one_class", "neither", "max_split"])
def test_compaction_and_subbucketing_equivalence(cfg):
    col = strings_column(_deep_rows(), device="cpu")
    paths = ["$.a", "$.a[*]", "$.a[0][*]", "$.a.b", "$.pad"]
    with config.override(json_device_render=False):
        base = [o.to_list() for o in tg.get_json_object_multiple_paths(col, paths)]
        with config.override(**cfg):
            got = [o.to_list() for o in tg.get_json_object_multiple_paths(col, paths)]
    assert got == base


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_overlap_grouping_matches_serial(arm):
    rows = ['{"k": [%d, %d.25], "pad": "%s"}' % (i, i, "y" * (i * 11 % 150)) for i in range(40)]
    col = strings_column(rows, device="cpu")
    outs = []
    for budget in (1, 1 << 30):
        with config.override(json_device_render=ARMS[arm], json_overlap_bytes=budget):
            outs.append([o.to_list() for o in tg.get_json_object_multiple_paths(
                col, ["$.k", "$.k[1]", "$.pad"])])
    assert outs[0] == outs[1]


def test_device_arm_row_chunks_change_nothing(monkeypatch):
    """Buckets cut into row chunks (a smaller token capacity per chunk)
    give the same columns as whole buckets."""
    col = strings_column(_deep_rows(), device="cpu")
    paths = ["$.a", "$.a[*]", "$[*]", "$.pad"]
    with config.override(json_device_render=True):
        whole = [o.to_list() for o in tg.get_json_object_multiple_paths(col, paths)]
        monkeypatch.setattr(tg, "CHUNK_BYTES", 64 * 48)
        chunked = [o.to_list() for o in tg.get_json_object_multiple_paths(col, paths)]
    assert chunked == whole


def test_machine_schedule_changes_nothing(monkeypatch):
    """The device machine's live checks every step and compaction from
    one row up give the same columns as its defaults."""
    col = strings_column(_deep_rows(), device="cpu")
    paths = ["$.a", "$.a[*]", "$.a[0][*]", "$[*]"]
    with config.override(json_device_render=True):
        base = [o.to_list() for o in tg.get_json_object_multiple_paths(col, paths)]
        monkeypatch.setattr(tscan, "_CHECK_EVERY", 1)
        monkeypatch.setattr(tscan, "_COMPACT_MIN_ROWS", 1)
        got = [o.to_list() for o in tg.get_json_object_multiple_paths(col, paths)]
    assert got == base


def test_device_arm_failure_raises():
    """No fallback: a failing device arm raises instead of rerunning on the
    host arm."""
    col = strings_column(['{"a": 1}'], device="cpu")
    orig = tscan.run_scan

    def boom(*a, **k):
        raise MemoryError("device arm failed")

    tscan.run_scan = boom
    try:
        with config.override(json_device_render=True), pytest.raises(MemoryError):
            tg.get_json_object(col, "$.a")
    finally:
        tscan.run_scan = orig


def test_step_cap_truncation_matches_jax():
    """Rows that exhaust the step cap are nulled and counted through the
    seam, by both packages, with the same count."""
    rows = ['{"a": [1, 2, 3, 4, 5, 6]}'] * 8
    crossings = {"jax": [], "port": []}

    def injector(key):
        def f(category, name):
            if name.startswith("json:step_cap_truncated"):
                crossings[key].append((category, name))
        return f

    j0, t0 = jg.truncation_count(), tg.truncation_count()
    jseam._set_injector(injector("jax"))
    tseam._set_injector(injector("port"))
    try:
        with jconfig.override(json_device_render=False, json_step_margin=-10000):
            jout = jg.get_json_object(jstrings_column(rows), "$.a[*]").to_list()
        with config.override(json_device_render=False, json_step_margin=-10000):
            tout = tg.get_json_object(strings_column(rows, device="cpu"), "$.a[*]").to_list()
    finally:
        jseam._set_injector(None)
        tseam._set_injector(None)
    assert tout == jout == [None] * 8
    assert tg.truncation_count() - t0 == jg.truncation_count() - j0 == 8
    assert crossings["port"] == crossings["jax"] == [("op", "json:step_cap_truncated:8")]
    with config.override(json_device_render=False):
        ok = tg.get_json_object(strings_column(rows, device="cpu"), "$.a[*]").to_list()
    assert ok == ["[1,2,3,4,5,6]"] * 8
    assert tg.truncation_count() - t0 == 8


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_path_deeper_than_16_raises(arm):
    with pytest.raises(ValueError, match="maximum depth"):
        run(['{"a": 1}'], [named("a")] * 17, arm)
    assert run(['{"a": 1}'], [named("a")] + [idx(0)] * 15, arm) == [None]


@pytest.mark.parametrize("bad", ["$[]", "$[abc]", "$[+1]", "$[ 2]", "$[1_0]", "$[1.5]", "$[",
                                 "$['a", "$x", "$$", "$.", "$..a", "no_dollar", "", "$[-1]"])
def test_parse_path_rejects_malformed(bad):
    with pytest.raises(ValueError):
        tg.parse_path(bad)
    with pytest.raises(ValueError):
        jg.parse_path(bad)


def test_parse_path_accepts_the_grammar():
    for p in ["$", "$['a]b'][3].*", "$.a[0].*", "$['x'][3].*", "$.a.b[*]"]:
        assert tg.parse_path(p) == jg.parse_path(p)
    assert tg.parse_path("$['a]b'][3].*") == [(2, b"a]b"), (1, 3), (0,)]


def test_results_stay_on_the_column_device():
    col = strings_column(['{"a": "x"}', None], device="cpu")
    for flag in (False, True):
        with config.override(json_device_render=flag):
            out = tg.get_json_object(col, "$.a")
        assert out.chars.device.type == out.offsets.device.type == "cpu"
        assert out.to_list() == ["x", None]
    assert tg._device_render_enabled(torch.device("cpu")) is False
    assert tg._device_render_enabled(torch.device("cuda")) is True
