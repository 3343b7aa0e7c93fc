#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``spark_rapids_jni_tpu_torch``).

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It exits non-zero, and prints no result, where there is no CUDA device or no
port package beside it.  Otherwise it:

1. builds ``csrc/hash_kernels.cu``, all five kernels, for sm_90a (nvcc,
   loaded with ctypes);
2. drives the main path at full size with the launch counters at 0: the
   flagship ``local_query_step`` on 2**26 rows (Spark's runtime bloom-filter
   defaults, 8388608 bits and 6 hashes), then ``murmur_hash32`` and
   ``xxhash64`` over an INT32 column with nulls plus an INT64 column of
   2**26 rows; every kernel must have launched at least once;
3. holds the step and the two hashes bit for bit against the same inputs run
   on the CPU, and checks the step's invariants (counts sum to n, sums to
   the sum of values, every key passes its own bloom probe);
4. checks both hashes against Spark's own vectors;
5. holds each kernel bit for bit against its plain PyTorch version on the
   same CUDA tensors at 2**26 rows, with per-row and with scalar seeds;
6. times each kernel and its plain version, and the step, with CUDA events
   (median of 20 after warm-up), and prints one JSON line per kernel and
   seed form and a ``step`` line;
7. drives the column-hash path with the launch counters at 0 again: Spark's
   ``HashPartitioning`` hash ``murmur_hash32([id16, desc, dec], seed=42)``
   and the runtime bloom filter's ``xxhash64([desc])`` over 2**24 rows (a
   CHAR(16) business id, a VARCHAR(100) with 10% nulls and a DECIMAL(38,2):
   about 1.07 GB of chars), then both hashes over a ``LIST<STRING>`` and a
   ``STRUCT<STRING, INT64>`` of 2**20 rows; the murmur calls must have gone
   through the byte kernel's three entry points: ``mm_hash_strings`` twice
   and ``mm_hash_decimal128`` once (and no ``mm_hash_bytes``) for the key,
   ``mm_hash_bytes`` for the list's element steps, ``mm_hash_strings`` for
   the struct's string;
8. holds every column-hash call bit for bit against the same inputs on the
   CPU and checks the Spark string, mixed-row and string-list vectors on the
   card; holds each entry point bit for bit against its plain version with
   per-row and scalar hashes, and times it: ``mm_hash_strings`` on id16 and
   desc at 2**24 rows and on a hazard column (rows of 0-100 B with a few of
   64 KiB and 1 MiB, all-empty tiles, ``chars`` as views at base offsets
   0..15 and as an empty buffer), ``mm_hash_bytes`` on the spans of one list
   element step (and the hazard rows gathered out of order), and
   ``mm_hash_decimal128`` on dec with its specials; times ``mm_hash_strings``
   against ``mm_hash_bytes`` over the same rows of id16 and desc in
   alternating pairs (a ``staging_pairs`` line); times every byte-kernel
   launch of the murmur calls at its own shape beside its bound (a
   ``launch_bounds`` line); times the six whole calls with their peak
   memory and prints a ``column_hash`` line;
9. drives the distributed path with the launch counters at 0 again, on a
   (1, 1) mesh over a one-rank NCCL group (NCCL will not put two ranks on
   one card): ``make_distributed_query_step`` on the step's 2**26 rows,
   ``make_distributed_q97`` on TPC-DS SF10's q97 tables (28,000,000 rows
   each), ``make_distributed_q97_columns`` on them with 10% null customers,
   once with enough shuffle capacity and once with a quarter of it, and
   ``shuffle_table`` over 2**22 rows of an INT32 key, a nullable
   DECIMAL(38,2) and a VARCHAR(100) padded to 100 bytes; each part must
   launch exactly its expected kernels; holds the step bit for bit against
   ``local_query_step``, both q97 forms against a numpy oracle (and q97
   against ``q97_local``), the overflow run's drops, and every row of the
   table against what was sent; holds ``mm_hash_long`` against its plain
   version at the q97 paths' shapes; times every part and the step's phases
   and prints a ``distributed`` line;
10. drives the plans path with the launch counters at 0 again, on the same
   mesh and NCCL group: ``q5_local`` on ``generate_q5_data(sf=838.86)``
   (store_sales 33,554,400 rows), ``q3_local`` on ``generate_q3_data(
   sf=559.24)`` (67,108,800 rows, 83,886 groups), q3's decimal-columns step
   on the same facts as device Columns, and ``run_q97_piece`` on the
   distributed phase's SF10 q97 tables; only the q97 plan may launch a
   kernel (``mm_hash_long`` once, its Exchange's placement); a second call
   of each part must be a cache hit with the same answer; holds q5 against
   ``q5_local_unfused`` and the rollup of ``q5_host_channel_partials``, q3,
   ``q3_local_unfused`` and the decimal step against a numpy oracle, the q97
   plan against the distributed phase's oracle and ``make_distributed_q97``,
   and ``mm_hash_long`` against its plain version at the q97 plan's shape;
   times each call host to host with its pad and upload share, each
   executor and step on resident inputs, and one SegmentAgg alone, and
   prints a ``plans`` line;
11. drives the governed path with the launch counters at 0 again, on the
   same mesh: ``run_distributed_q97`` on the SF10 tables,
   ``run_distributed_q5`` on the plans phase's q5 data, and
   ``run_distributed_q3`` and ``run_distributed_q3_columns`` on its q3 data,
   each twice under the default budget (the card's memory) and twice under
   a budget of half its working set; the default runs launch
   ``mm_hash_long`` once (q97) or nothing (q5, q3), the tight runs must
   split (q97 launching it once per key-space piece); every answer must
   equal the ungoverned run's, every reservation be released and no thread
   be left blocked; holds
   ``mm_hash_long`` against its plain version at a split piece's shape, runs
   a few seconds of the monte-carlo stress harness over a spillable cache of
   CUDA buffers, and prints a ``governed`` line (each call's seconds, splits,
   retries, executions, reserved bytes, peak device memory and launches,
   and the arbiter's build seconds); then the card's name and power limit,
   the ``kernels`` line (all seven kernels, their launches over the five
   paths) and, last, the ``ok`` line.

Every check that fails raises, and the script then exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N = 1 << 26
REPS = 20
WARMUP = 3
SOURCE = "spark_rapids_jni_tpu_torch/csrc/hash_kernels.cu"

# name -> (replaced TPU kernel, value dtype, seed/hash dtype, output bytes,
#          32-bit integer instructions per row).  The instruction counts are
# taken by hand from the kernel source: a 64-bit multiply as 4 (a wide
# multiply-add counted twice plus two cross-term multiply-adds), a 64-bit
# add, xor, shift or rotate as 2, a 32-bit operation as 1.
KERNELS = {
    "xx_hash_fixed8": ("spark_rapids_jni_tpu/ops/hash_pallas.py:171",
                       torch.int64, torch.int64, 8, 40),
    "mm_hash_long": ("spark_rapids_jni_tpu/ops/hash_pallas.py:188",
                     torch.int64, torch.int32, 4, 21),
    "mm_hash_int": ("spark_rapids_jni_tpu/ops/hash_pallas.py:184",
                    torch.int32, torch.int32, 4, 15),
    "xx_hash_fixed4": ("spark_rapids_jni_tpu/ops/hash_pallas.py:160",
                       torch.int32, torch.int64, 8, 33),
}

# The byte-string kernel's three entry points (csrc/hash_kernels.cu), all
# replacing the same TPU kernel, and their 32-bit instructions counted by hand
# from the source as above.  mm_hash_row: a word costs 12 (position 1, clamp
# 1, aligned load 1, funnel shift 1, mixK1 3, mixH1 3, loop 2), a tail byte 10
# (shift 1, sign extension 1, mixK1 3, mixH1 3, loop 2).  Beside them, a row
# of mm_hash_strings 32 (offsets and hash 3, addresses 6, window test 3, row
# set-up 6, first word 1, tail set-up 4, fmix 8, store 1) and 3 a staged
# 16-byte chunk (address, cp.async, loop); a row of mm_hash_bytes 30 (start,
# length and hash 3, address 4, row set-up 6, first word 1, tail set-up 4,
# fmix 8, store 1, grid-stride loop 3); a row of mm_hash_decimal128 85
# (loads 3, sign and complement 5, clz 4, length and shift 12, four
# predicated word rounds with byte swaps 28, tail select 3, three predicated
# tail rounds 24, fmix 8, store 1, loop 3 -- counted whole, since the
# predicated rounds issue whatever the length).
BYTES_REPLACES = "spark_rapids_jni_tpu/ops/hash_pallas.py:250"
OPS_PER_WORD, OPS_PER_TAIL_BYTE, OPS_PER_CHUNK = 12, 10, 3
OPS_PER_ROW = {"mm_hash_strings": 32, "mm_hash_bytes": 30, "mm_hash_decimal128": 85}
N_COL = 1 << 24  # rows of the column-hash batch
N_NESTED = 1 << 20  # rows of its list and struct columns

# Device-memory rate by card name (NVIDIA data sheets), bytes/s.
_MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
             ("H100", 3.35e12))
INT32_LANES_PER_SM = 64  # Hopper: 32-bit integer multiply-add per SM per clock


def _nvidia_smi(query: str, units: bool = False) -> str:
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def _card_rates():
    name = torch.cuda.get_device_name(0)
    mem = next((r for key, r in _MEM_RATE if key in name), None)
    if mem is None:
        raise RuntimeError(f"no memory rate known for {name!r}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(_nvidia_smi("clocks.max.sm")) * 1e6
    return mem, sms * INT32_LANES_PER_SM * clock_hz


def _bound(nbytes: int, ops: int, rates) -> dict:
    """The least time the card could take: the larger of ``nbytes`` over the
    memory rate and ``ops`` over the integer rate, and which one it is."""
    mem_rate, int_rate = rates
    bytes_ms, ops_ms = nbytes / mem_rate * 1e3, ops / int_rate * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _time_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _require_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Bit-exact comparison; returns the max absolute error (0.0) or raises
    with the largest unsigned difference among the first mismatches."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} != "
                             f"{want.dtype}{tuple(want.shape)}")
    got, want = got.to(want.device), want
    if torch.equal(got, want):
        return 0.0
    got, want = got.cpu(), want.cpu()
    bad = (got != want).nonzero().flatten()
    mask = (1 << (8 * got.element_size())) - 1
    worst = max(abs((int(got[i]) & mask) - (int(want[i]) & mask)) for i in bad[:4096])
    raise AssertionError(f"{what}: {bad.numel()} rows differ, max |diff| {worst}")


def build():
    from spark_rapids_jni_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    print(json.dumps({"build": {"source": SOURCE, "seconds": time.perf_counter() - t0,
                                "library": _build.library_path().name}}))
    if _build.build_log:
        print(_build.build_log.strip())


def config1_columns(device):
    """BASELINE config 1's shape at full size: an INT32 column with ~10% nulls
    and an INT64 column, drawn from a fixed seed."""
    from spark_rapids_jni_tpu_torch import columnar as c

    rng = np.random.RandomState(7)
    i32 = rng.randint(-(2**31), 2**31, N, dtype=np.int64).astype(np.int32)
    valid = rng.rand(N) >= 0.1
    i64 = rng.randint(-(2**63), 2**63, N, dtype=np.int64)
    return [c.Column(torch.from_numpy(i32).to(device), torch.from_numpy(valid).to(device),
                     c.INT32),
            c.Column(torch.from_numpy(i64).to(device), None, c.INT64)]


def main_path(cfg):
    """The main path at full size with the counters at 0; returns the counts,
    the inputs and the outputs."""
    from spark_rapids_jni_tpu_torch.models import local_query_step, make_example_batch
    from spark_rapids_jni_tpu_torch.ops import hash_cuda, murmur_hash32, xxhash64

    keys, values = make_example_batch(N, seed=0)
    cols = config1_columns("cuda")
    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    step = local_query_step(keys, values, cfg)
    mm = murmur_hash32(cols, seed=42)
    xx = xxhash64(cols)
    torch.cuda.synchronize()
    counts = dict(hash_cuda.launches)
    print(json.dumps({"main_path_launches": counts}))
    missing = [k for k in KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing}")
    return counts, keys, values, cols, step, mm, xx


def check_against_cpu(cfg, keys, values, cols, step, mm, xx):
    from spark_rapids_jni_tpu_torch.columnar.column import Column
    from spark_rapids_jni_tpu_torch.models import local_query_step
    from spark_rapids_jni_tpu_torch.ops import murmur_hash32, xxhash64

    t0 = time.perf_counter()
    cpu_step = local_query_step(keys.cpu(), values.cpu(), cfg)
    cpu_s = time.perf_counter() - t0
    for name, g, w in zip(("sums", "counts", "bits", "probe_hits"), step, cpu_step):
        _require_equal(f"step {name}", g, w)
    sums, counts, bits, hits = (t.cpu() for t in step)
    if int(counts.sum()) != N:
        raise AssertionError(f"counts sum {int(counts.sum())} != {N}")
    if int(sums.sum()) != int(values.sum()):
        raise AssertionError("bucket sums do not add up to the sum of values")
    if int(hits) != N:
        raise AssertionError(f"probe hits {int(hits)} != {N}: a false negative")
    cpu_cols = [Column(c.data.cpu(), None if c.validity is None else c.validity.cpu(),
                       c.dtype) for c in cols]
    _require_equal("murmur_hash32", mm.data, murmur_hash32(cpu_cols, seed=42).data)
    _require_equal("xxhash64", xx.data, xxhash64(cpu_cols).data)
    return cpu_s, int(hits), int(bits.sum())


def check_spark_vectors():
    """Spark ground truth (HashTest.java via tests/test_hash.py)."""
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch.ops import murmur_hash32, xxhash64

    v0 = c.column([0, 100, None, None, -(2**31), None], c.INT32)
    v1 = c.column([0, None, -100, None, None, 2**31 - 1], c.INT32)
    ts = c.column([0, None, 100, -100, 0x123456789ABCDEF, None, -0x123456789ABCDEF],
                  c.TIMESTAMP_MICROS)
    cases = [
        (murmur_hash32([v0, v1], seed=42).to_list(),
         [59727262, 751823303, -1080202046, 42, 723455942, 133916647]),
        (xxhash64([v0, v1]).to_list(),
         [1151812168208346021, -7987742665087449293, 8990748234399402673,
          42, 2073849959933241805, 1508894993788531228]),
        (murmur_hash32([ts], seed=42).to_list(),
         [-1670924195, 42, 1114849490, 904948192, 657182333, 42, -57193045]),
        (xxhash64([ts]).to_list(),
         [-5252525462095825812, 42, 8713583529807266080, 5675770457807661948,
          1941233597257011502, 42, -1318946533059658749]),
    ]
    for i, (got, want) in enumerate(cases):
        if got != want:
            raise AssertionError(f"Spark vector case {i}: {got} != {want}")
    return len(cases)


def _random(dtype, rng):
    """N values over the whole range of ``dtype``, boundary values first."""
    info = torch.iinfo(dtype)
    np_dtype = np.int64 if dtype == torch.int64 else np.int32
    a = rng.randint(info.min, info.max + 1, N, dtype=np_dtype)
    a[:4] = [0, -1, info.min, info.max]
    return torch.from_numpy(a).to("cuda")


def kernels(counts, rates):
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    rng = np.random.RandomState(11)
    rows = []
    for name, (replaces, vdt, adt, out_bytes, ops) in KERNELS.items():
        wrapper = getattr(hash_cuda, f"{name}_cuda")
        plain = getattr(hash_cuda, f"{name}_torch")
        v = _random(vdt, rng)
        per_row = _random(adt, rng)
        entry = None
        for form, aux in (("row", per_row), ("scalar", 0x9747B28C)):
            err = _require_equal(f"{name} ({form} seed)", wrapper(v, aux), plain(v, aux))
            nbytes = N * (v.element_size() + out_bytes
                          + (per_row.element_size() if form == "row" else 0))
            line = {
                "kernel": name, "seed": form, "n": N,
                "kernel_ms": _time_ms(lambda: wrapper(v, aux)),
                "plain_ms": _time_ms(lambda: plain(v, aux)),
                **_bound(nbytes, N * ops, rates),
                "bytes": nbytes, "int_ops": N * ops,
                "launches": counts[name], "max_abs_err": err,
            }
            print(json.dumps(line))
            if form == "row":
                entry = {
                    "name": name, "route": "cuda", "source": SOURCE,
                    "replaces": replaces, "launches": counts[name],
                    "max_abs_err": err, "ms": line["kernel_ms"],
                    "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
                    "bound_by": line["bound_by"], "library_ms": None,
                    "column": "random", "n": N,
                }
        rows.append(entry)
        del v, per_row
    return rows


def time_step(cfg, keys, values):
    """The whole step's time, and a breakdown by phase (each phase timed
    alone, so the phases need not add up to the step exactly)."""
    from spark_rapids_jni_tpu_torch.models import local_query_step
    from spark_rapids_jni_tpu_torch.models.nds import _bloom_positions, _umod
    from spark_rapids_jni_tpu_torch.ops import xxhash64_raw_int64

    torch.cuda.reset_peak_memory_stats()
    step_ms = _time_ms(lambda: local_query_step(keys, values, cfg))
    peak = torch.cuda.max_memory_allocated()
    h = xxhash64_raw_int64(keys)
    bucket = _umod(h, cfg.n_buckets)
    pos = _bloom_positions(keys, cfg.bloom_hashes, cfg.bloom_bits)
    bits = torch.zeros((cfg.bloom_bits,), dtype=torch.uint8, device="cuda")
    flat = pos.reshape(-1)
    ones = torch.ones_like(values, dtype=torch.int32)

    def aggregate():
        torch.zeros((cfg.n_buckets,), dtype=values.dtype, device="cuda").index_add_(
            0, bucket, values)
        torch.zeros((cfg.n_buckets,), dtype=torch.int32, device="cuda").index_add_(
            0, bucket, ones)

    def build_bits():
        bits[flat] = 1

    phases = {
        "xxhash64_keys": _time_ms(lambda: xxhash64_raw_int64(keys)),
        "bucket_umod": _time_ms(lambda: _umod(h, cfg.n_buckets)),
        "aggregate_index_add": _time_ms(aggregate),
        "bloom_positions": _time_ms(
            lambda: _bloom_positions(keys, cfg.bloom_hashes, cfg.bloom_bits)),
        "bloom_build": _time_ms(build_bits),
        "bloom_probe": _time_ms(lambda: bits[pos].all(dim=1).sum()),
    }
    return step_ms, phases, peak


# ---- the column-hash path -------------------------------------------------


def _on(col, device):
    """A column of the port (any class, nested ones recursively) on ``device``."""
    fields = {}
    for f in dataclasses.fields(col):
        v = getattr(col, f.name)
        if isinstance(v, torch.Tensor):
            v = v.to(device)
        elif f.name == "child":
            v = _on(v, device)
        elif f.name == "children":
            v = tuple(_on(c, device) for c in v)
        fields[f.name] = v
    return dataclasses.replace(col, **fields)


def _varchar(rng, n, max_len, null_frac, device):
    """``n`` rows of lengths uniform in [0, max_len] and bytes uniform in
    [0, 255] (so tails sign-extend both ways), ``null_frac`` of them null."""
    from spark_rapids_jni_tpu_torch import columnar as c

    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(rng.randint(0, max_len + 1, n), out=offsets[1:])
    chars = np.frombuffer(rng.bytes(int(offsets[-1])), np.uint8)
    return c.strings_from_arrays(chars, offsets.astype(np.int32), rng.rand(n) >= null_frac,
                                 device)


def _business_ids(rng, n, device):
    """CHAR(16) TPC-DS business ids: 16 uppercase letters, each half the
    8-letter base-26 spelling of a random key, most significant first, as
    models/tpcds.py _dim_ids spells its ids."""
    from spark_rapids_jni_tpu_torch import columnar as c

    keys = rng.randint(0, 26 ** 8, (n, 2), dtype=np.int64)
    chars = np.empty((n, 16), np.uint8)
    for half in range(2):
        for p in range(8):
            chars[:, 8 * half + p] = keys[:, half] // 26 ** (7 - p) % 26 + ord("A")
    return c.strings_from_arrays(chars.reshape(-1), 16 * np.arange(n + 1, dtype=np.int32),
                                 None, device)


def _decimal_specials(seed):
    """Unscaled DECIMAL128 values at every Java byte length 1..16: each
    length's extremes, the values one past them (which need the next length
    or, at 16 bytes, a sign byte re-added), random values of that length,
    and 0, 1, -1."""
    r = random.Random(seed)
    vals = [0, 1, -1]
    for nbytes in range(1, 17):
        top = 1 << (8 * nbytes - 1)
        vals += [top - 1, -top]
        if nbytes < 16:
            vals += [top, -top - 1]
        vals += [r.randrange(-top, top) for _ in range(8)]
    return vals


def _decimals(rng, n, device):
    """DECIMAL(38,2) unscaled values uniform over about +-10**36, the
    specials of _decimal_specials first."""
    from spark_rapids_jni_tpu_torch import columnar as c

    hi_max = 10 ** 36 >> 64
    hi = rng.randint(-hi_max, hi_max + 1, n, dtype=np.int64)
    lo = rng.randint(-(2 ** 63), 2 ** 63, n, dtype=np.int64)
    special = _decimal_specials(31)
    for i, v in enumerate(special):
        v &= (1 << 128) - 1
        hi[i] = np.uint64(v >> 64).astype(np.int64)
        lo[i] = np.uint64(v & 0xFFFFFFFFFFFFFFFF).astype(np.int64)
    return c.Decimal128Column(torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device),
                              None, c.decimal(38, 2))


def column_hash_batch(device):
    """The column-hash phase's inputs, drawn with numpy from a fixed seed:
    ``id16``, ``desc`` and ``dec`` of N_COL rows, a LIST<STRING> of 0-8
    desc-like leaves with 5% null rows and a STRUCT<STRING, INT64> with 5%
    null rows, both of N_NESTED rows."""
    from spark_rapids_jni_tpu_torch import columnar as c

    rng = np.random.RandomState(23)
    id16 = _business_ids(rng, N_COL, device)
    desc = _varchar(rng, N_COL, 100, 0.1, device)
    dec = _decimals(rng, N_COL, device)
    list_offsets = np.zeros(N_NESTED + 1, np.int64)
    np.cumsum(rng.randint(0, 9, N_NESTED), out=list_offsets[1:])
    leaves = _varchar(rng, int(list_offsets[-1]), 100, 0.1, device)
    lst = c.ListColumn(torch.from_numpy(list_offsets.astype(np.int32)).to(device), leaves,
                       torch.from_numpy(rng.rand(N_NESTED) >= 0.05).to(device))
    st = c.StructColumn(
        (_varchar(rng, N_NESTED, 100, 0.1, device),
         c.Column(torch.from_numpy(rng.randint(-(2**63), 2**63, N_NESTED, dtype=np.int64))
                  .to(device), None, c.INT64)),
        torch.from_numpy(rng.rand(N_NESTED) >= 0.05).to(device))
    return {"id16": id16, "desc": desc, "dec": dec, "list": lst, "struct": st}


def _column_hash_calls(b):
    """name -> zero-argument call of the public hash API on batch ``b``."""
    from spark_rapids_jni_tpu_torch.ops import murmur_hash32, xxhash64

    return {
        "murmur_hash32[id16,desc,dec]": lambda: murmur_hash32(
            [b["id16"], b["desc"], b["dec"]], seed=42),
        "xxhash64[desc]": lambda: xxhash64([b["desc"]]),
        "murmur_hash32[list<string>]": lambda: murmur_hash32([b["list"]], seed=42),
        "xxhash64[list<string>]": lambda: xxhash64([b["list"]]),
        "murmur_hash32[struct<string,int64>]": lambda: murmur_hash32([b["struct"]], seed=42),
        "xxhash64[struct<string,int64>]": lambda: xxhash64([b["struct"]]),
    }


def column_hash_path(batch):
    """The column-hash path with the counters at 0; returns the counts of the
    whole path and the outputs.  Each call's own launches are printed too."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    per_call, outs = {}, {}
    for name, call in _column_hash_calls(batch).items():
        before = dict(hash_cuda.launches)
        outs[name] = call()
        torch.cuda.synchronize()
        per_call[name] = {k: v - before[k] for k, v in hash_cuda.launches.items() if v > before[k]}
    counts = dict(hash_cuda.launches)
    print(json.dumps({"column_hash_launches": {"total": counts, "per_call": per_call}}))
    want = {  # call -> {byte entry point: launches, or None for "at least one"}
        "murmur_hash32[id16,desc,dec]": {"mm_hash_strings": 2, "mm_hash_decimal128": 1,
                                         "mm_hash_bytes": 0},
        "murmur_hash32[list<string>]": {"mm_hash_bytes": None},
        "murmur_hash32[struct<string,int64>]": {"mm_hash_strings": 1},
    }
    for call, entries in want.items():
        for kernel, n in entries.items():
            got = per_call[call].get(kernel, 0)
            if (n is None and got == 0) or (n is not None and got != n):
                raise AssertionError(f"{call} launched {kernel} {got} times, not "
                                     f"{'at least once' if n is None else n}")
    return counts, outs


def check_column_hash_against_cpu(batch, outs):
    """Every column-hash call held bit for bit against the same inputs run on
    the CPU; returns each CPU run's seconds."""
    cpu_batch = {k: _on(v, "cpu") for k, v in batch.items()}
    cpu_s = {}
    for name, call in _column_hash_calls(cpu_batch).items():
        t0 = time.perf_counter()
        want = call()
        cpu_s[name] = time.perf_counter() - t0
        _require_equal(f"{name} vs CPU", outs[name].data, want.data)
    return cpu_s


LONG_STR = (
    "A very long (greater than 128 bytes/char string) to test a multi hash-step data point "
    "in the MD5 hash function. This string needed to be longer.A 60 character string to "
    "test MD5's message padding algorithm")
MIXED_LONG_STR = (
    "A very long (greater than 128 bytes/char string) to test a multi hash-step data point "
    "in the MD5 hash function. This string needed to be longer.")
LIST_LONG_STR = (
    "A very long (greater than 128 bytes/char string) to test a multi hash-step data point "
    "in the Murmur3 hash function. This string needed to be longer.")


def check_spark_string_vectors(device):
    """Spark ground truth over strings (HashTest.java via tests/test_hash.py):
    the strings vectors, the mixed row, and the list of strings (whose
    expected values are the JAX package's hash of the same rows as a struct
    of two string columns, as tests/test_hash.py derives them)."""
    import struct as pystruct

    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch.ops import murmur_hash32, xxhash64

    def f32(bits):
        return pystruct.unpack("<f", pystruct.pack("<I", bits))[0]

    def f64(bits):
        return pystruct.unpack("<d", pystruct.pack("<Q", bits))[0]

    strs = c.strings_column(["a", "B\nc", "dE\"\u0100\t\u0101 \ud720\ud721\\Fg2'", LONG_STR,
                             "hiJ\ud720\ud721\ud720\ud721", None], device)
    mixed = [
        c.strings_column(["a", "B\n", "dE\"\u0100\t\u0101 \ud720\ud721", MIXED_LONG_STR,
                          None, None], device),
        c.column([0, 100, -100, -(2**31), 2**31 - 1, None], c.INT32, device),
        c.column([0.0, 100.0, -100.0, f64(0x7FF0000000000001), f64(0x7FFFFFFFFFFFFFFF), None],
                 c.FLOAT64, device),
        c.column([0.0, 100.0, -100.0, f32(0xFF800001), f32(0xFFFFFFFF), None], c.FLOAT32,
                 device),
        c.column([True, False, None, False, True, None], c.BOOL, device),
    ]
    leaves = c.strings_column([None, "a", "B\n", "", "dE\"\u0100\t\u0101", " \ud720\ud721",
                               LIST_LONG_STR, ""], device)
    lst = c.ListColumn(torch.tensor([0, 2, 4, 6, 7, 8, 8], dtype=torch.int32, device=device),
                       leaves, torch.tensor([True] * 5 + [False], device=device))
    cases = [
        (murmur_hash32([strs], seed=42).to_list(),
         [1485273170, 1709559900, 1423943036, 176121990, 1199621434, 42]),
        (xxhash64([strs]).to_list(),
         [-8582455328737087284, 2221214721321197934, 5798966295358745941,
          -4834097201550955483, -3782648123388245694, 42]),
        (murmur_hash32(mixed, seed=1868).to_list(),
         [1936985022, 720652989, 339312041, 1400354989, 769988643, 1868]),
        (xxhash64(mixed).to_list(),
         [7451748878409563026, 6024043102550151964, 3380664624738534402,
          8444697026100086329, -5888679192448042852, 42]),
        (murmur_hash32([lst], seed=1868).to_list(),
         [1286620945, -1467611664, 234247660, -848005081, 1992299068, 1868]),
        (xxhash64([lst]).to_list(),
         [-8582455328737087284, 7160715839242204087, -862482741676457612,
          329540788871337774, -7444071767201028348, 42]),
    ]
    for i, (got, want) in enumerate(cases):
        if got != want:
            raise AssertionError(f"Spark string vector case {i}: {got} != {want}")
    return len(cases)


def _row_hashes(n, seed, device):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.randint(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
                            ).to(device)


def _byte_line(kernel, what, form, n, nbytes, ops, rates, times, launches, err, **extra):
    """One timing line of a byte-kernel entry point, its bound computed from
    this run's inputs: ``nbytes`` moved and ``ops`` 32-bit instructions."""
    line = {"kernel": kernel, "column": what, "seed": form, "n": n,
            "kernel_ms": times[0], "plain_ms": times[1], **_bound(nbytes, ops, rates),
            "bytes": nbytes, "int_ops": ops, **extra, "launches": launches,
            "max_abs_err": err}
    print(json.dumps(line))
    return line


def _entry(line):
    """The kernels-line entry of a byte entry point, from its main line,
    with the input it was timed on: ``column`` and its ``n`` rows."""
    return {"name": line["kernel"], "route": "cuda", "source": SOURCE,
            "replaces": BYTES_REPLACES, "launches": line["launches"],
            "max_abs_err": line["max_abs_err"], "ms": line["kernel_ms"],
            "plain_ms": line["plain_ms"], "bound_ms": line["bound_ms"],
            "bound_by": line["bound_by"], "library_ms": None,
            "column": line["column"], "n": line["n"]}


def _row_ops(kernel, lens: torch.Tensor, chunks: int = 0) -> int:
    """Hand-counted 32-bit instructions for rows of these byte lengths."""
    words, tail = int((lens // 4).sum()), int((lens % 4).sum())
    return (OPS_PER_WORD * words + OPS_PER_TAIL_BYTE * tail + OPS_PER_CHUNK * chunks
            + OPS_PER_ROW[kernel] * lens.numel())


def strings_kernel(batch, counts, rates):
    """mm_hash_strings against its plain version on id16 and desc (2**24
    rows), each hash form, timed; returns the kernels-line entry (desc,
    per-row hashes).  Then the hazard column (see _hazard_strings)."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    per_row = _row_hashes(N_COL, 13, batch["desc"].device)
    entry = None
    for col_name in ("id16", "desc"):
        col = batch[col_name]
        chars, offsets = col.chars, col.offsets
        lens = col.lengths()
        nchars = int(offsets[-1])
        ops = _row_ops("mm_hash_strings", lens, -(-nchars // 16))
        for form, h in (("row", per_row), ("scalar", 0x9747B28C)):
            err = _require_equal(f"mm_hash_strings {col_name} ({form} hash)",
                                 hash_cuda.mm_hash_strings_cuda(chars, offsets, h),
                                 hash_cuda.mm_hash_strings_torch(chars, offsets, h))
            times = (_time_ms(lambda: hash_cuda.mm_hash_strings_cuda(chars, offsets, h)),
                     _time_ms(lambda: hash_cuda.mm_hash_strings_torch(chars, offsets, h)))
            nbytes = nchars + 4 * (N_COL + 1) + N_COL * (8 if form == "row" else 4)
            line = _byte_line("mm_hash_strings", col_name, form, N_COL, nbytes, ops, rates,
                              times, counts["mm_hash_strings"], err, chars=nchars)
            if col_name == "desc" and form == "row":
                entry = _entry(line)
    _hazard_strings(batch["desc"].device)
    return entry


PAIRS = 10


def staging_pairs(batch):
    """Whether staging tiles in shared memory pays: mm_hash_strings against
    the unstaged mm_hash_bytes over the same rows of id16 and desc (spans
    from the offsets, per-row hashes), timed in PAIRS alternating pairs
    whose order flips each pair.  Both are held bit for bit first.  Prints
    one line and returns it."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    out = {}
    for col_name in ("id16", "desc"):
        col = batch[col_name]
        starts = col.offsets[:-1].contiguous()
        lens = col.lengths().contiguous()
        h = _row_hashes(N_COL, 73, starts.device)
        fns = {"strings": lambda: hash_cuda.mm_hash_strings_cuda(col.chars, col.offsets, h),
               "bytes": lambda: hash_cuda.mm_hash_bytes_cuda(col.chars, starts, lens, h)}
        _require_equal(f"mm_hash_strings vs mm_hash_bytes on {col_name}", fns["strings"](),
                       fns["bytes"]())
        times = {k: [] for k in fns}
        for p in range(PAIRS):
            for k in (("strings", "bytes") if p % 2 == 0 else ("bytes", "strings")):
                times[k].append(_time_ms(fns[k]))
        diffs = [b - s for s, b in zip(times["strings"], times["bytes"])]
        out[col_name] = {**{f"{k}_ms": v for k, v in times.items()},
                         "strings_faster_pairs": sum(d > 0 for d in diffs),
                         "median_gain_ms": statistics.median(diffs)}
    line = {"staging_pairs": out}
    print(json.dumps(line))
    return line


HAZARD_ROWS = (1 << 16) + 77  # a ragged last tile of 77 rows
HAZARD_LONG = (1 << 16, 1 << 20)  # the lengths of its long rows


def hazard_column(seed=29):
    """HAZARD_ROWS rows of 0-100 bytes mixed with three of 64 KiB and two of
    1 MiB, two whole tiles of empty rows, and a ragged last tile: (uint8
    chars, int32 offsets) on the CPU."""
    rng = np.random.RandomState(seed)
    n = HAZARD_ROWS
    lens = rng.randint(0, 101, n)
    lens[5 * 256:7 * 256] = 0
    lens[[1000, 30001, 50002]] = HAZARD_LONG[0]
    lens[[20003, 60000]] = HAZARD_LONG[1]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    chars = np.frombuffer(rng.bytes(int(offsets[-1])), np.uint8).copy()
    return torch.from_numpy(chars), torch.from_numpy(offsets.astype(np.int32))


def _views(chars, device):
    """``chars`` copied to ``device`` as views at base offsets 0..15 of one
    buffer, and the base of each."""
    buf = torch.zeros(chars.numel() + 16, dtype=torch.uint8, device=device)
    for base in range(16):
        view = buf[base:base + chars.numel()]
        view.copy_(chars)
        yield base, view


def _hazard_strings(device):
    """mm_hash_strings on the hazard column, its chars at every base offset
    0..15, and on an all-empty column over an empty buffer, per-row and
    scalar hashes, against the plain version.  The plain version walks a
    1 MiB row one word at a time, which takes seconds of op dispatch on
    either device, so it runs once per hash form, on the CPU copies of the
    same inputs; the kernel's result does not depend on the base offset."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    chars, offsets = hazard_column()
    n = offsets.numel() - 1
    per_row = _row_hashes(n, 37, "cpu")
    doffs = offsets.to(device)
    checks = 0
    for form, h in (("row", per_row), ("scalar", 0x9747B28C)):
        want = hash_cuda.mm_hash_strings_torch(chars, offsets, h)
        dh = h.to(device) if isinstance(h, torch.Tensor) else h
        for base, view in _views(chars, device):
            _require_equal(f"mm_hash_strings hazard, base {base} ({form} hash)",
                           hash_cuda.mm_hash_strings_cuda(view, doffs, dh), want)
            checks += 1
        empty = torch.zeros(0, dtype=torch.uint8, device=device)
        zeros = torch.zeros(n + 1, dtype=torch.int32, device=device)
        _require_equal(f"mm_hash_strings empty buffer ({form} hash)",
                       hash_cuda.mm_hash_strings_cuda(empty, zeros, dh),
                       hash_cuda.mm_hash_strings_torch(empty.cpu(), zeros.cpu(), h))
        checks += 1
    print(json.dumps({"kernel": "mm_hash_strings", "column": "hazard", "n": n,
                      "chars": int(offsets[-1]), "longest": int((offsets[1:] - offsets[:-1]).max()),
                      "bases": 16, "checks": checks, "max_abs_err": 0.0}))


def spans_kernel(batch, counts, rates):
    """mm_hash_bytes against its plain version on the spans of one list
    element step, each hash form, timed; then on the hazard column's rows in
    a shuffled order at every base offset.  Returns the kernels-line entry
    (list step, per-row hashes)."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    lst = batch["list"]
    chars = lst.child.chars
    starts, lens = max(_list_steps(lst), key=lambda sl: sl[0].numel())
    starts, lens = starts.contiguous(), lens.contiguous()
    n = starts.numel()
    per_row = _row_hashes(n, 41, chars.device)
    span_bytes = int(lens.sum())
    ops = _row_ops("mm_hash_bytes", lens)
    entry = None
    for form, h in (("row", per_row), ("scalar", 0x9747B28C)):
        err = _require_equal(f"mm_hash_bytes list step ({form} hash)",
                             hash_cuda.mm_hash_bytes_cuda(chars, starts, lens, h),
                             hash_cuda.mm_hash_bytes_torch(chars, starts, lens, h))
        times = (_time_ms(lambda: hash_cuda.mm_hash_bytes_cuda(chars, starts, lens, h)),
                 _time_ms(lambda: hash_cuda.mm_hash_bytes_torch(chars, starts, lens, h)))
        nbytes = span_bytes + n * (16 if form == "row" else 12)
        line = _byte_line("mm_hash_bytes", "list<string> step", form, n, nbytes, ops, rates,
                          times, counts["mm_hash_bytes"], err, chars=span_bytes)
        if form == "row":
            entry = _entry(line)

    hchars, hoffs = hazard_column(seed=43)
    perm = torch.from_numpy(np.random.RandomState(47).permutation(hoffs.numel() - 1))
    hstarts = hoffs[:-1][perm].contiguous()
    hlens = (hoffs[1:] - hoffs[:-1])[perm].contiguous()
    hh = _row_hashes(perm.numel(), 53, "cpu")
    want = hash_cuda.mm_hash_bytes_torch(hchars, hstarts, hlens, hh)
    dev = chars.device
    for base, view in _views(hchars, dev):
        _require_equal(f"mm_hash_bytes hazard, base {base}",
                       hash_cuda.mm_hash_bytes_cuda(view, hstarts.to(dev), hlens.to(dev),
                                                    hh.to(dev)), want)
    print(json.dumps({"kernel": "mm_hash_bytes", "column": "hazard, shuffled", "n": perm.numel(),
                      "bases": 16, "checks": 16, "max_abs_err": 0.0}))
    return entry


def decimal_kernel(batch, counts, rates):
    """mm_hash_decimal128 against its plain version on dec (specials first),
    each hash form, timed, and against the bytes route (the Java bytes built
    in torch, hashed by mm_hash_bytes) once; returns the kernels-line entry
    (per-row hashes)."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda, hashing

    dec = batch["dec"]
    n = dec.size
    per_row = _row_hashes(n, 59, dec.hi.device)
    ops = OPS_PER_ROW["mm_hash_decimal128"] * n
    entry = None
    for form, h in (("row", per_row), ("scalar", 0x9747B28C)):
        got = hash_cuda.mm_hash_decimal128_cuda(dec.hi, dec.lo, h)
        err = _require_equal(f"mm_hash_decimal128 ({form} hash)", got,
                             hash_cuda.mm_hash_decimal128_torch(dec.hi, dec.lo, h))
        times = (_time_ms(lambda: hash_cuda.mm_hash_decimal128_cuda(dec.hi, dec.lo, h)),
                 _time_ms(lambda: hash_cuda.mm_hash_decimal128_torch(dec.hi, dec.lo, h)))
        nbytes = n * (16 + (8 if form == "row" else 4))
        line = _byte_line("mm_hash_decimal128", "dec", form, n, nbytes, ops, rates, times,
                          counts["mm_hash_decimal128"], err,
                          specials=len(_decimal_specials(31)))
        if form == "row":
            entry = _entry(line)
            _require_equal("mm_hash_decimal128 vs the Java bytes route", got,
                           hashing._mm_hash_bytes(*hashing._decimal128_spans(dec), per_row))
    return entry


def _list_steps(lst):
    """Each element step of the list walk over ``lst`` (hashing._hash_list),
    in its order: the (starts, lens) of the spans that one mm_hash_bytes
    launch hashes, clamped element indices included."""
    from spark_rapids_jni_tpu_torch.columnar.buckets import length_buckets

    starts = lst.offsets[:-1].to(torch.int64)
    lens = lst.offsets[1:].to(torch.int64) - starts
    live = torch.nonzero((lens > 0) & lst.is_valid()).flatten()
    leaf = lst.child
    for _, sub in length_buckets(lens[live]):
        rows = live[sub]
        for j in range(int(lens[rows].max())):
            idx = torch.clamp(starts[rows] + j, max=leaf.size - 1)
            s = leaf.offsets[idx]
            yield s, leaf.offsets[idx + 1] - s


def launch_bounds(batch, rates):
    """Every byte-kernel launch of the murmur calls on the column-hash path,
    at its own shape, with per-row hashes as the calls pass them: its bytes
    and bound from this run's inputs, and its time alone.  Prints one line
    and returns it."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    def shape(call, kernel, n, nbytes, ops, fn):
        return {"call": call, "kernel": kernel, "n": n, "bytes": nbytes,
                **_bound(nbytes, ops, rates), "ms": _time_ms(fn)}

    def strings(call, col):
        n, nchars = col.size, int(col.offsets[-1] - col.offsets[0])
        h = _row_hashes(n, 61, col.chars.device)
        return shape(call, "mm_hash_strings", n, nchars + 4 * (n + 1) + 8 * n,
                     _row_ops("mm_hash_strings", col.lengths(), -(-nchars // 16)),
                     lambda: hash_cuda.mm_hash_strings_cuda(col.chars, col.offsets, h))

    key = "murmur_hash32[id16,desc,dec]"
    dec = batch["dec"]
    hd = _row_hashes(dec.size, 67, dec.hi.device)
    out = [strings(key, batch["id16"]), strings(key, batch["desc"]),
           shape(key, "mm_hash_decimal128", dec.size, 24 * dec.size,
                 OPS_PER_ROW["mm_hash_decimal128"] * dec.size,
                 lambda: hash_cuda.mm_hash_decimal128_cuda(dec.hi, dec.lo, hd)),
           strings("murmur_hash32[struct<string,int64>]", batch["struct"].children[0])]
    chars = batch["list"].child.chars
    for starts, lens in _list_steps(batch["list"]):
        st, ln = starts.contiguous(), lens.contiguous()
        h = _row_hashes(st.numel(), 71, chars.device)
        out.append(shape("murmur_hash32[list<string>]", "mm_hash_bytes", st.numel(),
                         int(ln.sum()) + 16 * st.numel(), _row_ops("mm_hash_bytes", ln),
                         lambda: hash_cuda.mm_hash_bytes_cuda(chars, st, ln, h)))
    totals = {}
    for row in out:
        t = totals.setdefault(f"{row['call']} {row['kernel']}",
                              {"launches": 0, "ms": 0.0, "bound_ms": 0.0})
        t["launches"] += 1
        t["ms"] += row["ms"]
        t["bound_ms"] += row["bound_ms"]
    line = {"launch_bounds": out, "totals": totals}
    print(json.dumps(line))
    return line


def time_column_hash(batch):
    """The six whole full-size calls' times and the peak device memory of
    each, beside what the batch itself holds; and some of their parts, each
    timed alone: the decimal kernel and the length classes that xxhash64 over
    bytes walks."""
    from spark_rapids_jni_tpu_torch.columnar.buckets import length_buckets
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    out = {}
    for name, call in _column_hash_calls(batch).items():
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = _time_ms(call)
        out[name] = {"ms": ms, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                     "resident_bytes": resident}
    dec = batch["dec"]
    desc_lens = batch["desc"].lengths()
    out["parts_ms"] = {
        "mm_hash_decimal128[dec]": _time_ms(
            lambda: hash_cuda.mm_hash_decimal128_cuda(dec.hi, dec.lo, 42)),
        "length_buckets[desc]": _time_ms(lambda: length_buckets(desc_lens)),
    }
    return out


# ---- the distributed path -------------------------------------------------

Q97_SF = 10  # TPC-DS scale factor of the q97 tables: 28,000,000 rows per fact table
N_TABLE = 1 << 22  # rows of the table shuffle
TABLE_WIDTH = 100  # its VARCHAR(100)'s padded width
NULL_FRAC = 0.1  # null customer_sk of the nullable q97, null decimals of the table
# part -> the kernel launches it must make, and no others
DIST_LAUNCHES = {
    "step": {"xx_hash_fixed8": 1, "mm_hash_long": 3},  # buckets; bloom x2, partition_of
    "q97": {"mm_hash_long": 1},  # partition_of
    "q97_columns": {"mm_hash_long": 1},
    "q97_columns_overflow": {"mm_hash_long": 1},
    "table_shuffle": {},  # placed by key mod dp, as the JAX package's dry run places it
}


def init_single_rank():
    """A one-rank NCCL group on card 0 over a FileStore in a temporary
    directory, and the (1, 1) mesh over it; returns (mesh, the directory)."""
    import os
    import tempfile

    import torch.distributed as dist

    from spark_rapids_jni_tpu_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one host: bootstrap on loopback
    tmp = tempfile.TemporaryDirectory()
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp.name, "store"), 1),
                            rank=0, world_size=1)
    return make_mesh((1, 1)), tmp


def distributed_batch(device):
    """The distributed phase's inputs: the step's batch (make_example_batch,
    seed 0), the q97 tables at Q97_SF (generate_q97_tables, seed 42) with
    NULL_FRAC null customers drawn from numpy seed 97, and the table shuffle's
    INT32 key, nullable DECIMAL(38,2) and VARCHAR(100) padded to its width."""
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch.models import make_example_batch
    from spark_rapids_jni_tpu_torch.models.tpcds import generate_q97_tables
    from spark_rapids_jni_tpu_torch.parallel import pad_strings

    def t(a):
        return torch.from_numpy(a).to(device)

    keys, values = make_example_batch(N, seed=0, device=device)
    store, catalog = generate_q97_tables(sf=Q97_SF, seed=42)
    rng = np.random.RandomState(97)
    s_cv = rng.rand(len(store[0])) >= NULL_FRAC
    c_cv = rng.rand(len(catalog[0])) >= NULL_FRAC
    cols = (c.Column(t(store[0]), t(s_cv), c.INT32), c.Column(t(store[1]), None, c.INT32),
            c.Column(t(catalog[0]), t(c_cv), c.INT32), c.Column(t(catalog[1]), None, c.INT32),
            torch.ones(len(store[0]), dtype=torch.bool, device=device),
            torch.ones(len(catalog[0]), dtype=torch.bool, device=device))
    dec = dataclasses.replace(_decimals(rng, N_TABLE, device),
                              validity=t(rng.rand(N_TABLE) >= NULL_FRAC))
    desc = _varchar(rng, N_TABLE, TABLE_WIDTH, NULL_FRAC, device)
    table = {"k": c.Column(t(rng.randint(0, 2**31, N_TABLE).astype(np.int32)), None, c.INT32),
             "d": dec, "s": pad_strings(desc, TABLE_WIDTH)}
    return {"keys": keys, "values": values, "store": (t(store[0]), t(store[1])),
            "catalog": (t(catalog[0]), t(catalog[1])), "cols": cols, "table": table,
            "desc": desc, "host": {"store": store, "catalog": catalog, "s_cv": s_cv,
                                   "c_cv": c_cv}}


def _q97_capacity(b):
    from spark_rapids_jni_tpu_torch.models.q97 import default_q97_capacity

    return default_q97_capacity(len(b["host"]["store"][0]) + len(b["host"]["catalog"][0]), 1)


def _distributed_calls(mesh, b, cfg):
    """part -> zero-argument call of the port's distributed entry points on
    batch ``b`` over ``mesh``."""
    from spark_rapids_jni_tpu_torch.models import (
        make_distributed_q97,
        make_distributed_q97_columns,
        make_distributed_query_step,
    )
    from spark_rapids_jni_tpu_torch.parallel import DATA_AXIS, axis_size, shuffle_table

    cap = _q97_capacity(b)
    dp = axis_size(mesh, DATA_AXIS)
    key = b["table"]["k"].data
    return {
        "step": lambda: make_distributed_query_step(mesh, cfg)(b["keys"], b["values"]),
        "q97": lambda: make_distributed_q97(mesh, cap)(*b["store"], *b["catalog"]),
        "q97_columns": lambda: make_distributed_q97_columns(mesh, cap)(*b["cols"]),
        "q97_columns_overflow": lambda: make_distributed_q97_columns(mesh, cap // 4)(*b["cols"]),
        "table_shuffle": lambda: shuffle_table(b["table"], (key % dp).to(torch.int32),
                                               N_TABLE // dp, mesh),
    }


def distributed_path(mesh, b, cfg):
    """The distributed path with the counters at 0; returns the counts of the
    whole path, each part's own, and the outputs."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    per_part, outs = {}, {}
    for part, call in _distributed_calls(mesh, b, cfg).items():
        before = dict(hash_cuda.launches)
        outs[part] = call()
        torch.cuda.synchronize()
        per_part[part] = {k: v - before[k] for k, v in hash_cuda.launches.items() if v > before[k]}
    counts = dict(hash_cuda.launches)
    print(json.dumps({"distributed_launches": {"total": counts, "per_part": per_part}}))
    for part, want in DIST_LAUNCHES.items():
        if per_part[part] != want:
            raise AssertionError(f"distributed {part} launched {per_part[part]}, not {want}")
    return counts, per_part, outs


def _packed(cust, item):
    return (cust.astype(np.int64) << 32) | (item.astype(np.int64) & 0xFFFFFFFF)


def _distinct(a):
    """The sorted distinct values of ``a``, from ``np.sort`` (numpy 2.3's
    ``np.unique`` hashes, and took 118 s on 28M int64 on the card's host)."""
    a = np.sort(a)
    return a[np.concatenate(([True], a[1:] != a[:-1]))] if a.size else a


def q97_oracle(store, catalog, s_valid=None, c_valid=None):
    """(store_only, catalog_only, both) with numpy: each side's distinct packed
    (customer, item) pairs and their intersection.  Where a side has null
    customers, each distinct (NULL, item) is one more group of that side that
    joins nothing (SQL: DISTINCT groups NULLs, NULL never equals NULL)."""
    sides = []
    for (cust, item), valid in ((store, s_valid), (catalog, c_valid)):
        if valid is None:
            sides.append((_distinct(_packed(cust, item)), 0))
        else:
            sides.append((_distinct(_packed(cust[valid], item[valid])),
                          _distinct(item[~valid]).size))
    (s, s_null), (c, c_null) = sides
    at = np.minimum(np.searchsorted(c, s), max(c.size - 1, 0))  # s and c are sorted
    both = int((c[at] == s).sum()) if c.size else 0
    return s.size - both + s_null, c.size - both + c_null, both


def _q97_counts(out):
    return int(out.store_only), int(out.catalog_only), int(out.both)


def check_distributed(b, cfg, outs):
    """Every part's output checked: the step bit for bit against
    local_query_step on the same batch and device, with the dry run's
    invariants; q97 and its nullable form against the numpy oracle (and q97
    against q97_local), the overflow run's drops; the table's every row,
    limb, byte, length and validity, and its materialized strings.  Returns
    the oracle's counts and seconds."""
    from spark_rapids_jni_tpu_torch.models import local_query_step, q97_local
    from spark_rapids_jni_tpu_torch.parallel import materialize_strings

    step = outs["step"]
    local = local_query_step(b["keys"], b["values"], cfg)
    for name, g, w in zip(("bucket_sums", "bucket_counts", "bloom_bits", "probe_hits"),
                          step, local):
        _require_equal(f"distributed step {name} vs local_query_step", g, w)
    n = b["keys"].shape[0]
    got = (int(step.total_rows), int(step.dropped), int(step.bucket_counts.sum()),
           int(step.probe_hits))
    if got != (n, 0, n, n):
        raise AssertionError(f"distributed step (total_rows, dropped, counts, probe_hits) "
                             f"{got} != {(n, 0, n, n)}")

    h = b["host"]
    t0 = time.perf_counter()
    want = q97_oracle(h["store"], h["catalog"])
    want_null = q97_oracle(h["store"], h["catalog"], h["s_cv"], h["c_cv"])
    oracle_s = time.perf_counter() - t0
    q, qn, qo = outs["q97"], outs["q97_columns"], outs["q97_columns_overflow"]
    local_q = _q97_counts(q97_local(b["store"], b["catalog"]))
    if not (_q97_counts(q) == want == local_q and int(q.dropped) == 0):
        raise AssertionError(f"q97 {_q97_counts(q)} (dropped {int(q.dropped)}), q97_local "
                             f"{local_q}, oracle {want}")
    if not (_q97_counts(qn) == want_null and int(qn.dropped) == 0):
        raise AssertionError(f"nullable q97 {_q97_counts(qn)} (dropped {int(qn.dropped)}) != "
                             f"oracle {want_null}")
    rows = len(h["store"][0]) + len(h["catalog"][0])
    if int(qo.dropped) != rows - _q97_capacity(b) // 4:  # one rank keeps the first cap rows
        raise AssertionError(f"overflow run dropped {int(qo.dropped)}, not "
                             f"{rows - _q97_capacity(b) // 4}")

    tab, sent = outs["table_shuffle"], b["table"]
    if not bool(tab.valid.all()) or int(tab.dropped) != 0:
        raise AssertionError("table shuffle: a row did not arrive")
    k, d, s = (tab.columns[x] for x in ("k", "d", "s"))
    for what, g, w in (("key", k.data, sent["k"].data), ("key validity", k.validity, tab.valid),
                       ("decimal hi", d.hi, sent["d"].hi), ("decimal lo", d.lo, sent["d"].lo),
                       ("decimal validity", d.validity, sent["d"].validity),
                       ("string bytes", s.bytes, sent["s"].bytes),
                       ("string lengths", s.lengths, sent["s"].lengths),
                       ("string validity", s.validity, sent["s"].validity)):
        _require_equal(f"table shuffle {what}", g, w)
    back = materialize_strings(s)
    desc = b["desc"]
    lens = torch.where(desc.validity, desc.lengths(), 0)
    offsets = torch.zeros(N_TABLE + 1, dtype=torch.int32, device=lens.device)
    offsets[1:] = torch.cumsum(lens, 0)
    _require_equal("materialized offsets", back.offsets, offsets)
    _require_equal("materialized chars", back.chars,
                   desc.chars[torch.repeat_interleave(desc.validity,
                                                      desc.lengths().to(torch.int64))])
    return {"q97": want, "q97_columns": want_null, "oracle_s": oracle_s}


def _timed(fn) -> dict:
    """``fn``'s median time (``_time_ms``) and the peak device memory while it
    runs, beside what was resident before."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return {"ms": _time_ms(fn), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            "resident_bytes": resident}


def distributed_kernel_checks(b):
    """mm_hash_long against its plain version at the q97 paths' shapes (the
    placement hash of the composite keys and of the nullable form's mixed
    pair keys, seed 42); the step's launches have the kernels phase's shape."""
    from spark_rapids_jni_tpu_torch.models.q97 import _GOLDEN, _composite_key, _pair_key
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    keys = torch.cat([_composite_key(*b["store"]), _composite_key(*b["catalog"])])
    pairs = [_pair_key(cu.data, cu.is_valid(), it.data, it.is_valid(), side)
             for cu, it, side in ((b["cols"][0], b["cols"][1], 1), (b["cols"][2], b["cols"][3], 0))]
    k_hi = torch.cat([p[0] for p in pairs])
    mixed = k_hi ^ (torch.cat([p[1] for p in pairs]) * _GOLDEN)
    out = {}
    for what, v in (("q97 composite keys", keys), ("q97_columns mixed keys", mixed)):
        out[what] = {"n": v.numel(), "max_abs_err": _require_equal(
            f"mm_hash_long on the {what}", hash_cuda.mm_hash_long_cuda(v, 42),
            hash_cuda.mm_hash_long_torch(v, 42))}
    return out


def time_distributed(mesh, b, cfg):
    """Times and peak memory of each part, of local_query_step and q97_local
    on the same inputs, and of the step's phases, each timed alone:
    bloom build and probe, partition_of + bucket_by_partition, the whole
    all_to_all_shuffle, its collectives alone (on buffers of the send
    buffers' sizes), and the aggregation."""
    from spark_rapids_jni_tpu_torch.models import local_query_step, q97_local
    from spark_rapids_jni_tpu_torch.models.nds import _aggregate, _sharded_bloom
    from spark_rapids_jni_tpu_torch.parallel import (
        DATA_AXIS,
        all_to_all_shuffle,
        axis_group,
        axis_size,
        bucket_by_partition,
        materialize_strings,
        partition_of,
    )
    from spark_rapids_jni_tpu_torch.parallel.shuffle import _exchange

    calls = _distributed_calls(mesh, b, cfg)
    out = {part: _timed(calls[part]) for part in calls if part != "q97_columns_overflow"}
    out["local_query_step"] = _timed(lambda: local_query_step(b["keys"], b["values"], cfg))
    out["q97_local"] = _timed(lambda: q97_local(b["store"], b["catalog"]))
    shuffled = calls["table_shuffle"]()
    out["materialize_strings"] = _timed(lambda: materialize_strings(shuffled.columns["s"]))
    del shuffled

    keys, values = b["keys"], b["values"]
    dp, n = axis_size(mesh, DATA_AXIS), keys.shape[0]
    part = partition_of(keys, dp)
    cols = {"keys": keys, "values": values}
    shuffled = all_to_all_shuffle(cols, part, n, mesh)
    group = axis_group(mesh, DATA_AXIS)
    valid = torch.ones(n, dtype=torch.bool, device=keys.device)

    def exchange():
        for x in (valid, keys, values):
            _exchange(x, group)

    out["step_phases_ms"] = {
        "bloom": _time_ms(lambda: _sharded_bloom(keys, cfg, mesh)),
        "partition_of+bucket_by_partition": _time_ms(
            lambda: bucket_by_partition(partition_of(keys, dp), dp, n)),
        "all_to_all_shuffle": _time_ms(lambda: all_to_all_shuffle(cols, part, n, mesh)),
        "all_to_all": _time_ms(exchange),
        "aggregate": _time_ms(lambda: _aggregate(shuffled, cfg)),
    }
    return out


def distributed(mesh, cfg):
    """The distributed phase on ``mesh``, a (1, 1) mesh over a one-rank NCCL
    group: inputs, the path with the counters at 0, the checks, the times;
    prints the ``distributed`` line and returns the path's launch counts and
    what the plans phase holds its q97 against (the host tables, the oracle's
    and ``make_distributed_q97``'s counts, and the times of
    ``make_distributed_q97`` and ``q97_local``)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    b = distributed_batch("cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts, per_part, outs = distributed_path(mesh, b, cfg)
    want = check_distributed(b, cfg, outs)
    kernel_checks = distributed_kernel_checks(b)
    q, qn, qo = outs["q97"], outs["q97_columns"], outs["q97_columns_overflow"]
    del outs
    times = time_distributed(mesh, b, cfg)
    h = b["host"]
    print(json.dumps({"distributed": {
        "mesh": [1, 1], "backend": dist.get_backend(), "launches": per_part,
        "step": {"n": N, "cfg": cfg._asdict()},
        "q97": {"sf": Q97_SF, "rows": [len(h["store"][0]), len(h["catalog"][0])],
                "capacity": _q97_capacity(b), "counts": _q97_counts(q)},
        "q97_columns": {"null_frac": NULL_FRAC, "counts": _q97_counts(qn),
                        "overflow": {"capacity": _q97_capacity(b) // 4,
                                     "dropped": int(qo.dropped)}},
        "table_shuffle": {"n": N_TABLE, "width": TABLE_WIDTH,
                          "padded_bytes": N_TABLE * TABLE_WIDTH},
        "oracle": want, "kernel_checks": kernel_checks, "times": times,
        "batch_gen_s": gen_s}}))
    return counts, {"store": h["store"], "catalog": h["catalog"], "oracle": want["q97"],
                    "q97": _q97_counts(q), "capacity": _q97_capacity(b),
                    "times": {k: times[k] for k in ("q97", "q97_local")}}


# ---- the plans path -------------------------------------------------------

Q5_SF, Q5_SEED = 838.86, 5  # store_sales 33,554,400 rows (pads to 2**25); six streams 1.80 GB
Q3_SF, Q3_SEED = 559.24, 3  # store_sales 67,108,800 rows (2**26); 83,886 groups
PLAN_REPS = 3  # host-to-host calls timed per part, after the path's first call
# part -> the kernel launches it must make, and no others
PLAN_LAUNCHES = {
    "q5": {},
    "q3": {},
    "q3_columns": {},
    "q97_plan": {"mm_hash_long": 1},  # the Exchange's partition_of
}


def plans_batch(device, q97):
    """The plans phase's inputs: q5 and q3 data from their generators, q3's
    facts as device Columns with DECIMAL(38,2) prices (the decimal-columns
    step's inputs), and the distributed phase's q97 tables as one piece at
    its capacity."""
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch.models import Q97Batch, generate_q3_data, generate_q5_data
    from spark_rapids_jni_tpu_torch.models.q3 import _dims, _geometry, _price_limbs

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    q5 = generate_q5_data(sf=Q5_SF, seed=Q5_SEED)
    q3 = generate_q3_data(sf=Q3_SF, seed=Q3_SEED)
    hi, lo = _price_limbs(q3.ss_ext_sales_price)
    cols = (c.Column(t(q3.ss_item_sk), t(q3.ss_item_sk_valid), c.INT32),
            c.Column(t(q3.ss_sold_date_sk), t(q3.ss_sold_date_sk_valid), c.INT32),
            c.Decimal128Column(t(hi), t(lo), None, c.decimal(38, 2)),
            *(t(v) for v in _dims(q3).values()))
    piece = Q97Batch(*q97["store"], *q97["catalog"], capacity=q97["capacity"])
    return {"device": device, "q5": q5, "q3": q3, "q3_cols": cols,
            "geo3": tuple(sorted(_geometry(q3).items())), "piece": piece}


def _q3_columns_calls(mesh, b):
    """(the step on the resident columns, the step from host arrays: upload,
    step, download)."""
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch.models.q3 import _price_limbs, _q3_columns_step

    def resident():
        return _q3_columns_step(mesh, b["geo3"])(*b["q3_cols"])

    def from_host():
        q3, dev = b["q3"], b["device"]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        hi, lo = _price_limbs(q3.ss_ext_sales_price)
        out = _q3_columns_step(mesh, b["geo3"])(
            c.Column(t(q3.ss_item_sk), t(q3.ss_item_sk_valid), c.INT32),
            c.Column(t(q3.ss_sold_date_sk), t(q3.ss_sold_date_sk_valid), c.INT32),
            c.Decimal128Column(t(hi), t(lo), None, c.decimal(38, 2)),
            *(t(v) for v in (q3.item_brand_id, q3.item_manufact_id, q3.date_year, q3.date_moy)))
        return [x.cpu() for x in out]

    return resident, from_host


def _plans_calls(mesh, b):
    """part -> zero-argument call of the port's plan entry points on batch
    ``b``: q5 and q3 locally on the batch's device, q3's decimal-columns step
    and q97's plan form on ``mesh``."""
    from spark_rapids_jni_tpu_torch.models import q3_local, q5_local, run_q97_piece

    dev = b["device"]
    return {
        "q5": lambda: q5_local(b["q5"], device=dev),
        "q3": lambda: q3_local(b["q3"], device=dev),
        "q3_columns": _q3_columns_calls(mesh, b)[0],
        "q97_plan": lambda: run_q97_piece(mesh, b["piece"]),
    }


def _cache_counts():
    from spark_rapids_jni_tpu_torch.models.q3 import _q3_columns_step
    from spark_rapids_jni_tpu_torch.plans import plan_cache

    s, info = plan_cache.stats(), _q3_columns_step.cache_info()
    return {"hits": s["hits"], "traces": s["traces"], "step_hits": info.hits,
            "step_misses": info.misses}


def plans_path(mesh, b):
    """The plans path with the counters at 0; returns the counts of the whole
    path, each part's own, and the outputs.  Then each part once more, which
    must be a cache hit and give the same answer."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    calls = _plans_calls(mesh, b)
    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    per_part, outs = {}, {}
    for part, call in calls.items():
        before = dict(hash_cuda.launches)
        outs[part] = call()
        torch.cuda.synchronize()
        per_part[part] = {k: v - before[k] for k, v in hash_cuda.launches.items() if v > before[k]}
    counts = dict(hash_cuda.launches)
    print(json.dumps({"plans_launches": {"total": counts, "per_part": per_part}}))
    for part, want in PLAN_LAUNCHES.items():
        if per_part[part] != want:
            raise AssertionError(f"plans {part} launched {per_part[part]}, not {want}")
    second = {}
    for part, call in calls.items():
        before = _cache_counts()
        again = call()
        after = _cache_counts()
        hit = (after["hits"] == before["hits"] + 1 and after["traces"] == before["traces"]
               if part != "q3_columns" else after["step_hits"] == before["step_hits"] + 1
               and after["step_misses"] == before["step_misses"])
        if not hit:
            raise AssertionError(f"plans {part}: the second call was no cache hit "
                                 f"({before} -> {after})")
        same = (all(torch.equal(x, y) for x, y in zip(again, outs[part]))
                if part == "q3_columns" else
                [tuple(map(int, again))] == [tuple(map(int, outs[part]))]
                if part == "q97_plan" else again == outs[part])
        if not same:
            raise AssertionError(f"plans {part}: the second call gave another answer")
        second[part] = "hit"
    return counts, per_part, outs, second


def q3_oracle(q3):
    """(sums int64[groups], counts int64[groups], rows) of q3 with numpy: the
    valid rows whose keys are in their dims, filtered by manufacturer and
    month, summed exactly in int64 by (year, brand); rows ordered by year,
    sum descending, brand."""
    n_items, n_dates = len(q3.item_sk), len(q3.date_sk)
    isk = q3.ss_item_sk.astype(np.int64)
    dsk = q3.ss_sold_date_sk.astype(np.int64) - int(q3.date_sk[0])
    ok = (q3.ss_item_sk_valid & q3.ss_sold_date_sk_valid & (isk >= 1) & (isk <= n_items)
          & (dsk >= 0) & (dsk < n_dates))
    i, d, price = isk[ok] - 1, dsk[ok], q3.ss_ext_sales_price[ok]
    keep = (q3.item_manufact_id[i] == q3.manufact_id) & (q3.date_moy[d] == q3.moy)
    year0 = int(q3.date_year.min())
    n_years, n_brands = int(q3.date_year.max()) - year0 + 1, len(q3.brand_names)
    g = ((q3.date_year[d][keep].astype(np.int64) - year0) * n_brands
         + q3.item_brand_id[i][keep].astype(np.int64) - 1)
    sums = np.zeros(n_years * n_brands, np.int64)
    np.add.at(sums, g, price[keep])
    counts = np.bincount(g, minlength=n_years * n_brands)
    rows = [(year0 + int(x) // n_brands, int(x) % n_brands + 1,
             q3.brand_names[int(x) % n_brands], int(sums[x])) for x in np.nonzero(counts)[0]]
    rows.sort(key=lambda r: (r[0], -r[3], r[1]))
    return sums, counts, rows


def check_plans(b, q97, outs):
    """Every part's output checked: q5 against q5_local_unfused on the same
    device and the rollup of q5_host_channel_partials; q3 and
    q3_local_unfused against the numpy oracle, and q3's decimal-columns step
    group by group; q97's plan form against the distributed phase's oracle
    and make_distributed_q97.  Returns the oracles' seconds and sizes."""
    from spark_rapids_jni_tpu_torch.models.q3 import q3_local_unfused
    from spark_rapids_jni_tpu_torch.models.q5 import (
        _dim_ids,
        _facts_of,
        q5_host_channel_partials,
        q5_local_unfused,
        q5_rollup,
    )
    from spark_rapids_jni_tpu_torch.models.tpcds import CHANNELS

    q5, q3, dev = b["q5"], b["q3"], b["device"]
    got5 = outs["q5"]
    if q5_local_unfused(q5, device=dev) != got5:
        raise AssertionError("q5_local != q5_local_unfused")
    t0 = time.perf_counter()
    per = {n: q5_host_channel_partials(
        _facts_of(q5.channels[n]), len(q5.channels[n].dim_sk), q5.date_sk, q5.date_days,
        q5.sales_date_lo, q5.sales_date_hi) for n in CHANNELS}
    q5_oracle_s = time.perf_counter() - t0
    if q5_rollup(per, _dim_ids(q5)) != got5:
        raise AssertionError("q5_local != the rollup of q5_host_channel_partials")

    t0 = time.perf_counter()
    sums, counts, rows = q3_oracle(q3)
    q3_oracle_s = time.perf_counter() - t0
    got3 = [tuple(r) for r in outs["q3"]]
    if got3 != rows or not rows:
        raise AssertionError(f"q3_local ({len(got3)} rows) != the numpy oracle ({len(rows)})")
    if [tuple(r) for r in q3_local_unfused(q3, device=dev)] != rows:
        raise AssertionError("q3_local_unfused != the numpy oracle")
    hi, lo, cnt = (x.cpu().numpy() for x in outs["q3_columns"])
    if not (np.array_equal(cnt, counts) and np.array_equal(lo, sums)
            and np.array_equal(hi, sums >> 63)):
        raise AssertionError("q3 columns step (hi, lo, counts) != the numpy oracle")

    got97 = outs["q97_plan"]
    counts97 = tuple(int(x) for x in got97[:3])
    if not (counts97 == tuple(q97["oracle"]) == tuple(q97["q97"]) and int(got97.dropped) == 0):
        raise AssertionError(f"q97_plan {counts97} (dropped {int(got97.dropped)}), oracle "
                             f"{q97['oracle']}, make_distributed_q97 {q97['q97']}")
    return {"q5_oracle_s": q5_oracle_s, "q3_oracle_s": q3_oracle_s, "q5_rows": len(got5),
            "q3_rows": len(rows), "q97_counts": counts97}


def plans_kernel_checks(b):
    """mm_hash_long against its plain version at the q97 plan's shape: the
    packed keys of the padded store and catalog scans, in Union order."""
    from spark_rapids_jni_tpu_torch.models.q97 import _composite_key
    from spark_rapids_jni_tpu_torch.ops import hash_cuda
    from spark_rapids_jni_tpu_torch.parallel import quantized_rows

    p = b["piece"]
    keys = []
    for cust, item in ((p.s_cust, p.s_item), (p.c_cust, p.c_item)):
        m = quantized_rows(len(cust), 1)
        padded = [np.concatenate([a, np.zeros(m - len(a), a.dtype)]) for a in (cust, item)]
        keys.append(_composite_key(*(torch.from_numpy(a).to(b["device"]) for a in padded)))
    keys = torch.cat(keys)
    return {"n": keys.numel(), "max_abs_err": _require_equal(
        "mm_hash_long on the q97 plan's keys", hash_cuda.mm_hash_long_cuda(keys, 42),
        hash_cuda.mm_hash_long_torch(keys, 42))}


def _host_to_host(call, reps=PLAN_REPS) -> dict:
    """Median seconds of ``call`` (host to host: it ends in host results) and
    the peak device memory of one call beside what was resident before."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return {"s": statistics.median(times), "runs_s": times,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "resident_bytes": resident}


def _pad_upload(compiled, tables) -> dict:
    """The host pad (numpy) and the upload of one call of ``compiled``, each
    timed alone on the host clock; returns them with the uploaded inputs."""
    from spark_rapids_jni_tpu_torch.plans import pad_tables, plan_inputs

    t0 = time.perf_counter()
    padded = pad_tables(compiled.plan, tables, 1)  # one data shard: a (1, 1) mesh
    t1 = time.perf_counter()
    flat = plan_inputs(compiled, padded)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"pad_s": t1 - t0, "upload_s": t2 - t1,
            "upload_bytes": sum(x.numel() * x.element_size() for x in flat)}, flat


def _segment_phases(b):
    """One SegmentAgg's index_add_ alone, on the ids and values the plans
    give it: q5's store sales prices into their 6 dim buckets (the masked
    rows, most of them, dropped), the same rows spread over 65536 buckets,
    and q3's prices into its groups (83,886 at full size; masked rows dropped)."""
    from spark_rapids_jni_tpu_torch.models.q3 import _geometry, _group
    from spark_rapids_jni_tpu_torch.models.q5 import _window_member
    from spark_rapids_jni_tpu_torch.plans.compiler import segment_sum

    dev, q5, q3 = b["device"], b["q5"], b["q3"]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    ch = q5.channels["store"]
    n_dim = len(ch.dim_sk)
    sk, price = t(ch.sales_sk), t(ch.sales_price)
    ok = (t(ch.sales_sk_valid) & (sk >= 1) & (sk <= n_dim)
          & _window_member(t(ch.sales_date), t(ch.sales_date_valid), t(q5.date_sk),
                           t(q5.date_days), q5.sales_date_lo, q5.sales_date_hi))
    ids = torch.where(ok, sk - 1, -1)
    vals = torch.where(ok, price, 0)
    spread = torch.arange(sk.numel(), device=dev, dtype=torch.int32) % 65536

    geo = _geometry(q3)
    item, date = b["q3_cols"][0], b["q3_cols"][1]
    brand, manufact, year, moy = b["q3_cols"][3:]
    i_idx = torch.clamp(item.data - 1, 0, brand.shape[0] - 1)
    d_idx = torch.clamp(date.data - geo["date_sk0"], 0, year.shape[0] - 1)
    q3_ok = (item.is_valid() & date.is_valid() & (manufact[i_idx] == geo["manufact_id"])
             & (moy[d_idx] == geo["moy"]))
    groups = geo["n_years"] * geo["n_brands"]
    q3_ids = torch.where(q3_ok, _group(i_idx, d_idx, brand, year, n_brands=geo["n_brands"],
                                       year0=geo["year0"], n_years=geo["n_years"]), -1)
    q3_vals = torch.where(q3_ok, t(q3.ss_ext_sales_price), 0)
    return {"rows": [sk.numel(), q3_ids.numel()],
            "q5_store_sales_kept": int(ok.sum()), "q3_kept": int(q3_ok.sum()),
            "q5_store_sales_6_buckets_ms": _time_ms(lambda: segment_sum(vals, ids, n_dim)),
            "same_rows_65536_buckets_ms": _time_ms(lambda: segment_sum(vals, spread, 65536)),
            "q3_groups": groups,
            "q3_groups_ms": _time_ms(lambda: segment_sum(q3_vals, q3_ids, groups))}


def _unfused_device_only(b):
    """The unfused forms' device bodies on inputs already on the card: q5's
    six streams through ``_channel_partials``, q3 through ``_partials``."""
    from spark_rapids_jni_tpu_torch.models.q3 import _dims, _facts, _geometry, _partials
    from spark_rapids_jni_tpu_torch.models.q5 import _channel_partials, _facts_of
    from spark_rapids_jni_tpu_torch.models.tpcds import CHANNELS

    dev, q5, q3 = b["device"], b["q5"], b["q3"]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    chans = {n: ({k: t(v) for k, v in _facts_of(q5.channels[n]).items()},
                 len(q5.channels[n].dim_sk)) for n in CHANNELS}
    dim_sk, dim_days = t(q5.date_sk), t(q5.date_days)
    facts = [t(v) for v in _facts(q3).values()]
    dims = {k: t(v) for k, v in _dims(q3).items()}
    geo = _geometry(q3)
    return {
        "q5_local_unfused": {"ms": _time_ms(lambda: [_channel_partials(
            ch, n_dim, dim_sk, dim_days, q5.sales_date_lo, q5.sales_date_hi)
            for ch, n_dim in chans.values()])},
        "q3_local_unfused": {"ms": _time_ms(lambda: _partials(*facts, **dims, **geo))},
    }


def time_plans(mesh, b):
    """Host-to-host time and peak memory of each part's whole call, with its
    host pad and upload share; the unfused forms host to host; the
    device-only time of each CompiledPlan.fn (make_distributed_q5/q3 on the
    mesh, the q97 plan), of the decimal-columns step and of the unfused
    bodies on inputs already on the card; and one SegmentAgg's index_add_
    alone."""
    from spark_rapids_jni_tpu_torch.models import make_distributed_q3, make_distributed_q5
    from spark_rapids_jni_tpu_torch.models.q3 import _dims, _facts, _q3_tables, q3_local_unfused
    from spark_rapids_jni_tpu_torch.models.q5 import _plan_and_tables, q5_local_unfused
    from spark_rapids_jni_tpu_torch.models.q97 import q97_plan
    from spark_rapids_jni_tpu_torch.plans import compiled_plan_for

    calls = _plans_calls(mesh, b)
    resident, from_host = _q3_columns_calls(mesh, b)
    host = {part: _host_to_host(calls[part]) for part in ("q5", "q3", "q97_plan")}
    host["q3_columns"] = _host_to_host(from_host)
    dev = b["device"]
    host["q5_local_unfused"] = _host_to_host(lambda: q5_local_unfused(b["q5"], device=dev), 2)
    host["q3_local_unfused"] = _host_to_host(lambda: q3_local_unfused(b["q3"], device=dev), 2)

    p = b["piece"]
    q97_tables = {"store": {"cust": p.s_cust, "item": p.s_item},
                  "catalog": {"cust": p.c_cust, "item": p.c_item}}
    executors = {
        "make_distributed_q5": (make_distributed_q5(mesh, b["q5"]), _plan_and_tables(b["q5"])[1]),
        "make_distributed_q3": (make_distributed_q3(mesh, b["q3"]),
                                _q3_tables(_facts(b["q3"]), _dims(b["q3"]))),
        "q97_plan": (compiled_plan_for(q97_plan(p.capacity), mesh, q97_tables), q97_tables),
    }
    device_only = {}
    for name, (compiled, tables) in executors.items():
        share, flat = _pad_upload(compiled, tables)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        device_only[name] = {"ms": _time_ms(lambda: compiled.fn(*flat)),
                             "peak_mem_bytes": torch.cuda.max_memory_allocated(), **share}
        del flat
    device_only["q3_columns_step"] = {"ms": _time_ms(resident)}
    device_only.update(_unfused_device_only(b))
    for part, name in (("q5", "make_distributed_q5"), ("q3", "make_distributed_q3"),
                       ("q97_plan", "q97_plan")):
        host[part].update({k: device_only[name][k] for k in ("pad_s", "upload_s",
                                                              "upload_bytes")})
    return {"host_to_host": host, "device_only": device_only,
            "segment_sum": _segment_phases(b)}


def plans(mesh, q97):
    """The plans phase on ``mesh`` (the distributed phase's): inputs, the
    path with the counters at 0, a second call of each part (a cache hit),
    the checks, the times; prints the ``plans`` line and returns the path's
    launch counts and what the governed phase holds its runs against (the
    q5 and q3 data, ``q5_local``'s and ``q3_local``'s rows and host-to-host
    seconds, those of q3's decimal-columns step from host arrays and of the
    ungoverned q97 plan)."""
    t0 = time.perf_counter()
    b = plans_batch("cuda", q97)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts, per_part, outs, second = plans_path(mesh, b)
    checks = check_plans(b, q97, outs)
    kernel_check = plans_kernel_checks(b)
    q5_rows, q3_rows = outs["q5"], [tuple(r) for r in outs["q3"]]
    del outs
    times = time_plans(mesh, b)
    times["device_only"].update({"make_distributed_q97": q97["times"]["q97"],
                                 "q97_local": q97["times"]["q97_local"]})
    q5, q3 = b["q5"], b["q3"]
    print(json.dumps({"plans": {
        "mesh": [1, 1], "launches": per_part, "second_call": second,
        "q5": {"sf": Q5_SF, "seed": Q5_SEED,
               "rows": {n: [len(ch.sales_sk), len(ch.ret_sk)] for n, ch in q5.channels.items()}},
        "q3": {"sf": Q3_SF, "seed": Q3_SEED, "rows": len(q3.ss_item_sk),
               "items": len(q3.item_sk), "brands": len(q3.brand_names)},
        "q97_plan": {"capacity": b["piece"].capacity, "rows": b["piece"].rows},
        "checks": checks, "kernel_check": kernel_check, "times": times,
        "batch_gen_s": gen_s}}))
    host = times["host_to_host"]
    return counts, {"q5": q5, "q5_rows": q5_rows, "q5_local_s": host["q5"]["s"],
                    "q3": q3, "q3_rows": q3_rows, "q3_local_s": host["q3"]["s"],
                    "q3_columns_s": host["q3_columns"]["s"],
                    "q97_piece_s": host["q97_plan"]["s"]}


# ---- the governed path -----------------------------------------------------

GOV_TIGHT = 0.5  # the tight budget: this share of a run's working set
GOV_REPS = 2  # calls of each governed run, each checked
# run -> the kernel launches of one call, and no others
GOV_LAUNCHES = {
    "q97_default": {"mm_hash_long": 1},  # one piece: the Exchange's partition_of
    "q97_tight": {"mm_hash_long": 2},  # two key-space pieces
    "q5_default": {},
    "q5_tight": {},
    "q3_default": {},
    "q3_tight": {},
    "q3_columns_default": {},
    "q3_columns_tight": {},
}
GOV_TASKS = {"q97": 97, "q5": 5, "q3": 3, "q3_columns": 33}  # query -> its task id
MONTE_CARLO = dict(n_tasks=16, n_threads=8, n_shuffle_threads=2, budget_bytes=64 << 20,
                   task_max_bytes=48 << 20, allocs_per_task=50, skewed=True,
                   inject_retry_pct=5.0, seed=7, spill_buffers=8, duration_s=4.0)


def _governed_runs(mesh, q97, gp):
    """query -> (call of the governed runner under ``budget``, its
    working-set bytes): run_distributed_q97 on the SF10 tables,
    run_distributed_q5 on the plans phase's q5 data, run_distributed_q3 and
    run_distributed_q3_columns on its q3 data, on ``mesh``."""
    from spark_rapids_jni_tpu_torch.models import (
        Q97Batch,
        run_distributed_q3,
        run_distributed_q3_columns,
        run_distributed_q5,
        run_distributed_q97,
    )
    from spark_rapids_jni_tpu_torch.models.q3 import _facts, _price_limbs, q3_working_set_bytes
    from spark_rapids_jni_tpu_torch.models.q5 import _plan_and_tables
    from spark_rapids_jni_tpu_torch.models.q97 import q97_working_set_bytes
    from spark_rapids_jni_tpu_torch.plans import plan_working_set_bytes

    store, catalog, cap = q97["store"], q97["catalog"], q97["capacity"]
    plan, tables = _plan_and_tables(gp["q5"])
    q3 = gp["q3"]
    # the columns form's facts carry the price as two int64 limbs, not as one
    facts = {k: v for k, v in _facts(q3).items() if k != "price"}
    facts["price_hi"], facts["price_lo"] = _price_limbs(q3.ss_ext_sales_price)
    ws = {"q97": q97_working_set_bytes(Q97Batch(*store, *catalog, capacity=cap), 1),
          "q5": plan_working_set_bytes(plan, tables, 1),
          "q3": q3_working_set_bytes(q3, 1),
          "q3_columns": q3_working_set_bytes(facts, 1)}
    del facts
    call = {"q97": lambda budget: run_distributed_q97(mesh, store, catalog, budget=budget,
                                                       task_id=GOV_TASKS["q97"], capacity=cap,
                                                       manage_task=False),
            "q5": lambda budget: run_distributed_q5(mesh, gp["q5"], budget=budget,
                                                    task_id=GOV_TASKS["q5"], manage_task=False),
            "q3": lambda budget: run_distributed_q3(mesh, q3, budget=budget,
                                                    task_id=GOV_TASKS["q3"], manage_task=False),
            "q3_columns": lambda budget: run_distributed_q3_columns(
                mesh, q3, budget=budget, task_id=GOV_TASKS["q3_columns"], manage_task=False)}
    return call, ws


def _governed_once(gov, budget, task_id, call):
    """One governed call under ``budget`` in its task: the answer and what it
    cost (host-to-host seconds, splits and retries, executions, the budget's
    high-water reservation, the device peak beside what was resident, and
    the kernel launches)."""
    from spark_rapids_jni_tpu_torch.mem import task_context
    from spark_rapids_jni_tpu_torch.ops import hash_cuda
    from spark_rapids_jni_tpu_torch.plans import plan_cache

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    budget.reset_peak()
    before = dict(hash_cuda.launches)
    execs = plan_cache.stats()["execute_calls"]
    t0 = time.perf_counter()
    with task_context(gov, task_id):
        out = call(budget)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        splits = gov.get_and_reset_num_split_retry(task_id)
        retries = gov.get_and_reset_num_retry(task_id)
    return out, {
        "s": seconds, "splits": splits, "retries": retries,
        "executions": plan_cache.stats()["execute_calls"] - execs,
        "reserved_peak_bytes": budget.reset_peak(), "budget_bytes": budget.limit,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(), "resident_bytes": resident,
        "launches": {k: v - before[k] for k, v in hash_cuda.launches.items() if v > before[k]}}


def governed_path(mesh, q97, gp):
    """The governed path with the counters at 0: each runner GOV_REPS times
    under the default (card-sized) budget and under GOV_TIGHT of its working
    set; returns the path's launch counts, each run's calls and answers."""
    from spark_rapids_jni_tpu_torch.mem import BudgetedResource, MemoryGovernor
    from spark_rapids_jni_tpu_torch.mem.governed import default_device_budget
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    gov = MemoryGovernor.initialize()
    call, ws = _governed_runs(mesh, q97, gp)
    budgets = {"default": default_device_budget(gov)}
    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    runs, answers = {}, {}
    for query in GOV_TASKS:
        budgets[f"{query}_tight"] = BudgetedResource(gov, int(ws[query] * GOV_TIGHT))
        for kind in ("default", "tight"):
            run = f"{query}_{kind}"
            budget = budgets["default" if kind == "default" else run]
            calls = [_governed_once(gov, budget, GOV_TASKS[query], call[query])
                     for _ in range(GOV_REPS)]
            answers[run] = [out for out, _ in calls]
            runs[run] = {"working_set_bytes": ws[query], "calls": [c for _, c in calls]}
    counts = dict(hash_cuda.launches)
    print(json.dumps({"governed_launches": {
        "total": counts, "per_run": {r: [c["launches"] for c in v["calls"]]
                                     for r, v in runs.items()}}}))
    for run, want in GOV_LAUNCHES.items():
        got = [c["launches"] for c in runs[run]["calls"]]
        if got != [want] * GOV_REPS:
            raise AssertionError(f"governed {run} launched {got}, not {want} per call")
    return counts, runs, answers, budgets, gov


def check_governed(q97, gp, runs, answers, budgets, gov):
    """Every answer equal to the ungoverned run's (q97: the distributed
    phase's oracle and make_distributed_q97; q5: q5_local; q3 and its
    decimal-columns form: q3_local, itself held to the numpy oracle); each
    tight run split (an arbiter split signal, and two or more executions of
    the plan where the runner has one: q3's columns form runs its step, not
    a plan) and each default run did not; every reservation released and no
    thread left blocked."""
    for run, outs in answers.items():
        query = run.rsplit("_", 1)[0]
        for out in outs:
            if query == "q97":
                got = (int(out.store_only), int(out.catalog_only), int(out.both))
                if not got == tuple(q97["oracle"]) == tuple(q97["q97"]):
                    raise AssertionError(f"governed {run} {got} != oracle {q97['oracle']}")
            elif query == "q5" and out != gp["q5_rows"]:
                raise AssertionError(f"governed {run} != q5_local")
            elif query.startswith("q3") and [tuple(r) for r in out] != gp["q3_rows"]:
                raise AssertionError(f"governed {run} != q3_local")
        for c in runs[run]["calls"]:
            split = c["splits"] >= 1 and (query == "q3_columns" or c["executions"] >= 2)
            if split != run.endswith("tight"):
                raise AssertionError(f"governed {run}: executions {c['executions']}, "
                                     f"splits {c['splits']}")
    used = {name: b.used for name, b in budgets.items()}
    blocked = gov.arbiter.total_blocked_or_bufn()
    if any(used.values()) or blocked:
        raise AssertionError(f"governed: budget left in use {used}, blocked threads {blocked}")
    return {"budget_used_after": used, "blocked_or_bufn_after": blocked}


def governed_kernel_check(q97, device="cuda"):
    """mm_hash_long against its plain version at a tight q97 run's shape: the
    packed keys of the first key-space piece's padded scans; with the host
    seconds of that split (``split_q97_batch``, numpy) alone."""
    from spark_rapids_jni_tpu_torch.models import Q97Batch, split_q97_batch
    from spark_rapids_jni_tpu_torch.models.q97 import _composite_key
    from spark_rapids_jni_tpu_torch.ops import hash_cuda
    from spark_rapids_jni_tpu_torch.parallel import quantized_rows

    t0 = time.perf_counter()
    piece = split_q97_batch(Q97Batch(*q97["store"], *q97["catalog"],
                                     capacity=q97["capacity"]))[0]
    split_s = time.perf_counter() - t0
    keys = []
    for cust, item in ((piece.s_cust, piece.s_item), (piece.c_cust, piece.c_item)):
        m = quantized_rows(len(cust), 1)
        padded = [np.concatenate([a, np.zeros(m - len(a), a.dtype)]) for a in (cust, item)]
        keys.append(_composite_key(*(torch.from_numpy(a).to(device) for a in padded)))
    keys = torch.cat(keys)
    return {"n": keys.numel(), "q97_split_s": split_s, "max_abs_err": _require_equal(
        "mm_hash_long on a tight q97 piece's keys", hash_cuda.mm_hash_long_cuda(keys, 42),
        hash_cuda.mm_hash_long_torch(keys, 42))}


def governed_monte_carlo(device="cuda"):
    """A few seconds of the monte-carlo stress harness: tasks, shuffle threads
    and injected OOMs over one budget, with a spillable cache of buffers on
    ``device`` (pinned host copies when spilled); must come out ok."""
    from spark_rapids_jni_tpu_torch.mem.montecarlo import MonteCarloConfig, run_monte_carlo

    t0 = time.perf_counter()
    stats = run_monte_carlo(MonteCarloConfig(**MONTE_CARLO, device=device))
    seconds = time.perf_counter() - t0
    if not (stats.ok and stats.cache_pins > 0):
        raise AssertionError(f"monte carlo: {stats}")
    return {"config": MONTE_CARLO, "seconds": seconds, "ok": stats.ok,
            "tasks_completed": stats.tasks_completed, "retries": stats.retries,
            "splits": stats.splits, "injected": stats.injected, "peak_used": stats.peak_used,
            "cache_pins": stats.cache_pins, "cache_spills": stats.cache_spills}


def governed(mesh, q97, gp, device="cuda"):
    """The governed phase on ``mesh`` (the distributed phase's): the arbiter's
    build, the path with the counters at 0, the checks, a kernel check at a
    split piece's shape and the monte-carlo harness; prints the ``governed``
    line and returns the path's launch counts."""
    from spark_rapids_jni_tpu_torch.mem import MemoryGovernor, arbiter

    t0 = time.perf_counter()
    arbiter._ensure_lib()
    build_s = time.perf_counter() - t0
    try:
        counts, runs, answers, budgets, gov = governed_path(mesh, q97, gp)
        checks = check_governed(q97, gp, runs, answers, budgets, gov)
    finally:
        MemoryGovernor.shutdown()
    kernel_check = governed_kernel_check(q97, device)
    monte_carlo = governed_monte_carlo(device)
    print(json.dumps({"governed": {
        "mesh": [1, 1], "arbiter_build_s": build_s, "tight_share": GOV_TIGHT, "runs": runs,
        "ungoverned_s": {"q5_local": gp["q5_local_s"], "q3_local": gp["q3_local_s"],
                         "q3_columns_step_from_host": gp["q3_columns_s"],
                         "run_q97_piece": gp["q97_piece_s"]},
        "checks": checks, "kernel_check": kernel_check, "monte_carlo": monte_carlo}}))
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from spark_rapids_jni_tpu_torch.models import QueryStepConfig

    cfg = QueryStepConfig(n_buckets=1024, bloom_bits=8_388_608, bloom_hashes=6)
    build()
    counts, keys, values, cols, step, mm, xx = main_path(cfg)
    cpu_s, hits, bits_set = check_against_cpu(cfg, keys, values, cols, step, mm, xx)
    del cols, step, mm, xx
    n_vectors = check_spark_vectors()
    rates = _card_rates()
    rows = kernels(counts, rates)
    step_ms, phases, peak = time_step(cfg, keys, values)
    print(json.dumps({"step": {
        "n": N, "cfg": cfg._asdict(), "step_ms": step_ms, "phases_ms": phases,
        "peak_mem_bytes": peak, "cpu_step_s": cpu_s, "probe_hits": hits,
        "bloom_bits_set": bits_set, "spark_vector_cases": n_vectors,
        "mem_rate_Bps": rates[0], "int32_rate_ops": rates[1]}}))
    del keys, values

    t0 = time.perf_counter()
    batch = column_hash_batch("cuda")
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    col_counts, outs = column_hash_path(batch)
    cpu_col_s = check_column_hash_against_cpu(batch, outs)
    del outs
    n_string_vectors = check_spark_string_vectors("cuda")
    rows += [strings_kernel(batch, col_counts, rates), spans_kernel(batch, col_counts, rates),
             decimal_kernel(batch, col_counts, rates)]
    staging_pairs(batch)
    launch_bounds(batch, rates)
    print(json.dumps({"column_hash": {
        "n": N_COL, "n_nested": N_NESTED,
        "chars_bytes": {k: int(batch[k].offsets[-1]) for k in ("id16", "desc")},
        "calls": time_column_hash(batch), "cpu_s": cpu_col_s, "batch_gen_s": gen_s,
        "spark_string_vector_cases": n_string_vectors}}))
    del batch

    import torch.distributed as dist

    mesh, tmp = init_single_rank()  # one NCCL group for the distributed and plans phases
    try:
        dist_counts, q97 = distributed(mesh, cfg)
        plan_counts, gp = plans(mesh, q97)
        gov_counts = governed(mesh, q97, gp)
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    for row in rows:  # the main path is now all five paths: their launches add up
        row["launches"] = (counts[row["name"]] + col_counts[row["name"]]
                           + dist_counts[row["name"]] + plan_counts[row["name"]]
                           + gov_counts[row["name"]])
    print(_nvidia_smi("name,power.limit", units=True))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
