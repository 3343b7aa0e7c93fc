#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``spark_rapids_jni_tpu_torch``).

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It exits non-zero, and prints no result, where there is no CUDA device or no
port package beside it.  Otherwise it:

1. builds ``csrc/hash_kernels.cu`` for sm_90a (nvcc, loaded with ctypes);
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
   seed form, a ``step`` line, the card's name and power limit, a
   ``kernels`` line and, last, the ``ok`` line.

Every check that fails raises, and the script then exits non-zero.
"""

from __future__ import annotations

import json
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


def kernels(counts, mem_rate, int_rate):
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
            bytes_ms = nbytes / mem_rate * 1e3
            ops_ms = N * ops / int_rate * 1e3
            line = {
                "kernel": name, "seed": form, "n": N,
                "kernel_ms": _time_ms(lambda: wrapper(v, aux)),
                "plain_ms": _time_ms(lambda: plain(v, aux)),
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
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
    mem_rate, int_rate = _card_rates()
    rows = kernels(counts, mem_rate, int_rate)
    step_ms, phases, peak = time_step(cfg, keys, values)
    print(json.dumps({"step": {
        "n": N, "cfg": cfg._asdict(), "step_ms": step_ms, "phases_ms": phases,
        "peak_mem_bytes": peak, "cpu_step_s": cpu_s, "probe_hits": hits,
        "bloom_bits_set": bits_set, "spark_vector_cases": n_vectors,
        "mem_rate_Bps": mem_rate, "int32_rate_ops": int_rate}}))
    print(_nvidia_smi("name,power.limit", units=True))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
