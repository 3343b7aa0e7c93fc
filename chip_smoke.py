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
   CPU over their first 2**20 rows and checks the Spark string, mixed-row and string-list vectors on the
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
   and the arbiter's build seconds);
12. drives the bloom filter path with the launch counters at 0 again, at
   Spark's runtime-filter settings: four partial filters of 8,388,608 bits
   and 6 hashes over 1,000,000 INT64 build keys (5% nulls), merged,
   serialized to Spark's bytes and deserialized onto the card, then probed
   with 2**26 keys (10% nulls, a quarter drawn from the build keys); the
   largest filter (67,108,864 bits, 12 hashes) put with 4,000,000 keys and
   probed with the same keys; 1,024 keys put into an empty largest filter;
   ``mm_hash_long`` must launch twice per put and per probe, and each put
   take its path (scatter, or sorted for the small insert); holds every
   filter and the bytes bit for bit against the CPU run, the probe flags
   on a strided 2**20-row sample, checks on the card that every inserted
   key hits and null rows stay null, holds ``mm_hash_long`` with the
   probe's per-row seed against its plain version, and prints a ``bloom``
   line (times, peak memory, the false-positive share beside Spark's
   expected fpp);
13. drives the DECIMAL128 path with the counters at 0 again (plain torch; no
   kernel may launch): ``multiply128`` of two DECIMAL(38,10) columns of
   2**24 rows at scale 6, with and without ``interim_cast``, the divide,
   integer-divide, remainder, add and subtract calls at 2**22 rows with 1%
   zero divisors, and one call per remaining branch at 2**20 rows; holds
   every output against the CPU run on a strided 16,384-row sample and the
   ``DecimalUtilsTest`` vectors on the card, and prints a ``decimal`` line
   (time, profiled kernels and peak memory per call);
14. drives the JCUDF row path with the counters at 0 again (no kernel may
   launch): ``convert_to_rows`` and ``convert_from_rows`` and their
   fixed-width-optimized twins over TPC-DS store_sales as the plugin's
   Parquet reader hands it (2**23 rows of 104 B, one 872 MB batch), both
   directions over an (INT32, VARCHAR(100), DECIMAL(38,2)) table of 2**22
   rows, also in batches of at most 2**26 B; holds the rows against the
   numpy host arm on the CPU for the whole tables and the oracle arm on the
   card, and every read-back column against its input, and prints a
   ``rows`` line (times, phases, bytes bound, peak memory);
15. drives the CastStrings path with the counters at 0 again (no kernel may
   launch), at the size of a plugin batch: ``float_to_string`` over 2**24
   FLOAT64 rows (seed 53: specials, 72% wide magnitudes, 20% prices, 8%
   integers, 5% nulls) and the same values as FLOAT32, and its monolithic
   oracle; ``string_to_float`` of those strings to FLOAT64 and FLOAT32 and
   of a 2**20-row adversarial corpus; ``string_to_integer`` to INT64 and
   INT32 over 2**24 integer strings; ``string_to_decimal`` to DECIMAL(38,2)
   and DECIMAL(7,2) over 2**22 price strings; ``decimal_to_string`` over
   2**24 DECIMAL(38,2) and DECIMAL(18,2) rows; ``format_float`` with 2
   digits over 2**22 FLOAT64 and FLOAT32 rows; ``to_integers_with_base`` and
   ``from_integers_with_base`` at base 16 and 10 over 2**22 rows; holds the
   lane arms against the oracle on whole outputs and the numpy twin on
   2**22 rows, every call against the CPU run on a strided 2**18-row
   sample, ANSI mode's
   error row and the gtest vectors on the card, and prints a ``casts`` line
   (per call: time, phases, profiled kernels, peak memory, bytes bound;
   the round-trip share);
16. drives the order tier with the counters at 0 again (no kernel may
   launch: a range exchange places rows by rank, not by hash), at TPC-DS
   SF10's sizes (28,800,991 store sales, 102,000 items, 500,000 customers,
   10 categories, 20 income bands): ``run_range_plan_local`` of NDS q67 (a
   rank per category, top 100) and q64 (framed running sums and max per
   (category, brand) over 1,000 brands, band >= 10, top 100), of the global
   ``topk_sales_plan(100)`` and of ``naive_sort_limit_plan(100)``; q67 and
   both top-k plans over 4 map shards into 4 range partitions against
   shared splitters; q67's reduce plan through ``run_governed_plan``; holds
   every full-size output against a vectorized numpy oracle, the multi-shard
   and governed runs against the local ones, the top-k against the naive
   plan with fewer bytes on the wire, and every call at 2**20 rows against
   the CPU run, bit for bit and in row order; runs the plans phase's q5 and
   q3 locally through ``run_governed_plan`` with the ``plan_optimizer`` flag
   off and on (equal answers, the rewrite events counted), and prints an
   ``order`` line (per call: host-to-host seconds, peak memory, the steps
   of those timed calls as the entry points' own phase timers read them --
   the map emit, rank and sort, download, the reduce's upload and launch --
   and the reduce executor on resident inputs);
17. drives the JSON family with the counters at 0 again (no kernel may
   launch), on a Spark-style event column of 2**22 rows (seed 71: lengths
   33-1011 B, mean 212.5 B, 0.89 GB of chars; 10% null rows, 2%
   malformed rows; nesting depth 1-6, arrays of objects, escapes and
   ``\\uXXXX``, single-quoted strings, floats with exponents, ``-0``):
   ``get_json_object_multiple_paths`` over 8 paths (among them
   ``$.store.fruit[*].weight``, ``$.store.book``, ``$.k0``,
   ``$.store.fruit[0]``, ``$.*`` and one no row matches), one single-path
   ``get_json_object`` and ``from_json`` over the column with its malformed
   rows nulled, all on the device arm; holds every output bit for bit
   against the host arm on the card over the first 2**14 rows, the port's
   CPU run of the first 2**13 rows and ``tests/json_oracle.py`` over the
   first 2**12, checks that ``from_json`` of the whole column raises at the
   expected row, and prints a ``json`` line (per call: time, peak memory,
   phases, the kernels the profiler sees on 2**14 rows, bytes bound);
18. drives BASELINE config 5 with the counters at 0 again: the port's NDS
   harness ``main`` in this process, ``--sf 10 --verify --stream-chunk-rows
   1000000 --buckets 32`` on the card: q5 and q97's facts generated in
   chunks of 1,000,000 rows, grace-hashed to disk as JCUDF rows in 32
   buckets, each bucket a governed run on a (1, 1) mesh over a one-rank
   NCCL group (q97's Exchange launching ``mm_hash_long`` once a bucket, and
   no other kernel), q3 in memory; holds q97's counts to the JAX package's
   SF10 answers (27967534, 27967430, 21658 over 56,000,000 rows), q5 to 40
   rows, every query to its oracle and every spill file to its removal,
   ``mm_hash_long`` against its plain version at a bucket's shape, and
   prints a ``config5`` line (each query's wall time and rate, the host
   share of generating, routing, encoding, writing, reading and decoding,
   the device share between CUDA events around each bucket's run, the
   largest bucket, the host and device peaks);
19. drives the last Spark ops with the counters at 0 again (no kernel may
   launch), at a plugin batch from seed 73: the six ``parse_uri`` entry
   points (protocol, host, query, query with the key "id" and with a per-row
   key column, path) and ``literal_range_pattern`` over 2**22 web-log URLs
   (16-2,048 B, mostly under 300: http and https, userinfo, ports, queries,
   fragments, IPv4 and IPv6 hosts, %XX escapes and UTF-8; 5% malformed, 5%
   null); ``convert_timestamp_to_utc`` and
   ``convert_utc_timestamp_to_timezone`` in Asia/Shanghai and Asia/Kolkata
   on 2**26 TIMESTAMP_MICROS values over 1900-2100 (the zones' TZif files
   from the machine, else from tests/data/tzif/); both calendar rebases on
   2**26 TIMESTAMP_MICROS and 2**26 DATE32 values over years 1-2100;
   ``interleave_bits`` and ``hilbert_index(10, ...)`` over three INT32
   columns of 2**24 rows with 10% nulls; ``create_histogram_if_valid`` over
   2**24 (FLOAT64, INT64) rows and ``percentile_from_histogram`` at 0, 0.25,
   0.5, 0.75 and 1 over 2**20 histograms of 1-256 bins, as lists and as
   scalars; holds every output bit for bit against the port's CPU run of
   the first 2**18 rows (histograms), run in a spawned process while the
   card is timed, and the six ``parse_uri`` outputs against
   tests/uri_oracle.py on 2**14 rows; prints an ``ops_tail`` line (per
   call: time, peak memory, bytes bound);
20. profiles, with the port's ``Profiler`` and its ``torch.profiler``
   device trace, a governed q97 at SF10 on the governed phase's tables and
   an 8-path ``get_json_object`` over 2**14 rows of phase 17's column, each
   in a host range of its own; converts the capture with ``obs.convert``
   into one merged chrome trace and checks that the SRTP stream parses,
   that the seam ranges, the reservation counters and the flight
   recorder's STATE records are there, that ``mm_hash_long`` is among the
   device events as often as its counter says, and that every device event
   lies inside its call's host range (each window's export placed with
   that window's clock anchor and the clock rate its warm-up and closing
   marks show); prints each call's device busy share
   (the union of its kernels over its wall); then runs two governed q97
   calls under the seeded ``pressure_storm_config``, whose answers must
   equal the unfaulted one and whose injector decisions must be equal; and
   prints an ``obs`` line;
21. serves on the card through the port's ``ServingEngine`` (built-in
   handlers, 4 workers, a queue of 64) over a one-rank NCCL mesh, with three
   sessions (priorities 0, 1, 2) and 8 client threads: q97 at SF10 twice,
   q5, q3 and 16 ``get_json_object`` requests (1,024 rows of phase 17's
   generator, its 8 paths), then 512 ``hash32`` requests (int64 rows
   log-uniform over 1-2**20, numpy seed 79) through the micro-batcher and
   the same 512 with ``serve_ragged`` (256-row pages, 64 pages, 64
   riders); a q97 on an engine whose budget is half its working set, which
   must split and re-queue; 64 ``hash32`` requests under a seeded RetryOOM
   storm on ``handle:hash32``, twice, whose answers must not change, whose
   retries must equal the injected faults and whose injector decisions must
   be equal; and q3's plan twice through ``run_governed_plan`` with
   ``serve_result_cache`` on, the second a hit equal to the first with no
   reservation and no launch.  Holds q97 against the distributed phase's
   oracle, q5 and q3 against the plans phase's answers, each JSON answer
   against the direct call, every ``hash32`` answer bit for bit against the
   plain version on the card and the ragged answers against the
   micro-batch's; no request may be lost, ``mm_hash_long`` must launch at
   least once per micro-batch execution and per ragged tick, and the ragged
   programs built must be among the page geometries the ticks launched at.
   Prints ``serve_stage`` lines, ``serve_launches`` and the ``serve`` line;
22. serves through the port's ``Supervisor`` over 4 executor processes that
   share the card (``worker_cfg`` ``{"device": "cuda", "budget_bytes": the
   free memory at spawn over 1.25 over 4, "workers": 2}``; the parent
   empties its allocator's cache first): q97 at SF10 as a real
   cross-process hash shuffle over 4 map shards, plain and then with the
   adaptive exchange; q67 at SF10 (the order phase's batch) as a range
   shuffle; 256 ``hash32`` requests (int64 rows log-uniform over 1-2**20,
   numpy seed 83) from 8 client threads; one ``hash32_wide`` request whose
   answer (the murmur3 of 2**26 int64 keys made on the card) is 268,435,456
   bytes, under the default heartbeat budget; then a second cluster under
   ``chaos_shuffle_config`` (corrupt, truncated and stalled frames, and
   executor 0's first incarnation SIGKILLed at a seeded budget crossing)
   running q97 until that executor was killed and respawned.  Holds q97 to
   the earlier phases' oracle and ``run_exchange_plan_local`` on the card,
   q67 to the order phase's answer, every ``hash32`` answer and the wide
   one to the plain version's bits and ``mm_hash_long`` to its plain
   version at a map shard's shape; the clean cluster must spawn exactly 4
   executors, declare none dead and
   dispatch no lease twice, the chaos cluster complete every lease once,
   every executor run on the card and launch, and the card's processes stay
   within its memory.  The executors write their ``mm_hash_long`` launches to
   stats files, which the parent adds up.  Prints ``supervisor_launches``
   and the ``supervisor`` line (spawn-to-HELLO seconds, per handler
   latencies, each shuffle's span breakdown, the data plane's bytes, frames,
   CRC failures and retries, respawns, re-dispatches, peaks, launches);
23. launches ``torch.cuda.device_count()`` rank processes with a
   launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
   ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR=127.0.0.1``, a free ``MASTER_PORT``,
   NCCL on loopback): one rank on one card, one per card on more.  Each
   joins the group through ``parallel.multihost.initialize``, runs the NDS
   harness's ``main`` with ``--sf 10 --verify`` in memory and then streamed
   as phase 18 does, over ``make_pod_mesh(mp=1)``, then
   ``run_q97_monte_carlo`` over the ranks (6 tasks, each on process groups
   of its own).  Every rank's lines must be verified and equal to the
   others' (timings aside), q97's counts in memory the distributed phase's
   numpy oracle of the same SF10 tables and streamed the JAX package's
   config 5 answer, q5 40 rows, the monte-carlo ok with 6 data-axis groups;
   a rank that fails, or runs past 300 s, fails the run.  The ranks write their ``mm_hash_long``
   launches to files the parent adds up.  Prints ``multihost_launches`` and
   the ``multihost`` line (world, spawn-to-group seconds, each query's wall
   and Mrows/s per rank, the monte-carlo's stats);
   then the phases' seconds, the card's name and power limit, the
   ``kernels`` line (all seven kernels, their launches over the seventeen
   paths) and, last, the ``ok`` line.

The governed phase also holds every call's device peak over its reservation
to the default budget's headroom factor (``mem.governed.PEAK_OVER_RESERVATION``),
and the order phase holds float ``framed_sum`` over 2**21 rows bit for bit
between the card and the CPU.

Every check that fails raises, and the script then exits non-zero.
"""

from __future__ import annotations

import dataclasses
import json
import math
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


def _time_ms(fn, reps: int = REPS, warmup: int = WARMUP) -> float:
    """``fn``'s median time over ``reps`` calls after ``warmup`` calls, each
    call between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
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


COL_CPU_ROWS = 1 << 20  # rows of each column-hash call held against the CPU run


def _head_rows(col, n):
    """The first ``n`` rows of a flat column of the column-hash batch (a
    nested one of at most ``n`` rows is returned whole)."""
    if col.size <= n:
        return col
    if hasattr(col, "chars"):
        return _head(col, n)
    valid = None if col.validity is None else col.validity[:n]
    return dataclasses.replace(col, hi=col.hi[:n], lo=col.lo[:n], validity=valid)


def check_column_hash_against_cpu(batch, outs):
    """Every column-hash call held bit for bit against the same inputs run on
    the CPU, over the first COL_CPU_ROWS rows; returns each CPU run's
    seconds."""
    cpu_batch = {k: _on(_head_rows(v, COL_CPU_ROWS), "cpu") for k, v in batch.items()}
    cpu_s = {}
    for name, call in _column_hash_calls(cpu_batch).items():
        t0 = time.perf_counter()
        want = call()
        cpu_s[name] = time.perf_counter() - t0
        _require_equal(f"{name} vs CPU", outs[name].data[:COL_CPU_ROWS], want.data)
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


def _timed(fn, reps: int = REPS, warmup: int = WARMUP) -> dict:
    """``fn``'s median time (``_time_ms``) and the peak device memory while it
    runs, beside what was resident before."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    return {"ms": _time_ms(fn, reps, warmup), "peak_mem_bytes": torch.cuda.max_memory_allocated(),
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
PLAN_REPS = 2  # host-to-host calls timed per part, after the path's first call
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
    reserved, peak = budget.reset_peak(), torch.cuda.max_memory_allocated()
    return out, {
        "s": seconds, "splits": splits, "retries": retries,
        "executions": plan_cache.stats()["execute_calls"] - execs,
        "reserved_peak_bytes": reserved, "budget_bytes": budget.limit,
        "peak_mem_bytes": peak, "resident_bytes": resident,
        "peak_over_reserved": (peak - resident) / reserved,
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
    thread left blocked; no call's device peak above its reservation times
    the default budget's headroom factor."""
    from spark_rapids_jni_tpu_torch.mem import governed as governed_mod

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
    # the card's default budget leaves this factor of headroom: no call may peak above it
    ratios = {run: [c["peak_over_reserved"] for c in v["calls"]] for run, v in runs.items()}
    print(json.dumps({"governed_peak_over_reserved": ratios,
                      "factor": governed_mod.PEAK_OVER_RESERVATION}))
    worst = max(max(r) for r in ratios.values())
    if worst > governed_mod.PEAK_OVER_RESERVATION:
        raise AssertionError(f"governed: a call peaked at {worst}x its reservation, above "
                             f"the default budget's factor {governed_mod.PEAK_OVER_RESERVATION}")
    return {"budget_used_after": used, "blocked_or_bufn_after": blocked,
            "max_peak_over_reserved": worst,
            "peak_factor": governed_mod.PEAK_OVER_RESERVATION,
            "default_budget_bytes": budgets["default"].limit}


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


# ---- the bloom filter path (BASELINE config 4) ----------------------------

# Spark's runtime join filter (spark.sql.optimizer.runtime.bloomFilter.*):
# the default expectedNumItems / numBits, and maxNumItems / maxNumBits.
BLOOM_ITEMS, BLOOM_BITS = 1_000_000, 8_388_608
BLOOM_MAX_ITEMS, BLOOM_MAX_BITS = 4_000_000, 67_108_864
BLOOM_TASKS = 4  # build tasks, one partial filter each, then merged
BLOOM_SMALL = 1024  # keys put into an empty largest filter (the sorted path)
N_PROBE = 1 << 26  # probe keys: 512 MiB of INT64
BLOOM_SAMPLE = 1 << 20  # probe rows held against the CPU run (strided)
BLOOM_LAUNCHES = 2 * (BLOOM_TASKS + 2 + 2)  # mm_hash_long: two per put, two per probe


def _spark_num_hashes(n: int, m: int) -> int:
    """BloomFilter.optimalNumOfHashFunctions: max(1, round(m / n * ln 2))."""
    return max(1, int(math.floor(m / n * math.log(2) + 0.5)))


def _int64_column(vals, valid, device):
    from spark_rapids_jni_tpu_torch import columnar as c

    return c.Column(torch.from_numpy(vals).to(device),
                    None if valid is None else torch.from_numpy(valid).to(device), c.INT64)


def bloom_batch(device):
    """The bloom phase's keys, drawn with numpy from a fixed seed: 4,000,000
    build keys with 5% nulls (the first 1,000,000 build the default filter in
    four parts, all of them the largest filter), 1,024 keys for the sorted
    path, and 2**26 probe keys with 10% nulls, a quarter of them drawn from
    the default filter's build keys."""
    rng = np.random.RandomState(41)
    build = rng.randint(-(2**63), 2**63, BLOOM_MAX_ITEMS, dtype=np.int64)
    build_valid = rng.rand(BLOOM_MAX_ITEMS) >= 0.05
    probe = rng.randint(-(2**63), 2**63, N_PROBE, dtype=np.int64)
    from_build = rng.rand(N_PROBE) < 0.25
    src = rng.randint(0, BLOOM_ITEMS, int(from_build.sum()))
    probe[from_build] = build[src]
    inserted = np.zeros(N_PROBE, bool)
    inserted[from_build] = build_valid[src]
    probe_valid = rng.rand(N_PROBE) >= 0.1
    small = rng.randint(-(2**63), 2**63, BLOOM_SMALL, dtype=np.int64)
    part = BLOOM_ITEMS // BLOOM_TASKS
    return {
        "parts": [_int64_column(build[i * part:(i + 1) * part],
                                build_valid[i * part:(i + 1) * part], device)
                  for i in range(BLOOM_TASKS)],
        "big": _int64_column(build, build_valid, device),
        "small": _int64_column(small, None, device),
        "probe": _int64_column(probe, probe_valid, device),
        # probe rows that must hit (an inserted non-null key, not null) and
        # rows that hold no build key (for the false-positive share)
        "must_hit": torch.from_numpy(inserted & probe_valid).to(device),
        "absent": torch.from_numpy(~from_build & probe_valid).to(device),
        "n_inserted": int(build_valid[:BLOOM_ITEMS].sum()),
        "n_inserted_big": int(build_valid.sum()),
    }


def _put(f, col):
    """``bloom_filter_put`` and the put path it took."""
    from spark_rapids_jni_tpu_torch.ops import bloom_filter as bf

    before = dict(bf.put_paths)
    out = bf.bloom_filter_put(f, col)
    (path,) = [p for p in before if bf.put_paths[p] != before[p]]
    return out, path


def _bloom_calls(b, device):
    """The bloom phase's public calls on batch ``b``: four partial filters put
    and merged, serialized and deserialized onto ``device`` (what Spark ships
    to the probe tasks) and probed; the largest filter put and probed;
    the sorted-path put.  Returns the filters, the bytes, the probe columns
    and each put's path."""
    from spark_rapids_jni_tpu_torch.ops import (bloom_filter_create, bloom_filter_deserialize,
                                                bloom_filter_merge, bloom_filter_probe,
                                                bloom_filter_serialize)

    k = _spark_num_hashes(BLOOM_ITEMS, BLOOM_BITS)
    k_max = _spark_num_hashes(BLOOM_MAX_ITEMS, BLOOM_MAX_BITS)
    paths = {}
    parts = []
    for i, col in enumerate(b["parts"]):
        f, paths[f"part{i}"] = _put(bloom_filter_create(k, BLOOM_BITS // 64, device), col)
        parts.append(f)
    merged = bloom_filter_merge(parts)
    buf = bloom_filter_serialize(merged)
    shipped = bloom_filter_deserialize(buf, device)
    hits = bloom_filter_probe(b["probe"], shipped)
    big, paths["largest"] = _put(bloom_filter_create(k_max, BLOOM_MAX_BITS // 64, device),
                                 b["big"])
    big_hits = bloom_filter_probe(b["probe"], big)
    small, paths["small"] = _put(bloom_filter_create(k_max, BLOOM_MAX_BITS // 64, device),
                                 b["small"])
    return {"parts": parts, "merged": merged, "buf": buf, "shipped": shipped, "hits": hits,
            "big": big, "big_hits": big_hits, "small": small, "paths": paths,
            "num_hashes": [k, k_max]}


def bloom_path(b, device="cuda"):
    """The bloom path on ``device`` with the counters at 0; returns the
    counts, the outputs and the path's peak device memory."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hash_cuda.reset_launches()
    outs = _bloom_calls(b, device)
    torch.cuda.synchronize()
    counts = dict(hash_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"bloom_launches": counts, "put_paths": outs["paths"]}))
    if outs["num_hashes"] != [6, 12]:
        raise AssertionError(f"num_hashes {outs['num_hashes']} != Spark's [6, 12]")
    want_paths = {**{f"part{i}": "scatter" for i in range(BLOOM_TASKS)},
                  "largest": "scatter", "small": "sorted"}
    if outs["paths"] != want_paths:
        raise AssertionError(f"put paths {outs['paths']} != {want_paths}")
    want = {k: (BLOOM_LAUNCHES if k == "mm_hash_long" else 0) for k in counts}
    if counts != want:
        raise AssertionError(f"bloom launches {counts} != {want}")
    return counts, outs, peak


def check_bloom(b, outs):
    """Filters and bytes equal the CPU run bit for bit; probe flags equal it
    on a strided sample; on the card every inserted non-null key hits and null
    rows stay null.  Returns the false-positive shares and the CPU seconds."""
    from spark_rapids_jni_tpu_torch.ops import bloom_filter_probe

    t0 = time.perf_counter()
    idx = torch.arange(0, N_PROBE, N_PROBE // BLOOM_SAMPLE)
    probe = _on(b["probe"], "cpu")
    cpu_b = {"parts": [_on(c, "cpu") for c in b["parts"]], "big": _on(b["big"], "cpu"),
             "small": _on(b["small"], "cpu"),
             "probe": dataclasses.replace(probe, data=probe.data[idx],
                                          validity=probe.validity[idx])}
    cpu = _bloom_calls(cpu_b, "cpu")
    cpu_s = time.perf_counter() - t0
    for name in ("merged", "shipped", "big", "small"):
        _require_equal(f"bloom {name} longs", outs[name].longs, cpu[name].longs)
    for i, (g, w) in enumerate(zip(outs["parts"], cpu["parts"])):
        _require_equal(f"bloom part {i} longs", g.longs, w.longs)
    if outs["buf"] != cpu["buf"]:
        raise AssertionError("serialized bloom filter bytes differ from the CPU run")
    if cpu["paths"] != outs["paths"]:
        raise AssertionError(f"CPU put paths {cpu['paths']} != {outs['paths']}")
    fpp = {}
    for name in ("hits", "big_hits"):
        got = outs[name]
        _require_equal(f"bloom {name} (sample)", got.data[idx.to(got.data.device)],
                       cpu[name].data)
        _require_equal(f"bloom {name} validity", got.validity, b["probe"].validity)
        missed = int((b["must_hit"] & ~got.data).sum())
        if missed:
            raise AssertionError(f"bloom {name}: {missed} inserted keys probe false")
        fpp[name] = float(got.data[b["absent"]].float().mean())
    return fpp, cpu_s, int(b["must_hit"].sum())


def _spark_fpp(n: int, m: int, k: int) -> float:
    """The expected false-positive probability of (n keys, m bits, k hashes)."""
    return (1.0 - math.exp(-k * n / m)) ** k


def time_bloom(b, outs, device="cuda"):
    """Each bloom call's time (CUDA events, median of 20 after 3), the
    deserialize host to host, and mm_hash_long at the probe's shape (per-row
    h1 seed) against its plain version."""
    from spark_rapids_jni_tpu_torch.ops import (bloom_filter_create, bloom_filter_deserialize,
                                                bloom_filter_merge, bloom_filter_probe,
                                                bloom_filter_put, bloom_filter_serialize)
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    k, k_max = outs["num_hashes"]
    empty = bloom_filter_create(k, BLOOM_BITS // 64, device)
    empty_max = bloom_filter_create(k_max, BLOOM_MAX_BITS // 64, device)
    ms = {
        "put_part": _time_ms(lambda: bloom_filter_put(empty, b["parts"][0])),
        "merge": _time_ms(lambda: bloom_filter_merge(outs["parts"])),
        "serialize": _time_ms(lambda: bloom_filter_serialize(outs["merged"])),
        "probe": _time_ms(lambda: bloom_filter_probe(b["probe"], outs["shipped"])),
        "put_largest": _time_ms(lambda: bloom_filter_put(empty_max, b["big"])),
        "probe_largest": _time_ms(lambda: bloom_filter_probe(b["probe"], outs["big"])),
        "put_small_sorted": _time_ms(lambda: bloom_filter_put(empty_max, b["small"])),
    }
    host = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        bloom_filter_deserialize(outs["buf"], device)
        torch.cuda.synchronize()
        host.append(time.perf_counter() - t0)
    keys = b["probe"].data
    h1 = hash_cuda.mm_hash_long_cuda(keys, 0)
    err = _require_equal("mm_hash_long (bloom h2, row seed)",
                         hash_cuda.mm_hash_long_cuda(keys, h1),
                         hash_cuda.mm_hash_long_torch(keys, h1))
    kernel = {"n": N_PROBE, "max_abs_err": err,
              "kernel_ms": _time_ms(lambda: hash_cuda.mm_hash_long_cuda(keys, h1)),
              "plain_ms": _time_ms(lambda: hash_cuda.mm_hash_long_torch(keys, h1))}
    return ms, statistics.median(host), kernel


def bloom(device="cuda"):
    """The bloom phase: the path with the counters at 0, the checks, the
    times; prints the ``bloom`` line and returns the path's launch counts."""
    t0 = time.perf_counter()
    b = bloom_batch(device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts, outs, peak = bloom_path(b, device)
    fpp, cpu_s, must_hit = check_bloom(b, outs)
    ms, deserialize_s, kernel = time_bloom(b, outs, device)
    k, k_max = outs["num_hashes"]
    print(json.dumps({"bloom": {
        "n_probe": N_PROBE, "num_hashes": outs["num_hashes"],
        "num_bits": [BLOOM_BITS, BLOOM_MAX_BITS], "build_keys": [BLOOM_ITEMS, BLOOM_MAX_ITEMS],
        "tasks": BLOOM_TASKS, "serialized_bytes": len(outs["buf"]), "put_paths": outs["paths"],
        "ms": ms, "deserialize_host_to_host_s": deserialize_s, "path_peak_mem_bytes": peak,
        "false_positive_share": fpp,
        "spark_expected_fpp": {"hits": _spark_fpp(b["n_inserted"], BLOOM_BITS, k),
                               "big_hits": _spark_fpp(b["n_inserted_big"], BLOOM_MAX_BITS,
                                                      k_max)},
        "checks": {"must_hit_rows": must_hit, "sample_rows": BLOOM_SAMPLE, "cpu_s": cpu_s},
        "mm_hash_long": kernel, "launches": counts["mm_hash_long"], "batch_gen_s": gen_s}}))
    return counts


# ---- the DECIMAL128 path (BASELINE config 4) --------------------------------

N_DEC = 1 << 24  # rows of multiply128's columns (2 x 256 MiB)
N_DEC_DIV = 1 << 22  # rows of the divide, remainder and add/subtract calls
N_DEC_BRANCH = 1 << 20  # rows of the calls that reach the remaining branches
DEC_SAMPLE = 1 << 14  # rows of each call held against the CPU run (strided)
DEC_REPS, DEC_WARMUP = 3, 0  # the path's own call warms each one up


def _dec_specials():
    """0, +-(10**38 - 1) and +-10**k for k in 0..37."""
    return [0, 10**38 - 1, -(10**38 - 1)] + [s * 10**k for k in range(38) for s in (1, -1)]


def _dec_words(rng, n, specials):
    """``n`` unscaled DECIMAL(38) values as (hi, lo) int64 words: the
    specials first, then magnitudes of 1-38 digits (the digit count uniform),
    mixed signs."""
    digits = rng.integers(1, 39, n)
    hi = np.zeros(n, np.int64)
    lo = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n, dtype=np.int64,
                      endpoint=True).view(np.uint64)
    short = digits <= 19
    lo[short] = rng.integers(0, np.uint64(10) ** digits[short].astype(np.uint64),
                             dtype=np.uint64)
    hi_max = np.array([10**d >> 64 for d in range(39)], dtype=np.int64)
    hi[~short] = rng.integers(0, hi_max[digits[~short]])  # value < hi_max * 2**64 <= 10**d
    neg = rng.random(n) < 0.5
    nlo = ~lo + np.uint64(1)
    nhi = ~hi + (nlo == 0)
    lo, hi = np.where(neg, nlo, lo), np.where(neg, nhi, hi)
    for i, v in enumerate(specials):
        v &= (1 << 128) - 1
        hi[i] = np.uint64(v >> 64).astype(np.int64)
        lo[i] = np.uint64(v & 0xFFFFFFFFFFFFFFFF)
    return hi, lo.view(np.int64)


def _dec_column(hi, lo, valid, scale, device):
    from spark_rapids_jni_tpu_torch import columnar as c

    return c.Decimal128Column(torch.from_numpy(hi).to(device), torch.from_numpy(lo).to(device),
                              torch.from_numpy(valid).to(device), c.decimal(38, scale))


def decimal_batch(device):
    """DECIMAL(38,10) columns a and b of N_DEC rows (numpy seed 97, 5% nulls
    each), and b's first N_DEC_DIV rows with 1% zero divisors."""
    rng = np.random.default_rng(97)
    specials = _dec_specials()
    a_hi, a_lo = _dec_words(rng, N_DEC, specials)
    b_hi, b_lo = _dec_words(rng, N_DEC, specials[::-1])
    a_valid = rng.random(N_DEC) >= 0.05
    b_valid = rng.random(N_DEC) >= 0.05
    z = np.flatnonzero(rng.random(N_DEC_DIV) < 0.01)
    bz_hi, bz_lo = b_hi[:N_DEC_DIV].copy(), b_lo[:N_DEC_DIV].copy()
    bz_hi[z], bz_lo[z] = 0, 0
    return {"a": _dec_column(a_hi, a_lo, a_valid, 10, device),
            "b": _dec_column(b_hi, b_lo, b_valid, 10, device),
            "bz": _dec_column(bz_hi, bz_lo, b_valid[:N_DEC_DIV], 10, device),
            "zero_divisors": int(z.size)}


def _dec_head(col, n, scale):
    """The first ``n`` rows of a decimal column, read at another scale."""
    from spark_rapids_jni_tpu_torch import columnar as c

    return c.Decimal128Column(col.hi[:n], col.lo[:n], col.validity[:n], c.decimal(38, scale))


def _decimal_calls(d):
    """name -> (op, a, b, extra arguments): each decimal entry point at its
    size, then one call per branch the others do not reach."""
    a, b, bz = d["a"], d["b"], d["bz"]
    a4 = _dec_head(a, N_DEC_DIV, 10)
    return {
        "multiply128_interim": ("multiply128", a, b, (6, True)),
        "multiply128": ("multiply128", a, b, (6, False)),
        "divide128": ("divide128", a4, bz, (6,)),
        "integer_divide128": ("integer_divide128", a4, bz, ()),
        "remainder128": ("remainder128", a4, bz, (10,)),
        "add128": ("add128", a4, bz, (10,)),
        "subtract128": ("subtract128", a4, bz, (10,)),
        # n_shift_exp = -40: the staged multiply around two divides
        "divide128_shift_gt_38": ("divide128", _dec_head(a, N_DEC_BRANCH, 0),
                                  _dec_head(bz, N_DEC_BRANCH, 38), (2,)),
        # n_shift_exp = 10: a truncating divide, then a rounding one
        "divide128_n_shift_exp_gt_0": ("divide128", _dec_head(a, N_DEC_BRANCH, 10),
                                       _dec_head(bz, N_DEC_BRANCH, 0), (0,)),
        # d_shift_exp = 4: the divisor itself rounded down to the result scale
        "remainder128_d_shift_exp_gt_0": ("remainder128", _dec_head(a, N_DEC_BRANCH, 3),
                                          _dec_head(bz, N_DEC_BRANCH, 5), (1,)),
    }


def _dec_call(spec):
    from spark_rapids_jni_tpu_torch.ops import decimal128

    op, a, b, extra = spec
    return getattr(decimal128, op)(a, b, *extra)


def _dec_fields(out):
    """The tensors of an (overflow, result) pair: flags, validity and words."""
    ov, res = out
    words = [res.hi, res.lo] if hasattr(res, "hi") else [res.data]
    return [ov.data, ov.validity] + words + [res.validity]


def decimal_path(d):
    """Every decimal call once on the card with the counters at 0: plain torch,
    no kernel of the hash wrappers may launch."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    outs = {name: _dec_call(spec) for name, spec in _decimal_calls(d).items()}
    torch.cuda.synchronize()
    counts = dict(hash_cuda.launches)
    print(json.dumps({"decimal_launches": counts}))
    if any(counts.values()):
        raise AssertionError(f"the decimal path launched hash kernels: {counts}")
    return counts, outs


def check_decimal(d, outs):
    """Each call's outputs equal the CPU run on a strided DEC_SAMPLE-row
    sample (the functions are row-wise); returns the CPU seconds."""
    from spark_rapids_jni_tpu_torch import columnar as c

    def take(col, idx):
        return c.Decimal128Column(col.hi[idx].cpu(), col.lo[idx].cpu(), col.validity[idx].cpu(),
                                  col.dtype)

    t0 = time.perf_counter()
    for name, (op, a, b, extra) in _decimal_calls(d).items():
        idx = torch.arange(0, a.size, a.size // DEC_SAMPLE, device=a.device)
        want = _dec_call((op, take(a, idx), take(b, idx), extra))
        for i, (g, w) in enumerate(zip(_dec_fields(outs[name]), _dec_fields(want))):
            _require_equal(f"{name} field {i}", g[idx], w)
    return time.perf_counter() - t0


# DecimalUtilsTest vectors (tests/test_decimal128.py): (op, lhs, rhs, scale,
# expected; None where the row overflows)
DECIMAL_UTILS_VECTORS = [
    ("remainder128",
     ["-80968577325845461854951721352418610.13", "-80968577325845461854951721352418610.13",
      "-66686472768705331734321352506496901.71"],
     ["6749200345857154099505910298895800952.1", "-6749200345857154099505910298895800952.1",
      "-43880265997097383351377368851255372.5"], 2,
     ["-80968577325845461854951721352418610.13", "-80968577325845461854951721352418610.13",
      "-22806206771607948382943983655241529.21"]),
    ("remainder128", ["5776949384953805890688943467625198736"],
     ["-67337920196996830.354487679299"], 7, ["16310460742282291.8108019"]),
    ("remainder128", ["5776949384953805890688943467625198736"],
     ["-6733792019699683035.4487679299"], 10, ["3585222007130884413.9709383255"]),
    ("divide128",
     ["60250054953505368.439892586764888491018", "91910085134512953.335347579448489062875",
      "51312633107598808.869351260608653423886"],
     ["97982875273794447.385070145919990343867", "94478503341597285.814104936062234698349",
      "92266075543848323.800466593082956765923"], 6, ["0.614904", "0.972815", "0.556138"]),
    ("divide128", ["100000000000000000000000000000000"],
     ["3.0000000000000000000000000000000000000"], 6,
     ["33333333333333333333333333333333.333333"]),
    ("add128",
     ["9191008513307131620269245301.1615457290", "-9191008513307131620269245301.1615457290"],
     ["9447850332473678680446404122.5624623187", "-9447850332473678680446404122.5624623187"],
     10, [None, None]),
    ("add128",
     ["9191008513307131620269245301.1615457290", "-7949989536398283250841565918.6123449781"],
     ["451635271134476686911387864.48", "3022290197578200820919308997.64"], 9,
     ["9642643784441608307180633165.641545729", "-4927699338820082429922256920.972344978"]),
    ("multiply128", ["50000000000000000000000000000000000000"], ["2"], 0, [None]),
    ("add128", ["99999999999999999999999999999999999999"], ["1"], 0, [None]),
    ("subtract128", ["-99999999999999999999999999999999999999"], ["1"], 0, [None]),
]


def _dstr(s):
    """A Java BigDecimal string -> (unscaled int, scale)."""
    import decimal as pydec

    sign, digits, exp = pydec.Decimal(s).as_tuple()
    return int("".join(map(str, digits))) * (-1 if sign else 1), -exp


def check_decimal_utils_vectors(device):
    """The DecimalUtilsTest vectors give their expected values on ``device``."""
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch.ops import decimal128

    def col(strings):
        vs = [_dstr(s) for s in strings]
        (scale,) = {sc for _, sc in vs}
        return c.decimal128_column([v for v, _ in vs], 38, scale, device)

    for i, (op, lhs, rhs, scale, expected) in enumerate(DECIMAL_UTILS_VECTORS):
        ov, res = getattr(decimal128, op)(col(lhs), col(rhs), scale)
        if ov.to_list() != [e is None for e in expected]:
            raise AssertionError(f"DecimalUtilsTest vector {i} ({op}): overflow {ov.to_list()}")
        for g, e in zip(res.unscaled_to_list(), expected):
            if e is not None and (g, scale) != _dstr(e):
                raise AssertionError(f"DecimalUtilsTest vector {i} ({op}): {g} != {e}")
    return len(DECIMAL_UTILS_VECTORS)


def _profiled_kernels(fn) -> int:
    """The CUDA kernels (and device copies) that ``fn`` runs, as the profiler
    records them."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA)


def time_decimal(d):
    """Each call's time (CUDA events, median of DEC_REPS after DEC_WARMUP) and
    peak memory, and the kernels the profiler sees in one more call."""
    calls = {}
    for name, spec in _decimal_calls(d).items():
        line = _timed(lambda spec=spec: _dec_call(spec), DEC_REPS, DEC_WARMUP)
        line.update({"n": spec[1].size,
                     "profiled_kernels": _profiled_kernels(lambda spec=spec: _dec_call(spec))})
        calls[name] = line
    return calls


def decimal(device="cuda"):
    """The decimal phase: the path with the counters at 0, the checks against
    the CPU and the DecimalUtilsTest vectors, the times; prints the
    ``decimal`` line and returns the path's launch counts."""
    t0 = time.perf_counter()
    d = decimal_batch(device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts, outs = decimal_path(d)
    overflow_rows = {k: int(v[0].data.sum()) for k, v in outs.items()}
    cpu_s = check_decimal(d, outs)
    del outs
    n_vectors = check_decimal_utils_vectors(device)
    print(json.dumps({"decimal": {
        "n": N_DEC, "n_div": N_DEC_DIV, "n_branch": N_DEC_BRANCH,
        "zero_divisors": d["zero_divisors"], "overflow_rows": overflow_rows,
        "calls": time_decimal(d),
        "checks": {"sample_rows": DEC_SAMPLE, "cpu_s": cpu_s,
                   "decimal_utils_vectors": n_vectors},
        "batch_gen_s": gen_s}}))
    return counts


# ---- the JCUDF row path (BASELINE config 3) ---------------------------------

N_ROWS_FIXED = 1 << 23  # store_sales rows: 2**23 x 104 B = one 872 MB batch
N_ROWS_VAR = 1 << 22  # rows of the (INT32, VARCHAR(100), DECIMAL(38,2)) table
ROWS_SPLIT_BYTES = 1 << 26  # a batch limit that splits the variable table
ROWS_REPS, ROWS_WARMUP = 5, 1


def store_sales_columns(device):
    """TPC-DS store_sales as the plugin's Parquet reader hands it (numpy seed
    43): the nine INT32 surrogate keys (ss_sold_date_sk .. ss_promo_sk) with
    4% nulls, ss_ticket_number INT64, ss_quantity INT32 and the twelve
    DECIMAL(7,2) money columns (DECIMAL32)."""
    from spark_rapids_jni_tpu_torch import columnar as c

    rng = np.random.RandomState(43)
    n = N_ROWS_FIXED

    def col(data, dtype, null_frac=0.0):
        valid = torch.from_numpy(rng.rand(n) >= null_frac).to(device) if null_frac else None
        return c.Column(torch.from_numpy(data).to(device), valid, dtype)

    cols = [col(rng.randint(1, 2**31 - 1, n).astype(np.int32), c.INT32, 0.04)
            for _ in range(9)]
    cols.append(col(rng.randint(1, 2**40, n, dtype=np.int64), c.INT64))
    cols.append(col(rng.randint(1, 101, n).astype(np.int32), c.INT32))
    cols += [col(rng.randint(-(10**7) + 1, 10**7, n).astype(np.int32), c.decimal(7, 2))
             for _ in range(12)]
    return cols


def var_columns(device):
    """(INT32, VARCHAR(100) with 10% nulls, DECIMAL(38,2)) of N_ROWS_VAR rows
    (numpy seed 47), from the column-hash phase's generators."""
    from spark_rapids_jni_tpu_torch import columnar as c

    rng = np.random.RandomState(47)
    i32 = c.Column(torch.from_numpy(rng.randint(-(2**31), 2**31, N_ROWS_VAR, dtype=np.int64)
                                    .astype(np.int32)).to(device), None, c.INT32)
    return [i32, _varchar(rng, N_ROWS_VAR, 100, 0.1, device), _decimals(rng, N_ROWS_VAR, device)]


def _rows_calls(fixed, var):
    """name -> zero-argument call of the public row API; the from-rows calls
    read the rows of the matching to-rows call, made here once."""
    from spark_rapids_jni_tpu_torch.ops import (
        convert_from_rows, convert_from_rows_fixed_width_optimized, convert_to_rows,
        convert_to_rows_fixed_width_optimized)

    fixed_types = [col.dtype for col in fixed]
    var_types = [col.dtype for col in var]
    fixed_rows = convert_to_rows(fixed)
    var_rows = convert_to_rows(var)
    return {
        "to_rows[store_sales]": lambda: convert_to_rows(fixed),
        "to_rows_fixed_width_optimized[store_sales]":
            lambda: convert_to_rows_fixed_width_optimized(fixed),
        "from_rows[store_sales]": lambda: [convert_from_rows(r, fixed_types)
                                           for r in fixed_rows],
        "from_rows_fixed_width_optimized[store_sales]":
            lambda: [convert_from_rows_fixed_width_optimized(r, fixed_types)
                     for r in fixed_rows],
        "to_rows[int32,varchar,decimal128]": lambda: convert_to_rows(var),
        "to_rows[int32,varchar,decimal128](2^26 B batches)":
            lambda: convert_to_rows(var, max_batch_bytes=ROWS_SPLIT_BYTES),
        "from_rows[int32,varchar,decimal128]": lambda: [convert_from_rows(r, var_types)
                                                        for r in var_rows],
    }


def rows_path(fixed, var):
    """Every row call once on the card with the counters at 0 (no hash kernel
    may launch); returns the counts and the outputs."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    torch.cuda.synchronize()
    calls = _rows_calls(fixed, var)
    hash_cuda.reset_launches()
    outs = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    counts = dict(hash_cuda.launches)
    print(json.dumps({"rows_launches": counts}))
    if any(counts.values()):
        raise AssertionError(f"the row path launched hash kernels: {counts}")
    return counts, outs


def _require_rows_equal(what, got, want):
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} batches != {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        _require_equal(f"{what} batch {i} offsets", g.offsets, w.offsets)
        _require_equal(f"{what} batch {i} bytes", g.child.data, w.child.data)


def _column_tensors(col):
    """A column's tensors, validity as a bool tensor (all-valid included)."""
    if hasattr(col, "chars"):
        return [col.chars, col.offsets, col.is_valid()]
    if hasattr(col, "hi"):
        return [col.hi, col.lo, col.is_valid()]
    return [col.data, col.is_valid()]


def _require_columns_equal(what, got, want):
    for c, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype:
            raise AssertionError(f"{what} column {c}: {g.dtype} != {w.dtype}")
        for i, (gt, wt) in enumerate(zip(_column_tensors(g), _column_tensors(w))):
            if gt.dtype == torch.float32:  # FLOAT32 data: compare bits (NaN != NaN)
                gt, wt = gt.view(torch.int32), wt.view(torch.int32)
            _require_equal(f"{what} column {c} field {i}", gt, wt)


def _concat_columns(parts):
    """Batches of read-back columns joined into one set of columns (the
    string offsets rebased), to compare with the table they came from."""
    from spark_rapids_jni_tpu_torch import columnar as c

    out = []
    for cols in zip(*parts):
        valid = torch.cat([col.is_valid() for col in cols])
        if hasattr(cols[0], "chars"):
            offs = [cols[0].offsets]
            for col in cols[1:]:
                offs.append(col.offsets[1:] + offs[-1][-1])
            out.append(c.StringColumn(torch.cat([col.chars for col in cols]), torch.cat(offs),
                                      valid))
        elif hasattr(cols[0], "hi"):
            out.append(c.Decimal128Column(torch.cat([col.hi for col in cols]),
                                          torch.cat([col.lo for col in cols]), valid,
                                          cols[0].dtype))
        else:
            out.append(c.Column(torch.cat([col.data for col in cols]), valid, cols[0].dtype))
    return out


def check_rows(fixed, var, outs):
    """The card's rows equal the numpy host arm on the CPU for whole tables,
    the oracle arm on the card equals the fast arm, and every read-back
    column equals its input exactly.  Returns the CPU seconds and the split
    batch sizes."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.ops import convert_to_rows

    t0 = time.perf_counter()
    cpu_fixed = [_on(col, "cpu") for col in fixed]
    cpu_var = [_on(col, "cpu") for col in var]
    _require_rows_equal("store_sales rows", outs["to_rows[store_sales]"],
                        convert_to_rows(cpu_fixed))
    _require_rows_equal("var rows", outs["to_rows[int32,varchar,decimal128]"],
                        convert_to_rows(cpu_var))
    split = outs["to_rows[int32,varchar,decimal128](2^26 B batches)"]
    _require_rows_equal("var rows (2^26 B batches)", split,
                        convert_to_rows(cpu_var, max_batch_bytes=ROWS_SPLIT_BYTES))
    cpu_s = time.perf_counter() - t0
    sizes = [b.size for b in split]
    if len(sizes) < 2 or any(s % 32 for s in sizes[:-1]) or sum(sizes) != N_ROWS_VAR:
        raise AssertionError(f"split batches {sizes}")
    _require_rows_equal("store_sales fixed-width optimized rows",
                        outs["to_rows_fixed_width_optimized[store_sales]"],
                        outs["to_rows[store_sales]"])
    with config.override(rows_plan_cache=False):
        oracle = {name: call() for name, call in _rows_calls(fixed, var).items()
                  if "fixed_width_optimized" not in name}
    for name, rows in oracle.items():
        if name.startswith("to_rows"):
            _require_rows_equal(f"{name} oracle arm", outs[name], rows)
        else:
            for g, w in zip(outs[name], rows):
                _require_columns_equal(f"{name} oracle arm", g, w)
    for name in ("from_rows[store_sales]", "from_rows_fixed_width_optimized[store_sales]"):
        (back,) = outs[name]
        _require_columns_equal(f"{name} round trip", back, fixed)
    (back,) = outs["from_rows[int32,varchar,decimal128]"]
    _require_columns_equal("var round trip", back, var)
    from spark_rapids_jni_tpu_torch.ops import convert_from_rows

    parts = [convert_from_rows(b, [col.dtype for col in var]) for b in split]
    _require_columns_equal("var round trip (2^26 B batches)", _concat_columns(parts), var)
    return cpu_s, sizes


def _table_bytes(cols) -> int:
    """Bytes a conversion reads from (or writes to) columns: values, string
    chars and offsets, and a validity byte per row of each nullable column."""
    total = 0
    for col in cols:
        for t in ([col.chars, col.offsets] if hasattr(col, "chars")
                  else [col.hi, col.lo] if hasattr(col, "hi") else [col.data]):
            total += t.numel() * t.element_size()
        if col.validity is not None:
            total += col.validity.numel()
    return total


def _rows_bytes(batches) -> int:
    return sum(b.child.data.numel() + 4 * b.offsets.numel() for b in batches)


def time_rows(fixed, var, outs, rates):
    """Each row call's time (CUDA events, median of ROWS_REPS after
    ROWS_WARMUP) and peak memory beside its bytes bound (columns read plus rows
    written, or the reverse), and the PHASES of one call."""
    from spark_rapids_jni_tpu_torch.ops import row_conversion

    lines = {}
    for name, call in _rows_calls(fixed, var).items():
        cols = fixed if "store_sales" in name else var
        rows = outs["to_rows[store_sales]" if "store_sales" in name
                    else "to_rows[int32,varchar,decimal128]"]
        nbytes = _table_bytes(cols) + _rows_bytes(outs[name] if name.startswith("to_rows")
                                                  else rows)
        line = _timed(call, ROWS_REPS, ROWS_WARMUP)
        torch.cuda.synchronize()
        row_conversion.PHASES.reset()
        call()
        torch.cuda.synchronize()
        line.update({"phases_s": row_conversion.PHASES.snapshot(), "bytes": nbytes,
                     **_bound(nbytes, 0, rates)})
        lines[name] = line
    return lines


def jcudf_rows(rates, device="cuda"):
    """The row phase: the path with the counters at 0, the checks, the times;
    prints the ``rows`` line and returns the path's launch counts."""
    from spark_rapids_jni_tpu_torch.ops.row_conversion import compute_layout

    t0 = time.perf_counter()
    fixed, var = store_sales_columns(device), var_columns(device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    layout = {"store_sales": compute_layout([col.dtype for col in fixed])[3],
              "int32,varchar,decimal128": compute_layout([col.dtype for col in var])[3]}
    if layout != {"store_sales": 103, "int32,varchar,decimal128": 33}:
        raise AssertionError(f"size_per_row {layout}")
    counts, outs = rows_path(fixed, var)
    cpu_s, sizes = check_rows(fixed, var, outs)
    print(json.dumps({"rows": {
        "n_fixed": N_ROWS_FIXED, "n_var": N_ROWS_VAR, "size_per_row": layout,
        "store_sales_batch_bytes": int(outs["to_rows[store_sales]"][0].child.data.numel()),
        "var_rows_bytes": _rows_bytes(outs["to_rows[int32,varchar,decimal128]"]),
        "split_batch_rows": sizes, "calls": time_rows(fixed, var, outs, rates),
        "checks": {"cpu_host_arm_s": cpu_s, "oracle_arm": "equal", "round_trips": "equal"},
        "batch_gen_s": gen_s}}))
    return counts


# ---- the CastStrings path (BASELINE config 2) --------------------------------

N_CAST = 1 << 24  # rows of the FLOAT64 column (128 MiB) and of the integer strings
N_CAST_MID = 1 << 22  # rows of the decimal, format_float and base-cast calls
N_CAST_CORPUS = 1 << 20  # rows of the adversarial parse corpus and the ANSI column
CAST_SAMPLE = 1 << 18  # rows of each call held against the CPU run (strided)
CAST_REPS, CAST_WARMUP = 3, 0  # the path's own call warms each one up


def _digits(mag, width):
    """[n, width] ASCII digits of non-negative int64 ``mag`` (a tensor),
    right-aligned, and each value's digit count."""
    cols = []
    v = mag
    for _ in range(width):
        cols.append((v % 10 + ord("0")).to(torch.uint8))
        v = v // 10
    nd = torch.ones_like(mag)
    for k in range(1, 19):
        nd += (mag >= 10 ** k).to(torch.int64)
    return torch.stack(cols[::-1], dim=1), nd


def _concat_fields(parts, valid):
    """A StringColumn whose row i is the concatenation, over ``parts``, of
    the last ``ln[i]`` bytes of ``field[i]`` (``(field [n, w] uint8, ln [n])``
    pairs on one device)."""
    from spark_rapids_jni_tpu_torch import columnar as c

    n, dev = parts[0][0].shape[0], parts[0][0].device
    width = sum(f.shape[1] for f, _ in parts)
    out = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    pos = torch.zeros(n, dtype=torch.int64, device=dev)
    col = torch.arange(width, device=dev)[None, :]
    for field, ln in parts:
        w = field.shape[1]
        ln = torch.as_tensor(ln, device=dev).to(torch.int64).expand(n)
        take = (col >= pos[:, None]) & (col < (pos + ln)[:, None])
        src = torch.clamp(col - pos[:, None] + (w - ln)[:, None], 0, w - 1)
        out = torch.where(take, torch.gather(field, 1, src), out)
        pos = pos + ln
    return c.strings_from_padded(out, pos, valid)


def _const_field(n, text, device):
    return torch.tensor(list(text.encode()), dtype=torch.uint8,
                        device=device).expand(n, len(text))


def _bools(rng, n, p, device):
    return torch.from_numpy(rng.random(n) < p).to(device)


def _integer_strings(rng, n, device):
    """``n`` Spark integer strings: 1-18 digits (the count uniform), 10% '-'
    and 5% '+' signs, 5% wrapped in whitespace, 1% of 20 digits (past
    INT64), 1% ending in a junk letter, 5% nulls."""
    mag = torch.from_numpy((rng.random(n) * 10.0 ** rng.integers(1, 19, n))
                           .astype(np.int64)).to(device)
    digits, nd = _digits(mag, 20)
    over = _bools(rng, n, 0.01, device)
    nd = torch.where(over, 20, nd)
    digits[:, 0] = torch.where(over, ord("9"), digits[:, 0])
    junk = _bools(rng, n, 0.01, device)
    digits[:, -1] = torch.where(junk, ord("z"), digits[:, -1])
    sign = torch.where(_bools(rng, n, 2 / 3, device), ord("-"), ord("+")).to(torch.uint8)
    ws = _bools(rng, n, 0.05, device).to(torch.int64)
    pad = _const_field(n, " \t", device)
    return _concat_fields([(pad, 2 * ws), (sign[:, None], _bools(rng, n, 0.15, device)),
                           (digits, nd), (pad, ws)], _bools(rng, n, 0.95, device))


def _price_strings(rng, n, device):
    """``n`` price strings "d+.dd" under 100000, 2% as "d.ddddE+k", 5%
    nulls."""
    cents = torch.from_numpy(rng.integers(0, 10**7, n)).to(device)
    sci = _bools(rng, n, 0.02, device)
    ip, ipn = _digits(cents // 100, 5)
    fp, _ = _digits(cents % 100, 2)
    mant, _ = _digits(torch.from_numpy(rng.integers(10000, 100000, n)).to(device), 5)
    exp = (torch.from_numpy(rng.integers(0, 5, n)).to(device) + ord("0")).to(torch.uint8)
    plain = ~sci
    return _concat_fields([(ip, torch.where(plain, ipn, 0)), (mant[:, :1], sci),
                           (_const_field(n, ".", device), 1),
                           (fp, torch.where(plain, 2, 0)), (mant[:, 1:], 4 * sci),
                           (_const_field(n, "E+", device), 2 * sci), (exp[:, None], sci)],
                          _bools(rng, n, 0.95, device))


def _hex_strings(rng, n, device):
    """``n`` conv() inputs in base 16: 1-16 hex digits of either case, 10%
    '-', 5% leading whitespace, 2% a junk tail, 2% a lone blank."""
    nib = torch.from_numpy(rng.integers(0, 16, (n, 16))).to(device)
    upper = _bools(rng, n, 0.5, device)[:, None]
    digits = torch.where(nib < 10, nib + ord("0"),
                         torch.where(upper, nib + ord("A") - 10, nib + ord("a") - 10))
    nd = torch.from_numpy(rng.integers(1, 17, n)).to(device)
    blank = _bools(rng, n, 0.02, device)
    return _concat_fields([(_const_field(n, "  ", device), 2 * _bools(rng, n, 0.05, device)),
                           (_const_field(n, "-", device), _bools(rng, n, 0.1, device)),
                           (digits.to(torch.uint8), torch.where(blank, 0, nd)),
                           (_const_field(n, "zzz", device), 3 * _bools(rng, n, 0.02, device)),
                           (_const_field(n, " ", device), blank)], None)


# adversarial parse strings in the style of tests/test_straggler_fastpaths.py
_PARSE_EDGES = [
    "0", "-0", "0.0", "-0.0", ".5", "5.", "+3", "1e291", "-1e291", "1e-291", "1e308",
    "1e309", "1e-310", "4.9e-324", "1e-400", "1e400", "17976931348623157e292",
    "9999999999999999999", "18446744073709551609", "18446744073709551610",
    "184467440737095516091234", "0.01234567890123456789",
    "0." + "0" * 30 + "123456789012345678901234", "nan", "NaN", "-nan", "inf", "-inf",
    "Infinity", "-INFINITY", "+inf", " inf", "\riNf", "infinity7", "infx", "7f", "8d", "0f",
    "0d", "0 ", "1.3e+7f", "46037e\t", "2F.", "", ".", "e", "E15", "A", "null", "--1", "1..2",
    "1e", "1e+", "1.5e3e4", "0x1p3", " " * 36 + "7d", "1.1\x00", "1.2\x14", "1.6\x9f", "1.7!",
]


def _parse_corpus(n, device):
    """``n`` rows drawn (numpy seed 59) from 4096 adversarial strings:
    whitespace, signs, inf / infinity / nan in any case, trailing f/d,
    exponents, more than 20 digits, junk; 5% nulls."""
    from spark_rapids_jni_tpu_torch import columnar as c

    r = np.random.RandomState(59)
    base = list(_PARSE_EDGES)
    while len(base) < 4096:
        nd = r.randint(1, 26)
        digs = "".join(r.choice(list("0123456789"), nd))
        pt = r.randint(0, nd + 1)
        s = digs[:pt] + "." + digs[pt:] if r.rand() < 0.6 else digs
        if r.rand() < 0.6:
            s += r.choice(["e", "E"]) + str(r.choice(["", "+", "-"])) + str(r.randint(0, 330))
        if r.rand() < 0.5:
            s = "-" + s
        if r.rand() < 0.2:
            s = r.choice([" ", "\t", "\n"]) + s + r.choice(["f", "D", " ", ""])
        if r.rand() < 0.05:
            s = "".join(r.choice(list("0123456789.eE+-fdx \t\rZ"), 10))
        base.append(s)
    table = c.strings_column(base, device).padded()
    pick = np.concatenate([np.arange(len(base)), r.randint(0, len(base), max(n - len(base), 0))])
    pick = torch.from_numpy(pick[:n]).to(device)
    return c.strings_from_padded(table[0][pick], table[1][pick],
                                 torch.from_numpy(r.rand(n) >= 0.05).to(device))


def _cast_floats(n, device):
    """FLOAT64 values (numpy seed 53): the specials first (NaN, +-Inf, +-0,
    the least subnormal, the largest double), then 72% rand x exp(U(-30,
    30)) (full Ryu), 20% cent-rounded prices in [0, 1000), 8% integers in
    [1, 10**7) (the simple class), 30% negative; 5% nulls.  Returns the
    FLOAT64 column and the FLOAT32 column of the same values."""
    from spark_rapids_jni_tpu_torch import columnar as c

    rng = np.random.default_rng(53)
    kind = rng.random(n)
    vals = np.where(kind < 0.72, rng.random(n) * np.exp(rng.uniform(-30, 30, n)),
                    np.where(kind < 0.92, np.round(rng.random(n) * 1000, 2),
                             rng.integers(1, 10**7, n).astype(np.float64)))
    vals *= np.where(rng.random(n) < 0.3, -1.0, 1.0)
    vals[:7] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 5e-324, 1.7976931348623157e308]
    valid = torch.from_numpy(rng.random(n) >= 0.05).to(device)
    valid[:7] = True
    with np.errstate(over="ignore"):
        f32 = vals.astype(np.float32)
    return (c.Column(torch.from_numpy(vals.view(np.int64)).to(device), valid, c.FLOAT64),
            c.Column(torch.from_numpy(f32).to(device), valid.clone(), c.FLOAT32))


def _head(col, n):
    """The first ``n`` rows of a column (views; a string column keeps only
    its rows' chars)."""
    from spark_rapids_jni_tpu_torch import columnar as c

    valid = None if col.validity is None else col.validity[:n]
    if hasattr(col, "chars"):
        offs = col.offsets[:n + 1]
        return c.StringColumn(col.chars[:int(offs[-1])], offs, valid)
    return c.Column(col.data[:n], valid, col.dtype)


def casts_batch(device):
    """The casts phase's inputs, drawn with numpy from fixed seeds (strings
    laid out by plain torch on ``device``), and the FLOAT64 column's strings,
    made by float_to_string."""
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch.ops import float_to_string

    f64, f32 = _cast_floats(N_CAST, device)
    rng = np.random.default_rng(61)
    ints = _integer_strings(rng, N_CAST, device)
    i64 = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, N_CAST_MID,
                       endpoint=True)
    i64[:3] = [np.iinfo(np.int64).min, -1, 0]
    d64 = (rng.random(N_CAST) * 10.0 ** rng.integers(1, 19, N_CAST)).astype(np.int64)
    d64 *= np.where(rng.random(N_CAST) < 0.5, -1, 1)
    d64[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
    ansi = float_to_string(c.Column(f64.data[:N_CAST_CORPUS], None, c.FLOAT64))
    bad = int(rng.integers(0, N_CAST_CORPUS))
    ansi.chars[ansi.offsets[bad]] = ord("x")  # the one row that cannot parse
    # format_float sizes its grid by the largest exponent: its rows keep the
    # specials but not the least subnormal and the largest double
    keep = torch.cat([torch.arange(5), torch.arange(7, N_CAST_MID + 2)]).to(device)
    return {
        "f64": f64, "f32": f32,
        "f64_mid": c.Column(f64.data[keep], f64.validity[keep], c.FLOAT64),
        "f32_mid": c.Column(f32.data[keep], f32.validity[keep], c.FLOAT32),
        "f64_strings": float_to_string(f64),
        "corpus": _parse_corpus(N_CAST_CORPUS, device), "ints": ints,
        "ints_mid": _head(ints, N_CAST_MID), "prices": _price_strings(rng, N_CAST_MID, device),
        "hex": _hex_strings(rng, N_CAST_MID, device),
        "i64": c.Column(torch.from_numpy(i64).to(device), None, c.INT64),
        "dec128": _decimals(np.random.RandomState(67), N_CAST, device),
        "dec64": c.Column(torch.from_numpy(d64).to(device), None, c.decimal(18, 2)),
        "ansi": ansi, "ansi_row": bad}


def _cast_calls(b):
    """name -> (function of one column through the public CastStrings API,
    the batch's input column for it, the config flags it runs under)."""
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch import ops

    def to_float(dt):
        return lambda col: ops.string_to_float(col, False, dt)

    return {
        "float_to_string[f64]": (ops.float_to_string, b["f64"], {}),
        "float_to_string[f32]": (ops.float_to_string, b["f32"], {}),
        "float_to_string[f64,oracle]": (ops.float_to_string, b["f64"],
                                        {"float_bucketed": False}),
        "string_to_float[f64]": (to_float(c.FLOAT64), b["f64_strings"], {}),
        "string_to_float[f32]": (to_float(c.FLOAT32), b["f64_strings"], {}),
        "string_to_float[corpus]": (to_float(c.FLOAT64), b["corpus"], {}),
        "string_to_integer[int64]": (lambda col: ops.string_to_integer(col, c.INT64),
                                     b["ints"], {}),
        "string_to_integer[int32]": (lambda col: ops.string_to_integer(col, c.INT32),
                                     b["ints"], {}),
        "string_to_decimal[38,2]": (lambda col: ops.string_to_decimal(col, 38, 2),
                                    b["prices"], {}),
        "string_to_decimal[7,2]": (lambda col: ops.string_to_decimal(col, 7, 2),
                                   b["prices"], {}),
        "decimal_to_string[38,2]": (ops.decimal_to_string, b["dec128"], {}),
        "decimal_to_string[18,2]": (ops.decimal_to_string, b["dec64"], {}),
        "format_float[f64,2]": (lambda col: ops.format_float(col, 2), b["f64_mid"], {}),
        "format_float[f32,2]": (lambda col: ops.format_float(col, 2), b["f32_mid"], {}),
        "to_integers_with_base[16]": (lambda col: ops.to_integers_with_base(col, 16),
                                      b["hex"], {}),
        "to_integers_with_base[10]": (lambda col: ops.to_integers_with_base(col, 10),
                                      b["ints_mid"], {}),
        "from_integers_with_base[16]": (lambda col: ops.from_integers_with_base(col, 16),
                                        b["i64"], {}),
        "from_integers_with_base[10]": (lambda col: ops.from_integers_with_base(col, 10),
                                        b["i64"], {}),
    }


def _cast_run(spec, col=None):
    """One call of ``spec`` on its own input, or on ``col``."""
    from spark_rapids_jni_tpu_torch import config

    fn, inp, flags = spec
    with config.override(**flags):
        return fn(inp if col is None else col)


def casts_path(b):
    """Every cast call once on the card with the counters at 0: plain torch,
    no kernel of the hash wrappers may launch."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    calls = _cast_calls(b)
    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    outs = {name: _cast_run(spec) for name, spec in calls.items()}
    torch.cuda.synchronize()
    counts = dict(hash_cuda.launches)
    print(json.dumps({"casts_launches": counts}))
    if any(counts.values()):
        raise AssertionError(f"the casts path launched hash kernels: {counts}")
    return counts, outs


def _take(col, idx):
    """Rows ``idx`` of a column, copied to the CPU."""
    from spark_rapids_jni_tpu_torch import columnar as c

    valid = None if col.validity is None else col.validity[idx].cpu()
    if hasattr(col, "chars"):
        starts = col.offsets[idx].to(torch.int64)
        lens = col.offsets[idx + 1].to(torch.int64) - starts
        offs = torch.zeros(idx.numel() + 1, dtype=torch.int64, device=idx.device)
        offs[1:] = torch.cumsum(lens, 0)
        row = torch.repeat_interleave(torch.arange(idx.numel(), device=idx.device), lens)
        pos = torch.arange(row.numel(), device=idx.device)
        chars = col.chars[starts[row] + pos - offs[:-1][row]]
        return c.StringColumn(chars.cpu(), offs.to(torch.int32).cpu(), valid)
    if hasattr(col, "hi"):
        return c.Decimal128Column(col.hi[idx].cpu(), col.lo[idx].cpu(), valid, col.dtype)
    return c.Column(col.data[idx].cpu(), valid, col.dtype)


# the gtest vectors of tests/test_float_to_string.py, tests/test_decimal_format.py
# and tests/test_cast_string_to_float.py: (call, input, expected to_list())
CAST_VECTORS = [
    ("float_to_string", "f32", [100.0, 654321.25, -12761.125, 0.0, 5.0, -4.0, float("nan"),
                                123456789012.34, -0.0],
     ["100.0", "654321.25", "-12761.125", "0.0", "5.0", "-4.0", "NaN", "1.2345679E11",
      "-0.0"]),
    ("float_to_string", "f64", [100.0, 654321.25, -12761.125, 1.123456789123456789,
                                0.000000000000000000123456789123456789, 0.0, 5.0, -4.0,
                                float("nan"), 839542223232.794248339, -0.0, float("inf"),
                                1e7, 9999999.0, 1e-3, 9.0e-4, 5e-324,
                                1.7976931348623157e308],
     ["100.0", "654321.25", "-12761.125", "1.1234567891234568", "1.234567891234568E-19", "0.0",
      "5.0", "-4.0", "NaN", "8.395422232327942E11", "-0.0", "Infinity", "1.0E7", "9999999.0",
      "0.001", "9.0E-4", "5.0E-324", "1.7976931348623157E308"]),
    ("format_float", "f32", [100.0, 654321.25, -12761.125, 0.0, 5.0, -4.0, float("nan"),
                             123456789012.34, -0.0],
     ["100.00000", "654,321.25000", "-12,761.12500", "0.00000", "5.00000", "-4.00000", "�",
      "123,456,790,000.00000", "-0.00000"]),
    ("format_float", "f64", [100.0, 654321.25, -12761.125, 1.123456789123456789,
                             0.000000000000000000123456789123456789, 0.0, 5.0, -4.0,
                             float("nan"), 839542223232.794248339, 3232.794248339,
                             11234000000.0, -0.0, float("inf"), float("-inf")],
     ["100.00000", "654,321.25000", "-12,761.12500", "1.12346", "0.00000", "0.00000",
      "5.00000", "-4.00000", "�", "839,542,223,232.79420", "3,232.79425",
      "11,234,000,000.00000", "-0.00000", "∞", "-∞"]),
    ("decimal_to_string", (18, 7), [0, 100000000], ["0E-7", "10.0000000"]),
    ("decimal_to_string", (9, -1), [21, -30, 5], ["2.1E+2", "-3.0E+2", "5E+1"]),
    ("decimal_to_string", (38, 10), [12345678901234567890123456789012345678, -1, 0, None,
                                     -(10**37)],
     ["1234567890123456789012345678.9012345678", "-1E-10", "0E-10", None,
      "-1000000000000000000000000000.0000000000"]),
    ("string_to_float", "f64", ["7f", "\riNf", "1.3e5ef", "1.3e+7f", "9\n", "46037e\t", "8d",
                                "0\n", ".\r", "2F.", " " * 36 + "7d",
                                " " * 28 + "98392.5e-1f", ".", "e", "-2.21363921575273728E17",
                                "0", "-0000000000000000000E0",
                                "0000000000000000000000000000000017", "18446744073709551609",
                                "-1.8946e-10", "0000.123", "-nan", "1e-310", "1e-400"],
     [7.0, float("inf"), None, 13000000.0, 9.0, None, 8.0, 0.0, None, None, 7.0, 9839.25, None,
      None, -2.21363921575273728e17, 0.0, -0.0, 17.0, 18446744073709551609.0, -1.8946e-10,
      0.123, None, 1e-310, 0.0]),
]


def check_cast_vectors(device):
    """The gtest vectors give their expected strings and values on ``device``."""
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch import ops

    for i, (op, kind, vals, expected) in enumerate(CAST_VECTORS):
        if op == "decimal_to_string":
            p, s = kind
            col = (c.decimal128_column(vals, p, s, device) if p > 18
                   else c.column(vals, c.decimal(p, s), device))
            got = ops.decimal_to_string(col).to_list()
        elif op == "string_to_float":
            got = ops.string_to_float(c.strings_column(vals, device), False,
                                      c.FLOAT64).to_list()
        else:
            col = c.column(vals, c.FLOAT32 if kind == "f32" else c.FLOAT64, device)
            got = (ops.float_to_string(col) if op == "float_to_string"
                   else ops.format_float(col, 5)).to_list()
        if got != expected:
            raise AssertionError(f"gtest vector {i} ({op}): {got} != {expected}")
    return len(CAST_VECTORS)


def check_casts(b, outs):
    """The checks of the casts phase; returns what they measured.

    - the arms against each other on the card: float_to_string's bucketed
      lane arm against its monolithic oracle on whole outputs (the path's
      own calls), string_to_float's lane arm against the pinned numpy twin
      to FLOAT64 on the first N_CAST_MID rows (FLOAT32 meets the twin in the
      CPU sample);
    - every call against the port's CPU run on a strided CAST_SAMPLE-row
      sample of its input (the functions are row-wise);
    - ANSI mode names the one bad row; the gtest vectors on the card;
    - the round-trip share string_to_float(float_to_string(x)) == x over the
      finite rows (printed, not a gate: the reference's parse is not
      correctly rounded at extreme exponents).
    """
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch import config, ops

    _require_columns_equal("float_to_string lane arm vs oracle",
                           [outs["float_to_string[f64]"]], [outs["float_to_string[f64,oracle]"]])
    t0 = time.perf_counter()
    with config.override(cast_device_parse=False):
        twin = ops.string_to_float(_head(b["f64_strings"], N_CAST_MID), False, c.FLOAT64)
    _require_columns_equal("string_to_float[f64] lane arm vs numpy twin",
                           [_head(outs["string_to_float[f64]"], N_CAST_MID)], [twin])
    twin_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    for name, spec in _cast_calls(b).items():
        col = spec[1]
        idx = torch.arange(0, col.size, max(col.size // CAST_SAMPLE, 1), device=col.device)
        _require_columns_equal(f"{name} vs the CPU run", [_take(outs[name], idx)],
                               [_cast_run(spec, _take(col, idx))])
    cpu_s = time.perf_counter() - t0

    try:
        ops.string_to_float(b["ansi"], True, c.FLOAT64)
    except ops.CastException as e:
        if e.row_with_error != b["ansi_row"]:
            raise AssertionError(f"ANSI error row {e.row_with_error} != {b['ansi_row']}")
    else:
        raise AssertionError("ANSI string_to_float raised no CastException")

    f64 = b["f64"]
    finite = torch.isfinite(f64.data.view(torch.float64)) & f64.is_valid()
    back = outs["string_to_float[f64]"].data
    return {"twin_arm_s": twin_s, "cpu_sample_s": cpu_s, "sample_rows": CAST_SAMPLE,
            "ansi_error_row": b["ansi_row"],
            "round_trip_exact_share": float((back[finite] == f64.data[finite]).double().mean()),
            "gtest_vectors": check_cast_vectors(f64.device)}


def time_casts(b, outs, rates):
    """Each call's time (CUDA events, median of CAST_REPS after CAST_WARMUP)
    and peak memory, the kernels the profiler sees in one more call, the
    PHASES of one more (float_to_string and string_to_float), and its bytes
    bound: its input read once and its output written once."""
    import importlib

    phases = {"float_to_string": "float_to_string", "string_to_float": "cast_string_to_float"}
    lines = {}
    for name, spec in _cast_calls(b).items():
        line = _timed(lambda spec=spec: _cast_run(spec), CAST_REPS, CAST_WARMUP)
        nbytes = _table_bytes([spec[1], outs[name]])
        line.update({"n": spec[1].size, "bytes": nbytes, **_bound(nbytes, 0, rates),
                     "profiled_kernels": _profiled_kernels(lambda spec=spec: _cast_run(spec))})
        module = phases.get(name.split("[")[0])
        if module is not None:  # the package's float_to_string is the function
            timer = importlib.import_module(f"spark_rapids_jni_tpu_torch.ops.{module}").PHASES
            torch.cuda.synchronize()
            timer.reset()
            _cast_run(spec)
            torch.cuda.synchronize()
            line["phases_s"] = timer.snapshot()
        lines[name] = line
    return lines


def casts(rates, device="cuda"):
    """The casts phase: the path with the counters at 0, the checks, the
    times; prints the ``casts`` line and returns the path's launch counts."""
    t0 = time.perf_counter()
    b = casts_batch(device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts, outs = casts_path(b)
    checks = check_casts(b, outs)
    print(json.dumps({"casts": {
        "n": N_CAST, "n_mid": N_CAST_MID, "n_corpus": N_CAST_CORPUS,
        "f64_strings_chars": int(b["f64_strings"].offsets[-1]),
        "calls": time_casts(b, outs, rates), "checks": checks, "batch_gen_s": gen_s}}))
    return counts


# ---- the order tier ---------------------------------------------------------


def _runs(*keys):
    """Run starts over rows sorted by ``keys``: row 0, and every row whose
    key tuple differs from the row before it."""
    start = np.zeros(len(keys[0]), bool)
    for k in keys:
        start[1:] |= k[1:] != k[:-1]
    start[:1] = True
    return start


def _narrow(a):
    """``a`` in the narrowest signed integer type that holds its values, so
    that ``np.lexsort`` sorts it by radix (8 and 16 bits) or sooner; the
    values are unchanged."""
    for dt in (np.int8, np.int16, np.int32):
        info = np.iinfo(dt)
        if a.size == 0 or (a.min() >= info.min and a.max() <= info.max):
            return a.astype(dt)
    return a


def _segment_starts(start):
    """For every row, the index of the first row of its run."""
    return np.maximum.accumulate(np.where(start, np.arange(len(start)), 0))


def q67_vector_oracle(tables, k):
    """q67 (``models/q67.py``) in vectorized numpy, for the full-size run:
    the rows sorted by (category, price desc, sid) with ``np.lexsort``, the
    category runs and price-tie groups from change points, rank and dense
    rank from cumulative maxima and sums, then the kept rows in (category,
    rank, sid) order.  Equal to ``q67_oracle``, which loops per row."""
    ss, item = tables["store_sales"], tables["item"]
    n_items = len(item["category"])
    sel = (ss["item_sk"] >= 1) & (ss["item_sk"] <= n_items)
    item_sk, price, sid = ss["item_sk"][sel], ss["price"][sel], ss["sid"][sel]
    category = item["category"][item_sk - 1]
    order = np.lexsort((_narrow(sid), _narrow(-price), _narrow(category)))
    cat, price, item_sk, sid = category[order], price[order], item_sk[order], sid[order]
    run = _runs(cat)
    tie = run | _runs(price)
    seg0 = _segment_starts(run)
    rk = _segment_starts(tie) - seg0 + 1
    c = np.cumsum(tie)
    drk = c - c[seg0] + 1
    keep = np.flatnonzero(rk <= k)
    keep = keep[np.lexsort((sid[keep], rk[keep], cat[keep]))]
    return {"category": cat[keep], "item_sk": item_sk[keep], "price": price[keep],
            "sid": sid[keep], "rk": rk[keep].astype(np.int32),
            "drk": drk[keep].astype(np.int32), "rows": np.int64(len(keep))}


def _running_max(v, seg0):
    """Running maximum within each run, by doubling: after the step of width
    ``d`` row i holds the maximum over its run's last ``2d`` rows up to i."""
    out, idx, d = v.copy(), np.arange(len(v)), 1
    longest = int((idx - seg0).max()) + 1 if len(v) else 0
    while d < longest:
        take = idx[d:] - d >= seg0[d:]
        out[d:] = np.where(take, np.maximum(out[d:], out[:-d]), out[d:])
        d *= 2
    return out


def q64_vector_oracle(tables, k, band0):
    """q64 (``models/q64.py``) in vectorized numpy, for the full-size run:
    both dim joins, the band filter, the rows sorted by (category, brand, net
    desc, sid) with ``np.lexsort``, the (category, brand) runs from change
    points, then row number, the running and 3-preceding sums from cumulative
    sums and the running max by doubling, and the first ``k`` rows of each
    run.  Equal to ``q64_oracle``, which loops per row."""
    ss, item, cust = tables["store_sales"], tables["item"], tables["customer"]
    n_items, n_custs = len(item["category"]), len(cust["band"])
    sel = ((ss["item_sk"] >= 1) & (ss["item_sk"] <= n_items)
           & (ss["cust_sk"] >= 1) & (ss["cust_sk"] <= n_custs))
    item_sk, cust_sk = ss["item_sk"][sel], ss["cust_sk"][sel]
    net = (ss["qty"][sel] * ss["price"][sel]).astype(np.int64)
    sid = ss["sid"][sel]
    keep = cust["band"][cust_sk - 1] >= band0
    cat, brand = item["category"][item_sk - 1][keep], item["brand"][item_sk - 1][keep]
    net, sid = net[keep], sid[keep]
    order = np.lexsort((_narrow(sid), _narrow(-net), _narrow(brand), _narrow(cat)))
    cat, brand, net, sid = cat[order], brand[order], net[order], sid[order]
    seg0 = _segment_starts(_runs(cat, brand))
    idx = np.arange(len(net))
    rn = idx - seg0 + 1
    cs = np.cumsum(net)

    def frame_sum(lo):
        return cs - np.where(lo > 0, cs[np.maximum(lo - 1, 0)], 0)

    out = {"category": cat, "brand": brand, "sid": sid, "net": net,
           "rn": rn.astype(np.int32), "run_net": frame_sum(seg0),
           "net4": frame_sum(np.maximum(seg0, idx - 3)), "peak": _running_max(net, seg0)}
    first = rn <= k  # already in (category, brand, rn) order
    out = {f: v[first] for f, v in out.items()}
    out["rows"] = np.int64(int(first.sum()))
    return out


def topk_vector_oracle(tables, k):
    """The global top-k by (price desc, sid asc) without sorting every row:
    the rows priced at least the k-th largest price, sorted with
    ``np.lexsort``, their first k.  Equal to ``topk_oracle``."""
    ss = tables["store_sales"]
    price, sid = ss["price"], ss["sid"]
    k = min(k, len(price))
    if k == 0:
        return {"price": price[:0], "sid": sid[:0], "rows": np.int64(0)}
    kth = np.partition(price, len(price) - k)[len(price) - k]
    cand = np.flatnonzero(price >= kth)
    cand = cand[np.lexsort((sid[cand], -price[cand]))][:k]
    return {"price": price[cand], "sid": sid[cand], "rows": np.int64(k)}


ORDER_ROWS = 28_800_991  # TPC-DS SF10 store_sales rows
ORDER_ITEMS = 102_000  # SF10 item rows
ORDER_CUSTS = 500_000  # SF10 customer rows
ORDER_CATS = 10  # TPC-DS i_category values
ORDER_BANDS, ORDER_BAND0 = 20, 10  # TPC-DS income_band rows; q64's band cut
ORDER_BRANDS = 1000  # brands: about 10,000 (category, brand) runs
ORDER_K = 100  # q67's rk <= 100, and the top-k's and q64's k
ORDER_SHARDS = 4  # map shards and range partitions of the multi-shard runs
ORDER_SMALL = 1 << 20  # rows of the runs held against the CPU run
ORDER_REPS = 1  # host-to-host calls timed per call, after the path's first
ORDER_SEED = 67


def order_batch(rows, seed=ORDER_SEED):
    """q67's and q64's tables of ``rows`` store sales at SF10's dims, from the
    models' numpy generators."""
    from spark_rapids_jni_tpu_torch.models import make_q64_tables, make_q67_tables

    return {"q67": make_q67_tables(rows, ORDER_ITEMS, ORDER_CATS, seed=seed),
            "q64": make_q64_tables(rows, ORDER_ITEMS, ORDER_CUSTS, n_cats=ORDER_CATS,
                                   n_brands=ORDER_BRANDS, n_bands=ORDER_BANDS, seed=seed + 1)}


def _order_plans():
    """name -> (the plan, the batch's tables it runs on)."""
    from spark_rapids_jni_tpu_torch.models import (
        naive_sort_limit_plan,
        q64_plan,
        q67_plan,
        topk_sales_plan,
    )

    return {"q67": (q67_plan(ORDER_K, ORDER_ITEMS), "q67"),
            "q64": (q64_plan(ORDER_K, ORDER_ITEMS, ORDER_CUSTS, ORDER_BAND0), "q64"),
            "topk": (topk_sales_plan(ORDER_K), "q67"),
            "naive": (naive_sort_limit_plan(ORDER_K), "q67")}


def _reduce_tables(reduce_plan, part, tables):
    from spark_rapids_jni_tpu_torch.plans import EXCHANGE_SOURCE, ir

    rt = {EXCHANGE_SOURCE: part}
    for dim in ir.dim_tables(reduce_plan):
        rt[dim.table] = tables[dim.table]
    return rt


def _multiparts(plan, tables, nshards, nparts, device):
    """A cluster's range shuffle in one process: split the fact into map
    shards, choose the splitters once from the whole input, emit each
    shard's range partitions against them, regroup by partition, reduce
    each, ordered-concat.  Returns the result and the bytes that cross the
    'wire' (every partition's rows)."""
    from spark_rapids_jni_tpu_torch.plans import (
        emit_range_partitions,
        execute_plan,
        sample_range_splitters,
        split_exchange_plan,
    )
    from spark_rapids_jni_tpu_torch.serve.shuffle import (
        _slice_order_output,
        combine_ordered_outputs,
        scan_table_names,
        split_tables_n,
    )

    exchange, reduce_plan = split_exchange_plan(plan)
    splitters = sample_range_splitters(exchange, tables, nparts, device=device)
    shards = split_tables_n(tables, scan_table_names(plan), nshards)
    byshard = [emit_range_partitions(exchange, s, nparts, splitters, device=device)
               for s in shards]
    outs, nbytes = [], 0
    for p in range(nparts):
        part = {f: np.concatenate([byshard[m][p][f] for m in range(nshards)])
                for f in exchange.fields}
        nbytes += sum(v.nbytes for v in part.values())
        out = execute_plan(None, reduce_plan, _reduce_tables(reduce_plan, part, tables),
                           device=device)
        outs.append(_slice_order_output(reduce_plan, out))
    return combine_ordered_outputs(plan)(outs), nbytes


def _governed_reduce(plan, tables, device):
    """``plan``'s reduce half over its one range partition through
    run_governed_plan at the default budget (the card's memory), sliced to
    its valid rows."""
    from spark_rapids_jni_tpu_torch.plans import (
        emit_range_partitions,
        run_governed_plan,
        split_exchange_plan,
    )
    from spark_rapids_jni_tpu_torch.serve.shuffle import _slice_order_output

    exchange, reduce_plan = split_exchange_plan(plan)
    (part,) = emit_range_partitions(exchange, tables, 1, (), device=device)
    out = run_governed_plan(None, reduce_plan, _reduce_tables(reduce_plan, part, tables),
                            device=device)
    return _slice_order_output(reduce_plan, out)


def _order_calls(b, device):
    """call -> zero-argument call of the port's order-tier entry points on
    batch ``b``: each plan through run_range_plan_local, q67 and both top-k
    forms over ORDER_SHARDS map shards into as many range partitions, and
    q67's reduce plan governed."""
    from spark_rapids_jni_tpu_torch.serve.shuffle import run_range_plan_local

    plans = _order_plans()
    calls = {name: (lambda p=p, t=b[t]: run_range_plan_local(p, t, device=device))
             for name, (p, t) in plans.items()}
    for name in ("q67", "topk", "naive"):
        calls[f"{name}_multi"] = (lambda p=plans[name][0]: _multiparts(
            p, b["q67"], ORDER_SHARDS, ORDER_SHARDS, device))
    calls["q67_governed"] = lambda: _governed_reduce(plans["q67"][0], b["q67"], device)
    return calls


def _split_multi(outs):
    """The multi-shard calls' results and wire bytes apart."""
    wire = {}
    for name in [n for n in outs if n.endswith("_multi")]:
        outs[name], wire[name] = outs[name]
    return outs, wire


def order_path(b):
    """Every order-tier call once on the card with the counters at 0 (no
    hash kernel may launch: a range exchange places rows by rank); returns
    the counts, the outputs, the wire bytes and each first call's seconds."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    calls = _order_calls(b, "cuda")
    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    outs, first_s = {}, {}
    for name, call in calls.items():
        t0 = time.perf_counter()
        outs[name] = call()
        first_s[name] = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(hash_cuda.launches)
    print(json.dumps({"order_launches": counts}))
    if any(counts.values()):
        raise AssertionError(f"the order path launched hash kernels: {counts}")
    outs, wire = _split_multi(outs)
    return counts, outs, wire, first_s


def _require_rows_equal_np(what, got, want):
    """Equal order-sink outputs: the same fields, dtypes, values and row
    order."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: fields {sorted(got)} != {sorted(want)}")
    for f, w in want.items():
        g, w = np.asarray(got[f]), np.asarray(w)
        if g.dtype != w.dtype or g.shape != w.shape or not np.array_equal(g, w):
            bad = (int(np.count_nonzero(g != w)) if g.shape == w.shape else "shape")
            raise AssertionError(f"{what} field {f}: {g.dtype}{g.shape} != {w.dtype}{w.shape}"
                                 f" ({bad} rows differ)")


def check_order(b, outs, wire):
    """Every full-size output against the vectorized numpy oracles, the
    multi-shard runs against the local ones, top-k against the naive plan
    with fewer wire bytes, and the governed reduce against the ungoverned
    run."""
    t0 = time.perf_counter()
    want = {"q67": q67_vector_oracle(b["q67"], ORDER_K),
            "q64": q64_vector_oracle(b["q64"], ORDER_K, ORDER_BAND0),
            "topk": topk_vector_oracle(b["q67"], ORDER_K)}
    oracle_s = time.perf_counter() - t0
    want["naive"] = want["topk"]
    for name, w in want.items():
        _require_rows_equal_np(f"{name} vs the numpy oracle", outs[name], w)
    for name in ("q67", "topk", "naive"):
        _require_rows_equal_np(f"{name} over {ORDER_SHARDS}x{ORDER_SHARDS} vs local",
                               outs[f"{name}_multi"], outs[name])
    _require_rows_equal_np("governed q67 reduce vs ungoverned", outs["q67_governed"], outs["q67"])
    row_bytes = 16  # price + sid, int64 each
    if not (wire["topk_multi"] <= ORDER_SHARDS * ORDER_K * row_bytes < wire["naive_multi"]):
        raise AssertionError(f"top-k wire bytes {wire['topk_multi']} not below the naive "
                             f"plan's {wire['naive_multi']}")
    return {"oracle_s": oracle_s, "rows": {n: int(o["rows"]) for n, o in outs.items()},
            "q67_categories": int(len(np.unique(outs["q67"]["category"]))),
            "q64_runs_kept": int(np.count_nonzero(outs["q64"]["rn"] == 1))}


def check_order_small():
    """Every order-tier call at ORDER_SMALL rows on the card against the same
    call on the CPU (``device="cpu"``), bit for bit and in row order."""
    t0 = time.perf_counter()
    small = order_batch(ORDER_SMALL, seed=ORDER_SEED + 10)
    cuda, _ = _split_multi({n: c() for n, c in _order_calls(small, "cuda").items()})
    cpu, _ = _split_multi({n: c() for n, c in _order_calls(small, "cpu").items()})
    for name in cuda:
        _require_rows_equal_np(f"{name} at {ORDER_SMALL} rows vs the CPU run", cuda[name],
                               cpu[name])
    return {"rows": ORDER_SMALL, "calls": len(cuda), "s": time.perf_counter() - t0}


FRAMED_SUM_ROWS = 1 << 21  # rows of the float framed_sum held bit for bit, card vs CPU


def check_framed_sum_bits(n=FRAMED_SUM_ROWS):
    """Float running sums (``plans.window.framed_sum``) over FRAMED_SUM_ROWS
    rows in runs of about 1,000 (seed 73: wide magnitudes, 1% -0.0), float32
    and float64, unbounded and 64-row frames: the card's bits equal the
    CPU's, since both add in the JAX package's (XLA:CPU's) order."""
    from spark_rapids_jni_tpu_torch.plans.window import framed_sum

    t0 = time.perf_counter()
    rng = np.random.RandomState(73)
    starts = rng.rand(n) < 1e-3
    starts[0] = True
    err, calls = 0.0, 0
    for dt, bits in ((np.float32, torch.int32), (np.float64, torch.int64)):
        v = (rng.randn(n) * 10.0 ** rng.randint(-3, 6, n)).astype(dt)
        v[rng.randint(0, n, n // 100)] = -0.0
        for preceding in (None, 64):
            cpu = framed_sum(torch.from_numpy(v), torch.from_numpy(starts), preceding)
            card = framed_sum(torch.from_numpy(v).cuda(), torch.from_numpy(starts).cuda(),
                              preceding)
            err = max(err, _require_equal(f"framed_sum {np.dtype(dt).name} preceding="
                                          f"{preceding}: card bits vs CPU bits",
                                          card.view(bits), cpu.view(bits)))
            calls += 1
    return {"rows": n, "calls": calls, "max_abs_err": err, "s": time.perf_counter() - t0}


def _resident_reduce(plan, tables):
    """The reduce executor of ``plan`` on its inputs already on the card
    (CUDA events, median of 5 after 1) with its peak memory, and the
    partition's rows and uploaded bytes."""
    from spark_rapids_jni_tpu_torch.plans import (
        compiled_plan_for,
        emit_range_partitions,
        pad_tables,
        plan_inputs,
        split_exchange_plan,
    )

    exchange, reduce_plan = split_exchange_plan(plan)
    (part,) = emit_range_partitions(exchange, tables, 1, (), device="cuda")
    rt = _reduce_tables(reduce_plan, part, tables)
    compiled = compiled_plan_for(reduce_plan, None, rt, "cuda")
    flat = plan_inputs(compiled, pad_tables(reduce_plan, rt, 1))
    resident = _timed(lambda: compiled.fn(*flat), 5, 1)
    return {"partition_rows": len(next(iter(part.values()))),
            "upload_bytes": sum(x.numel() * x.element_size() for x in flat),
            "reduce_executor_ms": resident["ms"],
            "reduce_peak_mem_bytes": resident["peak_mem_bytes"]}


def time_order(b, first_s):
    """Each local call host to host (median of ORDER_REPS) with its peak
    memory and the mean seconds per call of its steps over those calls
    (the map emit, rank and sort and download of emit_range_partitions,
    then the reduce's upload and launch in execute_plan); the reduce
    executor on resident inputs; the other calls' first seconds."""
    from spark_rapids_jni_tpu_torch.plans import compiler, runtime

    calls = _order_calls(b, "cuda")
    lines = {}
    for name, (plan, table) in _order_plans().items():
        compiler.RANGE_PHASES.reset()
        runtime.PHASES.reset()
        line = _host_to_host(calls[name], ORDER_REPS)
        steps = {**compiler.RANGE_PHASES.snapshot(), **runtime.PHASES.snapshot()}
        line["steps_s"] = {k: v / ORDER_REPS for k, v in steps.items()}
        lines[name] = {**line, **_resident_reduce(plan, b[table])}
    for name in ("q67_multi", "topk_multi", "naive_multi", "q67_governed"):
        lines[name] = {"first_call_s": first_s[name]}
    return lines


def order_optimizer(gp):
    """The q5 and q3 plans of the plans phase (its data), and q3's with its
    dim gathers swapped, locally on the card through run_governed_plan with
    the plan_optimizer flag off and on: the answers must be equal, and the
    swapped plan must be reordered.  Counts the EV_PLAN_REWRITE events."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.models.q3 import _dims, _facts, _geometry, _q3_tables, q3_plan
    from spark_rapids_jni_tpu_torch.models.q5 import _plan_and_tables
    from spark_rapids_jni_tpu_torch.obs import flight
    from spark_rapids_jni_tpu_torch.plans import run_governed_plan

    q3 = gp["q3"]
    q3p, q3t = q3_plan(**_geometry(q3)), _q3_tables(_facts(q3), _dims(q3))
    plans = {"q5": _plan_and_tables(gp["q5"]), "q3": (q3p, q3t),
             "q3_swapped": (_swap_gathers(q3p), q3t)}
    flight.recorder().reset_for_tests()
    out = {}
    for name, (plan, tables) in plans.items():
        runs = {}
        for flag in (False, True):
            with config.override(plan_optimizer=flag):
                t0 = time.perf_counter()
                runs[flag] = run_governed_plan(None, plan, tables, device="cuda")
                torch.cuda.synchronize()
                runs[f"{flag}_s"] = time.perf_counter() - t0
        _require_rows_equal_np(f"{name} with the optimizer vs without", runs[True], runs[False])
        out[name] = {"off_s": runs["False_s"], "on_s": runs["True_s"]}
    rewrites = [e["detail"] for e in flight.snapshot() if e["kind"] == flight.EV_PLAN_REWRITE]
    out["plan_rewrite_events"] = len(rewrites)
    out["rules"] = sorted({d.split(":rule:")[1].split(":")[0] for d in rewrites})
    if "join_reorder" not in out["rules"]:
        raise AssertionError(f"the optimizer did not reorder q3_swapped's joins: {rewrites}")
    return out


def _swap_gathers(plan):
    """q3's plan with its two dim gathers in the other order (date_dim
    first): the optimizer's join_reorder puts the smaller dim (item) back
    first, so with the flag on this plan runs rewritten."""
    agg = plan.sinks[0]
    proj, filt = agg.child, agg.child.child
    upper, lower = filt.child, filt.child.child
    swapped = dataclasses.replace(lower, child=dataclasses.replace(upper, child=lower.child))
    return dataclasses.replace(plan, name="q3_swapped", sinks=(dataclasses.replace(
        agg, child=dataclasses.replace(proj, child=dataclasses.replace(filt, child=swapped))),))


def order(gp):
    """The order phase: q67, q64 and the global top-k at SF10 through the
    range driver, the multi-shard and governed runs, the path with the
    counters at 0, the checks, the optimizer on the plans phase's q5 and q3,
    the times; prints the ``order`` line and returns the path's launch
    counts and q67's batch and answer (phase 22 shuffles the same batch)."""
    t0 = time.perf_counter()
    b = order_batch(ORDER_ROWS)
    gen_s = time.perf_counter() - t0
    counts, outs, wire, first_s = order_path(b)
    checks = check_order(b, outs, wire)
    q67 = {"tables": b["q67"], "want": outs["q67"]}
    del outs
    checks["cpu_check"] = check_order_small()
    checks["framed_sum_float_bits"] = check_framed_sum_bits()
    print(json.dumps({"order": {
        "rows": ORDER_ROWS, "items": ORDER_ITEMS, "customers": ORDER_CUSTS,
        "categories": ORDER_CATS, "brands": ORDER_BRANDS, "bands": ORDER_BANDS,
        "band0": ORDER_BAND0, "k": ORDER_K, "shards": ORDER_SHARDS,
        "input_bytes": {n: sum(v.nbytes for v in t["store_sales"].values()) for n, t in b.items()},
        "launches": counts, "wire_bytes": wire, "checks": checks,
        "calls": time_order(b, first_s), "optimizer": order_optimizer(gp),
        "batch_gen_s": gen_s}}))
    return counts, q67


# ---- the JSON family ----------------------------------------------------------

N_JSON = 1 << 22  # event rows: lengths 33-1011 B, mean 212.5 B, 0.89 GB of chars
JSON_SEED = 71
JSON_POOL = 1 << 14  # distinct documents the rows are drawn from (each row gets its own id)
JSON_NULL, JSON_BAD = 0.10, 0.02  # null rows; malformed (truncated) documents
JSON_HOST_ROWS = 1 << 14  # rows held device arm against host arm on the card
JSON_CPU_ROWS = 1 << 13  # rows held against the port's CPU run
JSON_ORACLE_ROWS = 1 << 12  # rows held against tests/json_oracle.py
JSON_PROFILE_ROWS = 1 << 14  # rows of the calls whose kernels the profiler counts
JSON_REPS, JSON_WARMUP = 1, 0  # the warm-up is each call's own run on the path
JSON_PATHS = ["$.store.fruit[*].weight", "$.store.book", "$.k0", "$.store.fruit[0]", "$.*",
              "$.user.name", "$.tags[1]", "$.no_such_field"]
JSON_SINGLE = "$.store.bicycle.price"

_JSON_WORDS = ["apple", "pear", "fig", "kiwi", "plum", "red", "blue", "Nigel Rees",
               "Evelyn Waugh", "sword", "honour", "café", "中国", "naïve", "event", "click"]
_JSON_ESCAPED = ['a\\"b', 'line\\nbreak', 'tab\\there', 'back\\\\slash', 'sl\\/ash',
                 '\\u00e9t\\u00e9', '\\u4e2d\\u6587', 'q\\u0041z', 'bell\\b\\f\\r']
_JSON_FLOATS = ["12.5", "-0.375", "1.25e-3", "6.02E+7", "-3.25E2", "0.1", "-0.0", "1e400",
                "99.99", "2.5e10", "7.0", "-1.5e-7", "0.0", "100.0"]
_JSON_INTS = ["0", "-0", "7", "-42", "123456", "1700000000123", "-9"]


def _json_str(rng):
    """A string token: plain, escaped or \\u-escaped text, single quotes at times."""
    r = rng.random()
    body = (rng.choice(_JSON_ESCAPED) if r < 0.25 else rng.choice(_JSON_WORDS)
            + ("" if rng.random() < 0.5 else f" {rng.randrange(1000)}"))
    if rng.random() < 0.15 and '\\"' not in body:
        return "'" + body.replace("'", "") + "'"
    return '"' + body + '"'


def _json_scalar(rng):
    r = rng.random()
    if r < 0.35:
        return _json_str(rng)
    if r < 0.6:
        return rng.choice(_JSON_FLOATS)
    if r < 0.85:
        return rng.choice(_JSON_INTS)
    return rng.choice(["true", "false", "null"])


def _json_value(rng, depth):
    """A nested value: objects and arrays of objects down to ``depth``."""
    if depth <= 0 or rng.random() < 0.35:
        return _json_scalar(rng)
    if rng.random() < 0.5:
        return "[" + ",".join(_json_value(rng, depth - 1)
                              for _ in range(rng.randrange(1, 4))) + "]"
    return "{" + ",".join(f'"m{i}":' + _json_value(rng, depth - 1)
                          for i in range(rng.randrange(1, 4))) + "}"


def _json_doc(rng, target):
    """One Spark-style event document of about ``target`` bytes, nesting
    depth 1-6 (store/fruit/book as in the JSONPath examples)."""
    depth = min(6, max(1, target.bit_length() - 5 + rng.randrange(-1, 2)))
    parts = [f'"k0":{_json_scalar(rng)}']
    if rng.random() < (0.8 if target > 100 else 0.3):
        parts.append('"user":{"name":' + _json_str(rng) + f',"age":{rng.randrange(90)}'
                     + f',"score":{rng.choice(_JSON_FLOATS)}}}')
    if depth >= 2 and rng.random() < 0.85:
        fruit = ",".join('{"weight":' + rng.choice(_JSON_FLOATS + _JSON_INTS)
                         + ',"type":' + _json_str(rng) + "}"
                         for _ in range(rng.randrange(0, 1 + target // 120)))
        store = [f'"fruit":[{fruit}]']
        if rng.random() < 0.7:
            store.append('"book":' + _json_value(rng, depth - 2)
                         if rng.random() < 0.5 else
                         '"book":[{"author":' + _json_str(rng) + ',"price":'
                         + rng.choice(_JSON_FLOATS) + ',"meta":' + _json_value(rng, depth - 2)
                         + "}]")
        if rng.random() < 0.5:
            store.append('"bicycle":{"color":' + _json_str(rng) + ',"price":'
                         + rng.choice(_JSON_FLOATS) + "}")
        parts.append('"store":{' + ",".join(store) + "}")
    if rng.random() < 0.6:
        parts.append('"tags":[' + ",".join(_json_str(rng) for _ in range(rng.randrange(0, 4)))
                     + "]")
    for i in range(1, rng.randrange(1, 2 + target // 200)):
        parts.append(f'"k{i}":' + _json_value(rng, depth - 1))
    rng.shuffle(parts)
    doc = "{" + ",".join(parts) + "}"
    if len(doc.encode()) < target:
        doc = doc[:-1] + ',"pad":"' + "x" * (target - len(doc.encode()) - 9) + '"}'
    if rng.random() < 0.05:  # a root array of events
        doc = "[" + doc + "," + doc + "]"
    return doc


def _cut(d: bytes, rng) -> bytes:
    """``d`` cut short at a character boundary (a malformed document)."""
    k = rng.randrange(min(32, len(d) - 1), len(d))
    while k > 1 and 0x80 <= d[k] < 0xC0:
        k -= 1
    return d[:k]


def json_pool(seed=JSON_SEED):
    """The documents (bytes, at most 1000 B each) and their malformed flags,
    drawn from a numpy seed; a malformed document is a valid one cut short."""
    nrng = np.random.default_rng(seed)
    rng = random.Random(int(nrng.integers(1 << 62)))
    targets = np.clip(nrng.lognormal(np.log(150.0), 0.6, JSON_POOL), 24, 980).astype(int)
    docs, bad = [], nrng.random(JSON_POOL) < JSON_BAD
    for i, t in enumerate(targets):
        d = _json_doc(rng, int(t)).encode()
        while len(d) > 1000 or len(d) > 2 * t + 64:
            d = _json_doc(rng, int(t)).encode()
        if bad[i]:
            d = _cut(d, rng)
        docs.append(d)
    return docs, bad


def json_batch(device, n=None, seed=JSON_SEED):
    """The JSON phase's event column: row r is pool document ``pick[r]`` with
    ``"id":r`` spliced in first when it is an object (laid out by plain torch
    on ``device``, 2**18 rows at a time), 10% null rows, and the column with
    the malformed rows nulled (from_json's input: it raises on any malformed
    non-null row)."""
    from spark_rapids_jni_tpu_torch import columnar as c

    n = N_JSON if n is None else n
    docs, bad_doc = json_pool(seed)
    nrng = np.random.default_rng(seed + 1)
    pick = nrng.integers(0, JSON_POOL, n)
    valid = nrng.random(n) >= JSON_NULL
    plen = np.array([len(d) for d in docs], np.int64)
    is_obj = np.array([d[:1] == b"{" for d in docs])
    pool = np.zeros((JSON_POOL, 1024), np.uint8)
    for i, d in enumerate(docs):
        pool[i, :len(d)] = np.frombuffer(d, np.uint8)
    ids = np.arange(n, dtype=np.int64)
    ndig = np.maximum(1, np.floor(np.log10(np.maximum(ids, 1))).astype(np.int64) + 1)
    obj = is_obj[pick]
    pre = np.where(obj, 7 + ndig, 0)  # '{"id":' + digits + ','
    lens = np.where(obj, pre + plen[pick] - 1, plen[pick])
    pool_t = torch.from_numpy(pool).to(device)
    width = 1040
    chunks = []
    lane = torch.arange(width, device=device)[None, :]
    head = torch.tensor(list(b'{"id":'), dtype=torch.uint8, device=device)
    for r0 in range(0, n, 1 << 18):
        r1 = min(n, r0 + (1 << 18))
        pk = torch.from_numpy(pick[r0:r1]).to(device)
        pr = torch.from_numpy(pre[r0:r1]).to(device)[:, None]
        nd = torch.from_numpy(ndig[r0:r1]).to(device)[:, None]
        rid = torch.arange(r0, r1, device=device)[:, None]
        # body: the document without its '{' after the prefix (or whole)
        skip = (pr > 0).to(torch.int64)
        src = torch.clamp(lane - pr + skip, 0, 1023)
        m = torch.gather(pool_t[pk], 1, src)
        m = torch.where(lane >= pr, m, 0)
        # prefix: '{"id":', the id's digits (most significant first), ','
        dpos = lane - 6
        p10 = torch.pow(10, torch.clamp(nd - 1 - dpos, 0, 18).to(torch.float64)).to(torch.int64)
        digit = (torch.div(rid, p10, rounding_mode="floor") % 10 + 48).to(torch.uint8)
        m = torch.where((lane < 6) & (pr > 0), head[torch.clamp(lane, max=5)], m)
        m = torch.where((dpos >= 0) & (dpos < nd) & (pr > 0), digit, m)
        m = torch.where((lane == pr - 1) & (pr > 0), ord(","), m)
        chunks.append(c.strings_from_padded(m.to(torch.uint8),
                                            torch.from_numpy(lens[r0:r1]).to(device)))
    offs = [torch.zeros(1, dtype=torch.int64, device=device)]
    base = 0
    for ch in chunks:
        offs.append(ch.offsets[1:].to(torch.int64) + base)
        base += int(ch.offsets[-1])
    chars = torch.cat([ch.chars for ch in chunks])
    offsets = torch.cat(offs).to(torch.int32)
    bad_row = bad_doc[pick]
    valid_t = torch.from_numpy(valid).to(device)
    col = c.StringColumn(chars, offsets, valid_t)
    fj_col = c.StringColumn(chars, offsets, torch.from_numpy(valid & ~bad_row).to(device))
    return {"col": col, "fj_col": fj_col, "lens": lens, "valid": valid, "bad": bad_row}


def _json_calls(b):
    """The phase's three calls: 8 paths over one tokenization, one single
    path, and from_json over the column with its malformed rows nulled."""
    from spark_rapids_jni_tpu_torch.ops import (
        from_json,
        get_json_object,
        get_json_object_multiple_paths,
    )

    return {"multi_paths": lambda col=b["col"]: get_json_object_multiple_paths(col, JSON_PATHS),
            "single_path": lambda col=b["col"]: [get_json_object(col, JSON_SINGLE)],
            "from_json": lambda col=b["fj_col"]: [from_json(col)]}


def json_path(b):
    """Every JSON call once on the card (the device arm under "auto") with
    the counters at 0: plain torch, no hash kernel may launch.  Returns the
    counts, the outputs and get_json_object's phase times of each call."""
    import importlib

    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    gjo = importlib.import_module("spark_rapids_jni_tpu_torch.ops.get_json_object")
    calls = _json_calls(b)
    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    outs, phases = {}, {}
    for name, call in calls.items():
        gjo.reset_phase_times()
        outs[name] = call()
        torch.cuda.synchronize()
        if name != "from_json":  # get_json_object's phase timers
            phases[name] = gjo.phase_times()
    counts = dict(hash_cuda.launches)
    print(json.dumps({"json_launches": counts}))
    if any(counts.values()):
        raise AssertionError(f"the JSON path launched hash kernels: {counts}")
    return counts, outs, phases


def _cpu_copy(col):
    """A column of any kind (lists and structs recursively, or a list of
    columns) copied to the CPU."""
    import dataclasses as dc

    from spark_rapids_jni_tpu_torch import columnar as c

    if isinstance(col, list):
        return [_cpu_copy(x) for x in col]
    valid = None if col.validity is None else col.validity.cpu()
    if isinstance(col, c.ListColumn):
        return c.ListColumn(col.offsets.cpu(), _cpu_copy(col.child), valid)
    if isinstance(col, c.StructColumn):
        return c.StructColumn(tuple(_cpu_copy(k) for k in col.children), valid)
    if isinstance(col, c.StringColumn):
        return c.StringColumn(col.chars.cpu(), col.offsets.cpu(), valid)
    return dc.replace(col, data=col.data.cpu(), validity=valid)


def _head_any(col, n):
    """The first ``n`` rows of a column of any kind (a list keeps its rows'
    child rows; a struct, each child's first ``n``), or of each column of a
    list."""
    from spark_rapids_jni_tpu_torch import columnar as c

    if isinstance(col, list):
        return [_head_any(x, n) for x in col]
    if isinstance(col, c.ListColumn):
        offs = col.offsets[:n + 1]
        return c.ListColumn(offs, _head_any(col.child, int(offs[-1])),
                            None if col.validity is None else col.validity[:n])
    if isinstance(col, c.StructColumn):
        return c.StructColumn(tuple(_head_any(k, n) for k in col.children),
                              None if col.validity is None else col.validity[:n])
    return _head(col, n)


def _same_column(what, got, want):
    """Bit-exact equality of two columns of any kind: values, offsets, chars
    and validity (a null mask of all True equals no mask)."""
    from spark_rapids_jni_tpu_torch import columnar as c

    if isinstance(want, c.StringColumn):
        pairs = [("offsets", got.offsets, want.offsets), ("chars", got.chars, want.chars)]
    elif isinstance(want, c.ListColumn):
        pairs = [("offsets", got.offsets, want.offsets)]
        _same_column(f"{what} child", got.child, want.child)
    elif isinstance(want, c.StructColumn):
        pairs = []
        for i, (g, w) in enumerate(zip(got.children, want.children)):
            _same_column(f"{what} child {i}", g, w)
    else:
        pairs = [("data", got.data, want.data)]
    pairs.append(("validity", got.is_valid(), want.is_valid()))
    for part, g, w in pairs:
        if g.shape != w.shape or not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{what}: {part} differ")


def _tests_module(name):
    """tests/<name>.py, loaded by path (an oracle that imports neither
    package)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parent / "tests" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _expected_bad_row(b) -> int:
    """The row from_json names for the whole column: the first malformed
    non-null row of the narrowest length class that holds one."""
    lens = np.maximum(b["lens"], 1)
    width = np.maximum(32, 1 << np.ceil(np.log2(lens)).astype(np.int64))
    bad = b["valid"] & b["bad"]
    w0 = width[bad].min()
    return int(np.nonzero(bad & (width == w0))[0][0])


def check_json(b, outs):
    """The device arm against the host arm on the card, the port's CPU run
    and the sequential oracle, and from_json's raise on the whole column."""
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.ops import JsonParsingException, from_json, parse_path

    checks = {}
    t0 = time.perf_counter()
    host_b = {"col": _head(b["col"], JSON_HOST_ROWS), "fj_col": _head(b["fj_col"], JSON_HOST_ROWS)}
    with config.override(json_device_render=False):
        for name, call in _json_calls(host_b).items():
            if name == "from_json":
                continue  # one arm: held against the CPU run below
            for i, (g, w) in enumerate(zip(outs[name], call())):
                _same_column(f"{name}[{i}] device vs host arm", _head_any(g, JSON_HOST_ROWS), w)
    checks["host_arm_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cpu_b = {k: _cpu_copy(_head(b[k], JSON_CPU_ROWS)) for k in ("col", "fj_col")}
    for name, call in _json_calls(cpu_b).items():
        for i, (g, w) in enumerate(zip(outs[name], call())):
            _same_column(f"{name}[{i}] card vs CPU run", _head_any(g, JSON_CPU_ROWS), w)
    checks["cpu_run_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rows = _head(b["col"], JSON_ORACLE_ROWS).to_list()
    got = [_head(o, JSON_ORACLE_ROWS).to_list()
           for o in outs["multi_paths"] + outs["single_path"]]
    jo = _tests_module("json_oracle")
    nonnull = 0
    for path, col_rows in zip(JSON_PATHS + [JSON_SINGLE], got):
        parsed = parse_path(path)
        want = [jo.get_json_object(r, parsed) for r in rows]
        bad = [i for i in range(JSON_ORACLE_ROWS) if col_rows[i] != want[i]]
        if bad:
            raise AssertionError(f"{path}: {len(bad)} rows differ from the oracle, first "
                                 f"{bad[0]}: {col_rows[bad[0]]!r} != {want[bad[0]]!r}")
        nonnull += sum(w is not None for w in want)
    checks["oracle_s"] = time.perf_counter() - t0
    checks["oracle_nonnull_results"] = nonnull
    checks["non_null_results"] = {
        p: int(o.is_valid().sum()) for p, o in zip(JSON_PATHS, outs["multi_paths"])}

    want_row = _expected_bad_row(b)
    try:
        from_json(b["col"])
    except JsonParsingException as e:
        if e.row != want_row:
            raise AssertionError(f"from_json raised at row {e.row}, expected {want_row}")
    else:
        raise AssertionError("from_json did not raise on the malformed rows")
    checks["from_json_bad_row"] = want_row
    checks["rows"] = {"host_arm": JSON_HOST_ROWS, "cpu_run": JSON_CPU_ROWS,
                      "oracle": JSON_ORACLE_ROWS}
    return checks


def _counted_kernels(fn) -> int:
    """The CUDA kernels (and device copies) that ``fn`` runs, counted from the
    profiler's raw device records (a JSON call runs hundreds of thousands:
    building ``key_averages`` over them takes minutes)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == cuda)


def time_json(b, outs, phases, rates):
    """Each call's time (CUDA events, median of JSON_REPS; the path's own
    call was the warm-up) and peak memory, its phase times from the path's
    call, the kernels the profiler sees in the call on the first
    JSON_PROFILE_ROWS rows, and its bytes bound: the chars read once, the
    outputs written once."""
    prof_b = {k: _head(b[k], JSON_PROFILE_ROWS) for k in ("col", "fj_col")}
    lines = {}
    for name, call in _json_calls(b).items():
        line = _timed(call, JSON_REPS, JSON_WARMUP)
        src = b["fj_col"] if name == "from_json" else b["col"]
        out_bytes = sum(_table_bytes([o]) if hasattr(o, "chars") else
                        _table_bytes(list(o.child.children)) + 4 * o.offsets.numel()
                        + (0 if o.validity is None else o.validity.numel())
                        for o in outs[name])
        nbytes = _table_bytes([src]) + out_bytes
        line.update({"bytes": nbytes, **_bound(nbytes, 0, rates),
                     "profiled_kernels": _counted_kernels(_json_calls(prof_b)[name]),
                     "profiled_rows": JSON_PROFILE_ROWS})
        if name in phases:
            line["phases_s"] = phases[name]
        lines[name] = line
    return lines


def json_phase(rates, device="cuda"):
    """The JSON phase: the path with the counters at 0, the checks, the
    times; prints the ``json`` line and returns the path's launch counts and
    a copy of the column's first JSON_PROFILE_ROWS rows (phase 20's input)."""
    from spark_rapids_jni_tpu_torch import columnar as c

    t0 = time.perf_counter()
    b = json_batch(device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts, outs, phases = json_path(b)
    checks = check_json(b, outs)
    print(json.dumps({"json": {
        "n": N_JSON, "chars_bytes": int(b["col"].offsets[-1]),
        "mean_len": float(b["lens"].mean()), "null_share": float(1 - b["valid"].mean()),
        "malformed_share": float(b["bad"].mean()), "paths": JSON_PATHS, "single": JSON_SINGLE,
        "launches": counts, "calls": time_json(b, outs, phases, rates), "checks": checks,
        "batch_gen_s": gen_s}}))
    head = _head(b["col"], JSON_PROFILE_ROWS)  # phase 20's JSON input, copied out
    return counts, c.StringColumn(head.chars.clone(), head.offsets.clone(),
                                  head.validity.clone())


# ---- BASELINE config 5: NDS q5 + q97 streamed out of core --------------------

# the harness's own command line (seed 42 by default): q97's 56,000,000 fact
# rows generated in chunks of 1,000,000, grace-hashed to disk in 32 buckets
C5_ARGS = ["--sf", "10", "--verify", "--stream-chunk-rows", "1000000", "--buckets", "32"]
C5_BUCKETS = 32
C5_ROWS_IN = 56_000_000
C5_Q97_COUNTS = [27967534, 27967430, 21658]  # store_only, catalog_only, both (SCALING_r05.jsonl)
C5_Q5_ROWS = 40


def _streamed_timing(streaming, spill, run, per_query, query):
    """``run`` (a streamed runner) with its host phases (host clock), the CUDA
    events around its buckets' device runs and its device peak recorded in
    ``per_query[query]``."""
    def timed(*args, **kw):
        streaming.reset_timers()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = run(*args, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = {**streaming.PHASES.snapshot(), **spill.PHASES.snapshot()}
        host = sum(phases[k] for k in ("generate", "hash", "route_encode", "write",
                                       "read_decode"))
        device = streaming.device_seconds()
        per_query[query] = {"wall_s": wall, "phases_s": phases, "host_s": host,
                            "host_share": host / wall, "device_s": device,
                            "device_share": device / wall,
                            "peak_mem_bytes": torch.cuda.max_memory_allocated()}
        return out
    return timed


def config5_path():
    """The harness's ``main`` in this process with C5_ARGS on the card, with
    the counters at 0 (only q97's buckets may launch a kernel: mm_hash_long,
    once per bucket, its Exchange's placement); returns the counts, the JSON
    line it printed, per-query timings, the first q97 bucket's host arrays,
    the bucket runs and the spill directories."""
    import contextlib
    import io as _io
    import os
    from unittest import mock

    from spark_rapids_jni_tpu_torch.io import spill
    from spark_rapids_jni_tpu_torch.models import nds_harness, q97 as q97_mod, streaming
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    per_query, buckets, dirs = {}, [], []
    run_q97 = q97_mod.run_distributed_q97
    close = spill.ExternalTableShuffle.close

    def bucket_run(mesh, store, catalog, **kw):
        buckets.append((store, catalog) if not buckets else len(store[0]) + len(catalog[0]))
        return run_q97(mesh, store, catalog, **kw)

    def closed(self):
        close(self)
        dirs.append((self.dir, os.listdir(self.dir)))

    printed = _io.StringIO()
    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(q97_mod, "run_distributed_q97", bucket_run), \
            mock.patch.object(spill.ExternalTableShuffle, "close", closed), \
            mock.patch.object(streaming, "run_streaming_q97", _streamed_timing(
                streaming, spill, streaming.run_streaming_q97, per_query, "q97")), \
            mock.patch.object(streaming, "run_streaming_q5", _streamed_timing(
                streaming, spill, streaming.run_streaming_q5, per_query, "q5")), \
            contextlib.redirect_stdout(printed):
        rc = nds_harness.main(C5_ARGS)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = dict(hash_cuda.launches)
    print(json.dumps({"config5_launches": counts}))
    if rc != 0:
        raise AssertionError(f"nds_harness {' '.join(C5_ARGS)} exited {rc}")
    line = json.loads(printed.getvalue().strip().splitlines()[-1])
    return counts, line, seconds, per_query, buckets, dirs


def check_config5(counts, line, buckets, dirs):
    """q97's counts and rows equal the JAX package's SF10 answers, q5's 40
    rows, every query verified by its oracle, every bucket run on the card
    (mm_hash_long once each, no other kernel), and every spill file and
    directory gone."""
    import os

    qs = line["queries"]
    q97, q5 = qs["q97"], qs["q5"]
    if q97["counts"] != C5_Q97_COUNTS:
        raise AssertionError(f"config 5 q97 counts {q97['counts']} != {C5_Q97_COUNTS}")
    if not q97["fact_rows"] == q97["streamed"]["rows_in"] == C5_ROWS_IN:
        raise AssertionError(f"config 5 q97 read {q97['fact_rows']} rows, not {C5_ROWS_IN}")
    if q5["result_rows"] != C5_Q5_ROWS:
        raise AssertionError(f"config 5 q5 gave {q5['result_rows']} rows, not {C5_Q5_ROWS}")
    bad = [q for q, v in qs.items() if v["verified"] is not True]
    if bad:
        raise AssertionError(f"config 5: {bad} not verified against their oracles")
    runs = len(buckets)
    want = {k: (runs if k == "mm_hash_long" else 0) for k in counts}
    if counts != want or runs != C5_BUCKETS + q97["streamed"]["bucket_splits"]:
        raise AssertionError(f"config 5 launched {counts} over {runs} q97 bucket runs")
    left = [(d, names) for d, names in dirs if names or os.path.exists(d)]
    if left:
        raise AssertionError(f"config 5 left spill files behind: {left}")
    return {"q97_bucket_runs": runs, "shuffles_closed": len(dirs), "spill_files_left": 0}


def config5_kernel_check(store, catalog):
    """mm_hash_long against its plain version at a bucket's shape: the packed
    keys of the first q97 bucket's padded store and catalog scans."""
    from spark_rapids_jni_tpu_torch.models.q97 import _composite_key
    from spark_rapids_jni_tpu_torch.ops import hash_cuda
    from spark_rapids_jni_tpu_torch.parallel import quantized_rows

    keys = []
    for cust, item in (store, catalog):
        m = quantized_rows(len(cust), 1)
        padded = [np.concatenate([a, np.zeros(m - len(a), a.dtype)]) for a in (cust, item)]
        keys.append(_composite_key(*(torch.from_numpy(a).cuda() for a in padded)))
    keys = torch.cat(keys)
    return {"n": keys.numel(), "max_abs_err": _require_equal(
        "mm_hash_long on a config 5 q97 bucket's keys", hash_cuda.mm_hash_long_cuda(keys, 42),
        hash_cuda.mm_hash_long_torch(keys, 42))}


def config5():
    """Phase 18: BASELINE config 5 through the port's harness, streamed out
    of core at SF10; the checks, the kernel check, and a ``config5`` line
    (each query's wall time and rate, its host and device shares, largest
    bucket, host and device peaks; mm_hash_long's launches).  Returns the
    path's launch counts."""
    import shutil
    import tempfile

    counts, line, seconds, per_query, buckets, dirs = config5_path()
    checks = check_config5(counts, line, buckets, dirs)
    checks["kernel_check"] = config5_kernel_check(*buckets[0])
    qs = line["queries"]
    print(json.dumps({"config5": {
        "args": C5_ARGS, "seconds": seconds, "launches": counts,
        "queries": {q: {"wall_s": qs[q]["wall_s"], "Mrows_per_s": qs[q]["Mrows_per_s"],
                        "fact_rows": qs[q]["fact_rows"], "verified": qs[q]["verified"],
                        "peak_reserved_bytes": qs[q]["peak_reserved_bytes"],
                        **({"streamed": qs[q]["streamed"], **per_query[q]}
                           if q in per_query else {})}
                    for q in qs},
        "q97_counts": qs["q97"]["counts"], "q5_result_rows": qs["q5"]["result_rows"],
        "tmp_free_bytes": shutil.disk_usage(tempfile.gettempdir()).free,
        "checks": checks}}))
    return counts


# ---- phase 19: the last Spark ops at a plugin batch --------------------------

TAIL_SEED = 73
N_URL = 1 << 22  # web-log URLs: 16-2,048 B, mostly under 300
N_TS = 1 << 26  # TIMESTAMP_MICROS values of the zone conversions (1900-2100)
N_REBASE = 1 << 26  # TIMESTAMP_MICROS and DATE32 values of the rebase (years 1-2100)
N_ZORDER = 1 << 24  # rows of the three INT32 z-order columns
N_HIST_ROWS = 1 << 24  # (FLOAT64 value, INT64 count) rows of the histograms
N_HIST = 1 << 20  # histograms over them, 1-256 bins (geometric lengths)
TAIL_CPU_ROWS = 1 << 18  # rows (histograms) of each call held against the CPU run
# the CPU run's processes and the threads of each, beside the card's work
# (parse_uri's small ops scale with processes, not with threads)
TAIL_CPU_PROCS, TAIL_CPU_THREADS = 3, 2
URL_ORACLE_ROWS = 1 << 14  # URLs held against tests/uri_oracle.py
TAIL_PCTS = [0.0, 0.25, 0.5, 0.75, 1.0]
TAIL_REPS, TAIL_WARMUP = 2, 0  # each call timed after the path's own call
TAIL_ZONES = ["Asia/Shanghai", "Asia/Kolkata"]
URL_KEY = "id"  # parse_uri_query_literal's key
URL_KEYS = ["id", "q", "utm_source", "page", "", "zz"]  # the key column's keys
URL_RANGE = ("id=", 3, 48, 57)  # literal_range_pattern: "id=" and three digits
URL_NULL, URL_BAD = 0.05, 0.05
_URL_WORDS = ["shop", "news", "mail", "api", "cdn", "static", "img", "data", "blog", "search",
              "nvidia", "spark", "rapids", "docs", "login", "cart", "video", "maps", "item",
              "product", "category", "view", "index.html", "a.php", "v2", "2024"]
_URL_UTF8 = ["é", "ü", "中文", "日本語", "русский", "€", "ñ", "ß"]
_URL_TLDS = ["com", "org", "net", "io", "co.uk", "de", "cn", "in", "com.br"]
_URL_BAD = [" ", "|", "^", "%zz", "%4", "[", "\\", "`", "{", "\"", "<", "%"]


def _url_segment(rng):
    r = rng.random()
    if r < 0.55:
        return rng.choice(_URL_WORDS)
    if r < 0.75:
        return str(rng.randrange(10 ** rng.randint(1, 8)))
    if r < 0.9:
        return rng.choice(_URL_WORDS) + "%" + format(rng.randrange(256), "02X") + \
            rng.choice(_URL_WORDS)
    return rng.choice(_URL_UTF8) + rng.choice(_URL_WORDS)


def _url_prefix(rng):
    scheme = "https" if rng.random() < 0.6 else "http"
    ui = (rng.choice(["user", "admin", "u:p", "john.doe", "a%20b", "me:s3cr%21t"]) + "@"
          if rng.random() < 0.1 else "")
    r = rng.random()
    if r < 0.1:
        host = ".".join(str(rng.randrange(1, 255)) for _ in range(4))
    elif r < 0.15:
        groups = [format(rng.randrange(65536), "x") for _ in range(8)]
        host = "[" + (":".join(groups) if rng.random() < 0.5
                      else ":".join(groups[:3]) + "::" + groups[7]) + "]"
    else:
        labels = [rng.choice(["www", "m", "api", "cdn", "shop"])] if rng.random() < 0.7 else []
        labels += [rng.choice(_URL_WORDS[:18]) + (str(rng.randrange(100))
                                                  if rng.random() < 0.3 else "")]
        host = ".".join(labels) + "." + rng.choice(_URL_TLDS)
    port = f":{rng.choice([80, 443, 8080, 8443, 3000])}" if rng.random() < 0.15 else ""
    return f"{scheme}://{ui}{host}{port}"


def _url_path(rng):
    if rng.random() < 0.01:  # the long tail: 1,000-1,850 B
        target, segs = rng.randint(1000, 1850), []
        while sum(len(s.encode()) + 1 for s in segs) < target:
            segs.append(_url_segment(rng))
        return "/" + "/".join(segs)
    n = min(int(rng.expovariate(1 / 4)) + 1, 14)
    return "/" + "/".join(_url_segment(rng) for _ in range(n)) + \
        ("/" if rng.random() < 0.1 else "")


def _url_query(rng):
    if rng.random() < 0.45:
        return ""
    keys = ["id", "q", "utm_source", "page", "ref", "lang", "sort", "s", "utm_medium"]
    params = []
    for _ in range(rng.randint(1, 8)):
        k = rng.choice(keys)
        v = (str(rng.randrange(10 ** rng.randint(1, 6))) if rng.random() < 0.5
             else _url_segment(rng))
        params.append(f"{k}={v}")
    return "?" + "&".join(params)


def url_pools(seed=TAIL_SEED):
    """Byte-string pools the URL rows are drawn from (a numpy seed drives a
    python RNG): scheme, userinfo, host (domains, IPv4, IPv6) and port
    prefixes; paths (%XX escapes, UTF-8, 1% of 1,000-1,850 B); queries;
    fragments; and malformed URLs (a valid one with a bad byte spliced in)."""
    rng = random.Random(int(np.random.default_rng(seed).integers(1 << 62)))
    prefixes = [_url_prefix(rng).encode() for _ in range(4096)]
    paths = [_url_path(rng).encode() for _ in range(16384)]
    queries = [_url_query(rng).encode() for _ in range(8192)]
    frags = [(("#" + rng.choice(_URL_WORDS)) if rng.random() < 0.15 else "").encode()
             for _ in range(256)]
    bad = []
    for _ in range(1024):
        u = _url_prefix(rng) + _url_path(rng) + _url_query(rng)
        i = rng.randrange(8, len(u))
        bad.append((u[:i] + rng.choice(_URL_BAD) + u[i:]).encode())
    return {"prefix": prefixes, "path": paths, "query": queries, "frag": frags, "bad": bad}


def _pool_tensors(items, device):
    lens = np.array([len(b) for b in items], np.int64)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    chars = np.frombuffer(b"".join(items), np.uint8).copy()
    return (torch.from_numpy(chars).to(device), torch.from_numpy(offs).to(device),
            torch.from_numpy(lens).to(device))


def _concat_pools(parts, n, device):
    """(chars uint8, offsets int32) of ``n`` rows, row r the concatenation
    over ``parts`` of pool item ``pick[r]`` (none where ``pick`` is -1);
    ``parts`` are ``(pool chars, item starts, item lengths, pick)``."""
    lens = torch.zeros(n, dtype=torch.int64, device=device)
    plens = []
    for _, _, ilen, pick in parts:
        ln = torch.where(pick >= 0, ilen[pick.clamp(min=0)], 0)
        plens.append(ln)
        lens += ln
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(lens, 0)
    out = torch.empty(int(offsets[-1]), dtype=torch.uint8, device=device)
    cursor = offsets[:-1].clone()
    rows = torch.arange(n, device=device)
    for (chars, starts, _, pick), ln in zip(parts, plens):
        total = int(ln.sum())
        if total:
            row = torch.repeat_interleave(rows, ln)
            within = torch.arange(total, device=device) - (torch.cumsum(ln, 0) - ln)[row]
            out[cursor[row] + within] = chars[starts[pick.clamp(min=0)][row] + within]
        cursor += ln
    return out, offsets.to(torch.int32)


def url_batch(device, n=None, seed=TAIL_SEED):
    """The URL column (pools joined on ``device``), 5% malformed and 5% null
    rows, and the per-row key column (5% null)."""
    from spark_rapids_jni_tpu_torch import columnar as c

    n = N_URL if n is None else n
    pools = {k: _pool_tensors(v, device) for k, v in url_pools(seed).items()}
    nrng = np.random.default_rng(seed + 1)
    bad = nrng.random(n) < URL_BAD
    picks = {k: np.where(bad, -1, nrng.integers(0, pools[k][2].numel(), n))
             for k in ("prefix", "path", "query", "frag")}
    picks["bad"] = np.where(bad, nrng.integers(0, pools["bad"][2].numel(), n), -1)
    valid = nrng.random(n) >= URL_NULL
    parts = [(*pools[k], torch.from_numpy(picks[k]).to(device))
             for k in ("bad", "prefix", "path", "query", "frag")]
    chars, offsets = _concat_pools(parts, n, device)
    col = c.StringColumn(chars, offsets, torch.from_numpy(valid).to(device))
    keys = c.strings_from_arrays(*_key_arrays(nrng, n), device=device)
    lens = (offsets[1:] - offsets[:-1]).cpu().numpy()
    return {"col": col, "keys": keys, "lens": lens, "bad": bad, "valid": valid}


def _key_arrays(nrng, n):
    raw = [k.encode() for k in URL_KEYS]
    pick = nrng.integers(0, len(raw), n)
    klen = np.array([len(r) for r in raw], np.int32)[pick]
    offsets = np.concatenate([[0], np.cumsum(klen)]).astype(np.int32)
    pool = np.frombuffer(b"".join(raw), np.uint8)
    starts = np.concatenate([[0], np.cumsum([len(r) for r in raw])[:-1]])[pick]
    idx = np.repeat(starts - offsets[:-1], klen) + np.arange(int(offsets[-1]))
    return pool[idx], offsets, nrng.random(n) >= URL_NULL


def _tz_source():
    """Where the zones' TZif files are read: the machine's (zoneinfo.TZPATH,
    then the tzdata wheel) or, when it has neither, tests/data/tzif/ (put
    first on TZPATH)."""
    import pathlib
    import zoneinfo

    from spark_rapids_jni_tpu_torch.utils import tzif

    found = {z: tzif._find_tzfile(z) for z in TAIL_ZONES}
    if all(found.values()):
        return found
    committed = pathlib.Path(__file__).resolve().parent / "tests" / "data" / "tzif"
    zoneinfo.reset_tzpath(to=[str(committed)])
    found = {z: tzif._find_tzfile(z) for z in TAIL_ZONES}
    if not all(found.values()):
        raise AssertionError(f"no TZif data for {TAIL_ZONES}: {found}")
    return found


def tail_batch(device, sizes=None):
    """Phase 19's inputs on ``device`` from seed 73: the URL column and its
    keys, TIMESTAMP_MICROS over 1900-2100, TIMESTAMP_MICROS and DATE32 over
    years 1-2100, three INT32 columns with 10% nulls, and (FLOAT64 value,
    INT64 count) rows with their histogram lengths."""
    from spark_rapids_jni_tpu_torch import columnar as c

    s = {"url": N_URL, "ts": N_TS, "rebase": N_REBASE, "zorder": N_ZORDER,
         "hist_rows": N_HIST_ROWS, "hist": N_HIST, **(sizes or {})}
    b = url_batch(device, s["url"])
    rng = np.random.default_rng(TAIL_SEED + 2)
    day_us = 86_400_000_000
    d1900, d2100, d1 = -25567 * day_us, 47482 * day_us, -719162
    b["ts"] = c.Column(torch.from_numpy(rng.integers(d1900, d2100, s["ts"])).to(device), None,
                       c.TIMESTAMP_MICROS)
    b["micros"] = c.Column(torch.from_numpy(rng.integers(d1 * day_us, d2100, s["rebase"]))
                           .to(device), None, c.TIMESTAMP_MICROS)
    b["days"] = c.Column(torch.from_numpy(rng.integers(d1, 47482, s["rebase"]).astype(np.int32))
                         .to(device), None, c.DATE32)
    b["z"] = [c.Column(torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, s["zorder"])
                                        .astype(np.int32)).to(device),
                       torch.from_numpy(rng.random(s["zorder"]) >= 0.1).to(device), c.INT32)
              for _ in range(3)]
    vals = np.round(rng.lognormal(3.0, 1.0, s["hist_rows"]), 1)  # duplicates within a list
    b["hvals"] = c.Column(torch.from_numpy(vals.view(np.int64)).to(device),
                          torch.from_numpy(rng.random(s["hist_rows"]) >= 0.05).to(device),
                          c.FLOAT64)
    b["hcounts"] = c.Column(torch.from_numpy(rng.integers(0, 20, s["hist_rows"])).to(device),
                            None, c.INT64)
    lens = np.clip(rng.geometric(s["hist"] / s["hist_rows"], s["hist"]), 1, 256)
    diff = s["hist_rows"] - int(lens.sum())  # move the total to exactly hist_rows
    room = np.nonzero(lens < 256 if diff > 0 else lens > 1)[0]
    lens[rng.choice(room, abs(diff), replace=False)] += np.sign(diff)
    b["hoffsets"] = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
                                     ).to(device)
    b["hlens"] = lens
    return b


def _histograms(b, hist):
    from spark_rapids_jni_tpu_torch import columnar as c

    return c.ListColumn(b["hoffsets"], hist, None)


def _tail_calls(b):
    """name -> call of phase 19 over batch ``b``."""
    from spark_rapids_jni_tpu_torch import ops

    col, keys = b["col"], b["keys"]
    calls = {"parse_uri_protocol": lambda: ops.parse_uri_protocol(col),
             "parse_uri_host": lambda: ops.parse_uri_host(col),
             "parse_uri_query": lambda: ops.parse_uri_query(col),
             "parse_uri_query_literal": lambda: ops.parse_uri_query_literal(col, URL_KEY),
             "parse_uri_query_column": lambda: ops.parse_uri_query_column(col, keys),
             "parse_uri_path": lambda: ops.parse_uri_path(col),
             "literal_range_pattern": lambda: ops.literal_range_pattern(col, *URL_RANGE)}
    for z in TAIL_ZONES:
        calls[f"to_utc:{z}"] = lambda z=z: ops.convert_timestamp_to_utc(b["ts"], z)
        calls[f"from_utc:{z}"] = lambda z=z: ops.convert_utc_timestamp_to_timezone(b["ts"], z)
    for kind in ("micros", "days"):
        calls[f"gregorian_to_julian:{kind}"] = \
            lambda k=kind: ops.rebase_gregorian_to_julian(b[k])
        calls[f"julian_to_gregorian:{kind}"] = \
            lambda k=kind: ops.rebase_julian_to_gregorian(b[k])
    calls["interleave_bits"] = lambda: ops.interleave_bits(b["z"])
    calls["hilbert_index"] = lambda: ops.hilbert_index(10, b["z"])
    calls["create_histogram_if_valid"] = \
        lambda: ops.create_histogram_if_valid(b["hvals"], b["hcounts"], False)
    hist = ops.create_histogram_if_valid(b["hvals"], b["hcounts"], False)
    calls["percentile_list"] = \
        lambda: ops.percentile_from_histogram(_histograms(b, hist), TAIL_PCTS, True)
    calls["percentile_scalar"] = \
        lambda: ops.percentile_from_histogram(_histograms(b, hist), TAIL_PCTS, False)
    return calls


def tail_path(b):
    """Every call of phase 19 once with the counters at 0; no kernel may
    launch.  Returns the counts and the outputs."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    calls = _tail_calls(b)
    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    outs = {name: call() for name, call in calls.items()}
    torch.cuda.synchronize()
    counts = dict(hash_cuda.launches)
    print(json.dumps({"ops_tail_launches": counts}))
    if any(counts.values()):
        raise AssertionError(f"phase 19 launched {counts}: its path has no kernel")
    return counts, outs


def _tail_cpu_worker(in_path, out_path, threads, names):
    """Phase 19's calls ``names`` on the CPU over the heads saved at
    ``in_path``; the outputs saved at ``out_path`` (run in a process of its
    own)."""
    torch.set_num_threads(threads)
    calls = _tail_calls(torch.load(in_path, weights_only=False))
    torch.save({name: calls[name]() for name in names}, out_path)


def start_tail_cpu(b, tmp):
    """The first TAIL_CPU_ROWS rows of every input (histograms for the
    percentiles) copied to the CPU and run through the port in
    TAIL_CPU_PROCS spawned processes (the calls dealt out in turn, the
    costliest first) while the card runs the path and is timed; returns
    what :func:`finish_tail_cpu` takes."""
    import multiprocessing
    import os

    n = TAIL_CPU_ROWS
    m = int(b["hoffsets"][n])  # the first n histograms' rows
    hb = {"col": _cpu_copy(_head(b["col"], n)), "keys": _cpu_copy(_head(b["keys"], n)),
          "z": [_cpu_copy(_head(z, n)) for z in b["z"]],
          "hvals": _cpu_copy(_head(b["hvals"], m)), "hcounts": _cpu_copy(_head(b["hcounts"], m)),
          "hoffsets": b["hoffsets"][:n + 1].cpu()}
    for k in ("ts", "micros", "days"):
        hb[k] = _cpu_copy(_head(b[k], n))
    in_path = os.path.join(tmp, "tail_in.pt")
    torch.save(hb, in_path)
    names = sorted(_tail_calls(hb), key=lambda k: (not k.startswith("parse_uri"),
                                                   not k.startswith("percentile"), k))
    ctx = multiprocessing.get_context("spawn")
    procs = []
    for k in range(TAIL_CPU_PROCS):
        out_path = os.path.join(tmp, f"tail_out{k}.pt")
        proc = ctx.Process(target=_tail_cpu_worker,
                           args=(in_path, out_path, TAIL_CPU_THREADS, names[k::TAIL_CPU_PROCS]))
        proc.start()
        procs.append((proc, out_path))
    return {"procs": procs, "n": n, "m": m, "t0": time.perf_counter()}


def finish_tail_cpu(run, outs):
    """Waits for the CPU run and holds every card output bit for bit
    against it over its rows."""
    for proc, _ in run["procs"]:
        proc.join()
    codes = [proc.exitcode for proc, _ in run["procs"]]
    if any(codes):
        raise AssertionError(f"phase 19's CPU run exited {codes}")
    cpu_s = time.perf_counter() - run["t0"]
    n, m = run["n"], run["m"]
    cpu_outs = {}
    for _, out_path in run["procs"]:
        cpu_outs.update(torch.load(out_path, weights_only=False))
    if set(cpu_outs) != set(outs):
        raise AssertionError(f"phase 19's CPU run gave {sorted(cpu_outs)}")
    for name, want in cpu_outs.items():
        got = outs[name]
        if name == "percentile_scalar":
            got = _head_any(got, n * len(TAIL_PCTS))
        elif name == "create_histogram_if_valid":
            got = _head_any(got, m)
        else:
            got = _head_any(got, n)
        _same_column(f"phase 19 {name} card vs CPU", got, want)
    return {"cpu_rows": n, "cpu_hist_rows": m, "cpu_s": cpu_s, "cpu_procs": TAIL_CPU_PROCS,
            "cpu_threads": TAIL_CPU_THREADS}


def check_uri_oracle(b, outs):
    """The six parse_uri outputs against tests/uri_oracle.py over the first
    URL_ORACLE_ROWS rows (a null key gives a null row)."""
    oracle = _tests_module("uri_oracle")
    t0 = time.perf_counter()
    k = URL_ORACLE_ROWS
    urls = _head(b["col"], k).to_list()
    keys = _head(b["keys"], k).to_list()
    parts = {"parse_uri_protocol": "PROTOCOL", "parse_uri_host": "HOST",
             "parse_uri_query": "QUERY", "parse_uri_path": "PATH"}
    for name, part in parts.items():
        want = [oracle.parse_url(u, part) for u in urls]
        if _head(outs[name], k).to_list() != want:
            raise AssertionError(f"phase 19 {name} differs from tests/uri_oracle.py")
    want = [oracle.parse_url(u, "QUERY", URL_KEY) for u in urls]
    if _head(outs["parse_uri_query_literal"], k).to_list() != want:
        raise AssertionError("phase 19 parse_uri_query_literal differs from the oracle")
    want = [None if q is None else oracle.parse_url(u, "QUERY", q) for u, q in zip(urls, keys)]
    if _head(outs["parse_uri_query_column"], k).to_list() != want:
        raise AssertionError("phase 19 parse_uri_query_column differs from the oracle")
    valid_share = {name: float(outs[name].is_valid().float().mean())
                   for name in list(parts) + ["parse_uri_query_literal", "parse_uri_query_column"]}
    return {"oracle_rows": k, "oracle_s": time.perf_counter() - t0, "valid_share": valid_share,
            "literal_range_true": int(outs["literal_range_pattern"].data.sum())}


def _out_bytes(col) -> int:
    from spark_rapids_jni_tpu_torch import columnar as c

    if isinstance(col, list):
        return sum(_out_bytes(x) for x in col)
    if isinstance(col, c.ListColumn):
        return 4 * col.offsets.numel() + _out_bytes(col.child) + \
            (0 if col.validity is None else col.validity.numel())
    if isinstance(col, c.StructColumn):
        return sum(_out_bytes(k) for k in col.children)
    return _table_bytes([col])


def _in_bytes(b, name) -> int:
    if name.startswith(("parse_uri", "literal_range")):
        return _table_bytes([b["col"]] + ([b["keys"]] if name.endswith("column") else []))
    if name.startswith(("to_utc", "from_utc")):
        return _table_bytes([b["ts"]])
    if ":" in name:
        return _table_bytes([b[name.split(":")[1]]])
    if name in ("interleave_bits", "hilbert_index"):
        return _table_bytes(b["z"])
    hist = _table_bytes([b["hvals"], b["hcounts"]])
    return hist + (4 * b["hoffsets"].numel() if name.startswith("percentile") else 0)


def time_tail(b, outs, rates):
    """Each call's time (CUDA events, median of TAIL_REPS) and peak memory
    beside its bytes bound: its inputs read once, its output written once."""
    lines = {}
    for name, call in _tail_calls(b).items():
        line = _timed(call, TAIL_REPS, TAIL_WARMUP)
        nbytes = _in_bytes(b, name) + _out_bytes(outs[name])
        line.update({"bytes": nbytes, **_bound(nbytes, 0, rates)})
        lines[name] = line
    return lines


def ops_tail(rates, device="cuda", sizes=None):
    """Phase 19: the inputs, the path with the counters at 0 (no kernel),
    the checks, the times; prints the ``ops_tail`` line and returns the
    path's launch counts."""
    import tempfile

    tz = _tz_source()
    t0 = time.perf_counter()
    b = tail_batch(device, sizes)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        cpu_run = start_tail_cpu(b, tmp)
        try:
            t0 = time.perf_counter()
            counts, outs = tail_path(b)
            path_s = time.perf_counter() - t0
            checks = check_uri_oracle(b, outs)
            times = time_tail(b, outs, rates)
        finally:
            for proc, _ in cpu_run["procs"]:
                proc.join()
        checks.update(finish_tail_cpu(cpu_run, outs))
    lens = b["lens"]
    print(json.dumps({"ops_tail": {
        "n_url": len(lens), "url_chars_bytes": int(lens.sum()), "url_mean_len": float(lens.mean()),
        "url_len_range": [int(lens.min()), int(lens.max())],
        "url_under_300_share": float((lens < 300).mean()),
        "url_null_share": float(1 - b["valid"].mean()), "url_bad_share": float(b["bad"].mean()),
        "n_ts": b["ts"].size, "n_rebase": b["days"].size, "n_zorder": b["z"][0].size,
        "n_hist_rows": b["hvals"].size, "n_hist": len(b["hlens"]),
        "hist_len_range": [int(b["hlens"].min()), int(b["hlens"].max())],
        "zones": tz, "launches": counts, "calls": times, "checks": checks,
        "batch_gen_s": gen_s, "path_s": path_s}}))
    return counts


# ---- phase 20: observability on the card -------------------------------------

OBS_TASK = 970  # the task id of phase 20's governed q97 calls
OBS_FAULT_SEED = 4  # pressure_storm_config's seed: its first two draws inject
_DEVICE_CATS = {"cuda": ("kernel", "gpu_memcpy", "gpu_memset"), "cpu": ("cpu_op",)}
# torch.profiler's clock runs apart from the host's monotonic clock within a
# window, at a rate that differs from process to process (8 to 5,557 ppm seen
# on an H100 with torch 2.11.0+cu128); the converter fits each window's rate
# from the profiler's warm-up and closing marks (obs/convert.py).  A device
# event of a call may lie this far outside its host range after that fit:
# OBS_SLACK_US, plus OBS_DRIFT_PPM of the window's elapsed time
OBS_SLACK_US, OBS_DRIFT_PPM = 100.0, 2000.0


def _union_us(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _obs_q97(mesh, q97, gov, budget):
    from spark_rapids_jni_tpu_torch.mem import task_context
    from spark_rapids_jni_tpu_torch.models import run_distributed_q97

    with task_context(gov, OBS_TASK):
        out = run_distributed_q97(mesh, q97["store"], q97["catalog"], budget=budget,
                                  task_id=OBS_TASK, capacity=q97["capacity"], manage_task=False)
        torch.cuda.synchronize()
    return (int(out.store_only), int(out.catalog_only), int(out.both))


def _faulted_q97(mesh, q97, gov, budget):
    """One governed q97 call under the seeded pressure storm; returns its
    answer and the injector's decision at every crossing."""
    from spark_rapids_jni_tpu_torch.obs import seam
    from spark_rapids_jni_tpu_torch.obs.faultinj import FaultInjector, pressure_storm_config

    FaultInjector.install(pressure_storm_config(OBS_FAULT_SEED))
    check, decisions = seam._injector, []

    def recording(category, name):
        try:
            check(category, name)
        except BaseException as e:
            decisions.append((category, name, type(e).__name__))
            raise
        decisions.append((category, name, "ok"))

    seam._set_injector(recording)
    try:
        return _obs_q97(mesh, q97, gov, budget), decisions
    finally:
        FaultInjector.uninstall()


def _profiled_calls(mesh, q97, json_col, gov, budget, tmp):
    """The two calls under the profiler (with its device trace), each in a
    host range that ends after a synchronize and in a start/stop window of
    its own, so the q97 call's few device records are exported apart from
    the JSON call's ~420,000; returns the answers, the capture's bytes, the
    device trace directory and the launch counts."""
    import os

    from spark_rapids_jni_tpu_torch import ops
    from spark_rapids_jni_tpu_torch.obs import Profiler, seam
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    cap, dev_dir = os.path.join(tmp, "capture.srtp"), os.path.join(tmp, "devtrace")
    Profiler.init(cap, device_trace_dir=dev_dir)
    torch.cuda.synchronize()
    hash_cuda.reset_launches()
    try:  # a start/stop window (and a device trace export) per call
        Profiler.start()
        with seam.seam(seam.OP, "call:governed_q97"):
            answer = _obs_q97(mesh, q97, gov, budget)
        Profiler.stop()
        Profiler.start()
        with seam.seam(seam.OP, "call:get_json_object_8_paths"):
            outs = ops.get_json_object_multiple_paths(json_col, JSON_PATHS)
            torch.cuda.synchronize()
        Profiler.stop()
    finally:
        Profiler.shutdown()
    counts = dict(hash_cuda.launches)
    with open(cap, "rb") as f:
        data = f.read()
    return answer, outs, data, dev_dir, counts


def check_trace(data, dev_dir, counts, device):
    """The capture parses; every seam range, the reservation counters and
    the STATE records are there; the device events include mm_hash_long
    (CUPTI names the kernel, ``(anonymous namespace)::mm_hash_long_kernel``,
    as often as its counter says) and each lies inside its call's host
    range (or the profiler's warm-up and closing marks that open and close
    each window), widened by OBS_SLACK_US and OBS_DRIFT_PPM of the window's
    time for the device clock's drift, each window's export placed with its
    own clock anchor and the clock rate its marks show.  Prints
    and returns the trace's numbers, with the device's busy share of each
    call's window (the union of kernel intervals over its wall), before any
    check raises."""
    import os

    from spark_rapids_jni_tpu_torch.obs import convert, flight, profiler

    t0 = time.perf_counter()
    events = list(convert.parse_capture(data, strict=True))
    # each start() banks its own wall-minus-monotonic anchor and each stop()
    # writes its own export: a window's device events are placed with its own
    # anchor, as the drift allowance below counts from it
    offsets = [e["value"] for e in events
               if e["type"] == "counter" and e["name"] == profiler.CLOCK_ANCHOR]
    exports = sorted((os.path.join(dev_dir, n) for n in os.listdir(dev_dir)),
                     key=os.path.getmtime)
    if len(exports) != len(offsets):
        raise AssertionError(f"phase 20: {len(exports)} device exports for "
                             f"{len(offsets)} profiler windows")
    merged = convert.to_chrome(events)
    for k, (path, offset) in enumerate(zip(exports, offsets)):
        one = os.path.join(dev_dir, f"window{k}")
        os.mkdir(one)
        os.rename(path, os.path.join(one, os.path.basename(path)))
        merged = convert.merge_device_events(merged, convert.load_device_trace(one), offset)
    convert_s = time.perf_counter() - t0
    trace = merged["traceEvents"]
    host = [e for e in trace if e.get("pid") == 0 and e.get("ph") == "X"]
    windows = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in host
               if e["name"].startswith("call:")}
    # each profiler window opens with the profiler's own warm-up launches and
    # closes with its clock mark's launch
    warmups = [(e["ts"], e["ts"] + e["dur"]) for e in host
               if e["name"] in (profiler.WARMUP_RANGE, profiler.CLOSING_RANGE)]
    ranges = sorted({e["name"].split(":")[0] if e["name"].startswith("reserve:") else e["name"]
                     for e in host})
    counters = sorted({e["name"] for e in events if e["type"] == "counter"})
    states = sorted({e["kind"] for e in events if e["type"] == "state"})
    cats = _DEVICE_CATS[device]
    # the profiler's windows: each opens at its clock anchor
    anchors = sorted(e["t_ns"] / 1e3 for e in events
                     if e["type"] == "counter" and e["name"] == profiler.CLOCK_ANCHOR)

    def widened(s, e):
        """A host range [s, e] widened for the device clock's drift: the
        device timestamps of a window run up to OBS_DRIFT_PPM ahead of the
        host's monotonic clock as the window goes on."""
        a = max((t for t in anchors if t <= s), default=s)
        return s - OBS_SLACK_US, e + OBS_SLACK_US + OBS_DRIFT_PPM * 1e-6 * (e - a)

    devs = [e for e in trace if e.get("pid", 0) >= 1000 and e.get("ph") == "X"
            and e.get("cat") in cats]
    hash_names = sorted({e["name"] for e in devs if "mm_hash_long" in e["name"]})
    q97_s, q97_e = windows.get("call:governed_q97", (0, 0))
    q97_kernels = sorted({d["name"][:48] for d in devs if d.get("cat") == cats[0]
                          and q97_s <= d["ts"] <= q97_e})
    n_hash = sum(1 for e in devs if "mm_hash_long" in e["name"])
    per_call = {}
    for name, (s, e) in windows.items():
        ws, we = widened(s, e)
        inside = [d for d in devs if ws <= d["ts"] and d["ts"] + d["dur"] <= we]
        kernels = [(d["ts"], d["ts"] + d["dur"]) for d in inside if d.get("cat") == cats[0]]
        per_call[name] = {
            "wall_ms": (e - s) / 1e3, "device_events": len(inside), "kernels": len(kernels),
            "busy_share_kernels": _union_us(kernels) / (e - s),
            "busy_share_all": _union_us((d["ts"], d["ts"] + d["dur"]) for d in inside) / (e - s),
            "first_event_after_start_us": min((d["ts"] - s for d in inside), default=None),
            "last_event_before_end_us": min((e - d["ts"] - d["dur"] for d in inside),
                                            default=None),
            "allowance_us": we - e,
            "max_past_end_us": max((d["ts"] + d["dur"] - e for d in inside), default=None)}
    ranges_w = [widened(s, e) for s, e in list(windows.values()) + warmups]
    outside = [d for d in devs if not any(s <= d["ts"] and d["ts"] + d["dur"] <= e
                                          for s, e in ranges_w)]
    info = {"srtp_bytes": len(data), "srtp_events": len(events), "device_events": len(devs),
            "trace_events": len(trace), "seam_ranges": ranges, "counters": counters,
            "state_kinds": states, "mm_hash_long_events": n_hash, "hash_names": hash_names,
            "q97_kernel_names": q97_kernels, "device_exports": len(os.listdir(dev_dir)),
            "calls": per_call, "warmup_ranges": len(warmups), "windows": len(anchors),
            "anchor_offsets_ns": offsets,
            "clock_rates_ppm": [r * 1e6 for r in merged.get("deviceClockRates", [])],
            "drift_ppm_allowed": OBS_DRIFT_PPM, "slack_us": OBS_SLACK_US,
            "outside": len(outside),
            "outside_head": [(d["name"][:60], d["ts"], d["dur"]) for d in outside[:3]],
            "convert_s": convert_s}
    print(json.dumps({"obs_trace": info}))
    want = {"call:governed_q97", "call:get_json_object_8_paths",
            "get_json_object_multiple_paths", "reserve"}
    if not want <= set(ranges):
        raise AssertionError(f"phase 20: seam ranges {ranges} lack {want - set(ranges)}")
    if "device_budget_used" not in counters or flight.EV_TASK_ADMITTED not in states:
        raise AssertionError(f"phase 20: counters {counters}, state kinds {states}")
    if device == "cuda" and (n_hash != counts["mm_hash_long"] or n_hash == 0):
        raise AssertionError(f"phase 20: {n_hash} mm_hash_long device events, "
                             f"{counts['mm_hash_long']} launches counted")
    if outside:
        raise AssertionError(f"phase 20: {len(outside)} device events outside the calls' "
                             "host ranges")
    return info


def observability(mesh, q97, json_col, device="cuda"):
    """Phase 20: a governed q97 at SF10 (the governed phase's tables) and an
    8-path get_json_object over 2**14 rows of phase 17's column under the
    profiler with its device trace; the merged trace checked; then two
    governed q97 calls under the seeded pressure storm.  Prints the ``obs``
    line and returns the profiled calls' launch counts."""
    import tempfile

    from spark_rapids_jni_tpu_torch.mem import MemoryGovernor
    from spark_rapids_jni_tpu_torch.mem.governed import default_device_budget

    gov = MemoryGovernor.initialize()
    try:
        budget = default_device_budget(gov)
        t0 = time.perf_counter()
        unfaulted = _obs_q97(mesh, q97, gov, budget)  # warm; the answer to hold the rest to
        warm_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            answer, outs, data, dev_dir, counts = _profiled_calls(mesh, q97, json_col, gov,
                                                                  budget, tmp)
            profiled_s = time.perf_counter() - t0
            trace = check_trace(data, dev_dir, counts, device)
        print(json.dumps({"obs_launches": counts}))
        t0 = time.perf_counter()
        faulted = [_faulted_q97(mesh, q97, gov, budget) for _ in range(2)]
        faulted_s = time.perf_counter() - t0
    finally:
        MemoryGovernor.shutdown()
    oracle = tuple(q97["oracle"])
    if not unfaulted == answer == oracle:
        raise AssertionError(f"phase 20 q97 {unfaulted}, profiled {answer} != {oracle}")
    (a1, d1), (a2, d2) = faulted
    injected = sum(1 for d in d1 if d[2] != "ok")
    if a1 != unfaulted or a2 != unfaulted or d1 != d2 or not injected:
        raise AssertionError(f"phase 20 faulted q97 {a1} / {a2} (unfaulted {unfaulted}); "
                             f"decisions equal {d1 == d2}, injected {injected}")
    json_rows = [o.to_list()[:4] for o in outs[:2]]
    print(json.dumps({"obs": {
        "q97": list(unfaulted), "json_rows": json_col.size, "json_paths": len(JSON_PATHS),
        "launches": counts, "busy_share": {n: c["busy_share_kernels"]
                                           for n, c in trace["calls"].items()},
        "convert_s": trace["convert_s"], "warm_q97_s": warm_s, "profiled_s": profiled_s,
        "faulted": {"seed": OBS_FAULT_SEED, "decisions": d1, "injected": injected,
                    "answers_equal": True, "seconds": faulted_s},
        "json_head": json_rows}}))
    return counts


# ---- the serving engine (phase 21) ------------------------------------------

SERVE_SEED = 79  # numpy seed of the hash32 payloads and of the traffic's order
SERVE_CLIENTS = 8  # client threads, each waiting on its answer before its next submit
SERVE_PRIORITIES = (0, 1, 2)  # the three sessions' priorities
SERVE_HASH_REQS = 512  # hash32 requests (micro-batcher, then the same ones ragged)
SERVE_HASH_MAX_ROWS = 1 << 20  # their int64 rows are log-uniform over 1..this
SERVE_JSON_REQS = 16  # get_json_object requests, each over SERVE_JSON_ROWS rows and 8 paths
SERVE_JSON_ROWS = 1024
SERVE_STORM_REQS = 64  # hash32 requests under the RetryOOM storm (the first payloads)
SERVE_STORM = {"seed": SERVE_SEED,
               "serve": {"handle:hash32": {"percent": 25.0, "injectionType": "retry_oom"}}}
SERVE_Q3_TASK = 2103  # the task id of the result-cache q3 calls


def _serve_clients(engine, sessions, reqs):
    """Submit ``reqs`` [(handler, payload, rows)] from SERVE_CLIENTS threads,
    request i by session i % 3, each client waiting on its answer before its
    next submit (retrying after the hint on Backpressure); returns, per
    request, (answer, submit time, answer time) on the host clock -- each
    answer is host data, so no clock reads work still on the card -- and the
    queue's peak depth seen after the submits."""
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_jni_tpu_torch.serve import Backpressure

    peak = [0]

    def one(i):
        handler, payload, _rows = reqs[i]
        t0 = time.perf_counter()
        while True:
            try:
                resp = engine.submit(sessions[i % len(sessions)], handler, payload)
                break
            except Backpressure as e:
                time.sleep(e.retry_after_s)
        peak[0] = max(peak[0], engine.queue.depth())
        out = resp.result(timeout=900)
        return out, t0, time.perf_counter()

    with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
        results = list(pool.map(one, range(len(reqs))))
    return results, peak[0]


def _serve_stats(reqs, results):
    """Per handler: requests, ok (every answer was checked before this), p50
    and p99 of the client-side latency in ms, rows and rows/s over the span
    from the handler's first submit to its last answer."""
    by = {}
    for (handler, _p, rows), (_out, t0, t1) in zip(reqs, results):
        d = by.setdefault(handler, {"lat": [], "rows": 0, "t0": t0, "t1": t1})
        d["lat"].append((t1 - t0) * 1e3)
        d["rows"] += rows
        d["t0"], d["t1"] = min(d["t0"], t0), max(d["t1"], t1)
    return {h: {"requests": len(d["lat"]), "ok": len(d["lat"]),
                "p50_ms": float(np.percentile(d["lat"], 50)),
                "p99_ms": float(np.percentile(d["lat"], 99)),
                "rows": d["rows"], "rows_per_s": d["rows"] / (d["t1"] - d["t0"])}
            for h, d in by.items()}


def _counting(seam_mod, seen):
    """Count every seam crossing, by (category, name), into ``seen``."""
    def hook(category, name):
        seen[(category, name)] = seen.get((category, name), 0) + 1
    seam_mod._set_injector(hook)


def _ragged_geometries(seen, seam_mod):
    """(the geometries the ragged ticks launched at, those built as programs)
    from the crossings ``launch:ragged:<kernel>:<geometry>`` and
    ``ragged:<kernel>:<geometry>``."""
    launched = {n.split(":", 3)[3] for c, n in seen
                if c == seam_mod.COLLECTIVE and n.startswith("launch:ragged:")}
    built = {n.split(":", 2)[2] for c, n in seen
             if c == seam_mod.COMPILE and n.startswith("ragged:")}
    return launched, built


def _serve_hash_payloads(n, max_rows, seed=SERVE_SEED):
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(0.0, np.log(max_rows), n)).astype(np.int64) + 1
    sizes = np.minimum(sizes, max_rows)
    return [rng.integers(-(1 << 63), (1 << 63) - 1, int(k), dtype=np.int64, endpoint=True)
            for k in sizes]


def _hash_plain(payloads, device):
    """The plain torch version of every hash32 answer, on ``device``."""
    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    return [hash_cuda.mm_hash_long_torch(torch.from_numpy(p).to(device), 42).cpu().numpy()
            for p in payloads]


def _require_same_arrays(what, got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"{what}: answer {i} differs")
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} answers for {len(want)}")


def _engine(gov, budget, mesh, **kw):
    from spark_rapids_jni_tpu_torch.serve import ServingEngine

    return ServingEngine(mesh=mesh, gov=gov, budget=budget, builtin_handlers=True,
                         default_deadline_s=900.0, **kw)


def _sessions(engine):
    return [engine.open_session(f"client-p{p}", priority=p) for p in SERVE_PRIORITIES]


def _unanswered(engine, answered):
    """What the engine counted beside the ``answered`` client requests: every
    front-door request must be answered, none failed, timed out or cancelled
    (split halves count their own completions, so ``completed`` is not
    compared)."""
    m = engine.metrics
    got = {k: m.get(k) for k in ("submitted", "failed", "timed_out", "cancelled")}
    if got["submitted"] != answered or got["failed"] or got["timed_out"] or got["cancelled"]:
        raise AssertionError(f"phase 21: {answered} answers, engine counts {got}")
    return got


def _storm_run(gov, budget, mesh, payloads):
    """The RetryOOM storm: one worker held on a gate until every hash32
    request is queued (the queue holds them all) (so the batches and the order of the crossings are the
    same in every run), SERVE_STORM armed on the seam; returns the answers,
    the injector's decision at every crossing and the engine's retries."""
    import threading

    from spark_rapids_jni_tpu_torch.obs import seam
    from spark_rapids_jni_tpu_torch.obs.faultinj import FaultInjector
    from spark_rapids_jni_tpu_torch.serve import QueryHandler

    eng = _engine(gov, budget, mesh, workers=1, queue_size=len(payloads) + 1)
    gate = threading.Event()
    FaultInjector.install(SERVE_STORM)
    check, decisions = seam._injector, []

    def recording(category, name):
        try:
            check(category, name)
        except BaseException as e:
            decisions.append((category, name, type(e).__name__))
            raise
        decisions.append((category, name, "ok"))

    seam._set_injector(recording)
    try:
        eng.register(QueryHandler(name="gate", fn=lambda p, ctx: gate.wait(600)))
        sess = eng.open_session("storm")
        held = eng.submit(sess, "gate", None)
        resps = [eng.submit(sess, "hash32", p) for p in payloads]
        gate.set()
        held.result(timeout=600)
        answers = [r.result(timeout=600) for r in resps]
    finally:
        gate.set()
        FaultInjector.uninstall()
        eng.shutdown()
    _unanswered(eng, len(answers) + 1)  # and the gate
    return answers, decisions, eng.metrics.get("retried")


def serve_phase(mesh, q97, gp, json_head, device="cuda"):
    """Phase 21: the port's ServingEngine on ``mesh`` (a one-rank NCCL mesh)
    with its built-in handlers, 4 workers and a queue of 64 (the flags'
    defaults), three sessions (priorities 0, 1, 2) and 8 client threads:
    q97 at SF10 twice, q5 and q3 on the plans phase's data and 16
    get_json_object requests in one shuffled stream, then 512 hash32
    requests through the micro-batcher; a q97
    under half its working set on an engine of that budget (it must split and
    re-queue); the same 512 hash32 payloads with serve_ragged on (the default
    geometry: 256-row pages, 64 pages, 64 riders); 64 hash32 requests under a
    seeded RetryOOM storm on handle:hash32, twice; and q3's plan twice
    through run_governed_plan with serve_result_cache on.  Every answer is
    held to its reference; prints the ``serve`` line and returns the phase's
    launch counts and the q97 times phase 22 stands beside."""
    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.mem import BudgetedResource, MemoryGovernor, task_context
    from spark_rapids_jni_tpu_torch.mem.governed import default_device_budget
    from spark_rapids_jni_tpu_torch.models import Q97Batch, run_distributed_q3
    from spark_rapids_jni_tpu_torch.models.q97 import (
        default_q97_capacity,
        q97_working_set_bytes,
    )
    from spark_rapids_jni_tpu_torch.obs import seam
    from spark_rapids_jni_tpu_torch.ops import hash_cuda
    from spark_rapids_jni_tpu_torch.ops.get_json_object import get_json_object_multiple_paths
    from spark_rapids_jni_tpu_torch.plans import plan_cache
    from spark_rapids_jni_tpu_torch.plans.rcache import result_cache

    t_phase = time.perf_counter()
    store, catalog = q97["store"], q97["catalog"]
    q97_rows = len(store[0]) + len(catalog[0])
    oracle = tuple(q97["oracle"])
    payloads = _serve_hash_payloads(SERVE_HASH_REQS, SERVE_HASH_MAX_ROWS)
    plain = _hash_plain(payloads, device)
    json_rows = _head(json_head, SERVE_JSON_ROWS).to_list()
    t0 = time.perf_counter()
    json_want = [o.to_list() for o in get_json_object_multiple_paths(
        c.strings_column(json_rows, device=device), JSON_PATHS)]
    json_direct_s = time.perf_counter() - t0  # its answer is host data
    rng = np.random.default_rng(SERVE_SEED)
    reqs = ([("q97", (store, catalog), q97_rows)] * 2
            + [("q5", gp["q5"], sum(len(ch.sales_sk) + len(ch.ret_sk)
                                    for ch in gp["q5"].channels.values())),
               ("q3", gp["q3"], len(gp["q3"].ss_item_sk))]
            + [("get_json_object", (json_rows, JSON_PATHS), SERVE_JSON_ROWS)] * SERVE_JSON_REQS)
    reqs = [reqs[i] for i in rng.permutation(len(reqs))]
    hreqs = [("hash32", p, len(p)) for p in payloads]
    ws = q97_working_set_bytes(Q97Batch(*store, *catalog,
                                        capacity=default_q97_capacity(q97_rows, 1)), 1)
    gov = MemoryGovernor.initialize()
    seen, stages, out = {}, {}, {}
    try:
        budget = default_device_budget(gov)
        torch.cuda.synchronize()
        hash_cuda.reset_launches()
        # 1. the queries, then the hash32 requests through the micro-batcher
        t0 = time.perf_counter()
        eng = _engine(gov, budget, mesh)
        _counting(seam, seen)
        try:
            sessions = _sessions(eng)
            qresults, qpeak = _serve_clients(eng, sessions, reqs)
            stages["queries_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            hresults, hpeak = _serve_clients(eng, sessions, hreqs)
        finally:
            seam._set_injector(None)
            eng.shutdown()
        stages["micro_s"] = time.perf_counter() - t0
        results, peak = qresults + hresults, max(qpeak, hpeak)
        print(json.dumps({"serve_stage": "queries+micro", "s": stages}), flush=True)
        micro_launches = hash_cuda.launches["mm_hash_long"]
        m1 = {k: eng.metrics.get(k) for k in ("completed", "batched", "retried",
                                              "split_requeued")}
        m1.update(_unanswered(eng, len(results)), queue_peak=peak)
        m1["handlers"] = eng.metrics.snapshot()["handlers"]
        micro = {}
        for (handler, payload, _rows), (ans, _t0, _t1) in zip(reqs + hreqs, results):
            if handler == "q97":
                got = (int(ans.store_only), int(ans.catalog_only), int(ans.both))
                if got != oracle:
                    raise AssertionError(f"phase 21 q97 {got} != oracle {oracle}")
            elif handler == "q5" and ans != gp["q5_rows"]:
                raise AssertionError("phase 21 q5 != the plans phase's answer")
            elif handler == "q3" and [tuple(r) for r in ans] != gp["q3_rows"]:
                raise AssertionError("phase 21 q3 != the plans phase's answer")
            elif handler == "get_json_object" and ans != json_want:
                raise AssertionError("phase 21 get_json_object != the direct call")
            elif handler == "hash32":
                micro[id(payload)] = ans
        micro = [micro[id(p)] for p in payloads]
        _require_same_arrays("phase 21 hash32 (micro-batch) against the plain version", micro, plain)
        out["mixed"] = {**_serve_stats(reqs, qresults), **_serve_stats(hreqs, hresults)}
        # 2. q97 on an engine whose budget is half its working set
        t0 = time.perf_counter()
        tight = BudgetedResource(gov, int(ws * GOV_TIGHT))
        eng = _engine(gov, tight, mesh)
        try:
            sess = _sessions(eng)
            t_req = time.perf_counter()
            ans = eng.submit(sess[0], "q97", (store, catalog)).result(timeout=900)
            tight_s = time.perf_counter() - t_req
        finally:
            eng.shutdown()
        got = (int(ans.store_only), int(ans.catalog_only), int(ans.both))
        m2 = {k: eng.metrics.get(k) for k in ("completed", "split_requeued", "retried")}
        m2.update(_unanswered(eng, 1), class_splits=eng.class_split_counts())
        if got != oracle or m2["split_requeued"] < 2 or m2["class_splits"].get("q97", 0) < 1:
            raise AssertionError(f"phase 21 tight q97 {got} (oracle {oracle}), {m2}")
        if tight.used:
            raise AssertionError(f"phase 21 tight budget left in use: {tight.used}")
        stages["tight_s"] = time.perf_counter() - t0
        print(json.dumps({"serve_stage": "tight", "s": stages["tight_s"]}), flush=True)
        # 3. the same hash32 payloads with serve_ragged on
        t0 = time.perf_counter()
        before = hash_cuda.launches["mm_hash_long"]
        misses = plan_cache.stats()["misses"]
        eng = _engine(gov, budget, mesh, serve_ragged=True)
        ragged_seen = {}
        _counting(seam, ragged_seen)
        try:
            rresults, rpeak = _serve_clients(eng, _sessions(eng), hreqs)
        finally:
            seam._set_injector(None)
            eng.shutdown()
        ragged = [a for a, _t0, _t1 in rresults]
        _require_same_arrays("phase 21 hash32 (ragged) against the micro-batch answers", ragged, micro)
        ticks = eng.metrics.get("ragged_launches")
        ragged_launches = hash_cuda.launches["mm_hash_long"] - before
        geoms, programs = _ragged_geometries(ragged_seen, seam)
        m3 = {k: eng.metrics.get(k) for k in ("completed", "ragged_launches",
                                              "ragged_batched", "ragged_pages", "ragged_rows",
                                              "ragged_row_capacity", "ragged_splits",
                                              "retried")}
        m3.update(_unanswered(eng, len(rresults)), queue_peak=rpeak, geometries=sorted(geoms),
                  programs_built=sorted(programs),
                  plan_cache_misses=plan_cache.stats()["misses"] - misses)
        if ragged_launches < ticks or ticks < 1 or not programs <= geoms:
            raise AssertionError(f"phase 21 ragged: {ragged_launches} mm_hash_long launches "
                                 f"over {ticks} ticks, programs {programs}, geometries {geoms}")
        out["ragged"] = _serve_stats(hreqs, rresults)
        stages["ragged_s"] = time.perf_counter() - t0
        print(json.dumps({"serve_stage": "ragged", "s": stages["ragged_s"]}), flush=True)
        # 4. the RetryOOM storm, twice
        t0 = time.perf_counter()
        storm = [_storm_run(gov, budget, mesh, payloads[:SERVE_STORM_REQS]) for _ in range(2)]
        (a1, d1, r1), (a2, d2, r2) = storm
        _require_same_arrays("phase 21 hash32 under the storm", a1, micro[:SERVE_STORM_REQS])
        _require_same_arrays("phase 21 hash32 under the second storm", a2, micro[:SERVE_STORM_REQS])
        injected = sum(1 for d in d1 if d[2] != "ok")
        if d1 != d2 or not injected or r1 != injected or r2 != injected:
            raise AssertionError(f"phase 21 storm: decisions equal {d1 == d2}, injected "
                                 f"{injected}, retries {r1} / {r2}")
        stages["storm_s"] = time.perf_counter() - t0
        print(json.dumps({"serve_stage": "storm", "s": stages["storm_s"]}), flush=True)
        # 5. q3's plan twice with the result cache on: the second is a hit
        t0 = time.perf_counter()
        result_cache.reset_for_tests()
        result_cache.bind_budget(budget, device=device)
        try:
            with config.override(serve_result_cache=True), task_context(gov, SERVE_Q3_TASK):
                first = run_distributed_q3(mesh, gp["q3"], budget=budget,
                                           task_id=SERVE_Q3_TASK, manage_task=False)
                held, execs = budget.used, plan_cache.stats()["execute_calls"]
                budget.reset_peak()
                t_hit = time.perf_counter()
                second = run_distributed_q3(mesh, gp["q3"], budget=budget,
                                            task_id=SERVE_Q3_TASK, manage_task=False)
                hit_s = time.perf_counter() - t_hit
                peak_during_hit = budget.reset_peak()
            rstats = result_cache.stats()
        finally:
            result_cache.reset_for_tests()
        if ([tuple(r) for r in first] != gp["q3_rows"] or second != first
                or plan_cache.stats()["execute_calls"] != execs or peak_during_hit != held
                or rstats["hits"] != 1 or rstats["hbm_entries"] != 1):
            raise AssertionError(f"phase 21 result cache: equal {second == first}, "
                                 f"peak {peak_during_hit} held {held}, {rstats}")
        stages["rcache_s"] = time.perf_counter() - t0
        print(json.dumps({"serve_stage": "rcache", "s": stages["rcache_s"]}), flush=True)
    finally:
        seam._set_injector(None)
        MemoryGovernor.shutdown()
    counts = dict(hash_cuda.launches)
    executions = seen.get((seam.SERVE, "handle:hash32"), 0)
    if micro_launches < executions or executions < 1 or counts["mm_hash_long"] < 1:
        raise AssertionError(f"phase 21: {micro_launches} mm_hash_long launches over "
                             f"{executions} hash32 executions")
    print(json.dumps({"serve_launches": counts}))
    print(json.dumps({"serve": {
        "mesh": [1, 1], "workers": 4, "queue_size": 64, "clients": SERVE_CLIENTS,
        "sessions": list(SERVE_PRIORITIES), "seed": SERVE_SEED,
        "handlers": out["mixed"], "engine_run_ms": m1.pop("handlers"), "mixed": m1,
        "tight_q97": {"s": tight_s, "budget_bytes": tight.limit, "working_set_bytes": ws,
                      **m2},
        "ragged": {"handlers": out["ragged"], **m3, "mm_hash_long_launches": ragged_launches},
        "storm": {"requests": SERVE_STORM_REQS, "config": SERVE_STORM, "injected": injected,
                  "retries": [r1, r2], "decisions_equal": True, "crossings": len(d1)},
        "result_cache": {"hits": rstats["hits"], "misses": rstats["misses"],
                         "hbm_entries": rstats["hbm_entries"], "hit_s": hit_s,
                         "reservation_during_hit": peak_during_hit - held},
        "micro_batch": {"hash32_executions": executions, "batched_requests": m1["batched"],
                        "mm_hash_long_launches": micro_launches},
        "mm_hash_long_launches": counts["mm_hash_long"],
        "direct_s": {"q5_local": gp["q5_local_s"], "q3_local": gp["q3_local_s"],
                     "run_q97_piece": gp["q97_piece_s"], "get_json_object": json_direct_s},
        "stages_s": stages, "seconds": time.perf_counter() - t_phase}}))
    return counts, {"phase21_q97_engine_p50_ms": out["mixed"]["q97"]["p50_ms"],
                    "run_q97_piece_s": gp["q97_piece_s"]}


def serve_json_probe(device="cuda"):
    """Why phase 21's JSON handler runs one call at a time on the card: one
    SERVE_JSON_ROWS-row 8-path get_json_object call timed alone three times,
    then four of them at once in threads (each answer checked against the
    first).  ``python3 -c "import chip_smoke as c; c.serve_json_probe()"``."""
    import threading

    from spark_rapids_jni_tpu_torch import columnar as c
    from spark_rapids_jni_tpu_torch.ops.get_json_object import get_json_object_multiple_paths

    rows = json_batch(device, n=SERVE_JSON_ROWS)["col"].to_list()

    def one():
        col = c.strings_column(rows, device=device)
        return [o.to_list() for o in get_json_object_multiple_paths(col, JSON_PATHS)]

    alone = []
    for _ in range(3):
        t0 = time.perf_counter()
        want = one()
        alone.append(time.perf_counter() - t0)
    got = [None] * 4

    def run(k):
        got[k] = one()

    threads = [threading.Thread(target=run, args=(k,)) for k in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    four_s = time.perf_counter() - t0
    if any(g != want for g in got):
        raise AssertionError("serve_json_probe: a concurrent call's answer differs")
    print(json.dumps({"serve_json_probe": {"rows": SERVE_JSON_ROWS, "paths": len(JSON_PATHS),
                                           "alone_s": alone, "four_at_once_s": four_s}}))
    return alone, four_s


def serve_alone(device="cuda"):
    """Phase 21 by itself: builds the kernels, makes the inputs the earlier
    phases would hand it (the SF10 q97 tables and their oracle, the plans
    phase's q5 and q3 data with ``q5_local``'s and ``q3_local``'s rows,
    SERVE_JSON_ROWS rows of phase 17's generator) and runs it on a one-rank
    mesh.
    ``python3 -c "import chip_smoke as c; c.serve_alone()"``."""
    from spark_rapids_jni_tpu_torch.models import generate_q3_data, generate_q5_data
    from spark_rapids_jni_tpu_torch.models.q3 import q3_local
    from spark_rapids_jni_tpu_torch.models.q5 import q5_local
    from spark_rapids_jni_tpu_torch.models.q97 import default_q97_capacity
    from spark_rapids_jni_tpu_torch.models.tpcds import generate_q97_tables
    from spark_rapids_jni_tpu_torch.parallel import one_rank_mesh

    if device == "cuda":
        build()
    store, catalog = generate_q97_tables(sf=Q97_SF, seed=42)
    q97 = {"store": store, "catalog": catalog, "oracle": q97_oracle(store, catalog),
           "capacity": default_q97_capacity(len(store[0]) + len(catalog[0]), 1)}
    q5 = generate_q5_data(sf=Q5_SF, seed=Q5_SEED)
    q3 = generate_q3_data(sf=Q3_SF, seed=Q3_SEED)
    gp = {"q5": q5, "q5_rows": q5_local(q5, device=device), "q3": q3,
          "q3_rows": [tuple(r) for r in q3_local(q3, device=device)],
          "q5_local_s": None, "q3_local_s": None, "q97_piece_s": None}
    head = json_batch(device, n=SERVE_JSON_ROWS)["col"]
    with one_rank_mesh(device) as mesh:
        return serve_phase(mesh, q97, gp, head, device=device)


# ---- phase 22: the supervised cluster on one card ------------------------------

SUP_WORKERS = 4  # executor processes, all on the one card
SUP_ENGINE_WORKERS = 2  # worker threads of each executor's engine
SUP_SEED = 83  # numpy seed of the hash32 payloads and of the traffic's order
SUP_CLIENTS = 8  # client threads, each waiting on its answer before its next submit
SUP_HASH_REQS = 256  # hash32 requests; int64 rows log-uniform over 1..SERVE_HASH_MAX_ROWS
SUP_Q97_CAPACITY = 64  # q97_plan's in-mesh capacity: unused once the exchange is split off
SUP_CHAOS_SEED = 14  # chaos_shuffle_config's seed base (seed*1000 + worker*17 + incarnation)
SUP_KILL_PCT = 50.0  # per budget crossing of executor 0's first incarnation (it dies once)
SUP_CHAOS_ROUNDS = 3  # chaos q97 runs at most, until the armed executor has been killed
SUP_LEASE_HANG_S = 300.0  # a shard piece at SF10 is seconds of work, far from a hang
SUP_STATS_S = 0.25  # period of each executor's stats file
SUP_WIDE_ROWS = 1 << 26  # rows of the hash32_wide request: a 268,435,456-byte result


def _wide_keys(n, seed, device):
    """The hash32_wide request's int64 keys, made on ``device``."""
    return torch.arange(n, dtype=torch.int64, device=device) * 0x5DEECE66D + seed


def _q97_dicts(store, catalog):
    return {"store": {"cust": store[0], "item": store[1]},
            "catalog": {"cust": catalog[0], "item": catalog[1]}}


def supervised_worker(engine, stats_dir, device="cuda"):
    """Phase 22's executor process (``Supervisor(factory="chip_smoke:
    supervised_worker")``): the built-in handlers (``hash32`` is
    ``mm_hash_long`` on the card), q97's exchange as a hash-shuffle piece
    (plain, and adaptive for the run that asks for it), q67 as a
    range-shuffle piece, on the engine's device, which must be ``device``.
    A daemon thread writes the process's launch counts, the shuffle
    transport's counters and its memory peaks to ``stats_dir`` every
    SUP_STATS_S seconds and at exit, so the parent can add up what the
    executors launched (a killed one keeps its last file)."""
    import atexit
    import os
    import threading

    from spark_rapids_jni_tpu_torch import config
    from spark_rapids_jni_tpu_torch.models import q67_plan
    from spark_rapids_jni_tpu_torch.models.q97 import q97_plan
    from spark_rapids_jni_tpu_torch.ops import hash_cuda
    from spark_rapids_jni_tpu_torch.serve import QueryHandler, register_builtin_handlers
    from spark_rapids_jni_tpu_torch.serve import shuffle

    if engine.device.type != torch.device(device).type:
        raise RuntimeError(f"executor engine on {engine.device}, phase 22 asked {device}")
    register_builtin_handlers(engine)
    plain = shuffle.make_shuffle_handler(q97_plan(SUP_Q97_CAPACITY))
    engine.register(QueryHandler(name="q97_shuffle", fn=plain, nbytes_of=lambda p: 0))
    # the adaptive exchange is a per-process flag that every piece reads once
    # at its start: held on from the first adaptive piece in this process
    # until the last one ends (the adaptive run has the cluster to itself)
    users, lock = [0], threading.Lock()

    def adaptive(payload, ctx):
        with lock:
            if users[0] == 0:
                config.set("serve_adaptive_exchange", True)
            users[0] += 1
        try:
            return plain(payload, ctx)
        finally:
            with lock:
                users[0] -= 1
                if users[0] == 0:
                    config.set("serve_adaptive_exchange", False)

    engine.register(QueryHandler(name="q97_shuffle_adaptive", fn=adaptive,
                                 nbytes_of=lambda p: 0))
    engine.register(QueryHandler(
        name="q67_shuffle",
        fn=shuffle.make_range_shuffle_handler(q67_plan(ORDER_K, ORDER_ITEMS)),
        nbytes_of=lambda p: 0))

    def wide(payload, ctx):
        from spark_rapids_jni_tpu_torch.columnar.column import Column
        from spark_rapids_jni_tpu_torch.columnar.dtypes import INT64
        from spark_rapids_jni_tpu_torch.ops import murmur_hash32

        n, seed = payload
        keys = Column(_wide_keys(n, seed, ctx.device), None, INT64)
        return murmur_hash32([keys], seed=42).data.cpu().numpy()

    engine.register(QueryHandler(name="hash32_wide", fn=wide, nbytes_of=lambda p: 16 * p[0]))
    path = os.path.join(stats_dir, f"worker_{os.getpid()}.json")
    write_lock = threading.Lock()  # the stats thread and the exit hook

    def write():
        with hash_cuda._launches_lock:
            launches = dict(hash_cuda.launches)
        stats = {"pid": os.getpid(), "device": str(engine.device), "launches": launches,
                 "transport": shuffle.service().snapshot()["counters"]}
        if engine.device.type == "cuda":
            stats["max_allocated"] = torch.cuda.max_memory_allocated()
            stats["max_reserved"] = torch.cuda.max_memory_reserved()
        with write_lock:
            with open(path + ".tmp", "w") as f:
                json.dump(stats, f)
            os.replace(path + ".tmp", path)

    def loop():
        while True:
            write()
            time.sleep(SUP_STATS_S)

    write()
    atexit.register(write)
    threading.Thread(target=loop, daemon=True, name="phase22-stats").start()


def _worker_stats(stats_dir):
    import glob
    import os

    out = []
    for p in sorted(glob.glob(os.path.join(stats_dir, "worker_*.json"))):
        with open(p) as f:
            out.append(json.load(f))
    return out


class _AppMemory:
    """The card's compute processes' memory (``nvidia-smi
    --query-compute-apps``) sampled every half second in a thread: the
    largest sum over one sample, and each pid's largest reading, in MiB.
    Samples nothing when ``on`` is false (a rehearsal on the CPU)."""

    def __init__(self, on=True):
        import threading

        self.on = on
        self.peak_sum, self.per_pid, self.samples = 0, {}, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="phase22-mem")

    def _run(self):
        while not self._stop.wait(0.5):
            res = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                                  "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True, timeout=30)
            rows = [r.split(",") for r in res.stdout.strip().splitlines() if "," in r]
            used = {int(pid): int(mib) for pid, mib in rows}
            self.samples += 1
            self.peak_sum = max(self.peak_sum, sum(used.values()))
            for pid, mib in used.items():
                self.per_pid[pid] = max(self.per_pid.get(pid, 0), mib)

    def __enter__(self):
        if self.on:
            self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self.on:
            self._thread.join(timeout=60)


class _HelloWatch:
    """Polls a supervisor's executors every 10 ms in a thread: for each
    (worker, incarnation), the seconds from its spawn (the supervisor's
    construction for incarnation 0, else the first poll that saw it) to the
    first poll that saw it alive, i.e. its HELLO."""

    def __init__(self, t0):
        import threading

        self.t0, self.first, self.alive = t0, {}, {}
        self.sup = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="phase22-hello")

    def watch(self, sup):
        self.sup = sup
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.01):
            now = time.perf_counter()
            for wid, w in self.sup.snapshot()["workers"].items():
                key = f"{wid}.{w['incarnation']}"
                self.first.setdefault(key, self.t0 if w["incarnation"] == 0 else now)
                if w["state"] == "alive":
                    self.alive.setdefault(key, now)

    def wait_all(self, timeout=120.0):
        """Block until every executor is alive."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            snap = self.sup.snapshot()["workers"]
            if sum(1 for w in snap.values() if w["state"] == "alive") == SUP_WORKERS:
                return
            time.sleep(0.01)
        raise AssertionError(f"phase 22: executors not alive after {timeout} s: {snap}")

    def seconds(self):
        self._stop.set()
        self._thread.join(timeout=10)
        return {k: self.alive[k] - self.first[k] for k in sorted(self.alive)}


def _supervisor(stats_dir, share, device, chaos=None):
    from spark_rapids_jni_tpu_torch.models import q67_plan
    from spark_rapids_jni_tpu_torch.models.q97 import q97_plan
    from spark_rapids_jni_tpu_torch.serve import HandlerSpec, ShuffleSpec, Supervisor
    from spark_rapids_jni_tpu_torch.serve.shuffle import (
        combine_exchange_outputs,
        combine_ordered_outputs,
        make_range_split,
        scan_table_names,
        split_tables_n,
    )

    sup = Supervisor(
        workers=SUP_WORKERS, factory="chip_smoke:supervised_worker",
        factory_kwargs={"stats_dir": stats_dir, "device": device},
        worker_cfg={"device": device, "budget_bytes": share,
                    "workers": SUP_ENGINE_WORKERS},
        chaos=chaos, queue_size=2 * SUP_HASH_REQS, default_deadline_s=900.0,
        lease_hang_s=SUP_LEASE_HANG_S, lease_max_dispatches=6)
    plan = q97_plan(SUP_Q97_CAPACITY)
    scans = scan_table_names(plan)
    for name in ("q97_shuffle", "q97_shuffle_adaptive"):
        sup.register(ShuffleSpec(name, split_n=lambda p, n: split_tables_n(p, scans, n),
                                 combine=combine_exchange_outputs(plan),
                                 fanout=SUP_WORKERS))
    q67 = q67_plan(ORDER_K, ORDER_ITEMS)
    # the splitters are sampled here, in the supervisor's process, on the card
    sup.register(ShuffleSpec("q67_shuffle", split_n=make_range_split(q67, device=device),
                             combine=combine_ordered_outputs(q67), fanout=SUP_WORKERS))
    sup.register(HandlerSpec("hash32", nbytes_of=lambda p: 16 * len(p)))
    sup.register(HandlerSpec("hash32_wide", nbytes_of=lambda p: 16 * p[0]))
    return sup


def _sup_clients(sup, sess, reqs):
    """``reqs`` [(handler, payload)] from SUP_CLIENTS threads, each waiting on
    its answer; returns (answer, seconds from submit to answer) per request."""
    from concurrent.futures import ThreadPoolExecutor

    from spark_rapids_jni_tpu_torch.serve import Backpressure

    def one(i):
        handler, payload = reqs[i]
        t0 = time.perf_counter()
        while True:
            try:
                resp = sup.submit(sess, handler, payload)
                break
            except Backpressure as e:
                time.sleep(e.retry_after_s)
        return resp.result(timeout=900), time.perf_counter() - t0

    with ThreadPoolExecutor(SUP_CLIENTS) as pool:
        return list(pool.map(one, range(len(reqs))))


def _one(sup, sess, handler, payload):
    """One request; returns its answer, its seconds and its rid."""
    t0 = time.perf_counter()
    resp = sup.submit(sess, handler, payload)
    out = resp.result(timeout=900)
    return out, time.perf_counter() - t0, resp.task_id


def _breakdown(sup, rid):
    """Where one shuffle request's time went, from the live timeline's span
    waterfall (serve/telemetry.py, obs/trace.py): per executor process, the
    map side (its compute span's start to its first transport span), the
    fetches (the transport spans' sum and their span), and the reduce (the
    last transport span's end to the compute span's end), in ms; and the
    supervisor's queue span of each child (its dispatch order).  Spans the
    timeline has not seen close within 10 s are left out; ``complete`` says
    whether it saw them all close."""
    from spark_rapids_jni_tpu_torch.obs import trace
    from spark_rapids_jni_tpu_torch.serve import fetch_view

    deadline = time.perf_counter() + 10.0
    while True:
        view = fetch_view(*sup.telemetry_endpoint())
        rec = trace.waterfall(view["timeline"]["events"]).get(str(rid))
        if (rec is not None and rec["complete"]) or time.perf_counter() > deadline:
            break
        time.sleep(0.1)
    if rec is None:
        return None
    import os

    by_pid = {}
    for x in rec["spans"]:
        if x.get("dur_ms") is not None:
            by_pid.setdefault(x["pid"], []).append(x)
    out = {"complete": rec["complete"],
           "children_queue_ms": sorted(x["dur_ms"] for x in by_pid.get(os.getpid(), [])
                                       if x["kind"] == "queue")}
    for pid, spans in by_pid.items():
        comp = [x for x in spans if x["kind"] == "compute"]
        tr = sorted((x for x in spans if x["kind"] == "transport"), key=lambda x: x["t0"])
        if pid == os.getpid() or not comp:
            continue
        c0, c1 = comp[0]["t0"], comp[0]["t0"] + comp[0]["dur_ms"] / 1e3
        line = {"compute_ms": comp[0]["dur_ms"]}
        if tr:
            t_end = max(x["t0"] + x["dur_ms"] / 1e3 for x in tr)
            line.update(map_ms=(tr[0]["t0"] - c0) * 1e3,
                        fetch_sum_ms=sum(x["dur_ms"] for x in tr),
                        fetch_span_ms=(t_end - tr[0]["t0"]) * 1e3,
                        reduce_ms=(c1 - t_end) * 1e3)
        out[str(pid)] = line
    return out


def _q97_of(out):
    return (int(out["store_only"]), int(out["catalog_only"]), int(out["both"]))


def _require_q67(what, got, want):
    for k, v in want.items():
        if not np.array_equal(np.asarray(got[k]), np.asarray(v)):
            raise AssertionError(f"phase 22 {what}: field {k} differs from the order answer")


def _lat(seconds):
    ms = [s * 1e3 for s in seconds]
    return {"requests": len(ms), "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99))}


def _transport(stats):
    """The executors' shuffle transport counters, summed: bytes and frames
    sent, fetches, CRC failures, truncations, every retry by its reason."""
    tot = {}
    for s in stats:
        for k, v in s["transport"].items():
            tot[k] = tot.get(k, 0) + v
    return {"bytes_sent": tot.get("bytes_sent", 0), "frames_sent": tot.get("frames_sent", 0),
            "bytes_fetched": tot.get("bytes_fetched", 0), "fetched": tot.get("fetched", 0),
            "crc_failures": tot.get("retry_crc", 0),
            "truncated": tot.get("retry_truncated", 0),
            "refetches": tot.get("fetch_retries", 0),
            "retries_by_reason": {k[len("retry_"):]: v for k, v in tot.items()
                                  if k.startswith("retry_")},
            "faults_injected": {k: tot.get(k, 0) for k in ("faults_corrupt", "faults_truncate")}}


def supervisor_phase(q97, q67_want, q67_tables, direct, device="cuda"):
    """Phase 22: the port's Supervisor over SUP_WORKERS executor processes
    that share the one card (each its own engine, governor and budget share,
    spawned after the parent empties its allocator's cache), driven by client
    threads: q97 at SF10 as a real cross-process hash shuffle over
    SUP_WORKERS map shards, plain then adaptive; q67 as a range shuffle; and
    SUP_HASH_REQS hash32 requests.  Then a second cluster under
    ``chaos_shuffle_config`` (corrupt, truncated and stalled frames, and
    incarnation-0 executors SIGKILLed at a seeded budget crossing) runs q97
    until one executor was killed and respawned.  Every answer is held to its
    reference: q97 to the earlier phases' oracle and ``run_exchange_plan_local``
    on the card, q67 to the order phase's answer (``q67_want``), hash32 to the
    plain version's bits.  The clean cluster must spawn exactly SUP_WORKERS
    executors and dispatch no lease twice; the chaos cluster must complete
    every lease exactly once.  ``mm_hash_long`` launches made inside the
    executors are added up from their stats files.  Prints the ``supervisor``
    line and returns the phase's launch counts (the executors')."""
    import tempfile

    from spark_rapids_jni_tpu_torch.mem.governed import PEAK_OVER_RESERVATION
    from spark_rapids_jni_tpu_torch.models.q97 import q97_plan
    from spark_rapids_jni_tpu_torch.obs.faultinj import chaos_shuffle_config
    from spark_rapids_jni_tpu_torch.ops import hash_cuda
    from spark_rapids_jni_tpu_torch.serve.shuffle import run_exchange_plan_local

    t_phase = time.perf_counter()
    store, catalog = q97["store"], q97["catalog"]
    oracle = tuple(q97["oracle"])
    tables = _q97_dicts(store, catalog)
    # the single-process oracle on the card, timed: the direct call beside
    # which the shuffle's wall stands
    t0 = time.perf_counter()
    local = _q97_of(run_exchange_plan_local(q97_plan(SUP_Q97_CAPACITY), tables, device=device))
    local_s = time.perf_counter() - t0
    if local != oracle:
        raise AssertionError(f"phase 22 run_exchange_plan_local {local} != oracle {oracle}")
    payloads = _serve_hash_payloads(SUP_HASH_REQS, SERVE_HASH_MAX_ROWS, seed=SUP_SEED)
    plain = _hash_plain(payloads, device)
    # the kernel at a map shard's shape (its q97 keys), against its plain version
    shard = np.asarray(store[0][:len(store[0]) // SUP_WORKERS], np.int64) << 32
    keys = torch.from_numpy(shard).to(device)
    err = _require_equal("phase 22 mm_hash_long at a map shard's shape",
                         hash_cuda.mm_hash_long_cuda(keys, 42),
                         hash_cuda.mm_hash_long_torch(keys, 42))
    del keys
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the parent's cache from the earlier phases
        free, total = torch.cuda.mem_get_info()
    else:
        free, total = 1 << 34, 1 << 34
    share = int(free / PEAK_OVER_RESERVATION / SUP_WORKERS)
    line = {"workers": SUP_WORKERS, "engine_workers": SUP_ENGINE_WORKERS,
            "budget_share_bytes": share, "card_free_at_spawn": free, "card_total": total,
            "q97_rows": len(store[0]) + len(catalog[0]), "q67_rows": len(
                q67_tables["store_sales"]["sid"]),
            "hash32_requests": SUP_HASH_REQS, "seed": SUP_SEED, "kernel_check_err": err}
    with tempfile.TemporaryDirectory() as clean_dir, \
            tempfile.TemporaryDirectory() as chaos_dir, _AppMemory(device == "cuda") as mem:
        # 1. the clean cluster
        t0 = time.perf_counter()
        sup = _supervisor(clean_dir, share, device)
        watch = _HelloWatch(t0).watch(sup)
        try:
            watch.wait_all()
            sess = sup.open_session("phase22", priority=1)
            q97_out, q97_s, rid = _one(sup, sess, "q97_shuffle", tables)
            spans = {"q97_shuffle": _breakdown(sup, rid)}
            ad_out, ad_s, rid = _one(sup, sess, "q97_shuffle_adaptive", tables)
            spans["q97_shuffle_adaptive"] = _breakdown(sup, rid)
            q67_out, q67_s, rid = _one(sup, sess, "q67_shuffle", q67_tables)
            spans["q67_shuffle"] = _breakdown(sup, rid)
            rng = np.random.default_rng(SUP_SEED)
            order = rng.permutation(len(payloads))
            t_hash = time.perf_counter()
            hres = _sup_clients(sup, sess, [("hash32", payloads[i]) for i in order])
            hash_s = time.perf_counter() - t_hash
            # one result of 256 MB under the default heartbeat budget: its
            # chunks leave room for the beats, so no healthy worker recycles
            wide_out, wide_s, _rid = _one(sup, sess, "hash32_wide", (SUP_WIDE_ROWS, SUP_SEED))
            clean = {"workers_spawned": sup.metrics.get("workers_spawned"),
                     "workers_dead": sup.metrics.get("workers_dead"),
                     "leases": sup.lease_stats(),
                     "shuffles_started": sup.metrics.get("shuffles_started")}
        finally:
            hello = watch.seconds()
            sup.shutdown(drain=False, timeout=60)
        clean_s = time.perf_counter() - t0
        for what, got in (("q97 over the shuffle", _q97_of(q97_out)),
                          ("adaptive q97 over the shuffle", _q97_of(ad_out))):
            if got != oracle:
                raise AssertionError(f"phase 22 {what} {got} != oracle {oracle}")
        _require_q67("q67 over the range shuffle", q67_out, q67_want)
        answers = [None] * len(payloads)
        for i, (ans, _s) in zip(order, hres):
            answers[i] = ans
        _require_same_arrays("phase 22 hash32 through the supervisor against the plain version",
                             answers, plain)
        wide_plain = hash_cuda.mm_hash_long_torch(
            _wide_keys(SUP_WIDE_ROWS, SUP_SEED, device), 42).cpu().numpy()
        _require_same_arrays("phase 22 hash32_wide (a 256 MB result) against the plain version",
                             [wide_out], [wide_plain])
        if wide_out.nbytes < 256_000_000:
            raise AssertionError(f"phase 22 hash32_wide returned {wide_out.nbytes} B")
        wide = {"rows": SUP_WIDE_ROWS, "bytes": int(wide_out.nbytes), "s": wide_s}
        del wide_out, wide_plain
        lc = clean["leases"]
        if (clean["workers_spawned"] != SUP_WORKERS or clean["workers_dead"]
                or lc["redispatched"] or lc["max_dispatches"] != 1
                or lc["completed"] != lc["leases"] or lc["outstanding"]):
            raise AssertionError(f"phase 22 clean cluster: {clean}")
        clean_stats = _worker_stats(clean_dir)
        # 2. the chaos cluster: transport weather everywhere, and executor
        # 0's first incarnation armed to die at a budget crossing.  One kill
        # at a time: a piece re-dispatched onto an executor whose engine
        # threads all wait on the dead producer's partitions would queue
        # behind them until the fetch timeout
        t0 = time.perf_counter()

        def chaos(wid, inc):
            return chaos_shuffle_config(SUP_CHAOS_SEED * 1000 + wid * 17 + inc,
                                        kill=(wid == 0 and inc == 0), kill_pct=SUP_KILL_PCT)

        sup = _supervisor(chaos_dir, share, device, chaos=chaos)
        watch = _HelloWatch(t0).watch(sup)
        try:
            watch.wait_all()
            sess = sup.open_session("phase22-chaos", priority=1)
            chaos_runs = []
            while len(chaos_runs) < SUP_CHAOS_ROUNDS and not sup.metrics.get("workers_dead"):
                out, s, _rid = _one(sup, sess, "q97_shuffle", tables)
                chaos_runs.append(s)
                if _q97_of(out) != oracle:
                    raise AssertionError(f"phase 22 chaos q97 {_q97_of(out)} != {oracle}")
            watch.wait_all()  # every killed executor respawned
            chaos_line = {"runs_s": chaos_runs,
                          "workers_spawned": sup.metrics.get("workers_spawned"),
                          "workers_dead": sup.metrics.get("workers_dead"),
                          "leases_redispatched": sup.metrics.get("leases_redispatched"),
                          "leases": sup.lease_stats()}
        finally:
            chaos_hello = watch.seconds()
            sup.shutdown(drain=False, timeout=60)
        chaos_s = time.perf_counter() - t0
        lx = chaos_line["leases"]
        if (not chaos_line["workers_dead"]
                or chaos_line["workers_spawned"] < SUP_WORKERS + chaos_line["workers_dead"]
                or lx["completed"] != lx["leases"] or lx["outstanding"]):
            raise AssertionError(f"phase 22 chaos cluster: {chaos_line}")
        chaos_stats = _worker_stats(chaos_dir)
    stats = clean_stats + chaos_stats
    bad = [s for s in stats if torch.device(s["device"]).type != torch.device(device).type]
    if bad:
        raise AssertionError(f"phase 22: executors on the wrong device: {bad}")
    launches = {k: sum(s["launches"][k] for s in stats) for k in hash_cuda.launches}
    clean_launches = sum(s["launches"]["mm_hash_long"] for s in clean_stats)
    if device == "cuda":
        # every executor launched its warm-up at least (none fell back); the
        # clean ones also one per map piece of the two q97 shuffles and at
        # least one for the hash32 requests (a batch of several rides one)
        idle = [s["pid"] for s in stats if s["launches"]["mm_hash_long"] < 1]
        want_min = SUP_WORKERS + 2 * SUP_WORKERS + 1
        if idle or clean_launches < want_min:
            raise AssertionError(f"phase 22: executors {idle} launched nothing; "
                                 f"{clean_launches} mm_hash_long launches in the clean "
                                 f"cluster, fewer than {want_min}")
    if mem.peak_sum * (1 << 20) > total:
        raise AssertionError(f"phase 22: the card's processes held {mem.peak_sum} MiB, "
                             f"more than its {total} B")
    hash_lat = [s for _a, s in hres]
    print(json.dumps({"supervisor_launches": launches}))
    print(json.dumps({"supervisor": {
        **line,
        "spawn_to_hello_s": hello, "chaos_spawn_to_hello_s": chaos_hello,
        "handlers": {"hash32": _lat(hash_lat),
                     "q97_shuffle": {"s": q97_s}, "q97_shuffle_adaptive": {"s": ad_s},
                     "q67_shuffle": {"s": q67_s}},
        "hash32_stage_s": hash_s, "hash32_wide": wide, "spans_ms": spans,
        "q97_shuffle_s": q97_s, "q97_local_exchange_s": local_s, **direct,
        "transport": _transport(clean_stats), "chaos_transport": _transport(chaos_stats),
        "clean": clean, "chaos": chaos_line,
        "worker_peak_bytes": {str(s["pid"]): {"allocated": s.get("max_allocated"),
                                              "reserved": s.get("max_reserved")}
                              for s in stats},
        "nvidia_smi_peak_mib": {"sum": mem.peak_sum, "per_pid": mem.per_pid,
                                "samples": mem.samples},
        "worker_launches": {str(s["pid"]): s["launches"]["mm_hash_long"] for s in stats},
        "clean_mm_hash_long": clean_launches,
        "stages_s": {"clean": clean_s, "chaos": chaos_s},
        "seconds": time.perf_counter() - t_phase}}))
    return launches


def _q67_batch():
    from spark_rapids_jni_tpu_torch.models import make_q67_tables

    return make_q67_tables(ORDER_ROWS, ORDER_ITEMS, ORDER_CATS, seed=ORDER_SEED)


def supervisor_alone(device="cuda"):
    """Phase 22 by itself: builds the kernels, makes the SF10 q97 tables and
    their oracle and the order phase's q67 batch and answer, then runs it.
    ``python3 -c "import chip_smoke as c; c.supervisor_alone()"``."""
    from spark_rapids_jni_tpu_torch.models import q67_plan
    from spark_rapids_jni_tpu_torch.models.tpcds import generate_q97_tables
    from spark_rapids_jni_tpu_torch.serve.shuffle import run_range_plan_local

    if device == "cuda":
        build()
    store, catalog = generate_q97_tables(sf=Q97_SF, seed=42)
    q97 = {"store": store, "catalog": catalog, "oracle": q97_oracle(store, catalog)}
    q67_tables = _q67_batch()
    q67_want = run_range_plan_local(q67_plan(ORDER_K, ORDER_ITEMS), q67_tables, device=device)
    return supervisor_phase(q97, q67_want, q67_tables, {}, device=device)


# ---- phase 23: the launched ranks (multi-host) -------------------------------

MH_ARGS = ["--sf", "10", "--verify"]  # the harness in memory at SF10 (seed 42); then C5_ARGS
MH_MONTE_CARLO = dict(n_tasks=6, budget_frac=0.6, seed=0)
MH_TIMEOUT_S = 300.0  # a rank still running after this fails the phase
_MH_TIMING_KEYS = ("wall_s", "Mrows_per_s", "total_wall_s")


def multihost_rank(out_dir, device=None):
    """One rank of phase 23, started with a launcher's environment: joins the
    group through ``initialize`` (NCCL on LOCAL_RANK's card), runs the
    harness's ``main`` with MH_ARGS and then streamed with C5_ARGS (its mesh
    ``make_pod_mesh(mp=1)`` over the ranks), then ``run_q97_monte_carlo``
    over the ranks, and writes its lines, timings and ``mm_hash_long``
    launches to ``out_dir/rank<RANK>.json``.  ``device="cpu"`` runs it on
    gloo (a rehearsal)."""
    import contextlib
    import io as _io
    import os

    import torch.distributed as dist

    from spark_rapids_jni_tpu_torch.mem.montecarlo import run_q97_monte_carlo
    from spark_rapids_jni_tpu_torch.models import nds_harness
    from spark_rapids_jni_tpu_torch.ops import hash_cuda
    from spark_rapids_jni_tpu_torch.parallel import initialize_multihost, is_multihost
    from spark_rapids_jni_tpu_torch.parallel.multihost import process_summary

    rank = int(os.environ["RANK"])
    initialize_multihost(device=device)
    group_s = time.time() - float(os.environ["MH_SPAWN_T"])
    hash_cuda.reset_launches()
    lines, harness_s, harness_launches, rc = {}, {}, {}, 0
    for mode, args in (("memory", MH_ARGS), ("streamed", C5_ARGS)):
        printed = _io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc |= nds_harness.main(args, device=device)
        harness_s[mode] = time.perf_counter() - t0
        lines[mode] = json.loads(printed.getvalue().strip().splitlines()[-1])
        harness_launches[mode] = hash_cuda.launches["mm_hash_long"] - sum(
            harness_launches.values())
    t0 = time.perf_counter()
    stats = run_q97_monte_carlo(**MH_MONTE_CARLO, device=device)
    card = str(torch.cuda.current_device()) if device is None else str(rank)
    out = {"rank": rank, "pid": os.getpid(), "device": card,
           "summary": process_summary(), "multihost": is_multihost(),
           "spawn_to_group_s": group_s, "rc": rc, "harness_s": harness_s,
           "lines": lines, "harness_launches": harness_launches,
           "monte_carlo": {**dataclasses.asdict(stats), "ok": stats.ok,
                           "s": time.perf_counter() - t0},
           "launches": dict(hash_cuda.launches)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch_ranks(world, out_dir, device):
    """``world`` rank processes with a launcher's environment (one per card,
    NCCL on loopback), each running :func:`multihost_rank`; waits for all of
    them, and kills the rest and raises when one fails or the bound passes."""
    import os

    port, procs = _free_port(), []
    here = os.path.dirname(os.path.abspath(__file__))
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
               "NCCL_SOCKET_IFNAME": "lo", "MH_SPAWN_T": repr(time.time())}
        log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.multihost_rank({out_dir!r}, {device!r})"],
            cwd=here, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.perf_counter() + MH_TIMEOUT_S
    try:
        while any(p.poll() is None for p, _ in procs):
            bad = [i for i, (p, _) in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.perf_counter() > deadline:
                why = f"ranks {bad} exited non-zero" if bad else f"ranks still running " \
                    f"after {MH_TIMEOUT_S} s"
                raise AssertionError(f"phase 23: {why}")
            time.sleep(0.2)
        bad = [i for i, (p, _) in enumerate(procs) if p.returncode != 0]
        if bad:
            raise AssertionError(f"phase 23: ranks {bad} exited non-zero")
    except AssertionError:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
        for i, (p, log) in enumerate(procs):
            p.wait(timeout=30)
            log.close()
            with open(os.path.join(out_dir, f"rank{i}.log")) as f:
                print(f"phase 23 rank {i} (exit {p.returncode}):", f.read()[-3000:],
                      file=sys.stderr)
        raise
    for _, log in procs:
        log.close()
    out = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
            out.append(json.load(f))
    return out


def _without_timing(line):
    if isinstance(line, dict):
        return {k: _without_timing(v) for k, v in line.items() if k not in _MH_TIMING_KEYS}
    return line


def multihost_phase(q97, device=None):
    """Phase 23: ``torch.cuda.device_count()`` rank processes launched as
    ``torchrun`` launches them, each joining the group through
    ``initialize``, running the NDS harness at SF10 in memory and then
    streamed (config 5's C5_ARGS) over ``make_pod_mesh(mp=1)``, and then
    ``run_q97_monte_carlo`` over the ranks.  Every rank's lines must be
    verified and equal to the others' (timings aside); q97's counts in
    memory the numpy oracle of the distributed phase's SF10 tables
    (``q97["oracle"]``: the harness generates the same tables) and streamed
    C5_Q97_COUNTS (the chunk generator's); q5 40 rows; the monte-carlo ok on
    every rank with one data-axis group per task; every rank on its own
    card.  Prints the ``multihost`` line and returns the ranks' launch
    counts, added up.  ``device="cpu"`` rehearses it on two gloo ranks."""
    import tempfile

    from spark_rapids_jni_tpu_torch.ops import hash_cuda

    world = torch.cuda.device_count() if device is None else 2
    if device is None:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()  # the parent's cache: the ranks need the card
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        ranks = _launch_ranks(world, out_dir, device)
    seconds = time.perf_counter() - t0
    oracle = [int(x) for x in q97["oracle"]]
    want = {"memory": oracle, "streamed": C5_Q97_COUNTS}
    for r in ranks:
        mc = r["monte_carlo"]
        for mode, line in r["lines"].items():
            qs = line["queries"]
            if r["rc"] != 0 or any(q["verified"] is not True for q in qs.values()):
                raise AssertionError(f"phase 23 rank {r['rank']} {mode}: not verified: {line}")
            if line["ndev"] != world or qs["q97"]["counts"] != want[mode]:
                raise AssertionError(f"phase 23 rank {r['rank']} {mode}: ndev {line['ndev']}, "
                                     f"q97 {qs['q97']['counts']} against {want[mode]}")
            if qs["q5"]["result_rows"] != C5_Q5_ROWS or qs["q97"]["fact_rows"] != C5_ROWS_IN:
                raise AssertionError(f"phase 23 rank {r['rank']} {mode}: q5 "
                                     f"{qs['q5']['result_rows']} rows, q97 read "
                                     f"{qs['q97']['fact_rows']}")
            if device is None and r["harness_launches"][mode] < 1:
                raise AssertionError(f"phase 23 rank {r['rank']} {mode} launched no kernel")
        if not (mc["ok"] and mc["tasks_completed"] == MH_MONTE_CARLO["n_tasks"]
                and mc["data_groups"] == MH_MONTE_CARLO["n_tasks"]):
            raise AssertionError(f"phase 23 rank {r['rank']}: monte-carlo {mc}")
        if r["summary"]["process_count"] != world or r["multihost"] != (world > 1):
            raise AssertionError(f"phase 23 rank {r['rank']}: {r['summary']}")
        if any(v for k, v in r["launches"].items() if k != "mm_hash_long"):
            raise AssertionError(f"phase 23 rank {r['rank']} launched {r['launches']}")
    lines = [_without_timing(r["lines"]) for r in ranks]
    if any(line != lines[0] for line in lines):
        raise AssertionError(f"phase 23: the ranks' lines differ: {lines}")
    if sorted(r["device"] for r in ranks) != [str(i) for i in range(world)]:
        raise AssertionError(f"phase 23: ranks on cards {[r['device'] for r in ranks]}")
    launches = {k: sum(r["launches"].get(k, 0) for r in ranks) for k in hash_cuda.launches}
    print(json.dumps({"multihost_launches": launches}))
    modes = {}
    for mode in ("memory", "streamed"):
        qs = ranks[0]["lines"][mode]["queries"]
        modes[mode] = {
            "args": MH_ARGS if mode == "memory" else C5_ARGS,
            "harness_s": [r["harness_s"][mode] for r in ranks],
            "queries": {q: {"wall_s": [r["lines"][mode]["queries"][q]["wall_s"] for r in ranks],
                            "Mrows_per_s": [r["lines"][mode]["queries"][q]["Mrows_per_s"]
                                            for r in ranks],
                            "fact_rows": qs[q]["fact_rows"],
                            "peak_reserved_bytes": qs[q]["peak_reserved_bytes"],
                            **({"streamed": qs[q]["streamed"]} if "streamed" in qs[q] else {})}
                        for q in qs},
            "q97_counts": qs["q97"]["counts"], "q5_result_rows": qs["q5"]["result_rows"],
            "q3_result_rows": qs["q3"]["result_rows"],
            "mm_hash_long": [r["harness_launches"][mode] for r in ranks]}
    print(json.dumps({"multihost": {
        "world": world, "seconds": seconds,
        "spawn_to_group_s": [r["spawn_to_group_s"] for r in ranks], "harness": modes,
        "monte_carlo": [{k: r["monte_carlo"][k] for k in
                         ("ok", "tasks_completed", "data_groups", "leaked_bytes",
                          "blocked_at_end", "s")} for r in ranks],
        "rank_mm_hash_long": [r["launches"]["mm_hash_long"] for r in ranks],
        "summary": ranks[0]["summary"]}}))
    return launches


def multihost_alone():
    """Phase 23 by itself: builds the kernels and makes the SF10 q97 tables'
    oracle, then runs it.  ``python3 -c "import chip_smoke as c;
    c.multihost_alone()"``."""
    from spark_rapids_jni_tpu_torch.models.tpcds import generate_q97_tables

    build()
    store, catalog = generate_q97_tables(sf=Q97_SF, seed=42)
    return multihost_phase({"oracle": q97_oracle(store, catalog)})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    from spark_rapids_jni_tpu_torch.models import QueryStepConfig

    cfg = QueryStepConfig(n_buckets=1024, bloom_bits=8_388_608, bloom_hashes=6)
    seconds, clock = {}, [time.perf_counter()]

    def lap(name):  # the seconds each phase took, printed before the kernels line
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now

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
    lap("build_step_hashes")

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
    lap("column_hash")

    from spark_rapids_jni_tpu_torch.parallel import one_rank_mesh

    with one_rank_mesh("cuda") as mesh:  # one NCCL group for the next three phases
        dist_counts, q97 = distributed(mesh, cfg)
        lap("distributed")
        plan_counts, gp = plans(mesh, q97)
        lap("plans")
        gov_counts = governed(mesh, q97, gp)
        lap("governed")
    path_counts = [counts, col_counts, dist_counts, plan_counts, gov_counts]
    for name, phase in (("bloom", bloom), ("decimal", decimal),
                        ("rows", lambda: jcudf_rows(rates)), ("casts", lambda: casts(rates))):
        path_counts.append(phase())
        lap(name)
    order_counts, q67 = order(gp)
    path_counts.append(order_counts)
    lap("order")
    json_counts, json_head = json_phase(rates)
    path_counts.append(json_counts)
    lap("json")
    path_counts.append(config5())
    lap("config5")
    path_counts.append(ops_tail(rates))
    lap("ops_tail")
    with one_rank_mesh("cuda") as mesh:
        path_counts.append(observability(mesh, q97, json_head))
        lap("observability")
        serve_counts, direct = serve_phase(mesh, q97, gp, json_head)
        path_counts.append(serve_counts)
    lap("serve")
    path_counts.append(supervisor_phase(q97, q67["want"], q67["tables"], direct))
    lap("supervisor")
    path_counts.append(multihost_phase(q97))
    lap("multihost")
    print(json.dumps({"phase_seconds": seconds, "total": sum(seconds.values())}))
    for row in rows:  # the main path is now all seventeen paths: their launches add up
        row["launches"] = sum(c[row["name"]] for c in path_counts)
    print(_nvidia_smi("name,power.limit", units=True))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
