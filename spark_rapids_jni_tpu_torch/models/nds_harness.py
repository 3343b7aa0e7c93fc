"""NDS end-to-end harness: governed q5 + q97 (+ q3) over TPC-DS-shaped data
(PyTorch port of ``models/nds_harness.py``).

BASELINE config 5 is "NDS TPC-DS q5+q97 end-to-end"; this CLI is its
harness: generate tables at a scale factor, run the queries distributed +
governed (every launch admitted through the memory arbiter), verify against
host oracles, and report wall-clock.  q3 (star join + grouped agg) rides
along as the third query pattern.

    python -m spark_rapids_jni_tpu_torch.models.nds_harness --sf 100 --verify \\
        --stream-chunk-rows 1000000 --buckets 128

Prints one JSON line (the JAX harness's keys): per-query wall-clock, rows
processed, verification status.  One process drives one card (NCCL takes one
rank per card; gloo when :func:`main` is given ``device="cpu"``).  Alone, it
runs over a (1, 1) mesh on a one-rank group it makes; launched as ranks, it
joins their group through ``parallel.multihost.initialize`` and runs over
``make_pod_mesh(mp=1)``::

    torchrun --nproc_per_node 4 -m spark_rapids_jni_tpu_torch.models.nds_harness \\
        --sf 10 --verify

Every rank generates the same tables from ``--seed`` and runs its own data
block of each query, which ``plans.upload_inputs`` lays out on its device
(``plans.pad_tables`` + ``plans.plan_inputs`` define that layout and are its
oracle); every rank prints the line, with
``"ndev"`` the world size.  Streamed, every rank stages the buckets in a
temporary directory of its own and walks them in the same order, its host
reservations agreed over the data axis, so the ranks split the same buckets
on disk and issue the same collectives.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

__all__ = ["main", "q97_parquet_chunks"]


def _q97_tables(sf: float, seed: int):
    from spark_rapids_jni_tpu_torch.models.tpcds import generate_q97_tables

    return generate_q97_tables(sf, seed)


def q97_parquet_chunks(input_dir: str, n_splits: int):
    """Stream the q97 fact pair from parquet as ``(side, cust, item)``
    chunks, ONE ROW GROUP AT A TIME -- the composition of the footer
    planner with the out-of-core shuffle.

    Every file is cut into footer-planned byte-range splits (each row
    group belongs to exactly one split, so iterating every split sees
    each row exactly once); the thrift footer filter (io/parquet_footer.py
    midpoint rule) decides which row groups each split reads, the schema
    prune limits decoding to the two join keys (money columns never
    materialize -- NativeParquetJni.cpp:584 filter_groups feeding the
    columnar reader), and host memory is bounded by one row group.
    NULL keys are excluded (q97_host_oracle semantics) -- this generator
    is the single owner of that filter for both --input modes.
    """
    import numpy as np

    from spark_rapids_jni_tpu_torch.io import (
        StructElement,
        ValueElement,
        iter_split_batches,
        plan_byte_splits,
    )

    for name, prefix, side in (("store_sales", "ss", "store"),
                               ("catalog_sales", "cs", "catalog")):
        path = os.path.join(input_dir, f"{name}.parquet")
        schema = (StructElement.builder()
                  .add_child(f"{prefix}_customer_sk", ValueElement())
                  .add_child(f"{prefix}_item_sk", ValueElement())
                  .build())
        for off, length in plan_byte_splits(path, n_splits):
            for batch in iter_split_batches(path, off, length, schema,
                                            as_numpy=True):
                cust, cust_valid = batch[f"{prefix}_customer_sk"]
                item, item_valid = batch[f"{prefix}_item_sk"]
                cust = np.asarray(cust)
                item = np.asarray(item)
                keep = cust_valid
                if item_valid is not None:
                    keep = item_valid if keep is None else keep & item_valid
                if keep is not None:
                    cust, item = cust[keep], item[keep]
                yield (side,
                       cust.astype(np.int32, copy=False),
                       item.astype(np.int32, copy=False))


def _q97_tables_from_parquet(input_dir: str, n_splits: int):
    """Materialize the q97 fact pair from parquet (the in-memory --input
    mode): a per-side concatenate over :func:`q97_parquet_chunks`, so the
    footer planning / pruning / NULL-key semantics have one owner."""
    import numpy as np

    parts = {"store": ([], []), "catalog": ([], [])}
    for side, cust, item in q97_parquet_chunks(input_dir, n_splits):
        parts[side][0].append(cust)
        parts[side][1].append(item)

    def cat(side):
        custs, items = parts[side]
        return (np.concatenate(custs) if custs else np.zeros(0, np.int32),
                np.concatenate(items) if items else np.zeros(0, np.int32))

    return cat("store"), cat("catalog")


@contextlib.contextmanager
def _mesh(dev):
    """The harness's mesh on ``dev``: ``make_pod_mesh(mp=1)`` over every rank
    of the process group when one is up (the launch's, or the caller's),
    else a (1, 1) mesh over a one-rank group made (and taken down) here."""
    import torch.distributed as dist

    from spark_rapids_jni_tpu_torch.parallel import make_pod_mesh, one_rank_mesh

    if dist.is_initialized():
        yield make_pod_mesh(mp=1, device=dev)
        return
    with one_rank_mesh(dev) as mesh:
        yield mesh


def main(argv=None, *, device=None) -> int:
    """The CLI.  ``device`` (in-process callers only) picks where the
    queries run: the card unless it is ``"cpu"``."""
    ap = argparse.ArgumentParser(
        description="NDS q5+q97 (+q3) end-to-end harness")
    ap.add_argument("--sf", type=float, default=0.05)
    ap.add_argument("--ndev", type=int, default=0,
                    help="0 = all ranks; one rank drives one card, so 0 or the "
                         "world size")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--verify", action="store_true",
                    help="check results against host oracles (slow at big sf)")
    ap.add_argument("--input", default="",
                    help="read the q97 fact pair from parquet files in DIR "
                         "(tpcds.write_q97_parquet layout); each file is "
                         "split-planned through io/parquet_footer")
    ap.add_argument("--splits", type=int, default=2,
                    help="byte-range splits per parquet file (--input mode)")
    ap.add_argument("--stream-chunk-rows", type=int, default=0,
                    help="run q5+q97 out-of-core: facts flow in bounded "
                         "chunks through disk grace-hash buckets "
                         "(models/streaming.py); 0 = in-memory.  Generated "
                         "facts chunk at this many rows; with --input, q97 "
                         "chunks at parquet row-group granularity instead")
    ap.add_argument("--buckets", type=int, default=16,
                    help="key-space buckets for --stream-chunk-rows mode")
    args = ap.parse_args(argv)

    from spark_rapids_jni_tpu_torch import device as _device
    from spark_rapids_jni_tpu_torch.parallel import initialize_multihost

    dev = _device.resolve(device)
    # join the launch's process group first: across ranks the harness must
    # span every rank's card, not run once per rank
    initialize_multihost(device=dev)
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if args.ndev not in (0, world):
        ap.error(f"--ndev: one rank drives one card, so 0 or the world size ({world})")
    with _mesh(dev) as mesh:
        out = _run(args, mesh, dev, world)
    print(json.dumps(out))
    failed = any(q.get("verified") is False for q in out["queries"].values())
    return 1 if failed else 0


def _run(args, mesh, dev, world) -> dict:
    """The three queries on ``mesh``; the JSON object ``main`` prints."""
    from spark_rapids_jni_tpu_torch.mem import BudgetedResource, MemoryGovernor
    from spark_rapids_jni_tpu_torch.models import (
        generate_q3_data,
        generate_q5_data,
        q3_local,
        q5_local,
        run_distributed_q3,
        run_distributed_q5,
        run_distributed_q97,
    )

    gov = MemoryGovernor.initialize()
    budget = BudgetedResource(gov, 8 << 30)
    out = {"sf": args.sf, "ndev": world, "queries": {}}
    if args.input:
        out["input"] = args.input
        out["splits_per_file"] = args.splits

    try:
        budget.reset_peak()
        if args.stream_chunk_rows > 0:
            from spark_rapids_jni_tpu_torch.models.streaming import (
                generate_q5_chunks,
                generate_q97_chunks,
                run_streaming_q5,
                run_streaming_q97,
            )

            # host-side bucket staging is governed through the arbiter's
            # CPU path, like the reference's is_for_cpu ladder; one budget
            # PER QUERY so each reported host peak is that query's own
            def host_budget():
                return BudgetedResource(gov, 4 << 30, is_cpu=True)

            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="nds_q5_shuffle_") as td:
                q5_rows, q5_ok, q5_stats = run_streaming_q5(
                    mesh,
                    generate_q5_chunks(args.sf, args.seed,
                                       args.stream_chunk_rows),
                    tmpdir=td, n_buckets=args.buckets, budget=budget,
                    host_budget=host_budget(), task_id=1,
                    verify=args.verify)
            q5_dt = time.perf_counter() - t0
            q5_rows_total = q5_stats["rows_in"]
            out["queries"]["q5"] = {
                "wall_s": round(q5_dt, 3),
                "fact_rows": q5_rows_total,
                "Mrows_per_s": round(q5_rows_total / q5_dt / 1e6, 2),
                "result_rows": len(q5_rows),
                "verified": q5_ok,
                "streamed": q5_stats,
                "peak_reserved_bytes": budget.reset_peak(),
            }
        else:
            data = generate_q5_data(sf=args.sf, seed=args.seed)
            q5_rows_total = sum(
                len(ch.sales_sk) + len(ch.ret_sk)
                for ch in data.channels.values())
            t0 = time.perf_counter()
            q5_rows = run_distributed_q5(mesh, data, budget=budget, task_id=1)
            q5_dt = time.perf_counter() - t0
            q5_ok = (q5_rows == q5_local(data, device=dev)) if args.verify else None
            out["queries"]["q5"] = {
                "wall_s": round(q5_dt, 3),
                "fact_rows": q5_rows_total,
                "Mrows_per_s": round(q5_rows_total / q5_dt / 1e6, 2),
                "result_rows": len(q5_rows),
                "verified": q5_ok,
                "peak_reserved_bytes": budget.reset_peak(),
            }

        if args.stream_chunk_rows > 0:
            if args.input:
                # footer-planned parquet scan feeding the disk shuffle:
                # chunk = one surviving row group per byte-range split
                q97_chunks = q97_parquet_chunks(args.input, args.splits)
            else:
                q97_chunks = generate_q97_chunks(args.sf, args.seed,
                                                 args.stream_chunk_rows)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(prefix="nds_shuffle_") as td:
                counts, q97_ok, stats = run_streaming_q97(
                    mesh, q97_chunks,
                    tmpdir=td, n_buckets=args.buckets, budget=budget,
                    host_budget=host_budget(), task_id=2, verify=args.verify)
            q97_dt = time.perf_counter() - t0
            nq = stats["rows_in"]
            out["queries"]["q97"] = {
                "wall_s": round(q97_dt, 3),
                "fact_rows": nq,
                "Mrows_per_s": round(nq / q97_dt / 1e6, 2),
                "counts": list(counts),
                "verified": q97_ok,
                "streamed": stats,
                "peak_reserved_bytes": budget.reset_peak(),
            }
        else:
            if args.input:
                store, catalog = _q97_tables_from_parquet(args.input,
                                                          args.splits)
            else:
                store, catalog = _q97_tables(args.sf, args.seed)
            nq = len(store[0]) + len(catalog[0])
            t0 = time.perf_counter()
            q97 = run_distributed_q97(mesh, store, catalog, budget=budget,
                                      task_id=2)
            q97_dt = time.perf_counter() - t0
            q97_ok = None
            if args.verify:
                from spark_rapids_jni_tpu_torch.models.streaming import _distinct_counts

                q97_ok = (int(q97.store_only), int(q97.catalog_only),
                          int(q97.both)) == _distinct_counts(store, catalog)
            out["queries"]["q97"] = {
                "wall_s": round(q97_dt, 3),
                "fact_rows": nq,
                "Mrows_per_s": round(nq / q97_dt / 1e6, 2),
                "counts": [int(q97.store_only), int(q97.catalog_only),
                           int(q97.both)],
                "verified": q97_ok,
                "peak_reserved_bytes": budget.reset_peak(),
            }

        q3_data = generate_q3_data(sf=args.sf, seed=args.seed)
        n3 = len(q3_data.ss_item_sk)
        t0 = time.perf_counter()
        q3_rows = run_distributed_q3(mesh, q3_data, budget=budget, task_id=3)
        q3_dt = time.perf_counter() - t0
        q3_ok = (q3_rows == q3_local(q3_data, device=dev)) if args.verify else None
        out["queries"]["q3"] = {
            "wall_s": round(q3_dt, 3),
            "fact_rows": n3,
            "Mrows_per_s": round(n3 / q3_dt / 1e6, 2),
            "result_rows": len(q3_rows),
            "verified": q3_ok,
            "peak_reserved_bytes": budget.reset_peak(),
        }
        out["total_wall_s"] = round(q5_dt + q97_dt + q3_dt, 3)
    finally:
        MemoryGovernor.shutdown()
    return out


if __name__ == "__main__":
    sys.exit(main())
