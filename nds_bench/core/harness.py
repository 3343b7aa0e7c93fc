"""One run of one cell: set-up, the measured window, the check of every
answer against the plain reference, and the result line.

The result is the last line of standard output, one JSON object.  The
numbers the check compares are also the last lines of standard error, each
beside its limit.  A run prints no result, and exits with another code than
0, where the card or the cards the cell asks for are missing, or where a
module of JAX or of the JAX package is loaded once the window has closed.

A traffic mix with ``"ranks": n`` runs the cell as ``n`` processes, one a
card: the command's own process is rank 0, starts the others with a
launcher's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), gathers their tasks and checks, and alone
prints the result.  Each rank's task thread ``t`` runs the same pool tasks
in the same order as every other rank's, and the ranks agree before each
task whether the window is still open, so that a task's collectives always
find every rank.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from nds_bench.core import registry
from nds_bench.core.imports import forbidden_modules
from nds_bench.core.loop import TaskRecord, TaskThreads
from nds_bench.core.trace import WINDOW_RANGE, Summary

WARM_TASK_ID = 1
WINDOW_TASK_ID = 1_000_000


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""

    window_s: float
    setup_s: float
    done: List[TaskRecord]  # answered inside the window, without error
    phases: Dict[str, float]
    peak_alloc_bytes: Optional[int]
    trace: Optional[Summary]  # rank 0's, its busy_s the mean over the ranks' cards
    rates: tuple
    hash_kernel: Optional[str]
    chips: int = 1


def init_group(device, rank: int = 0, world: int = 1) -> None:
    """The process group: one rank of its own, or ``world`` ranks met through
    the launcher's environment.  NCCL on a card, gloo on the CPU."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    if dev.type == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if world == 1:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)


def thread_meshes(threads: int, device) -> list:
    """One (ranks, 1) mesh per task thread on process groups of the thread's
    own, made on every rank in the same order, so that no two concurrent
    tasks share a communicator."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from spark_rapids_jni_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    world, rank = dist.get_world_size(), dist.get_rank()
    layout = torch.arange(world, dtype=torch.int64).reshape(world, 1)
    out = []
    for _ in range(threads):
        data = dist.new_group(list(range(world)))
        model = None
        for r in range(world):  # every rank makes every rank's model group
            g = dist.new_group([r])
            if r == rank:
                model = g
        out.append(DeviceMesh.from_group([data, model], torch.device(device).type,
                                         mesh=layout, mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))
    return out


def _agreements(threads: int) -> list:
    """Per task thread, the function by which the ranks agree whether the
    window is open for one more task: open only where it is open on every
    rank (a gloo group of the thread's own)."""
    import torch
    import torch.distributed as dist

    def agree(group):
        def f(go: bool) -> bool:
            flag = torch.tensor([1 if go else 0])
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=group)
            return bool(flag.item())
        return f

    return [agree(dist.new_group(backend="gloo")) for _ in range(threads)]


def _card(device) -> dict:
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "sms": 0}
    index = dev.index or 0
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(index), "count": 1,
            "sms": torch.cuda.get_device_properties(index).multi_processor_count}


def run_cell(cell: registry.Cell, seed: int, seconds: float, trace: bool,
             process_start: float, device="cuda", rates=None, rank: int = 0,
             world: int = 1) -> Optional[dict]:
    """One run of ``cell`` as rank ``rank`` of ``world``; rank 0 returns the
    result, with the numbers it compared last (``checks``), and every other
    rank None.  ``process_start`` is the process's start on the monotonic
    clock.  ``rates`` (memory bytes/s, integer instructions/s) default to the
    card's."""
    import torch
    import torch.distributed as dist

    from spark_rapids_jni_tpu_torch.mem.governed import task_context
    from spark_rapids_jni_tpu_torch.mem.governor import MemoryGovernor
    from spark_rapids_jni_tpu_torch.plans.runtime import PHASES

    cuda = torch.device(device).type == "cuda"
    card_index = torch.device(device).index or 0
    if cuda:
        torch.cuda.set_device(card_index)
    card = _card(device)
    if rates is None:
        from nds_bench.core.bounds import card_rates

        rates = card_rates(card["kind"], card["sms"])
    q, traffic, config = cell.query, cell.traffic, cell.config
    threads = int(traffic["threads"])
    pool = q.make_pool(config, traffic, seed, device, rank=rank, world=world)
    if cuda:  # the peak is the program's, not the generator's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    least = [q.least_bytes(t, config) for t in pool.tasks]
    if q.NEEDS_MESH or world > 1:
        init_group(device, rank, world)
    meshes = thread_meshes(threads, device) if q.NEEDS_MESH else [None] * threads
    agree = _agreements(threads) if world > 1 else None
    everyone = dist.new_group(backend="gloo") if world > 1 else None
    gov = MemoryGovernor.instance()
    runner = q.open_runner(config, traffic, pool, meshes, device, gov)
    loop = TaskThreads(runner.run, pool.tasks, threads, gov, task_context,
                       offset=seed % len(pool.tasks), rows_of=lambda t: t["rows"],
                       thread_init=(lambda: torch.cuda.set_device(card_index))
                       if cuda else None, agree=agree)
    loop.warm(int(traffic.get("warmup_tasks_per_thread", 1)), WARM_TASK_ID)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    sync()
    if everyone is not None:
        dist.barrier(group=everyone)
    PHASES.reset()
    peak_setup = torch.cuda.max_memory_allocated() if cuda else None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if trace:
        from nds_bench.core.trace import profiler

        prof = profiler(cuda)
        prof.__enter__()
    window = torch.profiler.record_function(WINDOW_RANGE)
    window.__enter__()
    t_start = time.perf_counter()
    setup_s = time.monotonic() - process_start
    t_end = t_start + seconds
    join = loop.window(t_end, WINDOW_TASK_ID)
    time.sleep(max(0.0, t_end - time.perf_counter()))
    window.__exit__(None, None, None)
    join()
    sync()
    summary = None
    if prof is not None:
        from nds_bench.core.trace import events_of, summarize

        prof.__exit__(None, None, None)
        summary = summarize(events_of(prof))
        del prof
    phases = PHASES.snapshot()
    peak_window = torch.cuda.max_memory_allocated() if cuda else None
    runner.close()
    del runner, loop.run
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    records = sorted(loop.records, key=lambda r: r.seq)
    for r in records:
        r.rank, r.least_bytes = rank, least[r.pool_index]

    # the check: every answer that came, against the plain reference
    indices = sorted({r.pool_index for r in records if r.error is None})
    want = dict(zip(indices, cell.reference.answers(
        [pool.tasks[i] for i in indices], pool.shared, config, device)))
    wrong = sum(1 for r in records if r.error is None and r.answer != want[r.pool_index])
    failed = sum(1 for r in records if r.error is not None)
    mine = {"records": [dataclasses.replace(r, answer=None) for r in records],
            "t_end": t_end, "wrong": wrong, "failed": failed, "phases": phases,
            "peaks": [p for p in (peak_setup, peak_window) if p is not None],
            "peak_window": peak_window,
            "busy_s": summary.busy_s if summary is not None else None}
    ranks = [mine]
    if everyone is not None:
        ranks = [None] * world
        dist.all_gather_object(ranks, mine, group=everyone)
    if dist.is_initialized():
        dist.destroy_process_group()
    if rank != 0:
        return None
    records = [r for part in ranks for r in part["records"]]
    done = [r for part in ranks for r in part["records"]
            if r.error is None and r.t1 <= part["t_end"]]
    wrong, failed = sum(p["wrong"] for p in ranks), sum(p["failed"] for p in ranks)
    phases = {k: sum(p["phases"].get(k, 0.0) for p in ranks)
              for k in {k for p in ranks for k in p["phases"]}}
    if summary is not None:
        summary = dataclasses.replace(
            summary, busy_s=sum(p["busy_s"] for p in ranks) / len(ranks))
    windows = [p["peak_window"] for p in ranks if p["peak_window"] is not None]
    data = RunData(seconds, setup_s, done, phases, max(windows) if windows else None,
                   summary, rates, q.HASH_KERNEL, chips=cell.chips)
    checks = {
        "wrong_answers": {"value": wrong, "limit": 0},
        "failed_tasks": {"value": failed, "limit": 0},
        "tasks_answered_in_window": {"value": len(done), "min": 1},
    }
    correct = wrong == 0 and failed == 0 and len(done) >= 1

    metrics = {}
    for m in (cell.per_layer() if trace else cell.end_to_end()):
        value = m.reader.read(data)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    dev = {k: v for k, v in card.items() if k != "sms"}
    dev["count"] = cell.chips
    peaks = [x for p in ranks for x in p["peaks"]]
    dev["memory_peak_bytes"] = max(peaks) if peaks else 0
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                               "idle_gaps": [list(x) for x in summary.idle_gaps]}
    result["checks"] = checks
    return result


def _check_lines(checks: dict) -> List[str]:
    out = []
    for name, c in checks.items():
        limit = f"<= {c['limit']}" if "limit" in c else f">= {c['min']}"
        out.append(f"check {name} {c['value']} {limit}")
    return out


RANK_ENV = "NDS_BENCH_RANK"  # set in the processes rank 0 starts


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_ranks(command: List[str], world: int) -> List[subprocess.Popen]:
    """Start ranks 1 to ``world - 1`` of ``command`` with a launcher's
    environment, and give this process, rank 0, the same."""
    common = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
              "WORLD_SIZE": str(world)}
    os.environ.update(common, RANK="0", LOCAL_RANK="0")
    return [subprocess.Popen(command, stdout=subprocess.DEVNULL,
                             env=dict(os.environ, **common, RANK=str(r), LOCAL_RANK=str(r),
                                      **{RANK_ENV: str(r)}))
            for r in range(1, world)]


def _stop(children: List[subprocess.Popen], grace_s: float = 0.0) -> List[Optional[int]]:
    """Wait up to ``grace_s`` for the ranks rank 0 started, end those still
    running, and return their exit codes."""
    deadline = time.monotonic() + grace_s
    for c in children:
        try:
            c.wait(max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            c.kill()
            c.wait()
    return [c.returncode for c in children]


def _watch_ranks(children: List[subprocess.Popen]) -> None:
    """Rank 0: end the run as soon as another rank fails, since the ranks
    left would wait for it in their collectives."""
    def watch():
        while True:
            for c in children:
                rc = c.poll()
                if rc not in (None, 0):
                    sys.stderr.write(f"rank {children.index(c) + 1} exited with {rc}\n")
                    _stop(children)
                    os._exit(4)
            if all(c.returncode == 0 for c in children):
                return
            time.sleep(0.5)

    threading.Thread(target=watch, name="rank-watch", daemon=True).start()


def _watch_parent() -> None:
    """Another rank: end when rank 0 is gone."""
    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(5)

    threading.Thread(target=watch, name="parent-watch", daemon=True).start()


def main(argv: Optional[List[str]] = None, process_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    argv = sys.argv[1:] if argv is None else argv
    args = ap.parse_args(argv)
    if process_start is None:
        process_start = time.monotonic()
    cell = registry.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        sys.stderr.write(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
                         f"has {have}\n")
        return 2
    world = int(cell.traffic.get("ranks", 1))
    rank, children = int(os.environ.get(RANK_ENV, "0")), []
    if world > 1 and rank == 0:
        children = launch_ranks([sys.executable, os.path.abspath(sys.argv[0]), *argv], world)
        _watch_ranks(children)
    elif world > 1:
        _watch_parent()
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), process_start,
                          device=f"cuda:{rank}" if world > 1 else "cuda", rank=rank,
                          world=world)
    finally:
        codes = _stop(children, grace_s=120.0)
    bad = forbidden_modules(sys.modules)
    if bad:
        sys.stderr.write(f"the run loaded {', '.join(bad)}: the port must run without "
                         "JAX or the JAX package\n")
        return 3
    if any(codes):
        sys.stderr.write(f"the other ranks exited with {codes}\n")
        return 4
    if result is None:  # another rank: rank 0 prints the result
        return 0
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    sys.stderr.write("\n".join(_check_lines(result["checks"])) + "\n")
    sys.stderr.flush()
    return 0
