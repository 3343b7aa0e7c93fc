"""Randomized multi-task stress for the memory-governance state machine
(PyTorch port of ``mem/montecarlo.py``).

Parity target: ``RmmSparkMonteCarlo`` (src/test/java/com/nvidia/spark/rapids/
jni/RmmSparkMonteCarlo.java:56, 979 LoC; CI invocation ci/fuzz-test.sh
``--taskMaxMiB=2048 --gpuMiB=3072 --skewed --allocMode=ASYNC``).  N simulated
tasks run on real threads against a budget-capped resource, with skewed
allocation sizes, shuffle threads serving multiple tasks, injected OOMs, and
the full retry / split-and-retry protocol.  The run succeeds iff every task
completes (possibly after retries/splits), nothing leaks, and no thread ends
blocked — the arbiter's liveness and accounting invariants under chaos.

Runable as a CLI (the fuzz-test.sh analog)::

    python -m spark_rapids_jni_tpu_torch.mem.montecarlo --tasks 16 --seed 7 \
        --budget-mib 64 --task-max-mib 48 --skewed --duration-s 10

The spillable cache's buffers live on the card unless the caller asks for
the CPU (``--device cpu``); spilled copies sit in pinned host memory.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

from spark_rapids_jni_tpu_torch.mem.exceptions import (
    RetryOOM,
    SplitAndRetryOOM,
)
from spark_rapids_jni_tpu_torch.mem.governor import (
    BudgetedResource,
    MemoryGovernor,
    OutOfBudget,
)

__all__ = ["MonteCarloConfig", "MonteCarloStats", "run_monte_carlo",
           "run_q97_monte_carlo", "main"]


@dataclasses.dataclass
class MonteCarloConfig:
    n_tasks: int = 8
    n_threads: int = 4                  # concurrent dedicated task threads
    n_shuffle_threads: int = 1
    budget_bytes: int = 16 << 20
    task_max_bytes: int = 12 << 20      # peak working set a task may try
    allocs_per_task: int = 20
    skewed: bool = True                 # a few tasks allocate near the max
    inject_retry_pct: float = 5.0       # chance per alloc of a forced RetryOOM
    seed: int = 0
    max_task_retries: int = 1000
    duration_s: Optional[float] = None  # wall-clock cap: stop issuing tasks
    spill_buffers: int = 0              # shared spillable cache buffers
    device: Optional[str] = None        # where cache buffers live (card if None)


@dataclasses.dataclass
class MonteCarloStats:
    tasks_completed: int = 0
    retries: int = 0
    splits: int = 0
    injected: int = 0
    peak_used: int = 0
    leaked_bytes: int = 0
    blocked_at_end: int = 0
    cache_pins: int = 0
    cache_spills: int = 0
    data_groups: int = 0                # distinct data-axis groups (q97 arm)
    failures: List[str] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return (not self.failures and self.leaked_bytes == 0
                and self.blocked_at_end == 0)


class _Task:
    """One simulated Spark task: a random alloc/free program with retry."""

    def __init__(self, task_id: int, cfg: MonteCarloConfig, rng: random.Random):
        self.task_id = task_id
        self.cfg = cfg
        # skew: every 4th task works near the ceiling (RmmSparkMonteCarlo
        # --skewed gives some tasks outsized footprints)
        scale = 1.0 if not cfg.skewed or task_id % 4 else 3.0
        cap = min(cfg.task_max_bytes, int(cfg.task_max_bytes * scale / 3))
        self.sizes = [
            max(1, int(rng.expovariate(1.0) * cap / cfg.allocs_per_task))
            for _ in range(cfg.allocs_per_task)
        ]
        self.inject = [rng.uniform(0, 100) < cfg.inject_retry_pct
                       for _ in range(cfg.allocs_per_task)]

    def run(self, gov: MemoryGovernor, budget: BudgetedResource,
            stats: "MonteCarloStats", stats_lock: threading.Lock,
            cache=None) -> None:
        gov.current_thread_is_dedicated_to_task(self.task_id)
        held: List[int] = []
        sizes = list(self.sizes)
        rng = random.Random(self.cfg.seed * 7919 + self.task_id)
        try:
            attempts = 0
            while attempts < self.cfg.max_task_retries:
                attempts += 1
                try:
                    gov.start_retry_block()
                    for i, size in enumerate(sizes):
                        if self.inject[i]:
                            self.inject[i] = False
                            gov.force_retry_oom()
                            with stats_lock:
                                stats.injected += 1
                        held.append(budget.acquire(size))
                        with stats_lock:
                            stats.peak_used = max(stats.peak_used, budget.used)
                        if cache and rng.random() < 0.3:
                            # pin a shared spillable buffer mid-program: its
                            # re-admission competes with every tenant's
                            # allocs and may spill LRU peers; the content
                            # check catches any corruption across staging
                            bi = rng.randrange(len(cache))
                            with cache[bi].use() as t:
                                if int(t[0]) != bi:  # not assert: survives -O
                                    raise RuntimeError(
                                        f"cache corrupted: buffer {bi} "
                                        f"reads {int(t[0])}")
                            with stats_lock:
                                stats.cache_pins += 1
                        # steady-state: drop some early allocations
                        if len(held) > 4:
                            budget.release(held.pop(0))
                    break  # program completed
                except RetryOOM:
                    # roll back to spillable state and try again
                    with stats_lock:
                        stats.retries += 1
                    for h in held:
                        budget.release(h)
                    held.clear()
                    gov.block_thread_until_ready()
                except SplitAndRetryOOM:
                    # halve the working set and retry (the split protocol)
                    with stats_lock:
                        stats.splits += 1
                    for h in held:
                        budget.release(h)
                    held.clear()
                    sizes = [max(1, s // 2) for s in sizes]
                finally:
                    gov.end_retry_block()
            else:
                with stats_lock:
                    stats.failures.append(
                        f"task {self.task_id} hit max_task_retries")
        finally:
            for h in held:
                budget.release(h)
            gov.task_done(self.task_id)
            gov.remove_current_dedicated_thread_association(self.task_id)
            with stats_lock:
                stats.tasks_completed += 1


def _shuffle_thread(gov: MemoryGovernor, budget: BudgetedResource,
                    task_ids: List[int], stop: threading.Event,
                    rng: random.Random, stats: MonteCarloStats,
                    stats_lock: threading.Lock) -> None:
    """Highest-priority shuffle thread serving several tasks at once
    (RmmSpark.shuffleThreadWorkingTasks:155)."""
    gov.shuffle_thread_working_on_tasks(task_ids)
    try:
        while not stop.is_set():
            size = max(1, int(rng.expovariate(1.0) * 4096))
            try:
                budget.acquire(size)
                budget.release(size)
            except (RetryOOM, SplitAndRetryOOM):
                with stats_lock:
                    stats.retries += 1
            except OutOfBudget:
                # non-retryable: record it — a silently-dead shuffle thread
                # would weaken the run's liveness invariants
                with stats_lock:
                    stats.failures.append(
                        "shuffle thread hit non-retryable OutOfBudget")
                return
            time.sleep(0.001)
    finally:
        gov.remove_current_dedicated_thread_association(-1)


def run_monte_carlo(cfg: MonteCarloConfig) -> MonteCarloStats:
    rng = random.Random(cfg.seed)
    stats = MonteCarloStats()
    stats_lock = threading.Lock()
    gov = MemoryGovernor.initialize()
    spill_pool = None
    cache = None
    try:
        budget = BudgetedResource(gov, cfg.budget_bytes)
        if cfg.spill_buffers:
            import torch

            from spark_rapids_jni_tpu_torch.mem.spill import SpillPool

            spill_pool = SpillPool(budget, device=cfg.device)
            # each buffer ~1/8 of a task's peak, first element = its index
            nelem = max(16, cfg.task_max_bytes // 8 // 8)
            cache = []
            for bi in range(cfg.spill_buffers):
                cache.append(spill_pool.add(
                    torch.full((nelem,), bi, dtype=torch.int64)))
        tasks = [_Task(i, cfg, rng) for i in range(cfg.n_tasks)]
        stop = threading.Event()
        shufflers = []
        for i in range(cfg.n_shuffle_threads):
            t = threading.Thread(
                target=_shuffle_thread,
                args=(gov, budget, list(range(cfg.n_tasks)), stop,
                      random.Random(cfg.seed + 1000 + i), stats, stats_lock),
                daemon=True)
            t.start()
            shufflers.append(t)

        deadline = (time.monotonic() + cfg.duration_s
                    if cfg.duration_s else None)
        with ThreadPoolExecutor(max_workers=cfg.n_threads) as pool:
            futures = []
            for task in tasks:
                if deadline and time.monotonic() > deadline:
                    break
                futures.append(pool.submit(
                    task.run, gov, budget, stats, stats_lock, cache))
            for f in futures:
                try:
                    f.result(timeout=120)
                # analyze: ignore[retry-protocol] - the fuzz harness runs
                # OUTSIDE the workers' brackets; an escaped control signal
                # here is itself a protocol failure and is REPORTED, which
                # is the opposite of swallowing it
                except Exception as e:  # noqa: BLE001 - collected as failure
                    stats.failures.append(repr(e))
        stop.set()
        for t in shufflers:
            t.join(timeout=10)
        if spill_pool is not None:
            stats.cache_spills = spill_pool.spill_count
            spill_pool.close()  # releases resident cache reservations
        stats.leaked_bytes = budget.used
        stats.blocked_at_end = gov.arbiter.total_blocked_or_bufn()
    finally:
        MemoryGovernor.shutdown()
    return stats




def run_q97_monte_carlo(n_tasks: int = 6, budget_frac: float = 0.6,
                        seed: int = 0, ndev: Optional[int] = None,
                        device: Optional[str] = None) -> MonteCarloStats:
    """Monte-carlo over a REAL query: concurrent governed distributed q97
    runs under a shared tight budget with skewed keys.

    Each task thread generates a skewed two-table batch, runs
    run_distributed_q97 through the shared budget (splits/grows under real
    contention + escalation), and verifies the exact result against a host
    set oracle.  Success = every task exact, no leaks, no thread blocked.

    The tasks run on ``ndev`` ranks: the world of an initialised process
    group, where every rank makes this call with the same arguments and
    runs every task (task ``i`` of each rank together, each rank under a
    budget of its own), else 1, over a one-rank group made here (gloo for
    ``device="cpu"``, NCCL for the card) and taken down again.  ``ndev``
    other than that raises.

    Departure from the JAX package, whose tasks share one mesh: each task
    runs over a (ndev, 1) mesh of its own process groups, made on every
    rank in task order before the task threads start (``new_group`` is
    collective over the default group), so the plan's ``all_to_all`` and
    ``all_reduce`` and the admission agreement of concurrent tasks never
    share a communicator, and no lock serializes their launches.  The
    groups are made explicitly: a mesh dim that spans the world would get
    the default group from ``DeviceMesh``, the same one for every task.
    ``MonteCarloStats.data_groups`` counts the distinct data-axis groups
    the tasks ran over.
    """
    import torch.distributed as dist

    from spark_rapids_jni_tpu_torch.parallel import one_rank_mesh

    if dist.is_initialized():
        world = dist.get_world_size()
        if ndev not in (None, world):
            raise ValueError(f"run_q97_monte_carlo: ndev={ndev}, but the process "
                             f"group spans {world} ranks")
        return _q97_tasks(world, n_tasks, budget_frac, seed, device)
    if ndev not in (None, 1):
        raise ValueError(f"run_q97_monte_carlo: ndev={ndev} needs a process group of "
                         f"{ndev} ranks (parallel.multihost.initialize)")
    with one_rank_mesh(device):
        return _q97_tasks(1, n_tasks, budget_frac, seed, device)


def _task_meshes(ndev: int, n_tasks: int, device) -> tuple:
    """One (ndev, 1) mesh per task over process groups of its own, made on
    every rank in task order; returns the meshes, every group made and the
    number of distinct data-axis groups among the meshes."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from spark_rapids_jni_tpu_torch import device as _device
    from spark_rapids_jni_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        axis_group,
        check_mesh_device,
    )

    dev = _device.resolve(device)
    check_mesh_device(dev)
    rank = dist.get_rank()
    layout = torch.arange(ndev, dtype=torch.int64).reshape(ndev, 1)
    meshes, made = [], []
    for _ in range(n_tasks):
        data = dist.new_group(list(range(ndev)))
        model = None
        for d in range(ndev):  # every rank makes every rank's model group
            g = dist.new_group([d])
            if d == rank:
                model = g
        made += [data, model]
        meshes.append(DeviceMesh.from_group([data, model], dev.type, mesh=layout,
                                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS)))
    groups = [axis_group(m, DATA_AXIS) for m in meshes]
    distinct = len({id(g) for g in groups})
    if distinct != n_tasks or any(g is dist.group.WORLD for g in groups):
        raise RuntimeError("run_q97_monte_carlo: two tasks share a data-axis group")
    return meshes, made, distinct


def _q97_tasks(ndev: int, n_tasks: int, budget_frac: float, seed: int,
               device) -> MonteCarloStats:
    """The q97 arm's tasks, each on a mesh of its own over ``ndev`` ranks."""
    import numpy as np
    import torch.distributed as dist

    from spark_rapids_jni_tpu_torch.models.q97 import (
        Q97Batch,
        q97_host_oracle,
        q97_working_set_bytes,
        run_distributed_q97,
    )

    meshes, made, data_groups = _task_meshes(ndev, n_tasks, device)
    stats = MonteCarloStats(data_groups=data_groups)
    stats_lock = threading.Lock()
    gov = MemoryGovernor.initialize()
    try:
        rng0 = np.random.RandomState(seed)
        batches = []
        for _ in range(n_tasks):
            n = int(rng0.randint(200, 800))
            hot = rng0.randint(1, 4, int(n * 0.7)).astype(np.int32)
            cold = rng0.randint(4, 300, n - len(hot)).astype(np.int32)
            s_cust = np.concatenate([hot, cold])
            s_item = rng0.randint(1, 10, n).astype(np.int32)
            c_cust = rng0.permutation(s_cust).astype(np.int32)
            c_item = rng0.randint(1, 10, n).astype(np.int32)
            batches.append(((s_cust, s_item), (c_cust, c_item)))

        full = max(
            q97_working_set_bytes(
                Q97Batch(s[0], s[1], c[0], c[1], capacity=64), ndev)
            for s, c in batches)
        budget = BudgetedResource(gov, int(full * budget_frac))

        def task(tid, store, catalog):
            out = run_distributed_q97(
                meshes[tid], store, catalog, budget=budget, task_id=tid,
                capacity=64)
            if (out.store_only, out.catalog_only, out.both) != \
                    q97_host_oracle(store, catalog):
                with stats_lock:
                    stats.failures.append(f"task {tid}: wrong q97 result")
            with stats_lock:
                stats.tasks_completed += 1

        with ThreadPoolExecutor(max_workers=min(4, n_tasks)) as pool:
            futures = [pool.submit(task, i, s, c)
                       for i, (s, c) in enumerate(batches)]
            for f in futures:
                try:
                    f.result(timeout=600)
                # analyze: ignore[retry-protocol] - as above: escaped
                # control signals are collected as reported failures
                except Exception as e:  # noqa: BLE001 - collected as failure
                    stats.failures.append(repr(e))
        # per-task split metrics were consumed by task_done checkpointing;
        # liveness + leak invariants are the run's success criteria
        stats.leaked_bytes = budget.used
        stats.blocked_at_end = gov.arbiter.total_blocked_or_bufn()
    finally:
        MemoryGovernor.shutdown()
        for g in made:
            dist.destroy_process_group(g)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="arbiter monte-carlo stress")
    ap.add_argument("--tasks", type=int, default=16)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--shuffle-threads", type=int, default=2)
    ap.add_argument("--budget-mib", type=int, default=64)
    ap.add_argument("--task-max-mib", type=int, default=48)
    ap.add_argument("--allocs", type=int, default=50)
    ap.add_argument("--skewed", action="store_true")
    ap.add_argument("--inject-pct", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--duration-s", type=float, default=None)
    ap.add_argument("--spill-buffers", type=int, default=0,
                    help="shared spillable cache buffers pinned randomly "
                         "mid-program (exercises the spill ladder)")
    ap.add_argument("--workload", choices=("alloc", "q97"), default="alloc",
                    help="alloc: synthetic reserve/release chaos; q97: real "
                    "governed distributed q97 under a shared tight budget")
    ap.add_argument("--device", default=None,
                    help="where the cache buffers and q97 run: the card "
                         "unless 'cpu'")
    args = ap.parse_args(argv)
    if args.workload == "q97":
        from spark_rapids_jni_tpu_torch.parallel import initialize_multihost

        initialize_multihost(device=args.device)  # a launch of several ranks
        stats = run_q97_monte_carlo(n_tasks=args.tasks, seed=args.seed,
                                    device=args.device)
        print(f"tasks_completed={stats.tasks_completed} "
              f"leaked={stats.leaked_bytes} "
              f"blocked_at_end={stats.blocked_at_end} ok={stats.ok}")
        for f in stats.failures:
            print("FAILURE:", f, file=sys.stderr)
        return 0 if stats.ok else 1
    cfg = MonteCarloConfig(
        n_tasks=args.tasks, n_threads=args.threads,
        n_shuffle_threads=args.shuffle_threads,
        budget_bytes=args.budget_mib << 20,
        task_max_bytes=args.task_max_mib << 20,
        allocs_per_task=args.allocs, skewed=args.skewed,
        inject_retry_pct=args.inject_pct, seed=args.seed,
        duration_s=args.duration_s, spill_buffers=args.spill_buffers,
        device=args.device)
    stats = run_monte_carlo(cfg)
    print(f"tasks_completed={stats.tasks_completed} retries={stats.retries} "
          f"splits={stats.splits} injected={stats.injected} "
          f"peak_used={stats.peak_used} leaked={stats.leaked_bytes} "
          f"blocked_at_end={stats.blocked_at_end} "
          f"cache_pins={stats.cache_pins} cache_spills={stats.cache_spills} "
          f"ok={stats.ok}")
    for f in stats.failures:
        print("FAILURE:", f, file=sys.stderr)
    return 0 if stats.ok else 1


if __name__ == "__main__":
    sys.exit(main())
