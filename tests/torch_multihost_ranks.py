"""Rank processes launched the way ``torchrun`` launches them, for the port's
multi-host tests (``tests/test_torch_multihost.py``; not a test module).

:func:`launch` spawns one process per rank.  Each sets the launcher's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``, and ``GROUP_RANK`` where the caller gives
nodes), joins the gloo group through ``parallel.multihost.initialize``, runs
one named job of :data:`JOBS` and writes what it returns as JSON.

This module imports neither JAX nor the JAX package: spawned ranks import it
afresh, and the JAX references stay in the test module.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import socket
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch.multiprocessing as mp

JOBS: Dict[str, Callable] = {}

Q97_ROWS, Q97_SEED = 512, 11  # tests/multihost_worker.py's inputs
HARNESS_SF = 0.01  # 28,000 q97 rows a side
HARNESS_CHUNK, HARNESS_BUCKETS = 2000, 4
HOST_CAP = 96 << 10  # the streamed run's host budget: q97's buckets split on disk
MC_TASKS = 3


def _job(fn):
    JOBS[fn.__name__] = fn
    return fn


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def harness_args(streamed: bool) -> List[str]:
    args = ["--sf", str(HARNESS_SF), "--seed", "42", "--verify"]
    if streamed:
        args += ["--stream-chunk-rows", str(HARNESS_CHUNK), "--buckets", str(HARNESS_BUCKETS)]
    return args


def q97_inputs() -> List[np.ndarray]:
    """tests/multihost_worker.py's global inputs: store (cust, item), then
    catalog (cust, item)."""
    rng = np.random.RandomState(Q97_SEED)
    return [rng.randint(1, 50, Q97_ROWS).astype(np.int32) for _ in range(4)]


def _harness(argv) -> dict:
    from spark_rapids_jni_tpu_torch.models import nds_harness

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = nds_harness.main(argv, device="cpu")
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    line["rc"] = rc
    return line


@contextlib.contextmanager
def _tight_host_budget():
    """Cap every host (``is_cpu``) budget the harness makes at HOST_CAP."""
    import spark_rapids_jni_tpu_torch.mem as mem

    orig = mem.BudgetedResource

    class Tight(orig):
        def __init__(self, gov, limit, is_cpu=False):
            super().__init__(gov, min(limit, HOST_CAP) if is_cpu else limit, is_cpu=is_cpu)

    mem.BudgetedResource = Tight
    try:
        yield
    finally:
        mem.BudgetedResource = orig


@_job
def pair() -> dict:
    """The 2-rank job: q97 on the JAX worker's inputs over make_pod_mesh(mp=1),
    the harness in memory and streamed (buckets split on disk), and the q97
    monte-carlo over both ranks."""
    import torch.distributed as dist

    from spark_rapids_jni_tpu_torch.mem.montecarlo import run_q97_monte_carlo
    from spark_rapids_jni_tpu_torch.models import make_distributed_q97
    from spark_rapids_jni_tpu_torch.parallel import (
        DATA_AXIS,
        axis_index,
        axis_size,
        is_multihost,
        make_pod_mesh,
    )
    from spark_rapids_jni_tpu_torch.parallel import multihost

    import torch

    out = {"summary": multihost.process_summary(), "multihost": is_multihost(),
           "world": dist.get_world_size()}
    mesh = make_pod_mesh(mp=1, device="cpu")
    dp, d = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)
    n = Q97_ROWS // dp
    shards = [torch.from_numpy(a[d * n:(d + 1) * n]) for a in q97_inputs()]
    got = make_distributed_q97(mesh, Q97_ROWS)(*shards)
    out["q97"] = [int(got.store_only), int(got.catalog_only), int(got.both), int(got.dropped)]
    out["harness"] = _harness(harness_args(False))
    with _tight_host_budget():
        out["streamed"] = _harness(harness_args(True))
    t0 = time.perf_counter()
    stats = run_q97_monte_carlo(n_tasks=MC_TASKS, budget_frac=0.6, seed=1, ndev=dp,
                                device="cpu")
    out["monte_carlo"] = {"ok": stats.ok, "tasks_completed": stats.tasks_completed,
                          "data_groups": stats.data_groups, "failures": stats.failures,
                          "leaked": stats.leaked_bytes, "blocked": stats.blocked_at_end,
                          "s": time.perf_counter() - t0}
    return out


@_job
def pod_layout() -> dict:
    """make_pod_mesh over ranks whose nodes interleave: each mesh's rank array,
    this rank's coordinates and axis indices, and its groups' ranks; mp that
    straddles a node must raise."""
    import torch.distributed as dist

    from spark_rapids_jni_tpu_torch.parallel import (
        DATA_AXIS,
        MODEL_AXIS,
        axis_group,
        axis_index,
        make_pod_mesh,
    )

    out = {}
    for mp_ in (1, 2):
        mesh = make_pod_mesh(mp=mp_, device="cpu")
        out[f"mp{mp_}"] = {
            "mesh": mesh.mesh.tolist(),
            "coordinate": list(mesh.get_coordinate()),
            "data_index": axis_index(mesh, DATA_AXIS),
            "model_index": axis_index(mesh, MODEL_AXIS),
            "data_group": dist.get_process_group_ranks(axis_group(mesh, DATA_AXIS)),
            "model_group": dist.get_process_group_ranks(axis_group(mesh, MODEL_AXIS)),
        }
    try:
        make_pod_mesh(mp=4, device="cpu")
        out["mp4"] = "built"
    except ValueError as e:
        out["mp4"] = str(e)
    return out


def _rank_main(i: int, env_of: List[dict], job: str, workdir: str) -> None:
    os.environ.update({k: str(v) for k, v in env_of[i].items()})
    from spark_rapids_jni_tpu_torch.parallel import multihost

    multihost.INIT_TIMEOUT_S = 120.0
    multihost.initialize(device="cpu")
    try:
        out = JOBS[job]()
        with open(os.path.join(workdir, f"rank{i}.json.tmp"), "w") as f:
            json.dump(out, f)
        os.replace(os.path.join(workdir, f"rank{i}.json.tmp"),
                   os.path.join(workdir, f"rank{i}.json"))
    finally:
        import torch.distributed as dist

        dist.barrier()  # no rank tears the group down under another's last collective
        dist.destroy_process_group()


def launch(job: str, workdir, nodes: Sequence[Optional[int]], timeout_s: float = 240.0
           ) -> List[dict]:
    """Run ``job`` on ``len(nodes)`` ranks, rank ``i`` on node ``nodes[i]``
    (``GROUP_RANK``; None leaves it unset, all on this host), with the
    environment ``torchrun`` would give them; returns each rank's result in
    rank order."""
    workdir = str(workdir)
    world, port = len(nodes), free_port()
    env_of = []
    for i, node in enumerate(nodes):
        peers = [r for r in range(world) if nodes[r] == node]
        env = {"RANK": i, "WORLD_SIZE": world, "LOCAL_RANK": peers.index(i),
               "LOCAL_WORLD_SIZE": len(peers), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": port}
        if node is not None:
            env["GROUP_RANK"] = node
        env_of.append(env)
    ctx = mp.start_processes(_rank_main, args=(env_of, job, workdir), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(timeout=10)
            raise TimeoutError(f"{job}: ranks still running after {timeout_s} s")
    results = []
    for i in range(world):
        with open(os.path.join(workdir, f"rank{i}.json")) as f:
            results.append(json.load(f))
    return results
