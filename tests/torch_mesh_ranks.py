"""Jobs run on every rank of a gloo group on the CPU, for the port's
distributed parity tests (``tests/test_torch_distributed.py``,
``tests/test_torch_q97.py``, ``tests/test_torch_plan_ranks.py``,
``tests/test_torch_governed_ranks.py``).

:func:`run_ranks` spawns one process per rank of a (dp, mp) mesh.  Each rank
joins a gloo group through a ``file://`` rendezvous in the caller's work
directory, builds the port's mesh over the CPU, runs the named jobs of
:data:`JOBS` on its own data shard of the global numpy inputs, and saves
what each job returns.  The caller gets one ``{label: {name: array}}`` dict
per rank, in rank order (rank = d * mp + m).

This module imports neither JAX nor the JAX package: spawned ranks import
it afresh, and the JAX references stay in the test modules.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from spark_rapids_jni_tpu_torch import columnar as tc
from spark_rapids_jni_tpu_torch.mem import BudgetedResource, MemoryGovernor, task_context
from spark_rapids_jni_tpu_torch.mem.governed import ShuffleCapacityExceeded
from spark_rapids_jni_tpu_torch.models import (
    Q97Batch,
    QueryStepConfig,
    make_distributed_q97,
    make_distributed_q97_columns,
    make_distributed_query_step,
    run_distributed_q5,
    run_distributed_q97,
    run_q97_piece,
)
from spark_rapids_jni_tpu_torch.models import q3 as q3_mod
from spark_rapids_jni_tpu_torch.models import q5 as q5_mod
from spark_rapids_jni_tpu_torch.models.tpcds import generate_q3_data, generate_q5_data
from spark_rapids_jni_tpu_torch.plans import (
    execute_plan,
    pad_tables,
    plan_cache,
    plan_inputs,
)
from spark_rapids_jni_tpu_torch.parallel import (
    DATA_AXIS,
    PaddedStrings,
    all_to_all_shuffle,
    axis_group,
    axis_index,
    axis_size,
    make_mesh,
    materialize_strings,
    pad_strings,
    shuffle_table,
)

Arrays = Dict[str, np.ndarray]
JOBS: Dict[str, Callable] = {}


def _job(fn):
    JOBS[fn.__name__] = fn
    return fn


def _data_shard(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's rows of a global array sharded over ``data`` (replicated
    over ``model``): the data index's block of dp equal leading blocks."""
    n = x.shape[0] // axis_size(mesh, DATA_AXIS)
    d = axis_index(mesh, DATA_AXIS)
    return x[d * n:(d + 1) * n]


def _shards(mesh, inputs: Arrays, *names) -> List[torch.Tensor]:
    return [_data_shard(torch.from_numpy(inputs[n]), mesh) for n in names]


def _numpy(out) -> Arrays:
    return {k: v.numpy() for k, v in out._asdict().items()}


@_job
def step(mesh, inputs: Arrays, cfg: Tuple[int, int, int, int]) -> Arrays:
    """make_distributed_query_step over this rank's keys and values."""
    keys, values = _shards(mesh, inputs, "keys", "values")
    return _numpy(make_distributed_query_step(mesh, QueryStepConfig(*cfg))(keys, values))


@_job
def shuffle(mesh, inputs: Arrays, capacity: int) -> Arrays:
    """all_to_all_shuffle of an int64 column, a [n, 3] int32 column and a
    bool column by ``part``, with ``row_valid``: the whole receive buffers."""
    k, rows, flag, part, row_valid = _shards(mesh, inputs, "k", "rows", "flag", "part",
                                             "row_valid")
    res = all_to_all_shuffle({"k": k, "rows": rows, "flag": flag}, part, capacity, mesh,
                             row_valid=row_valid)
    return {**{f"col.{n}": c.numpy() for n, c in res.columns.items()},
            "valid": res.valid.numpy(), "dropped": res.dropped.numpy()}


@_job
def table(mesh, inputs: Arrays, capacity: int) -> Arrays:
    """shuffle_table of an INT32 key, a nullable DECIMAL(38,2) and a nullable
    string column padded to its longest row, placed by key mod dp."""
    dp = axis_size(mesh, DATA_AXIS)
    strings = tc.strings_from_arrays(inputs["s_chars"], inputs["s_offsets"],
                                     inputs["s_valid"], device="cpu")
    ps = pad_strings(strings)
    sb, sl, sv = (_data_shard(t, mesh) for t in ps)
    key, hi, lo, dvalid = _shards(mesh, inputs, "key", "dec_hi", "dec_lo", "dec_valid")
    ex = shuffle_table(
        {"k": tc.Column(key, None, tc.INT32),
         "d": tc.Decimal128Column(hi, lo, dvalid, tc.decimal(38, 2)),
         "s": PaddedStrings(sb, sl, sv)},
        (key % dp).to(torch.int32), capacity, mesh)
    dropped = ex.dropped.clone()
    dist.all_reduce(dropped, group=axis_group(mesh, DATA_AXIS))
    d, s = ex.columns["d"], ex.columns["s"]
    back = materialize_strings(s)
    return {"k": ex.columns["k"].data.numpy(), "k_valid": ex.columns["k"].validity.numpy(),
            "valid": ex.valid.numpy(), "d_hi": d.hi.numpy(), "d_lo": d.lo.numpy(),
            "d_valid": d.validity.numpy(), "s_bytes": s.bytes.numpy(),
            "s_lengths": s.lengths.numpy(), "s_valid": s.validity.numpy(),
            "dropped": dropped.numpy(), "m_chars": back.chars.numpy(),
            "m_offsets": back.offsets.numpy(), "m_valid": back.validity.numpy()}


@_job
def q97(mesh, inputs: Arrays, capacity: int, with_validity: bool = False) -> Arrays:
    """make_distributed_q97 over this rank's shard of the two tables."""
    names = ["s_cust", "s_item", "c_cust", "c_item"]
    if with_validity:
        names += ["s_valid", "c_valid"]
    args = _shards(mesh, inputs, *names)
    return _numpy(make_distributed_q97(mesh, capacity, with_validity=with_validity)(*args))


@_job
def q97_columns(mesh, inputs: Arrays, capacity: int) -> Arrays:
    """make_distributed_q97_columns over nullable INT32 key columns; a
    column's validity is the input ``<name>_valid`` when there is one."""
    cols = []
    for name in ("s_cust", "s_item", "c_cust", "c_item"):
        (data,) = _shards(mesh, inputs, name)
        valid = _shards(mesh, inputs, name + "_valid")[0] if name + "_valid" in inputs \
            else None
        cols.append(tc.Column(data, valid, tc.INT32))
    s_rv, c_rv = _shards(mesh, inputs, "s_rv", "c_rv")
    return _numpy(make_distributed_q97_columns(mesh, capacity)(*cols, s_rv, c_rv))


@_job
def q97_piece(mesh, inputs: Arrays, capacity: int) -> Arrays:
    """run_q97_piece over the WHOLE host tables, as every rank passes them;
    ``raised`` is 1 where it raised ShuffleCapacityExceeded."""
    piece = Q97Batch(inputs["s_cust"], inputs["s_item"], inputs["c_cust"], inputs["c_item"],
                     capacity=capacity)
    try:
        out = run_q97_piece(mesh, piece)
    except ShuffleCapacityExceeded:
        return {"raised": np.array(1)}
    return {**out._asdict(), "raised": np.array(0)}


def _query(query: str, sf: float, seed: int):
    """(module, plan, host tables, make_distributed) of q5 or q3 at (sf, seed)."""
    if query == "q5":
        data = generate_q5_data(sf=sf, seed=seed)
        plan, tables = q5_mod._plan_and_tables(data)
        return data, plan, tables, q5_mod.make_distributed_q5
    data = generate_q3_data(sf=sf, seed=seed)
    tables = q3_mod._q3_tables(q3_mod._facts(data), q3_mod._dims(data))
    return data, q3_mod.q3_plan(**q3_mod._geometry(data)), tables, q3_mod.make_distributed_q3


@_job
def plan(mesh, inputs: Arrays, query: str, sf: float, seed: int) -> Arrays:
    """execute_plan of q5's or q3's plan over the whole host tables, twice
    (``retraces``/``hits`` count what the second run added), then the
    executor of make_distributed_* on this rank's flat shards (``same`` is 1
    where it returned the identical cached executor on every call)."""
    data, plan_, tables, make = _query(query, sf, seed)
    out = {f"plan.{k}": v for k, v in execute_plan(mesh, plan_, tables).items()}
    before = plan_cache.stats()
    execute_plan(mesh, plan_, tables)
    after = plan_cache.stats()
    compiled = make(mesh, data)
    same = all(make(mesh, data) is compiled for _ in range(3))
    flat = plan_inputs(compiled, pad_tables(plan_, tables, axis_size(mesh, DATA_AXIS)))
    for name, v in zip(compiled.out_names, compiled.fn(*flat)):
        out[f"fn.{name}"] = v.numpy()
    return {**out, "retraces": np.array(after["traces"] - before["traces"]),
            "hits": np.array(after["hits"] - before["hits"]), "same": np.array(int(same))}


@_job
def q3_columns(mesh, inputs: Arrays, geo: dict) -> Arrays:
    """_q3_columns_step over this rank's shard of padded facts (INT32 key
    Columns with validity, a DECIMAL(38,2) price from its limbs) and the dims
    whole; ``same`` is 1 where the step came from its cache."""
    ss_item, ss_item_v, ss_date, ss_date_v, hi, lo = _shards(
        mesh, inputs, "ss_item", "ss_item_v", "ss_date", "ss_date_v", "price_hi", "price_lo")
    dims = [torch.from_numpy(inputs[n]) for n in ("item_brand", "item_manufact", "date_year",
                                                 "date_moy")]
    geo_items = tuple(sorted(geo.items()))
    step = q3_mod._q3_columns_step(mesh, geo_items)
    out = step(tc.Column(ss_item, ss_item_v, tc.INT32), tc.Column(ss_date, ss_date_v, tc.INT32),
               tc.Decimal128Column(hi, lo, None, tc.decimal(38, 2)), *dims)
    same = q3_mod._q3_columns_step(mesh, geo_items) is step
    return {**_numpy(out), "same": np.array(int(same))}


def _governed(mesh, limit: int, split_on_rank: int, run) -> Arrays:
    """``run(budget, task_id)`` on this rank's own governor under a budget of
    ``limit`` bytes, with a SplitAndRetryOOM injected first where this rank
    is ``split_on_rank``; adds the arbiter's split count for the task, the
    plan executions it made and the budget left in use."""
    gov = MemoryGovernor(watchdog_period_s=0.02)
    try:
        budget = BudgetedResource(gov, limit)
        before = plan_cache.stats()["execute_calls"]
        with task_context(gov, 1):
            if dist.get_rank() == split_on_rank:
                gov.force_split_and_retry_oom(num_ooms=1)
            out = run(budget, 1)
            splits = gov.get_and_reset_num_split_retry(1)
        return {**out, "splits": np.array(splits), "used": np.array(budget.used),
                "executions": np.array(plan_cache.stats()["execute_calls"] - before)}
    finally:
        gov.close()


@_job
def governed_q97(mesh, inputs: Arrays, limit: int, capacity: int,
                 split_on_rank: int = -1) -> Arrays:
    """run_distributed_q97 over the WHOLE host tables under a budget of
    ``limit`` bytes (see :func:`_governed`)."""
    def run(budget, task_id):
        out = run_distributed_q97(mesh, (inputs["s_cust"], inputs["s_item"]),
                                  (inputs["c_cust"], inputs["c_item"]), budget=budget,
                                  task_id=task_id, capacity=capacity, manage_task=False)
        return {"counts": np.array([out.store_only, out.catalog_only, out.both])}
    return _governed(mesh, limit, split_on_rank, run)


@_job
def governed_q5(mesh, inputs: Arrays, limit: int, sf: float, seed: int,
                split_on_rank: int = -1) -> Arrays:
    """run_distributed_q5 on q5 data regenerated from (sf, seed) under a
    budget of ``limit`` bytes (see :func:`_governed`): the rows' keys and
    numbers."""
    data = generate_q5_data(sf=sf, seed=seed)

    def run(budget, task_id):
        rows = run_distributed_q5(mesh, data, budget=budget, task_id=task_id,
                                  manage_task=False)
        return {"keys": np.array([f"{r.channel}|{r.id}" for r in rows]),
                "values": np.array([r[2:] for r in rows], np.int64)}
    return _governed(mesh, limit, split_on_rank, run)


def _rank_main(rank: int, world: int, shape: Tuple[int, int], workdir: str,
               jobs: Sequence[Tuple[str, str, dict]]) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(shape, device="cpu")
        out = {}
        for label, name, kwargs in jobs:
            with np.load(os.path.join(workdir, f"{label}.in.npz")) as f:
                inputs = dict(f)
            for k, v in JOBS[name](mesh, inputs, **kwargs).items():
                out[f"{label}.{k}"] = v
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def run_ranks(shape: Tuple[int, int], jobs: Sequence[Tuple[str, str, Arrays, dict]],
              workdir, timeout_s: Optional[float] = None) -> List[Dict[str, Arrays]]:
    """Run ``jobs`` -- (label, job name, global inputs, keyword arguments) --
    on the ranks of a ``shape`` mesh of gloo processes, all in one spawn;
    returns each rank's ``{label: {name: array}}``, in rank order.  With
    ``timeout_s``, ranks still running after that many seconds are killed
    and ``TimeoutError`` is raised."""
    workdir = str(workdir)
    world = shape[0] * shape[1]
    for label, _, inputs, _ in jobs:
        np.savez(os.path.join(workdir, f"{label}.in.npz"), **inputs)
    ctx = mp.start_processes(_rank_main, args=(world, shape, workdir,
                                               [(label, name, kw) for label, name, _, kw in jobs]),
                             nprocs=world, join=False, start_method="spawn")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    while not ctx.join(timeout=1.0):
        if deadline is not None and time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(timeout=10)
            raise TimeoutError(f"ranks still running after {timeout_s} s")
    results = []
    for rank in range(world):
        per_label: Dict[str, Arrays] = {label: {} for label, *_ in jobs}
        with np.load(os.path.join(workdir, f"rank{rank}.npz")) as f:
            for key in f.files:
                label, name = key.split(".", 1)
                per_label[label][name] = f[key]
        results.append(per_label)
    return results
