"""TPC-DS q97 as Spark reduce tasks: the generator, the adapter to the port's
governed entry point (``models.q97.run_distributed_q97``) and the bytes a
task must move.

A task is one shuffle partition of the scan's output after the date filter:
the (customer_sk, item_sk) pairs of store_sales and of catalog_sales, as
host int32 arrays, as a shuffle read delivers them.  Keys are drawn on the
device from the seed, uniform over the specification's domains (customers
and items at the configuration's scale factor), each task's from its
partition's share of the pairs, then copied to the host.
"""

from __future__ import annotations

from typing import List

import torch

from nds_bench.core.loop import Pool

NEEDS_MESH = True  # q97's plan carries an Exchange
HASH_KERNEL = "mm_hash_long"  # the exchange's placement hash (csrc/hash_kernels.cu)


def task_rows(config: dict, scale: float = 1.0):
    """(store rows, catalog rows) of one reduce task: one year of the sales
    years passes the month filter, split over the shuffle partitions."""
    per = config["sales_years"] * config["shuffle_partitions"]
    return (round(config["store_sales_rows"] * scale / per),
            round(config["catalog_sales_rows"] * scale / per))


def pool_scales(traffic: dict) -> List[float]:
    """Each pool task's size as a multiple of a plain task, from the traffic
    mix's repeating pattern."""
    pattern = traffic.get("task_scale_pattern", [1.0])
    return [float(pattern[i % len(pattern)]) for i in range(traffic["pool_tasks"])]


def make_pool(config: dict, traffic: dict, seed: int, device, rank: int = 0,
              world: int = 1) -> Pool:
    """The pool's tasks from ``seed``, a few large draws on ``device`` copied
    to the host once and cut into tasks.  Pool task ``t`` is shuffle
    partition ``p = t mod shuffle_partitions``, which holds the pairs whose
    zero-based customer and item indices sum to ``p`` modulo the partitions:
    1/partitions of the pairs, with customers and items each uniform, so
    that duplicates within a side and overlaps between sides are as dense
    as in a partition of Spark's hash exchange."""
    sizes = [task_rows(config, s) for s in pool_scales(traffic)]
    parts, items = config["shuffle_partitions"], config["items"]
    if items < parts:
        raise ValueError("every partition needs items of each residue: items >= partitions")
    rows = torch.tensor([a + b for a, b in sizes], device=device)
    part = torch.repeat_interleave(torch.arange(len(sizes), device=device) % parts, rows)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    n = int(rows.sum())
    cust = torch.randint(1, config["customers"] + 1, (n,), generator=g, device=device,
                         dtype=torch.int64)
    residue = (part - (cust - 1)) % parts  # the item index's residue in this partition
    choices = (items - 1 - residue) // parts + 1  # items of that residue
    pick = torch.randint(0, 1 << 40, (n,), generator=g, device=device,
                         dtype=torch.int64) % choices
    item = (residue + parts * pick + 1).to(torch.int32).cpu().numpy()
    cust = cust.to(torch.int32).cpu().numpy()
    del residue, choices, pick, part
    tasks, at = [], 0
    for n_s, n_c in sizes:
        s, c, at = slice(at, at + n_s), slice(at + n_s, at + n_s + n_c), at + n_s + n_c
        tasks.append({"s_cust": cust[s], "s_item": item[s],
                      "c_cust": cust[c], "c_item": item[c], "rows": n_s + n_c})
    return Pool(tasks, {})


def least_bytes(task: dict, config: dict) -> int:
    """Each input byte read once (four int32 keys a row) and each output byte
    written once (three int64 counts and the int32 drop count)."""
    return task["rows"] * 8 + 3 * 8 + 4


class Runner:
    """The port's governed q97 over each thread's own mesh, under the
    traffic mix's budget (``budget_bytes``; the card's default without)."""

    def __init__(self, config: dict, traffic: dict, pool: Pool, meshes, device, gov):
        from spark_rapids_jni_tpu_torch.mem.governed import default_device_budget
        from spark_rapids_jni_tpu_torch.mem.governor import BudgetedResource
        from spark_rapids_jni_tpu_torch.models.q97 import run_distributed_q97

        self._run = run_distributed_q97
        self.meshes = meshes
        if torch.device(device).type == "cuda":
            # the kernel library is built (a checkout's first run) and loaded
            # here, before the task threads would race to build it
            from spark_rapids_jni_tpu_torch.ops import _build

            _build.library()
        budget = traffic.get("budget_bytes")
        self.budget = default_device_budget(gov) if budget is None else \
            BudgetedResource(gov, int(budget))

    def run(self, thread: int, task: dict, task_id: int):
        out = self._run(self.meshes[thread], (task["s_cust"], task["s_item"]),
                        (task["c_cust"], task["c_item"]), budget=self.budget,
                        task_id=task_id, manage_task=False)
        return (int(out.store_only), int(out.catalog_only), int(out.both))

    def close(self):
        self.meshes = None


def open_runner(config, traffic, pool, meshes, device, gov) -> Runner:
    return Runner(config, traffic, pool, meshes, device, gov)

