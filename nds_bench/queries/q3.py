"""TPC-DS q3 as Spark map tasks: the generator, the adapter to the port's
governed plan path (``models.q3.run_distributed_q3``) and the bytes a task
must move.

A task is one scan split of store_sales: item and sold-date keys (each null
in a share of rows), and ``ss_ext_sales_price`` as DECIMAL(7,2) held as its
unscaled int64, as host arrays.  The dimensions are the specification's
item (brand and manufacturer per item) and date_dim (every day from
1900-01-02, 73,049 rows).  Everything is drawn on the device from the seed,
then copied to the host.
"""

from __future__ import annotations


import numpy as np
import torch

from nds_bench.core.loop import Pool

NEEDS_MESH = False  # q3's plan has no Exchange: it runs on the card alone
HASH_KERNEL = None


def date_dim(config: dict) -> dict:
    """d_date_sk, d_year and d_moy of every day of the date dimension."""
    first = np.datetime64(config["d_date_first"], "D")
    days = first + np.arange(config["date_dim_rows"])
    years = days.astype("datetime64[Y]")
    return {
        "date_sk": (config["d_date_sk_first"] + np.arange(config["date_dim_rows"])).astype(np.int32),
        "date_year": (years.astype(np.int64) + 1970).astype(np.int32),
        "date_moy": ((days.astype("datetime64[M]") - years.astype("datetime64[M]"))
                     .astype(np.int64) + 1).astype(np.int32),
    }


def sales_date_sks(config: dict):
    """The first and last d_date_sk that sales fall on."""
    first = np.datetime64(config["d_date_first"], "D")
    lo = (np.datetime64(config["sales_date_first"], "D") - first).astype(np.int64)
    hi = (np.datetime64(config["sales_date_last"], "D") - first).astype(np.int64)
    return config["d_date_sk_first"] + int(lo), config["d_date_sk_first"] + int(hi)


def make_pool(config: dict, traffic: dict, seed: int, device, rank: int = 0,
              world: int = 1) -> Pool:
    """The dimensions and the pool's facts from ``seed``, a few large draws on
    ``device``, copied to the host once and cut into tasks."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def ints(lo, hi, n, dtype=torch.int32):
        return torch.randint(lo, hi + 1, (n,), generator=g, device=device, dtype=dtype)

    items = config["items"]
    shared = {
        "item_brand": ints(1, config["brands"], items).cpu().numpy(),
        "item_manufact": ints(1, config["manufacturers"], items).cpu().numpy(),
        **date_dim(config),
    }
    rows = traffic["task_rows"]
    n = rows * traffic["pool_tasks"]
    lo, hi = sales_date_sks(config)
    keep = 1.0 - config["null_share"]
    qty = ints(config["quantity_min"], config["quantity_max"], n, torch.int64)
    price = (qty * ints(0, config["sales_price_max_cents"], n, torch.int64)).cpu().numpy()
    del qty
    facts = {
        "ss_item": ints(1, items, n).cpu().numpy(),
        "ss_date": ints(lo, hi, n).cpu().numpy(),
        "ss_item_v": (torch.rand((n,), generator=g, device=device) < keep).cpu().numpy(),
        "ss_date_v": (torch.rand((n,), generator=g, device=device) < keep).cpu().numpy(),
        "price": price,
    }
    tasks = [dict({k: v[i * rows:(i + 1) * rows] for k, v in facts.items()}, rows=rows)
             for i in range(traffic["pool_tasks"])]
    return Pool(tasks, shared)


def least_bytes(task: dict, config: dict) -> int:
    """Each input byte read once: the facts (two int32 keys, two validity
    bytes and the int64 price a row) and the two dimensions' columns the
    plan gathers; each output byte written once: the int64 sum and int32
    count of every (year, brand) group of the grid."""
    years = date_dim(config)["date_year"]
    groups = config["brands"] * (int(years.max()) - int(years.min()) + 1)
    return (task["rows"] * (4 + 1 + 4 + 1 + 8) + config["items"] * 8
            + config["date_dim_rows"] * 8 + groups * 12)


class Runner:
    """The port's governed q3 plan on the card, under the card's default
    budget."""

    def __init__(self, config: dict, traffic: dict, pool: Pool, meshes, device, gov):
        from spark_rapids_jni_tpu_torch.mem.governed import default_device_budget
        from spark_rapids_jni_tpu_torch.models.q3 import run_distributed_q3
        from spark_rapids_jni_tpu_torch.models.tpcds import Q3Data

        self._run = run_distributed_q3
        self.device = device
        self.budget = default_device_budget(gov)
        sh = pool.shared
        names = [f"{config['brand_name_prefix']}{b}" for b in range(1, config["brands"] + 1)]
        self.data = {}
        for t in pool.tasks:
            self.data[id(t)] = Q3Data(
                ss_item_sk=t["ss_item"], ss_item_sk_valid=t["ss_item_v"],
                ss_sold_date_sk=t["ss_date"], ss_sold_date_sk_valid=t["ss_date_v"],
                ss_ext_sales_price=t["price"],
                item_sk=np.arange(1, config["items"] + 1, dtype=np.int32),
                item_brand_id=sh["item_brand"], item_manufact_id=sh["item_manufact"],
                brand_names=names, date_sk=sh["date_sk"], date_year=sh["date_year"],
                date_moy=sh["date_moy"], manufact_id=config["manufact_id"], moy=config["moy"])

    def run(self, thread: int, task: dict, task_id: int):
        rows = self._run(None, self.data[id(task)], budget=self.budget, task_id=task_id,
                         manage_task=False, device=self.device)
        return tuple((r.d_year, r.brand_id, r.brand, r.sum_agg) for r in rows)

    def close(self):
        self.data = None


def open_runner(config, traffic, pool, meshes, device, gov) -> Runner:
    return Runner(config, traffic, pool, meshes, device, gov)
