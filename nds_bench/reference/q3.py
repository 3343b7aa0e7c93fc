"""Plain reference of TPC-DS q3 over one task's rows, and its control.

    select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price)
    from date_dim, store_sales, item
    where d_date_sk = ss_sold_date_sk and ss_item_sk = i_item_sk
      and i_manufact_id = 128 and d_moy = 11
    group by d_year, i_brand_id, i_brand
    order by d_year, sum desc, i_brand_id

Plain PyTorch over the generated rows and dimensions, on the device it is
given: the join keys and the filter row by row; then, for the few rows that
pass, exact integer sums of the unscaled DECIMAL(7,2) prices per (year,
brand) in Python ints.  It imports nothing of the program.

Every per-task group sum lies far below 2^24 cents, so float32 and every
wider type sum these prices exactly, and no lower precision separates a
wrong answer from a right one.  The control therefore breaks the
configuration's other guarantee, that a row whose item or date key is null
joins nothing: it keeps those rows.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def answer(task: dict, shared: dict, config: dict, device="cpu",
           control: bool = False) -> Tuple:
    """The query's rows for one task: (d_year, i_brand_id, i_brand, sum)."""

    def on(a):
        return torch.from_numpy(a).to(device)

    ii = on(task["ss_item"]).to(torch.int64) - 1
    di = on(task["ss_date"]).to(torch.int64) - config["d_date_sk_first"]
    ok = (ii >= 0) & (ii < config["items"]) & (di >= 0) & (di < config["date_dim_rows"])
    if not control:
        ok &= on(task["ss_item_v"]) & on(task["ss_date_v"])
    ii, di = ii.clamp(0, config["items"] - 1), di.clamp(0, config["date_dim_rows"] - 1)
    ok &= (on(shared["item_manufact"])[ii] == config["manufact_id"]) & \
        (on(shared["date_moy"])[di] == config["moy"])
    kept = torch.nonzero(ok).flatten()
    rows, ii, di = kept.cpu().numpy(), ii[kept].cpu().numpy(), di[kept].cpu().numpy()
    sums: dict = {}
    for y, b, p in zip(shared["date_year"][di].tolist(), shared["item_brand"][ii].tolist(),
                       task["price"][rows].tolist()):
        sums[(y, b)] = sums.get((y, b), 0) + p
    out = [(y, b, f"{config['brand_name_prefix']}{b}", s) for (y, b), s in sums.items()]
    out.sort(key=lambda r: (r[0], -r[3], r[1]))
    return tuple(out)


def answers(tasks: List[dict], shared: dict, config: dict, device,
            control: bool = False) -> List[Tuple]:
    return [answer(t, shared, config, device, control) for t in tasks]
