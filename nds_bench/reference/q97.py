"""Plain reference of TPC-DS q97 over one task's keys, and its control.

    SELECT SUM(store_only), SUM(catalog_only), SUM(both) FROM
      (SELECT DISTINCT customer_sk, item_sk FROM store_sales) ss
      FULL OUTER JOIN
      (SELECT DISTINCT customer_sk, item_sk FROM catalog_sales) cs
      USING (customer_sk, item_sk)

Set semantics in plain PyTorch: the distinct pairs of each side
(``torch.unique``), then their intersection (``torch.isin``).  It imports
nothing of the program and takes only the generated keys.

The control breaks the configuration's guarantee that pairs are told apart
exactly: it packs the pair into 32 bits (``customer * (items + 1) + item``,
wrapped), the width a later change might be tempted to sort in.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def _keys(cust, item, device, items: int, control: bool) -> torch.Tensor:
    c = torch.from_numpy(cust).to(device=device, dtype=torch.int64)
    i = torch.from_numpy(item).to(device=device, dtype=torch.int64)
    if control:
        return (c * (items + 1) + i) & 0xFFFFFFFF
    return (c << 32) | i


def answer(task: dict, config: dict, device, control: bool = False) -> Tuple[int, int, int]:
    """(store_only, catalog_only, both) of one task."""
    items = config["items"]
    s = torch.unique(_keys(task["s_cust"], task["s_item"], device, items, control))
    c = torch.unique(_keys(task["c_cust"], task["c_item"], device, items, control))
    both = int(torch.isin(s, c).sum())
    return (s.numel() - both, c.numel() - both, both)


def answers(tasks: List[dict], shared: dict, config: dict, device,
            control: bool = False) -> List[Tuple[int, int, int]]:
    return [answer(t, config, device, control) for t in tasks]
