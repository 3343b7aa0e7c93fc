"""Power-of-two length classes for ragged walks (port of columnar/buckets.py).

Only ``length_buckets`` is ported: the JAX package also builds padded byte
rectangles per class (``padded_buckets``, ``map_buckets``) because its
kernels need dense tiles, while the port's hash kernel reads each row's bytes
straight from the Arrow buffer.  The classes still matter where work is
walked element by element in torch (the list walk, xxhash64 over bytes):
grouping rows of similar length keeps one long row from setting the number
of steps for the whole column.
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def _next_pow2(v: torch.Tensor) -> torch.Tensor:
    """Element-wise next power of two of int64 ``v >= 1`` (exact, no float
    log), for values below 2**32."""
    v = v - 1
    for s in (1, 2, 4, 8, 16):
        v = v | (v >> s)
    return v + 1


def length_buckets(lens: torch.Tensor) -> List[Tuple[int, torch.Tensor]]:
    """Group row indices by power-of-two length class.

    Returns ``[(width, rows), ...]`` ordered by width, ``rows`` the int64
    indices (ascending, on ``lens``' device) of the rows whose length rounds
    up to ``width``; zero-length rows land in the width-1 class.  The same
    classes as the JAX package's ``length_buckets(lens, min_width=1,
    round_rows=False)``:
    the port pads no row counts, having no compiled-shape cache to bound.
    """
    widths = _next_pow2(torch.clamp(lens.to(torch.int64), min=1))
    return [(w, torch.nonzero(widths == w).flatten())
            for w in torch.unique(widths).tolist()]
