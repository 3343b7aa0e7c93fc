"""Steady-state timing by two-point subtraction (PyTorch port of
``obs/timing.py``).

CUDA work is asynchronous: a host clock read right after a call measures the
launch, not the work.  The recipe here:

1. ``device_sync(tree)``: synchronize every CUDA device that holds a tensor
   in ``tree`` (``torch.cuda.synchronize``); CPU tensors need nothing.
2. ``time_marginal(fn, iters_lo, iters_hi)``: time the loop at two
   iteration counts and report ``(t_hi - t_lo) / (iters_hi - iters_lo)``.
   The subtraction cancels *all* fixed costs (the sync, the launch queue's
   ramp), so what remains is the steady-state per-call time: the number a
   throughput claim should be made of.

The reference's nvbench benchmarks (e.g.
``src/main/cpp/benchmarks/row_conversion.cpp:27``) get the same effect from
CUDA events; this recipe times any callable host to host.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Tuple

import torch

__all__ = ["device_sync", "time_marginal", "time_marginal_for_iters"]


def _leaves(tree: Any):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "__dataclass_fields__"):
        for name in tree.__dataclass_fields__:
            yield from _leaves(getattr(tree, name))


def device_sync(tree: Any) -> None:
    """Block until every tensor in ``tree`` (tensors, dicts, lists, tuples
    and dataclasses such as the port's columns, nested) has been computed:
    synchronizes each CUDA device that holds one.  Other leaves are
    ignored."""
    devices = {t.device for t in _leaves(tree) if t.device.type == "cuda"}
    for d in devices:
        torch.cuda.synchronize(d)


def time_marginal(
    fn: Callable[[], Any],
    iters_lo: int = 5,
    iters_hi: int = 25,
    sync: Callable[[Any], None] = device_sync,
) -> Tuple[float, dict]:
    """Steady-state seconds per call of ``fn`` via two-point subtraction.

    Returns ``(seconds_per_call, info)`` where info carries the raw points
    for the bench detail blob.  ``fn`` is invoked ``iters_lo + iters_hi + 1``
    times total (1 warmup).  If noise makes the subtraction non-positive,
    falls back to the amortized hi-point rate (which still contains the
    fixed sync overhead and therefore *understates* throughput, the safe
    direction for a reported number).
    """
    out = fn()
    sync(out)  # warm

    times = []
    for iters in (iters_lo, iters_hi):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        sync(out)
        times.append(time.perf_counter() - t0)

    marginal = (times[1] - times[0]) / (iters_hi - iters_lo)
    amortized = times[1] / iters_hi
    info = {
        "t_lo_s": round(times[0], 6),
        "t_hi_s": round(times[1], 6),
        "iters": [iters_lo, iters_hi],
        "amortized_s_per_call": round(amortized, 9),
        "method": "marginal",
    }
    if marginal <= 0:
        info["method"] = "amortized-fallback"
        return amortized, info
    return marginal, info


def time_marginal_for_iters(fn: Callable[[], Any], iters: int):
    """`time_marginal` with the two points derived from a caller's legacy
    iteration budget.  Cheap stages (small ``iters``) stay cheap: total
    calls ~= 2*iters + 1, never more than ~1.3x the pre-marginal loop for
    large ``iters``.
    """
    if iters <= 4:
        lo, hi = 1, max(3, iters)
    else:
        lo, hi = max(2, iters // 4), iters
    return time_marginal(fn, lo, hi)
