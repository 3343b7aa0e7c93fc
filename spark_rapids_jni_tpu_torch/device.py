"""Device choice for the port's entry points: the card unless the caller asks
for the CPU."""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """``device``, or ``cuda`` when it is None; raises when CUDA is asked for
    (explicitly or by default) and no card is present."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return d


# held across every CUDA graph capture of the port: a capture's entry
# synchronizes the device and returns cached memory to the driver (room for
# the graph's own pool), which the card refuses while another thread's
# capture is open
_capture_lock = threading.Lock()


@contextlib.contextmanager
def graph_capture(graph: "torch.cuda.CUDAGraph"):
    """Capture ``graph`` over the ``with`` body (``torch.cuda.graph``) so that
    several threads may use the card at once, as a serving engine's workers
    do: one capture at a time, each in thread-local mode, so that other
    threads may launch, copy and allocate while it is open."""
    with _capture_lock, torch.cuda.graph(graph, capture_error_mode="thread_local"):
        yield
