"""Governed execution (PyTorch port of ``mem/governed.py``): so far the two
exceptions of its retry protocol, at the JAX package's import path.
``plans.runtime.execute_plan`` raises :class:`ShuffleCapacityExceeded`."""

from __future__ import annotations

__all__ = ["MaxSplitDepthExceeded", "ShuffleCapacityExceeded"]


class MaxSplitDepthExceeded(MemoryError):
    """A batch could not be made small enough within the split-depth cap."""


class ShuffleCapacityExceeded(Exception):
    """Raised when a fixed-capacity exchange overflowed (its ``dropped`` count
    is above 0).  The caller re-runs the same piece with a larger capacity:
    the shuffle-spill retry the reference protocol describes for exchanges
    that outgrow their buffers."""
