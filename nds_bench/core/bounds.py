"""The card's peaks and the least time a launch could take.

A frozen copy of ``chip_smoke.py``'s bound arithmetic (``_MEM_RATE``,
``INT32_LANES_PER_SM``, ``KERNELS``, ``_card_rates`` and ``_bound``), so that
the yardstick does not move when the smoke script is edited.  Each input byte
is read once and each output byte written once; the operations are the
hand-counted 32-bit instructions per row of the kernel's source.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Tuple

# Device-memory rate by card name (NVIDIA data sheets), bytes/s.
MEM_RATE = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
INT32_LANES_PER_SM = 64  # Hopper: 32-bit integer multiply-add per SM per clock

# kernel -> (bytes read per row, bytes written per row, 32-bit instructions per
# row), for the scalar-seed form the shuffle's placement hash launches
KERNELS = {
    "mm_hash_long": (8, 4, 21),
    "mm_hash_int": (4, 4, 15),
    "xx_hash_fixed8": (8, 8, 40),
    "xx_hash_fixed4": (4, 8, 33),
}


def mem_rate(card_name: str) -> float:
    """The card's published memory rate in bytes/s; raises for a card the
    table does not know."""
    rate = next((r for key, r in MEM_RATE if key in card_name), None)
    if rate is None:
        raise RuntimeError(f"no memory rate known for {card_name!r}")
    return rate


def _max_sm_clock_hz() -> Optional[float]:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, check=True, timeout=60)
        return float(res.stdout.strip().splitlines()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def card_rates(card_name: str, sms: int) -> Tuple[float, Optional[float]]:
    """(memory bytes/s, 32-bit integer instructions/s or None when the clock
    cannot be read)."""
    clock = _max_sm_clock_hz()
    return mem_rate(card_name), (None if clock is None else sms * INT32_LANES_PER_SM * clock)


def bound_s(nbytes: float, ops: float, rates) -> float:
    """The least time the card could take: the larger of ``nbytes`` over the
    memory rate and ``ops`` over the integer rate."""
    mem, ints = rates
    t = nbytes / mem
    if ints:
        t = max(t, ops / ints)
    return t


def kernel_bound_s(kernel: str, n: int, rates) -> float:
    """The least time of one launch of ``kernel`` over ``n`` rows."""
    read, written, ops = KERNELS[kernel]
    return bound_s(n * (read + written), n * ops, rates)
