"""Batch-length quantizing for the shuffle and the executor (PyTorch port of
the framework-neutral part of ``parallel/shuffle.py``).

``partition_of`` and the all-to-all exchange arrive with the distributed slice.
"""

from __future__ import annotations

from spark_rapids_jni_tpu_torch.columnar.column import next_pow2


def quantized_rows(n: int, mult: int) -> int:
    """Batch length that is a ``mult`` multiple AND pow2-quantized:
    ``mult * next_pow2(ceil(n / mult))`` (min one block), so a long-lived
    executor sees O(log max_rows) batch shapes per geometry."""
    return mult * next_pow2(max(1, -(-int(n) // mult)))
