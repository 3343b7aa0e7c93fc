"""The check that no run loads JAX or the JAX package.

The port's name begins with the JAX package's, so the check compares each
loaded module's top-level name (the part before the first dot) whole."""

from __future__ import annotations

from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "spark_rapids_jni_tpu"})


def forbidden_modules(names: Iterable[str]) -> List[str]:
    """The top-level names among ``names`` that a run may not load."""
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
