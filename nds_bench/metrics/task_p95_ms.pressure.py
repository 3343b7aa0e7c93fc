"""``task_p95_ms`` where memory is contended on purpose, as a per-layer
metric: the arbiter's wake-up order decides the tail there from run to run."""

from nds_bench.core.registry import reader

read = reader("task_p95_ms").read
