"""The harness: registry, task loop, trace reduction, statistics, bounds."""
