"""Handler factories for the port's cluster-serving tests (not a test module).

Spawned executor worker processes (``serve/rpc.py``) resolve their handler
factory as a ``"module:function"`` string against their own interpreter;
these live here, at module level in an importable file, and mirror
``cluster_worker.py``'s factories for the PyTorch port.  They import only the
port, never JAX.  Each takes a ``device`` keyword: when given, the factory
checks that the worker's engine runs there (the device reaches the engine
through ``worker_cfg["device"]``), so a test that asks for the CPU fails
loudly if its workers went anywhere else.
"""

import os
import time

from spark_rapids_jni_tpu_torch.serve import QueryHandler


def _check_device(engine, device) -> None:
    import torch

    if device is not None and engine.device != torch.device(device):
        raise RuntimeError(f"worker engine on {engine.device}, factory asked {device}")


def register_toy(engine, service_s: float = 0.0, device=None) -> None:
    """Toy handlers the supervisor tests drive.

    - ``sum``: splittable list-of-ints sum;
    - ``sum_fan``: the same body, fanned out across executors;
    - ``echo_pid``: returns this worker process's pid (placement probe);
    - ``sleep_n``: sleeps ``payload`` seconds then returns it;
    - ``hang_once``: wedges for 60s the FIRST time a given marker path is
      seen (the re-dispatched attempt on a survivor returns fast);
    - ``boom``: always raises ValueError (remote-error propagation);
    - ``hash32``: Spark's murmur3 of an int64 array with seed 42 on the
      engine's device (``mm_hash_long`` on the card);
    - ``big``: payload ``(n, marker)``, returns ``n`` bytes of 7 as a uint8
      array, first appending this worker's pid to the file ``marker`` (a
      result large enough to cross the pipe in many chunks).
    """
    _check_device(engine, device)

    def run_sum(p, ctx):
        if service_s:
            time.sleep(service_s)
        return sum(p)

    for name in ("sum", "sum_fan"):
        engine.register(QueryHandler(
            name=name, fn=run_sum,
            nbytes_of=lambda p: 64 * len(p),
            split=lambda p: [p[:len(p) // 2], p[len(p) // 2:]],
            combine=sum))

    engine.register(QueryHandler(name="echo_pid", fn=lambda p, ctx: os.getpid()))

    def run_sleep(p, ctx):
        time.sleep(float(p))
        return float(p)

    engine.register(QueryHandler(name="sleep_n", fn=run_sleep))

    def run_hang_once(p, ctx):
        marker = str(p)
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write(str(os.getpid()))
            time.sleep(60.0)  # wedged: only a supervisor recycle ends this
        return "recovered"

    engine.register(QueryHandler(name="hang_once", fn=run_hang_once))

    def run_boom(p, ctx):
        raise ValueError(f"boom: {p}")

    engine.register(QueryHandler(name="boom", fn=run_boom))

    def run_hash32(p, ctx):
        import numpy as np
        import torch

        from spark_rapids_jni_tpu_torch.columnar.column import Column
        from spark_rapids_jni_tpu_torch.columnar.dtypes import INT64
        from spark_rapids_jni_tpu_torch.ops import murmur_hash32

        data = torch.from_numpy(np.asarray(p, np.int64)).to(ctx.device, copy=True)
        return murmur_hash32([Column(data, None, INT64)], seed=42).data.cpu().numpy()

    engine.register(QueryHandler(name="hash32", fn=run_hash32,
                                 nbytes_of=lambda p: 12 * len(p)))

    def run_big(p, ctx):
        import numpy as np

        n, marker = p
        out = np.full(int(n), 7, np.uint8)
        with open(marker, "a") as f:
            f.write(f"{os.getpid()}\n")
        return out

    engine.register(QueryHandler(name="big", fn=run_big))


def register_shuffle(engine, capacity: int = 64, map_delay_s: float = 0.0,
                     device=None, name: str = "q97_shuffle") -> None:
    """q97's Exchange plan served as a real peer-to-peer shuffle piece.
    ``map_delay_s`` stalls each piece BEFORE its map fragment runs, widening
    the mid-exchange window a SIGKILL test aims into."""
    from spark_rapids_jni_tpu_torch.models.q97 import q97_plan
    from spark_rapids_jni_tpu_torch.serve.shuffle import run_shuffle_piece

    _check_device(engine, device)
    plan = q97_plan(capacity)

    def fn(payload, ctx):
        if map_delay_s:
            time.sleep(map_delay_s)
        return run_shuffle_piece(plan, payload, ctx)

    engine.register(QueryHandler(name=name, fn=fn, nbytes_of=lambda p: 0))


def register_order_shuffle(engine, k: int = 3, n_items: int = 40,
                           map_delay_s: float = 0.0, device=None) -> None:
    """The range-shuffle handlers: q67 (windowed rank), q64 and the global
    top-k plan served as real range-partitioned shuffle pieces."""
    from spark_rapids_jni_tpu_torch.models.q64 import q64_plan
    from spark_rapids_jni_tpu_torch.models.q67 import q67_plan, topk_sales_plan
    from spark_rapids_jni_tpu_torch.serve.shuffle import run_range_shuffle_piece

    _check_device(engine, device)

    def make(plan):
        def fn(payload, ctx):
            if map_delay_s:
                time.sleep(map_delay_s)
            return run_range_shuffle_piece(plan, payload, ctx)

        return fn

    engine.register(QueryHandler(
        name="q67_shuffle", fn=make(q67_plan(k, n_items)), nbytes_of=lambda p: 0))
    engine.register(QueryHandler(
        name="q64_shuffle", fn=make(q64_plan(k, n_items, 25, 2)), nbytes_of=lambda p: 0))
    engine.register(QueryHandler(
        name="topk_shuffle", fn=make(topk_sales_plan(k)), nbytes_of=lambda p: 0))


def register_shuffle_tier(engine, device=None, slow_delay_s: float = 0.6) -> None:
    """Every shuffle handler one test cluster serves: ``q97_shuffle``, a
    ``q97_shuffle_slow`` twin whose pieces wait ``slow_delay_s`` before their
    map fragment (the SIGKILL window), and the range handlers."""
    register_shuffle(engine, device=device)
    register_shuffle(engine, device=device, map_delay_s=slow_delay_s,
                     name="q97_shuffle_slow")
    register_order_shuffle(engine, device=device)
