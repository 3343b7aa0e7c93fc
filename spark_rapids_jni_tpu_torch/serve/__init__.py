"""Multi-tenant query serving: admission control, batching, backpressure
(PyTorch port of ``serve/``, the engine half).

The front door: many concurrent client sessions drive queries through the
bounded admission queue into a worker pool, where every request is bracketed
through the memory governor's retry protocol (mem/) exactly like a Spark task.
The engine runs its handlers on one card, over a mesh or on a device:

    with one_rank_mesh("cuda") as mesh:
        engine = ServingEngine(mesh=mesh, workers=4, queue_size=64,
                               builtin_handlers=True)
        sess = engine.open_session(priority=1, byte_budget=1 << 30)
        resp = engine.submit(sess, "q97", (store, catalog), deadline_s=10)
        out = resp.result(timeout=30)   # or Backpressure raised at submit
        engine.shutdown()

Layers: serve.session (tenants -> governor task ids), serve.queue (bounded
priority queue + deadlines + backpressure), serve.executor (worker pool,
governed execution, split re-queueing, micro-batching), serve.ragged (page-pool
ticks), serve.metrics (counters + latency histograms, exported through the obs
seam), serve.attribution (per-tenant costs), serve.controller (adaptive
admission).

The crash-only tier above the engine -- the supervisor over worker processes
(serve.supervisor, serve.rpc), its telemetry and SLO engines and the
peer-to-peer shuffle plane -- comes with the next slice; serve.shuffle holds
only the single-process range driver and is not imported here.
"""

from spark_rapids_jni_tpu_torch.serve.controller import AdmissionController, Knob
from spark_rapids_jni_tpu_torch.serve.executor import (
    HandlerContext,
    QueryHandler,
    ServingEngine,
    register_builtin_handlers,
)
from spark_rapids_jni_tpu_torch.serve.metrics import LatencyHistogram, ServeMetrics
from spark_rapids_jni_tpu_torch.serve.queue import (
    AdmissionQueue,
    Backpressure,
    Request,
    RequestTimeout,
    Response,
)
from spark_rapids_jni_tpu_torch.serve.ragged import RaggedDispatcher, RaggedSpec
from spark_rapids_jni_tpu_torch.serve.session import (
    Session,
    SessionBudgetExceeded,
    SessionRegistry,
)

__all__ = [
    "AdmissionController",
    "AdmissionQueue",
    "Backpressure",
    "Knob",
    "HandlerContext",
    "LatencyHistogram",
    "QueryHandler",
    "RaggedDispatcher",
    "RaggedSpec",
    "Request",
    "RequestTimeout",
    "Response",
    "ServeMetrics",
    "ServingEngine",
    "Session",
    "SessionBudgetExceeded",
    "SessionRegistry",
    "register_builtin_handlers",
]
