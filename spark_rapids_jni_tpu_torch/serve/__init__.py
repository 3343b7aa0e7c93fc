"""Multi-tenant query serving: admission control, batching, backpressure
(PyTorch port of ``serve/``).

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

The crash-only tier above the engine: serve.supervisor (a router/supervisor
owning sessions + admission over N executor worker processes, with a
per-request lease table, idempotent re-dispatch and a reversible degradation
ladder), serve.rpc (the worker process entry point + pipe protocol),
serve.telemetry (the live cluster timeline and its endpoint) and serve.slo
(burn-rate objectives feeding the ladder).  One engine is one failure
domain; the supervisor is what makes losing one survivable.  Its executor
processes run on the card unless ``worker_cfg["device"]`` asks for the CPU;
several of them may share one card, each given its budget share
(``worker_cfg["budget_bytes"]``).
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
from spark_rapids_jni_tpu_torch.serve.slo import SLO, BurnRateEngine
from spark_rapids_jni_tpu_torch.serve.telemetry import (
    ClusterTimeline,
    TelemetryExporter,
    TelemetryServer,
    fetch_view,
)
from spark_rapids_jni_tpu_torch.serve.supervisor import (
    DEGRADE_LEVELS,
    Degraded,
    HandlerSpec,
    RemoteExecutorError,
    ShuffleSpec,
    Supervisor,
)

# serve.shuffle (the peer-to-peer columnar data plane) is NOT imported here:
# it pulls in the plan compiler, and executor worker processes that never
# serve a shuffle handler stay cheap to spawn.

__all__ = [
    "AdmissionController",
    "AdmissionQueue",
    "Backpressure",
    "BurnRateEngine",
    "ClusterTimeline",
    "SLO",
    "TelemetryExporter",
    "TelemetryServer",
    "fetch_view",
    "DEGRADE_LEVELS",
    "Degraded",
    "HandlerSpec",
    "Knob",
    "HandlerContext",
    "LatencyHistogram",
    "QueryHandler",
    "RaggedDispatcher",
    "RaggedSpec",
    "RemoteExecutorError",
    "Request",
    "RequestTimeout",
    "Response",
    "ServeMetrics",
    "ServingEngine",
    "Session",
    "ShuffleSpec",
    "SessionBudgetExceeded",
    "SessionRegistry",
    "Supervisor",
    "register_builtin_handlers",
]
