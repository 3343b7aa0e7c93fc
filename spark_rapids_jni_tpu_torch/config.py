"""Typed runtime flags backed by environment variables (a copy of the JAX
package's ``config.py``: every flag keeps its name, default and environment
variable, so one setting governs both packages; each package resolves its
own runtime overrides).

The reference has no runtime config framework of its own — it uses build
flags, Java system properties (``ai.rapids.cudf.spark.rmmWatchdogPollingPeriod``,
SparkResourceAdaptor.java:35), and env vars for tooling
(``FAULT_INJECTOR_CONFIG_PATH``) — see SURVEY.md §5 config/flag system.  This
module is the coherent analog: one registry of every knob the framework
reads, each with a type, default, env var, and doc string, plus runtime
override support for tests.

Usage::

    from spark_rapids_jni_tpu_torch import config
    rows = config.get("bench_rows")
    with config.override(json_fuzz_rows=10000):
        ...
    config.describe()   # -> human-readable flag table
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Callable, Dict, Optional

__all__ = ["Flag", "register", "get", "set", "override", "describe", "FLAGS"]


def _parse_bool(s: str) -> bool:
    return s.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class Flag:
    name: str
    default: Any
    env: str
    parser: Callable[[str], Any]
    doc: str


FLAGS: Dict[str, Flag] = {}
_overrides: Dict[str, Any] = {}
_lock = threading.Lock()


def register(name: str, default: Any, doc: str,
             env: Optional[str] = None,
             parser: Optional[Callable[[str], Any]] = None) -> Flag:
    """Register a flag; the env var defaults to ``SRT_<NAME>``."""
    if env is None:
        env = "SRT_" + name.upper()
    if parser is None:
        if isinstance(default, bool):
            parser = _parse_bool
        elif isinstance(default, int):
            parser = int
        elif isinstance(default, float):
            parser = float
        else:
            parser = str
    flag = Flag(name, default, env, parser, doc)
    with _lock:
        if name in FLAGS:
            raise ValueError(f"flag {name!r} already registered")
        FLAGS[name] = flag
    return flag


def get(name: str) -> Any:
    """Resolve a flag: runtime override > env var > default."""
    flag = FLAGS[name]
    with _lock:
        if name in _overrides:
            return _overrides[name]
    raw = os.environ.get(flag.env)
    if raw is not None:
        try:
            return flag.parser(raw)
        except (ValueError, TypeError):
            import warnings

            warnings.warn(f"ignoring unparsable {flag.env}={raw!r}",
                          RuntimeWarning, stacklevel=2)
    return flag.default


def _validate(names) -> None:
    unknown = [n for n in names if n not in FLAGS]
    if unknown:
        raise KeyError(f"unknown flag(s) {unknown!r}")


def set(name: str, value: Any) -> None:  # noqa: A001 - flag-registry verb
    _validate([name])
    with _lock:
        _overrides[name] = value


@contextlib.contextmanager
def override(**kv):
    """Temporarily override flags (tests)."""
    _validate(kv)  # all-or-nothing: validate before applying any
    with _lock:
        saved = dict(_overrides)
        _overrides.update(kv)
    try:
        yield
    finally:
        with _lock:
            _overrides.clear()
            _overrides.update(saved)


def describe() -> str:
    lines = []
    for name in sorted(FLAGS):
        f = FLAGS[name]
        cur = get(name)
        lines.append(f"{name} = {cur!r}  [env {f.env}, default {f.default!r}]"
                     f"\n    {f.doc}")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# framework flags (every env knob the package reads, in one place)
# --------------------------------------------------------------------------

register("test_tpu", False,
         "Run the pytest suite on the real TPU instead of the virtual CPU "
         "mesh (slow: remote-compiles every kernel).", env="SRT_TEST_TPU")
register("bench_rows", 1 << 24,
         "Row count for bench.py workloads.", env="BENCH_ROWS")
register("bench_iters", 20,
         "Timed iterations per bench.py workload.", env="BENCH_ITERS")
register("json_fuzz_rows", 300,
         "Row count for the get_json_object fuzz-vs-oracle test.",
         env="SRT_JSON_FUZZ_ROWS")
register("fault_injector_config_path", "",
         "JSON config that arms the fault injector at import "
         "(obs/faultinj.py; the FAULT_INJECTOR_CONFIG_PATH analog).",
         env="SRT_FAULT_INJECTOR_CONFIG_PATH")
# NOTE: the round-2 "json_eval_device" flag (device scan + host render, a
# third evaluator shadowed by json_device_render) was removed in round 4;
# its lax.scan machine lives on as ops/json_scan.py, the core of the
# device-render product path below.
def _parse_device_render(s: str):
    return "auto" if s.strip().lower() == "auto" else _parse_bool(s)


register("json_device_render", "auto",
         "Arm of get_json_object: True = the device arm (the torch tokenizer "
         "path, the stacked path machine of ops/json_scan.py and the render of "
         "ops/json_render_device.py, on the column's device), False = the "
         "host arm (the numpy machine and render), 'auto' (default) picks by "
         "the column's device: the device arm for CUDA columns, the host arm "
         "for CPU ones.  No arm falls back to the other.",
         env="SRT_JSON_DEVICE_RENDER", parser=_parse_device_render)
register("json_compact", True,
         "Active-row compaction in the host get_json_object machine: when "
         "at least half a (sub-)bucket's rows have finished, machine state "
         "gathers down to the survivors (segments scatter back by original "
         "row id).  Off = dense lockstep over every row for every step "
         "(the pre-compaction shape, kept as an equivalence oracle).",
         env="SRT_JSON_COMPACT")
register("json_subbucket_min_rows", 512,
         "Minimum rows per token-count sub-bucket in the host "
         "get_json_object machine (columnar/buckets.count_subbuckets): "
         "classes smaller than this merge upward.  >= bucket rows "
         "disables sub-bucketing (one machine at the bucket-wide token "
         "capacity); 1 splits maximally.",
         env="SRT_JSON_SUBBUCKET_MIN_ROWS")
register("json_step_margin", 40,
         "Additive step-cap margin for the host get_json_object machine "
         "(cap = 2T + margin, T = token capacity).  Rows that exhaust the "
         "cap are nulled AND counted through the obs seam "
         "(json:step_cap_truncated) — lowering this below the default "
         "makes truncation reachable for tests; raising it buys "
         "pathological nestings more steps.",
         env="SRT_JSON_STEP_MARGIN")
register("json_overlap_bytes", 64 << 20,
         "Padded-input byte budget (x paths) per group of bucket chunks in "
         "get_json_object's device arm and from_json: a group's chunks run "
         "before its batched width syncs, and its tables are held at once "
         "(the memory bound). 1 = one chunk per group.",
         env="SRT_JSON_OVERLAP_BYTES")
register("float_device_render", "auto",
         "Arm of ops/float_to_string.py: True = the torch lane Ryu on the "
         "column's device, False = the numpy host renderer (the twin), "
         "'auto' (default) picks by the column's device: the lane arm for "
         "CUDA tensors, the twin for CPU ones.  No arm falls back to the "
         "other; the result is on the column's device.",
         env="SRT_FLOAT_DEVICE_RENDER", parser=_parse_device_render)
register("float_bucketed", True,
         "Value-class bucketing in float_to_string (round 20): split "
         "the column into specials / simple-integer / full-Ryu classes "
         "(columnar/buckets.class_buckets) so the 22-iteration masked "
         "shortest-search and 128-bit limb machinery run only on the "
         "residue bucket, with strength-reduced one-gather emission. "
         "Off = the monolithic whole-column oracle path.",
         env="SRT_FLOAT_BUCKETED")
register("cast_device_parse", "auto",
         "Arm of ops/cast_string_to_float.py: True = the torch lane scan "
         "+ softfloat assembly on the column's device, False = the numpy "
         "host scan + hardware-binary64 assembly (the twin), 'auto' "
         "(default) picks by the column's device: the lane arm for CUDA "
         "tensors, the twin for CPU ones.  No arm falls back to the "
         "other; the result is on the column's device.",
         env="SRT_CAST_DEVICE_PARSE", parser=_parse_device_render)
register("rows_device_path", "auto",
         "Arm of ops/row_conversion.py's cached-permutation fast path: "
         "True = the torch gather on the columns' device, False = the "
         "numpy host transpose, 'auto' (default) picks by the columns' "
         "device (the torch arm for CUDA tensors, numpy for CPU ones).",
         env="SRT_ROWS_DEVICE_PATH", parser=_parse_device_render)
register("rows_plan_cache", True,
         "Cached byte-permutation row<->column plans (round 20): "
         "precompute the (src,dst) byte permutation of the fixed "
         "section ONCE per schema, key it in the process-global plan "
         "cache on (schema signature, pow2 row bucket), and run each "
         "direction as one fused gather plus the ragged string pass. "
         "Off = the per-column Python-loop oracle paths.",
         env="SRT_ROWS_PLAN_CACHE")
register("hash_backend", "auto",
         "Backend for murmur3/xxhash64 column contributions: 'xla' "
         "(fused elementwise ops), 'pallas' (VMEM-blocked kernels, "
         "ops/hash_pallas.py; interpret-mode off-TPU), or 'auto' — "
         "kind-adaptive dispatch (round 16): byte/string inputs always "
         "take the XLA scan (pallas measured 0.37x on strings, BENCH_r07 "
         "A/B), fixed-width inputs take pallas only on a real TPU "
         "backend. Explicit values force every kind; v5e A/B history in "
         "PERF_CAPTURE.jsonl and docs/PERF.md.",
         env="SRT_HASH_BACKEND")
register("partition_hash", "murmur3",
         "Internal shuffle-placement hash (parallel/shuffle.partition_of, "
         "read at each call): 'murmur3' (Spark's placement hash) or "
         "'mix32' (pure-u32 mix, ~1/3 the multiplies; placement is never "
         "user-visible so Spark compatibility does not bind here). "
         "Default measured on the v5e (round 5): murmur3 23.9 vs mix32 "
         "22.7 Grows/s — the multiply savings don't show at HBM-bound "
         "sizes, so the Spark-compatible hash stays default.",
         env="SRT_PARTITION_HASH")
register("watchdog_period_s", 0.1,
         "Memory-governor deadlock-watchdog poll period (the "
         "rmmWatchdogPollingPeriod analog, SparkResourceAdaptor.java:35).",
         env="SRT_WATCHDOG_PERIOD_S")
register("device_budget_bytes", 8 << 30,
         "Default HBM working-set admission budget for governed execution "
         "(mem/governed.py); the RMM pool-size analog.",
         env="SRT_DEVICE_BUDGET_BYTES")
register("serve_workers", 4,
         "Worker threads in the serving engine's executor pool "
         "(serve/executor.py).", env="SRT_SERVE_WORKERS")
register("serve_queue_size", 64,
         "Admission-queue bound: submits past this depth are rejected "
         "with backpressure (serve/queue.py).", env="SRT_SERVE_QUEUE_SIZE")
register("flight_ring_size", 4096,
         "Bounded event capacity of the always-on governance flight "
         "recorder (obs/flight.py): the newest N state-transition events "
         "survive for anomaly dumps.", env="SRT_FLIGHT_RING_SIZE")
register("flight_dump_dir", "",
         "Directory for flight-recorder anomaly dump artifacts (JSON, "
         "pretty-printed by tools/flightdump.py).  Empty (default) keeps "
         "dumps in memory only (FlightRecorder.dumps).",
         env="SRT_FLIGHT_DUMP_DIR")
register("plan_cache_size", 64,
         "Resident compiled-plan variants in the process-global plan "
         "cache (plans/cache.py), LRU-evicted past this.  Variants are "
         "keyed on (plan structure, dtype signature, pow2 batch bucket), "
         "so a long-lived executor holds O(log rows) entries per query "
         "geometry.", env="SRT_PLAN_CACHE_SIZE")
register("flight_saturation_rejects", 8,
         "Consecutive backpressure rejections (no successful submit in "
         "between) that count as queue saturation and trigger a flight-"
         "recorder anomaly dump (serve/executor.py).",
         env="SRT_FLIGHT_SATURATION_REJECTS")
register("serve_adaptive", False,
         "Telemetry-steered adaptive admission (serve/controller.py): the "
         "serving engine runs a feedback controller that tunes queue "
         "depth, session byte-budget scale, priority aging, and "
         "pre-emptive split depth from live flight-recorder gauges.  Off "
         "(default) = the static-config behavior of rounds 1-8.",
         env="SRT_SERVE_ADAPTIVE")
register("serve_controller_period_s", 0.05,
         "Tick period of the adaptive-admission controller thread "
         "(serve/controller.py).  Each tick samples pressure gauges, "
         "updates the EWMA, and applies at most one banded adjustment "
         "per knob.", env="SRT_SERVE_CONTROLLER_PERIOD_S")
register("serve_retry_jitter_seed", 0,
         "Seed for the serving engine's backpressure retry-after jitter "
         "(serve/executor.py): hints spread over [0.5x, 1.5x) of the "
         "EWMA-derived backoff so synchronized rejectees de-phase.  Fixed "
         "seed = replayable hint sequence (chaos determinism).",
         env="SRT_SERVE_RETRY_JITTER_SEED")
register("serve_hang_factor", 20.0,
         "Hung-task watchdog threshold: a handler still running after "
         "this multiple of its per-class EWMA service time (floored at "
         "serve_hang_min_s) is flagged EV_TASK_HUNG with a rate-limited "
         "anomaly dump (serve/executor.py).  <= 0 disables the watchdog.",
         env="SRT_SERVE_HANG_FACTOR")
register("serve_hang_min_s", 1.0,
         "Absolute floor for the hung-task watchdog bound: cold classes "
         "(no EWMA yet) and microsecond handlers are never flagged before "
         "this many seconds.", env="SRT_SERVE_HANG_MIN_S")
register("serve_heartbeat_s", 0.05,
         "Executor-worker heartbeat period in cluster serving "
         "(serve/rpc.py -> serve/supervisor.py): each worker process "
         "reports liveness + pressure gauges this often.",
         env="SRT_SERVE_HEARTBEAT_S")
register("serve_heartbeat_misses", 6,
         "Consecutive missed heartbeat periods after which the supervisor "
         "declares an executor dead and re-dispatches its leases "
         "(serve/supervisor.py).", env="SRT_SERVE_HEARTBEAT_MISSES")
register("serve_lease_hang_s", 5.0,
         "Supervisor-side hung-lease bound: a lease outstanding on one "
         "executor longer than this marks the executor wedged — it is "
         "killed, respawned, and the lease re-queued to survivors "
         "(crash-only recovery).  MUST exceed the slowest legitimate "
         "handler service time, or healthy-but-slow executors get "
         "recycled; a request that hangs lease_max_dispatches separate "
         "executors fails terminally instead of destroying the pool.",
         env="SRT_SERVE_LEASE_HANG_S")
register("serve_ragged", False,
         "Continuous ragged batching in the serving engine "
         "(serve/ragged.py): arbitrary concurrent requests of one "
         "handler class pack into the fixed-size page pool and ride ONE "
         "fused launch per tick, results scattered back per session.  "
         "Off (default) = the micro-batching behavior of rounds 1-11 "
         "(the bit-identical parity oracle).", env="SRT_SERVE_RAGGED")
register("serve_page_rows", 256,
         "Rows per fixed-size page in the ragged batching page pool "
         "(columnar/pages.py).  Page count quantizes pow2 above this, "
         "so it sets the pack granularity, not a capacity.",
         env="SRT_SERVE_PAGE_ROWS")
register("serve_ragged_pool_pages", 64,
         "Standing page count of the ragged dispatch pool: every fresh "
         "tick packs into serve_page_rows x this many rows (padding "
         "validity-masked), so steady-state traffic compiles ONE "
         "program per (handler kernel, dtype) regardless of request "
         "shapes.  Page counts only drop below this when "
         "SplitAndRetryOOM halves a pack.",
         env="SRT_SERVE_RAGGED_POOL_PAGES")
register("serve_ragged_max_riders", 64,
         "Most requests that share one fused ragged launch (the rider-id "
         "capacity is its pow2; per-rider kernel outputs are sized by "
         "it).  Candidates past the row or rider cap stay queued for "
         "the next tick.", env="SRT_SERVE_RAGGED_MAX_RIDERS")
register("serve_send_timeout_s", 10.0,
         "Bounded-time guard on cross-process pipe sends (serve/rpc.py "
         "SafeConn): a peer that stops draining its pipe for this long "
         "surfaces as an EV_TASK_HUNG flight event and a failed send "
         "(the caller's unreachable-peer path) instead of an indefinite "
         "block holding the send lock.  <= 0 disables the guard.",
         env="SRT_SERVE_SEND_TIMEOUT_S")
register("serve_shuffle_fetch_timeout_s", 30.0,
         "Total time a shuffle consumer will wait for one partition "
         "(serve/shuffle.py) across map updates, reconnects, and "
         "re-fetches before the piece fails with ShuffleFetchStalled "
         "(which the supervisor re-dispatches, bounded by "
         "lease_max_dispatches).  Must comfortably exceed the time a "
         "dead producer takes to be detected, re-dispatched, and "
         "re-produced on a survivor.",
         env="SRT_SERVE_SHUFFLE_FETCH_TIMEOUT_S")
register("serve_shuffle_io_timeout_s", 2.0,
         "Per-attempt socket I/O timeout of one framed partition fetch: "
         "a stalled peer (peer_stall chaos, wedged serving thread) trips "
         "this, the consumer records EV_SHUFFLE_RETRY and backs off "
         "with seeded jitter rather than hanging on the socket.",
         env="SRT_SERVE_SHUFFLE_IO_TIMEOUT_S")
register("serve_shuffle_backoff_ms", 10.0,
         "Base backoff between shuffle fetch attempts; each attempt "
         "sleeps base * attempt * jitter with jitter drawn from "
         "[0.5, 1.5) of a per-(sid, task, part) seeded RNG, so "
         "consumers storming a recovering producer de-phase "
         "deterministically.", env="SRT_SERVE_SHUFFLE_BACKOFF_MS")
register("serve_shuffle_jitter_seed", 0,
         "Seed of the shuffle fetch backoff jitter (chaos determinism: "
         "one seed yields one retry schedule).",
         env="SRT_SERVE_SHUFFLE_JITTER_SEED")
register("serve_shuffle_credit_bytes", 64 << 20,
         "Credit window of the shuffle consumer: the transport reserves "
         "min(partition bytes, this) from the executor's governed budget "
         "around each fetch+decode, so in-flight transport memory "
         "competes with compute under the SAME byte budget (blocking or "
         "RetryOOM through the normal protocol instead of OOMing the "
         "peer).", env="SRT_SERVE_SHUFFLE_CREDIT_BYTES")
register("serve_shuffle_spool_dir", "",
         "Same-host fast path of the shuffle transport: when set (e.g. "
         "a directory under /dev/shm), producers additionally spool each "
         "framed partition to '<dir>/<sid>_<map>_<part>.frame' and the "
         "map broadcast carries the path, so same-host consumers read "
         "shared memory instead of the socket (still CRC-verified).  "
         "Empty (default) = socket-only.",
         env="SRT_SERVE_SHUFFLE_SPOOL_DIR")
register("flight_dump_rate_s", 1.0,
         "Anomaly-dump rate limit of the flight recorder (obs/flight.py): "
         "at most one dump artifact per reason per this many seconds "
         "(counted as dumps_suppressed past it).  Chaos tiers tighten it "
         "to capture every incident; fleets widen it to bound artifact "
         "churn.  Every dump carries a paired (wall_time_s, t_ns) stamp "
         "so cluster merges align per-process monotonic clocks exactly.",
         env="SRT_FLIGHT_DUMP_RATE_S")
register("serve_telemetry", True,
         "Continuous cluster telemetry (serve/telemetry.py): executor "
         "workers piggyback rolling flight-ring deltas + metric "
         "snapshots onto the heartbeat cadence (MSG_TELEMETRY), the "
         "supervisor maintains a bounded live cluster timeline served "
         "over a local endpoint (tools/servetop.py, flightdump --live), "
         "and serving requests root distributed spans (obs/trace.py).  "
         "Off = rounds 1-13 behavior: dumps-only observability, no span "
         "events in the ring (full governance-history capacity), no "
         "exports, no endpoint.",
         env="SRT_SERVE_TELEMETRY")
register("serve_telemetry_s", 0.05,
         "Minimum period between one worker's telemetry exports.  The "
         "export rides the heartbeat thread, so the effective cadence is "
         "max(this, serve_heartbeat_s); an undeliverable export is "
         "SKIPPED (EV_TELEMETRY_DROP), never blocked on.",
         env="SRT_SERVE_TELEMETRY_S")
register("serve_telemetry_max_events", 4096,
         "Most flight-ring events one telemetry export ships; a larger "
         "backlog is trimmed to the newest (counted + EV_TELEMETRY_DROP) "
         "so a post-storm export can never stall the pipe behind one "
         "giant message.  Default matches flight_ring_size: an export "
         "can always ship a full ring, so events are only ever lost to "
         "ring rollover itself (a process emitting a full ring between "
         "two beats), never to the trim.",
         env="SRT_SERVE_TELEMETRY_MAX_EVENTS")
register("serve_timeline_events", 65536,
         "Bounded event capacity of the supervisor's live cluster "
         "timeline (serve/telemetry.py ClusterTimeline): the newest N "
         "merged cross-process events are queryable over the local "
         "telemetry endpoint.", env="SRT_SERVE_TIMELINE_EVENTS")
register("serve_telemetry_port", 0,
         "TCP port of the supervisor's local telemetry endpoint "
         "(127.0.0.1; one JSON snapshot per connection).  0 (default) "
         "binds an ephemeral port — read it from "
         "Supervisor.telemetry_endpoint() or the BENCH_serve record.",
         env="SRT_SERVE_TELEMETRY_PORT")
register("serve_slo_config", "",
         "Declared service-level objectives as a JSON list (serve/slo.py "
         "schema: [{\"name\", \"handler\"|\"tenant\", \"p99_ms\", "
         "\"error_frac\", \"shed_frac\"}]).  Evaluated over multi-window "
         "burn rates by the supervisor's monitor tick; a burning "
         "objective emits EV_SLO_BURN, pressures the degradation ladder "
         "and (via MSG_PRESSURE slo_frac) every worker's admission "
         "controller, and emits EV_SLO_OK on recovery.  Empty = no SLOs.",
         env="SRT_SERVE_SLO_CONFIG")
register("serve_result_cache", False,
         "Governed multi-tier result cache (plans/rcache.py, round 15): "
         "results keyed on (plan/handler, input-content CRC fingerprint, "
         "dtype/pow2-bucket signature, named-table versions) are served "
         "from an HBM -> host RAM -> disk store instead of recomputing.  "
         "plans/runtime consults it before admission (a hit never enters "
         "the governed bracket), the serving engine before the handler "
         "bracket, and the supervisor before dispatch (a hit never costs "
         "a lease or a pipe crossing).  HBM residency rides the live "
         "device budget opportunistically (try_acquire + spill-handler "
         "demotion: a RetryOOM storm squeezes the cache first).  Off "
         "(default) = rounds 1-14 behavior, every request pays compute.",
         env="SRT_SERVE_RESULT_CACHE")
register("serve_result_cache_hbm_bytes", 256 << 20,
         "Cap on result-cache bytes resident in the HBM tier (the cache "
         "additionally never takes budget the governor can't spare right "
         "now, and pressure demotes below this cap).",
         env="SRT_SERVE_RESULT_CACHE_HBM_BYTES")
register("serve_result_cache_host_bytes", 1 << 30,
         "Cap on result-cache bytes resident in host RAM; past it, LRU "
         "entries demote to the disk tier (serve_result_cache_dir set) "
         "or evict.", env="SRT_SERVE_RESULT_CACHE_HOST_BYTES")
register("serve_result_cache_dir", "",
         "Directory of the result cache's disk tier: demoted entries "
         "persist as CRC32-framed files (columnar/frames.py FR_RESULT) "
         "verified on every load — a corrupt file is dropped and the "
         "query recomputes.  Empty (default) disables the disk tier "
         "(host-cap overflow evicts instead of demoting).",
         env="SRT_SERVE_RESULT_CACHE_DIR")
register("serve_result_cache_entries", 1024,
         "Most entries the result cache holds across all tiers; past it "
         "the overall LRU entry is dropped.",
         env="SRT_SERVE_RESULT_CACHE_ENTRIES")
register("serve_result_cache_advertise", 16,
         "Hottest result-cache key tokens each executor worker "
         "advertises in its heartbeat gauges (serve/rpc.py): the "
         "supervisor's cached_only degradation level admits submits "
         "whose key is advertised hot by ANY worker — under overload, "
         "hot queries keep being served while cold ones shed.  0 "
         "disables advertisement.",
         env="SRT_SERVE_RESULT_CACHE_ADVERTISE")
register("serve_controller_freeze", False,
         "Kill switch for adaptive admission: when set, the controller "
         "immediately resets every knob to its static config value and "
         "stops adjusting — behavior becomes bit-identical to "
         "serve_adaptive=False while the controller thread keeps "
         "heartbeating (so un-freezing resumes without a restart).",
         env="SRT_SERVE_CONTROLLER_FREEZE")
register("plan_optimizer", False,
         "Stats-driven plan rewriter (plans/optimizer.py, round 19): "
         "run_governed_plan rewrites every plan to a bounded fixed point "
         "— filter pushdown below GatherJoin/Exchange, filter/project "
         "fusion, join reordering seeded from the table-stats registry "
         "(models/tables.py record_stats/observe_tables) — before the "
         "result-cache key is computed, so equivalent queries "
         "canonicalize to ONE cache entry.  Every rewrite is an exact "
         "algebraic identity of the compiler's masked-row semantics "
         "(bit-identical outputs; fuzzed in tests/test_optimizer.py).  "
         "Each applied rule emits EV_PLAN_REWRITE.  Off (default) = "
         "plans compile exactly as written, round-18 behavior.",
         env="SRT_PLAN_OPTIMIZER")
register("serve_adaptive_exchange", False,
         "Adaptive Exchange execution (serve/shuffle.py, round 19): map "
         "tasks over-partition by serve_adaptive_overpartition, and every "
         "consumer waits for the broadcast shuffle map to show ALL map "
         "sides produced, then greedily groups contiguous partitions by "
         "their MEASURED bytes (targeting serve_adaptive_part_bytes per "
         "reduce; one group = broadcast-style single reduce, fewer groups "
         "than partitions = coalesce) — partition count and join strategy "
         "become runtime decisions driven by real sizes instead of "
         "plan-time guesses.  Exact for the integer additive sinks these "
         "plans aggregate (regrouping reorders rows, never sums).  Each "
         "reduce emits EV_ADAPT_EXCHANGE with its strategy.  Off "
         "(default) = one reduce per plan-time partition, round-18 "
         "behavior.", env="SRT_SERVE_ADAPTIVE_EXCHANGE")
register("serve_adaptive_overpartition", 4,
         "Over-partitioning factor for adaptive exchanges: map sides "
         "emit fanout x this many hash partitions, giving the runtime "
         "grouping step fine-grained units to pack into right-sized "
         "reduces.  Ignored unless serve_adaptive_exchange is set.",
         env="SRT_SERVE_ADAPTIVE_OVERPARTITION")
register("serve_adaptive_part_bytes", 1 << 20,
         "Target measured bytes per adaptive reduce group: the greedy "
         "packer closes a group once it holds at least this many bytes "
         "(total bytes below it collapse to a single broadcast-style "
         "reduce).  Ignored unless serve_adaptive_exchange is set.",
         env="SRT_SERVE_ADAPTIVE_PART_BYTES")
register("serve_hedge", False,
         "Speculative hedging (serve/supervisor.py, round 19): the "
         "health sweep launches ONE duplicate dispatch of a lease that "
         "has sat past serve_hedge_factor x its handler's windowed p99 "
         "on a second ALIVE worker; the first result completes the "
         "lease and the loser is dropped by the existing "
         "incarnation-checked duplicate-drop path (exactly-once stands).  "
         "Bounded: hedges_launched never exceeds serve_hedge_budget_frac "
         "of leases granted, shuffle children are never hedged, and one "
         "hedge max per lease.  Emits EV_HEDGE_LAUNCH / EV_HEDGE_WIN / "
         "EV_HEDGE_LOSE.  Off (default) = stragglers wait for the hang "
         "sweep, round-18 behavior.", env="SRT_SERVE_HEDGE")
register("serve_hedge_factor", 3.0,
         "A lease hedges once its age exceeds this many times its "
         "handler's windowed p99 latency (serve/metrics.py "
         "handler_latency_counts diffed over serve_hedge_window_s).",
         env="SRT_SERVE_HEDGE_FACTOR")
register("serve_hedge_budget_frac", 0.05,
         "Hedge budget: hedges_launched stays at or below this fraction "
         "of leases granted (checked at launch time) — hedging is a "
         "tail-latency tool, never a 2x-dispatch storm.",
         env="SRT_SERVE_HEDGE_BUDGET_FRAC")
register("serve_hedge_min_samples", 8,
         "Windowed completions a handler needs before its p99 is "
         "trusted to trigger hedges — below it, no hedge (a cold "
         "handler's p99 is noise).", env="SRT_SERVE_HEDGE_MIN_SAMPLES")
register("serve_hedge_window_s", 5.0,
         "Width of the sliding latency window the hedge trigger's p99 "
         "is computed over.", env="SRT_SERVE_HEDGE_WINDOW_S")
