"""Distributed request spans: where did request X spend its 80 ms? (A copy of
the JAX package's ``obs/trace.py``.)

The flight recorder (obs/flight.py) answers "what state transitions
happened" per governor task; it cannot answer the operator's first
question during an incident — *which phase of which request is slow,
right now, across which processes*.  This module adds the missing
dimension: a trace context ``(rid, span, parent)`` stamped on every
serving request (the serving tier wires it in) and carried
across the supervisor pipe, so one request's

    queue-wait -> dispatch -> (transport) -> compute -> scatter

breakdown reconstructs LIVE from the telemetry plane (serve/telemetry.py)
— not just post-hoc from anomaly dumps.

Design constraints, in order:

- **the hot path is two deque appends per span** — open and close are
  plain flight events (``EV_SPAN_OPEN``/``EV_SPAN_CLOSE``) whose detail
  string carries the context tokens (``rid:<r>:span:<s>:parent:<p>:
  kind:<k>``), so spans ride the existing ring, the existing telemetry
  export, the existing dump merge, and the existing wire-id freeze with
  zero new transport;
- **ids are cluster-unique without coordination** — a span id packs the
  owning pid into its high bits, so two executors can open spans for one
  rid concurrently and the merge never collides;
- **emission lives HERE only** — every layer opens/closes spans through
  these helpers, which keeps the analyze gate's EVENT_PAIRS balance
  check trivially true (one module emits both sides) and gives the
  reconstruction one grammar to parse.

``rid`` is the request's front-door task id (the supervisor lease id in
cluster serving — the same token lease events already carry), so span
chains and lease chains key the merge identically.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import re
import threading
import time
from typing import Dict, List, Optional

from spark_rapids_jni_tpu_torch.obs import flight as _flight

__all__ = [
    "SPAN_QUEUE", "SPAN_DISPATCH", "SPAN_TRANSPORT", "SPAN_COMPUTE",
    "SPAN_SCATTER", "SPAN_CACHE", "SPAN_KINDS",
    "TraceContext", "new_root", "child_of", "to_wire", "from_wire",
    "open_span", "close_span", "span", "maybe_span",
    "push_current", "pop_current", "current",
    "waterfall", "chain_complete", "format_waterfall",
]

# the span-kind vocabulary (the phases a request waterfall is made of)
SPAN_QUEUE = "queue"          # admission-queue wait (submit -> pop/grant)
SPAN_DISPATCH = "dispatch"    # supervisor lease outstanding on one worker
SPAN_TRANSPORT = "transport"  # shuffle partition fetch (consumer side)
SPAN_COMPUTE = "compute"      # governed handler execution on a worker
SPAN_SCATTER = "scatter"      # batch/ragged result redistribution
SPAN_CACHE = "cache_hit"      # result served from the result cache
#                               (plans/rcache.py round 15): the request
#                               skipped dispatch/compute entirely, so a
#                               hit's waterfall is queue -> cache_hit
SPAN_KINDS = (SPAN_QUEUE, SPAN_DISPATCH, SPAN_TRANSPORT, SPAN_COMPUTE,
              SPAN_SCATTER, SPAN_CACHE)

# span ids are (pid | counter) packed so concurrently-opened spans across
# executor processes never collide in a merged timeline; 20 pid bits
# (Linux pid_max default is < 2^22; collisions would only smear two spans
# into one, never crash) + 28 counter bits per process
_ids = itertools.count(1)


def _new_span_id() -> int:
    return ((os.getpid() & 0xFFFFF) << 28) | (next(_ids) & 0xFFFFFFF)


class TraceContext:
    """One node of a request's span tree: (trace id, span id, parent)."""

    __slots__ = ("rid", "span", "parent")

    def __init__(self, rid: int, span: int, parent: int = 0):
        self.rid = int(rid)
        self.span = int(span)
        self.parent = int(parent)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"TraceContext(rid={self.rid}, span={self.span:x}, "
                f"parent={self.parent:x})")


def new_root(rid: int) -> TraceContext:
    """The root context of one request (rid = front-door task id)."""
    return TraceContext(rid, _new_span_id(), 0)


def child_of(ctx: TraceContext) -> TraceContext:
    """A fresh child context under ``ctx`` (same rid lineage)."""
    return TraceContext(ctx.rid, _new_span_id(), ctx.span)


def to_wire(ctx: Optional[TraceContext]) -> Optional[tuple]:
    """The picklable form carried in MSG_DISPATCH's ``trace`` field."""
    return None if ctx is None else (ctx.rid, ctx.span, ctx.parent)


def from_wire(t) -> Optional[TraceContext]:
    """Parse a wire trace tuple; malformed input degrades to None (an
    untraced request still serves — tracing must never fail dispatch)."""
    try:
        if t is None:
            return None
        rid, span, parent = t
        return TraceContext(int(rid), int(span), int(parent))
    except (TypeError, ValueError):
        return None


# --------------------------------------------------------------------------
# emission (the only module that records EV_SPAN_OPEN / EV_SPAN_CLOSE)
# --------------------------------------------------------------------------


class SpanHandle:
    """An open span: close exactly once (idempotent — races between a
    normal close and a cleanup close are benign)."""

    __slots__ = ("ctx", "kind", "task_id", "extra", "t0_ns", "_closed")

    def __init__(self, ctx: TraceContext, kind: str, task_id: int,
                 extra: str, t0_ns: int):
        self.ctx = ctx
        self.kind = kind
        self.task_id = task_id
        self.extra = extra
        self.t0_ns = t0_ns
        self._closed = False


def _detail(ctx: TraceContext, kind: str, extra: str) -> str:
    d = (f"rid:{ctx.rid}:span:{ctx.span}:parent:{ctx.parent}"
         f":kind:{kind}")
    return f"{d}:{extra}" if extra else d


def open_span(parent: Optional[TraceContext], kind: str, *,
              task_id: int = -1, extra: str = "") -> Optional[SpanHandle]:
    """Open a child span under ``parent`` (None parent = no-op: untraced
    requests cost nothing).  Returns the handle to pass to
    :func:`close_span`."""
    if parent is None:
        return None
    ctx = child_of(parent)
    h = SpanHandle(ctx, kind, task_id, extra, time.monotonic_ns())
    _flight.record(_flight.EV_SPAN_OPEN, task_id,
                   detail=_detail(ctx, kind, extra))
    return h


def close_span(handle: Optional[SpanHandle]) -> None:
    """Close an open span (records the duration); None and double closes
    are no-ops so every cleanup path may call this unconditionally."""
    if handle is None or handle._closed:
        return
    handle._closed = True
    _flight.record(_flight.EV_SPAN_CLOSE, handle.task_id,
                   detail=_detail(handle.ctx, handle.kind, handle.extra),
                   value=time.monotonic_ns() - handle.t0_ns)


@contextlib.contextmanager
def span(parent: Optional[TraceContext], kind: str, *, task_id: int = -1,
         extra: str = ""):
    """Open/close a child span around a block; the child context becomes
    the thread's CURRENT context inside, so nested layers (shuffle
    fetches under a compute span) attach without plumbing."""
    h = open_span(parent, kind, task_id=task_id, extra=extra)
    if h is None:
        yield None
        return
    # close_span owns the whole window from here: push/pop stay paired
    # inside it (push_current is a bare thread-local append — it either
    # appends or leaves the stack untouched), and no fault between open
    # and the inner try can leave the span dangling
    try:
        push_current(h.ctx)
        try:
            yield h.ctx
        finally:
            pop_current()
    finally:
        close_span(h)


@contextlib.contextmanager
def maybe_span(kind: str, *, extra: str = ""):
    """A child span under the thread's current context, or a no-op when
    none is set — how deep layers (serve/shuffle.py fetches) narrate
    without threading a context through every signature."""
    cur = current()
    if cur is None:
        yield None
        return
    with span(cur, kind, extra=extra) as ctx:
        yield ctx


# thread-local current-context stack (handler threads set it around the
# governed run; worker threads are pool-owned so the stack never leaks
# across requests as long as push/pop pair — span() guarantees it)
_tls = threading.local()


def push_current(ctx: TraceContext) -> None:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(ctx)


def pop_current() -> None:
    stack = getattr(_tls, "stack", None)
    if stack:
        stack.pop()


def current() -> Optional[TraceContext]:
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


# --------------------------------------------------------------------------
# reconstruction (flightdump --live / --waterfall, servetop, bench gates)
# --------------------------------------------------------------------------

_TOKENS = re.compile(
    r"(?:^|:)rid:(\d+):span:(\d+):parent:(\d+):kind:([a-z_]+)")


def waterfall(events: List[dict]) -> Dict[str, dict]:
    """Reconstruct per-request span trees from flight-event dicts.

    Accepts raw ring snapshots, anomaly-dump events, AND cluster-merged
    events (which add ``pid``/``wall_s``); open/close match on span id.
    Returns ``{rid: {"spans": [span...], "pids": [...],
    "complete": bool}}`` with each span carrying ``kind``, ``span``,
    ``parent``, ``t0`` (wall_s when available, else t_ns seconds),
    ``dur_ms`` (None while open), ``closed`` and ``pid``.
    """
    spans: Dict[int, dict] = {}
    order = 0
    for e in events:
        k = e.get("kind")
        if k not in ("span_open", "span_close"):
            continue
        m = _TOKENS.search(str(e.get("detail", "")))
        if not m:
            continue
        rid, span_id, parent, skind = (m.group(1), int(m.group(2)),
                                       int(m.group(3)), m.group(4))
        s = spans.get(span_id)
        if s is None:
            order += 1
            s = spans[span_id] = {
                "rid": rid, "span": span_id, "parent": parent,
                "kind": skind, "t0": None, "dur_ms": None,
                "closed": False, "pid": e.get("pid"), "order": order,
            }
        if k == "span_open":
            s["t0"] = (float(e["wall_s"]) if "wall_s" in e
                       else float(e.get("t_ns", 0)) / 1e9)
            if e.get("pid") is not None:
                s["pid"] = e.get("pid")
        else:
            s["closed"] = True
            s["dur_ms"] = round(int(e.get("value", 0)) / 1e6, 3)
            if s["t0"] is None and "wall_s" in e:
                # close seen without its open (ring rolled over): back
                # out the start from the duration so the bar still lands
                s["t0"] = float(e["wall_s"]) - int(e.get("value", 0)) / 1e9
    out: Dict[str, dict] = {}
    for s in spans.values():
        rec = out.setdefault(s["rid"], {"spans": [], "pids": set(),
                                        "complete": False})
        rec["spans"].append(s)
        if s.get("pid") is not None:
            rec["pids"].add(s["pid"])
    for rec in out.values():
        rec["spans"].sort(key=lambda s: (s["t0"] if s["t0"] is not None
                                         else float("inf"), s["order"]))
        rec["pids"] = sorted(rec["pids"])
        rec["complete"] = chain_complete(rec)
    return out


def chain_complete(rec: dict, *, require_dispatch: bool = False) -> bool:
    """True when the request's phase chain completed: the LAST span of
    each required kind (queue, compute, and — where one was ever opened
    — dispatch) is closed.  Judged on the last span per kind, not all
    spans: an attempt orphaned mid-compute by a SIGKILLed executor
    leaves its span open forever, but the re-dispatched attempt's closed
    chain IS the request's complete story — redispatch churn shows as
    extra bars, never as "incomplete"."""
    last: Dict[str, dict] = {}
    for s in rec["spans"]:  # spans are sorted by (t0, emission order)
        last[s["kind"]] = s
    if SPAN_CACHE in last and SPAN_COMPUTE not in last:
        # a result-cache hit never dispatched or computed: its complete
        # story is queue -> cache_hit (the round-15 short-circuit shape)
        need = {SPAN_QUEUE, SPAN_CACHE}
    else:
        need = {SPAN_QUEUE, SPAN_COMPUTE}
        if require_dispatch or SPAN_DISPATCH in last:
            need.add(SPAN_DISPATCH)
    return all(k in last and last[k]["closed"] for k in need)


def format_waterfall(rec: dict, *, width: int = 48) -> List[str]:
    """Render one rid's spans as indented bars on a shared time base."""
    spans = [s for s in rec["spans"] if s["t0"] is not None]
    if not spans:
        return ["  (no timed spans)"]
    t0 = min(s["t0"] for s in spans)
    span_end = max((s["t0"] + (s["dur_ms"] or 0.0) / 1e3) for s in spans)
    total = max(span_end - t0, 1e-9)
    depth = {s["span"]: s for s in spans}
    lines = []
    for s in spans:
        d, p = 0, s["parent"]
        while p in depth and d < 8:
            d += 1
            p = depth[p]["parent"]
        off = int(width * (s["t0"] - t0) / total)
        dur_s = (s["dur_ms"] or 0.0) / 1e3
        bar = max(1, int(width * dur_s / total)) if s["closed"] else 1
        mark = "=" * bar if s["closed"] else ">"
        dur = (f"{s['dur_ms']:9.3f} ms" if s["closed"] else "   OPEN     ")
        pid = f" pid {s['pid']}" if s.get("pid") is not None else ""
        lines.append(f"  {'  ' * d}{s['kind']:<10}{dur} "
                     f"|{' ' * off}{mark:<{max(1, width - off)}}|{pid}")
    return lines
