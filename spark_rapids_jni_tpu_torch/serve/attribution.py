"""Per-tenant resource attribution + the cluster capacity observatory (a copy
of the JAX package's ``serve/attribution.py``).

ROADMAP open item 1 (elastic fleet + tenant fairness) needs an
autoscaler and weighted-fair admission that steer on *measured*
per-tenant dominant-resource usage and cluster headroom.  Before this
module those signals did not exist: sessions tracked bytes charged, but
nothing attributed compute time, governed byte·seconds, queue wait,
transport bytes, or cache residency back to the tenant that caused
them.  This module is that signal plane, in two halves:

**Worker-side metering.**  Every request carries an
:class:`AttributionRecord`; a thread-local meter pointer makes the
record reachable from the layers a request flows through without
threading it by hand — ``mem/governed`` reservations report
byte·seconds at release, ``serve/shuffle`` reports transport bytes per
fetched partition, ``plans/rcache`` reports hits/misses and residency
bytes.  The executor accumulates compute ns at the same sites it
records run latency, and emits ONE ``EV_ATTRIB`` flight event per
terminal request (:func:`emit`) — so attribution rides the existing
MSG_TELEMETRY delta path and survives SIGKILL exactly like spans do.
Alongside the per-request records, two process-cumulative counters —
worker busy ns and governor byte·ns — ship in every telemetry export's
metrics (:func:`worker_gauges`); they are the independent measurement
the completeness gates reconcile the attributed sums against.

**Supervisor-side rollup.**  :class:`AttributionRollup` folds
``EV_ATTRIB`` events (fed post-dedup from the cluster timeline, so a
re-ingested delta can never double-count) into a bounded, lock-sharded
per-tenant/per-handler ledger with fixed-width downsampled windows
(10s/1m/10m), computing per-tenant dominant-resource share,
per-resource cluster utilization, and capacity headroom (fleet capacity
minus P95 windowed demand).  ``EV_HEDGE_LOSE`` marks a rid's cost
``wasted`` — hedge losers are attributed, then flagged.  The snapshot
is served as the ``attribution`` section of the telemetry endpoint and
summarized into ``MSG_PRESSURE`` gauges.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from spark_rapids_jni_tpu_torch.obs import flight as _flight

__all__ = [
    "AttributionRecord", "AttributionRollup",
    "metered", "active_record", "emit",
    "note_reservation", "note_tx", "note_cache_hit", "note_cache_miss",
    "note_cache_store", "note_busy",
    "worker_gauges", "reset_worker_counters_for_tests",
    "parse_detail", "RESOURCES",
]

# the dominant-resource vocabulary the rollup accounts per tenant:
# compute ns, governed byte·ns (reservation size x hold time), queue
# wait ns, and transport bytes — each with its own cluster capacity
# model (see AttributionRollup.set_capacity)
RESOURCES = ("comp_ns", "gbs", "queue_ns", "tx_bytes")


class AttributionRecord:
    """One request's resource ledger, accumulated while it is served."""

    __slots__ = ("rid", "tenant", "handler", "comp_ns", "gbs", "queue_ns",
                 "blocked_ns", "tx_bytes", "res_bytes", "hits", "misses",
                 "retries", "splits", "flags")

    def __init__(self, rid: int = -1, tenant: str = "", handler: str = ""):
        self.rid = rid
        self.tenant = tenant
        self.handler = handler
        self.comp_ns = 0       # handler compute windows (run_ns sites)
        self.gbs = 0           # governed byte·ns: sum(nbytes x held_ns)
        self.queue_ns = 0      # admission-queue wait
        self.blocked_ns = 0    # parked under governor pressure
        self.tx_bytes = 0      # shuffle/transport bytes fetched
        self.res_bytes = 0     # result-cache residency bytes touched
        self.hits = 0          # result-cache hits
        self.misses = 0        # result-cache misses
        self.retries = 0       # RetryOOM deliveries
        self.splits = 0        # split/presplit re-queues
        self.flags: set = set()  # "split" | "cache" | "hedge"


# --------------------------------------------------------------------------
# worker-side metering: the thread-local meter + process counters
# --------------------------------------------------------------------------

_TLS = threading.local()

# Process-cumulative reconciliation counters: attributed sums must cover
# these independent measurements (completeness gates, serve_bench
# --tenant-storm).  int += is not GIL-atomic, so one leaf lock guards
# both; it is uncontended and never held across any other call.
_COUNTER_LOCK = threading.Lock()
_BUSY_NS = [0]       # protected by _COUNTER_LOCK
_GOV_BYTE_NS = [0]   # protected by _COUNTER_LOCK


class metered:
    """Bind ``rec`` as the calling thread's active attribution record
    for the ``with`` scope.  Re-entrant by save/restore: the executor's
    inline presplit child runs nested inside the parent's serve scope,
    and each must meter into its OWN record."""

    __slots__ = ("rec", "_prev")

    def __init__(self, rec: Optional[AttributionRecord]):
        self.rec = rec
        self._prev = None

    def __enter__(self):
        self._prev = getattr(_TLS, "rec", None)
        _TLS.rec = self.rec
        return self.rec

    def __exit__(self, *exc):
        _TLS.rec = self._prev
        return False


def active_record() -> Optional[AttributionRecord]:
    """The calling thread's active record, or None (metering off)."""
    return getattr(_TLS, "rec", None)


def note_reservation(nbytes: int, held_ns: int) -> None:
    """A governed reservation released after ``held_ns``: byte·seconds
    metering (mem/governed.py calls this on every release).  The
    process-cumulative counter advances unconditionally — it is the
    governor-side measurement attribution reconciles against — while
    the per-request share lands on the active record when one is
    bound."""
    byte_ns = int(nbytes) * max(int(held_ns), 0)
    with _COUNTER_LOCK:
        _GOV_BYTE_NS[0] += byte_ns
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.gbs += byte_ns


def note_busy(run_ns: int) -> None:
    """A worker thread finished ``run_ns`` of handler compute — called
    at exactly the sites that attribute comp_ns to a record, so the
    coverage gate compares like against like."""
    with _COUNTER_LOCK:
        _BUSY_NS[0] += max(int(run_ns), 0)


def note_tx(nbytes: int) -> None:
    """Transport bytes fetched for the active request (serve/shuffle)."""
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.tx_bytes += int(nbytes)


def note_cache_hit(nbytes: int) -> None:
    """A result-cache hit served ``nbytes`` of resident value bytes."""
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.hits += 1
        rec.res_bytes += int(nbytes)
        rec.flags.add("cache")


def note_cache_miss() -> None:
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.misses += 1


def note_cache_store(nbytes: int) -> None:
    """A computed result entered cache residency (counted as residency
    bytes the request added, on top of any hit bytes it consumed)."""
    rec = getattr(_TLS, "rec", None)
    if rec is not None:
        rec.res_bytes += int(nbytes)


def worker_gauges() -> dict:
    """The cumulative reconciliation gauges shipped in every telemetry
    export's metrics dict (serve/rpc.py merges them in, so they ride
    force-flushes too — the same message that carries the EV_ATTRIB
    events, which is what keeps reconciliation SIGKILL-tight)."""
    with _COUNTER_LOCK:
        busy, gov = _BUSY_NS[0], _GOV_BYTE_NS[0]
    ring = _flight.ring_stats()
    return {"attrib_busy_ns": busy, "attrib_gov_byte_ns": gov,
            "ring_dropped": ring["dropped"]}


def reset_worker_counters_for_tests() -> None:
    with _COUNTER_LOCK:
        _BUSY_NS[0] = 0
        _GOV_BYTE_NS[0] = 0


# --------------------------------------------------------------------------
# the EV_ATTRIB wire grammar (detail tokens; see obs/flight.py)
# --------------------------------------------------------------------------

# (record attr, token) pairs appended nonzero-only, in this order
_OPT_TOKENS = (("gbs", "gbs"), ("queue_ns", "q"), ("blocked_ns", "blk"),
               ("tx_bytes", "tx"), ("res_bytes", "res"), ("hits", "hit"),
               ("misses", "miss"), ("retries", "retry"),
               ("splits", "split"))


def emit(rec: AttributionRecord, task_id: int = -1) -> None:
    """Record ``rec`` as ONE EV_ATTRIB flight event.  Called exactly
    once per request, from the single terminal-state owner (_finish) —
    the response's first-wins completion makes double emission
    structurally impossible."""
    tenant = str(rec.tenant).replace(":", "_") or "-"
    handler = str(rec.handler).replace(":", "_") or "-"
    parts = [f"rid:{rec.rid}:tenant:{tenant}:handler:{handler}"
             f":comp:{rec.comp_ns}"]
    for attr, token in _OPT_TOKENS:
        v = getattr(rec, attr)
        if v:
            parts.append(f"{token}:{v}")
    if rec.flags:
        parts.append(f"flags:{'+'.join(sorted(rec.flags))}")
    _flight.record(_flight.EV_ATTRIB, task_id, detail=":".join(parts),
                   value=rec.comp_ns)


_TOKEN_FIELDS = {"comp": "comp_ns", "gbs": "gbs", "q": "queue_ns",
                 "blk": "blocked_ns", "tx": "tx_bytes", "res": "res_bytes",
                 "hit": "hits", "miss": "misses", "retry": "retries",
                 "split": "splits"}


def parse_detail(detail: str) -> Optional[dict]:
    """Decode one EV_ATTRIB detail string back into a field dict, or
    None when it does not parse (foreign/truncated detail — counted by
    the rollup, never raised)."""
    toks = str(detail).split(":")
    out: Dict[str, Any] = {f: 0 for f in _TOKEN_FIELDS.values()}
    out["flags"] = ()
    i, n = 0, len(toks)
    seen_rid = False
    while i + 1 < n:
        key, val = toks[i], toks[i + 1]
        if key == "rid":
            try:
                out["rid"] = int(val)
            except ValueError:
                return None
            seen_rid = True
        elif key in ("tenant", "handler"):
            out[key] = val
        elif key == "flags":
            out["flags"] = tuple(val.split("+"))
        elif key in _TOKEN_FIELDS:
            try:
                out[_TOKEN_FIELDS[key]] = int(val)
            except ValueError:
                return None
        i += 2
    if not seen_rid or "tenant" not in out or "handler" not in out:
        return None
    return out


# --------------------------------------------------------------------------
# supervisor-side rollup: tenants, handlers, windows, capacity
# --------------------------------------------------------------------------

# downsampled window tiers: (label, width_s, slots).  Cluster-wide rings
# use the full slot counts; per-tenant/per-handler rings use the
# smaller _ENTITY_SLOTS so 1000+ tracked entities stay bounded.
WINDOW_TIERS = (("10s", 10.0, 30), ("1m", 60.0, 30), ("10m", 600.0, 24))
_ENTITY_SLOTS = {"10s": 12, "1m": 10, "10m": 6}


class _WindowRing:
    """One fixed-width downsampled ring: slot = wall-epoch modulo the
    slot count, reset lazily when a new epoch claims it."""

    __slots__ = ("width_s", "nslots", "epochs", "sums")

    def __init__(self, width_s: float, nslots: int):
        self.width_s = float(width_s)
        self.nslots = int(nslots)
        self.epochs = [-1] * self.nslots
        self.sums: List[Optional[Dict[str, int]]] = [None] * self.nslots

    def add(self, wall_s: float, fields: Dict[str, int]) -> None:
        ep = int(wall_s // self.width_s)
        i = ep % self.nslots
        if self.epochs[i] != ep:
            self.epochs[i] = ep
            self.sums[i] = {}
        d = self.sums[i]
        for k, v in fields.items():
            if v:
                d[k] = d.get(k, 0) + v

    def rates(self) -> List[Dict[str, float]]:
        """Per-populated-slot per-second demand rates, oldest first."""
        order = sorted((ep, i) for i, ep in enumerate(self.epochs)
                       if ep >= 0)
        return [{k: v / self.width_s for k, v in self.sums[i].items()}
                for _, i in order if self.sums[i] is not None]


def _p95(values: List[float]) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    return vs[min(len(vs) - 1, int(0.95 * len(vs)))]


class _EntityStats:
    """Bounded per-tenant (or per-handler) ledger entry: lifetime totals
    plus small per-tier demand rings."""

    __slots__ = ("totals", "wasted_ns", "requests", "rings")

    def __init__(self):
        self.totals = {"comp_ns": 0, "gbs": 0, "queue_ns": 0,
                       "blocked_ns": 0, "tx_bytes": 0, "res_bytes": 0,
                       "hits": 0, "misses": 0, "retries": 0, "splits": 0}
        self.wasted_ns = 0
        self.requests = 0
        self.rings = {label: _WindowRing(width, _ENTITY_SLOTS[label])
                      for label, width, _ in WINDOW_TIERS}

    def add(self, wall_s: float, rec: dict) -> None:
        t = self.totals
        for k in t:
            t[k] += int(rec.get(k, 0))
        self.requests += 1
        self.rings_add(wall_s, rec)

    def rings_add(self, wall_s: float, rec: dict) -> None:
        fields = {r: int(rec.get(r, 0)) for r in RESOURCES}
        for ring in self.rings.values():
            ring.add(wall_s, fields)

    def fold(self, other: "_EntityStats") -> None:
        """Absorb an evicted entry's totals (the '~other' bucket) so
        cluster sums stay exact under the tenant cap."""
        for k, v in other.totals.items():
            self.totals[k] += v
        self.wasted_ns += other.wasted_ns
        self.requests += other.requests


_N_SHARDS = 8
_TENANTS_PER_SHARD = 256   # LRU-evicted into "~other" past this
_MAX_HANDLERS = 256
_MAX_RIDS = 4096
_OTHER = "~other"


class _TenantShard:
    """One lock + LRU tenant table: tenant ingest shards on
    hash(tenant) so hot rollup never funnels through one lock."""

    __slots__ = ("lock", "tenants")

    def __init__(self):
        self.lock = threading.Lock()
        self.tenants: OrderedDict = OrderedDict()  # guarded-by: lock


class AttributionRollup:
    """The supervisor's bounded fold of EV_ATTRIB events into
    per-tenant/per-handler ledgers, cluster demand windows, and the
    capacity/headroom model.  Feed it post-dedup events only (the
    cluster timeline's on_event hook): dedup upstream is what makes a
    re-ingested telemetry delta unable to double-count."""

    def __init__(self):
        self._shards = [_TenantShard() for _ in range(_N_SHARDS)]
        self._lock = threading.Lock()
        # cluster-wide demand rings, full tier widths
        self._rings = {  # guarded-by: _lock
            label: _WindowRing(width, slots)
            for label, width, slots in WINDOW_TIERS}
        self._cluster = _EntityStats()  # guarded-by: _lock
        self._handlers: OrderedDict = OrderedDict()  # guarded-by: _lock
        # bounded per-rid cost table (flightdump --attrib breakdowns +
        # hedge-waste marking, order-independent with the cost events)
        self._rids: OrderedDict = OrderedDict()  # guarded-by: _lock
        self._events = 0  # guarded-by: _lock
        self._unparsed = 0  # guarded-by: _lock
        self._rids_evicted = 0  # guarded-by: _lock
        # fleet capacity model (set_capacity) — rates per second
        self._capacity = {  # guarded-by: _lock
            "workers": 0, "threads": 0, "budget_bytes": 0}
        # per-(worker, incarnation) high-water of the cumulative worker
        # reconciliation gauges; sums across incarnations survive kills
        self._gauge_hw: Dict[tuple, dict] = {}  # guarded-by: _lock

    # -- ingest -------------------------------------------------------------
    def ingest_event(self, ev: dict) -> None:
        """Fold one (deduped) flight event.  EV_ATTRIB adds costs;
        EV_HEDGE_LOSE marks the rid's cost wasted.  Anything else is
        ignored, so callers may feed the whole stream."""
        kind = ev.get("kind")
        if kind == _flight.EV_ATTRIB:
            rec = parse_detail(ev.get("detail", ""))
            wall_s = float(ev.get("wall_s", 0.0))
            if rec is None:
                with self._lock:
                    self._unparsed += 1
                return
            self._fold_record(wall_s, rec)
        elif kind == _flight.EV_HEDGE_LOSE:
            m = str(ev.get("detail", "")).split(":")
            if len(m) >= 2 and m[0] == "rid":
                try:
                    self._mark_wasted(int(m[1]))
                except ValueError:
                    pass

    def _fold_record(self, wall_s: float, rec: dict) -> None:
        tenant = rec.get("tenant") or "-"
        handler = rec.get("handler") or "-"
        shard = self._shards[hash(tenant) % _N_SHARDS]
        wasted_extra = 0
        with shard.lock:
            st = shard.tenants.get(tenant)
            if st is None:
                if len(shard.tenants) >= _TENANTS_PER_SHARD:
                    _, evicted = shard.tenants.popitem(last=False)
                    other = shard.tenants.setdefault(_OTHER,
                                                     _EntityStats())
                    other.fold(evicted)
                st = shard.tenants[tenant] = _EntityStats()
            else:
                shard.tenants.move_to_end(tenant)
            st.add(wall_s, rec)
        with self._lock:
            self._events += 1
            self._cluster.add(wall_s, rec)
            fields = {r: int(rec.get(r, 0)) for r in RESOURCES}
            for ring in self._rings.values():
                ring.add(wall_s, fields)
            h = self._handlers.get(handler)
            if h is None:
                if len(self._handlers) >= _MAX_HANDLERS:
                    _, ev_h = self._handlers.popitem(last=False)
                    hh = self._handlers.setdefault(_OTHER, _EntityStats())
                    hh.fold(ev_h)
                h = self._handlers[handler] = _EntityStats()
            else:
                self._handlers.move_to_end(handler)
            h.add(wall_s, rec)
            entry = self._entry_locked(rec["rid"])
            entry["tenant"] = tenant
            entry["handler"] = handler
            for k in self._cluster.totals:
                entry[k] = entry.get(k, 0) + int(rec.get(k, 0))
            for f in rec.get("flags", ()):
                entry.setdefault("flags", set()).add(f)
            entry["events"] = entry.get("events", 0) + 1
            if entry.get("wasted"):
                # costs landing AFTER the hedge-lose marker still count
                # as waste (order independence)
                wasted_extra = int(rec.get("comp_ns", 0))
        if wasted_extra:
            self._add_wasted(tenant, wasted_extra)

    def _entry_locked(self, rid: int) -> dict:
        entry = self._rids.get(rid)
        if entry is None:
            if len(self._rids) >= _MAX_RIDS:
                self._rids.popitem(last=False)
                self._rids_evicted += 1
            entry = self._rids[rid] = {}
        else:
            self._rids.move_to_end(rid)
        return entry

    def _mark_wasted(self, rid: int) -> None:
        with self._lock:
            entry = self._entry_locked(rid)
            already = entry.get("wasted", False)
            entry["wasted"] = True
            tenant = entry.get("tenant")
            comp = int(entry.get("comp_ns", 0)) if not already else 0
        if tenant and comp:
            self._add_wasted(tenant, comp)

    def _add_wasted(self, tenant: str, comp_ns: int) -> None:
        shard = self._shards[hash(tenant) % _N_SHARDS]
        with shard.lock:
            st = shard.tenants.get(tenant)
            if st is None:
                st = shard.tenants.get(_OTHER)
            if st is not None:
                st.wasted_ns += comp_ns

    def note_worker_gauges(self, worker_id: int, incarnation: int,
                           metrics: Optional[dict]) -> None:
        """High-water the cumulative worker reconciliation gauges per
        incarnation (each incarnation's counters restart at 0; summing
        the high-waters across incarnations survives SIGKILL)."""
        if not metrics:
            return
        gauges = metrics.get("gauges") or {}
        src = gauges if "attrib_busy_ns" in gauges else metrics
        if "attrib_busy_ns" not in src:
            return
        key = (int(worker_id), int(incarnation))
        with self._lock:
            hw = self._gauge_hw.setdefault(
                key, {"attrib_busy_ns": 0, "attrib_gov_byte_ns": 0,
                      "ring_dropped": 0})
            for k in hw:
                hw[k] = max(hw[k], int(src.get(k, 0)))

    def set_capacity(self, *, workers: int, threads: int,
                     budget_bytes: int) -> None:
        """The fleet capacity model: ``workers`` alive executors x
        ``threads`` engine workers each (compute: threads x 1e9 ns/s),
        and ``budget_bytes`` governed budget per executor (byte·ns/s =
        budget x 1e9)."""
        with self._lock:
            self._capacity = {"workers": int(workers),
                              "threads": int(threads),
                              "budget_bytes": int(budget_bytes)}

    # -- views --------------------------------------------------------------
    def measured(self) -> dict:
        """Summed worker reconciliation gauges across incarnations."""
        with self._lock:
            out = {"busy_ns": 0, "gov_byte_ns": 0, "ring_dropped": 0}
            for hw in self._gauge_hw.values():
                out["busy_ns"] += hw["attrib_busy_ns"]
                out["gov_byte_ns"] += hw["attrib_gov_byte_ns"]
                out["ring_dropped"] += hw["ring_dropped"]
            return out

    def _capacity_rates_locked(self) -> Dict[str, float]:
        cap = self._capacity
        return {
            "comp_ns": cap["workers"] * cap["threads"] * 1e9,
            "gbs": cap["workers"] * cap["budget_bytes"] * 1e9,
            # queue wait has no capacity (it IS the shortfall signal);
            # transport is bounded by the governed budget flow
            "queue_ns": 0.0,
            "tx_bytes": cap["workers"] * float(cap["budget_bytes"]),
        }

    def snapshot(self, top: int = 32) -> dict:
        """The attribution section of the telemetry endpoint view."""
        tenants: Dict[str, _EntityStats] = {}
        for shard in self._shards:
            with shard.lock:
                for name, st in shard.tenants.items():
                    tenants[name] = st  # snapshot read; totals are ints
        with self._lock:
            cluster_totals = dict(self._cluster.totals)
            cluster_wasted = self._cluster.wasted_ns
            requests = self._cluster.requests
            cap_rates = self._capacity_rates_locked()
            capacity = dict(self._capacity)
            windows = {}
            for label, ring in self._rings.items():
                rates = ring.rates()
                windows[label] = {
                    "width_s": ring.width_s,
                    "slots": len(rates),
                    "p95": {r: round(_p95([s.get(r, 0.0) for s in rates]),
                                     3)
                            for r in RESOURCES},
                }
            handlers = {
                name: {"requests": h.requests,
                       "comp_ns": h.totals["comp_ns"],
                       "gbs": h.totals["gbs"],
                       "queue_ns": h.totals["queue_ns"]}
                for name, h in self._handlers.items()
            }
            events = self._events
            unparsed = self._unparsed
            rids_tracked = len(self._rids)
            rids_evicted = self._rids_evicted
        p95_10s = windows.get("10s", {}).get("p95", {})
        utilization = {}
        headroom = {}
        for r in RESOURCES:
            cap_r = cap_rates.get(r, 0.0)
            demand = float(p95_10s.get(r, 0.0))
            if cap_r > 0:
                utilization[r] = round(min(1.0, demand / cap_r), 4)
                headroom[r] = round(cap_r - demand, 3)
            else:
                utilization[r] = None
                headroom[r] = None
        rows = []
        for name, st in tenants.items():
            shares = {
                r: (st.totals[r] / cluster_totals[r]
                    if cluster_totals.get(r) else 0.0)
                for r in RESOURCES
            }
            dom_res = max(shares, key=lambda r: shares[r])
            rows.append({
                "tenant": name,
                "dominant_share": round(shares[dom_res], 4),
                "dominant_resource": dom_res,
                "shares": {r: round(v, 4) for r, v in shares.items()},
                "requests": st.requests,
                "wasted_ns": st.wasted_ns,
                **st.totals,
            })
        rows.sort(key=lambda t: -t["dominant_share"])
        measured = self.measured()
        attributed_comp = cluster_totals.get("comp_ns", 0)
        coverage = (attributed_comp / measured["busy_ns"]
                    if measured["busy_ns"] > 0 else None)
        return {
            "events": events,
            "unparsed": unparsed,
            "requests": requests,
            "tenants_tracked": len(tenants),
            "tenants": rows[:top],
            "handlers": handlers,
            "cluster": {**cluster_totals, "wasted_ns": cluster_wasted},
            "windows": windows,
            "capacity": {**capacity, "rates": cap_rates},
            "utilization": utilization,
            "headroom": headroom,
            "measured": measured,
            "coverage_comp": (round(coverage, 4)
                              if coverage is not None else None),
            "rids_tracked": rids_tracked,
            "rids_evicted": rids_evicted,
        }

    def pressure_gauges(self) -> dict:
        """The compact summary exported into MSG_PRESSURE's cluster
        dict: top tenant dominant share + per-resource headroom
        fractions — enough for the admission controller to SEE tenant
        skew and capacity margin (acting on them is PR 21)."""
        snap = self.snapshot(top=1)
        top = snap["tenants"][0] if snap["tenants"] else None
        util = snap["utilization"]
        return {
            "attrib_top_tenant": top["tenant"] if top else "",
            "attrib_top_share": top["dominant_share"] if top else 0.0,
            "attrib_headroom_comp_frac": (
                round(1.0 - util["comp_ns"], 4)
                if util.get("comp_ns") is not None else None),
            "attrib_headroom_gbs_frac": (
                round(1.0 - util["gbs"], 4)
                if util.get("gbs") is not None else None),
        }

    def rid_breakdown(self, rid: Optional[int] = None) -> Any:
        """Per-rid cost entries (flightdump --attrib): one rid's dict,
        or all tracked rids newest-last."""
        with self._lock:
            if rid is not None:
                e = self._rids.get(rid)
                return self._rid_row(rid, e) if e is not None else None
            return [self._rid_row(r, e) for r, e in self._rids.items()]

    @staticmethod
    def _rid_row(rid: int, e: dict) -> dict:
        row = {k: (sorted(v) if isinstance(v, set) else v)
               for k, v in e.items()}
        row["rid"] = rid
        return row
