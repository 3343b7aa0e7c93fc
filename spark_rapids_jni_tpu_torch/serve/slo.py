"""SLO burn-rate engine: declared objectives, multi-window evaluation (a
copy of the JAX package's ``serve/slo.py``).

The degradation ladder (round 10) and the admission controller (round 9)
steer on RESOURCE pressure — memory, blocked time, queue occupancy.  None
of that says whether the service is keeping its promises: a cluster can
sit at 40% memory while one tenant's p99 quietly triples.  This module
closes that gap with the SRE-standard formulation:

- an **objective** declares an acceptable violation fraction — latency
  (at most 1% of requests over ``p99_ms``), errors (at most
  ``error_frac`` failed), shed (at most ``shed_frac`` of a tenant's
  submits rejected by degradation);
- the **burn rate** of a window is (observed violation fraction) /
  (allowed fraction): 1.0 burns the budget exactly as fast as allowed,
  2.0 twice as fast;
- burn is evaluated over **two windows** (fast + slow): entering burn
  requires BOTH elevated — the fast window makes the alert prompt, the
  slow window keeps a single straggler from tripping it; recovery
  requires the fast window back under the exit threshold (hysteresis).

Every state change is ledger-visible: ``EV_SLO_BURN`` on entry,
``EV_SLO_OK`` on recovery (a declared EVENT_PAIRS pair — a layer that can
declare burn must be able to declare recovery), plus a bounded ledger of
decisions.  :meth:`BurnRateEngine.pressure` folds burning objectives into
the [0, 1] stress signal the supervisor's ladder already consumes, and
the supervisor broadcasts it to every worker's admission controller as
the ``slo_frac`` gauge of MSG_PRESSURE — SLO burn is a first-class
pressure source, not a dashboard afterthought.

Objectives come from the ``serve_slo_config`` flag (JSON) or are passed
programmatically; the schema is documented in docs/OBSERVABILITY.md.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Callable, List, Optional

from spark_rapids_jni_tpu_torch.obs import flight as _flight

__all__ = ["SLO", "BurnRateEngine", "parse_slo_config"]


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declared objective set for a handler class or a tenant.

    Exactly one of ``handler``/``tenant`` scopes it (``handler="*"``
    covers the whole service via the global latency histogram).  Unset
    objective fields are simply not evaluated.
    """

    name: str
    handler: Optional[str] = None    # handler class ("*" = service-wide)
    tenant: Optional[str] = None     # session id (error/shed objectives)
    p99_ms: Optional[float] = None   # latency target (1% violation budget)
    error_frac: Optional[float] = None  # allowed failed fraction
    shed_frac: Optional[float] = None   # allowed degraded-reject fraction

    def __post_init__(self):
        if (self.handler is None) == (self.tenant is None):
            raise ValueError(
                f"SLO {self.name!r}: exactly one of handler/tenant")
        if self.tenant is not None and self.p99_ms is not None:
            raise ValueError(
                f"SLO {self.name!r}: latency objectives are per-handler "
                f"(per-tenant latency histograms are not tracked)")
        if (self.p99_ms is None and self.error_frac is None
                and self.shed_frac is None):
            raise ValueError(f"SLO {self.name!r} declares no objective")


def parse_slo_config(text: str) -> List[SLO]:
    """The ``serve_slo_config`` JSON schema: a list of SLO dicts."""
    if not text or not text.strip():
        return []
    raw = json.loads(text)
    if not isinstance(raw, list):
        raise ValueError("serve_slo_config must be a JSON list")
    out = []
    for i, d in enumerate(raw):
        if not isinstance(d, dict):
            raise ValueError(f"serve_slo_config[{i}] is not an object")
        out.append(SLO(
            name=str(d.get("name", f"slo{i}")),
            handler=d.get("handler"),
            tenant=d.get("tenant"),
            p99_ms=(float(d["p99_ms"]) if d.get("p99_ms") is not None
                    else None),
            error_frac=(float(d["error_frac"])
                        if d.get("error_frac") is not None else None),
            shed_frac=(float(d["shed_frac"])
                       if d.get("shed_frac") is not None else None),
        ))
    return out


# the latency budget: a p99 objective allows 1% of requests over target
_LATENCY_BUDGET_FRAC = 0.01


def _violating_counts(counts: List[int], target_ns: int) -> int:
    """Requests whose log2 latency bucket lies entirely above target
    (bucket i covers [2^i, 2^(i+1)) ns — conservative: the bucket that
    straddles the target is not counted)."""
    if not counts:
        return 0
    first = max(0, target_ns.bit_length())  # lowest bucket fully above
    return sum(counts[first:])


class _Objective:
    """Runtime state of one (SLO, objective-kind) pair."""

    __slots__ = ("slo", "kind", "burning", "since_t", "last_fast",
                 "last_slow")

    def __init__(self, slo: SLO, kind: str):
        self.slo = slo
        self.kind = kind            # "latency" | "error" | "shed"
        self.burning = False
        self.since_t = 0.0
        self.last_fast = 0.0
        self.last_slow = 0.0


class BurnRateEngine:
    """Evaluates declared SLOs over multi-window burn rates.

    ``metrics_source`` returns the cumulative sample the windows diff:
    ``{"handler_latency_counts": {h: [bucket counts]},
    "run_latency_counts": [...], "counters": {...},
    "sessions": {sid: {...}}}`` — :func:`supervisor_metrics_source`
    adapts a ServeMetrics; tests inject synthetic shapes directly.
    """

    def __init__(self, slos: List[SLO],
                 metrics_source: Callable[[], dict], *,
                 fast_window_s: float = 5.0, slow_window_s: float = 60.0,
                 enter_burn: float = 1.0, exit_burn: float = 0.5,
                 min_samples: int = 8, pressure_clip: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.slos = list(slos)
        self._metrics_source = metrics_source
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.enter_burn = float(enter_burn)
        self.exit_burn = float(exit_burn)
        self.min_samples = int(min_samples)
        self.pressure_clip = float(pressure_clip)
        self._clock = clock
        self._lock = threading.Lock()
        # (now, sample) history long enough to cover the slow window
        self._samples: List[tuple] = []  # guarded-by: _lock
        # the objective LIST is frozen after __init__ (lock-free reads
        # are safe); each _Objective's mutable fields are only touched
        # under _lock
        self._objectives: List[_Objective] = []
        self.ledger: List[dict] = []  # guarded-by: _lock
        for slo in self.slos:
            if slo.p99_ms is not None:
                self._objectives.append(_Objective(slo, "latency"))
            if slo.error_frac is not None:
                self._objectives.append(_Objective(slo, "error"))
            if slo.shed_frac is not None:
                self._objectives.append(_Objective(slo, "shed"))

    # -- sampling ------------------------------------------------------------
    def tick(self) -> None:
        """One evaluation step (the supervisor's monitor tick calls it;
        tests drive it with an injected clock)."""
        if not self._objectives:
            return
        now = self._clock()
        try:
            sample = self._metrics_source()
        # analyze: ignore[retry-protocol] - metrics sampling on the
        # monitor tick: a failing source (engine mid-shutdown) skips the
        # tick, never kills the monitor
        except Exception:  # noqa: BLE001
            return
        transitions = []
        with self._lock:
            self._samples.append((now, sample))
            # retain one sample older than the slow window (the diff base)
            cutoff = now - self.slow_window_s
            while (len(self._samples) > 2
                   and self._samples[1][0] <= cutoff):
                self._samples.pop(0)
            for obj in self._objectives:
                fast = self._burn_locked(obj, now, self.fast_window_s,
                                         sample)
                slow = self._burn_locked(obj, now, self.slow_window_s,
                                         sample)
                obj.last_fast, obj.last_slow = fast, slow
                if (not obj.burning and fast >= self.enter_burn
                        and slow >= self.enter_burn):
                    obj.burning = True
                    obj.since_t = now
                    transitions.append((obj, True, fast, slow))
                elif obj.burning and fast <= self.exit_burn:
                    obj.burning = False
                    transitions.append((obj, False, fast, slow))
            for obj, burning, fast, slow in transitions:
                self.ledger.append({
                    "t_ns": time.monotonic_ns(),
                    "slo": obj.slo.name, "objective": obj.kind,
                    "state": "burn" if burning else "ok",
                    "burn_fast": round(fast, 3),
                    "burn_slow": round(slow, 3),
                })
            del self.ledger[:-256]
        for obj, burning, fast, slow in transitions:
            detail = (f"slo:{obj.slo.name}:obj:{obj.kind}"
                      f":burn:{fast:.2f}")
            if burning:
                _flight.record(_flight.EV_SLO_BURN, -1, detail=detail,
                               value=int(fast * 1000))
            else:
                _flight.record(_flight.EV_SLO_OK, -1, detail=detail,
                               value=int(fast * 1000))

    def _window_base(self, now: float, window_s: float) -> Optional[dict]:
        """(Caller holds ``self._lock``.)  The newest sample at least
        ``window_s`` old — None until the history spans the window."""
        base = None
        for t, s in self._samples:
            if t <= now - window_s:
                base = s
            else:
                break
        return base

    def _burn_locked(self, obj: _Objective, now: float, window_s: float,
                     sample: dict) -> float:
        base = self._window_base(now, window_s)
        if base is None:
            # no full window yet: a brand-new engine reports zero burn
            # rather than alerting off a sliver of history
            return 0.0
        viol, total, budget = self._violation(obj, base, sample)
        if total < self.min_samples or budget <= 0:
            return 0.0
        return (viol / total) / budget

    @staticmethod
    def _counts_delta(now_counts, base_counts) -> List[int]:
        if not now_counts:
            return []
        if not base_counts:
            return list(now_counts)
        return [a - b for a, b in zip(now_counts, base_counts)]

    def _violation(self, obj: _Objective, base: dict,
                   sample: dict) -> tuple:
        """(violations, total, allowed fraction) for one window."""
        slo = obj.slo
        if obj.kind == "latency":
            key = "run_latency_counts" if slo.handler == "*" else None
            if key is not None:
                counts = self._counts_delta(sample.get(key, []),
                                            base.get(key, []))
            else:
                counts = self._counts_delta(
                    sample.get("handler_latency_counts", {})
                    .get(slo.handler, []),
                    base.get("handler_latency_counts", {})
                    .get(slo.handler, []))
            total = sum(counts)
            target_ns = int(slo.p99_ms * 1e6)
            return (_violating_counts(counts, target_ns), total,
                    _LATENCY_BUDGET_FRAC)

        def delta(name: str) -> int:
            if slo.tenant is not None:
                s = sample.get("sessions", {}).get(slo.tenant, {})
                b = base.get("sessions", {}).get(slo.tenant, {})
            else:
                s = sample.get("counters", {})
                b = base.get("counters", {})
            return int(s.get(name, 0)) - int(b.get(name, 0))

        if obj.kind == "error":
            errors = delta("failed")
            total = errors + delta("completed")
            return errors, total, float(slo.error_frac)
        # shed: degraded rejections against everything the tenant asked
        shed = delta("rejected_degraded")
        total = shed + delta("submitted")
        return shed, total, float(slo.shed_frac)

    # -- the pressure surface ------------------------------------------------
    def pressure(self) -> float:
        """Burning objectives as a [0, 1] stress contribution:
        ``min(1, worst fast burn / pressure_clip)`` — with the defaults
        (enter 1.0, clip 2.0) an objective entering burn contributes 0.5,
        which clears every ladder degrade threshold's first band, and
        2x-budget burn saturates the signal."""
        with self._lock:
            worst = 0.0
            for obj in self._objectives:
                if obj.burning:
                    worst = max(worst, obj.last_fast)
        if worst <= 0.0:
            return 0.0
        return min(1.0, worst / max(self.pressure_clip, 1e-9))

    def burning(self) -> List[str]:
        with self._lock:
            return [f"{o.slo.name}:{o.kind}" for o in self._objectives
                    if o.burning]

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "slos": [dataclasses.asdict(s) for s in self.slos],
                "objectives": [
                    {"slo": o.slo.name, "objective": o.kind,
                     "burning": o.burning,
                     "burn_fast": round(o.last_fast, 3),
                     "burn_slow": round(o.last_slow, 3)}
                    for o in self._objectives
                ],
                "burning": [f"{o.slo.name}:{o.kind}"
                            for o in self._objectives if o.burning],
                "ledger_tail": list(self.ledger)[-16:],
            }


def supervisor_metrics_source(metrics) -> Callable[[], dict]:
    """Adapt a :class:`ServeMetrics` to the engine's sample shape."""

    def sample() -> dict:
        snap = metrics.snapshot()
        return {
            "handler_latency_counts": metrics.handler_latency_counts(),
            "run_latency_counts": metrics.run_latency_counts(),
            "counters": snap["counters"],
            "sessions": snap["sessions"],
        }

    return sample
