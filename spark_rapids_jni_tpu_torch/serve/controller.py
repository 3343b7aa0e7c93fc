"""Telemetry-steered adaptive admission: close the loop recorder -> knobs (a
copy of the JAX package's ``serve/controller.py``).

Rounds 1-8 made every admission knob *static* config — queue depth, session
byte budgets, split thresholds — while the flight recorder (obs/flight.py)
measured exactly the signals an operator would retune them from: rolling
blocked-ns, retry/split storms, spill volume, queue saturation.  This
module is the feedback controller that closes the loop, the serving analog
of steering admission from live device-pressure counters (*Accelerating
Presto with GPUs*, PAPERS.md) over the tiered budget model the governor
already enforces (*Sparkle*).

One daemon thread ticks every ``serve_controller_period_s``.  Each tick:

1. **samples** pressure — the engine budget's used/limit fraction, the
   arbiter's rolling blocked-ns trend gauge (``Arbiter.rolling_blocked``,
   a trailing window, NOT lifetime totals), queue occupancy, and deltas of
   the serve retry/split counters;
2. **filters** it through an EWMA, and compares against a hysteresis band
   (``band_hi``/``band_lo``): only a *sustained* excursion outside the
   band adjusts anything, so a square-wave signal oscillating across the
   midpoint converges to NO adjustments (pinned by test_serve_controller);
3. **adjusts** at most one banded step per knob per dwell window, always
   inside hard min/max clamps:

   - admission queue depth (``AdmissionQueue.set_maxsize``; shrinking
     proactively purges deadline-expired entries),
   - per-session byte-budget scale (``Session.set_budget_scale``),
   - priority aging (starved sessions ratchet upward via
     ``AdmissionQueue.age_sessions`` + ``Session.set_age_boost``),
   - pre-emptive split depth per request class
     (``ServingEngine.set_presplit``, the port's only pre-split; the
     self-governed plan handlers ``q5`` and ``q3`` take none and split
     reactively inside their own governed bracket).

The controller is itself governed for robustness: every decision lands in
the flight ring as an ``EV_CONTROL_*`` event (the decision ledger
``tools/flightdump.py --control`` reconstructs), and the
``serve_controller_freeze`` kill switch resets every knob to its static
value on the next tick — behavior becomes bit-identical to
``serve_adaptive=False`` without restarting the engine.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import deque
from typing import Callable, Dict, Optional

from spark_rapids_jni_tpu_torch.obs import flight as _flight
from spark_rapids_jni_tpu_torch.serve.metrics import (
    percentile_of_counts as _percentile,
)

__all__ = ["AdmissionController", "Knob"]


def _counts_delta(now, start):
    """Windowed latency-bucket counts between two cumulative samples."""
    if not now:
        return []
    if not start:
        return list(now)
    return [a - b for a, b in zip(now, start)]


class Knob:
    """One governed control variable: a static value (what the kill switch
    restores), hard clamps, and the current setting."""

    __slots__ = ("name", "static", "lo", "hi", "value")

    def __init__(self, name: str, static, lo, hi):
        self.name = name
        self.static = static
        self.lo = lo
        self.hi = hi
        self.value = static

    def clamp(self, v):
        return min(self.hi, max(self.lo, v))


# counters whose per-tick deltas feed decisions (sampled from ServeMetrics)
_DELTA_COUNTERS = ("retried", "split_requeued", "rejected_full", "completed")

# a cluster-pressure sample older than max(this, 4 heartbeat periods)
# steers nothing: the supervisor broadcasts at heartbeat rate, so a few
# missed periods means the pipe (or the supervisor) is gone and local
# signals must govern.  Scaled by the CONFIGURED heartbeat so a slow-
# beating deployment doesn't silently disable federated admission.
_CLUSTER_STALE_S = 2.0


class AdmissionController:
    """The feedback loop from flight-recorder gauges to admission knobs.

    ``signal_source`` (tests) replaces live sampling with an injected
    callable returning the same dict shape as :meth:`_sample`;
    :meth:`tick` is public so convergence tests drive the control law
    deterministically without the thread.
    """

    def __init__(self, engine, *, period_s: Optional[float] = None,
                 ewma_alpha: float = 0.3,
                 band_hi: float = 0.85, band_lo: float = 0.5,
                 dwell_ticks: int = 4,
                 age_after_s: float = 1.0, max_age_boost: int = 3,
                 presplit_max: int = 3, presplit_decay_ticks: int = 40,
                 presplit_probe_lo: float = 0.1,
                 blocked_window_s: float = 1.0,
                 latency_probe: bool = True,
                 probe_after_ticks: int = 12,
                 probe_window_ticks: int = 10,
                 probe_min_samples: int = 8,
                 probe_keep_ratio: float = 0.9,
                 signal_source: Optional[Callable[[], dict]] = None):
        if period_s is None:
            from spark_rapids_jni_tpu_torch import config

            period_s = float(config.get("serve_controller_period_s"))
        self.engine = engine
        self.period_s = period_s
        self.ewma_alpha = ewma_alpha
        self.band_hi = band_hi
        self.band_lo = band_lo
        self.dwell_ticks = dwell_ticks
        self.age_after_s = age_after_s
        self.max_age_boost = max_age_boost
        self.presplit_max = min(presplit_max, engine.max_split_depth)
        self.presplit_decay_ticks = presplit_decay_ticks
        self.presplit_probe_lo = presplit_probe_lo
        self.blocked_window_s = blocked_window_s
        self.latency_probe = latency_probe
        self.probe_after_ticks = probe_after_ticks
        self.probe_window_ticks = probe_window_ticks
        self.probe_min_samples = probe_min_samples
        self.probe_keep_ratio = probe_keep_ratio
        self._signal_source = signal_source
        qs = engine.static_queue_size
        self.knobs: Dict[str, Knob] = {
            "queue_depth": Knob("queue_depth", qs, max(1, qs // 4), qs),
            "session_scale": Knob("session_scale", 1.0, 0.25, 1.0),
        }
        self._lock = threading.Lock()  # ledger + ewma + per-knob bookkeeping
        self.ledger: "deque" = deque(maxlen=256)  # guarded-by: _lock
        self._ewma: Optional[float] = None  # guarded-by: _lock
        self._tick = 0  # guarded-by: _lock
        self._last_adj: Dict[str, int] = {}  # guarded-by: _lock
        self._last_counters: Dict[str, int] = {}  # guarded-by: _lock
        self._last_class_splits: Dict[str, int] = {}  # guarded-by: _lock
        # ticks since last class split
        self._class_quiet: Dict[str, int] = {}  # guarded-by: _lock
        # latency-aware presplit probing (ROADMAP item 4 follow-on): per
        # handler, the in-flight probe record and the converged-regime
        # "already decided" marker (cleared when splits recur or decay
        # fires, so a new regime re-earns its probe)
        self._probe: Dict[str, dict] = {}  # guarded-by: _lock
        self._probe_done: Dict[str, bool] = {}  # guarded-by: _lock
        self._boosts: Dict[str, int] = {}  # guarded-by: _lock
        # federated admission (round 13): the supervisor's cluster-wide
        # pressure aggregate (MSG_PRESSURE via serve/rpc.py), as
        # (pressure, stamp); stale samples (a supervisor that stopped
        # broadcasting) age out after _CLUSTER_STALE_S so an orphaned
        # worker falls back to steering on its local view alone
        self._cluster: Optional[tuple] = None  # guarded-by: _lock
        self._frozen = False  # guarded-by: _lock
        self.errors = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None  # guarded-by: _lock
        # telemetry registration mirrors the engine's: weak, so an
        # abandoned controller never pins itself into the process-global
        # recorder, and the source self-unregisters once collected
        self._telemetry_name = f"controller:{id(engine):x}"
        wm = weakref.WeakMethod(self.snapshot)
        name = self._telemetry_name

        def _sample_tele(wm=wm, name=name):
            fn = wm()
            if fn is None:
                _flight.unregister_telemetry_source(name)
                return {"error": "controller collected"}
            return fn()

        _flight.register_telemetry_source(name, _sample_tele)

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> None:
        with self._lock:
            if self._thread is not None:
                return
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name="serve-admission-control")
            t = self._thread
        t.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
        _flight.unregister_telemetry_source(self._telemetry_name)

    def _loop(self) -> None:
        while not self._stop.wait(self.period_s):
            try:
                self.tick()
            # analyze: ignore[retry-protocol] - the controller daemon runs
            # in no task's retry bracket (a control signal here targets
            # nobody) and must survive everything, like the watchdog; the
            # failure is still surfaced as a counted anomaly, not eaten
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self.errors += 1
                _flight.anomaly("controller_error", detail=repr(e)[:200])

    # -- sampling -----------------------------------------------------------
    def _sample(self) -> dict:
        """Live pressure signals (tests inject a source with this shape)."""
        eng = self.engine
        mem_frac = eng.budget.used / max(1, eng.budget.limit)
        try:
            rolled = eng.gov.arbiter.rolling_blocked(self.blocked_window_s)
        except RuntimeError:  # racing governor close: no trend signal
            rolled = {}
        workers = max(1, len(eng._workers))
        blocked_frac = (sum(rolled.values())
                        / (self.blocked_window_s * 1e9 * workers))
        return {
            "mem_frac": mem_frac,
            "blocked_frac": min(1.0, blocked_frac),
            "queue_depth": eng.queue.depth(),
            "counters": {k: eng.metrics.get(k) for k in _DELTA_COUNTERS},
            "class_splits": eng.class_split_counts(),
            "session_waits": eng.queue.session_waits(),
        }

    def _deltas(self, counters: Dict[str, int]) -> Dict[str, int]:
        with self._lock:
            out = {k: counters.get(k, 0) - self._last_counters.get(k, 0)
                   for k in counters}
            self._last_counters = dict(counters)
        return out

    # -- the decision ledger ------------------------------------------------
    def _adjust(self, knob: str, old, new, reason: str) -> None:
        scaled = int(round(new * 1000)) if isinstance(new, float) else int(new)
        with self._lock:
            self.ledger.append({
                "tick": self._tick, "t_ns": time.monotonic_ns(),
                "knob": knob, "old": old, "new": new, "reason": reason,
            })
        _flight.record(_flight.EV_CONTROL_ADJUST, -1,
                       detail=f"{knob}:{old}->{new}:{reason}", value=scaled)

    # -- the control law ----------------------------------------------------
    def tick(self, signals: Optional[dict] = None) -> None:
        """One control step.  Public and injectable for deterministic
        convergence tests; the thread calls it with live samples."""
        from spark_rapids_jni_tpu_torch import config

        frozen = bool(config.get("serve_controller_freeze"))
        with self._lock:
            self._tick += 1
            was_frozen, self._frozen = self._frozen, frozen
        if frozen:
            if not was_frozen:
                self._apply_static("kill_switch")
                _flight.record(_flight.EV_CONTROL_FREEZE, -1,
                               detail="kill_switch", value=1)
            return
        if was_frozen:
            with self._lock:
                self._ewma = None  # re-learn from the current regime
            _flight.record(_flight.EV_CONTROL_FREEZE, -1,
                           detail="resumed", value=0)
        sig = signals if signals is not None else (
            self._signal_source() if self._signal_source is not None
            else self._sample())
        local = max(float(sig.get("mem_frac", 0.0)),
                    float(sig.get("blocked_frac", 0.0)))
        cluster = self._cluster_pressure()
        # federated admission: steer on the WORST of this process's view
        # and the supervisor's cluster aggregate — a quiet worker in an
        # overloaded cluster tightens too; the decision ledger says which
        # signal drove each move
        pressure = max(local, cluster)
        src = "cluster" if cluster > local else "local"
        with self._lock:
            ewma = (pressure if self._ewma is None
                    else self.ewma_alpha * pressure
                    + (1.0 - self.ewma_alpha) * self._ewma)
            self._ewma = ewma
        deltas = self._deltas(dict(sig.get("counters", {})))
        overloaded = ewma >= self.band_hi
        calm = ewma <= self.band_lo and deltas.get("retried", 0) == 0 \
            and deltas.get("split_requeued", 0) == 0
        self._steer_queue_depth(overloaded, calm, src)
        self._steer_session_scale(overloaded, calm, src)
        self._steer_presplit(dict(sig.get("class_splits", {})))
        if self.latency_probe:
            self._steer_latency_probe()
        self._steer_aging(dict(sig.get("session_waits", {})))

    def _dwell_ok(self, knob: str) -> bool:
        with self._lock:
            return (self._tick - self._last_adj.get(knob, -10**9)
                    >= self.dwell_ticks)

    def _mark_adj(self, knob: str) -> None:
        with self._lock:
            self._last_adj[knob] = self._tick

    def note_cluster_pressure(self, gauges: dict) -> None:
        """Feed the supervisor's cluster-wide pressure aggregate into the
        next ticks (serve/rpc.py routes MSG_PRESSURE here via
        ``ServingEngine.note_cluster_pressure``)."""
        p = max(float(gauges.get("blocked_frac", 0.0)),
                float(gauges.get("mem_frac", 0.0)),
                float(gauges.get("queue_frac", 0.0)),
                # SLO burn rides the same broadcast (round 14): a worker
                # in a promise-burning cluster tightens its knobs even
                # when its local resource gauges look calm
                float(gauges.get("slo_frac", 0.0)))
        with self._lock:
            self._cluster = (min(1.0, p), time.monotonic())

    def _cluster_pressure(self) -> float:
        from spark_rapids_jni_tpu_torch import config

        with self._lock:
            c = self._cluster
        stale_s = max(_CLUSTER_STALE_S,
                      4.0 * float(config.get("serve_heartbeat_s")))
        if c is None or time.monotonic() - c[1] > stale_s:
            return 0.0
        return c[0]

    def _steer_queue_depth(self, overloaded: bool, calm: bool,
                           src: str = "local") -> None:
        k = self.knobs["queue_depth"]
        if not (overloaded or calm) or not self._dwell_ok(k.name):
            return
        new = k.clamp(k.value // 2 if overloaded else k.value * 2)
        if new == k.value:
            return
        old, k.value = k.value, new
        self._mark_adj(k.name)
        purged = self.engine.queue.set_maxsize(new)
        reason = ("pressure_high" if overloaded else "pressure_low")
        if src != "local":  # the ledger distinguishes cluster-driven moves
            reason += f":{src}"
        if purged:
            reason += f":purged={purged}"
        self._adjust(k.name, old, new, reason)

    def _steer_session_scale(self, overloaded: bool, calm: bool,
                             src: str = "local") -> None:
        k = self.knobs["session_scale"]
        if not (overloaded or calm) or not self._dwell_ok(k.name):
            return
        new = k.clamp(k.value * 0.5 if overloaded else k.value * 2.0)
        if new == k.value:
            return
        old, k.value = k.value, new
        self._mark_adj(k.name)
        for sess in self.engine.sessions.all_open():
            sess.set_budget_scale(new)
        reason = "pressure_high" if overloaded else "pressure_low"
        if src != "local":
            reason += f":{src}"
        self._adjust(k.name, old, new, reason)

    def apply_to_new_session(self, sess) -> None:
        """Bring a just-opened session onto the CURRENT posture (the
        engine calls this from open_session): the scale knob is only
        pushed to open sessions when its value changes, so without this a
        tenant that joins mid-overload would enforce its full static
        budget until the next adjustment."""
        with self._lock:
            frozen = self._frozen
        if not frozen:
            sess.set_budget_scale(self.knobs["session_scale"].value)

    def _steer_presplit(self, class_splits: Dict[str, int]) -> None:
        """Pre-emptive split sizing: classes that keep drawing reactive
        SplitAndRetryOOM get split BEFORE dispatch; quiet classes decay
        back one level per ``presplit_decay_ticks``."""
        for handler, total in class_splits.items():
            with self._lock:
                delta = total - self._last_class_splits.get(handler, 0)
                self._last_class_splits[handler] = total
            if delta > 0:
                with self._lock:
                    self._class_quiet[handler] = 0
                    # splits mean the regime moved: abort any in-flight
                    # latency probe (escalation owns the knob again) and
                    # let the next convergence re-earn its probe
                    aborted = self._probe.pop(handler, None)
                    self._probe_done.pop(handler, None)
                if aborted is not None and aborted["phase"] == "probe":
                    self.engine.set_presplit(handler, aborted["depth"])
                    self._adjust(f"presplit:{handler}",
                                 aborted["depth"] + 1, aborted["depth"],
                                 "probe_split_abort")
            cur = self.engine.presplit_depth(handler)
            if delta > 0:
                # dwell between escalations: top-level splits observed in
                # this window may predate the knob's last change (requests
                # already past the presplit gate) — stepping every tick
                # would overshoot the depth the class actually needs
                if not self._dwell_ok(f"presplit:{handler}"):
                    continue
                # going DEEPER than one level needs sustained evidence
                # (several top-level splits in one window): a straggler
                # that was popped before the knob landed must not drag
                # every future request to a deeper split than it needs
                if cur >= 1 and delta < 2:
                    continue
                new = min(cur + 1, self.presplit_max)
                if new != cur:
                    self._mark_adj(f"presplit:{handler}")
                    self.engine.set_presplit(handler, new)
                    self._adjust(f"presplit:{handler}", cur, new,
                                 f"split_retries+{delta}")
            else:
                with self._lock:
                    quiet = self._class_quiet.get(handler, 0) + 1
                    self._class_quiet[handler] = quiet
                    ewma = self._ewma
                    probing = handler in self._probe
                # decay is a PROBE (the next full-size attempt re-tests the
                # budget) — only probe when overall pressure has actually
                # subsided, or mid-storm probes hand a tail-latency spike
                # to whichever request draws the full-size attempt; a
                # live latency probe owns the knob until it decides
                if (cur > 0 and not probing
                        and quiet >= self.presplit_decay_ticks
                        and (ewma is None
                             or ewma <= self.presplit_probe_lo)):
                    with self._lock:
                        self._class_quiet[handler] = 0
                        # shallower regime: the deeper-probe decision (if
                        # any) no longer applies — let it re-run
                        self._probe_done.pop(handler, None)
                    self.engine.set_presplit(handler, cur - 1)
                    self._adjust(f"presplit:{handler}", cur, cur - 1,
                                 "quiet_decay")

    def _steer_latency_probe(self) -> None:
        """Latency-aware presplit depth (ROADMAP item 4 follow-on).

        Reactive escalation converges to the depth that merely STOPS
        SplitAndRetry signals — but the throughput-optimal depth can be
        one deeper, where smaller pieces unlock budget-level parallelism.
        Once a class has been quiet for ``probe_after_ticks``, measure a
        baseline window of its p99 at the converged depth, then set the
        knob one deeper for an equal window, and KEEP the deeper depth
        only if the windowed p99 actually improved (``probe_keep_ratio``).
        Windows with fewer than ``probe_min_samples`` completions decide
        nothing (revert); recurring splits abort mid-probe
        (_steer_presplit owns that path).
        """
        counts = self.engine.metrics.handler_latency_counts()
        with self._lock:
            candidates = list(self._last_class_splits)
        for handler in candidates:
            with self._lock:
                st = self._probe.get(handler)
                quiet = self._class_quiet.get(handler, 0)
                done = self._probe_done.get(handler, False)
                ewma = self._ewma
            cur = self.engine.presplit_depth(handler)
            if st is None:
                if (done or quiet < self.probe_after_ticks
                        or cur + 1 > self.presplit_max
                        or (ewma is not None
                            and ewma > self.presplit_probe_lo)):
                    continue
                with self._lock:
                    self._probe[handler] = {
                        "phase": "baseline", "depth": cur, "ticks": 0,
                        "start": list(counts.get(handler, [])),
                        "baseline_p99": 0,
                    }
                continue
            st["ticks"] += 1
            if st["ticks"] < self.probe_window_ticks:
                continue
            window = _counts_delta(counts.get(handler, []), st["start"])
            samples = sum(window)
            if st["phase"] == "baseline":
                if samples < self.probe_min_samples:
                    with self._lock:  # nothing measurable yet: stand down
                        self._probe.pop(handler, None)
                    continue
                st["baseline_p99"] = _percentile(window, 99)
                st["phase"] = "probe"
                st["ticks"] = 0
                st["start"] = list(counts.get(handler, []))
                self._mark_adj(f"presplit:{handler}")
                self.engine.set_presplit(handler, st["depth"] + 1)
                self._adjust(f"presplit:{handler}", st["depth"],
                             st["depth"] + 1, "latency_probe")
                continue
            # probe window complete: decide
            keep = (samples >= self.probe_min_samples
                    and _percentile(window, 99)
                    <= self.probe_keep_ratio * st["baseline_p99"])
            with self._lock:
                self._probe.pop(handler, None)
                self._probe_done[handler] = True
                self._class_quiet[handler] = 0
            if keep:
                self._adjust(f"presplit:{handler}", st["depth"] + 1,
                             st["depth"] + 1,
                             "probe_keep:p99_improved")
            else:
                self._mark_adj(f"presplit:{handler}")
                self.engine.set_presplit(handler, st["depth"])
                self._adjust(f"presplit:{handler}", st["depth"] + 1,
                             st["depth"],
                             "probe_revert:insufficient"
                             if samples < self.probe_min_samples
                             else "probe_revert:p99_worse")

    def _steer_aging(self, session_waits: Dict[str, float]) -> None:
        """Starvation control: a session whose oldest queued request has
        waited N aging periods gets boost N (clamped), ratcheted onto its
        queued work and applied to future submits; served sessions decay
        back to 0."""
        boosts = {sid: min(self.max_age_boost, int(w / self.age_after_s))
                  for sid, w in session_waits.items()
                  if w >= self.age_after_s}
        with self._lock:
            prev = self._boosts
            self._boosts = boosts
        changed = {sid: b for sid, b in boosts.items()
                   if b != prev.get(sid, 0)}
        cleared = [sid for sid in prev if sid not in boosts]
        if changed:
            self.engine.queue.age_sessions(changed)
        for sess in self.engine.sessions.all_open():
            sid = sess.session_id
            if sid in changed:
                sess.set_age_boost(changed[sid])
            elif sid in cleared:
                sess.set_age_boost(0)
        for sid, b in changed.items():
            self._adjust(f"age_boost:{sid}", prev.get(sid, 0), b,
                         "starvation")

    # -- the kill switch ----------------------------------------------------
    def _apply_static(self, reason: str) -> None:
        """Reset every knob to its static value — the freeze contract:
        after this, admission decisions are bit-identical to
        serve_adaptive=False (queue bound, session caps, priorities, and
        dispatch all read their static values)."""
        for k in self.knobs.values():
            if k.value != k.static:
                old, k.value = k.value, k.static
                self._adjust(k.name, old, k.static, reason)
        self.engine.queue.set_maxsize(self.knobs["queue_depth"].static)
        for sess in self.engine.sessions.all_open():
            sess.set_budget_scale(1.0)
            sess.set_age_boost(0)
        for handler in list(self.engine.presplit_map()):
            self.engine.set_presplit(handler, 0)
        # entries boosted by age_sessions before the freeze must pop in
        # static (priority, seq) order too — bit-identical means the
        # QUEUE's order, not just future submits
        self.engine.queue.clear_boosts()
        with self._lock:
            self._boosts = {}
            self._class_quiet = {}
            self._last_adj = {}
            self._ewma = None
            self._probe = {}
            self._probe_done = {}

    # -- introspection ------------------------------------------------------
    def snapshot(self) -> dict:
        """Controller gauges for telemetry/dumps: knob values, EWMA, the
        ledger tail — enough to see WHAT the posture is and WHY."""
        with self._lock:
            ledger_tail = list(self.ledger)[-16:]
            ewma = self._ewma
            frozen, tick = self._frozen, self._tick
            boosts = dict(self._boosts)
            errors = self.errors
            cluster = self._cluster
        return {
            "frozen": frozen,
            "tick": tick,
            "pressure_ewma": round(ewma, 4) if ewma is not None else None,
            "cluster_pressure": (round(cluster[0], 4)
                                 if cluster is not None else None),
            "knobs": {k.name: {"value": k.value, "static": k.static,
                               "lo": k.lo, "hi": k.hi}
                      for k in self.knobs.values()},
            "presplit": self.engine.presplit_map(),
            "age_boosts": boosts,
            "errors": errors,
            "ledger_tail": ledger_tail,
        }
