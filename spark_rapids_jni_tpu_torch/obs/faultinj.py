"""Config-driven fault injection at the framework dispatch seam (a copy of the
JAX package's ``obs/faultinj.py``).

Parity target: ``libcufaultinj`` (faultinj/faultinj.cu) — the CUPTI-hooked
chaos tool that injects faults into CUDA calls per a JSON config with
match-by-name / ``*`` wildcards, probabilities, interception counts, and
inotify hot reload (faultinj.cu:387 config parse, :139-144 trap/assert
injection, README.md).  The TPU analog hooks the dispatch seam
(obs/seam.py) that every instrumented op, transfer, and collective crosses.

Config shape::

    {
      "dynamic": true,            # hot-reload on file change (mtime poll)
      "seed": 42,                 # optional deterministic RNG
      "op": {
        "murmur_hash32": {"percent": 50, "injectionType": "exception",
                           "interceptionCount": 2},
        "*":             {"percent": 1,  "injectionType": "retry_oom"}
      },
      "transfer": { ... }, "collective": { ... }, "alloc": { ... }
    }

``injectionType``:

- ``exception``    -> InjectedException (the PTX ``trap;`` analog: the call
  fails immediately with a framework error)
- ``retry_oom``    -> GpuRetryOOM (drives the arbiter's retry protocol)
- ``split_oom``    -> GpuSplitAndRetryOOM
- ``device_error`` -> GpuOOM (the sticky ``assert(0)`` analog: a
  non-retryable device failure)
- ``host_oom``     -> OffHeapOOM (a hard host/off-heap allocation failure)

Behavioral kinds (round 10, crash-only serving): instead of raising, the
crossing misbehaves the way a sick executor process does —

- ``slow``      -> the crossing stalls ``durationMs`` (default 50) before
  proceeding: a degraded-but-correct executor;
- ``hang``      -> the crossing stalls ``durationMs`` (default one hour):
  a wedged handler thread that will never return on its own — only the
  supervisor's hung-lease recycling (serve/supervisor.py) or the engine's
  hung-task watchdog notices;
- ``proc_kill`` -> ``SIGKILL`` to the CURRENT process: the crash-only
  failure domain drill.  No cleanup runs, no exception propagates — the
  supervisor must detect the dead executor and re-dispatch its leases.

``interceptionCount`` limits how many times the rule fires (faultinj.cu
``injectionCount`` countdown); ``percent`` gates each crossing.

Auto-activation: if ``SRT_FAULT_INJECTOR_CONFIG_PATH`` is set when
``install_from_env()`` runs (the ops package calls it on import), the
injector arms itself — mirroring the driver-level ``CUDA_INJECTION64_PATH``
/ ``FAULT_INJECTOR_CONFIG_PATH`` environment contract.
"""

from __future__ import annotations

import fnmatch
import json
import os
import random
import signal
import threading
import time
from typing import Optional

from spark_rapids_jni_tpu_torch.mem.exceptions import (
    GpuOOM,
    GpuRetryOOM,
    GpuSplitAndRetryOOM,
    InjectedException,
    OffHeapOOM,
)
from spark_rapids_jni_tpu_torch.obs import seam as _seam

__all__ = ["FaultInjector", "install_from_env", "pressure_storm_config",
           "chaos_kill_config", "chaos_shuffle_config", "transport_fault",
           "ENV_CONFIG_PATH"]

ENV_CONFIG_PATH = "SRT_FAULT_INJECTOR_CONFIG_PATH"

_FAULTS = {
    "exception": lambda name: InjectedException(f"injected fault in {name}"),
    "retry_oom": lambda name: GpuRetryOOM(f"injected retry OOM in {name}"),
    "split_oom": lambda name: GpuSplitAndRetryOOM(
        f"injected split-and-retry OOM in {name}"),
    "device_error": lambda name: GpuOOM(f"injected device error in {name}"),
    "host_oom": lambda name: OffHeapOOM(f"injected host OOM in {name}"),
}

# behavioral kinds misbehave instead of raising (executed OUTSIDE the
# injector lock: a hang must wedge the crossing thread, not the injector)
_BEHAVIOR_KINDS = frozenset({"slow", "hang", "proc_kill"})
_BEHAVIOR_DEFAULT_MS = {"slow": 50.0, "hang": 3_600_000.0}

# transport kinds (round 13, the columnar data plane): the shuffle sender
# consults :func:`transport_fault` per framed partition send and APPLIES
# the verdict itself — a corrupted or truncated frame must actually cross
# the wire (the receiver's CRC / length check is what's under test), so
# the injector returns a verdict instead of raising.  ``peer_stall``
# behaves like ``slow`` but lives in the shuffle category so one profile
# can storm all three without rule-name shadowing.
_TRANSPORT_KINDS = frozenset({"frame_corrupt", "frame_truncate",
                              "peer_stall"})
_BEHAVIOR_DEFAULT_MS.update({"peer_stall": 500.0})


class _Rule:
    def __init__(self, spec: dict):
        self.percent = float(spec.get("percent", 100))
        self.kind = spec.get("injectionType", "exception")
        if (self.kind not in _FAULTS and self.kind not in _BEHAVIOR_KINDS
                and self.kind not in _TRANSPORT_KINDS):
            raise ValueError(f"unknown injectionType {self.kind!r}")
        self.duration_s = float(
            spec.get("durationMs", _BEHAVIOR_DEFAULT_MS.get(self.kind, 0.0))
        ) / 1e3
        # None = unlimited, mirroring a missing injectionCount in faultinj
        c = spec.get("interceptionCount")
        self.remaining = None if c is None else int(c)

    def fire(self, rng: random.Random, name: str):
        """Roll the dice; returns ``(kind, payload)`` — payload is the
        exception to raise for fault kinds, the stall duration for
        slow/hang, None for proc_kill — or None when the rule holds."""
        if self.remaining is not None and self.remaining <= 0:
            return None
        if self.percent < 100 and rng.uniform(0, 100) >= self.percent:
            return None
        if self.remaining is not None:
            self.remaining -= 1
        if self.kind in _BEHAVIOR_KINDS or self.kind in _TRANSPORT_KINDS:
            return (self.kind, self.duration_s)
        return ("raise", _FAULTS[self.kind](name))


class FaultInjector:
    """Singleton chaos hook over the dispatch seam."""

    _instance: Optional["FaultInjector"] = None

    def __init__(self, config, config_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._path = config_path
        self._mtime = 0.0
        self._watcher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._load(config)

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def install(cls, config_or_path) -> "FaultInjector":
        """Arm the injector from a dict or a JSON config file path."""
        if cls._instance is not None:
            raise RuntimeError("fault injector already installed")
        if isinstance(config_or_path, (str, os.PathLike)):
            path = os.fspath(config_or_path)
            with open(path) as f:
                config = json.load(f)
            inj = cls(config, path)
            inj._mtime = os.stat(path).st_mtime
            if config.get("dynamic"):
                inj._watcher = threading.Thread(
                    target=inj._watch, name="srt-faultinj-watch", daemon=True)
                inj._watcher.start()
        else:
            inj = cls(dict(config_or_path))
        cls._instance = inj
        _seam._set_injector(inj._check)
        return inj

    @classmethod
    def uninstall(cls) -> None:
        inj = cls._instance
        if inj is None:
            return
        _seam._set_injector(None)
        inj._stop.set()
        if inj._watcher is not None:
            inj._watcher.join(timeout=5)
        cls._instance = None

    # -- config ------------------------------------------------------------
    def _load(self, config: dict) -> None:
        rules = {}
        for cat in (_seam.OP, _seam.TRANSFER, _seam.COLLECTIVE, _seam.ALLOC,
                    _seam.SPILL, _seam.COMPILE, _seam.SERVE, _seam.SHUFFLE):
            cat_spec = config.get(cat, {})
            rules[cat] = {name: _Rule(spec) for name, spec in cat_spec.items()}
        with self._lock:
            self._rules = rules
            self._rng = random.Random(config.get("seed"))

    def _watch(self) -> None:
        """Hot reload on config change (faultinj.cu:32 inotify analog)."""
        while not self._stop.wait(0.2):
            try:
                m = os.stat(self._path).st_mtime
                if m != self._mtime:
                    self._mtime = m
                    with open(self._path) as f:
                        self._load(json.load(f))
            except (OSError, ValueError):
                pass  # mid-write config; retry next poll

    # -- the seam hook -----------------------------------------------------
    @staticmethod
    def _match_rule(cat_rules: dict, name: str) -> Optional[_Rule]:
        """Rule precedence for one crossing: exact name, then glob
        patterns (the reference matches interceptionMatchPattern regexes
        the same way), then the catch-all.  ONE definition shared by the
        seam hook and the transport consult, so the two chaos surfaces
        can never resolve a name differently."""
        rule = cat_rules.get(name)
        if rule is None:
            rule = next(
                (r for pat, r in cat_rules.items()
                 if pat != "*" and pat != name
                 and fnmatch.fnmatchcase(name, pat)),
                None) or cat_rules.get("*")
        return rule

    def _check(self, category: str, name: str) -> None:
        with self._lock:
            cat_rules = self._rules.get(category)
            if not cat_rules:
                return
            rule = self._match_rule(cat_rules, name)
            if rule is None:
                return
            fired = rule.fire(self._rng, name)
        if fired is None:
            return
        kind, payload = fired
        if kind == "raise":
            raise payload
        if kind == "proc_kill":
            # the crash-only drill: no cleanup, no exception — the process
            # vanishes mid-crossing exactly like a segfaulted executor
            os.kill(os.getpid(), signal.SIGKILL)
        if kind in ("frame_corrupt", "frame_truncate"):
            # transport verdicts are meaningless at a plain seam crossing
            # (there are no bytes here to damage); only the shuffle
            # sender's transport_fault() consult can apply them
            return
        # slow / hang / peer_stall: stall the crossing thread (outside the
        # lock — a hang wedges THIS thread only, others keep injecting)
        time.sleep(payload)

    def _transport_check(self, name: str):
        """The shuffle transport's consult (serve/shuffle.py, per framed
        partition send): returns ``("frame_corrupt" | "frame_truncate",
        duration)`` for the SENDER to apply to the outgoing bytes, or None.
        ``peer_stall`` stalls the serving thread here (the receiver sees a
        peer that stops talking mid-frame) and returns None."""
        with self._lock:
            cat_rules = self._rules.get(_seam.SHUFFLE)
            if not cat_rules:
                return None
            rule = self._match_rule(cat_rules, name)
            if rule is None:
                return None
            fired = rule.fire(self._rng, name)
        if fired is None:
            return None
        kind, payload = fired
        if kind == "peer_stall":
            time.sleep(payload)
            return None
        if kind in _TRANSPORT_KINDS:
            return (kind, payload)
        if kind == "raise":
            raise payload
        return None  # slow/hang/proc_kill make no sense here; ignore


def pressure_storm_config(seed: int = 0, *, retry_pct: float = 25.0,
                          split_pct: float = 8.0) -> dict:
    """The seeded memory-pressure-storm chaos profile (round 9).

    One canonical scenario shared by the serve_bench ``--chaos-storm``
    tier, the CI chaos gate, and the controller acceptance tests, so
    "adaptive beats static under chaos" is always measured against the
    SAME storm: injected RetryOOMs on a fraction of budget reservations
    (extra arbiter churn inside every retry bracket) plus occasional
    SplitAndRetryOOMs at the serve seam (handler-level split storms).
    Real *sustained* pressure comes from the caller's undersized budget;
    this profile adds the transient-fault weather on top.

    Deterministic: the injector's config-level RNG is seeded, so the same
    seed yields the same injected-fault schedule (the property
    test_observability pins for the injector in general).
    """
    return {
        "seed": int(seed),
        "alloc": {"reserve:*": {"percent": float(retry_pct),
                                "injectionType": "retry_oom"}},
        "serve": {"handle:*": {"percent": float(split_pct),
                               "injectionType": "split_oom"}},
    }


def chaos_kill_config(seed: int = 0, *, kill: bool = True,
                      kill_pct: float = 8.0, slow_pct: float = 5.0,
                      slow_ms: float = 25.0) -> dict:
    """The seeded executor-chaos profile for cluster serving (round 10).

    Armed INSIDE each executor worker process by the supervisor's chaos
    mode (``serve_bench --cluster N --chaos-kill``): a fraction of served
    requests stall briefly (``slow``), and — when ``kill`` is set for this
    incarnation — one seeded crossing SIGKILLs the whole executor mid-
    request (``interceptionCount: 1``: each armed incarnation dies at most
    once, so the kill count across a run is bounded by the incarnations
    the caller chooses to arm).  Deterministic per seed, like
    :func:`pressure_storm_config`.
    """
    cfg = {
        "seed": int(seed),
        "serve": {"handle:*": {"percent": float(slow_pct),
                               "injectionType": "slow",
                               "durationMs": float(slow_ms)}},
    }
    if kill:
        # the kill arms a DIFFERENT seam (the budget reservation every
        # executor-governed handler crosses per attempt) so it rolls
        # independently of the serve-seam slow weather — one rule per
        # crossing name means stacking both on handle:* would shadow
        # (review r10); dying while holding an admission slot is also
        # the nastier drill
        cfg["alloc"] = {"reserve:*": {"percent": float(kill_pct),
                                      "injectionType": "proc_kill",
                                      "interceptionCount": 1}}
    return cfg


def transport_fault(name: str):
    """Module-level consult for the shuffle transport: the armed
    injector's shuffle-category verdict for ``name``, or None when no
    injector is installed (the zero-overhead default)."""
    inj = FaultInjector._instance
    if inj is None:
        return None
    return inj._transport_check(name)


def chaos_shuffle_config(seed: int = 0, *, kill: bool = True,
                         corrupt_pct: float = 12.0,
                         truncate_pct: float = 8.0,
                         stall_pct: float = 6.0, stall_ms: float = 400.0,
                         kill_pct: float = 5.0) -> dict:
    """The seeded data-plane chaos profile (round 13).

    Armed INSIDE each executor worker by ``serve_bench --cluster
    --chaos-shuffle``: framed partition sends are corrupted (receiver's
    CRC must catch and re-fetch), truncated mid-frame (length check), or
    stalled (``peer_stall`` wedges the serving thread past the consumer's
    I/O timeout, driving the seeded-jitter backoff path); when ``kill``
    is armed for an incarnation, one seeded budget-reservation crossing
    SIGKILLs the executor mid-exchange (``interceptionCount: 1`` per
    armed incarnation, like :func:`chaos_kill_config`).  The three
    transport rules bind DIFFERENT crossing names (``frame:*`` /
    ``trunc:*`` / ``stall:*`` — the sender consults all three per send)
    so none shadows another.  Deterministic per seed.
    """
    cfg = {
        "seed": int(seed),
        "shuffle": {
            "frame:*": {"percent": float(corrupt_pct),
                        "injectionType": "frame_corrupt",
                        "interceptionCount": 4},
            "trunc:*": {"percent": float(truncate_pct),
                        "injectionType": "frame_truncate",
                        "interceptionCount": 4},
            "stall:*": {"percent": float(stall_pct),
                        "injectionType": "peer_stall",
                        "durationMs": float(stall_ms),
                        "interceptionCount": 2},
        },
    }
    if kill:
        # die while holding an admission slot mid-exchange: the transport
        # reservation (fetch credit) and the reduce's governed bracket
        # both cross reserve:*, so the kill lands inside the shuffle
        cfg["alloc"] = {"reserve:*": {"percent": float(kill_pct),
                                      "injectionType": "proc_kill",
                                      "interceptionCount": 1}}
    return cfg


def install_from_env() -> Optional[FaultInjector]:
    """Arm from the ``fault_injector_config_path`` config flag (env-backed by
    SRT_FAULT_INJECTOR_CONFIG_PATH) if set and not already armed."""
    from spark_rapids_jni_tpu_torch import config

    path = config.get("fault_injector_config_path")
    if path and FaultInjector._instance is None:
        return FaultInjector.install(path)
    return None
