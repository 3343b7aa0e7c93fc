"""Named-table version registry: the result cache's invalidation lever (a
copy of the JAX package's ``models/tables.py``, which imports no framework;
the port has no result cache yet, and its plan optimizer reads the stats).

Query payloads in this repo name their input tables (``store_sales``,
``catalog`` ... — the scan-table names of every compiled plan).  The
result cache (plans/rcache.py) fingerprints inputs by CONTENT (a CRC per
column buffer), which makes stale serves structurally impossible — but
content digests alone cannot *reclaim* anything: when a client declares
"table T changed", every cached result computed over T's old content is
dead weight that only falls out by LRU.  This registry is the missing
declaration: a process-local monotonic version per table name.

- Fingerprints embed ``version_of(name)`` per dependency, so a
  :func:`bump` makes every older entry UNREACHABLE (keys can no longer
  be rebuilt) the instant it returns;
- registered listeners (the result cache) run synchronously inside
  ``bump``, so the bumped table's entries are also RECLAIMED — their
  bytes return to the budget before the next query admits;
- in cluster serving the supervisor owns bumps
  (``Supervisor.bump_table``) and broadcasts ``MSG_TABLE_BUMP`` so every
  executor's registry converges via :func:`advance_to` (versions only
  move forward; a late broadcast can never roll one back).

Unregistered names read as version 0 — a table nobody ever bumps is
simply a table whose cache entries live by content digest + LRU alone.

Round 19 extends the registry with per-table STATISTICS recorded at
upload (:func:`record_stats` / :func:`observe_tables`): row counts and a
content fingerprint, versioned with the table.  These are the
cost-model seeds the plan optimizer (plans/optimizer.py) reorders joins
by — a dim table's row count decides which gather applies first, and
the fingerprint lets a reader tell whether stats describe the content
currently registered or a previous version.  Stats for a version other
than the current one are dropped on read (a bump makes stale stats
unreachable exactly like it makes cache entries unreachable).
"""

from __future__ import annotations

import threading
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from spark_rapids_jni_tpu_torch.obs import flight as _flight

__all__ = ["version_of", "versions_of", "bump", "advance_to",
           "snapshot", "add_listener", "remove_listener",
           "record_stats", "observe_tables", "stats_of",
           "stats_snapshot",
           "reset_for_tests"]

_lock = threading.Lock()
_versions: Dict[str, int] = {}  # guarded-by: _lock
# name -> {"rows": int, "fingerprint": int, "version": int} recorded at
# upload; read by the optimizer's join-reorder rule  # guarded-by: _lock
_stats: Dict[str, dict] = {}
# bump listeners: fn(name, new_version), called OUTSIDE the registry
# lock (a listener that consults versions must not deadlock) but on the
# bumping thread, so bump() returning means invalidation already ran
_listeners: List[Callable[[str, int], None]] = []  # guarded-by: _lock


def version_of(name: str) -> int:
    """Current version of ``name`` (0 = never bumped)."""
    with _lock:
        return _versions.get(name, 0)


def versions_of(names) -> Tuple[Tuple[str, int], ...]:
    """(name, version) per name, input order — the dependency stamp a
    result-cache fingerprint embeds."""
    with _lock:
        return tuple((n, _versions.get(n, 0)) for n in names)


def _notify(name: str, version: int) -> None:
    with _lock:
        listeners = list(_listeners)
    for fn in listeners:
        fn(name, version)


def bump(name: str) -> int:
    """Advance ``name``'s version by one and run invalidation listeners;
    returns the new version.  After this returns, no lookup anywhere in
    this process can serve a result fingerprinted with the old version."""
    with _lock:
        v = _versions[name] = _versions.get(name, 0) + 1
    _flight.record(_flight.EV_RCACHE_INVALIDATE, -1,
                   detail=f"table:{name}:version:{v}", value=v)
    _notify(name, v)
    return v


def advance_to(name: str, version: int) -> int:
    """Converge ``name`` to at least ``version`` (cross-process bump
    broadcasts).  Monotonic: a stale broadcast is a no-op.  Listeners run
    only when the version actually moved."""
    with _lock:
        cur = _versions.get(name, 0)
        if version <= cur:
            return cur
        _versions[name] = version
    _flight.record(_flight.EV_RCACHE_INVALIDATE, -1,
                   detail=f"table:{name}:version:{version}:broadcast",
                   value=version)
    _notify(name, version)
    return version


def snapshot() -> Dict[str, int]:
    with _lock:
        return dict(_versions)


# --------------------------------------------------------------------------
# per-table statistics (round 19): the optimizer's cost-model seeds
# --------------------------------------------------------------------------


def record_stats(name: str, *, rows: int, fingerprint: int = 0) -> None:
    """Record ``name``'s row count + content fingerprint AT UPLOAD,
    stamped with the current version — the registry's answer to "how big
    is this table right now".  Idempotent for identical content."""
    with _lock:
        _stats[name] = {"rows": int(rows),
                        "fingerprint": int(fingerprint),
                        "version": _versions.get(name, 0)}


def observe_tables(tables: Dict[str, Dict[str, "object"]]) -> None:
    """Record stats for every table in a ``{name: {field: array}}``
    upload payload: rows from the first column, fingerprint a CRC over
    each column's (name, dtype, length) header — cheap enough to run per
    upload, stable across identical uploads, and sensitive to schema or
    cardinality drift (content CRCs stay the result cache's job)."""
    for name, fields in tables.items():
        if not fields:
            continue
        rows = len(next(iter(fields.values())))
        fp = 0
        for fname in sorted(fields):
            v = fields[fname]
            fp = zlib.crc32(
                f"{fname}:{getattr(v, 'dtype', '')}:{len(v)}".encode(),
                fp)
        record_stats(name, rows=rows, fingerprint=fp)


def stats_of(name: str) -> Optional[dict]:
    """The stats recorded for ``name``'s CURRENT version, or None when
    never recorded / recorded for an older version (a bump makes stale
    stats unreachable, like cache entries)."""
    with _lock:
        st = _stats.get(name)
        if st is None or st["version"] != _versions.get(name, 0):
            return None
        return dict(st)


def stats_snapshot() -> Dict[str, dict]:
    """Current-version stats per table (stale entries filtered) — the
    telemetry view and the optimizer's bulk read."""
    with _lock:
        return {n: dict(st) for n, st in _stats.items()
                if st["version"] == _versions.get(n, 0)}


def add_listener(fn: Callable[[str, int], None]) -> None:
    with _lock:
        if fn not in _listeners:
            _listeners.append(fn)


def remove_listener(fn: Callable[[str, int], None]) -> None:
    with _lock:
        if fn in _listeners:
            _listeners.remove(fn)


def reset_for_tests() -> None:
    with _lock:
        _versions.clear()
        _listeners.clear()
        _stats.clear()


_flight.register_telemetry_source("table_versions", snapshot)
_flight.register_telemetry_source("table_stats", stats_snapshot)
