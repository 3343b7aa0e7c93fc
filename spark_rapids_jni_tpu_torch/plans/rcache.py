"""Governed multi-tier result cache: hot queries skip compute entirely
(PyTorch port of ``plans/rcache.py``).

Every layer below this one makes one query cheaper; this module makes a
REPEATED query nearly free.  *Sparkle*'s large-memory result tier is the
model (PAPERS.md): analytics traffic is Zipf-skewed — millions of users
asking the same hot questions — so a result keyed on *exactly what was
computed over exactly which bytes* turns the hot tail of the workload
into memory-speed lookups while cold queries still pay compute.

**Key** = (what ran, over which bytes, at which geometry):

- the plan signature (``plans/ir.plan_signature``) or handler name +
  handler-declared payload key,
- the input table fingerprint — per column ``(field, dtype, pow2-padded
  length, CRC32 of the raw buffer)`` so equal keys imply bit-equal
  inputs (stale serves are structurally impossible),
- the dtype/pow2-bucket signature (the same lattice the plan cache keys
  compiled variants on — a result computed at one padded geometry IS the
  result at any other, but keeping the bucket in the key keeps hit
  accounting aligned with compile-variant accounting),
- the version of every named input table (``models/tables.py``): a bump
  changes every dependent key, making stale entries unreachable the
  instant it returns — and a registered listener reclaims their bytes.

**Tiers** — HBM -> host RAM -> disk, governed end to end:

- the HBM tier reserves its bytes from the SAME ``BudgetedResource``
  live queries admit through, via :meth:`BudgetedResource.try_acquire`
  (opportunistic: cached bytes never block or steal from live work);
- the cache registers a spill handler on that budget, consulted BEFORE
  the arbiter's BLOCKED/BUFN escalation — a RetryOOM storm squeezes the
  cache first, demoting HBM entries to host (and host to disk under the
  host cap) instead of killing live tasks;
- the disk tier reuses ``columnar/frames.py`` framing: CRC32 over the
  whole payload, verified on load — a corrupt file is dropped loudly
  (``EV_RCACHE_EVICT`` reason ``corrupt``) and the query recomputes.

The port's HBM tier holds an entry's arrays as tensors on the device bound
with the budget (:meth:`ResultCache.bind_budget`; the serving engine passes
its own), uploaded with ``torch.tensor(..., device=...)``; a refused upload
(``torch.cuda.OutOfMemoryError`` is a ``RuntimeError``) stays host-side and
hands its bytes back.  Keys are the JAX package's: they are computed from
the same host numpy and give equal values.

**Read path** (wired in round 15): ``plans/runtime.run_governed_plan``
consults the cache before admission (a hit never enters the governed
bracket), ``serve/executor`` consults it before the handler bracket, and
``serve/supervisor`` short-circuits hits before dispatch (a hit never
costs a lease or a pipe crossing).  Every hit/store/demote/evict/
invalidate is a flight event and a gauge (docs/OBSERVABILITY.md).
"""

from __future__ import annotations

import os
import pickle
import threading
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from spark_rapids_jni_tpu_torch import device as _device
from spark_rapids_jni_tpu_torch.columnar import frames as _frames
from spark_rapids_jni_tpu_torch.obs import flight as _flight
# per-request attribution hooks (TLS pointer mutations only — no lock,
# no blocking — so calling them under self._lock is safe)
from spark_rapids_jni_tpu_torch.serve import attribution as _attrib

__all__ = [
    "ResultCache", "result_cache",
    "array_digest", "tables_fingerprint", "plan_result_key",
    "request_key", "key_token",
]

# storage kinds (how a value serializes / which tiers it may occupy)
_KIND_TABLE = "table"   # Dict[str, np.ndarray]: HBM-capable, framed disk
_KIND_ARRAY = "array"   # one np.ndarray: HBM-capable, framed disk
_KIND_BLOB = "blob"     # any picklable value: host + (pickled) disk

# entry residency: fresh entries materialize host-side and PLACE once
# (host->hbm when the budget has headroom, host->disk when larger than
# the host cap — both before the entry is visible in the table); after
# that residency only walks DOWN (promote = recompute).  Every
# transition site below carries the matching annotation so the analyze
# gate's state-machine pass pins the direction at merge time.
# state-machine: rcache_tier field=tier
_TIER_TRANSITIONS = {
    "hbm": ("host",),          # pressure/cap demotion (budget released)
    "host": ("hbm", "disk"),   # insert placement up; host-cap demotion
    #                            down (framed + CRC to disk)
    "disk": (),                # terminal residency; drops delete the file
}


def array_digest(a: np.ndarray) -> int:
    """CRC32 content fingerprint of one column buffer (dtype + shape +
    raw bytes — bit-equal arrays and only bit-equal arrays collide)."""
    a = np.ascontiguousarray(a)
    h = zlib.crc32(f"{a.dtype.str}:{a.shape}".encode())
    return zlib.crc32(a.tobytes(), h) & 0xFFFFFFFF


def _quantized(n: int, dp: int) -> int:
    from spark_rapids_jni_tpu_torch.parallel.shuffle import quantized_rows

    return quantized_rows(n, dp)


def tables_fingerprint(tables: Dict[str, Dict[str, np.ndarray]],
                       dp: int) -> Tuple[tuple, tuple]:
    """(fingerprint, deps) of a name->{field: array} table dict.

    The fingerprint carries, per table (name-sorted): the table's
    current version (models/tables.py), then per field the dtype, the
    pow2/dp-quantized padded length (the bucket the compiled variant
    keys on), and the content CRC.  ``deps`` is the (name, version)
    stamp :meth:`ResultCache.put` revalidates — a version bump between
    fingerprint and result drops the insert instead of caching a result
    no future key can name truthfully."""
    from spark_rapids_jni_tpu_torch.models import tables as _tables

    deps = _tables.versions_of(sorted(tables))
    fp = []
    for (name, version) in deps:
        fields = tables[name]
        cols = tuple(
            (f, str(np.asarray(v).dtype), _quantized(len(v), dp),
             array_digest(np.asarray(v)))
            for f, v in sorted(fields.items()))
        fp.append((name, version, cols))
    return tuple(fp), deps


def plan_result_key(plan, dp: int,
                    tables: Dict[str, Dict[str, np.ndarray]]) -> Tuple:
    """Cache key of one governed plan execution: (plan value, input
    fingerprint, bucket geometry).  Returns ``(key, deps)``."""
    from spark_rapids_jni_tpu_torch.plans import ir

    fp, deps = tables_fingerprint(tables, dp)
    return ("plan", ir.plan_signature(plan), int(dp), fp), deps


def request_key(handler: str, payload_key: Any,
                table_names=()) -> Tuple:
    """Cache key of one serving request: handler name + the handler's
    declared payload key + the version of every named table dependency.
    Returns ``(key, deps)`` — ``payload_key`` should already embed a
    content digest (``array_digest``) for any data the payload ships."""
    from spark_rapids_jni_tpu_torch.models import tables as _tables

    deps = _tables.versions_of(sorted(table_names))
    return ("req", handler, payload_key, deps), deps


def key_token(key: Tuple) -> str:
    """Short stable token of a key (flight-event details, hot-key
    advertisement across the supervisor pipe).  repr-based: keys are
    built from str/int/tuple only, so the token is identical in every
    process that builds the same key."""
    return f"{zlib.crc32(repr(key).encode()) & 0xFFFFFFFF:08x}"


def _frozen_host(v: torch.Tensor) -> np.ndarray:
    """A device-tier array as read-only host numpy (a view of a CPU tensor,
    a download of a CUDA one), frozen like every host-tier value."""
    a = v.cpu().numpy()
    a.flags.writeable = False
    return a


def _release_budget(budget, nbytes: int) -> None:
    # resource: release budget
    """Hand ``nbytes`` of HBM reservation back.  A budget whose governor
    already closed (teardown, shutdown race) raises from the native
    arbiter AFTER the byte accounting already settled — the reservation
    is gone either way, so the wake-blocked-tenants side effect is all
    that's lost."""
    try:
        budget.release(nbytes)
    except RuntimeError:
        pass


class _Entry:
    """One cached result's residency record."""

    __slots__ = ("key", "token", "kind", "tier", "value", "nbytes",
                 "deps", "hits", "seq", "path", "budget", "label")

    def __init__(self, key, token, kind, value, nbytes, deps, label):
        self.key = key
        self.token = token
        self.kind = kind
        self.tier = "host"  # fresh entries materialize host-side; see
        #                     _TIER_TRANSITIONS for the residency ladder
        self.value = value      # device dict | host dict/array/object |
        #                         None while resident on disk only
        self.nbytes = nbytes
        self.deps = deps        # ((table, version), ...) at store time
        self.hits = 0
        self.seq = 0            # LRU clock value
        self.path = ""          # disk-tier frame file
        self.budget = None      # BudgetedResource holding the HBM bytes
        self.label = label      # handler / plan name (events, servetop)


class ResultCache:
    """Process-global multi-tier result store (see module doc).

    One re-entrant lock guards the table and every residency move; disk
    I/O runs under it too — demotions and cold disk hits are rare and
    small next to the compute they replace, and a lock-free file path
    would reintroduce exactly the remove-vs-readmit races the spill
    pool had to close.  Lock order is cache -> budget everywhere (the
    budget never calls the cache while holding its own lock: spill
    handlers run outside it)."""

    def __init__(self, *, hbm_bytes: Optional[int] = None,
                 host_bytes: Optional[int] = None,
                 max_entries: Optional[int] = None,
                 directory: Optional[str] = None):
        self._hbm_cap = hbm_bytes
        self._host_cap = host_bytes
        self._max_entries = max_entries
        self._dir = directory
        self._lock = threading.RLock()
        self._entries: Dict[Tuple, _Entry] = {}  # guarded-by: _lock
        self._clock = 0  # guarded-by: _lock
        self._budget = None  # guarded-by: _lock
        self._device = None  # the HBM tier's device  # guarded-by: _lock
        self._tier_bytes = {"hbm": 0, "host": 0, "disk": 0}  # guarded-by: _lock
        self._stats: Dict[str, int] = {  # guarded-by: _lock
            "lookups": 0, "hits": 0, "hits_hbm": 0, "hits_host": 0,
            "hits_disk": 0, "misses": 0, "stores": 0, "stale_puts": 0,
            "demotes_hbm_host": 0, "demotes_host_disk": 0,
            "evictions": 0, "invalidated": 0, "corrupt_drops": 0,
        }
        self._listening = False  # guarded-by: _lock

    # -- configuration -----------------------------------------------------
    def _cap(self, which: str) -> int:
        ctor = {"hbm": self._hbm_cap, "host": self._host_cap,
                "entries": self._max_entries}[which]
        if ctor is not None:
            return int(ctor)
        from spark_rapids_jni_tpu_torch import config

        flag = {"hbm": "serve_result_cache_hbm_bytes",
                "host": "serve_result_cache_host_bytes",
                "entries": "serve_result_cache_entries"}[which]
        return int(config.get(flag))

    def _disk_dir(self) -> str:
        if self._dir is not None:
            return self._dir
        from spark_rapids_jni_tpu_torch import config

        return str(config.get("serve_result_cache_dir") or "")

    def bind_budget(self, budget, device: _device.DeviceLike = None) -> None:
        """Attach the device budget the HBM tier reserves from, and
        register the pressure spill handler on it (idempotent per
        budget and device).  The tier's entries live on ``device``, the
        card unless the caller asks for the CPU.  Rebinding demotes
        entries held on the OLD budget — their reservations must not
        outlive the binding."""
        dev = _device.resolve(device) if budget is not None else None
        with self._lock:
            old = self._budget
            if old is budget and self._device == dev:
                return
            if old is not None:
                for e in list(self._entries.values()):
                    if e.tier == "hbm":
                        self._demote_hbm_locked(e, reason="rebind")
                old.unregister_spill_handler(self._pressure_demote)
            self._budget = budget
            self._device = dev
            if budget is not None:
                budget.register_spill_handler(self._pressure_demote)
            self._ensure_listener_locked()

    def _ensure_listener_locked(self) -> None:
        if self._listening:
            return
        self._listening = True
        from spark_rapids_jni_tpu_torch.models import tables as _tables

        _tables.add_listener(self._on_table_bump)

    # -- the read path -----------------------------------------------------
    def lookup(self, key: Tuple, *, rid: int = -1) -> Optional[Any]:
        """The cached value for ``key``, or None.  Revalidates the
        entry's dependency versions against the live registry on every
        hit — an entry that raced a bump into the table is dropped here,
        never served.  Disk-tier values are CRC-verified on load; any
        damage evicts the entry (reason ``corrupt``) and returns None so
        the caller recomputes."""
        from spark_rapids_jni_tpu_torch.models import tables as _tables

        with self._lock:
            self._ensure_listener_locked()
            self._stats["lookups"] += 1
            e = self._entries.get(key)
            if e is None:
                self._stats["misses"] += 1
                _attrib.note_cache_miss()
                return None
            if e.deps and tuple(_tables.versions_of(
                    [t for t, _ in e.deps])) != e.deps:
                # raced insert from before a bump: reclaim, never serve
                self._drop_locked(e, reason="stale")
                self._stats["misses"] += 1
                _attrib.note_cache_miss()
                return None
            value = self._materialize_locked(e)
            if value is None:  # corrupt disk frame: already evicted
                self._stats["misses"] += 1
                _attrib.note_cache_miss()
                return None
            self._clock += 1
            e.seq = self._clock
            e.hits += 1
            self._stats["hits"] += 1
            self._stats[f"hits_{e.tier}"] += 1
            prefix = f"rid:{rid}:" if rid >= 0 else ""
            _flight.record(_flight.EV_RCACHE_HIT, rid,
                           detail=f"{prefix}handler:{e.label}:tier:"
                                  f"{e.tier}:key:{e.token}",
                           value=e.nbytes)
            _attrib.note_cache_hit(e.nbytes)
            return value

    def _materialize_locked(self, e: _Entry) -> Optional[Any]:
        """The servable value of one entry (caller holds the lock)."""
        if e.tier == "hbm":
            return {k: _frozen_host(v) for k, v in e.value.items()} \
                if e.kind == _KIND_TABLE else _frozen_host(e.value)
        if e.tier == "host":
            if e.kind == _KIND_TABLE:
                return dict(e.value)
            if e.kind == _KIND_BLOB:
                return self._unpickle_locked(e, e.value)
            return e.value
        return self._load_disk_locked(e)

    def _unpickle_locked(self, e: _Entry, raw) -> Optional[Any]:
        """Each blob hit decodes its own copy (see _adopt); a value that
        stopped unpickling (its class was redefined/removed) drops to a
        recompute rather than failing the request."""
        try:
            return pickle.loads(bytes(raw))
        except (pickle.UnpicklingError, ValueError, EOFError,
                AttributeError, IndexError, ImportError):
            self._stats["corrupt_drops"] += 1
            self._drop_locked(e, reason="corrupt")
            return None

    def _load_disk_locked(self, e: _Entry) -> Optional[Any]:
        try:
            with open(e.path, "rb") as f:
                meta, bufs = _frames.decode_frame(f.read())
        except (OSError, _frames.FrameError):
            self._stats["corrupt_drops"] += 1
            self._drop_locked(e, reason="corrupt")
            return None
        # identity is the FULL key, not just the 32-bit filename token:
        # two keys whose tokens collide share a path (the later demote
        # overwrote it), and serving the survivor's payload under the
        # other key would be a wrong answer — exactly what this module
        # promises cannot happen.  A mismatch reads as corruption: drop
        # and recompute.
        if (meta[0] != _frames.FR_RESULT or meta[1] != e.token
                or meta[5] != repr(e.key)):
            self._stats["corrupt_drops"] += 1
            self._drop_locked(e, reason="corrupt")
            return None
        tag, token, kind, names, shapes, keyrepr = meta
        if kind == _KIND_BLOB:
            return self._unpickle_locked(e, bufs[0].tobytes())
        arrays = [b.reshape(tuple(s)) for b, s in zip(bufs, shapes)]
        if kind == _KIND_ARRAY:
            return arrays[0]
        return dict(zip(names, arrays))

    # -- the write path ----------------------------------------------------
    def put(self, key: Tuple, value: Any, deps=(), *,
            label: str = "") -> bool:
        """Insert one computed result.  Returns False (and stores
        nothing) when a dependency version moved since ``deps`` was
        stamped — the bump-mid-flight guard — or when the value cannot
        be sized/serialized.  Insert tier: HBM when the bound budget has
        headroom RIGHT NOW (``try_acquire`` — never blocks, never
        squeezes live work to make room for cache), else host, demoting
        LRU residents down the ladder to respect each cap."""
        from spark_rapids_jni_tpu_torch.models import tables as _tables

        kind, stored, nbytes = self._adopt(value)
        if stored is None:
            return False
        with self._lock:
            self._ensure_listener_locked()
            deps = tuple(deps)
            if deps and tuple(_tables.versions_of(
                    [t for t, _ in deps])) != deps:
                self._stats["stale_puts"] += 1
                return False
            old = self._entries.get(key)
            if old is not None:
                self._drop_locked(old, reason="replaced", quiet=True)
            e = _Entry(key, key_token(key), kind, stored, nbytes,
                       deps, label)
            placed = self._place_locked(e)
            if not placed:
                return False
            self._clock += 1
            e.seq = self._clock
            self._entries[key] = e
            self._stats["stores"] += 1
            _flight.record(_flight.EV_RCACHE_STORE, -1,
                           detail=f"handler:{label}:tier:{e.tier}:"
                                  f"key:{e.token}",
                           value=nbytes)
            _attrib.note_cache_store(nbytes)
            cap = max(1, self._cap("entries"))
            while len(self._entries) > cap:
                lru = min(self._entries.values(), key=lambda x: x.seq)
                self._drop_locked(lru, reason="cap")
            return True

    def _adopt(self, value: Any):
        """(kind, stored_value, nbytes) — host copies decoupled from the
        caller and frozen read-only, so neither side can mutate the
        other's view of a cached result."""
        if isinstance(value, dict) and value and all(
                isinstance(v, np.ndarray) for v in value.values()):
            stored = {}
            for k, v in value.items():
                c = np.array(v, copy=True)
                c.flags.writeable = False
                stored[k] = c
            return (_KIND_TABLE, stored,
                    sum(int(v.nbytes) for v in stored.values()))
        if isinstance(value, np.ndarray):
            c = np.array(value, copy=True)
            c.flags.writeable = False
            return _KIND_ARRAY, c, int(c.nbytes)
        try:
            pickled = pickle.dumps(value)
        except (pickle.PicklingError, TypeError, ValueError,
                AttributeError):
            return _KIND_BLOB, None, 0  # unpicklable: not cacheable
        # blobs are stored as their PICKLED bytes, not the live object:
        # a mutable result (list, dict of scalars) the caller keeps a
        # reference to must not be able to poison the cache, and every
        # hit must hand each client its own fresh copy
        return _KIND_BLOB, pickled, len(pickled)

    def _place_locked(self, e: _Entry) -> bool:
        """Choose the insert tier for a fresh host-side entry."""
        if (e.kind in (_KIND_TABLE, _KIND_ARRAY)
                and self._budget is not None
                and e.nbytes <= self._cap("hbm")):
            while (self._tier_bytes["hbm"] + e.nbytes > self._cap("hbm")
                   and self._demote_lru_locked("hbm", reason="cap")):
                pass
            if (self._tier_bytes["hbm"] + e.nbytes <= self._cap("hbm")
                    and self._budget.try_acquire(e.nbytes)):
                # the opportunistic bytes are held from HERE until the
                # entry owns them (e.budget) or a release hands them
                # back: round 15's review found the narrower
                # except-clause release leaking the reservation when
                # the upload failed with anything OUTSIDE the expected
                # types (the exact historical shape the
                # resource-lifecycle gate now pins — the outer
                # BaseException arm is the all-paths backstop)
                try:
                    host = e.value
                    dev = self._device

                    try:
                        if e.kind == _KIND_TABLE:
                            # analyze: ignore[governed-allocation] -
                            # cached residency deliberately bypasses the
                            # retry bracket: its bytes were just
                            # try_acquire'd from the SAME budget
                            # (accounted, never blocking), and a cache
                            # insert must never park a thread or draw
                            # Retry/Split signals meant for live queries
                            e.value = {k: torch.tensor(v, device=dev)
                                       for k, v in host.items()}
                        else:
                            # analyze: ignore[governed-allocation] - same
                            # try_acquire-accounted cache upload as above
                            e.value = torch.tensor(host, device=dev)
                    except (RuntimeError, ValueError):
                        # the device refused (torch.cuda.OutOfMemoryError
                        # is a RuntimeError; fragmentation, shutdown):
                        # stay host-side and hand the bytes back
                        e.value = host
                        _release_budget(self._budget, e.nbytes)
                    else:
                        e.tier = "hbm"  # transition: rcache_tier host->hbm
                        #                 (insert placement: the entry is
                        #                 not yet visible in the table)
                        e.budget = self._budget
                        self._tier_bytes["hbm"] += e.nbytes
                        return True
                except BaseException:
                    # an unexpected fault mid-upload (anything but the
                    # refusal types above) must not leak the reservation
                    _release_budget(self._budget, e.nbytes)
                    raise
        # host tier: make room under the cap (demote LRU to disk when a
        # spool dir is configured, else evict)
        if e.nbytes > self._cap("host"):
            return self._spill_to_disk_locked(e)
        while (self._tier_bytes["host"] + e.nbytes > self._cap("host")
               and self._demote_lru_locked("host", reason="cap")):
            pass
        if self._tier_bytes["host"] + e.nbytes > self._cap("host"):
            return False  # nothing left to demote and still no room
        self._tier_bytes["host"] += e.nbytes
        return True

    def _spill_to_disk_locked(self, e: _Entry) -> bool:
        """Write a fresh entry straight to the disk tier (value larger
        than the host cap).  False when no dir is configured."""
        if not self._write_disk_locked(e):
            return False
        e.tier = "disk"  # transition: rcache_tier host->disk (insert
        #                  placement of an over-host-cap value)
        e.value = None
        self._tier_bytes["disk"] += e.nbytes
        return True

    # -- demotion / eviction ----------------------------------------------
    def _lru_locked(self, tier: str) -> Optional[_Entry]:
        cands = [e for e in self._entries.values() if e.tier == tier]
        return min(cands, key=lambda e: e.seq) if cands else None

    def _demote_lru_locked(self, tier: str, *, reason: str) -> bool:
        e = self._lru_locked(tier)
        if e is None:
            return False
        if tier == "hbm":
            return self._demote_hbm_locked(e, reason=reason)
        return self._demote_host_locked(e, reason=reason)

    def _demote_hbm_locked(self, e: _Entry, *, reason: str) -> bool:
        if e.tier != "hbm":
            return False
        host = ({k: _frozen_host(v) for k, v in e.value.items()}
                if e.kind == _KIND_TABLE else _frozen_host(e.value))
        e.tier = "host"  # transition: rcache_tier hbm->host
        e.value = host
        self._tier_bytes["hbm"] -= e.nbytes
        self._tier_bytes["host"] += e.nbytes
        if e.budget is not None:
            _release_budget(e.budget, e.nbytes)
            e.budget = None
        self._stats["demotes_hbm_host"] += 1
        _flight.record(_flight.EV_RCACHE_DEMOTE, -1,
                       detail=f"key:{e.token}:hbm->host:reason:{reason}",
                       value=e.nbytes)
        # respect the host cap the demotion just pressured
        while (self._tier_bytes["host"] > self._cap("host")
               and self._demote_lru_locked("host", reason="cap")):
            pass
        return True

    def _demote_host_locked(self, e: _Entry, *, reason: str) -> bool:
        if e.tier != "host":
            return False
        if not self._write_disk_locked(e):
            self._drop_locked(e, reason="cap")
            return True  # room WAS freed, just not preserved
        e.tier = "disk"  # transition: rcache_tier host->disk
        e.value = None
        self._tier_bytes["host"] -= e.nbytes
        self._tier_bytes["disk"] += e.nbytes
        self._stats["demotes_host_disk"] += 1
        _flight.record(_flight.EV_RCACHE_DEMOTE, -1,
                       detail=f"key:{e.token}:host->disk:reason:{reason}",
                       value=e.nbytes)
        return True

    def _write_disk_locked(self, e: _Entry) -> bool:
        d = self._disk_dir()
        if not d:
            return False
        if e.kind == _KIND_TABLE:
            names = sorted(e.value)
            meta = (_frames.FR_RESULT, e.token, e.kind, names,
                    [list(e.value[n].shape) for n in names],
                    repr(e.key))
            bufs = [np.ascontiguousarray(e.value[n]).reshape(-1)
                    for n in names]
        elif e.kind == _KIND_ARRAY:
            meta = (_frames.FR_RESULT, e.token, e.kind, [],
                    [list(e.value.shape)], repr(e.key))
            bufs = [np.ascontiguousarray(e.value).reshape(-1)]
        else:  # blob: e.value already IS the pickled bytes (_adopt)
            meta = (_frames.FR_RESULT, e.token, e.kind, [], [],
                    repr(e.key))
            bufs = [np.frombuffer(e.value, np.uint8)]
        path = os.path.join(d, f"rc_{e.token}.frame")
        try:
            os.makedirs(d, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(_frames.encode_frame(meta, bufs))
            os.replace(tmp, path)  # atomic: readers never see a torn file
        except OSError:
            return False
        e.path = path
        return True

    def _drop_locked(self, e: _Entry, *, reason: str,
                     quiet: bool = False) -> None:
        self._entries.pop(e.key, None)
        self._tier_bytes[e.tier] -= e.nbytes
        if e.tier == "hbm" and e.budget is not None:
            _release_budget(e.budget, e.nbytes)
            e.budget = None
        if e.tier == "disk" and e.path:
            try:
                os.remove(e.path)
            except OSError:
                pass
        e.value = None
        if not quiet:
            # drop categories stay DISJOINT gauges (an operator sums
            # them): stale drops count as `invalidated`, CRC failures as
            # `corrupt_drops` (both at their call sites) — `evictions`
            # is capacity pressure only.  The flight event narrates all
            # of them, with the reason in its detail.
            if reason not in ("stale", "corrupt"):
                self._stats["evictions"] += 1
            _flight.record(_flight.EV_RCACHE_EVICT, -1,
                           detail=f"key:{e.token}:tier:{e.tier}:"
                                  f"reason:{reason}",
                           value=e.nbytes)

    # -- governance hooks --------------------------------------------------
    def _pressure_demote(self, nbytes: int) -> int:
        """Budget spill handler: live queries are short of ``nbytes`` —
        demote LRU HBM entries until that much budget came back.  Runs
        BEFORE the arbiter's BLOCKED/BUFN escalation, so a RetryOOM
        storm squeezes cached residency first and kills nothing."""
        freed = 0
        with self._lock:
            while freed < nbytes:
                e = self._lru_locked("hbm")
                if e is None:
                    break
                n = e.nbytes
                if self._demote_hbm_locked(e, reason="pressure"):
                    freed += n
                else:  # pragma: no cover - defensive: tier raced
                    break
        return freed

    def _on_table_bump(self, name: str, version: int) -> None:
        """models/tables listener: reclaim every entry depending on an
        older version of ``name`` (the bump already made them
        unreachable — this returns their bytes)."""
        with self._lock:
            victims = [e for e in self._entries.values()
                       if any(t == name and v < version
                              for t, v in e.deps)]
            for e in victims:
                self._stats["invalidated"] += 1
                self._drop_locked(e, reason="stale")

    # -- introspection / lifecycle ----------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = dict(self._stats)
            out["entries"] = len(self._entries)
            for tier in ("hbm", "host", "disk"):
                out[f"{tier}_bytes"] = self._tier_bytes[tier]
                out[f"{tier}_entries"] = sum(
                    1 for e in self._entries.values() if e.tier == tier)
            looked = out["lookups"]
            out["hit_ratio"] = round(out["hits"] / looked, 4) if looked \
                else 0.0
            return out

    def hot_tokens(self, n: int = 16):
        """The ``n`` hottest resident keys' tokens, hits-descending —
        what a worker advertises in its heartbeat gauges so the router
        knows which submits will hit somewhere (serve/supervisor.py's
        cached_only admission)."""
        with self._lock:
            hot = sorted(self._entries.values(),
                         key=lambda e: (-e.hits, -e.seq))[:max(0, n)]
            return [e.token for e in hot if e.hits > 0]

    def clear(self) -> None:
        with self._lock:
            for e in list(self._entries.values()):
                self._drop_locked(e, reason="clear", quiet=True)

    def reset_for_tests(self) -> None:
        from spark_rapids_jni_tpu_torch.models import tables as _tables

        with self._lock:
            self.clear()
            for k in self._stats:
                self._stats[k] = 0
            if self._budget is not None:
                self._budget.unregister_spill_handler(
                    self._pressure_demote)
                self._budget = None
                self._device = None
            _tables.remove_listener(self._on_table_bump)
            self._listening = False


#: the process-global cache every read/write path shares (one resident
#: set, one gauge surface — like plan_cache and the default budget)
result_cache = ResultCache()

_flight.register_telemetry_source("result_cache", result_cache.stats)
