"""Offline profile converter CLI (spark_rapids_profile_converter analog; a
copy of the JAX package's ``obs/convert.py`` but for the device trace it
reads).

Parses the SRTP capture format (obs/profiler.py) and emits either JSON lines
(one event per line) or a chrome://tracing / Perfetto-compatible trace,
the role NVTXT output plays for the reference
(spark_rapids_profile_converter.cpp:106-116).

With ``--device-trace DIR`` (the ``device_trace_dir`` handed to
Profiler.init), the ``torch.profiler`` chrome exports in ``DIR`` (one per
start/stop window; the JAX package reads its run's perfetto export) are
merged into the chrome output: host seam ranges and on-device kernel events
interleave on one timeline, the role the reference's per-kernel device
activity records play in its capture stream (profiler.fbs:124-287,
ProfilerJni.cpp:366).  An export stamps each event in microseconds after
its ``baseTimeNanoseconds`` on the wall clock; :func:`load_device_trace`
adds that base, so the events read as wall-clock microseconds.  Device
events sit under shifted pids so tracks stay distinguishable; alignment uses
the wall/monotonic clock anchor the profiler banks at start() when the
device clock reads as wall time, else falls back to aligning both streams at
their first event; where a window holds the profiler's warm-up and closing
marks (on a card), its events are also rescaled by the clock rate error the
marks show.

Usage::

    python -m spark_rapids_jni_tpu_torch.obs.convert capture.srtp --format json
    python -m spark_rapids_jni_tpu_torch.obs.convert capture.srtp --format chrome \
        --device-trace /tmp/devtrace -o trace.json
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import struct
import sys
from typing import Iterator, List, Optional

from spark_rapids_jni_tpu_torch.obs.flight import EVENT_KINDS
from spark_rapids_jni_tpu_torch.obs.profiler import (
    CLOCK_ANCHOR,
    CLOSING_RANGE,
    MAGIC,
    VERSION,
    WARMUP_RANGE,
)

_CATEGORY_NAMES = ["op", "transfer", "collective", "alloc", "marker",
                   "spill", "compile", "serve"]

SUPPORTED_VERSIONS = (1, 2)

# per-version record sizes that differ: v1 COUNTER carried no tid
_COUNTER_FMT = {1: "<IQq", 2: "<IQqI"}


def parse_capture(data: bytes, *, midstream: bool = False,
                  version: Optional[int] = None,
                  strict: bool = False) -> Iterator[dict]:
    """Yield event dicts from a raw capture byte string.

    Reads format v1 and v2 (v2 adds STATE records and a tid on COUNTER).
    ``midstream=True`` starts at a *block boundary* with no file header —
    every block is self-contained (the string table restarts per block),
    so a consumer attaching to a live stream can begin at any size prefix;
    ``version`` then selects the record layout (default: current).

    A truncated final block (a writer killed mid-flush) ends iteration
    cleanly instead of raising, unless ``strict=True``.  Corruption
    *inside* a complete block (unknown record kind) still raises.
    """
    if midstream:
        pos = 0
        version = VERSION if version is None else version
    else:
        if data[:4] != MAGIC:
            raise ValueError("not an SRTP capture (bad magic)")
        version = struct.unpack_from("<I", data, 4)[0]
        pos = 8
    if version not in SUPPORTED_VERSIONS:
        raise ValueError(f"unsupported SRTP version {version}")
    cfmt = _COUNTER_FMT[version]
    clen = struct.calcsize(cfmt)
    while pos < len(data):
        if pos + 4 > len(data):
            if strict:
                raise ValueError("truncated capture: partial block length")
            return
        (blen,) = struct.unpack_from("<I", data, pos)
        pos += 4
        end = pos + blen
        if end > len(data):
            if strict:
                raise ValueError("truncated capture: partial final block")
            return
        names = {}
        while pos < end:
            kind = data[pos]
            pos += 1
            if kind == 0:  # STRING_DEF
                nid, ln = struct.unpack_from("<IH", data, pos)
                pos += 6
                names[nid] = data[pos : pos + ln].decode("utf-8")
                pos += ln
            elif kind == 1:  # RANGE
                nid, cat, t0, t1, tid = struct.unpack_from("<IBQQI", data, pos)
                pos += 25
                yield {"type": "range", "name": names.get(nid, f"#{nid}"),
                       "category": _CATEGORY_NAMES[cat], "start_ns": t0,
                       "end_ns": t1, "tid": tid}
            elif kind == 2:  # INSTANT
                nid, cat, t, tid = struct.unpack_from("<IBQI", data, pos)
                pos += 17
                yield {"type": "instant", "name": names.get(nid, f"#{nid}"),
                       "category": _CATEGORY_NAMES[cat], "t_ns": t, "tid": tid}
            elif kind == 3:  # COUNTER
                vals = struct.unpack_from(cfmt, data, pos)
                pos += clen
                nid, t, value = vals[0], vals[1], vals[2]
                yield {"type": "counter", "name": names.get(nid, f"#{nid}"),
                       "t_ns": t, "value": value,
                       "tid": vals[3] if version >= 2 else None}
            elif kind == 4 and version >= 2:  # STATE
                ek, task_id, t, tid, did, value = struct.unpack_from(
                    "<BqQIIq", data, pos)
                pos += 33
                yield {"type": "state",
                       "kind": (EVENT_KINDS[ek] if ek < len(EVENT_KINDS)
                                else f"#{ek}"),
                       "task_id": task_id, "t_ns": t, "tid": tid,
                       "detail": names.get(did, f"#{did}"), "value": value}
            else:
                raise ValueError(f"corrupt capture: record kind {kind}")
        pos = end


# pid for the reconstructed per-task governance tracks (host seam events
# are pid 0, merged device tracks sit at >= 1000)
_GOV_PID = 2000

# state kinds whose `value` carries a duration (ns) ending at t_ns: they
# render as complete ('X') slices so blocked windows are visible spans
_STATE_DUR_KINDS = {"woken": "blocked", "spill_end": "spill"}


def _state_to_chrome(e: dict, out: list, named_tracks: set) -> None:
    """One governance STATE event -> chrome events on a per-task track."""
    track = e["task_id"] if e["task_id"] >= 0 else e["tid"]
    if track not in named_tracks:
        named_tracks.add(track)
        if not named_tracks - {track}:  # first track names the process
            out.append({"ph": "M", "pid": _GOV_PID, "name": "process_name",
                        "args": {"name": "governance"}})
        label = (f"task {track}" if e["task_id"] >= 0
                 else f"thread {e['tid']} (untasked)")
        out.append({"ph": "M", "pid": _GOV_PID, "tid": track,
                    "name": "thread_name", "args": {"name": label}})
    span = _STATE_DUR_KINDS.get(e["kind"])
    if span is not None and e["value"] > 0:
        out.append({"name": span, "cat": "governance", "ph": "X",
                    "ts": (e["t_ns"] - e["value"]) / 1e3,
                    "dur": e["value"] / 1e3, "pid": _GOV_PID, "tid": track,
                    "args": {"detail": e["detail"]}})
    else:
        out.append({"name": e["kind"], "cat": "governance", "ph": "i",
                    "ts": e["t_ns"] / 1e3, "pid": _GOV_PID, "tid": track,
                    "s": "t", "args": {"detail": e["detail"]}})


def to_chrome(events) -> dict:
    """Chrome trace-event JSON (ts/dur in microseconds).

    Governance STATE events land on per-task tracks under a dedicated
    ``governance`` pid, on the same monotonic timeline as the op/serve
    ranges — blocked windows (and spills) render as spans, the other
    transitions as instants.
    """
    out = []
    named_tracks: set = set()
    for e in events:
        if e["type"] == "range":
            out.append({"name": e["name"], "cat": e["category"], "ph": "X",
                        "ts": e["start_ns"] / 1e3,
                        "dur": (e["end_ns"] - e["start_ns"]) / 1e3,
                        "pid": 0, "tid": e["tid"]})
        elif e["type"] == "instant":
            out.append({"name": e["name"], "cat": e["category"], "ph": "i",
                        "ts": e["t_ns"] / 1e3, "pid": 0, "tid": e["tid"],
                        "s": "t"})
        elif e["type"] == "state":
            _state_to_chrome(e, out, named_tracks)
        else:
            out.append({"name": e["name"], "ph": "C", "ts": e["t_ns"] / 1e3,
                        "pid": 0, "args": {"value": e["value"]}})
    return {"traceEvents": out}


# pid offset for merged device tracks: SRTP host events are pid 0
_DEVICE_PID_BASE = 1000
# first number given to a device track named by a string pid (above pid_max)
_NAMED_PID_BASE = 1 << 24


def load_device_trace(trace_dir: str) -> List[dict]:
    """Raw trace events of every torch.profiler chrome export in
    ``trace_dir`` (one per start/stop window of the capture, oldest first;
    [] when none was captured there), each ``ts`` moved by its export's
    ``baseTimeNanoseconds`` to wall-clock microseconds.  The exports name
    some tracks by a string pid ("Spans"); each such pid gets a number of
    its own above any process id."""
    paths = sorted(
        glob.glob(os.path.join(trace_dir, "*.json"))
        + glob.glob(os.path.join(trace_dir, "*.json.gz")),
        key=os.path.getmtime)
    named_pids: dict = {}
    out = []
    for path in paths:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            doc = json.load(f)
        base_us = (doc.get("baseTimeNanoseconds", 0) / 1e3
                   if isinstance(doc, dict) else 0.0)
        evs = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        for e in evs:
            if not isinstance(e, dict):
                continue
            if "ts" in e and isinstance(e["ts"], (int, float)):
                e = dict(e, ts=e["ts"] + base_us)
            pid = e.get("pid", 0)
            if not isinstance(pid, int):
                e = dict(e, pid=named_pids.setdefault(pid, _NAMED_PID_BASE + len(named_pids)))
            out.append(e)
    return out


# a fitted clock rate error above this is taken for a mismatched mark, and
# the window keeps its anchor's placement alone
_MAX_CLOCK_RATE = 0.05


def _clock_rate(host: List[dict], kernels: List[dict], shift_us: float):
    """(the host time it is fitted from, the rate error) of one window's
    profiler clock against the host's, or None: its first and last kernel
    launches are the warm-up's and the closing mark's (Profiler.start and
    stop), each synchronized on inside a host range, so the last kernel to end
    within the warm-up range and the window's last kernel should end as far
    before their ranges' ends; what the second is off beyond the first,
    over the host time between them, is the rate error."""
    if not kernels:
        return None
    first = kernels[0]["ts"] + shift_us
    last_end = max(k["ts"] + k["dur"] for k in kernels) + shift_us

    def nearest(name, t):
        cands = [e for e in host if e.get("pid") == 0 and e.get("ph") == "X"
                 and e.get("name") == name]
        return min(cands, key=lambda e: abs(e["ts"] - t), default=None)

    w, c = nearest(WARMUP_RANGE, first), nearest(CLOSING_RANGE, last_end)
    if w is None or c is None:
        return None
    w_end, c_end = w["ts"] + w["dur"], c["ts"] + c["dur"]
    in_w = [k["ts"] + k["dur"] + shift_us for k in kernels
            if w["ts"] <= k["ts"] + shift_us and k["ts"] + k["dur"] + shift_us <= w_end]
    if not in_w or c_end <= w_end:
        return None
    rate = ((last_end - c_end) - (max(in_w) - w_end)) / (c_end - w_end)
    return (w_end, rate) if abs(rate) <= _MAX_CLOCK_RATE else None


def merge_device_events(chrome: dict, dev_events: List[dict],
                        wall_minus_mono_ns: Optional[int]) -> dict:
    """Interleave device trace events into a chrome trace built from SRTP.

    Complete ('X') device events are remapped to pids >= 1000; metadata
    ('M') events ride along so track names survive.  If the device clock
    reads as wall time and the capture carries the clock anchor, events
    are placed exactly on the host monotonic timeline; otherwise both
    streams are aligned at their first event.  Where the window's export
    holds the kernels of the profiler's warm-up and closing marks (a card),
    its events are also rescaled by the rate error those marks show
    (:func:`_clock_rate`), recorded in the trace's ``deviceClockRates``.
    """
    host = chrome["traceEvents"]
    xs = [e for e in dev_events if e.get("ph") == "X" and "ts" in e]
    if not xs:
        return chrome
    dev_min_us = min(e["ts"] for e in xs)
    host_min_us = min((e["ts"] for e in host if "ts" in e), default=0.0)

    shift_us = host_min_us - dev_min_us  # fallback: align first events
    if wall_minus_mono_ns is not None:
        exact = -wall_minus_mono_ns / 1e3  # wall us -> monotonic us
        # trust the anchor only when it lands the device stream inside an
        # hour of the host stream (i.e. the device ts really is wall time)
        if abs((dev_min_us + exact) - host_min_us) < 3600e6:
            shift_us = exact

    kernels = sorted((e for e in xs if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    fit = _clock_rate(host, kernels, shift_us)
    if fit is not None:
        chrome.setdefault("deviceClockRates", []).append(fit[1])
    for e in dev_events:
        ph = e.get("ph")
        if ph not in ("X", "M"):
            continue
        m = dict(e)
        m["pid"] = _DEVICE_PID_BASE + int(e.get("pid", 0))
        if ph == "X":
            m["ts"] = e["ts"] + shift_us
            if fit is not None:  # stamped t0 + (t - t0)(1 + rate): invert it
                t0, rate = fit
                m["ts"] = t0 + (m["ts"] - t0) / (1 + rate)
                m["dur"] = e.get("dur", 0) / (1 + rate)
            m.setdefault("cat", "device")
        host.append(m)
    return chrome


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Convert an SRTP profiler capture to JSON or chrome trace")
    ap.add_argument("capture")
    ap.add_argument("--format", choices=["json", "chrome"], default="json")
    ap.add_argument("-o", "--output", default="-")
    ap.add_argument("--device-trace", default="",
                    help="device_trace_dir of the run: merge its "
                         "torch.profiler chrome exports into the chrome trace")
    args = ap.parse_args(argv)

    with open(args.capture, "rb") as f:
        data = f.read()
    events = parse_capture(data)

    def emit(out) -> None:
        if args.format == "json":
            for e in events:
                out.write(json.dumps(e) + "\n")
            return
        evs = list(events)
        chrome = to_chrome(evs)
        if args.device_trace:
            anchor = next(
                (e["value"] for e in evs
                 if e["type"] == "counter" and e["name"] == CLOCK_ANCHOR),
                None)
            chrome = merge_device_events(
                chrome, load_device_trace(args.device_trace), anchor)
        json.dump(chrome, out)

    if args.output == "-":
        emit(sys.stdout)
    else:
        with open(args.output, "w") as out:
            emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
