"""Always-on framework profiler with a buffered background writer (PyTorch
port of ``obs/profiler.py``).

Parity target: the CUPTI profiler (Profiler.java:50-124 API,
ProfilerJni.cpp:61-180 double-buffering + :366 writer thread,
profiler_serializer.cpp:222 size-prefixed flatbuffer blocks).  The TPU
analog: op/transfer/collective ranges captured at the dispatch seam
(obs/seam.py), double-buffered through a completed-buffer queue, serialized
by a dedicated writer thread into size-prefixed binary blocks delivered to a
user writer (file path or ``write(bytes)`` object), plus an optional
``torch.profiler`` capture for the device timeline: CPU activity, and CUDA
activity (CUPTI kernel records, under each kernel's own name) when a card is
present, exported as a chrome trace into the directory the caller names with
``device_trace_dir`` (the JAX package's ``xplane_dir``, which held the
jax.profiler XPlane capture).  The capture format is byte for byte the JAX
package's.

Capture format (little-endian):

- file header: ``b"SRTP"`` + u32 version (2; the converter still reads 1)
- blocks: u32 payload_len + payload (the size-prefix mirrors the
  reference's size-prefixed flatbuffers so a stream can be split without
  parsing records)
- payload records, each starting with a u8 kind:
  - 0 STRING_DEF: u32 id, u16 len, utf-8 bytes (interned names)
  - 1 RANGE: u32 name_id, u8 category, u64 start_ns, u64 end_ns, u32 tid
  - 2 INSTANT: u32 name_id, u8 category, u64 t_ns, u32 tid
  - 3 COUNTER: u32 name_id, u64 t_ns, i64 value [, u32 tid — v2 only:
    v1 counters carried no thread id, unlike RANGE/INSTANT]
  - 4 STATE (v2 only): u8 event_kind (obs/flight.py EVENT_KINDS index),
    i64 task_id, u64 t_ns, u32 tid, u32 detail_name_id, i64 value —
    one governance state-transition event from the flight recorder

Offline conversion to JSON / chrome-trace: ``python -m
spark_rapids_jni_tpu_torch.obs.convert`` (the spark_rapids_profile_converter
analog, spark_rapids_profile_converter.cpp:106-116).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import queue
import struct
import threading
import time
from typing import Optional

from spark_rapids_jni_tpu_torch.obs import seam as _seam

__all__ = ["Profiler", "MAGIC", "VERSION", "CLOCK_ANCHOR", "WARMUP_RANGE", "CLOSING_RANGE"]

MAGIC = b"SRTP"
VERSION = 2

# counter emitted at start(): wall-clock ns minus monotonic ns, letting the
# converter place wall-stamped device events (torch.profiler's chrome export
# stamps them in wall-clock time) on the monotonic host timeline
CLOCK_ANCHOR = "__clock_wall_minus_mono_ns"

_CATEGORIES = {_seam.OP: 0, _seam.TRANSFER: 1, _seam.COLLECTIVE: 2,
               _seam.ALLOC: 3, "marker": 4, _seam.SPILL: 5,
               _seam.COMPILE: 6, _seam.SERVE: 7}

_R_STRING, _R_RANGE, _R_INSTANT, _R_COUNTER, _R_STATE = 0, 1, 2, 3, 4


class _State:
    """Module-singleton state (Profiler.java static API shape)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.writer = None
        self.own_file = None
        self.active = False  # between start() and stop()
        self.buf = bytearray()
        self.buf_limit = 1 << 16
        self.completed: "queue.Queue" = queue.Queue()
        self.writer_thread: Optional[threading.Thread] = None
        self.names = {}
        self.next_name_id = 0
        self.device_trace_dir: Optional[str] = None
        self.torch_prof = None  # the running torch.profiler.profile, if any
        self.initialized = False


_st = _State()
_trace_seq = itertools.count()

# device launches that open each device trace window: torch.profiler drops
# the first records of a window that follows earlier profiling sessions in
# the process, about one more per earlier session (1-7 after one to eight
# sessions, 24 after a long run's; measured on the H100 with torch
# 2.11.0+cu128), so throwaway launches take those places
WARMUP_LAUNCHES = 256
WARMUP_RANGE = "profiler:warmup"
# one device launch and a synchronize that close each device trace window:
# with the warm-up's last launch they give the converter a launch at each end
# of the window on both clocks, from which it fits the profiler clock's rate
# to the host's (the two drift apart by up to a few thousand ppm, at a rate
# that differs from process to process)
CLOSING_RANGE = "profiler:closing"


def _intern(name: str) -> int:
    """Intern a name; emits a STRING_DEF record on first sight."""
    nid = _st.names.get(name)
    if nid is None:
        nid = _st.next_name_id
        _st.next_name_id += 1
        _st.names[name] = nid
        raw = name.encode("utf-8")
        _st.buf += struct.pack("<BIH", _R_STRING, nid, len(raw)) + raw
    return nid


def _flush_active_locked():
    if _st.buf:
        _st.completed.put(bytes(_st.buf))
        _st.buf = bytearray()


def _append_locked(rec: bytes):
    """Append one record and flush at the buffer limit (caller holds lock)."""
    _st.buf += rec
    if len(_st.buf) >= _st.buf_limit:
        _flush_active_locked()
        # string table resets with each buffer: every block is
        # self-contained, so a consumer can start mid-stream
        _st.names = {}
        _st.next_name_id = 0


def _writer_loop():
    """Dedicated writer thread (writer_thread_process, ProfilerJni.cpp:366)."""
    while True:
        item = _st.completed.get()
        if item is None:
            return
        _st.writer.write(struct.pack("<I", len(item)) + item)


@contextlib.contextmanager
def _range(category: str, name: str):
    t0 = time.monotonic_ns()
    try:
        yield
    finally:
        t1 = time.monotonic_ns()
        with _st.lock:
            if _st.active:
                nid = _intern(name)
                _append_locked(struct.pack(
                    "<BIBQQI", _R_RANGE, nid, _CATEGORIES.get(category, 0),
                    t0, t1, threading.get_ident() & 0xFFFFFFFF))


class Profiler:
    """Static facade mirroring Profiler.java init/start/stop/shutdown."""

    @staticmethod
    def init(writer, *, buffer_bytes: int = 1 << 16,
             device_trace_dir: Optional[str] = None) -> None:
        """Set up capture.  ``writer`` is a path or an object with
        ``write(bytes)``; events flow only between start() and stop().
        ``device_trace_dir`` (the JAX package's ``xplane_dir``) names the
        directory each start()/stop() window's torch.profiler chrome trace
        is exported into."""
        with _st.lock:
            if _st.initialized:
                raise RuntimeError("profiler already initialized")
            if isinstance(writer, (str, bytes)):
                _st.own_file = open(writer, "wb")
                _st.writer = _st.own_file
            else:
                _st.writer = writer
            _st.buf_limit = buffer_bytes
            _st.device_trace_dir = device_trace_dir
            _st.writer.write(MAGIC + struct.pack("<I", VERSION))
            _st.writer_thread = threading.Thread(
                target=_writer_loop, name="srt-profiler-writer", daemon=True)
            _st.writer_thread.start()
            _st.initialized = True
        _seam._set_profiler(_range)

    @staticmethod
    def start() -> None:
        with _st.lock:
            if not _st.initialized:
                raise RuntimeError("profiler not initialized")
            _st.active = True
        # clock-domain anchor: SRTP ranges are monotonic-ns, the device
        # timeline (torch.profiler's chrome export) is wall-ns: bank the
        # offset so the converter can map device events into the host
        # timebase exactly
        Profiler.counter(CLOCK_ANCHOR,
                         time.time_ns() - time.monotonic_ns())
        if _st.device_trace_dir is not None:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.start()
            _st.torch_prof = prof
            if torch.cuda.is_available():
                with _range("marker", WARMUP_RANGE):
                    pad = torch.zeros(1, device="cuda")
                    for _ in range(WARMUP_LAUNCHES):
                        pad.add_(1)
                    torch.cuda.synchronize()

    @staticmethod
    def stop() -> None:
        prof, _st.torch_prof = _st.torch_prof, None
        if prof is not None:
            import torch

            if torch.cuda.is_available():
                with _range("marker", CLOSING_RANGE):
                    torch.ones(1, device="cuda").add_(1)
                    torch.cuda.synchronize()
            prof.stop()
            # the chrome export is what obs/convert.py merges into the
            # durable trace (the device kernel timeline)
            os.makedirs(_st.device_trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                _st.device_trace_dir,
                f"torch_trace_{os.getpid()}_{next(_trace_seq)}.json"))
        with _st.lock:
            _st.active = False
            _flush_active_locked()
            _st.names = {}
            _st.next_name_id = 0

    @staticmethod
    def shutdown() -> None:
        """Stop capture, drain the queue, detach from the seam."""
        with _st.lock:
            was_init = _st.initialized
            _st.active = False
            _flush_active_locked()
        if not was_init:
            return
        _seam._set_profiler(None)
        _st.completed.put(None)
        _st.writer_thread.join(timeout=10)
        if _st.own_file is not None:
            _st.own_file.close()
        with _st.lock:
            _st.writer = None
            _st.own_file = None
            _st.writer_thread = None
            _st.names = {}
            _st.next_name_id = 0
            _st.initialized = False

    # -- extra event sources ------------------------------------------------
    @staticmethod
    def marker(name: str) -> None:
        """Instant event (NVTX marker analog)."""
        with _st.lock:
            if _st.active:
                nid = _intern(name)
                _append_locked(struct.pack(
                    "<BIBQI", _R_INSTANT, nid, _CATEGORIES["marker"],
                    time.monotonic_ns(), threading.get_ident() & 0xFFFFFFFF))

    @staticmethod
    def counter(name: str, value: int) -> None:
        with _st.lock:
            if _st.active:
                nid = _intern(name)
                _append_locked(struct.pack(
                    "<BIQqI", _R_COUNTER, nid, time.monotonic_ns(), value,
                    threading.get_ident() & 0xFFFFFFFF))

    @staticmethod
    def state(event_kind: int, task_id: int, detail: str = "",
              value: int = 0, *, t_ns: int = 0, tid: int = 0) -> None:
        """Governance state-transition record (obs/flight.py feed).  The
        caller passes its own timestamp/thread so the capture record is
        bit-identical to the ring-buffer event it mirrors."""
        with _st.lock:
            if _st.active:
                did = _intern(detail)
                _append_locked(struct.pack(
                    "<BBqQIIq", _R_STATE, event_kind & 0xFF, task_id,
                    t_ns or time.monotonic_ns(),
                    (tid or threading.get_ident()) & 0xFFFFFFFF,
                    did, value))
