"""The PyTorch port's observability layer against the JAX package's on the
CPU: the profiler's SRTP capture, the converter, the fault injector, the
request spans, steady-state timing and the version stamp.

- The same seam crossings, markers, counters and state records give the same
  SRTP bytes in both packages once timestamps, thread ids and the clock
  anchor's value are masked (tolerance 0 on every other byte).
- Both converters give the same events and chrome trace from one capture.
- A ``torch.profiler`` CPU export merges into the chrome trace on the host's
  monotonic timeline.
- The fault injector makes the same decisions under one seed in both
  packages and across two runs (decisions are compared, never wall time:
  stalls are recorded, not slept).
- The three profiler hooks (governed reservations, flight STATE records,
  the JSON step-cap counter) reach the capture; the injector arms from the
  environment when ``ops`` is imported.
"""

import io
import json
import os
import struct
import subprocess
import sys
import time

import pytest
import torch

from spark_rapids_jni_tpu.obs import convert as jconvert
from spark_rapids_jni_tpu.obs import faultinj as jfaultinj
from spark_rapids_jni_tpu.obs import profiler as jprofiler
from spark_rapids_jni_tpu.obs import seam as jseam
from spark_rapids_jni_tpu.obs import trace as jtrace
from spark_rapids_jni_tpu import version as jversion
from spark_rapids_jni_tpu_torch import obs, ops, version
from spark_rapids_jni_tpu_torch.columnar import INT32, column
from spark_rapids_jni_tpu_torch.mem.exceptions import InjectedException
from spark_rapids_jni_tpu_torch.obs import convert, faultinj, flight, profiler, seam, trace
from spark_rapids_jni_tpu_torch.obs.timing import (
    device_sync,
    time_marginal,
    time_marginal_for_iters,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"port": (profiler, seam, faultinj), "jax": (jprofiler, jseam, jfaultinj)}


@pytest.fixture(autouse=True)
def _clean():
    flight.recorder().reset_for_tests()
    yield
    for prof, _, inj in PACKAGES.values():
        inj.FaultInjector.uninstall()
        prof.Profiler.shutdown()
    flight.recorder().reset_for_tests()


def _drive(pkg, buffer_bytes=256):
    """One fixed sequence of profiler traffic through ``pkg``'s profiler and
    seam; returns the capture's bytes."""
    prof, sm, _ = PACKAGES[pkg]
    sink = io.BytesIO()
    prof.Profiler.init(sink, buffer_bytes=buffer_bytes)
    prof.Profiler.start()
    for i in range(24):
        with sm.seam(sm.OP, f"op{i % 5}"):
            pass
    with sm.seam(sm.ALLOC, "reserve:dev:4096"):
        with sm.seam(sm.SPILL, "spill:4096B"):
            pass
    prof.Profiler.marker("checkpoint")
    prof.Profiler.counter("device_budget_used", 4096)
    prof.Profiler.state(3, 12, "detail-é", -5, t_ns=77, tid=9)
    prof.Profiler.stop()
    prof.Profiler.shutdown()
    return sink.getvalue()


def mask_capture(data: bytes) -> bytes:
    """The capture with every timestamp and thread id zeroed, and the clock
    anchor counter's value (a clock reading) too."""
    out = bytearray(data)
    assert bytes(out[:4]) == b"SRTP"
    pos = 8
    while pos < len(out):
        (blen,) = struct.unpack_from("<I", out, pos)
        pos += 4
        end = pos + blen
        names = {}
        while pos < end:
            kind = out[pos]
            pos += 1
            if kind == 0:
                nid, ln = struct.unpack_from("<IH", out, pos)
                names[nid] = bytes(out[pos + 6:pos + 6 + ln]).decode()
                pos += 6 + ln
            elif kind == 1:  # name, cat, t0, t1, tid
                struct.pack_into("<QQI", out, pos + 5, 0, 0, 0)
                pos += 25
            elif kind == 2:  # name, cat, t, tid
                struct.pack_into("<QI", out, pos + 5, 0, 0)
                pos += 17
            elif kind == 3:  # name, t, value, tid
                (nid,) = struct.unpack_from("<I", out, pos)
                struct.pack_into("<Q", out, pos + 4, 0)
                if names[nid] == profiler.CLOCK_ANCHOR:
                    struct.pack_into("<q", out, pos + 12, 0)
                struct.pack_into("<I", out, pos + 20, 0)
                pos += 24
            elif kind == 4:  # event kind, task, t, tid, detail, value
                struct.pack_into("<QI", out, pos + 9, 0, 0)
                pos += 33
            else:
                raise AssertionError(f"record kind {kind}")
    return bytes(out)


def test_capture_format_constants_match():
    assert (profiler.MAGIC, profiler.VERSION, profiler.CLOCK_ANCHOR) == \
        (jprofiler.MAGIC, jprofiler.VERSION, jprofiler.CLOCK_ANCHOR)
    assert profiler._CATEGORIES == jprofiler._CATEGORIES
    assert obs.Profiler is profiler.Profiler


@pytest.mark.parametrize("buffer_bytes", [64, 256, 1 << 16])
def test_srtp_bytes_equal_between_packages(buffer_bytes):
    port, jax_bytes = _drive("port", buffer_bytes), _drive("jax", buffer_bytes)
    assert len(port) == len(jax_bytes)
    assert mask_capture(port) == mask_capture(jax_bytes)
    # and a second port run gives the same masked bytes
    assert mask_capture(_drive("port", buffer_bytes)) == mask_capture(port)


def test_converters_agree_on_one_capture(tmp_path):
    data = _drive("port")
    events = list(convert.parse_capture(data))
    assert events == list(jconvert.parse_capture(data))
    assert convert.to_chrome(events) == jconvert.to_chrome(events)
    names = [e.get("name") for e in events]
    assert "op0" in names and "reserve:dev:4096" in names and "checkpoint" in names
    state = [e for e in events if e["type"] == "state"]
    assert state == [{"type": "state", "kind": flight.EVENT_KINDS[3], "task_id": 12,
                      "t_ns": 77, "tid": 9, "detail": "detail-é", "value": -5}]
    # mid-stream attach and a truncated final block, as in the JAX package
    assert list(convert.parse_capture(data[8:], midstream=True)) == events
    assert list(convert.parse_capture(data[:-3])) == list(jconvert.parse_capture(data[:-3]))
    with pytest.raises(ValueError):
        list(convert.parse_capture(data[:-3], strict=True))
    path = tmp_path / "c.srtp"
    path.write_bytes(data)
    for fmt in ("json", "chrome"):
        a, b = tmp_path / f"port.{fmt}", tmp_path / f"jax.{fmt}"
        assert convert.main([str(path), "--format", fmt, "-o", str(a)]) == 0
        assert jconvert.main([str(path), "--format", fmt, "-o", str(b)]) == 0
        assert a.read_text() == b.read_text()


def test_torch_profiler_cpu_export_merges(tmp_path):
    cap, dev_dir = tmp_path / "cap.srtp", tmp_path / "devtrace"
    profiler.Profiler.init(str(cap), device_trace_dir=str(dev_dir))
    profiler.Profiler.start()  # two start/stop windows: an export each
    col = column(list(range(4096)), INT32, device="cpu")
    ops.murmur_hash32([col], seed=42)
    profiler.Profiler.stop()
    profiler.Profiler.start()
    x = torch.randn(256, 256)
    with seam.seam(seam.OP, "matmul"):
        x @ x
    profiler.Profiler.stop()
    profiler.Profiler.shutdown()
    exports = sorted(os.listdir(dev_dir))
    assert len(exports) == 2 and all(e.endswith(".json") for e in exports)
    assert any(e.get("ph") == "X" for e in convert.load_device_trace(str(dev_dir)))

    out = tmp_path / "merged.json"
    assert convert.main([str(cap), "--format", "chrome", "--device-trace", str(dev_dir),
                         "-o", str(out)]) == 0
    merged = json.loads(out.read_text())["traceEvents"]
    host = {e["name"]: e for e in merged if e.get("pid", 0) < 1000 and e["ph"] == "X"}
    assert "murmur_hash32" in host and "matmul" in host
    devs = [e for e in merged if e.get("pid", 0) >= 1000 and e["ph"] == "X"]
    assert devs and any(e["ph"] == "M" and e.get("pid", 0) >= 1000 for e in merged)
    # the clock anchor puts each window's ops inside its host range (slack of
    # 2 ms for the profiler's approximate clock conversion): aten::mm in the
    # second window's matmul, the murmur hash's ops in the first's
    for name, op in (("matmul", "aten::mm"), ("murmur_hash32", None)):
        rng = host[name]
        inside = [e for e in devs if rng["ts"] - 2e3 <= e["ts"]
                  and e["ts"] + e["dur"] <= rng["ts"] + rng["dur"] + 2e3]
        assert inside and (op is None or any(e["name"] == op for e in inside)), name


def test_merge_fits_the_profiler_clock_rate_from_its_marks():
    """A window whose export holds the warm-up's and the closing mark's
    kernels (as on a card) is rescaled by the rate error they show: device
    events stamped by a clock running 3,000 ppm fast land back on the host's
    timeline; without the closing mark only the anchor places them."""
    rate = 3000e-6
    w_end, c_end = 1_000.0, 3_001_000.0  # host us: warm-up and closing range ends

    def stamped(t):  # the profiler clock, fast by `rate` after the warm-up
        return t + rate * (t - w_end)

    def kernel(name, start, end):
        return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
                "ts": stamped(start), "dur": stamped(end) - stamped(start)}

    dev = [kernel("warm", 500.0, 980.0), kernel("work", 2_000_000.0, 2_900_000.0),
           kernel("mark", 3_000_900.0, 3_000_980.0)]
    ranges = [("profiler:warmup", 0.0, w_end), ("call:work", 1_500.0, 2_950_000.0),
              ("profiler:closing", 3_000_800.0, c_end)]
    host = [{"name": n, "ph": "X", "ts": a, "dur": b - a, "pid": 0, "tid": 1}
            for n, a, b in ranges]
    merged = convert.merge_device_events({"traceEvents": [dict(h) for h in host]}, dev, 0)
    assert merged["deviceClockRates"] == [pytest.approx(rate)]
    got = {e["name"]: e for e in merged["traceEvents"] if e.get("pid", 0) >= 1000}
    assert got["work"]["ts"] == pytest.approx(2_000_000.0, abs=1.0)
    assert got["work"]["ts"] + got["work"]["dur"] == pytest.approx(2_900_000.0, abs=1.0)
    assert got["mark"]["ts"] + got["mark"]["dur"] == pytest.approx(3_000_980.0, abs=1.0)
    # no closing mark in the host trace: the anchor alone places the events
    plain = convert.merge_device_events(
        {"traceEvents": [dict(h) for h in host if h["name"] != "profiler:closing"]}, dev, 0)
    assert "deviceClockRates" not in plain
    work = next(e for e in plain["traceEvents"] if e.get("name") == "work" and e["pid"] >= 1000)
    assert work["ts"] == pytest.approx(stamped(2_000_000.0))


def _decisions(pkg, config, crossings, monkeypatch):
    """Install ``config`` into ``pkg``'s injector and cross each (category,
    name); returns per crossing "ok", the exception's type name, or the
    stall it asked for (``time.sleep`` is recorded, not slept)."""
    _, sm, inj = PACKAGES[pkg]
    stalls = []
    monkeypatch.setattr(inj.time, "sleep", stalls.append)
    inj.FaultInjector.install(config)
    out = []
    try:
        for cat, name in crossings:
            before = len(stalls)
            try:
                with sm.seam(cat, name):
                    pass
                out.append(("stall", stalls[-1]) if len(stalls) > before else "ok")
            except MemoryError as e:
                out.append(type(e).__name__)
            except RuntimeError as e:
                out.append(type(e).__name__)
    finally:
        inj.FaultInjector.uninstall()
    return out


CROSSINGS = ([("op", f"murmur_hash32")] * 40 + [("op", "xxhash64")] * 20
             + [("alloc", f"reserve:dev:{i}") for i in range(40)]
             + [("serve", f"handle:q{i % 3}") for i in range(40)])


@pytest.mark.parametrize("seed", [1234, 7])
def test_injector_decisions_equal_between_packages_and_runs(seed, monkeypatch):
    config = {
        "seed": seed,
        "op": {"murmur_hash32": {"injectionType": "exception", "percent": 50},
               "xx*": {"injectionType": "slow", "percent": 40, "durationMs": 15.0},
               "*": {"injectionType": "retry_oom", "interceptionCount": 1}},
        **{k: v for k, v in faultinj.pressure_storm_config(seed).items() if k != "seed"},
    }
    a = _decisions("port", config, CROSSINGS, monkeypatch)
    b = _decisions("port", config, CROSSINGS, monkeypatch)
    c = _decisions("jax", config, CROSSINGS, monkeypatch)
    assert a == b == c
    kinds = set(x if isinstance(x, str) else x[0] for x in a)
    assert {"ok", "InjectedException", "stall", "GpuRetryOOM", "GpuSplitAndRetryOOM"} <= kinds
    assert ("stall", 0.015) in a


def test_profiles_equal_between_packages():
    for seed in (0, 9):
        assert faultinj.pressure_storm_config(seed) == jfaultinj.pressure_storm_config(seed)
        assert faultinj.chaos_kill_config(seed) == jfaultinj.chaos_kill_config(seed)
        assert faultinj.chaos_shuffle_config(seed) == jfaultinj.chaos_shuffle_config(seed)


def test_injector_through_instrumented_ops():
    faultinj.FaultInjector.install({
        "op": {"murmur_hash32": {"injectionType": "exception", "interceptionCount": 2}}})
    col = column([1, 2], INT32, device="cpu")
    for _ in range(2):
        with pytest.raises(InjectedException, match="murmur_hash32"):
            ops.murmur_hash32([col], seed=42)
    assert ops.murmur_hash32([col], seed=42).to_list() is not None
    assert ops.xxhash64([col]).to_list() is not None
    with pytest.raises(RuntimeError, match="already installed"):
        faultinj.FaultInjector.install({})


def test_transport_fault_consult(monkeypatch):
    assert faultinj.transport_fault("frame:1") is None
    faultinj.FaultInjector.install(faultinj.chaos_shuffle_config(3, kill=False))
    seen = [faultinj.transport_fault(f"frame:{i}") for i in range(60)]
    assert any(v is not None and v[0] == "frame_corrupt" for v in seen)


def test_hot_reload(tmp_path):
    cfg = tmp_path / "faults.json"
    cfg.write_text(json.dumps({"dynamic": True, "op": {}}))
    faultinj.FaultInjector.install(str(cfg))
    col = column([1], INT32, device="cpu")
    ops.murmur_hash32([col], seed=0)
    cfg.write_text(json.dumps({"dynamic": True,
                               "op": {"murmur_hash32": {"injectionType": "exception"}}}))
    os.utime(cfg, (time.time() + 2, time.time() + 2))
    deadline, fired = time.time() + 5, False
    while time.time() < deadline and not fired:
        try:
            ops.murmur_hash32([col], seed=0)
            time.sleep(0.05)
        except InjectedException:
            fired = True
    assert fired


def test_profiler_hooks_fire_once_bound():
    import importlib

    from spark_rapids_jni_tpu_torch.mem import BudgetedResource, MemoryGovernor, reservation

    gjo = importlib.import_module("spark_rapids_jni_tpu_torch.ops.get_json_object")
    sink = io.BytesIO()
    gov = MemoryGovernor(watchdog_period_s=0.02)
    try:
        budget = BudgetedResource(gov, 1 << 20)
        profiler.Profiler.init(sink)
        profiler.Profiler.start()
        with reservation(budget, 4096):
            pass
        flight.record(flight.EV_TASK_ADMITTED, 5, detail="dedicated")
        gjo._note_truncation(3)
        profiler.Profiler.stop()
        profiler.Profiler.shutdown()
    finally:
        gov.close()
    events = list(convert.parse_capture(sink.getvalue()))
    counters = [(e["name"], e["value"]) for e in events if e["type"] == "counter"]
    assert ("device_budget_used", 4096) in counters and ("device_budget_used", 0) in counters
    assert any(n == "json.step_cap_truncated" and v >= 3 for n, v in counters)
    states = [e for e in events if e["type"] == "state"]
    assert any(e["kind"] == flight.EV_TASK_ADMITTED and e["task_id"] == 5 for e in states)
    ranges = {e["name"]: e["category"] for e in events if e["type"] == "range"}
    assert ranges["reserve:dev:4096"] == "alloc"
    assert ranges["json:step_cap_truncated:3"] == "op"


def _import_ops_with(env_path, tmp_path):
    code = ("import warnings\nwarnings.simplefilter('always')\n"
            "import spark_rapids_jni_tpu_torch.ops as o\n"
            "from spark_rapids_jni_tpu_torch.obs.faultinj import FaultInjector\n"
            "from spark_rapids_jni_tpu_torch.columnar import INT32, column\n"
            "print('armed', FaultInjector._instance is not None)\n"
            "try:\n"
            "    o.xxhash64([column([1], INT32, device='cpu')])\n"
            "    print('ran')\n"
            "except Exception as e:\n"
            "    print('raised', type(e).__name__)\n")
    env = {**os.environ, faultinj.ENV_CONFIG_PATH: str(env_path)}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO, env=env)


def test_install_from_env_at_import(tmp_path):
    cfg = tmp_path / "env_faults.json"
    cfg.write_text(json.dumps({"op": {"xxhash64": {"injectionType": "exception"}}}))
    good = _import_ops_with(cfg, tmp_path)
    assert good.returncode == 0, good.stderr
    assert good.stdout.split() == ["armed", "True", "raised", "InjectedException"]
    bad_cfg = tmp_path / "bad.json"
    bad_cfg.write_text("{not json")
    bad = _import_ops_with(bad_cfg, tmp_path)
    assert bad.returncode == 0, bad.stderr
    assert bad.stdout.split() == ["armed", "False", "ran"]
    assert "fault injector config (SRT_FAULT_INJECTOR_CONFIG_PATH) ignored" in bad.stderr


def test_time_marginal_on_a_cpu_function():
    x = torch.arange(4096, dtype=torch.float32)
    dt, info = time_marginal(lambda: x + 1.0, 2, 6)
    assert dt > 0 and info["iters"] == [2, 6]
    assert info["method"] in ("marginal", "amortized-fallback")
    calls = []
    dt, info = time_marginal_for_iters(lambda: calls.append(1), 2)
    assert dt > 0 and len(calls) <= 5
    device_sync({"a": [x, (column([1, None], INT32, device="cpu"), 3.5)], "b": None})


def test_time_marginal_fallback_is_amortized(monkeypatch):
    import itertools

    from spark_rapids_jni_tpu_torch.obs import timing

    seq = itertools.cycle([0.0, 10.0, 10.0, 10.0])
    monkeypatch.setattr(timing.time, "perf_counter", lambda: next(seq))
    dt, info = time_marginal(lambda: 1, 2, 4, sync=lambda _out: None)
    assert info["method"] == "amortized-fallback"
    assert dt == info["amortized_s_per_call"]


def test_spans_match_jax_grammar():
    ctx = trace.new_root(9)
    h = trace.open_span(ctx, trace.SPAN_QUEUE, task_id=9, extra="handler:q97")
    trace.close_span(h)
    trace.close_span(h)  # idempotent
    with trace.span(ctx, trace.SPAN_COMPUTE) as inner:
        assert trace.current() is inner
        with trace.maybe_span(trace.SPAN_TRANSPORT) as t:
            assert t.rid == 9 and t.parent == inner.span
    assert trace.current() is None
    evs = flight.snapshot()
    assert [e["kind"] for e in evs] == ["span_open", "span_close", "span_open", "span_open",
                                         "span_close", "span_close"]
    assert jtrace._detail(h.ctx, h.kind, h.extra) == trace._detail(h.ctx, h.kind, h.extra)
    falls = trace.waterfall(evs)
    assert falls == jtrace.waterfall(evs)
    assert falls["9"]["complete"]
    assert trace.format_waterfall(falls["9"]) == jtrace.format_waterfall(falls["9"])
    assert trace.from_wire(trace.to_wire(ctx)).span == ctx.span
    assert trace.from_wire(("a", "b", "c")) is None and trace.open_span(None, "queue") is None
    assert trace.SPAN_KINDS == jtrace.SPAN_KINDS


def test_version_matches_jax():
    assert version.VERSION == jversion.VERSION == version.__version__
    assert version.build_info() == jversion.build_info()
