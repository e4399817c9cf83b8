"""The port's trace utilities on the CPU: its own copy of the latency
histogram against the reference's (same edges, percentiles, wire shape
and Prometheus lines on the same samples), the interval union the
decode profile uses for device busy time, the card-only measuring
scripts refusing a machine without a card, and the int8 matmul sweep's
shapes and bound (the int8 training path's projections). Then the
store-backed halves of the pool hooks against the reference's on the
same JSONL and calls: goodput events and spans emitted, queried, pruned
and ingested (the same rows but their random row keys), one trace
exported to Chrome trace JSON, the trace context's constructors, the
progress beat and the preempt-request helpers."""

import json
import os
import pathlib
import threading
import time

import numpy as np
import pytest

from batch_shipyard_tpu.agent import preemption as ref_preemption
from batch_shipyard_tpu.agent import progress as ref_progress
from batch_shipyard_tpu.goodput import events as ref_events
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu.trace import context as ref_context
from batch_shipyard_tpu.trace import export as ref_export
from batch_shipyard_tpu.trace import histogram as jhist
from batch_shipyard_tpu.trace import spans as ref_spans
from batch_shipyard_tpu_torch.agent import preemption
from batch_shipyard_tpu_torch.agent import progress
from batch_shipyard_tpu_torch.goodput import events
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
from batch_shipyard_tpu_torch.trace import context
from batch_shipyard_tpu_torch.trace import export
from batch_shipyard_tpu_torch.trace import spans
from batch_shipyard_tpu_torch.trace import (decode_sweep, int8_matmul_sweep,
                                            profiler_window, serve_compare)
from batch_shipyard_tpu_torch.trace import histogram as thist
from batch_shipyard_tpu_torch.trace.decode_profile import (
    PROFILER_WARMUP_STEPS, WINDOW, busy_us, window_kernels)


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_matches_reference(seed):
    samples = list(np.random.RandomState(seed).lognormal(3.0, 1.5, 500))
    mine = thist.LatencyHistogram.of(samples)
    want = jhist.LatencyHistogram.of(samples)
    assert mine.to_dict() == want.to_dict()
    assert mine.percentiles((50, 90, 99)) == want.percentiles((50, 90, 99))
    assert mine.prometheus_bucket_lines("x") == \
        want.prometheus_bucket_lines("x")
    # Reports of the two packages merge: the wire shape round-trips.
    back = thist.LatencyHistogram.from_dict(want.to_dict())
    assert back.merge(mine).to_dict() == \
        jhist.LatencyHistogram.merged([want, want]).to_dict()


def test_busy_us_is_the_union_of_intervals():
    assert busy_us([]) == 0.0
    assert busy_us([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0),
                    (5.5, 5.7)]) == pytest.approx(4.0)
    assert busy_us([(4.0, 5.0), (0.0, 1.0)]) == pytest.approx(2.0)


def test_window_kernels_leave_out_the_profilers_warmup():
    """The profile readings count the device kernels that start inside
    the host's window range, not the warm-up steps' kernels before it
    nor the range's own device annotation."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(name, device, start):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start,
                                                          end=start + 1))

    events = [event("warmup_kernel", DeviceType.CUDA, 1.0),
              event(WINDOW, DeviceType.CPU, 10.0),
              event(WINDOW, DeviceType.CUDA, 10.5),
              event("aten::mm", DeviceType.CPU, 11.0),
              event("kernel_a", DeviceType.CUDA, 12.0),
              event("kernel_b", DeviceType.CUDA, 10.0)]
    assert [e.name for e in window_kernels(events)] == ["kernel_a",
                                                       "kernel_b"]
    assert PROFILER_WARMUP_STEPS >= 1


@pytest.mark.parametrize("script, argv", [
    (decode_sweep, []), (decode_sweep, ["--dense-variant", "2x128"]),
    (int8_matmul_sweep, []), (profiler_window, []), (serve_compare, ["."]),
    (serve_compare, ["--phase", "train_int8", "."])])
def test_card_only_scripts_refuse_without_cuda(monkeypatch, capsys,
                                               script, argv):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert script.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_int8_matmul_sweep_shapes_are_a_layers_projections():
    """One layer's seven QuantDense projections of bench_transformer at
    its 32768 rows, and the least time of the qkvo shape: the fp32
    output's bytes at 3.35 TB/s (0.0504 ms), above its int8 operations
    at 1979 TOP/s (0.0347 ms)."""
    shapes = int8_matmul_sweep.SHAPES
    assert sum(count for _, count in shapes.values()) == 7
    assert int8_matmul_sweep.ROWS == 32768
    assert shapes["qkvo"] == ((1024, 1024), 4)
    assert shapes["down"] == ((2816, 1024), 1)
    assert int8_matmul_sweep.bound_ms(1024, 1024) == pytest.approx(
        0.050434598, rel=1e-6)


class _Range:
    def __init__(self, start):
        self.start, self.end = start, start + 1.0


class _Event:
    def __init__(self, name, start):
        self.name, self.time_range = name, _Range(start)


def test_train_profile_op_times_are_the_windows_ops():
    """op_us sums each host op's self device time inside the window, and
    leaves out the window itself, the events before it and the runtime's
    markers."""
    from torch.autograd import DeviceType

    from batch_shipyard_tpu_torch.trace import train_profile

    def event(name, start, us, device=DeviceType.CPU):
        e = _Event(name, start)
        e.device_type, e.self_device_time_total = device, us
        return e
    events = [event("aten::bmm", 0.0, 5.0),
              event(train_profile.WINDOW, 1.0, 0.0),
              event("aten::bmm", 2.0, 3.0), event("aten::bmm", 3.0, 4.0),
              event("aten::mm", 4.0, 2.0), event("aten::cat", 5.0, 0.0),
              event("Command Buffer Full", 6.0, 99.0),
              event("kernel", 7.0, 0.0, DeviceType.CUDA)]
    assert train_profile.op_us(events) == {"aten::bmm": 7.0, "aten::mm": 2.0}
    assert train_profile.op_us(events[:1]) == {}


@pytest.mark.parametrize("short_windows", [0, 1, 2, 3])
def test_train_profile_retakes_a_window_short_of_ring_kernels(
        monkeypatch, short_windows):
    """profile_steps retakes a window whose ring kernels fall short of
    the wrappers' launches (the profiler dropped some), up to
    PROFILE_ATTEMPTS windows; past them ring_us_by_axis refuses it."""
    import contextlib

    import torch

    from batch_shipyard_tpu_torch.ops import ring_collectives
    from batch_shipyard_tpu_torch.trace import train_profile
    symbol = train_profile.KERNEL_SYMBOLS["ring_permute"][0]
    windows = []

    class Group:
        axis = "sp"

        def wait_ns(self):
            return 0

    class Mesh:
        def distinct_groups(self):
            return [Group()]

        def check(self):
            pass

    class Harness:
        mesh = Mesh()

        def step(self, batch):
            if ring_collectives.copy_log is not None:
                ring_collectives.copy_log += [("ring_permute", "sp")] * 2

    def kernels(events):
        windows.append(None)
        n = 3 if len(windows) <= short_windows else 4
        return [_Event(f"{symbol}<float>", float(i)) for i in range(n)]
    monkeypatch.setattr(train_profile, "profile",
                        lambda **kw: contextlib.nullcontext(
                            type("P", (), {"events": lambda self: []})()))
    monkeypatch.setattr(train_profile, "record_function",
                        lambda name: contextlib.nullcontext())
    monkeypatch.setattr(train_profile, "window_kernels", kernels)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    if short_windows >= train_profile.PROFILE_ATTEMPTS:
        with pytest.raises(RuntimeError, match="profiler saw 3 ring"):
            train_profile.profile_steps(Harness(), {}, 2)
    else:
        out = train_profile.profile_steps(Harness(), {}, 2)
        assert out["ring_kernel_calls_per_step"]["ring_permute"] == 2
        assert out["ring_ms_per_step_by_axis"] == {"sp": 4 / 1e3 / 2}
    assert len(windows) == min(short_windows + 1,
                               train_profile.PROFILE_ATTEMPTS)


# ------------------- the store halves of the pool hooks ------------------

NOW = time.time()
GOODPUT_LINES = [
    {"kind": "compile", "start": NOW - 9.0, "end": NOW - 8.0,
     "attrs": {"what": "warmup", "cache_hit": True, "saved_seconds": 2.5},
     "trace_id": "a" * 16, "span_id": "b" * 8},
    {"kind": "step_window", "start": NOW - 8.0, "end": NOW - 2.0,
     "attrs": {"step_start": 0, "step_end": 5, "tokens": 640},
     "trace_id": "a" * 16, "span_id": "b" * 8},
    {"kind": "checkpoint_save", "start": NOW - 2.0, "end": NOW - 1.0,
     "attrs": {}},
    {"kind": "not_a_kind", "start": NOW, "end": NOW, "attrs": {}},
    {"kind": "compile", "start": "junk", "attrs": {}},
]
SPAN_LINES = [
    {"kind": "compile", "trace_id": "a" * 16, "span_id": "c" * 8,
     "parent_span_id": "b" * 8, "start": NOW - 9.0, "end": NOW - 8.0,
     "attrs": {"what": "aot_precompile", "label": "train_step_aot"}},
    {"kind": "train_step_window", "trace_id": "a" * 16,
     "span_id": "d" * 8, "parent_span_id": "b" * 8, "start": NOW - 8.0,
     "end": NOW - 2.0, "attrs": {}},
    {"kind": "serve_request", "trace_id": "a" * 16, "span_id": "e" * 8,
     "parent_span_id": "zz", "start": NOW - 1.5, "end": NOW - 1.0,
     "attrs": {"request_id": "r1"}},
    {"kind": "compile", "trace_id": "", "span_id": "f" * 8, "start": 1.0},
    {"kind": "nope", "trace_id": "a" * 16, "span_id": "9" * 8,
     "start": 1.0},
]


def _write(path, lines):
    with open(path, "w", encoding="utf-8") as fh:
        for line in lines:
            fh.write(json.dumps(line) + "\n")
        fh.write("not json\n\n")


def _rows(rows):
    """Rows without their random keys (row key, etag)."""
    return [{k: v for k, v in row.items() if k not in ("_rk", "_etag")}
            for row in rows]


def _ingested(tmp_path, who):
    """A store of ``who``'s ("port" or "ref") package after ingesting the
    same two files and emitting the same store-side events and spans."""
    ev, sp, st = ((events, spans, MemoryStateStore()) if who == "port"
                  else (ref_events, ref_spans, RefStore()))
    ctx_mod = context if who == "port" else ref_context
    gfile, sfile = tmp_path / f"{who}_g.jsonl", tmp_path / f"{who}_s.jsonl"
    _write(gfile, GOODPUT_LINES)
    _write(sfile, SPAN_LINES)
    counts = (ev.ingest_local_events(st, "pool1", str(gfile), job_id="j1",
                                     task_id="t0", node_id="n0"),
              sp.ingest_local_spans(st, "pool1", str(sfile), job_id="j1",
                                    task_id="t0", node_id="n0"))
    assert not gfile.exists() and not sfile.exists()
    root = ctx_mod.TraceContext("a" * 16, "b" * 8)
    ev.emit(st, "pool1", "queued", job_id="j1", task_id="t0",
            start=NOW - 20.0, end=NOW - 10.0, trace_id="a" * 16,
            span_id="b" * 8)
    ev.emit(st, "pool1", "bogus_kind", start=NOW)
    ev.emit(st, "pool1", "idle", node_id="n0", start=NOW - 3600.0,
            end=NOW - 3000.0)
    sp.emit(st, "pool1", "task_run", root, job_id="j1", task_id="t0",
            node_id="n0", start=NOW - 10.0, end=NOW, self_span=True)
    sp.emit(st, "pool1", "task_run", None)
    return st, counts, ev, sp


def test_store_hooks_give_the_references_rows(tmp_path):
    port, port_counts, _, _ = _ingested(tmp_path, "port")
    ref, ref_counts, _, _ = _ingested(tmp_path, "ref")
    assert port_counts == ref_counts == (3, 3)
    for kwargs in ({}, {"job_id": "j1"}, {"trace_id": "a" * 16},
                   {"task_id": "t0"}):
        assert _rows(events.query(port, "pool1", **kwargs)) == \
            _rows(ref_events.query(ref, "pool1", **kwargs))
    for kwargs in ({}, {"trace_id": "a" * 16}, {"job_id": "j1"}):
        assert _rows(spans.query(port, "pool1", **kwargs)) == \
            _rows(ref_spans.query(ref, "pool1", **kwargs))
    # The Chrome trace of one trace, and its parent-link check.
    rows = export.trace_rows(port, "pool1", "a" * 16)
    ref_rows = ref_export.trace_rows(ref, "pool1", "a" * 16)
    chrome = export.to_chrome_trace(rows, "a" * 16)
    assert chrome == ref_export.to_chrome_trace(rows, "a" * 16)
    assert chrome == ref_export.to_chrome_trace(ref_rows, "a" * 16)
    assert export.export_trace(port, "pool1", "a" * 16) == chrome
    assert export.validate_parent_links(chrome) == \
        ref_export.validate_parent_links(chrome)
    assert any("zz" in p for p in export.validate_parent_links(chrome))
    assert export.render_tree(rows) == ref_export.render_tree(rows)
    out = tmp_path / "trace.json"
    assert json.loads(pathlib.Path(export.write_chrome_trace(
        chrome, str(out))).read_text()) == chrome
    # Retention: the same rows go.
    assert events.prune(port, "pool1", 1800.0) == \
        ref_events.prune(ref, "pool1", 1800.0) == 1
    assert spans.prune(port, "pool1", 5.0) == \
        ref_spans.prune(ref, "pool1", 5.0)
    assert _rows(events.query(port, "pool1")) == \
        _rows(ref_events.query(ref, "pool1"))
    assert _rows(spans.query(port, "pool1")) == \
        _rows(ref_spans.query(ref, "pool1"))


def test_store_spans_and_events_time_a_block():
    store, ref = MemoryStateStore(), RefStore()
    ctx = context.TraceContext.new()
    for ev, sp, st, c in ((events, spans, store, ctx),
                          (ref_events, ref_spans, ref,
                           ref_context.TraceContext(ctx.trace_id,
                                                    ctx.span_id))):
        with ev.span(st, "pool1", "image_pull", job_id="j",
                     trace_id=c.trace_id) as attrs:
            attrs["bytes"] = 7
        with sp.span(st, "pool1", "image_pull", c, job_id="j") as attrs:
            attrs["bytes"] = 7
    got = _rows(events.query(store, "pool1"))
    want = _rows(ref_events.query(ref, "pool1"))
    assert [r["attrs"] for r in got] == [r["attrs"] for r in want] == [
        {"bytes": 7}]
    assert [(r["kind"], r["trace_id"]) for r in got] == \
        [(r["kind"], r["trace_id"]) for r in want]
    got = spans.query(store, "pool1")
    want = ref_spans.query(ref, "pool1")
    assert [(r["parent_span_id"], r["attrs"]) for r in got] == \
        [(r["parent_span_id"], r["attrs"]) for r in want] == \
        [(ctx.span_id, {"bytes": 7})]


def test_trace_context_constructors_are_the_references():
    ctx = context.TraceContext.new()
    assert len(ctx.trace_id) == 16 and len(ctx.span_id) == 8
    assert ctx.parent_span_id is None
    child = ctx.child()
    assert (child.trace_id, child.parent_span_id) == (ctx.trace_id,
                                                      ctx.span_id)
    assert child.span_id != ctx.span_id
    assert len(context.new_trace_id()) == len(ref_context.new_trace_id())
    for entity in ({"trace_id": "t1", "trace_span_id": "s1",
                    "trace_parent_span_id": "p1"},
                   {"trace_id": "t1", "trace_span_id": "s1"},
                   {"trace_id": "t1"}, {}):
        got = context.TraceContext.from_entity(entity)
        want = ref_context.TraceContext.from_entity(entity)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.trace_id, got.span_id, got.parent_span_id) == \
                (want.trace_id, want.span_id, want.parent_span_id)


def test_iso_to_epoch_is_the_references():
    for value in ("2026-10-18T14:15:24.123456Z", "2026-10-18T14:15:24Z",
                  "2026-10-18T14:15:24+02:00", "junk", "", None):
        assert events.iso_to_epoch(value) == ref_events.iso_to_epoch(value)


def test_last_beat_and_preempt_helpers_are_the_references(monkeypatch,
                                                          tmp_path):
    beat = tmp_path / "beat"
    assert progress.last_beat(str(beat)) is None is \
        ref_progress.last_beat(str(beat))
    progress.seed(str(beat))
    os.utime(beat, (1000.0, 1234.5))
    assert progress.last_beat(str(beat)) == \
        ref_progress.last_beat(str(beat)) == 1234.5
    request = tmp_path / "preempt.json"
    monkeypatch.delenv(preemption.PREEMPT_REQUEST_FILE_ENV, raising=False)
    assert preemption.preempt_requested() is False is \
        ref_preemption.preempt_requested()
    monkeypatch.setenv(preemption.PREEMPT_REQUEST_FILE_ENV, str(request))
    assert preemption.preempt_requested() is False is \
        ref_preemption.preempt_requested()
    assert preemption.wait_for_request(str(request), 0.1) is None is \
        ref_preemption.wait_for_request(str(request), 0.1)
    timer = threading.Timer(0.2, preemption.write_request,
                            (str(request), "drill"))
    timer.start()
    got = preemption.wait_for_request(str(request), 5.0)
    timer.join()
    assert got["reason"] == "drill"
    assert got == ref_preemption.wait_for_request(str(request), 1.0)
    assert preemption.preempt_requested() is True is \
        ref_preemption.preempt_requested()
