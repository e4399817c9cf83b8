"""The port's goodput accounting (batch_shipyard_tpu_torch.goodput.
accounting) against the reference's: every report function on the event
lists of tests/test_goodput.py's scenarios, on the same events emitted
into each package's store, and on the events a port task and the port's
workload write, with equal results (floats within 1e-9 relative)."""

import json
import math
import shutil
import time

import pytest

from batch_shipyard_tpu.goodput import accounting as ref
from batch_shipyard_tpu.goodput import events as ref_events
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu_torch.config import settings
from batch_shipyard_tpu_torch.goodput import accounting as port
from batch_shipyard_tpu_torch.goodput import events as gp
from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
from batch_shipyard_tpu_torch.pool import manager as pool_mgr
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore

REL = 1e-9


def _ev(kind, start, end, job_id="j1", task_id="t1", node_id="n1",
        **attrs):
    return {"kind": kind, "start": float(start), "end": float(end),
            "job_id": job_id, "task_id": task_id, "node_id": node_id,
            "attrs": attrs}


def _same(got, want, path="$"):
    """Equal structure and values, floats within REL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _same(got[key], want[key], f"{path}.{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=REL, abs_tol=1e-12), (
            path, got, want)
    else:
        assert got == want, (path, got, want)


# tests/test_goodput.py's timelines, by name.
SCENARIOS = {
    "preemption_downtime": [
        _ev(gp.NODE_PREEMPTED, 10.0, 10.0, preempted_nodes=2),
        _ev(gp.NODE_PREEMPTED, 10.0, 70.0, recovered=True, nodes=2),
        _ev(gp.NODE_IDLE, 70.0, 100.0, node_id="n1")],
    "partition_wall": [
        _ev(gp.TASK_QUEUED, 0.0, 10.0),
        _ev(gp.TASK_RUNNING, 10.0, 100.0),
        _ev(gp.TASK_IMAGE_PULL, 10.0, 14.0),
        _ev(gp.PROGRAM_COMPILE, 14.0, 24.0),
        _ev(gp.PROGRAM_STEP_WINDOW, 24.0, 84.0, step_start=0,
            step_end=60, tokens=6000),
        _ev(gp.PROGRAM_CHECKPOINT_SAVE, 84.0, 90.0, step=60)],
    "backoff": [
        _ev(gp.TASK_RUNNING, 0.0, 10.0),
        _ev(gp.TASK_QUEUED, 10.0, 30.0),
        _ev(gp.TASK_BACKOFF, 10.0, 18.0, retries=1, delay_seconds=8.0),
        _ev(gp.TASK_RUNNING, 30.0, 90.0),
        _ev(gp.PROGRAM_STEP_WINDOW, 30.0, 90.0, step_start=0,
            step_end=60)],
    "cross_task_queue": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 100.0, task_id="t1",
            step_start=0, step_end=100),
        _ev(gp.TASK_QUEUED, 0.0, 110.0, task_id="t2")],
    "checkpoint_in_window": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 100.0),
        _ev(gp.PROGRAM_CHECKPOINT_SAVE, 40.0, 50.0)],
    "preemption_replay": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 100.0, step_start=0,
            step_end=100),
        _ev(gp.PROGRAM_CHECKPOINT_SAVE, 100.0, 104.0, step=80),
        _ev(gp.PROGRAM_CHECKPOINT_RESTORE, 110.0, 112.0, step=80),
        _ev(gp.PROGRAM_STEP_WINDOW, 112.0, 132.0, step_start=80,
            step_end=100),
        _ev(gp.PROGRAM_STEP_WINDOW, 132.0, 152.0, step_start=100,
            step_end=120)],
    "partial_replay": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 100.0, step_start=0,
            step_end=100),
        _ev(gp.PROGRAM_CHECKPOINT_SAVE, 100.0, 104.0, step=80),
        _ev(gp.PROGRAM_CHECKPOINT_RESTORE, 110.0, 112.0, step=80),
        _ev(gp.PROGRAM_STEP_WINDOW, 112.0, 152.0, step_start=80,
            step_end=120)],
    "replayed_totals": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 10.0, step_start=0, step_end=10),
        _ev(gp.PROGRAM_STEP_WINDOW, 10.0, 20.0, step_start=0,
            step_end=10)],
    "async_checkpoint": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 100.0),
        _ev(gp.PROGRAM_CHECKPOINT_SAVE, 40.0, 42.0, step=50,
            mode="snapshot"),
        _ev(gp.PROGRAM_CHECKPOINT_ASYNC, 42.0, 110.0, step=50)],
    "retry": [_ev(gp.TASK_RETRY, 5.0, 5.0, retries=1)],
    "empty": [],
    "gang_windows": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 50.0, task_id="t1",
            node_id=f"n{i}", step_start=0, step_end=50)
        for i in range(8)],
    "gang_then_replay": [
        *(_ev(gp.PROGRAM_STEP_WINDOW, 0.0, 50.0, task_id="t1",
              node_id=f"n{i}", step_start=0, step_end=50, tokens=500)
          for i in range(8)),
        _ev(gp.PROGRAM_STEP_WINDOW, 60.0, 80.0, task_id="t1",
            step_start=0, step_end=50)],
    "rework_per_job": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 50.0, job_id="jA", step_start=0,
            step_end=50),
        _ev(gp.PROGRAM_STEP_WINDOW, 60.0, 110.0, job_id="jB",
            step_start=0, step_end=50)],
    "waterfall": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 60.0),
        _ev(gp.PROGRAM_COMPILE, 60.0, 100.0)],
    "idle_nodes": [
        _ev(gp.PROGRAM_STEP_WINDOW, 0.0, 100.0, node_id="n0"),
        *(_ev(gp.NODE_IDLE, 0.0, 100.0, job_id=None, task_id=None,
              node_id=f"n{i}") for i in range(1, 8))],
    "junk_attrs": [
        _ev(gp.PROGRAM_STEP_WINDOW, 1.0, 2.0),
        _ev(gp.PROGRAM_STEP_WINDOW, 3.0, 4.0, step_start="a",
            step_end="b"),
        _ev(gp.PROGRAM_STEP_WINDOW, 5.0, 6.0, step_start=0, step_end=5)],
    "control_plane": [
        _ev(gp.STORE_OUTAGE, 0.0, 5.0, job_id=None),
        _ev(gp.TASK_ADOPTION, 5.0, 7.0),
        _ev(gp.TASK_EXPANSION, 7.0, 8.0),
        _ev(gp.GANG_MIGRATE, 8.0, 12.0),
        _ev(gp.TASK_PREEMPT_RECOVERY, 12.0, 15.0),
        _ev(gp.TASK_EVICTION_RECOVERY, 15.0, 17.0),
        _ev(gp.SERVE_RECOVERY, 17.0, 18.0),
        _ev(gp.PROGRAM_WARMUP, 18.0, 20.0),
        _ev(gp.PROGRAM_EVAL, 20.0, 21.0),
        _ev(gp.TASK_CONTAINER_START, 21.0, 22.0),
        _ev(gp.PROGRAM_COMPILE, 22.0, 24.0, cache_hit=True,
            saved_seconds=3.5),
        _ev(gp.PROGRAM_STEP_WINDOW, 24.0, 30.0, step_start=0,
            step_end=6, tokens=600)],
}
_NAMES = sorted(SCENARIOS)


def test_constants_are_the_references():
    assert port.BADPUT_CATEGORIES == ref.BADPUT_CATEGORIES
    assert port.OVERLAPPED_CATEGORIES == ref.OVERLAPPED_CATEGORIES
    assert port.PRODUCTIVE == ref.PRODUCTIVE
    assert gp.EVENT_KINDS == ref_events.EVENT_KINDS


@pytest.mark.parametrize("name", _NAMES)
def test_decompose_and_renderings_equal_the_references(name):
    events = SCENARIOS[name]
    got, want = port.decompose(events), ref.decompose(events)
    _same(got, want)
    _same(port.decompose(events, wall=(0.0, 200.0)),
          ref.decompose(events, wall=(0.0, 200.0)))
    assert port.waterfall_table(got) == ref.waterfall_table(want)
    labels = {"pool": "p1", "job": name}
    assert port.prometheus_lines(got, labels) == ref.prometheus_lines(
        want, labels)
    total = (got["productive_seconds"] + sum(got["badput_seconds"].values())
             + sum(got["overlapped_seconds"].values()))
    assert total == pytest.approx(got["wall_seconds"])


@pytest.mark.parametrize("name", _NAMES)
def test_decompose_by_node_equals_the_references(name):
    events = SCENARIOS[name]
    _same(port.decompose_by_node(events), ref.decompose_by_node(events))
    _same(port.decompose_by_node(events, left_cutoff=20.0),
          ref.decompose_by_node(events, left_cutoff=20.0))


@pytest.mark.parametrize("base,cand", list(zip(_NAMES, _NAMES[1:])))
def test_report_delta_equals_the_references(base, cand):
    reports = {name: (port.decompose(SCENARIOS[name]),
                      ref.decompose(SCENARIOS[name]))
               for name in (base, cand)}
    _same(port.report_delta(reports[base][0], reports[cand][0]),
          ref.report_delta(reports[base][1], reports[cand][1]))


def _emit_both(stores, pool_id, event):
    """The same event through each package's store-backed emit."""
    fields = {k: event[k] for k in ("job_id", "task_id", "node_id",
                                    "start", "end")}
    gp.emit(stores["port"], pool_id, event["kind"], attrs=event["attrs"],
            **fields)
    ref_events.emit(stores["ref"], pool_id, event["kind"],
                    attrs=event["attrs"], **fields)


def test_store_reports_equal_the_references():
    """job_report, pool_report (whole and trailing window) and
    fleet_report over two pools, the events emitted into each package's
    own store."""
    stores = {"port": MemoryStateStore(), "ref": RefStore()}
    now = time.time()
    for pool_id in ("p1", "p2"):
        for store in stores.values():
            store.upsert_entity("pools", "pools", pool_id,
                                {"state": "ready"})
    for name in ("partition_wall", "backoff", "async_checkpoint",
                 "gang_then_replay", "idle_nodes", "control_plane"):
        for event in SCENARIOS[name]:
            _emit_both(stores, "p1", dict(
                event, job_id=event["job_id"] and f"{name}-{event['job_id']}"))
    # p2: a recent window and one far outside the trailing hour.
    _emit_both(stores, "p2", _ev(gp.PROGRAM_STEP_WINDOW, now - 100,
                                 now - 40, job_id="recent"))
    _emit_both(stores, "p2", _ev(gp.NODE_IDLE, now - 50_000, now - 49_000,
                                 job_id=None))
    for job_id in ("partition_wall-j1", "backoff-j1", "nope"):
        _same(port.job_report(stores["port"], "p1", job_id),
              ref.job_report(stores["ref"], "p1", job_id))
    for pool_id in ("p1", "p2"):
        _same(port.pool_report(stores["port"], pool_id),
              ref.pool_report(stores["ref"], pool_id))
        _same(port.pool_report(stores["port"], pool_id,
                               include_jobs=False),
              ref.pool_report(stores["ref"], pool_id, include_jobs=False))
    _same(port.pool_report(stores["port"], "p2", window_seconds=3600),
          ref.pool_report(stores["ref"], "p2", window_seconds=3600))
    fleet = port.fleet_report(stores["port"])
    _same(fleet, ref.fleet_report(stores["ref"]))
    assert sorted(fleet["pools"]) == ["p1", "p2"]
    for report in (fleet, fleet["pools"]["p1"]):
        assert port.waterfall_table(report) == ref.waterfall_table(report)


def test_a_port_tasks_events_price_alike():
    """A task on the port's fake pool records a step window through
    $SHIPYARD_GOODPUT_FILE; the node side's events (queue, run, the
    ingested window, idle) price alike in both packages and partition
    the job's wall."""
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate
    conf = {"pool_specification": {
        "id": "gpool", "substrate": "fake",
        "vm_configuration": {"vm_size": "a3-highgpu-1g",
                             "vm_count": {"dedicated": 1}},
        "max_wait_time_seconds": 30}}
    store = MemoryStateStore()
    substrate = FakePodSubstrate(store)
    pool = settings.pool_settings(conf)
    payload = (
        "python3 -c \"import json,os,time; t=time.time(); "
        "fh=open(os.environ['SHIPYARD_GOODPUT_FILE'],'a'); "
        "fh.write(json.dumps({'kind':'step_window','start':t,"
        "'end':t+0.08,'attrs':{'step_start':0,'step_end':8,"
        "'tokens':64}})+chr(10)); fh.close(); time.sleep(0.1)\"")
    try:
        pool_mgr.create_pool(store, substrate, pool,
                             settings.global_settings({}), conf)
        jobs_mgr.add_jobs(store, pool, settings.job_settings_list(
            {"job_specifications": [{
                "id": "jgood", "tasks": [{"command": payload}]}]}))
        tasks = jobs_mgr.wait_for_tasks(store, "gpool", "jgood",
                                        timeout=30)
        assert tasks[0]["state"] == "completed"
        want = {gp.TASK_QUEUED, gp.TASK_RUNNING, gp.PROGRAM_STEP_WINDOW}
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            events = gp.query(store, "gpool", job_id="jgood")
            if want <= {e["kind"] for e in events}:
                break
            time.sleep(0.1)
    finally:
        substrate.stop_all()
    assert want <= {e["kind"] for e in events}
    got = port.job_report(store, "gpool", "jgood")
    _same(got, dict(ref.decompose(events), job_id="jgood",
                    pool_id="gpool"))
    assert got["steps"] == 8 and got["tokens"] == 64
    total = got["productive_seconds"] + sum(got["badput_seconds"].values())
    assert total == pytest.approx(got["wall_seconds"], rel=0.01)
    pool_events = gp.query(store, "gpool")
    _same(port.decompose_by_node(pool_events),
          ref.decompose_by_node(pool_events))


def test_workload_events_price_alike(tmp_path, monkeypatch, capsys):
    """The events the port's training workload writes (a compile phase
    with the cache's verdict, its step window), ingested by each
    package's events module, give the same job report."""
    from batch_shipyard_tpu_torch.compilecache import manager
    from batch_shipyard_tpu_torch.workloads import train_transformer
    goodput = tmp_path / "goodput.jsonl"
    monkeypatch.setenv(gp.GOODPUT_FILE_ENV, str(goodput))
    monkeypatch.setattr(manager, "_current", None)
    assert train_transformer.main([
        "--device", "cpu", "--d-model", "32", "--n-layers", "1",
        "--n-heads", "2", "--d-ff", "64", "--vocab", "64", "--seq-len",
        "16", "--batch", "2", "--warmup", "1", "--steps", "2",
        "--compile-cache-dir", str(tmp_path / "cache")]) == 0
    capsys.readouterr()
    copy = tmp_path / "copy.jsonl"
    shutil.copy(goodput, copy)
    lines = [json.loads(line) for line in goodput.read_text().splitlines()]
    assert {gp.PROGRAM_COMPILE, gp.PROGRAM_STEP_WINDOW} <= {
        line["kind"] for line in lines}
    port_store, ref_store = MemoryStateStore(), RefStore()
    assert gp.ingest_local_events(port_store, "p1", str(goodput),
                                  job_id="job1", task_id="t0") > 0
    assert ref_events.ingest_local_events(ref_store, "p1", str(copy),
                                          job_id="job1", task_id="t0") > 0
    got = port.job_report(port_store, "p1", "job1")
    _same(got, ref.job_report(ref_store, "p1", "job1"))
    assert got["steps"] == 2 and got["compile_cache_misses"] >= 1
