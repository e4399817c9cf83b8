"""The port's store-outage ride-through (batch_shipyard_tpu_torch/state/
resilient.py) against the reference's: each scenario of the reference's
resilient-store and group-commit tests runs on both packages' wrappers,
over their own MemoryStateStore behind one FlakyStore schedule. The inner
ops the wrapper issued, the final rows, the ``store_outage`` rows and the
journal's entries agree (apart from times and minted row keys). Then the
wiring: the port's agent process builds the wrapper unless its bootstrap
says ``"resilience": null``, its heartbeat loop skips a beat's sweeps on
StoreOutageError, and an in-process pool's task rides an outage."""

import json
import logging
import os
import threading
import time
import types

import pytest

from batch_shipyard_tpu.state import names as ref_names
from batch_shipyard_tpu.state import resilient as ref_resilient
from batch_shipyard_tpu.state.base import NotFoundError as RefNotFound
from batch_shipyard_tpu.state.base import EntityExistsError as RefExists
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state import resilient
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, NotFoundError)
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore

PACKAGES = {
    "reference": types.SimpleNamespace(
        mod=ref_resilient, store=RefStore, names=ref_names,
        not_found=RefNotFound, exists=RefExists),
    "port": types.SimpleNamespace(
        mod=resilient, store=MemoryStateStore, names=names,
        not_found=NotFoundError, exists=EntityExistsError),
}
# The reference's test knobs, small enough for a scenario to take well
# under a second.
KNOBS = {"retry_base": 0.02, "retry_cap": 0.1, "probe_interval": 0.05}


class FlakyStore:
    """Transport-failure wrapper with one schedule for both packages:
    every op raises while ``down``; the next ``fail_next`` ops raise;
    ``tear_after`` makes the next insert_entities land that many rows and
    then raise. Records every op that reaches it."""

    def __init__(self, inner):
        self.inner = inner
        self.down = False
        self.fail_next = 0
        self.tear_after = None
        self.calls = []

    def __getattr__(self, name):
        attr = getattr(self.inner, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            self.calls.append(name)
            if self.down:
                raise RuntimeError("store down")
            if self.fail_next > 0:
                self.fail_next -= 1
                raise RuntimeError("store down")
            if name == "insert_entities" and self.tear_after is not None:
                keep, self.tear_after = self.tear_after, None
                for pk, rk, entity in args[1][:keep]:
                    self.inner.insert_entity(args[0], pk, rk, entity)
                raise ConnectionError("torn mid-batch")
            return attr(*args, **kwargs)
        return call


def _rs(pkg, flaky, tmp_path, **kw):
    for key, value in KNOBS.items():
        kw.setdefault(key, value)
    return pkg.mod.ResilientStore(flaky, str(tmp_path / "wal.jsonl"),
                                  pool_id="testpool", node_id="n0", **kw)


def _wal(tmp_path):
    """The journal file's entries, without their times."""
    path = tmp_path / "wal.jsonl"
    if not path.exists():
        return None
    entries = [json.loads(line) for line in path.read_text().splitlines()
               if line.strip()]
    return [{k: v for k, v in e.items() if k != "recorded_at"}
            for e in entries]


def _outages(raw, pkg):
    return [r for r in raw.query_entities(pkg.names.TABLE_GOODPUT)
            if r["kind"] == "store_outage"]


def _rows(raw, pkg):
    """Every row of the tables the scenarios touch, without etags; an
    outage row also without its times and minted key (checked apart)."""
    out = {}
    for table in (pkg.names.TABLE_TASKS, pkg.names.TABLE_GOODPUT,
                  pkg.names.TABLE_NODES):
        rows = []
        for row in raw.query_entities(table):
            row = {k: v for k, v in row.items() if k != "_etag"}
            if row.get("kind") == "store_outage":
                assert row["end"] > row["start"]
                row = {k: v for k, v in row.items()
                       if k not in ("start", "end", "_rk")}
            rows.append(row)
        out[table] = sorted(rows, key=json.dumps)
    return out


def _record(pkg, raw, flaky, extra=None, calls=True):
    return {"calls": list(flaky.calls) if calls else None,
            "rows": _rows(raw, pkg), "outages": len(_outages(raw, pkg)),
            **(extra or {})}


# ------------------------- the reference's scenarios -------------------------

def critical_retries_and_prices_outage(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path)
    flaky.fail_next = 3
    rs.insert_entity(pkg.names.TABLE_TASKS, "p$j", "t0",
                     {"state": "pending"})
    assert raw.get_entity(pkg.names.TABLE_TASKS, "p$j",
                          "t0")["state"] == "pending"
    outage, = _outages(raw, pkg)
    assert outage["node_id"] == "n0"
    return _record(pkg, raw, flaky)


def put_stream_rides_outage_untorn(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path)
    payload = [b"aa", b"bb", b"cc"]
    consumed = []

    def chunks():
        for block in payload:
            consumed.append(block)
            yield block

    flaky.fail_next = 2
    rs.put_object_stream("outputs/k", chunks())
    assert raw.get_object("outputs/k") == b"aabbcc"
    assert consumed == payload
    return _record(pkg, raw, flaky)


def get_stream_retries_open(pkg, tmp_path):
    raw = pkg.store()
    raw.put_object("k", b"x" * 100)
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path)
    flaky.fail_next = 2
    assert b"".join(rs.get_object_stream("k")) == b"x" * 100
    with pytest.raises(pkg.not_found):
        list(rs.get_object_stream("missing"))
    return _record(pkg, raw, flaky)


def critical_ceiling_survives_latch_flap(pkg, tmp_path):
    """A caller error failing against a healthy store keeps re-latching
    an outage that concurrent advisory probes clear; the per-call ceiling
    still ends it. The interleaving is the threads', so only the outcome
    is compared."""
    raw = pkg.store()

    class OneOpBroken:
        def __init__(self, inner):
            self.inner = inner

        def __getattr__(self, name):
            attr = getattr(self.inner, name)
            if name == "merge_entity":
                def broken(*a, **k):
                    raise RuntimeError("caller bug")
                return broken
            return attr

    rs = pkg.mod.ResilientStore(OneOpBroken(raw), str(tmp_path / "wal.jsonl"),
                                pool_id="testpool", node_id="n0",
                                retry_base=0.02, retry_cap=0.05,
                                probe_interval=0.01, max_outage_seconds=0.4)
    stop = threading.Event()

    def flapper():
        while not stop.is_set():
            rs.insert_entity(pkg.names.TABLE_GOODPUT, "testpool",
                             f"f{time.monotonic()}",
                             {"kind": "idle", "start": 0, "end": 1})
            time.sleep(0.02)

    thread = threading.Thread(target=flapper, daemon=True)
    thread.start()
    try:
        t0 = time.monotonic()
        with pytest.raises(pkg.mod.StoreOutageError):
            rs.merge_entity(pkg.names.TABLE_TASKS, "p$j", "t",
                            {"state": "x"})
        assert time.monotonic() - t0 < 5.0
    finally:
        stop.set()
        thread.join(timeout=5.0)
    return {"tasks": list(raw.query_entities(pkg.names.TABLE_TASKS))}


def semantic_errors_propagate(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path)
    with pytest.raises(pkg.not_found):
        rs.get_entity(pkg.names.TABLE_TASKS, "p$j", "missing")
    assert rs.journal_backlog() == 0 and not rs.outage_active()
    return _record(pkg, raw, flaky)


def advisory_wal_order_and_replay(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path, probe_interval=3600.0)
    flaky.down = True
    for i in range(4):
        rs.insert_entity(pkg.names.TABLE_GOODPUT, "testpool",
                         f"{i:03d}$r", {"kind": "idle", "seq": i,
                                        "start": i, "end": i + 1})
    assert rs.journal_backlog() == 4
    wal = _wal(tmp_path)
    flaky.down = False
    rs.queue_length("q")
    assert rs.journal_backlog() == 0
    seqs = [r["seq"] for r in sorted(
        raw.query_entities(pkg.names.TABLE_GOODPUT), key=lambda r: r["_rk"])
        if r["kind"] == "idle"]
    assert seqs == [0, 1, 2, 3]
    assert _wal(tmp_path) is None
    return _record(pkg, raw, flaky, {"wal": wal})


def heartbeat_coalescing(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path, probe_interval=3600.0)
    raw.upsert_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                      {"state": "idle"})
    flaky.down = True
    for beat in range(10):
        rs.merge_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                        {"heartbeat_at": float(beat),
                         "running_tasks": beat % 3})
    assert rs.journal_backlog() == 1
    wal = _wal(tmp_path)
    flaky.down = False
    rs.queue_length("q")
    node = raw.get_entity(pkg.names.TABLE_NODES, "testpool", "n0")
    assert node["heartbeat_at"] == 9.0 and node["state"] == "idle"
    return _record(pkg, raw, flaky, {"wal": wal})


def coalescing_respects_op_boundaries(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path, probe_interval=3600.0)
    raw.upsert_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                      {"state": "idle", "extra": "stale"})
    flaky.down = True
    rs.merge_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                    {"heartbeat_at": 1.0})
    rs.upsert_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                     {"state": "running"})
    rs.merge_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                    {"heartbeat_at": 2.0})
    assert rs.journal_backlog() == 3
    wal = _wal(tmp_path)
    flaky.down = False
    rs.queue_length("q")
    node = raw.get_entity(pkg.names.TABLE_NODES, "testpool", "n0")
    assert node["state"] == "running" and node["heartbeat_at"] == 2.0
    assert "extra" not in node
    return _record(pkg, raw, flaky, {"wal": wal})


def replay_idempotent_after_crash(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path, probe_interval=3600.0)
    flaky.down = True
    for i in range(2):
        rs.insert_entity(pkg.names.TABLE_GOODPUT, "testpool", f"00{i}$r",
                         {"kind": "idle", "start": i, "end": i + 1})
    # The crash: the first entry was applied before the journal trim.
    raw.insert_entity(pkg.names.TABLE_GOODPUT, "testpool", "000$r",
                      {"kind": "idle", "start": 0, "end": 1})
    wal = _wal(tmp_path)
    flaky.down = False
    rs2 = _rs(pkg, flaky, tmp_path)
    assert rs2.journal_backlog() == 2
    rs2.queue_length("q")
    assert rs2.journal_backlog() == 0
    assert len([r for r in raw.query_entities(pkg.names.TABLE_GOODPUT)
                if r["kind"] == "idle"]) == 2
    return _record(pkg, raw, flaky, {"wal": wal})


def wal_survives_restart(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path, probe_interval=3600.0)
    flaky.down = True
    rs.insert_entity(pkg.names.TABLE_GOODPUT, "testpool", "000$r",
                     {"kind": "idle", "start": 0, "end": 1})
    del rs  # the agent process dies with a backlog
    wal = _wal(tmp_path)
    flaky.down = False
    rs2 = _rs(pkg, flaky, tmp_path)
    assert rs2.journal_backlog() == 1
    rs2.queue_length("q")
    assert rs2.journal_backlog() == 0
    return _record(pkg, raw, flaky, {"wal": wal})


def fresh_advisory_queues_behind_undrained_backlog(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    raw.upsert_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                      {"state": "idle"})
    rs = _rs(pkg, flaky, tmp_path, probe_interval=3600.0)
    flaky.down = True
    rs.merge_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                    {"heartbeat_at": 1.0})
    del rs
    flaky.down = False
    rs2 = _rs(pkg, flaky, tmp_path, probe_interval=3600.0)
    assert rs2.journal_backlog() == 1 and not rs2.outage_active()
    # A concurrent drain owns the replay: the fresh beat must queue
    # behind the stale journaled one, not write through it.
    assert rs2._replay_lock.acquire(blocking=False)
    try:
        rs2.merge_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                         {"heartbeat_at": 2.0})
        assert raw.get_entity(pkg.names.TABLE_NODES, "testpool",
                              "n0").get("heartbeat_at") is None
        wal = _wal(tmp_path)
    finally:
        rs2._replay_lock.release()
    rs2.queue_length("q")
    assert rs2.journal_backlog() == 0
    assert raw.get_entity(pkg.names.TABLE_NODES, "testpool",
                          "n0")["heartbeat_at"] == 2.0
    return _record(pkg, raw, flaky, {"wal": wal})


def bounded_caps_critical_retry(pkg, tmp_path):
    """The bounded window's attempts depend on the clock, so the calls
    compared are those after it."""
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path, max_outage_seconds=900.0)
    flaky.down = True
    t0 = time.monotonic()
    with pytest.raises(pkg.mod.StoreOutageError):
        with rs.bounded(0.3):
            rs.get_entity(pkg.names.TABLE_TASKS, "p$j", "t0")
    assert time.monotonic() - t0 < 2.0
    assert rs.outage_active()
    flaky.down = False
    flaky.calls.clear()
    flaky.fail_next = 2
    assert rs.queue_length("q") == 0
    assert not rs.outage_active()
    return _record(pkg, raw, flaky)


def replay_never_resurrects_deleted_node(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path, probe_interval=3600.0)
    raw.upsert_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                      {"state": "idle"})
    flaky.down = True
    rs.upsert_entity(pkg.names.TABLE_NODES, "testpool", "n0",
                     {"state": "idle", "heartbeat_at": 1.0})
    assert rs.journal_backlog() == 1
    wal = _wal(tmp_path)
    raw.delete_entity(pkg.names.TABLE_NODES, "testpool", "n0")
    flaky.down = False
    rs.queue_length("q")
    assert rs.journal_backlog() == 0
    with pytest.raises(pkg.not_found):
        raw.get_entity(pkg.names.TABLE_NODES, "testpool", "n0")
    return _record(pkg, raw, flaky, {"wal": wal})


# --------------------------- group commit -------------------------------

def group_commit_coalesces_and_flushes(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path)
    pk = pkg.names.task_pk("pool1", "job1")
    with rs.group_commit():
        for i in range(4):
            rs.insert_entities(pkg.names.TABLE_TASKS, [
                (pk, f"task-{4 * i + j:05d}", {"state": "pending"})
                for j in range(4)])
        for i in range(4):
            rs.put_messages("q-0", [b"m%d" % (4 * i + j) for j in range(4)])
        assert rs.group_commit_pending() > 0
        assert len(list(rs.query_entities(pkg.names.TABLE_TASKS,
                                          partition_key=pk))) == 16
        assert rs.group_commit_pending() == 0
    assert raw.queue_length("q-0") == 16
    return _record(pkg, raw, flaky, {
        "coalesced": rs.group_commit_coalesced_total,
        "commits": rs.group_commits_total})


def group_commit_never_tears_a_batch(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    rs = _rs(pkg, flaky, tmp_path)
    pk = pkg.names.task_pk("pool1", "job1")
    flaky.tear_after = 5
    with rs.group_commit():
        rs.insert_entities(pkg.names.TABLE_TASKS, [
            (pk, f"task-{i:05d}", {"state": "pending", "n": i})
            for i in range(12)])
    rows = {r["_rk"]: r["n"] for r in raw.query_entities(
        pkg.names.TABLE_TASKS, partition_key=pk)}
    assert rows == {f"task-{i:05d}": i for i in range(12)}
    return _record(pkg, raw, flaky)


def group_commit_defers_semantic_error(pkg, tmp_path):
    raw = pkg.store()
    flaky = FlakyStore(raw)
    pk = pkg.names.task_pk("pool1", "job1")
    raw.insert_entity(pkg.names.TABLE_TASKS, pk, "task-00001",
                      {"state": "pending"})
    rs = _rs(pkg, flaky, tmp_path)
    with pytest.raises(pkg.exists):
        with rs.group_commit():
            rs.insert_entities(pkg.names.TABLE_TASKS, [
                (pk, "task-00001", {"state": "pending"})])
            rs.put_messages("q-0", [b"survivor"])
    assert raw.queue_length("q-0") == 1
    return _record(pkg, raw, flaky)


SCENARIOS = [
    critical_retries_and_prices_outage, put_stream_rides_outage_untorn,
    get_stream_retries_open, critical_ceiling_survives_latch_flap,
    semantic_errors_propagate, advisory_wal_order_and_replay,
    heartbeat_coalescing, coalescing_respects_op_boundaries,
    replay_idempotent_after_crash, wal_survives_restart,
    fresh_advisory_queues_behind_undrained_backlog,
    bounded_caps_critical_retry, replay_never_resurrects_deleted_node,
    group_commit_coalesces_and_flushes, group_commit_never_tears_a_batch,
    group_commit_defers_semantic_error,
]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_agrees_with_the_reference(scenario, tmp_path):
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = scenario(PACKAGES["reference"], tmp_path / "ref")
    got = scenario(PACKAGES["port"], tmp_path / "port")
    assert got == want


def test_journal_written_by_one_package_replays_under_the_other(tmp_path):
    """The journal format is shared: a reference agent's backlog is a
    port agent's debt (and the other way round)."""
    for writer, reader in (("reference", "port"), ("port", "reference")):
        w, r = PACKAGES[writer], PACKAGES[reader]
        work = tmp_path / writer
        work.mkdir()
        flaky = FlakyStore(w.store())
        rs = _rs(w, flaky, work, probe_interval=3600.0)
        flaky.down = True
        rs.insert_entity(w.names.TABLE_GOODPUT, "testpool", "000$r",
                         {"kind": "idle", "start": 0, "end": 1})
        rs.merge_entity(w.names.TABLE_NODES, "testpool", "n0",
                        {"heartbeat_at": 3.0})
        raw = r.store()
        raw.upsert_entity(r.names.TABLE_NODES, "testpool", "n0",
                          {"state": "idle"})
        rs2 = _rs(r, raw, work)
        assert rs2.journal_backlog() == 2
        rs2.queue_length("q")
        assert rs2.journal_backlog() == 0
        assert raw.get_entity(r.names.TABLE_NODES, "testpool",
                              "n0")["heartbeat_at"] == 3.0
        assert [row["_rk"] for row in raw.query_entities(
            r.names.TABLE_GOODPUT)] == ["000$r"]


# ------------------------------ the agent ------------------------------

def _boot(tmp_path, **extra):
    return {"storage": {"backend": "memory", "prefix": "resilient-test"},
            "pool_config": {"pool_specification": {
                "id": "rpool", "substrate": "fake",
                "vm_configuration": {"vm_size": "a3-highgpu-1g",
                                     "vm_count": {"dedicated": 1}}}},
            "identity": {"pool_id": "rpool", "node_id": "rpool-n0",
                         "node_index": 0, "hostname": "h",
                         "internal_ip": "127.0.0.1"},
            "work_dir": str(tmp_path / "node"), "run_nodeprep": False,
            **extra}


def test_agent_process_builds_the_wrapper_by_default(tmp_path):
    from batch_shipyard_tpu_torch.agent import __main__ as agent_main
    raw = MemoryStateStore()
    agent = agent_main.build_agent(_boot(tmp_path), store=raw)
    assert isinstance(agent.store, resilient.ResilientStore)
    assert agent.store._inner is raw
    assert agent.store._journal_path == str(
        tmp_path / "node" / "store_wal.jsonl")
    assert agent.store._pool_id == "rpool"
    assert agent.store._node_id == "rpool-n0"
    # The reference's default knobs.
    assert (agent.store._retry_base, agent.store._retry_cap,
            agent.store._max_outage_seconds) == (0.25, 5.0, 900.0)


def test_agent_process_drops_the_wrapper_on_null(tmp_path):
    from batch_shipyard_tpu_torch.agent import __main__ as agent_main
    raw = MemoryStateStore()
    agent = agent_main.build_agent(_boot(tmp_path, resilience=None),
                                   store=raw)
    assert agent.store is raw


def test_agent_process_passes_the_knobs_through(tmp_path):
    from batch_shipyard_tpu_torch.agent import __main__ as agent_main
    agent = agent_main.build_agent(_boot(tmp_path, resilience={
        "retry_base": 0.5, "retry_cap": 2.0, "max_outage_seconds": 60.0,
        "probe_interval": 0.25}), store=MemoryStateStore())
    assert (agent.store._retry_base, agent.store._retry_cap,
            agent.store._max_outage_seconds,
            agent.store._probe_interval) == (0.5, 2.0, 60.0, 0.25)


def test_in_process_agent_keeps_the_bare_store(tmp_path):
    from batch_shipyard_tpu_torch.agent.node_agent import (
        NodeAgent, NodeIdentity)
    from batch_shipyard_tpu_torch.config import settings
    raw = MemoryStateStore()
    boot = _boot(tmp_path)
    agent = NodeAgent(raw, NodeIdentity(**boot["identity"]),
                      settings.pool_settings(boot["pool_config"]),
                      work_dir=boot["work_dir"])
    assert agent.store is raw
    assert type(agent._store_bounded(1.0)).__name__ == "nullcontext"


def test_heartbeat_loop_skips_the_sweeps_on_a_store_outage(tmp_path,
                                                           caplog):
    """The beat's coordination sweeps run under the wrapper's bounded
    window; when it fires, the loop logs and goes on beating (the
    reference's ``except StoreOutageError`` arm), and the heartbeat
    itself journals."""
    from batch_shipyard_tpu_torch.agent import __main__ as agent_main
    raw = MemoryStateStore()
    flaky = FlakyStore(raw)
    boot = _boot(tmp_path, heartbeat_interval=0.05, resilience=dict(KNOBS))
    agent = agent_main.build_agent(boot, store=flaky)
    raw.upsert_entity(names.TABLE_NODES, "rpool", "rpool-n0",
                      {"state": "idle"})
    bounds = []
    real_bounded = agent.store.bounded

    def short_bound(seconds):
        bounds.append(seconds)
        return real_bounded(0.1)

    agent._store_bounded = short_bound
    flaky.down = True
    caplog.set_level(logging.WARNING)
    thread = threading.Thread(target=agent._heartbeat_loop, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and not any(
                "coordination sweeps skipped" in r.getMessage()
                for r in caplog.records):
            time.sleep(0.05)
        backlog = agent.store.journal_backlog()
    finally:
        flaky.down = False
        agent.stop()
        thread.join(timeout=10.0)
    assert not thread.is_alive()
    assert any("coordination sweeps skipped" in r.getMessage()
               for r in caplog.records)
    # The window the reference gives the sweeps.
    assert bounds and bounds[0] == max(5.0, 2.0 * 0.05)
    # The beats themselves journaled (one coalesced node publish).
    assert backlog == 1


def test_a_restart_during_an_outage_boots_within_its_bounds(tmp_path):
    """A restarted agent with a predecessor's slot ledger boots while the
    store is dark: the pre-restart heartbeat probe and the ledger's
    adoption probe each run under the wrapper's bounded window (the
    reference's max(10, 2 x heartbeat)), so start() returns instead of
    retrying toward the outage ceiling."""
    from batch_shipyard_tpu_torch.agent import __main__ as agent_main
    raw = MemoryStateStore()
    flaky = FlakyStore(raw)
    raw.upsert_entity(names.TABLE_NODES, "rpool", "rpool-n0",
                      {"state": "idle", "heartbeat_at": 5.0})
    boot = _boot(tmp_path, heartbeat_interval=0.05,
                 resilience=dict(KNOBS, max_outage_seconds=60.0))
    agent = agent_main.build_agent(boot, store=flaky)
    slots = tmp_path / "node" / "slots"
    slots.mkdir(parents=True)
    (slots / "slot0.json").write_text(json.dumps(
        {"job_id": "j", "task_id": "t", "pid": 999999, "slot": 0}))
    bounds = []
    real_bounded = agent.store.bounded

    def short_bound(seconds):
        bounds.append(seconds)
        return real_bounded(0.2)

    agent._store_bounded = short_bound
    flaky.down = True
    thread = threading.Thread(target=agent.start, daemon=True)
    t0 = time.monotonic()
    thread.start()
    thread.join(20.0)
    booted = not thread.is_alive()
    seconds = time.monotonic() - t0
    flaky.down = False
    agent.stop()
    agent.join(10.0)
    assert booted and seconds < 10.0
    assert bounds == [max(10.0, 2.0 * 0.05)] * 2


def test_task_rides_a_store_outage_on_an_in_process_pool(tmp_path):
    """The CPU rehearsal of the card's outage leg: a fake pool whose
    agent is built as the agent process builds it (ride-through on) over
    a store switched off for a second while a task runs. The task
    completes once, unretried, one ``store_outage`` row covers the
    window, and the journal drains."""
    from batch_shipyard_tpu_torch.config import settings
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    from batch_shipyard_tpu_torch.pool import manager as pool_mgr
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate
    raw = MemoryStateStore()
    flaky = FlakyStore(raw)
    pod = FakePodSubstrate(flaky, work_root=str(tmp_path / "pod"),
                           heartbeat_interval=0.2)
    pod.agent_kwargs = {"resilience": dict(KNOBS)}
    conf = {"pool_specification": {
        "id": "opool", "substrate": "fake",
        "vm_configuration": {"vm_size": "a3-highgpu-1g",
                             "vm_count": {"dedicated": 1}},
        "max_wait_time_seconds": 30}}
    pool = settings.pool_settings(conf)
    pool_mgr.create_pool(raw, pod, pool, settings.global_settings({}), conf)
    try:
        jobs_mgr.add_jobs(raw, pool, settings.job_settings_list(
            {"job_specifications": [{"id": "oj", "tasks": [{
                "id": "t", "command": "sleep 2; echo rode-it-out"}]}]}))
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and jobs_mgr.list_tasks(
                raw, "opool", "oj")[0].get("state") != "running":
            time.sleep(0.05)
        time.sleep(0.3)
        off = time.time()
        flaky.down = True
        time.sleep(1.0)
        agent = next(iter(pod._agents["opool"].values()))
        wal = os.path.join(agent.work_dir, "store_wal.jsonl")
        journaled = os.path.exists(wal)
        on = time.time()
        flaky.down = False
        row, = jobs_mgr.wait_for_tasks(raw, "opool", "oj", timeout=30)
        assert (row["state"], row["exit_code"]) == ("completed", 0)
        assert not row.get("retries")
        assert jobs_mgr.get_task_output(
            raw, "opool", "oj", "t", "stdout.txt").strip() == b"rode-it-out"
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline and (
                agent.store.journal_backlog() or not _outages(
                    raw, PACKAGES["port"])):
            time.sleep(0.05)
        assert journaled
        assert agent.store.journal_backlog() == 0
        outage, = _outages(raw, PACKAGES["port"])
        assert off <= outage["start"] <= on and outage["end"] >= on
        assert outage["node_id"] == agent.identity.node_id
        running = [e for e in gp_events.query(raw, "opool", job_id="oj")
                   if e["kind"] == gp_events.TASK_RUNNING]
        assert len(running) == 1
    finally:
        pod.stop_all()


def test_the_cards_outage_leg_on_the_cpu(tmp_path):
    """chip_smoke's (n6) leg on the CPU with a task that sleeps and
    prints a loss line in place of the warm run: its own checks (one
    outage row over the window, the journal replayed, the task once)
    pass."""
    import sys
    import chip_smoke as cs
    losses = [2.5, 2.25]
    command = (f"{sys.executable} -c \"import json, time; time.sleep(8); "
               f"print(json.dumps({{'losses': {losses}}}))\"")
    leg = cs.outage_leg(tmp_path, {}, command, {"report": {"losses": losses}})
    assert leg["outage_priced_s"] >= cs.OUTAGE_S
    assert leg["journaled_entries"] >= 1
