"""The port's chaos injectors: ChaosStore's delay, error and outage gates
against the reference's on the same op sequence; every kind of
``apply_injection`` on a live fakepod pool of the port's (GPU nodes,
the drills' shape), each checked for what it hit; and the port of
tests/test_bulk_submission.py:320, a group commit through transient
injected errors on the port's ResilientStore."""

import os
import signal
import time

import pytest

from batch_shipyard_tpu.chaos import injectors as ref_injectors
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu_torch.chaos import injectors
from batch_shipyard_tpu_torch.chaos.plan import INJECTION_KINDS, Injection
from batch_shipyard_tpu_torch.config import settings as settings_mod
from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
from batch_shipyard_tpu_torch.pool import manager as pool_mgr
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state import resilient as state_resilient
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

POOL_ID = "inject"
JOB_ID = "victims"


# ------------------------------ ChaosStore ------------------------------

def _ops(store):
    """One pass over faulted and unfaulted ops: (name, thunk)."""
    return [
        ("put_object", lambda: store.put_object("k/a", b"1")),
        ("get_object", lambda: store.get_object("k/a")),
        ("insert_entity", lambda: store.insert_entity(
            "t", "p", f"r{time.monotonic_ns()}", {"v": 1})),
        ("upsert_entity", lambda: store.upsert_entity(
            "t", "p", "fixed", {"v": 2})),
        ("get_entity", lambda: store.get_entity("t", "p", "fixed")),
        ("queue_length", lambda: store.queue_length("q")),
        ("put_message", lambda: store.put_message("q", b"m")),
        ("delete_object", lambda: store.delete_object("k/a")),
    ]


def _run_ops(store, passes: int = 2) -> list:
    outcomes = []
    for _ in range(passes):
        for name, op in _ops(store):
            try:
                op()
                outcomes.append((name, "ok"))
            except Exception as exc:  # noqa: BLE001 - the outcome
                outcomes.append((name, f"{type(exc).__name__}: {exc}"))
    return outcomes


def _gated(mod, store_cls, scenario):
    chaos = mod.ChaosStore(store_cls())
    if scenario == "errors":
        chaos.inject_errors(3)
    elif scenario == "errors_accumulate":
        chaos.inject_errors(2)
        chaos.inject_errors(3)
        chaos.inject_errors(-4)
    elif scenario == "outage_then_errors":
        chaos.inject_errors(2)
        chaos.inject_outage(60.0)
        during = _run_ops(chaos, passes=1)
        chaos.inject_outage(0.0)
        return during + _run_ops(chaos)
    elif scenario == "expired_outage":
        chaos.inject_outage(0.0)
    return _run_ops(chaos)


@pytest.mark.parametrize("scenario", ["none", "errors", "errors_accumulate",
                                      "outage_then_errors",
                                      "expired_outage"])
def test_chaos_store_gates_match_the_reference(scenario):
    want = _gated(ref_injectors, RefStore, scenario)
    got = _gated(injectors, MemoryStateStore, scenario)
    assert got == want
    if scenario == "errors":
        errors = [o for _, o in got if o.startswith("ChaosError")]
        assert errors == [f"ChaosError: {injectors.INJECTED_ERROR}"] * 3
    if scenario == "outage_then_errors":
        assert [o for _, o in got[:8] if o != "ok"] == \
            [f"ChaosError: {injectors.OUTAGE_ERROR}"] * 7
        assert [o for _, o in got[8:] if o.startswith("ChaosError")] == \
            [f"ChaosError: {injectors.INJECTED_ERROR}"] * 2


def test_chaos_store_delay_window_matches_the_reference():
    """A delay window sleeps every faulted op (not queue_length) while
    it lasts, then none."""
    def delays(mod, store_cls):
        chaos = mod.ChaosStore(store_cls())
        chaos.inject_delay(0.05, 0.6)
        slow = []
        for name, op in _ops(chaos):
            t0 = time.monotonic()
            op()
            slow.append((name, time.monotonic() - t0 >= 0.045))
        time.sleep(0.65)
        t0 = time.monotonic()
        for _, op in _ops(chaos):
            op()
        return slow, time.monotonic() - t0 < 0.2
    want = delays(ref_injectors, RefStore)
    got = delays(injectors, MemoryStateStore)
    assert got == want
    assert dict(got[0]) == {name: name != "queue_length"
                            for name, _ in _ops(None)}


def test_faulted_op_set_is_the_references():
    assert injectors._FAULTED_OPS == ref_injectors._FAULTED_OPS


# ---------------------------- apply_injection ----------------------------

def _pool(nodes=2, slots=1):
    store = MemoryStateStore()
    chaos = injectors.ChaosStore(store)
    substrate = FakePodSubstrate(chaos, heartbeat_interval=0.2,
                                 node_stale_seconds=3.0)
    substrate.agent_kwargs = {"claim_visibility_seconds": 3.0,
                              "gang_sweep_interval": 1.0}
    conf = {"pool_specification": {
        "id": POOL_ID, "substrate": "fake",
        "vm_configuration": {"vm_size": "a3-highgpu-1g",
                             "vm_count": {"dedicated": nodes}},
        "task_slots_per_node": slots, "max_wait_time_seconds": 30}}
    pool = settings_mod.pool_settings(conf)
    pool_mgr.create_pool(store, substrate, pool,
                         settings_mod.global_settings({}), conf)
    return store, chaos, substrate, pool


def _running(store, substrate, pool, count=2):
    """Submit ``count`` long sleeps; wait until each runs somewhere."""
    jobs_mgr.add_jobs(store, pool, settings_mod.job_settings_list(
        {"job_specifications": [{"id": JOB_ID, "tasks": [
            {"id": f"v{i}", "command": "sleep 20"}
            for i in range(count)]}]}))
    deadline = time.monotonic() + 20.0
    while time.monotonic() < deadline:
        live = [a for a in injectors._live_agents(substrate, POOL_ID)
                if a._live_procs]
        if len(live) >= min(count, 2):
            return live
        time.sleep(0.05)
    raise AssertionError("no task reached a live process")


def _injection(kind, node_index=0, **params):
    return Injection(at=0.0, kind=kind, node_index=node_index,
                     params=tuple(sorted(params.items())))


def _proc_state(pid):
    """The state letter of /proc/<pid>/stat, None once the pid is gone
    (it may go between any two reads)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0]
    except FileNotFoundError:
        return None


def _await(cond, timeout=15.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return False


def _kill_tasks(substrate):
    for agent in injectors._live_agents(substrate, POOL_ID):
        for proc in list(agent._live_procs.values()):
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError, OSError):
                pass


def _node_ids(substrate):
    return sorted(a.identity.node_id
                  for a in injectors._live_agents(substrate, POOL_ID))


def _store_kinds(kind, store, chaos, substrate, pool):
    record = injectors.apply_injection(
        _injection(kind, delay=0.02, window=30.0, ops=2), substrate,
        POOL_ID, store=chaos)
    assert record["applied"]
    if kind == "store_delay":
        assert chaos._delay_until > time.monotonic() + 20.0
        assert chaos._delay_seconds == 0.02
    elif kind == "store_error":
        assert chaos._error_budget == 2
    else:
        with pytest.raises(injectors.ChaosError,
                           match=injectors.OUTAGE_ERROR):
            chaos.get_object("any")
        chaos.inject_outage(0.0)
    # Without a store to fault, nothing is applied.
    assert not injectors.apply_injection(
        _injection(kind), substrate, POOL_ID)["applied"]


def _blackout(kind, store, chaos, substrate, pool):
    agents = injectors._live_agents(substrate, POOL_ID)
    record = injectors.apply_injection(
        _injection(kind, node_index=3, window=30.0), substrate, POOL_ID)
    assert record["applied"]
    target = next(a for a in agents
                  if a.identity.node_id == record["node_id"])
    assert target.heartbeat_blackout_until > time.time() + 20.0
    if kind == "heartbeat_blackout":
        # node_index 3 of two live agents: the second.
        assert target is agents[1]
    else:
        assert target.lease_blackout_until > time.time() + 20.0
        assert "leader_epoch" in record


def _task_signals(kind, store, chaos, substrate, pool):
    _running(store, substrate, pool)
    record = injectors.apply_injection(_injection(kind), substrate,
                                       POOL_ID)
    assert record["applied"] and record["pid"]
    pid = record["pid"]
    if kind == "task_kill":
        assert _await(lambda: _proc_state(pid) in (None, "Z"))
    else:
        assert _await(lambda: _proc_state(pid) == "T")


def _node_crashes(kind, store, chaos, substrate, pool):
    before = _node_ids(substrate)
    record = injectors.apply_injection(
        _injection(kind, node_index=1, revive_after=0.3, count=1),
        substrate, POOL_ID)
    assert record["applied"]
    if kind == "node_preempt":
        assert record["node_id"] == before[1]
        # Revived with the same identity.
        assert _await(lambda: _node_ids(substrate) == before)
    elif kind == "host_loss_resize":
        assert record["crashed"] == [before[1]]
        time.sleep(0.5)
        assert _node_ids(substrate) == [before[0]]
    else:
        assert sorted(record["crashed"]) == before
        assert _node_ids(substrate) == []


def _agent_restart(kind, store, chaos, substrate, pool):
    live = _running(store, substrate, pool)
    record = injectors.apply_injection(
        _injection(kind, revive_after=0.3), substrate, POOL_ID)
    assert record["applied"]
    assert record["node_id"] in {a.identity.node_id for a in live}
    crashed = next(a for a in live
                   if a.identity.node_id == record["node_id"])
    assert crashed._abandoned
    # The revived agent runs on the same work dir.
    assert _await(lambda: any(
        a.identity.node_id == record["node_id"] and a is not crashed
        for a in injectors._live_agents(substrate, POOL_ID)))


def _notices(kind, store, chaos, substrate, pool):
    _running(store, substrate, pool)
    record = injectors.apply_injection(
        _injection(kind, notice=0.3, revive_after=0.3), substrate,
        POOL_ID)
    assert record["applied"]
    assert record["job_id"] == JOB_ID
    row = jobs_mgr.get_task(store, POOL_ID, JOB_ID, record["task_id"])
    assert row.get(names.TASK_COL_PREEMPT_REQUEST), row
    agent = next(a for a in injectors._live_agents(substrate, POOL_ID)
                 if a.identity.node_id == record["node_id"])
    if kind == "node_preempt_notice":
        # An oblivious sleep does not drain: the node is crashed after
        # the notice and revived.
        assert _await(lambda: all(
            a is not agent
            for a in injectors._live_agents(substrate, POOL_ID)))
    else:
        # No follow-through: the victim's node stays as it was.
        time.sleep(0.5)
        assert agent in injectors._live_agents(substrate, POOL_ID)


def _serving_kinds(kind, store, chaos, substrate, pool):
    # The batch injector does not apply the serving kinds: their
    # drills (chaos/serving_drill.py) act on a fleet, not a pool.
    record = injectors.apply_injection(_injection(kind), substrate,
                                       POOL_ID, store=chaos)
    assert not record["applied"]


CASES = {
    "store_delay": _store_kinds, "store_error": _store_kinds,
    "store_outage": _store_kinds,
    "heartbeat_blackout": _blackout, "leader_partition": _blackout,
    "task_kill": _task_signals, "task_wedge": _task_signals,
    "node_preempt": _node_crashes, "host_loss_resize": _node_crashes,
    "pool_capacity_loss": _node_crashes,
    "agent_restart": _agent_restart,
    "node_preempt_notice": _notices, "victim_ignore_notice": _notices,
    "replica_kill": _serving_kinds, "replica_drain_notice": _serving_kinds,
    "router_restart": _serving_kinds,
}


def test_every_kind_has_a_case():
    assert set(CASES) == set(INJECTION_KINDS)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_apply_injection_on_a_fakepod_pool(kind):
    store, chaos, substrate, pool = _pool()
    try:
        CASES[kind](kind, store, chaos, substrate, pool)
    finally:
        _kill_tasks(substrate)
        substrate.stop_all()


def test_no_live_agents_applies_nothing():
    substrate = FakePodSubstrate(MemoryStateStore())
    record = injectors.apply_injection(_injection("node_preempt"),
                                       substrate, "no-such-pool")
    assert record == {"kind": "node_preempt", "at": 0.0,
                      "node_index": 0, "applied": False}


# ------------------------- group commit under faults ----------------------

def test_group_commit_under_chaos_store_faults(tmp_path):
    """tests/test_bulk_submission.py:320 on the port: transient injected
    errors during the flush retry through to exactly-once rows."""
    raw = MemoryStateStore()
    chaos = injectors.ChaosStore(raw)
    rs = state_resilient.ResilientStore(
        chaos, journal_path=str(tmp_path / "wal.jsonl"),
        retry_base=0.01, retry_cap=0.05)
    pk = names.task_pk("bulkpool", "bulkjob")
    chaos.inject_errors(2)
    with rs.group_commit():
        rs.insert_entities(names.TABLE_TASKS, [
            (pk, f"task-{i:05d}", {"state": "pending"})
            for i in range(8)])
        rs.put_messages("q-0", [b"x"] * 8)
    rows = list(raw.query_entities(names.TABLE_TASKS, partition_key=pk))
    assert len(rows) == 8
    # At-least-once on the queue leg: >= is the contract.
    assert raw.queue_length("q-0") >= 8
