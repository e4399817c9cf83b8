"""The port's pool services against the reference's: job schedules
(registration, due runs, instance ids, run_exclusive, the daemon loops)
and autoscale (scenario and formula targets, tick), each decision taken
by both packages under one injected clock on the same store contents;
autoscale's targets are node counts (a GPU pool is one slice of
``vm_count`` nodes); and node 0's agent, and no other, runs both
services when pool_services asks for them."""

import datetime
import threading
import time

import pytest

from batch_shipyard_tpu.config import settings as ref_settings
from batch_shipyard_tpu.jobs import schedules as ref_schedules
from batch_shipyard_tpu.pool import autoscale as ref_autoscale
from batch_shipyard_tpu.pool import manager as ref_pool_mgr
from batch_shipyard_tpu.state import names as ref_names
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu.substrate.fakepod import (
    FakePodSubstrate as RefFakePod)
from batch_shipyard_tpu_torch.config import settings
from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
from batch_shipyard_tpu_torch.jobs import schedules
from batch_shipyard_tpu_torch.pool import autoscale
from batch_shipyard_tpu_torch.pool import manager as pool_mgr
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

PKGS = {
    "port": {"settings": settings, "schedules": schedules,
             "autoscale": autoscale, "pool_mgr": pool_mgr, "names": names,
             "store": MemoryStateStore, "fake": FakePodSubstrate},
    "ref": {"settings": ref_settings, "schedules": ref_schedules,
            "autoscale": ref_autoscale, "pool_mgr": ref_pool_mgr,
            "names": ref_names, "store": RefStore, "fake": RefFakePod},
}
MONDAY_NOON = datetime.datetime(2026, 7, 27, 12, 0)
SUNDAY = datetime.datetime(2026, 7, 26, 12, 0)


def _pool_conf(pool_id="ap", nodes=1, slots=2, **extra):
    spec = {"id": pool_id, "substrate": "fake",
            "vm_configuration": {"vm_size": "a3-highgpu-1g",
                                 "vm_count": {"dedicated": nodes}},
            "task_slots_per_node": slots, "max_wait_time_seconds": 30}
    spec.update(extra)
    return {"pool_specification": spec}


def _seed_tasks(store, nm, pool_id, pending=0, running=0):
    store.insert_entity(nm.TABLE_JOBS, pool_id, "j",
                        {"state": "active", "spec": {}})
    pk = nm.task_pk(pool_id, "j")
    for idx in range(pending):
        store.insert_entity(nm.TABLE_TASKS, pk, f"p{idx}",
                            {"state": "pending", "spec": {}})
    for idx in range(running):
        store.insert_entity(nm.TABLE_TASKS, pk, f"r{idx}",
                            {"state": "running", "spec": {}})


def _seed_nodes(store, nm, pool_id, count, state="idle", first=0):
    for idx in range(first, first + count):
        store.upsert_entity(nm.TABLE_NODES, pool_id, f"n{idx}", {
            "state": state, "node_index": idx, "slice_index": 0,
            "worker_index": idx, "heartbeat_at": 1e18,
            "hostname": f"n{idx}", "internal_ip": "10.0.0.1"})


# --------------------------------- autoscale ----------------------------

# (autoscale block, nodes, pending, running, preempted, now): each taken
# by both packages on the same store contents.
DECISIONS = {
    "pending_tasks": ({"scenario": {
        "name": "pending_tasks", "maximum_vm_count": {"dedicated": 16},
        "bias_last_sample": False}}, 4, 20, 0, 0, None),
    "pending_biased": ({"scenario": {
        "name": "pending_tasks", "maximum_vm_count": {"dedicated": 16}}},
        4, 20, 0, 0, None),
    "active_tasks_to_minimum": ({"scenario": {
        "name": "active_tasks", "minimum_vm_count": {"dedicated": 4},
        "maximum_vm_count": {"dedicated": 16},
        "bias_last_sample": False}}, 8, 0, 0, 0, None),
    "active_tasks": ({"scenario": {
        "name": "active_tasks", "maximum_vm_count": {"dedicated": 16},
        "bias_last_sample": False}}, 2, 3, 9, 0, None),
    "max_increment": ({"scenario": {
        "name": "pending_tasks", "maximum_vm_count": {"dedicated": 64},
        "maximum_vm_increment_per_evaluation": {"dedicated": 4},
        "bias_last_sample": False}}, 4, 100, 0, 0, None),
    "workday_monday": ({"scenario": {
        "name": "workday", "minimum_vm_count": {"dedicated": 0},
        "maximum_vm_count": {"dedicated": 8}}}, 0, 0, 0, 0, MONDAY_NOON),
    "workday_sunday": ({"scenario": {
        "name": "workday", "minimum_vm_count": {"dedicated": 0},
        "maximum_vm_count": {"dedicated": 8}}}, 0, 0, 0, 0, SUNDAY),
    "weekend": ({"scenario": {
        "name": "weekend", "minimum_vm_count": {"dedicated": 1},
        "maximum_vm_count": {"dedicated": 5}}}, 2, 0, 0, 0, SUNDAY),
    "offpeak_calm": ({"scenario": {
        "name": "workday_with_offpeak_max_low_priority",
        "minimum_vm_count": {"dedicated": 2, "low_priority": 0},
        "maximum_vm_count": {"dedicated": 12, "low_priority": 8},
        "rebalance_preemption_percentage": 25}}, 4, 0, 0, 0, SUNDAY),
    "offpeak_rebalanced": ({"scenario": {
        "name": "workday_with_offpeak_max_low_priority",
        "minimum_vm_count": {"dedicated": 2, "low_priority": 0},
        "maximum_vm_count": {"dedicated": 12, "low_priority": 8},
        "rebalance_preemption_percentage": 25}}, 4, 0, 0, 2, SUNDAY),
    "goodput": ({"scenario": {
        "name": "goodput", "maximum_vm_count": {"dedicated": 32}}},
        2, 40, 4, 0, None),
    "formula": ({"formula": "min(16, pending_tasks * 2)"}, 0, 3, 0, 0,
                None),
    "formula_clock": ({"formula": "8 if hour >= 9 and weekday < 5 else 1"},
                      1, 0, 0, 0, MONDAY_NOON),
    "no_scenario": ({}, 3, 5, 0, 0, None),
}


def _decide(pkg, block, nodes, pending, running, preempted, now):
    mods = PKGS[pkg]
    store = mods["store"]()
    pool = mods["settings"].pool_settings(_pool_conf(
        autoscale=dict(block, enabled=True)))
    _seed_nodes(store, mods["names"], "ap", nodes)
    _seed_nodes(store, mods["names"], "ap", preempted, state="preempted",
                first=100)
    _seed_tasks(store, mods["names"], "ap", pending, running)
    return mods["autoscale"].evaluate(
        store, pool, now=now or MONDAY_NOON)


@pytest.mark.parametrize("name", sorted(DECISIONS))
def test_decisions_equal_the_references(name):
    got = _decide("port", *DECISIONS[name])
    assert got == _decide("ref", *DECISIONS[name])
    assert got["target_slices"] is None


def test_targets_are_node_counts():
    """A GPU pool's target is a count of nodes, not rounded to any slice
    (20 pending tasks at 2 slots a node: 10 nodes)."""
    assert _decide("port", *DECISIONS["pending_tasks"])[
        "target_nodes"] == 10
    assert _decide("port", *DECISIONS["max_increment"])[
        "target_nodes"] == 8
    assert _decide("port", *DECISIONS["formula"])["target_nodes"] == 6
    assert _decide("port", *DECISIONS["workday_monday"])[
        "target_nodes"] == 8
    assert _decide("port", *DECISIONS["workday_sunday"])[
        "target_nodes"] == 0
    hot = _decide("port", *DECISIONS["offpeak_rebalanced"])
    assert hot["rebalance"] and hot["preempted_nodes"] == 2
    assert "rebalanced to dedicated" in hot["reason"]
    assert "node count" in autoscale.__doc__.replace("\n", " ")


@pytest.mark.parametrize("formula", [
    "__import__('os').system('true')",
    "().__class__.__bases__[0].__subclasses__()",
    "[x for x in (1,)][0]", "lambda: 1", "unknown_name + 1"])
def test_unsafe_formulas_raise_in_both(formula):
    for pkg in PKGS:
        with pytest.raises(ValueError):
            _decide(pkg, {"formula": formula}, 1, 0, 0, 0, None)


def test_tick_resizes_a_fake_pool_by_nodes():
    """tick on each package's fake pool of one node, 5 pending tasks at
    one slot a node: the same decision, applied as 5 nodes."""
    out = {}
    for pkg, mods in PKGS.items():
        store = mods["store"]()
        substrate = mods["fake"](store)
        conf = _pool_conf(slots=1, autoscale={
            "enabled": True, "scenario": {
                "name": "pending_tasks",
                "maximum_vm_count": {"dedicated": 8},
                "bias_last_sample": False}})
        pool = mods["settings"].pool_settings(conf)
        try:
            mods["pool_mgr"].create_pool(
                store, substrate, pool, mods["settings"].global_settings({}),
                conf)
            idle = mods["autoscale"].autoscale_tick(store, substrate, pool,
                                                    now=MONDAY_NOON)
            mods["autoscale"].enable_autoscale(store, pool)
            _seed_tasks(store, mods["names"], "ap", pending=5)
            decision = mods["autoscale"].autoscale_tick(
                store, substrate, pool, now=MONDAY_NOON)
            nodes = len(mods["pool_mgr"].list_nodes(store, "ap"))
            # The added nodes boot; the next tick samples them ready.
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and sum(
                    n.state in mods["pool_mgr"].READY_STATES
                    for n in mods["pool_mgr"].list_nodes(store, "ap")) < 5:
                time.sleep(0.05)
            again = mods["autoscale"].autoscale_tick(
                store, substrate, pool, now=MONDAY_NOON)
        finally:
            substrate.stop_all()
        out[pkg] = (idle, decision, nodes, again)
    assert out["port"] == out["ref"]
    idle, decision, nodes, again = out["port"]
    assert not idle["applied"]
    assert decision["applied"] and decision["target_nodes"] == 5
    assert nodes == 5
    assert not again["applied"]


def test_preemption_bookkeeping_equals_the_references():
    """_record_preemptions on each package's store: one marker as the
    count rises, none on a repeat, one outage span on recovery."""
    kinds = {}
    for pkg, mods in PKGS.items():
        store = mods["store"]()
        store.upsert_entity("pools", "pools", "p1", {"state": "ready"})
        for count in (2, 2, 0):
            entity = store.get_entity("pools", "pools", "p1")
            mods["autoscale"]._record_preemptions(store, entity, "p1",
                                                  count)
        rows = store.query_entities(mods["names"].TABLE_GOODPUT,
                                    partition_key="p1")
        kinds[pkg] = sorted((r["kind"], r["end"] > r["start"],
                             sorted(r["attrs"])) for r in rows)
    assert kinds["port"] == kinds["ref"]
    assert [spans for _kind, spans, _attrs in kinds["port"]] == [
        False, True]


def test_run_daemon_applies_and_stops():
    store = MemoryStateStore()
    substrate = FakePodSubstrate(store)
    conf = _pool_conf(autoscale={"enabled": True, "formula": "3"})
    pool = settings.pool_settings(conf)
    stop = threading.Event()
    try:
        pool_mgr.create_pool(store, substrate, pool,
                             settings.global_settings({}), conf)
        autoscale.enable_autoscale(store, pool)
        thread = threading.Thread(
            target=autoscale.run_daemon, args=(store, substrate, pool),
            kwargs={"stop_event": stop, "interval": 0.05}, daemon=True)
        thread.start()
        deadline = time.monotonic() + 20
        while len(pool_mgr.list_nodes(store, "ap")) != 3 and \
                time.monotonic() < deadline:
            stop.wait(0.05)
        stop.set()
        thread.join(timeout=10)
        assert not thread.is_alive()
        assert len(pool_mgr.list_nodes(store, "ap")) == 3
    finally:
        stop.set()
        substrate.stop_all()


# --------------------------------- schedules ----------------------------

def _schedule_env(pkg):
    """A pool of no nodes: instances are submitted and stay active."""
    mods = PKGS[pkg]
    store = mods["store"]()
    substrate = mods["fake"](store)
    conf = _pool_conf(pool_id="sp", nodes=0)
    pool = mods["settings"].pool_settings(conf)
    mods["pool_mgr"].create_pool(store, substrate, pool,
                                 mods["settings"].global_settings({}), conf)
    return store, substrate, pool


def _jobs(pkg, exclusive=False, **schedule):
    recurrence = {"schedule": dict({"recurrence_interval_seconds": 1},
                                   **schedule)}
    if exclusive:
        recurrence["job_manager"] = {"run_exclusive": True,
                                     "monitor_task_completion": True}
    return PKGS[pkg]["settings"].job_settings_list({"job_specifications": [
        {"id": "sched", "recurrence": recurrence,
         "tasks": [{"command": "echo tick"}]},
        {"id": "plain", "tasks": [{"command": "echo once"}]}]})


@pytest.mark.parametrize("exclusive", [False, True])
def test_due_runs_and_instance_ids_equal_the_references(exclusive):
    """The same instances at the same injected times from both packages;
    run_exclusive holds the next while the last is still active."""
    t0 = 1_800_000_000.0
    times = (t0, t0 + 0.2, t0 + 1.5, t0 + 3.0)
    out = {}
    for pkg in PKGS:
        store, substrate, pool = _schedule_env(pkg)
        try:
            jobs = _jobs(pkg, exclusive)
            out[pkg] = [PKGS[pkg]["schedules"].run_due_schedules(
                store, pool, jobs, now=now) for now in times]
            state = PKGS[pkg]["schedules"].schedule_state(store, "sp",
                                                          "sched")
            out[pkg].append({k: state[k] for k in (
                "run_number", "last_run_at", "active_instance")})
        finally:
            substrate.stop_all()
    assert out["port"] == out["ref"]
    if exclusive:
        assert out["port"][:4] == [["sched-r00000"], [], [], []]
    else:
        assert out["port"][:4] == [["sched-r00000"], [],
                                   ["sched-r00001"], ["sched-r00002"]]
    assert schedules.instance_id("sched", 7) == \
        ref_schedules.instance_id("sched", 7) == "sched-r00007"


def test_window_bounds_equal_the_references():
    bounds = {"do_not_run_until": "2027-01-15T08:00:00Z",
              "do_not_run_after": "2027-01-15T09:00:00Z"}
    until = datetime.datetime(2027, 1, 15, 8, tzinfo=datetime.timezone.utc
                              ).timestamp()
    t0 = until - 3600
    out = {}
    for pkg in PKGS:
        store, substrate, pool = _schedule_env(pkg)
        try:
            jobs = _jobs(pkg, **bounds)
            out[pkg] = [PKGS[pkg]["schedules"].run_due_schedules(
                store, pool, jobs, now=now)
                for now in (t0, until + 1, until + 7200)]
        finally:
            substrate.stop_all()
    assert out["port"] == out["ref"] == [[], ["sched-r00000"], []]


def test_registration_equals_the_references():
    config = {"job_specifications": [
        {"id": "recur", "recurrence": {"schedule": {
            "recurrence_interval_seconds": 60}},
         "tasks": [{"command": "true"}]},
        {"id": "once", "tasks": [{"command": "true"}]}]}
    out = {}
    for pkg, mods in PKGS.items():
        store = mods["store"]()
        registered = mods["schedules"].register_schedules(store, "sp",
                                                          config)
        stored = mods["schedules"].stored_schedule_jobs(store, "sp")
        out[pkg] = (registered, [(j.id, j.recurrence.
                                  recurrence_interval_seconds)
                                 for j in stored])
        mods["schedules"].unregister_schedule(store, "sp", "recur")
        assert mods["schedules"].stored_schedule_jobs(store, "sp") == []
    assert out["port"] == out["ref"] == (["recur"], [("recur", 60)])
    with pytest.raises(ValueError, match="recurrence_interval_seconds"):
        schedules.register_schedules(MemoryStateStore(), "sp", {
            "job_specifications": [{"id": "bad", "recurrence": {
                "schedule": {}}, "tasks": [{"command": "true"}]}]})


def test_schedule_daemon_stops_at_max_recurrences():
    store, substrate, pool = _schedule_env("port")
    try:
        launched = schedules.run_schedule_daemon(
            store, pool, _jobs("port")[:1], poll_interval=0.05,
            max_recurrences=1)
        assert launched == 1
        assert jobs_mgr.get_job(store, "sp", "sched-r00000")
    finally:
        substrate.stop_all()


# ------------------------------ on node 0 -------------------------------

def _service_threads(substrate, pool_id):
    """The service threads each node's agent started, once its boot
    (agent.start(), which starts them last) has returned."""
    out = {}
    for node in pool_mgr.list_nodes(substrate.store, pool_id):
        boot = substrate._boot_threads[node.node_id]
        boot.join(timeout=10)
        assert not boot.is_alive()
        agent = substrate.agent(pool_id, node.node_id)
        out[node.node_id] = sorted(
            t.name.split("-")[1] for t in agent._threads
            if t.name.startswith("svc-") and t.is_alive())
    return out


def test_node_zero_runs_both_services_and_no_other_node_does():
    """pool_services on a fake pool of two nodes: node 0's agent runs the
    schedule service (a registered 1 s recurrence fires with no CLI) and
    the autoscale service (formula 3 grows the pool to 3 nodes); node 1
    runs neither."""
    conf = _pool_conf(pool_id="svcpool", nodes=2, autoscale={
        "enabled": True, "formula": "3"}, pool_services={
            "schedules": True, "autoscale": True,
            "poll_interval_seconds": 0.1})
    store = MemoryStateStore()
    substrate = FakePodSubstrate(store)
    pool = settings.pool_settings(conf)
    try:
        pool_mgr.create_pool(store, substrate, pool,
                             settings.global_settings({}), conf)
        threads = _service_threads(substrate, "svcpool")
        assert threads == {"svcpool-s0-w0": ["as", "sched"],
                           "svcpool-s0-w1": []}
        schedules.register_schedules(store, "svcpool", {
            "job_specifications": [{
                "id": "recurjob", "recurrence": {"schedule": {
                    "recurrence_interval_seconds": 1}},
                "tasks": [{"command": "true"}]}]})
        autoscale.enable_autoscale(store, pool)
        deadline = time.monotonic() + 30
        seen = set()
        while time.monotonic() < deadline and (
                len(seen) < 2 or
                len(pool_mgr.list_nodes(store, "svcpool")) != 3):
            seen = {row["_rk"] for row in store.query_entities(
                names.TABLE_JOBS, partition_key="svcpool")
                if row["_rk"].startswith("recurjob-r")}
            time.sleep(0.1)
        assert len(seen) >= 2
        assert len(pool_mgr.list_nodes(store, "svcpool")) == 3
        # The node autoscale added (index 2) runs no service either.
        assert _service_threads(substrate, "svcpool")[
            "svcpool-s0-w2"] == []
    finally:
        substrate.stop_all()


def test_no_services_without_pool_services():
    conf = _pool_conf(pool_id="plainpool", nodes=1)
    store = MemoryStateStore()
    substrate = FakePodSubstrate(store)
    pool = settings.pool_settings(conf)
    try:
        pool_mgr.create_pool(store, substrate, pool,
                             settings.global_settings({}), conf)
        assert _service_threads(substrate, "plainpool") == {
            "plainpool-s0-w0": []}
    finally:
        substrate.stop_all()
