"""The scenarios of tests/test_jobs_e2e.py through both pipelines: the
reference's FakePod + MemoryStateStore and the port's, on the same pool
and jobs YAML (a GPU pool of four a3-highgpu-1g nodes). Each scenario is
one case; both packages must agree on task states, exit codes, retry
counts, dependency order and outputs, the gang's env lines mapped across
(the reference's JAX_* rendezvous, the port's torch.distributed one)."""

import json
import time
import types

import pytest

from batch_shipyard_tpu.config import settings as ref_settings
from batch_shipyard_tpu.jobs import manager as ref_jobs
from batch_shipyard_tpu.pool import manager as ref_pool
from batch_shipyard_tpu.state import names as ref_names
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu.substrate.fakepod import FakePodSubstrate as RefPod
from batch_shipyard_tpu_torch.config import settings as port_settings
from batch_shipyard_tpu_torch.jobs import manager as port_jobs
from batch_shipyard_tpu_torch.pool import manager as port_pool
from batch_shipyard_tpu_torch.state import names as port_names
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

POOL_CONF = {"pool_specification": {
    "id": "pool1", "substrate": "fake",
    "vm_configuration": {"vm_size": "a3-highgpu-1g",
                         "vm_count": {"dedicated": 4}},
    "inter_node_communication_enabled": True,
    "max_wait_time_seconds": 30}}

PACKAGES = {
    "reference": types.SimpleNamespace(
        settings=ref_settings, jobs=ref_jobs, pool=ref_pool,
        names=ref_names, store=RefStore, substrate=RefPod,
        rank="$JAX_PROCESS_ID", world="$JAX_NUM_PROCESSES",
        coordinator="$JAX_COORDINATOR_ADDRESS"),
    "port": types.SimpleNamespace(
        settings=port_settings, jobs=port_jobs, pool=port_pool,
        names=port_names, store=MemoryStateStore, substrate=FakePodSubstrate,
        rank="$RANK", world="$WORLD_SIZE",
        coordinator="$MASTER_ADDR:$MASTER_PORT"),
}


def _wait_until(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    value = fn()
    while not value and time.monotonic() < deadline:
        time.sleep(0.1)
        value = fn()
    return value


def _states(pkg, store, job_id, timeout=30):
    tasks = pkg.jobs.wait_for_tasks(store, "pool1", job_id, timeout=timeout)
    return {t["_rk"]: (t["state"], t.get("exit_code"), t.get("retries"))
            for t in tasks}


def _out(pkg, store, job_id, task_id, instance=None):
    return pkg.jobs.get_task_output(store, "pool1", job_id, task_id,
                                    instance=instance).strip()


def _submit(pkg, store, pool, jobs_conf):
    return pkg.jobs.add_jobs(store, pool,
                             pkg.settings.job_settings_list(jobs_conf))


def single_task_runs_and_streams_output(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "job1",
        "tasks": [{"command": "echo hello from $SHIPYARD_TASK_ID"}]}]})
    states = _states(pkg, store, "job1")
    assert states == {"task-00000": ("completed", 0, 0)}
    return states, _out(pkg, store, "job1", "task-00000")


def task_env_contract(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jenv", "environment_variables": {"MYVAR": "42"},
        "tasks": [{"command":
                   "echo $MYVAR $SHIPYARD_POOL_ID $SHIPYARD_JOB_ID"}]}]})
    states = _states(pkg, store, "jenv")
    out = _out(pkg, store, "jenv", "task-00000")
    assert out == b"42 pool1 jenv"
    return states, out


def failing_task_retries_then_quarantines(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jfail",
        "tasks": [{"command": "exit 3", "max_task_retries": 2}]}]})
    tasks = pkg.jobs.wait_for_tasks(store, "pool1", "jfail", timeout=30)
    task = tasks[0]
    assert task["state"] == pkg.names.TASK_STATE_QUARANTINED
    history = [a["exit_code"]
               for a in task["diagnostics"]["attempt_history"]]
    assert history == [3, 3, 3]
    return task["state"], task["exit_code"], task["retries"], history


def task_dependencies_order(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jdep",
        "tasks": [{"id": "a", "command": "echo A"},
                  {"id": "b", "command": "echo B", "depends_on": ["a"]},
                  {"id": "c", "command": "echo C", "depends_on": ["b"]}]}]})
    tasks = {t["_rk"]: t for t in pkg.jobs.wait_for_tasks(
        store, "pool1", "jdep", timeout=30)}
    order = sorted(tasks, key=lambda k: tasks[k]["started_at"])
    assert tasks["a"]["completed_at"] <= tasks["b"]["started_at"]
    assert tasks["b"]["completed_at"] <= tasks["c"]["started_at"]
    return ({k: t["state"] for k, t in tasks.items()}, order,
            [_out(pkg, store, "jdep", k) for k in order])


def dependency_on_failed_task_blocks(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jblock",
        "tasks": [{"id": "bad", "command": "exit 1"},
                  {"id": "child", "command": "echo never",
                   "depends_on": ["bad"]}]}]})
    states = _states(pkg, store, "jblock")
    assert states["bad"][0] == "failed"
    assert states["child"][0] == "blocked"
    return states


def dependency_action_satisfy_runs_child(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jsat",
        "tasks": [{"id": "bad", "command": "exit 1",
                   "exit_conditions": {"default": {"exit_options": {
                       "dependency_action": "satisfy"}}}},
                  {"id": "child", "command": "echo ran",
                   "depends_on": ["bad"]}]}]})
    states = _states(pkg, store, "jsat")
    assert states["child"][0] == "completed"
    return states, _out(pkg, store, "jsat", "child")


def wall_time_enforcement(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jwall",
        "tasks": [{"command": "sleep 30", "max_wall_time_seconds": 1}]}]})
    task = pkg.jobs.wait_for_tasks(store, "pool1", "jwall", timeout=30)[0]
    assert task["state"] == "failed" and task["timed_out"]
    return task["state"], task["timed_out"]


def job_prep_runs_once_per_node(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jp", "job_preparation": {"command": "echo prep"},
        "tasks": [{"id": f"t{i}", "command": "echo x"}
                  for i in range(6)]}]})
    states = _states(pkg, store, "jp")
    rows = list(store.query_entities(
        pkg.names.TABLE_JOBPREP,
        partition_key=pkg.names.task_pk("pool1", "jp")))
    assert 1 <= len(rows) <= 4
    return states, {r["state"] for r in rows}


def auto_complete_and_job_release(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jac", "auto_complete": True,
        "job_preparation": {"command": "echo prep"},
        "job_release": {"command": "echo release"},
        "tasks": [{"command": "echo done"}]}]})
    states = _states(pkg, store, "jac")
    done = _wait_until(lambda: pkg.jobs.get_job(
        store, "pool1", "jac")["state"] == "completed", 10)
    assert done
    return states, pkg.jobs.get_job(store, "pool1", "jac")["state"]


def parametric_sweep_fanout(pkg, store, pool):
    counts = _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jsweep",
        "tasks": [{"command": "echo {0}-{1}",
                   "task_factory": {"parametric_sweep": {
                       "generator": "product",
                       "product": [{"start": 0, "stop": 2, "step": 1},
                                   {"values": ["x", "y", "z"]}]}}}]}]})
    states = _states(pkg, store, "jsweep")
    outs = {k: _out(pkg, store, "jsweep", k) for k in states}
    assert set(outs.values()) == {b"0-x", b"0-y", b"0-z", b"1-x", b"1-y",
                                  b"1-z"}
    return counts["jsweep"], states, outs


def gang_task_rendezvous_and_distributed_env(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jgang",
        "tasks": [{
            "command": (f"echo {pkg.rank}/{pkg.world} {pkg.coordinator} "
                        f"$SHIPYARD_HOST_LIST"),
            "multi_instance": {
                "num_instances": 4, "coordination_command": "echo coord",
                "jax_distributed": {"enabled": True,
                                    "transport": "ici"}}}]}]})
    states = _states(pkg, store, "jgang", timeout=60)
    lines = []
    for k in range(4):
        rank, coord, hosts = _out(pkg, store, "jgang", "task-00000",
                                  instance=k).decode().split(" ")
        assert len(hosts.split(",")) == 4
        lines.append((rank, coord))
    assert {rank for rank, _ in lines} == {"0/4", "1/4", "2/4", "3/4"}
    assert len({coord for _, coord in lines}) == 1
    assert lines[0][1].split(":")[1] == "8476"
    return states, sorted(lines)


def gang_multislice_env(pkg, store, pool):
    """A GPU pool is one flat gang: neither package sets MEGASCALE_* on
    it, and both give every member the gang's size."""
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jms",
        "tasks": [{
            "command": (f"echo \"$MEGASCALE_NUM_SLICES|"
                        f"$MEGASCALE_SLICE_ID|{pkg.world}\""),
            "multi_instance": {
                "num_instances": 4,
                "jax_distributed": {"enabled": True,
                                    "transport": "auto"}}}]}]})
    states = _states(pkg, store, "jms", timeout=60)
    outs = [_out(pkg, store, "jms", "task-00000", instance=k)
            for k in range(4)]
    assert outs == [b"||4"] * 4
    return states, outs


def terminate_job(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jterm", "tasks": [{"command": "sleep 60"}]}]})
    time.sleep(0.5)
    pkg.jobs.terminate_job(store, "pool1", "jterm")
    state = pkg.jobs.get_job(store, "pool1", "jterm")["state"]
    assert state == "terminated"
    return state


def job_stats(pkg, store, pool):
    _submit(pkg, store, pool, {"job_specifications": [{
        "id": "jstats",
        "tasks": [{"command": "echo 1"}, {"command": "exit 1"}]}]})
    states = _states(pkg, store, "jstats")
    stats = pkg.jobs.job_stats(store, "pool1")
    assert stats["tasks"] == 2
    return states, stats["tasks"], stats["by_state"]


def orphaned_task_reclaimed_from_dead_node(pkg, store, pool):
    names = pkg.names
    pk = names.task_pk("pool1", "jorph")
    store.insert_entity(names.TABLE_JOBS, "pool1", "jorph",
                        {"state": "active", "spec": {}})
    store.insert_entity(names.TABLE_TASKS, pk, "t0", {
        "state": "running", "node_id": "ghost-node",
        "spec": {"command": "echo reclaimed", "runtime": "none"},
        "retries": 0})
    store.upsert_entity(names.TABLE_NODES, "pool1", "ghost-node", {
        "state": "running", "heartbeat_at": 0.0})
    store.put_message(names.task_queue("pool1"), json.dumps(
        {"job_id": "jorph", "task_id": "t0"}).encode())
    task = pkg.jobs.wait_for_tasks(store, "pool1", "jorph", timeout=30)[0]
    assert task["node_id"] != "ghost-node"
    return task["state"], task["exit_code"], _out(pkg, store, "jorph", "t0")


def broken_gang_fails_fast(pkg, store, pool):
    names = pkg.names
    pk = names.task_pk("pool1", "jghost")
    store.insert_entity(names.TABLE_JOBS, "pool1", "jghost",
                        {"state": "active", "spec": {}})
    spec = {"command": "echo never", "runtime": "none",
            "multi_instance": {"num_instances": 4,
                               "jax_distributed": {"enabled": True}}}
    store.insert_entity(names.TABLE_TASKS, pk, "g0",
                        {"state": "pending", "spec": spec, "retries": 0})
    gang_pk = names.gang_pk("pool1", "jghost", "g0")
    store.insert_entity(names.TABLE_GANGS, gang_pk, "i0", {
        "node_id": "ghost-node", "hostname": "ghost",
        "internal_ip": "10.9.9.9", "slice_index": 0,
        "worker_index": 0, "state": "joined"})
    store.insert_entity(names.TABLE_GANGS, gang_pk, "node$ghost-node",
                        {"instance": 0})
    store.upsert_entity(names.TABLE_NODES, "pool1", "ghost-node", {
        "state": "running", "heartbeat_at": 0.0})
    for k in range(4):
        store.put_message(names.task_queue("pool1"), json.dumps(
            {"job_id": "jghost", "task_id": "g0", "instance": k}).encode())
    task = _wait_until(lambda: (lambda t: t if t.get("state") == "failed"
                                else None)(pkg.jobs.get_task(
                                    store, "pool1", "jghost", "g0")))
    assert task and "gang member" in task.get("error", "")
    return task["state"], "gang member" in task["error"]


def gang_done_member_crash_finalized_by_peer(pkg, store, pool):
    names = pkg.names
    pk = names.task_pk("pool1", "jdone")
    store.insert_entity(names.TABLE_JOBS, "pool1", "jdone",
                        {"state": "active", "spec": {}})
    spec = {"command": "echo x", "runtime": "none",
            "multi_instance": {"num_instances": 2,
                               "jax_distributed": {"enabled": False}}}
    store.insert_entity(names.TABLE_TASKS, pk, "g1",
                        {"state": "running", "spec": spec, "retries": 0})
    gang_pk = names.gang_pk("pool1", "jdone", "g1")
    for k, node in ((0, "ghost-a"), (1, "ghost-b")):
        store.insert_entity(names.TABLE_GANGS, gang_pk, f"i{k}", {
            "node_id": node, "hostname": node, "internal_ip": "10.0.0.9",
            "slice_index": 0, "worker_index": k, "state": "done",
            "exit_code": 0})
        store.insert_entity(names.TABLE_GANGS, gang_pk, f"node${node}",
                            {"instance": k})
    store.put_message(names.task_queue("pool1"), json.dumps(
        {"job_id": "jdone", "task_id": "g1", "instance": 1}).encode())
    task = _wait_until(lambda: (lambda t: t if t.get("state") ==
                                "completed" else None)(pkg.jobs.get_task(
                                    store, "pool1", "jdone", "g1")))
    assert task
    return task["state"], task["exit_code"]


SCENARIOS = [
    single_task_runs_and_streams_output, task_env_contract,
    failing_task_retries_then_quarantines, task_dependencies_order,
    dependency_on_failed_task_blocks, dependency_action_satisfy_runs_child,
    wall_time_enforcement, job_prep_runs_once_per_node,
    auto_complete_and_job_release, parametric_sweep_fanout,
    gang_task_rendezvous_and_distributed_env, gang_multislice_env,
    terminate_job, job_stats, orphaned_task_reclaimed_from_dead_node,
    broken_gang_fails_fast, gang_done_member_crash_finalized_by_peer,
]


def _run(pkg, scenario):
    store = pkg.store()
    substrate = pkg.substrate(store)
    pool = pkg.settings.pool_settings(POOL_CONF)
    pkg.pool.create_pool(store, substrate, pool,
                         pkg.settings.global_settings({}), POOL_CONF)
    try:
        return scenario(pkg, store, pool)
    finally:
        substrate.stop_all()


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_agrees_with_the_reference(scenario):
    want = _run(PACKAGES["reference"], scenario)
    got = _run(PACKAGES["port"], scenario)
    assert got == want
