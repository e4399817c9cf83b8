"""The self-healing scenarios of tests/test_chaos_recovery.py:85-711
through both packages, each on its own FakePod pool and
MemoryStateStore, in the style of tests/test_torch_jobs_e2e.py: the wedge
watchdog, progress beats and their throttle, the retry supervisor's
backoff, poison quarantine and its diagnostics, node health scores,
quarantine and probation, checkpoint-aware gang requeue, broken and
abandoned gangs, the registration grace and the orphaned-gang janitor.
Each scenario makes the reference test's assertions (with its timeouts)
and returns what the two packages must agree on. The pools are GPU
pools of a3-highgpu-1g nodes, one node a host of the reference's slice
(v5litepod-8: two, v5litepod-16: four, v5litepod-4: one)."""

import datetime
import json
import os
import signal
import time
import types

import pytest

from batch_shipyard_tpu import fleet as ref_fleet
from batch_shipyard_tpu.agent import progress as ref_progress
from batch_shipyard_tpu.config import settings as ref_settings
from batch_shipyard_tpu.jobs import manager as ref_jobs
from batch_shipyard_tpu.pool import manager as ref_pool
from batch_shipyard_tpu.state import names as ref_names
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu.substrate.fakepod import FakePodSubstrate as RefPod
from batch_shipyard_tpu_torch import fleet as port_fleet
from batch_shipyard_tpu_torch.agent import progress as port_progress
from batch_shipyard_tpu_torch.config import settings as port_settings
from batch_shipyard_tpu_torch.jobs import manager as port_jobs
from batch_shipyard_tpu_torch.pool import manager as port_pool
from batch_shipyard_tpu_torch.state import names as port_names
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

PACKAGES = {
    "reference": types.SimpleNamespace(
        settings=ref_settings, jobs=ref_jobs, pool=ref_pool,
        names=ref_names, store=RefStore, substrate=RefPod,
        fleet=ref_fleet, progress=ref_progress),
    "port": types.SimpleNamespace(
        settings=port_settings, jobs=port_jobs, pool=port_pool,
        names=port_names, store=MemoryStateStore,
        substrate=FakePodSubstrate, fleet=port_fleet,
        progress=port_progress),
}
FAST_RETRY = {"retry_backoff_base": 0.2, "retry_backoff_cap": 1.0}


class Pool:
    """A pool of ``nodes`` GPU nodes on a fresh store of ``pkg``."""

    def __init__(self, pkg, pool_id, nodes=2, slots=2, stale=3.0,
                 agent_kwargs=FAST_RETRY):
        self.pkg = pkg
        self.id = pool_id
        conf = {"pool_specification": {
            "id": pool_id, "substrate": "fake",
            "vm_configuration": {"vm_size": "a3-highgpu-1g",
                                 "vm_count": {"dedicated": nodes}},
            "task_slots_per_node": slots,
            "max_wait_time_seconds": 30}}
        self.store = pkg.store()
        self.substrate = pkg.substrate(self.store, node_stale_seconds=stale)
        self.substrate.agent_kwargs = dict(agent_kwargs)
        self.pool = pkg.settings.pool_settings(conf)
        pkg.pool.create_pool(self.store, self.substrate, self.pool,
                             pkg.settings.global_settings({}), conf)

    def submit(self, jobs_conf):
        return self.pkg.jobs.add_jobs(
            self.store, self.pool,
            self.pkg.settings.job_settings_list(jobs_conf))

    def wait(self, job_id, timeout=30):
        return self.pkg.jobs.wait_for_tasks(self.store, self.id, job_id,
                                            timeout=timeout,
                                            poll_interval=0.2)

    def agents(self):
        return _poll(lambda: list(self.substrate._agents.get(
            self.id, {}).values()), timeout=15, message="agents booted")

    def gang_rows(self):
        return list(self.store.query_entities(self.pkg.names.TABLE_GANGS))


def _poll(predicate, timeout: float, interval: float = 0.1,
          message: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {message}")


def wedge_watchdog_kills_and_retry_completes(p, tmp):
    marker = tmp / "attempted"
    start = time.monotonic()
    p.submit({"job_specifications": [{"id": "wedge", "tasks": [{
        "id": "t0",
        "command": (f"if [ -f {marker} ]; then echo healed; else "
                    f"touch {marker} && sleep 60; fi"),
        "progress_deadline_seconds": 1, "max_task_retries": 2}]}]})
    task = p.wait("wedge")[0]
    elapsed = time.monotonic() - start
    out = p.pkg.jobs.get_task_output(p.store, p.id, "wedge", "t0")
    history = task.get("attempt_history") or []
    assert elapsed < 25, elapsed
    return (task["state"], task["retries"], out.strip(),
            any("wedged" in (a.get("reason") or "") for a in history))


def progress_beats_defeat_the_watchdog(p, tmp):
    cmd = ("for i in 1 2 3 4 5 6; do "
           "touch $SHIPYARD_PROGRESS_FILE; sleep 0.5; done; echo steady")
    p.submit({"job_specifications": [{"id": "beats", "tasks": [{
        "id": "t0", "command": cmd, "progress_deadline_seconds": 1,
        "max_task_retries": 1}]}]})
    task = p.wait("beats")[0]
    return task["state"], bool(task.get("retries")), bool(task.get("wedged"))


def retry_backoff_stamps_not_before(p, tmp):
    marker = tmp / "failed-once"
    p.submit({"job_specifications": [{"id": "boff", "tasks": [{
        "id": "t0",
        "command": (f"if [ -f {marker} ]; then echo ok; else "
                    f"touch {marker} && exit 1; fi"),
        "max_task_retries": 3}]}]})
    entity = _poll(
        lambda: (e := p.pkg.jobs.get_task(
            p.store, p.id, "boff", "t0")).get("retries") and e,
        timeout=15, interval=0.05, message="first requeue")
    not_before = float(entity["not_before"])
    observed = time.time()
    task = p.wait("boff")[0]
    started = datetime.datetime.strptime(
        task["started_at"], "%Y-%m-%dT%H:%M:%S.%fZ").replace(
        tzinfo=datetime.timezone.utc).timestamp()
    # base 0.8 * 2^0 with +-25% jitter => [0.6, 1.0]s
    assert 0.0 < not_before - observed <= 1.1
    assert started >= not_before - 0.25
    return (entity["retries"], entity["last_exit_code"], task["state"])


def poison_quarantine_with_diagnostics(p, tmp):
    names = p.pkg.names
    p.submit({"job_specifications": [{"id": "poison", "tasks": [
        {"id": "bad", "command": "echo boom-stderr >&2; exit 3",
         "max_task_retries": 1},
        {"id": "good", "command": "echo fine"}]}]})
    tasks = {t["_rk"]: t for t in p.wait("poison")}
    bad = tasks["bad"]
    diag = bad["diagnostics"]
    history = diag["attempt_history"]
    emitted = {}
    ctx = type("Ctx", (), {"store": p.store, "pool": p.pool})()
    orig = p.pkg.fleet._emit
    p.pkg.fleet._emit = lambda data, raw=False: emitted.update(data)
    try:
        p.pkg.fleet.action_jobs_tasks_list(ctx, "poison", raw=True)
    finally:
        p.pkg.fleet._emit = orig
    shown = {t["id"]: t for t in emitted["tasks"]}
    stats = p.pkg.pool.pool_stats(p.store, p.id)
    assert bad["state"] == names.TASK_STATE_QUARANTINED
    return (tasks["good"]["state"], bad["state"], bad["exit_code"],
            "retry budget exhausted" in bad["error"],
            "boom-stderr" in diag["stderr_tail"],
            [a["exit_code"] for a in history],
            all(a.get("node_id") for a in history),
            shown["bad"]["diagnostics"]["exit_codes"],
            len(shown["bad"]["diagnostics"]["node_history"]),
            stats["tasks"][names.TASK_STATE_QUARANTINED])


def zero_budget_task_fails_plain(p, tmp):
    p.submit({"job_specifications": [{"id": "legacy", "tasks": [
        {"id": "t0", "command": "exit 7"}]}]})
    task = p.wait("legacy")[0]
    return task["state"], task["exit_code"]


def _pending_task(p, job_id, task_id):
    names = p.pkg.names
    pk = names.task_pk(p.id, job_id)
    p.store.insert_entity(names.TABLE_TASKS, pk, task_id,
                          {"state": "pending", "spec": {}})
    return p.store.get_entity(names.TABLE_TASKS, pk, task_id)


def node_health_quarantine_and_recovery(p, tmp):
    names = p.pkg.names
    agent = p.agents()[0]
    seen = [agent.node_quarantined()]
    for _ in range(3):
        agent._note_task_outcome(False, wedged=True)
    seen.append(agent.node_quarantined())
    node = _poll(
        lambda: (n := p.store.get_entity(
            names.TABLE_NODES, p.id, agent.identity.node_id)).get(
            names.NODE_COL_QUARANTINED) and n,
        timeout=10, message="quarantine column")
    entity = _pending_task(p, "jx", "tx")
    seen += [node[names.NODE_COL_HEALTH] < 0.25,
             agent._claim_regular("jx", "tx", entity) is None,
             agent._gang_claim(names.gang_pk(p.id, "jx", "tx"), 0)]
    for _ in range(3):
        agent._note_task_outcome(True)
    seen.append(agent.node_quarantined())
    entity = p.store.get_entity(names.TABLE_TASKS,
                                names.task_pk(p.id, "jx"), "tx")
    seen.append(agent._claim_regular("jx", "tx", entity) is not None)
    assert seen == [False, True, True, True, False, False, True]
    return seen


def node_quarantine_probation_release(p, tmp):
    agent = p.agents()[0]
    for _ in range(3):
        agent._note_task_outcome(False, wedged=True)
    seen = [agent.node_quarantined()]
    _poll(lambda: not agent.node_quarantined(), timeout=10,
          message="probation release")
    entity = _pending_task(p, "jp", "tp")
    seen.append(agent._claim_regular("jp", "tp", entity) is not None)
    agent._note_task_outcome(False)
    seen.append(agent.node_quarantined())
    assert seen == [True, True, True]
    return seen


def beat_throttle_scales_to_deadline(p, tmp):
    progress = p.pkg.progress
    saved = {k: os.environ.get(k) for k in (
        progress.PROGRESS_FILE_ENV, progress.PROGRESS_DEADLINE_ENV)}
    path = tmp / "beat"
    try:
        os.environ[progress.PROGRESS_FILE_ENV] = str(path)
        os.environ[progress.PROGRESS_DEADLINE_ENV] = "1"
        throttle = progress._throttle_seconds()
        progress._last_beat_at = 0.0
        progress.beat()
        first = path.stat().st_mtime
        time.sleep(0.3)
        progress.beat()
        advanced = path.stat().st_mtime > first
        del os.environ[progress.PROGRESS_DEADLINE_ENV]
        ceiling = progress._throttle_seconds() == progress.BEAT_INTERVAL
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    assert throttle == pytest.approx(0.25) and advanced and ceiling
    return throttle, advanced, ceiling, progress.BEAT_INTERVAL


def wedging_node_health_drops_e2e(p, tmp):
    names = p.pkg.names
    marker = tmp / "once"
    p.submit({"job_specifications": [{"id": "w", "tasks": [{
        "id": "t0",
        "command": (f"if [ -f {marker} ]; then echo done; else "
                    f"touch {marker} && sleep 60; fi"),
        "progress_deadline_seconds": 1, "max_task_retries": 2}]}]})
    task = p.wait("w")[0]
    wedge_nodes = [a.get("node_id") for a in task["attempt_history"]
                   if "wedged" in (a.get("reason") or "")]
    assert wedge_nodes
    node = p.store.get_entity(names.TABLE_NODES, p.id, wedge_nodes[0])
    return task["state"], node[names.NODE_COL_HEALTH] < 1.0


def gang_member_killed_midrun_resumes_from_checkpoint(p, tmp):
    ckpt = tmp / "ckpt"
    cmd = (f"step=$(cat {ckpt} 2>/dev/null || echo 0); "
           f"if [ \"$SHIPYARD_TASK_INSTANCE\" != \"0\" ]; then "
           f"sleep 3; "
           f"elif [ \"$step\" = \"0\" ]; then echo 3 > {ckpt}; "
           f"sleep 3; else echo $((step+2)) > {ckpt}; fi")
    p.submit({"job_specifications": [{"id": "gj", "tasks": [{
        "id": "g0", "command": cmd, "max_task_retries": 2,
        "multi_instance": {"num_instances": 2}}]}]})

    def committed_and_running():
        procs = []
        for agent in p.substrate._agents.get(p.id, {}).values():
            procs.extend(agent._live_procs.values())
        return procs if len(procs) >= 2 and ckpt.exists() else None

    procs = _poll(committed_and_running, timeout=20,
                  message="gang instances running past commit")
    os.killpg(os.getpgid(procs[0].pid), signal.SIGKILL)
    task = p.wait("gj", timeout=40)[0]
    return (task["state"], task["retries"], int(ckpt.read_text().strip()),
            p.gang_rows())


def _ghost_gang(p, job_id, instances, retries, state, attempt=0):
    names = p.pkg.names
    pk = names.task_pk(p.id, job_id)
    p.store.insert_entity(names.TABLE_JOBS, p.id, job_id,
                          {"state": "active", "spec": {}})
    spec = {"command": "echo recovered", "runtime": "none",
            "max_task_retries": 1,
            "multi_instance": {"num_instances": instances,
                               "jax_distributed": {"enabled": False}}}
    p.store.insert_entity(names.TABLE_TASKS, pk, "g0",
                          {"state": state, "spec": spec,
                           "retries": retries})
    gang_pk = names.gang_pk(p.id, job_id, "g0", attempt=attempt)
    p.store.insert_entity(names.TABLE_GANGS, gang_pk, "i0", {
        "node_id": "ghost", "hostname": "ghost",
        "internal_ip": "10.9.9.9", "slice_index": 0,
        "worker_index": 0, "state": "joined"})
    p.store.insert_entity(names.TABLE_GANGS, gang_pk, "node$ghost",
                          {"instance": 0})
    p.store.upsert_entity(names.TABLE_NODES, p.id, "ghost", {
        "state": "running", "heartbeat_at": 0.0})


def broken_gang_requeues_within_budget(p, tmp):
    names = p.pkg.names
    _ghost_gang(p, "jg", 2, 0, "running")
    for k in range(2):
        p.store.put_message(names.task_queue(p.id), json.dumps(
            {"job_id": "jg", "task_id": "g0", "instance": k}).encode())
    task = p.wait("jg", timeout=40)[0]
    return task["state"], task["retries"], p.gang_rows()


def broken_gang_budget_exhausted_quarantines(p, tmp):
    names = p.pkg.names
    _ghost_gang(p, "jq", 8, 1, "running", attempt=1)
    p.store.put_message(names.task_queue(p.id), json.dumps(
        {"job_id": "jq", "task_id": "g0", "instance": 1}).encode())
    task = p.wait("jq", timeout=40)[0]
    assert task["state"] == names.TASK_STATE_QUARANTINED
    return (task["state"], "gang member(s) lost" in task["error"],
            "ghost" in str(task["diagnostics"]["attempt_history"]),
            p.gang_rows())


def abandoned_gang_claim_resumed_by_owner(p, tmp):
    names = p.pkg.names
    p.store.insert_entity(names.TABLE_JOBS, p.id, "jr",
                          {"state": "active", "spec": {}})
    pk = names.task_pk(p.id, "jr")
    spec = {"command": "echo resumed", "runtime": "none",
            "max_task_retries": 1,
            "multi_instance": {"num_instances": 2,
                               "jax_distributed": {"enabled": False}}}
    p.store.insert_entity(names.TABLE_TASKS, pk, "g0",
                          {"state": "pending", "spec": spec,
                           "retries": 0})
    agent = next(iter(p.substrate._agents[p.id].values()))
    gang_pk = names.gang_pk(p.id, "jr", "g0")
    p.store.insert_entity(names.TABLE_GANGS, gang_pk,
                          f"node${agent.identity.node_id}",
                          {"instance": 0})
    p.store.insert_entity(names.TABLE_GANGS, gang_pk, "i0", {
        "node_id": agent.identity.node_id,
        "hostname": agent.identity.hostname,
        "internal_ip": agent.identity.internal_ip,
        "slice_index": 0, "worker_index": 0, "state": "joined"})
    for k in range(2):
        p.store.put_message(names.task_queue(p.id), json.dumps(
            {"job_id": "jr", "task_id": "g0", "instance": k}).encode())
    task = p.wait("jr", timeout=40)[0]
    return task["state"], p.gang_rows()


def gang_claim_resume_is_guarded(p, tmp):
    names = p.pkg.names
    agent = next(iter(p.substrate._agents[p.id].values()))
    me = agent.identity.node_id
    gang_pk = names.gang_pk(p.id, "jx", "g0")
    p.store.insert_entity(names.TABLE_GANGS, gang_pk, f"node${me}",
                          {"instance": 0})
    p.store.insert_entity(names.TABLE_GANGS, gang_pk, "i0",
                          {"node_id": me, "state": "joined"})
    seen = [agent._gang_claim(gang_pk, 0), agent._gang_claim(gang_pk, 0)]
    with agent._running_lock:
        agent._active_gang_claims.discard((gang_pk, 0))
    p.store.merge_entity(names.TABLE_GANGS, gang_pk, "i0",
                         {"state": "done"})
    seen.append(agent._gang_claim(gang_pk, 0))
    p.store.merge_entity(names.TABLE_GANGS, gang_pk, "i0",
                         {"node_id": "other", "state": "joined"})
    seen.append(agent._gang_claim(gang_pk, 0))
    assert seen == [True, False, False, False]
    return seen


def node_alive_registration_grace(p, tmp):
    names = p.pkg.names
    agent = p.agents()[0]
    rows = {"booting": {"state": "creating", "registered_at": time.time()},
            "stale": {"state": "creating",
                      "registered_at": time.time() - 60.0},
            "legacy": {"state": "running"},
            "alive": {"state": "running", "heartbeat_at": time.time()}}
    seen = []
    for node_id, row in rows.items():
        p.store.upsert_entity(names.TABLE_NODES, p.id, node_id, row)
        seen.append(agent._node_alive(node_id))
    assert seen == [True, False, False, True]
    return seen


def orphaned_gang_janitor_sweeps_leaked_rows(p, tmp):
    names = p.pkg.names
    tpk = names.task_pk(p.id, "jj")
    p.store.insert_entity(names.TABLE_JOBS, p.id, "jj",
                          {"state": "active", "spec": {}})
    p.store.insert_entity(names.TABLE_TASKS, tpk, "gdone",
                          {"state": "completed", "retries": 0, "spec": {}})
    done_pk = names.gang_pk(p.id, "jj", "gdone")
    p.store.insert_entity(names.TABLE_GANGS, done_pk, "node$n0",
                          {"instance": 0})
    ghost_pk = names.gang_pk(p.id, "jj", "ghost")
    p.store.insert_entity(names.TABLE_GANGS, ghost_pk, "i0",
                          {"state": "joined"})
    p.store.insert_entity(names.TABLE_TASKS, tpk, "glive",
                          {"state": "running", "retries": 2, "spec": {}})
    stale_pk = names.gang_pk(p.id, "jj", "glive", attempt=0)
    live_pk = names.gang_pk(p.id, "jj", "glive", attempt=2)
    p.store.insert_entity(names.TABLE_GANGS, stale_pk, "node$n1",
                          {"instance": 0})
    p.store.insert_entity(names.TABLE_GANGS, live_pk, "i0",
                          {"state": "joined"})
    agent = next(a for a in p.substrate._agents[p.id].values()
                 if a.identity.node_index == 0)
    agent._last_gang_sweep -= agent.gang_sweep_interval + 1
    agent._sweep_orphaned_gangs()
    left = {pk: len(list(p.store.query_entities(
        names.TABLE_GANGS, partition_key=pk)))
        for pk in (done_pk, ghost_pk, stale_pk, live_pk)}
    assert list(left.values()) == [0, 0, 0, 1]
    return list(left.values())


# (scenario, pool kwargs): nodes as the reference's accelerator's hosts.
SCENARIOS = [
    (wedge_watchdog_kills_and_retry_completes, {}),
    (progress_beats_defeat_the_watchdog, {}),
    (retry_backoff_stamps_not_before,
     {"agent_kwargs": {"retry_backoff_base": 0.8,
                       "retry_backoff_cap": 2.0}}),
    (poison_quarantine_with_diagnostics, {}),
    (zero_budget_task_fails_plain, {}),
    (node_health_quarantine_and_recovery, {}),
    (node_quarantine_probation_release,
     {"agent_kwargs": {**FAST_RETRY, "health_probation_seconds": 0.3}}),
    (beat_throttle_scales_to_deadline, None),
    (wedging_node_health_drops_e2e, {}),
    (gang_member_killed_midrun_resumes_from_checkpoint, {"nodes": 4}),
    (broken_gang_requeues_within_budget, {}),
    (broken_gang_budget_exhausted_quarantines, {}),
    (abandoned_gang_claim_resumed_by_owner, {}),
    (gang_claim_resume_is_guarded, {}),
    (node_alive_registration_grace, {"nodes": 1}),
    (orphaned_gang_janitor_sweeps_leaked_rows, {}),
]


def _run(name, scenario, pool_kwargs, tmp_path):
    pkg = PACKAGES[name]
    tmp = tmp_path / name
    tmp.mkdir()
    if pool_kwargs is None:
        return scenario(types.SimpleNamespace(pkg=pkg), tmp)
    p = Pool(pkg, scenario.__name__.replace("_", "")[:20], **pool_kwargs)
    try:
        return scenario(p, tmp)
    finally:
        p.substrate.stop_all()


@pytest.mark.parametrize("scenario,pool_kwargs", SCENARIOS,
                         ids=[s.__name__ for s, _ in SCENARIOS])
def test_scenario_agrees_with_the_reference(scenario, pool_kwargs,
                                            tmp_path):
    want = _run("reference", scenario, pool_kwargs, tmp_path)
    got = _run("port", scenario, pool_kwargs, tmp_path)
    assert got == want
