"""The non-slow scenarios of tests/test_chaos_stress.py through both
packages, each on its own FakePod pool(s) and MemoryStateStore: 120
tasks exactly once, 40 tasks through random agent crashes
(``FakePodSubstrate.start_chaos``), a 10^5-task submission's queueing
layer, and three pools on one store, one under agent-kill chaos. Each
scenario makes the reference test's assertions with its timeouts and
returns what the two packages must agree on. The pools are GPU pools
of a3-highgpu-1g nodes, one a host of the reference's slice
(v5litepod-16: four, -8: two, -4: one, -64: sixteen)."""

import json
import threading
import time
from collections import Counter

import pytest

from tests.test_torch_chaos_recovery import PACKAGES


def _conf(pool_id, nodes, slots=None, shards=None):
    spec = {"id": pool_id, "substrate": "fake",
            "vm_configuration": {"vm_size": "a3-highgpu-1g",
                                 "vm_count": {"dedicated": nodes}},
            "max_wait_time_seconds": 30}
    if slots:
        spec["task_slots_per_node"] = slots
    if shards:
        spec["task_queue_shards"] = shards
    return {"pool_specification": spec}


def _create(pkg, store, conf, **substrate_kwargs):
    substrate = pkg.substrate(store, **substrate_kwargs)
    pool = pkg.settings.pool_settings(conf)
    pkg.pool.create_pool(store, substrate, pool,
                         pkg.settings.global_settings({}), conf)
    return substrate, pool


def _jobs(pkg, job_id, tasks):
    return pkg.settings.job_settings_list(
        {"job_specifications": [{"id": job_id, "tasks": tasks}]})


def scheduler_stress_120_tasks(pkg):
    store = pkg.store()
    substrate = None
    try:
        substrate, pool = _create(pkg, store, _conf("stress", 4, slots=4))
        start = time.monotonic()
        pkg.jobs.add_jobs(store, pool, _jobs(pkg, "big", [
            {"id": f"t{i:03d}", "command": f"echo done-{i}"}
            for i in range(120)]))
        tasks = pkg.jobs.wait_for_tasks(store, "stress", "big",
                                        timeout=120, poll_interval=0.5)
        elapsed = time.monotonic() - start
        outs = [pkg.jobs.get_task_output(
            store, "stress", "big", f"t{i:03d}").strip()
            for i in (0, 59, 119)]
        assert elapsed < 115
        return (len(tasks), {t["state"] for t in tasks}, outs)
    finally:
        if substrate is not None:
            substrate.stop_all()


def chaos_tasks_survive_agent_crashes(pkg):
    store = pkg.store()
    substrate = stop_chaos = None
    try:
        substrate, pool = _create(pkg, store, _conf("chaos", 4, slots=2),
                                  node_stale_seconds=3.0)
        stop_chaos = substrate.start_chaos(
            "chaos", kill_interval=0.7, revive_after=0.3, seed=42)
        pkg.jobs.add_jobs(store, pool, _jobs(pkg, "survivor", [
            {"id": f"t{i:02d}", "command": f"sleep 0.2 && echo alive-{i}"}
            for i in range(40)]))
        tasks = pkg.jobs.wait_for_tasks(store, "chaos", "survivor",
                                        timeout=180, poll_interval=0.5)
        bad = {t["_rk"]: t["state"] for t in tasks
               if t["state"] != "completed"}
        assert not bad, bad
        outs = [pkg.jobs.get_task_output(
            store, "chaos", "survivor", f"t{i:02d}").strip()
            for i in (0, 39)]
        return len(tasks), outs
    finally:
        if stop_chaos is not None:
            stop_chaos.set()
        if substrate is not None:
            substrate.stop_all()


def submission_scale_100k_queueing(pkg):
    names = pkg.names
    n = 100_000
    conf = _conf("s100k", 16, shards=16)
    store = pkg.store()
    pool = pkg.settings.pool_settings(conf)
    store.insert_entity(names.TABLE_POOLS, "pools", "s100k", {
        "state": "ready", "spec": conf})
    start = time.monotonic()
    counts = pkg.jobs.add_jobs(store, pool, _jobs(pkg, "vast", [
        {"command": "true", "runtime": "none",
         "task_factory": {"repeat": n}}]))
    submit_elapsed = time.monotonic() - start
    assert submit_elapsed < 120, f"submission took {submit_elapsed:.0f}s"
    final_shards = pkg.jobs.pool_queue_shards(store, "s100k", ttl=0)
    queues = names.task_queues("s100k", final_shards)
    lengths = {q: store.queue_length(q) for q in queues}
    populated = {q: c for q, c in lengths.items() if c}
    original_names = set(names.task_queues("s100k", 16))
    original = [c for q, c in lengths.items() if q in original_names and c]
    seen = Counter()
    popped = 0
    for q in populated:
        for msg in store.get_messages(q, max_messages=32,
                                      visibility_timeout=60.0):
            seen[json.loads(msg.payload)["task_id"]] += 1
            store.delete_message(msg)
            popped += 1
    assert final_shards >= 16
    assert original_names <= set(queues)
    assert sum(lengths.values()) == n
    assert len(populated) >= 16
    assert min(original) > n / 64
    assert popped >= 16 * 32
    assert len(seen) == popped and max(seen.values()) == 1
    return counts["vast"], sum(lengths.values())


def soak_concurrent_pools_with_chaos(pkg):
    store = pkg.store()
    n_tasks = {"soak-a": 150, "soak-b": 100, "soak-c": 60}
    pools, substrates = {}, {}
    stop_chaos = None
    try:
        for pool_id, nodes, slots in (("soak-a", 4, 4), ("soak-b", 2, 2),
                                      ("soak-c", 1, 2)):
            substrates[pool_id], pools[pool_id] = _create(
                pkg, store, _conf(pool_id, nodes, slots=slots, shards=4),
                node_stale_seconds=3.0)
        stop_chaos = substrates["soak-b"].start_chaos(
            "soak-b", kill_interval=0.8, revive_after=0.3, seed=7)
        results = {}

        def drive(pool_id):
            try:
                pkg.jobs.add_jobs(store, pools[pool_id], _jobs(
                    pkg, "load", [{"id": f"t{i:04d}",
                                   "command": f"echo {pool_id}-{i}"}
                                  for i in range(n_tasks[pool_id])]))
                results[pool_id] = pkg.jobs.wait_for_tasks(
                    store, pool_id, "load", timeout=240,
                    poll_interval=0.5)
            except Exception as exc:  # noqa: BLE001
                results[pool_id] = exc

        threads = [threading.Thread(target=drive, args=(p,), daemon=True)
                   for p in pools]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not any(t.is_alive() for t in threads)
        assert set(results) == set(pools), results.keys()
        summary = {}
        for pool_id, tasks in results.items():
            assert not isinstance(tasks, Exception), (pool_id, tasks)
            bad = {t["_rk"]: t["state"] for t in tasks
                   if t["state"] != "completed"}
            assert not bad, (pool_id, bad)
            last = n_tasks[pool_id] - 1
            summary[pool_id] = (len(tasks), [
                pkg.jobs.get_task_output(
                    store, pool_id, "load", f"t{i:04d}").strip()
                for i in (0, last)])
        return summary
    finally:
        if stop_chaos is not None:
            stop_chaos.set()
        for substrate in substrates.values():
            substrate.stop_all()


SCENARIOS = [scheduler_stress_120_tasks, chaos_tasks_survive_agent_crashes,
             submission_scale_100k_queueing,
             soak_concurrent_pools_with_chaos]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scenario_agrees_with_the_reference(scenario):
    want = scenario(PACKAGES["reference"])
    got = scenario(PACKAGES["port"])
    assert got == want
