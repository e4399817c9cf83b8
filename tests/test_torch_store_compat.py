"""Same store bytes: one localfs root, both packages. A job the reference
submits is run by the port's agents and read back by the reference; a
job the port submits is run by the reference's agents and read back by
the port. And the compile-cache seed between nodes through the port's
agents: task 1 leaves an entry in its node's cache, the agent exports it,
and after ``pool del`` / ``pool add`` on a fresh work root task 2 finds
the entry before it runs; the reference reads the port's latest.json."""

import time

import pytest

from batch_shipyard_tpu.compilecache import seeding as ref_seeding
from batch_shipyard_tpu.config import settings as ref_settings
from batch_shipyard_tpu.jobs import manager as ref_jobs
from batch_shipyard_tpu.pool import manager as ref_pool
from batch_shipyard_tpu.state.localfs import LocalFSStateStore as RefFS
from batch_shipyard_tpu.substrate.fakepod import FakePodSubstrate as RefPod
from batch_shipyard_tpu_torch.compilecache import seeding
from batch_shipyard_tpu_torch.config import settings
from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
from batch_shipyard_tpu_torch.pool import manager as pool_mgr
from batch_shipyard_tpu_torch.state.localfs import LocalFSStateStore
from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

POOL_CONF = {"pool_specification": {
    "id": "compat", "substrate": "fake",
    "vm_configuration": {"vm_size": "a3-highgpu-1g",
                         "vm_count": {"dedicated": 2}},
    "inter_node_communication_enabled": True,
    "max_wait_time_seconds": 30}}
JOBS_CONF = {"job_specifications": [{
    "id": "cj", "environment_variables": {"V": "7"},
    "tasks": [
        {"id": "a", "command": "echo a$V"},
        {"id": "b", "command": "echo b $SHIPYARD_JOB_ID",
         "depends_on": ["a"]},
        {"id": "g", "command":
         "echo $SHIPYARD_TASK_INSTANCE/$SHIPYARD_TASK_INSTANCES",
         "multi_instance": {"num_instances": 2,
                            "jax_distributed": {"enabled": True}}},
        {"id": "f", "command": "exit 4"},
    ]}]}
WANT = {"a": ("completed", 0, b"a7"), "b": ("completed", 0, b"b cj"),
        "f": ("failed", 4, b"")}

SIDES = {
    "reference": (ref_settings, ref_jobs, ref_pool, RefFS, RefPod),
    "port": (settings, jobs_mgr, pool_mgr, LocalFSStateStore,
             FakePodSubstrate),
}


@pytest.mark.parametrize("submitter,runner", [("reference", "port"),
                                              ("port", "reference")])
def test_jobs_cross_packages_over_one_localfs_root(tmp_path, submitter,
                                                   runner):
    root = str(tmp_path / "store")
    r_settings, _, r_pool, r_store_cls, r_pod = SIDES[runner]
    s_settings, s_jobs, _, s_store_cls, _ = SIDES[submitter]
    run_store = r_store_cls(root)
    substrate = r_pod(run_store, work_root=str(tmp_path / "nodes"))
    r_pool.create_pool(run_store, substrate,
                       r_settings.pool_settings(POOL_CONF),
                       r_settings.global_settings({}), POOL_CONF)
    try:
        store = s_store_cls(root)
        pool = s_settings.pool_settings(POOL_CONF)
        counts = s_jobs.add_jobs(store, pool,
                                 s_settings.job_settings_list(JOBS_CONF))
        assert counts == {"cj": 4}
        tasks = {t["_rk"]: t for t in s_jobs.wait_for_tasks(
            store, "compat", "cj", timeout=60)}
        for task_id, (state, code, out) in WANT.items():
            assert (tasks[task_id]["state"], tasks[task_id]["exit_code"]) \
                == (state, code), tasks[task_id]
            assert s_jobs.get_task_output(
                store, "compat", "cj", task_id).strip() == out
        assert tasks["a"]["completed_at"] <= tasks["b"]["started_at"]
        assert tasks["g"]["state"] == "completed"
        assert sorted(s_jobs.get_task_output(
            store, "compat", "cj", "g", instance=k).strip()
            for k in range(2)) == [b"0/2", b"1/2"]
        assert s_jobs.job_stats(store, "compat")["tasks"] == 4
    finally:
        substrate.stop_all()


def test_cache_seeds_a_fresh_node_across_pool_recreation(tmp_path):
    root = str(tmp_path / "store")
    store = LocalFSStateStore(root)
    conf = {"pool_specification": dict(
        POOL_CONF["pool_specification"], id="seedpool",
        vm_configuration={"vm_size": "a3-highgpu-1g",
                          "vm_count": {"dedicated": 1}})}
    pool = settings.pool_settings(conf)
    glob = settings.global_settings({})

    def run(job_id, command, work_root):
        substrate = FakePodSubstrate(store, work_root=str(work_root))
        pool_mgr.create_pool(store, substrate, pool, glob, conf)
        jobs_mgr.add_jobs(store, pool, settings.job_settings_list(
            {"job_specifications": [{"id": job_id, "tasks": [
                {"id": "t", "command": command}]}]}))
        task = jobs_mgr.wait_for_tasks(store, "seedpool", job_id,
                                       timeout=30)[0]
        return substrate, task

    substrate, task = run("jcold", (
        'd="$SHIPYARD_COMPILE_CACHE_DIR/ident-X" && mkdir -p "$d" && '
        'echo \'{"identity": "X"}\' > "$d/identity.json" && '
        'echo warm-bits > "$d/entry-1"'), tmp_path / "work1")
    assert task["state"] == "completed", task
    deadline = time.monotonic() + 15
    while time.monotonic() < deadline and not (
            seeding.latest_info(store, "seedpool") or {}).get("identities"):
        time.sleep(0.05)
    latest = seeding.latest_info(store, "seedpool")
    assert latest["identities"]["X"]["entries"] == 1
    # The reference reads the port's pointer, byte for byte.
    assert ref_seeding.latest_info(RefFS(root), "seedpool") == latest
    pool_mgr.delete_pool(store, substrate, "seedpool")
    substrate, task = run(
        "jwarm", 'cat "$SHIPYARD_COMPILE_CACHE_DIR/ident-X/entry-1"',
        tmp_path / "work2")
    try:
        assert task["state"] == "completed", task
        assert jobs_mgr.get_task_output(
            store, "seedpool", "jwarm", "t").strip() == b"warm-bits"
    finally:
        substrate.stop_all()
