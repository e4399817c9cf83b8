"""The port's localhost substrate: real subprocess node agents
(``python -m batch_shipyard_tpu_torch.agent``) over the port's localfs
store, as tests/test_localhost_substrate.py runs the reference's, and a
2-instance gang of the port's train_transformer under the launcher's
torch.distributed env, whose losses must equal
``distributed.launch_local``'s run of the same command bit for bit."""

import json
import os
import pathlib
import sys

import pytest

from batch_shipyard_tpu_torch.agent import perf
from batch_shipyard_tpu_torch.config import settings as settings_mod
from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
from batch_shipyard_tpu_torch.pool import manager as pool_mgr
from batch_shipyard_tpu_torch.state.localfs import LocalFSStateStore
from batch_shipyard_tpu_torch.substrate.localhost import LocalhostSubstrate
from batch_shipyard_tpu_torch.workloads import distributed

REPO = pathlib.Path(__file__).resolve().parent.parent
GLOBAL = settings_mod.global_settings({})
# A tiny train_transformer on the CPU: 2 layers, batch 2 (one row a rank
# of the gang).
TRAIN_ARGS = ["--device", "cpu", "--vocab", "64", "--d-model", "32",
              "--n-layers", "2", "--n-heads", "2", "--d-ff", "64",
              "--seq-len", "16", "--batch", "2", "--warmup", "1",
              "--steps", "2", "--no-remat", "--no-compile-cache"]


@pytest.fixture()
def ctx(tmp_path):
    store = LocalFSStateStore(str(tmp_path / "store"))
    creds = settings_mod.credentials_settings({"credentials": {
        "storage": {"backend": "localfs", "root": str(tmp_path / "store")}}})
    conf = {"pool_specification": {
        "id": "lh", "substrate": "localhost",
        "vm_configuration": {"vm_size": "a3-highgpu-1g",
                             "vm_count": {"dedicated": 2}},
        "inter_node_communication_enabled": True,
        "max_wait_time_seconds": 90}}
    pool = settings_mod.pool_settings(conf)
    substrate = LocalhostSubstrate(store, creds,
                                   work_root=str(tmp_path / "nodes"),
                                   pool_config=conf, run_nodeprep=True)
    yield store, substrate, pool, conf
    try:
        pool_mgr.delete_pool(store, substrate, "lh")
    except Exception:
        substrate.deallocate_pool("lh")


def test_localhost_agents_run_tasks_and_a_torch_gang(ctx):
    store, substrate, pool, conf = ctx
    nodes = pool_mgr.create_pool(store, substrate, pool, GLOBAL, conf)
    assert len(nodes) == 2
    # Node prep ran in each agent process: on this CPU-only torch it
    # reports torch_cuda_ready:False and still completes.
    events = [row["event"] for row in perf.query(store, "lh")
              if row["source"] == "nodeprep"]
    assert events.count("start") == events.count("end") == 2
    assert events.count("torch_cuda_ready:False") == 2
    port = distributed.free_port()
    jobs = settings_mod.job_settings_list({"job_specifications": [{
        "id": "lhjob",
        "tasks": [
            {"id": "echo", "command": "echo subprocess-agent"},
            # Tasks run with cwd=task_dir: the port must still be
            # importable (PYTHONPATH injected by the substrate).
            {"id": "mod", "command":
             "python -c 'import batch_shipyard_tpu_torch; "
             "print(\"mod-ok\")'"},
            {"id": "gang", "command": " ".join(
                [sys.executable, "-m",
                 "batch_shipyard_tpu_torch.workloads.train_transformer",
                 *TRAIN_ARGS]),
             "environment_variables": {"OMP_NUM_THREADS": "1"},
             "multi_instance": {"num_instances": 2, "jax_distributed": {
                 "enabled": True, "coordinator_port": port}}},
        ]}]})
    jobs_mgr.add_jobs(store, pool, jobs)
    tasks = {t["_rk"]: t for t in jobs_mgr.wait_for_tasks(
        store, "lh", "lhjob", timeout=150)}
    assert all(t["state"] == "completed" for t in tasks.values()), tasks
    assert jobs_mgr.get_task_output(
        store, "lh", "lhjob", "echo").strip() == b"subprocess-agent"
    assert jobs_mgr.get_task_output(
        store, "lh", "lhjob", "mod").strip() == b"mod-ok"
    lines = jobs_mgr.get_task_output(
        store, "lh", "lhjob", "gang", instance=0).decode().splitlines()
    assert lines[-2].startswith("[proc 0/2] transformer: mesh=")
    gang = json.loads(lines[-1])
    assert gang["mesh"]["dp"] == 2 and len(gang["per_rank"]) == 2
    # The same command as two local ranks with launch_local's env.
    runs = distributed.launch_local(
        [sys.executable, "-m",
         "batch_shipyard_tpu_torch.workloads.train_transformer",
         *TRAIN_ARGS], 2, 120,
        env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"),
        cwd=REPO)
    assert all(r["returncode"] == 0 for r in runs), [
        r["stderr"][-2000:] for r in runs]
    local = json.loads(runs[0]["stdout"].strip().splitlines()[-1])
    assert gang["losses"] == local["losses"]
    assert [r["params_sha256"] for r in gang["per_rank"]] == [
        r["params_sha256"] for r in local["per_rank"]]
