"""The port's task runner (agent/task_runner.py) against the reference's:
the env contract and the ``none`` runtime byte for byte; docker and
singularity argv equal apart from the device flags, which are the GPU
passthrough (``--gpus all --ipc host --net host``; ``--nv``) when it is
forced by $SHIPYARD_FORCE_GPU_PASSTHROUGH. The reference's TPU
passthrough is forced by its /dev/accel0, made to exist for the test."""

import os

import pytest

from batch_shipyard_tpu.agent import task_runner as ref_runner
from batch_shipyard_tpu_torch.agent import task_runner

REF_DEVICE = {"docker": ["--privileged", "--device", "/dev/accel0",
                         "--net", "host"],
              "singularity": ["--bind", "/dev:/dev"]}
GPU_DEVICE = {"docker": ["--gpus", "all", "--ipc", "host", "--net", "host"],
              "singularity": ["--nv"]}


def _execution(module, runtime: str, task_dir: str, **extra):
    env = {"MYVAR": "1",
           "SHIPYARD_GOODPUT_FILE": f"{task_dir}/goodput.jsonl",
           "SHIPYARD_PROGRESS_FILE": f"{task_dir}/progress.json",
           "SHIPYARD_TRACE_FILE": f"{task_dir}/trace.jsonl",
           "SHIPYARD_COMPILE_CACHE_DIR": "/work/compilecache"}
    return module.TaskExecution(
        pool_id="p", job_id="j", task_id="t", node_id="n", node_index=3,
        command="echo hi", runtime=runtime, image="img:1", env=env,
        task_dir=task_dir, slot=1, instances=2, instance=1,
        host_list=("a", "b"), shm_size="1g",
        additional_docker_run_options=("--cap-add", "SYS_PTRACE"),
        additional_singularity_options=("--cleanenv",), **extra)


def _strip(argv: list, flags: list) -> list:
    for k in range(len(argv) - len(flags) + 1):
        if argv[k:k + len(flags)] == flags:
            return argv[:k] + argv[k + len(flags):]
    return argv


@pytest.mark.parametrize("runtime,extra", [
    ("none", {}), ("none", {"record_exit_code": True}),
    ("docker", {}), ("docker", {"container_runtime": "kata_containers"}),
    ("docker", {"docker_exec_in": "c1"}), ("singularity", {})])
def test_env_and_argv_match_the_reference(tmp_path, monkeypatch, runtime,
                                          extra):
    monkeypatch.setenv("SHIPYARD_FORCE_GPU_PASSTHROUGH", "1")
    exists = os.path.exists
    monkeypatch.setattr(os.path, "exists", lambda path: (
        path == "/dev/accel0" or exists(path)))
    task_dir = str(tmp_path / "task")
    ref = _execution(ref_runner, runtime, task_dir, **extra)
    port = _execution(task_runner, runtime, task_dir, **extra)
    base = {"PATH": "/usr/bin", "HOME": "/home/x"}
    assert (task_runner.build_task_env(port, base) ==
            ref_runner.build_task_env(ref, base))
    assert task_runner.container_name(port) == ref_runner.container_name(
        ref)
    ref_argv = ref_runner.synthesize_command(ref)
    argv = task_runner.synthesize_command(port)
    if runtime == "none" or extra.get("docker_exec_in"):
        assert argv == ref_argv
        return
    assert task_runner.gpu_passthrough()
    flags = GPU_DEVICE[runtime]
    assert _strip(argv, flags) != argv
    assert _strip(argv, flags) == _strip(ref_argv, REF_DEVICE[runtime])
    if runtime == "docker":
        # In the reference's place, before the task's own options.
        at = ref_argv.index("--privileged")
        assert argv[at:at + len(flags)] == flags
    monkeypatch.delenv("SHIPYARD_FORCE_GPU_PASSTHROUGH")
    if not task_runner.gpu_passthrough():
        assert flags[0] not in task_runner.synthesize_command(port)
