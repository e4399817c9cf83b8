"""Task execution on a node: env contract + runtime command synthesis.

The port's copy of batch_shipyard_tpu/agent/task_runner.py (reference
analog: scripts/shipyard_task_runner.sh and the docker/singularity exec
wiring in _construct_task, convoy/batch.py:4640-4700). The env contract
and the ``none`` runtime are the reference's byte for byte; what differs
is the device passthrough. A docker task on a node with /dev/nvidia0
(or with $SHIPYARD_FORCE_GPU_PASSTHROUGH set) runs with ``--gpus all
--ipc host --net host``: every GPU of the node, as a TPU task sees every
chip; the host's IPC namespace, because gang ranks in separate
containers on one host map each other's ring buffers by CUDA IPC
(ops/csrc/ring_collectives.cu); and the host network for the gang's
rendezvous. A singularity task gets ``--nv``.

Env contract exposed to every task (the $AZ_BATCH_* analog):

  SHIPYARD_POOL_ID / SHIPYARD_JOB_ID / SHIPYARD_TASK_ID
  SHIPYARD_NODE_ID / SHIPYARD_NODE_INDEX
  SHIPYARD_TASK_DIR        working directory for the task
  SHIPYARD_TASK_SLOT       slot index on this node
  SHIPYARD_HOST_LIST       comma-separated worker hostnames (gang tasks;
                           $AZ_BATCH_HOST_LIST analog, batch.py:4378)
  SHIPYARD_TASK_INSTANCES  gang size (1 for regular tasks)
  SHIPYARD_TASK_INSTANCE   this instance's index
  SHIPYARD_JOB_SHARED_DIR  node-local directory shared by every task
                           of the job ($AZ_BATCH_JOB_SHARED_DIR
                           analog; set by the node agent)
  SHIPYARD_JOB_SCRATCH     auto_scratch mount for the job (node-local
                           or the gang-shared NFS namespace; only set
                           when the job opts in)
  SHIPYARD_GOODPUT_FILE    JSONL sink for program-phase goodput events
                           (goodput/events.py record/phase); the agent
                           ingests it into TABLE_GOODPUT post-task
  SHIPYARD_PROGRESS_FILE   liveness file for the wedge watchdog
                           (agent/progress.py): instrumented workloads
                           beat it every step; tasks declaring
                           progress_deadline_seconds are killed when
                           it goes stale (hang -> bounded retry)
  SHIPYARD_TRACE_ID        distributed-trace context of this task
  SHIPYARD_TRACE_SPAN_ID   (trace/context.py): program spans recorded
  SHIPYARD_TRACE_FILE      in-process parent under the task's run
                           span; the JSONL span sink is ingested by
                           the agent post-task
  SHIPYARD_PROFILE_REQUEST_FILE  on-demand profiling (trace/
  SHIPYARD_PROFILE_DIR     profiling.py): the train harness watches
                           the request file and writes torch.profiler
                           captures into the dir, uploaded post-task
plus, for gang tasks, the torch.distributed env from jobs/launcher.py
(MASTER_ADDR, RANK, WORLD_SIZE, PET_* etc.).
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import signal
import subprocess
import time
from typing import Optional

from batch_shipyard_tpu_torch.agent import progress
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)


@dataclasses.dataclass
class TaskExecution:
    """Everything needed to run one task instance on a node."""

    pool_id: str
    job_id: str
    task_id: str
    node_id: str
    node_index: int
    command: str
    runtime: str = "none"  # none | docker | singularity
    # Docker runtime for the container: runc (default) or
    # kata_containers -> `docker run --runtime kata-runtime`
    # (VM-isolated containers; reference shipyard_nodeprep.sh:1105
    # install + :1133 default-runtime wiring).
    container_runtime: str = "runc"
    image: Optional[str] = None
    env: dict[str, str] = dataclasses.field(default_factory=dict)
    task_dir: str = "."
    slot: int = 0
    instances: int = 1
    instance: int = 0
    host_list: tuple[str, ...] = ()
    max_wall_time_seconds: Optional[float] = None
    # Wedge watchdog: kill the task when its progress file goes stale
    # past this deadline (None = watchdog disabled for this task).
    progress_deadline_seconds: Optional[float] = None
    remove_container_after_exit: bool = True
    shm_size: Optional[str] = None
    additional_docker_run_options: tuple[str, ...] = ()
    additional_singularity_options: tuple[str, ...] = ()
    docker_exec_in: Optional[str] = None  # exec into a running container
    interactive: bool = False
    # Crash-restart adoption contract (agent/node_agent.py slot
    # ledger): when set, the task's exit code is persisted to
    # EXIT_CODE_FILENAME in task_dir — by a shell trailer inside the
    # task's own session for runtime "none" (survives the agent
    # process dying) AND by run_task after reaping (covers kill
    # paths). A restarted agent adopting the still-running process
    # reads the file to classify the exit it never got to wait() on.
    record_exit_code: bool = False


@dataclasses.dataclass
class TaskResult:
    exit_code: int
    stdout_path: str
    stderr_path: str
    started_at: str
    completed_at: str
    wall_seconds: float
    timed_out: bool = False
    # True when the wedge watchdog killed the task for missing its
    # progress deadline (alive but stalled — the TPU-wedge shape).
    wedged: bool = False


def build_task_env(execution: TaskExecution,
                   base_env: Optional[dict[str, str]] = None,
                   ) -> dict[str, str]:
    env = dict(base_env if base_env is not None else os.environ)
    env.update(execution.env)
    env.update({
        "SHIPYARD_POOL_ID": execution.pool_id,
        "SHIPYARD_JOB_ID": execution.job_id,
        "SHIPYARD_TASK_ID": execution.task_id,
        "SHIPYARD_NODE_ID": execution.node_id,
        "SHIPYARD_NODE_INDEX": str(execution.node_index),
        "SHIPYARD_TASK_DIR": execution.task_dir,
        "SHIPYARD_TASK_SLOT": str(execution.slot),
        "SHIPYARD_TASK_INSTANCES": str(execution.instances),
        "SHIPYARD_TASK_INSTANCE": str(execution.instance),
    })
    if execution.host_list:
        env["SHIPYARD_HOST_LIST"] = ",".join(execution.host_list)
    return env


def container_name(execution: "TaskExecution") -> Optional[str]:
    """The fixed docker ``--name`` for this execution, or None for
    non-docker runtimes and exec-in tasks (which attach to a
    container somebody else owns)."""
    if execution.runtime == "docker" and not execution.docker_exec_in:
        return (f"shipyard-{execution.job_id}-{execution.task_id}"
                f"-i{execution.instance}")
    return None


# ------------------------- in-process runtime --------------------------
#
# runtime: "inproc" — the task runs as a FUNCTION CALL inside the
# agent's worker thread: no fork, no /bin/bash, no task-dir creation,
# no stdout files. This is the 10^5-task scheduler-proof mode: at that
# scale per-task subprocess cost (fork+exec+pipe teardown, ~10ms each)
# dominates the scheduler benchmark and the measurement stops being
# about scheduling. Everything ABOVE the runner (claims, state
# transitions, goodput/trace emission, queue drain) runs the real
# path. The command string's first token selects a registered
# callable; unknown commands exit 127 like a shell would.

def _inproc_noop(execution: "TaskExecution") -> int:
    return 0


def _inproc_fail(execution: "TaskExecution") -> int:
    return 1


def _inproc_preempt_exit(execution: "TaskExecution") -> int:
    """Exit preempted immediately (test hook for the requeue path)."""
    from batch_shipyard_tpu_torch.agent import preemption
    return preemption.EXIT_PREEMPTED


INPROC_COMMANDS = {
    "noop": _inproc_noop,
    "fail": _inproc_fail,
    "preempt-exit": _inproc_preempt_exit,
}


def _run_inproc(execution: TaskExecution) -> TaskResult:
    started_at = util.datetime_utcnow_iso()
    start = time.monotonic()
    name = (execution.command or "noop").split(None, 1)[0]
    fn = INPROC_COMMANDS.get(name)
    if fn is None:
        exit_code = 127
    else:
        try:
            exit_code = int(fn(execution) or 0)
        except Exception:  # noqa: BLE001 - a task bug is exit 1,
            # never an agent-thread crash
            logger.exception("inproc task %s failed", name)
            exit_code = 1
    return TaskResult(
        exit_code=exit_code, stdout_path="", stderr_path="",
        started_at=started_at,
        completed_at=util.datetime_utcnow_iso(),
        wall_seconds=time.monotonic() - start)


# Where the exit-code sentinel lands, relative to task_dir (the
# command runs with cwd=task_dir, so the shell trailer needs no
# absolute path and no env remap).
EXIT_CODE_FILENAME = ".shipyard_exitcode"


def _exit_recorded_command(command: str) -> str:
    """Wrap a runtime-"none" command so its exit code lands in
    EXIT_CODE_FILENAME from INSIDE the task's own session: the
    write happens even when the spawning agent process is long dead
    (tasks run start_new_session=True and outlive an agent crash —
    the adoption scenario). tmp+mv so a reader never sees a torn
    write; the original exit code is preserved."""
    return (f"( {command}\n); __shipyard_ec=$?; "
            f"printf '%s' \"$__shipyard_ec\" "
            f"> {EXIT_CODE_FILENAME}.tmp && "
            f"mv {EXIT_CODE_FILENAME}.tmp {EXIT_CODE_FILENAME}; "
            f"exit $__shipyard_ec")


def gpu_passthrough() -> bool:
    """Whether a container task gets the node's GPUs: the node has
    /dev/nvidia0, or $SHIPYARD_FORCE_GPU_PASSTHROUGH is set."""
    return bool(os.path.exists("/dev/nvidia0") or os.environ.get(
        "SHIPYARD_FORCE_GPU_PASSTHROUGH"))


def synthesize_command(execution: TaskExecution) -> list[str]:
    """Build the argv for the task's runtime.

    docker/singularity lines mirror the capability surface of the
    reference's run-option synthesis (batch.py:4640-4700) with GPU
    passthrough (module doc).
    """
    if execution.runtime == "none":
        command = execution.command
        if execution.record_exit_code:
            command = _exit_recorded_command(command)
        return ["/bin/bash", "-c", command]
    if execution.runtime == "docker":
        if execution.docker_exec_in:
            argv = ["docker", "exec", execution.docker_exec_in,
                    "/bin/bash", "-c", execution.command]
            return argv
        argv = ["docker", "run"]
        if execution.container_runtime == "kata_containers":
            argv += ["--runtime", "kata-runtime"]
        if execution.remove_container_after_exit:
            argv.append("--rm")
        argv += ["--name", container_name(execution)]
        if execution.interactive:
            argv.append("-it")
        if gpu_passthrough():
            argv += ["--gpus", "all", "--ipc", "host", "--net", "host"]
        if execution.shm_size:
            argv += ["--shm-size", execution.shm_size]
        argv += ["-w", "/shipyard/task", "-v",
                 f"{execution.task_dir}:/shipyard/task"]
        for key in sorted(execution.env):
            argv += ["-e", key]
        for var in ("SHIPYARD_POOL_ID", "SHIPYARD_JOB_ID",
                    "SHIPYARD_TASK_ID", "SHIPYARD_NODE_ID",
                    "SHIPYARD_NODE_INDEX", "SHIPYARD_TASK_INSTANCES",
                    "SHIPYARD_TASK_INSTANCE", "SHIPYARD_HOST_LIST",
                    "SHIPYARD_TASK_SLOT"):
            argv += ["-e", var]
        # SHIPYARD_TASK_DIR names the HOST path; inside the container
        # the task dir is the /shipyard/task mount, so forward the
        # remapped value rather than the bare passthrough.
        argv += ["-e", "SHIPYARD_TASK_DIR=/shipyard/task"]
        goodput_file = execution.env.get("SHIPYARD_GOODPUT_FILE")
        if goodput_file:
            # The host task_dir is mounted at /shipyard/task: remap
            # the recorder path onto the mount so the agent finds the
            # file on the host side after exit. A sink outside this
            # execution's task_dir (e.g. a gang coordination step
            # whose task_dir is a subdir) is unreachable through the
            # mount — leave the env alone; the recorder's writes are
            # simply lost with the container, never an error.
            host_dir = os.path.abspath(execution.task_dir)
            host_file = os.path.abspath(goodput_file)
            if host_file.startswith(host_dir + os.sep):
                rel = os.path.relpath(host_file, host_dir)
                argv += ["-e",
                         f"SHIPYARD_GOODPUT_FILE=/shipyard/task/{rel}"]
        progress_file = execution.env.get(progress.PROGRESS_FILE_ENV)
        if progress_file:
            # Same mount remap as the goodput sink: beats written
            # inside the container must land where the host-side
            # watchdog stats them.
            host_dir = os.path.abspath(execution.task_dir)
            host_file = os.path.abspath(progress_file)
            if host_file.startswith(host_dir + os.sep):
                rel = os.path.relpath(host_file, host_dir)
                argv += ["-e",
                         f"{progress.PROGRESS_FILE_ENV}="
                         f"/shipyard/task/{rel}"]
        # Trace-span sink + profiling request/artifact paths: same
        # mount remap — the agent reads all three host-side after
        # exit (SHIPYARD_TRACE_ID/_SPAN_ID are plain values and pass
        # through the generic -e loop above untouched).
        for var in ("SHIPYARD_TRACE_FILE",
                    "SHIPYARD_PROFILE_REQUEST_FILE",
                    "SHIPYARD_PROFILE_DIR",
                    "SHIPYARD_PREEMPT_REQUEST_FILE"):
            host_path = execution.env.get(var)
            if not host_path:
                continue
            host_dir = os.path.abspath(execution.task_dir)
            host_abs = os.path.abspath(host_path)
            if host_abs.startswith(host_dir + os.sep):
                rel = os.path.relpath(host_abs, host_dir)
                argv += ["-e", f"{var}=/shipyard/task/{rel}"]
        cache_dir = execution.env.get("SHIPYARD_COMPILE_CACHE_DIR")
        if cache_dir:
            # The node's persistent compile cache lives OUTSIDE the
            # task dir (it is shared by every task on the node): give
            # it its own mount and point the env at the mount, so the
            # containerized workload's warm entries land where the
            # agent's seed/export hooks find them.
            argv += ["-v",
                     f"{os.path.abspath(cache_dir)}:"
                     f"/shipyard/compilecache",
                     "-e", "SHIPYARD_COMPILE_CACHE_DIR="
                           "/shipyard/compilecache"]
        argv += list(execution.additional_docker_run_options)
        argv += [execution.image or "",
                 "/bin/bash", "-c", execution.command]
        return argv
    if execution.runtime == "singularity":
        argv = ["singularity", "exec"]
        if gpu_passthrough():
            argv += ["--nv", "--writable-tmpfs"]
        argv += list(execution.additional_singularity_options)
        argv += [execution.image or "",
                 "/bin/bash", "-c", execution.command]
        return argv
    raise ValueError(f"unknown runtime {execution.runtime!r}")


def run_task(execution: TaskExecution,
             base_env: Optional[dict[str, str]] = None,
             on_start=None) -> TaskResult:
    """Execute the task, streaming stdout/stderr to files in task_dir.

    Enforces max_wall_time by process-group kill (the agent-side analog
    of Azure Batch maxWallClockTime task constraints). ``on_start`` is
    called with the Popen handle once the process exists (used by the
    agent to support task termination).
    """
    if execution.runtime == "inproc":
        return _run_inproc(execution)
    os.makedirs(execution.task_dir, exist_ok=True)
    if execution.record_exit_code:
        # A stale sentinel from a previous attempt in the same task
        # dir must never classify THIS attempt's exit.
        for stale in (EXIT_CODE_FILENAME, EXIT_CODE_FILENAME + ".tmp"):
            try:
                os.remove(os.path.join(execution.task_dir, stale))
            except OSError:
                pass
    stdout_path = os.path.join(execution.task_dir, "stdout.txt")
    stderr_path = os.path.join(execution.task_dir, "stderr.txt")
    env = build_task_env(execution, base_env)
    argv = synthesize_command(execution)
    started_at = util.datetime_utcnow_iso()
    start = time.monotonic()
    timed_out = False
    wedged = False
    progress_file = execution.env.get(progress.PROGRESS_FILE_ENV)
    watchdog = execution.progress_deadline_seconds
    if progress_file:
        # Spawn counts as the first beat: the watchdog clock starts
        # now, and un-instrumented-but-opted-in tasks get the full
        # deadline before their first (never-coming) beat is due.
        progress.seed(progress_file)
    with open(stdout_path, "wb") as out, open(stderr_path, "wb") as err:
        proc = subprocess.Popen(
            argv, stdout=out, stderr=err, env=env, cwd=execution.task_dir,
            start_new_session=True)
        if on_start is not None:
            on_start(proc)
        policing = watchdog is not None and progress_file
        while True:
            if policing:
                timeout = _WATCHDOG_POLL_SECONDS
            elif execution.max_wall_time_seconds is not None:
                # Wall limit only: sleep straight to the deadline —
                # no 5 Hz wakeups over a multi-hour task lifetime.
                timeout = max(0.1, execution.max_wall_time_seconds
                              - (time.monotonic() - start))
            else:
                # Nothing to police: one blocking wait.
                timeout = None
            try:
                exit_code = proc.wait(timeout=timeout)
                break
            except subprocess.TimeoutExpired:
                pass
            elapsed = time.monotonic() - start
            if execution.max_wall_time_seconds is not None and \
                    elapsed > execution.max_wall_time_seconds:
                timed_out = True
                logger.warning(
                    "task %s/%s/%s exceeded wall time %.1fs; killing",
                    execution.pool_id, execution.job_id,
                    execution.task_id,
                    execution.max_wall_time_seconds)
                exit_code = _kill_task(
                    proc, grace_seconds=10.0,
                    container=container_name(execution))
                break
            if watchdog is not None and progress_file:
                beat = progress.last_beat(progress_file)
                stale = (elapsed if beat is None
                         else time.time() - beat)
                if stale > watchdog:
                    # Wedged: alive but no progress. SIGKILL straight
                    # away — the motivating hangs (TPU_WEDGE_REPORT.md)
                    # sit inside the runtime and never honor SIGTERM.
                    wedged = True
                    logger.warning(
                        "task %s/%s/%s made no progress for %.1fs "
                        "(deadline %.1fs); killing as wedged",
                        execution.pool_id, execution.job_id,
                        execution.task_id, stale, watchdog)
                    exit_code = _kill_task(
                        proc, grace_seconds=0.0,
                        container=container_name(execution))
                    break
    wall = time.monotonic() - start
    if execution.record_exit_code:
        # Belt to the shell trailer's suspenders: kill paths (wedge /
        # wall-time SIGKILL) never run the trailer, so the reaping
        # process records the code it saw. tmp+rename like the
        # trailer; best-effort — the adoption reader treats a missing
        # sentinel as an unknown (failed) exit.
        sentinel = os.path.join(execution.task_dir,
                                EXIT_CODE_FILENAME)
        try:
            util.atomic_write(sentinel, str(exit_code).encode())
        except OSError:
            logger.debug("exit-code sentinel write failed",
                         exc_info=True)
    return TaskResult(
        exit_code=exit_code, stdout_path=stdout_path,
        stderr_path=stderr_path, started_at=started_at,
        completed_at=util.datetime_utcnow_iso(), wall_seconds=wall,
        timed_out=timed_out, wedged=wedged)


# Watchdog poll granularity: how often a running task's wall-time and
# progress deadlines are re-checked. Small enough that tests with
# ~second deadlines stay sharp; large enough to cost nothing.
_WATCHDOG_POLL_SECONDS = 0.2


def _kill_task(proc, grace_seconds: float = 10.0,
               container: Optional[str] = None) -> int:
    """Kill a task's whole process group: SIGTERM with a grace window,
    then SIGKILL (grace_seconds=0 goes straight to SIGKILL — the
    wedge path, where SIGTERM provably never lands).

    For docker tasks the process-group escalation only reaches the
    docker CLIENT: SIGKILL is never proxied, so the container (and
    the accelerator it holds) would live on, and its fixed --name
    would break every retry landing on this node. Before the hard
    kill, force-remove the container so the workload actually dies
    and the name is freed. (SIGTERM in the grace window IS proxied
    by the client, so graceful shutdown still works.)"""
    if grace_seconds > 0:
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        except ProcessLookupError:
            pass
        try:
            return proc.wait(timeout=grace_seconds)
        except subprocess.TimeoutExpired:
            pass
    if container is not None:
        _force_remove_container(container)
    try:
        os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
    except ProcessLookupError:
        pass
    return proc.wait()


def _force_remove_container(name: str) -> None:
    try:
        subprocess.run(["docker", "rm", "-f", name],
                       stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, timeout=30)
    except Exception:  # noqa: BLE001 - kill escalation proceeds anyway
        logger.warning("docker rm -f %s failed", name, exc_info=True)


def format_command_line(argv: list[str]) -> str:
    return " ".join(shlex.quote(a) for a in argv)
