"""Shared bootstrap for distributed workload payloads.

Counterpart of batch_shipyard_tpu/workloads/distributed.py. The reference
reads the gang env of jobs/launcher.py and initialises jax.distributed;
the port reads the same ``SHIPYARD_TASK_INSTANCE(S)`` and torch's
launcher env (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, which ``python -m torch.distributed.run`` sets) and
initialises a ``gloo`` process group. gloo, not NCCL: the ring kernels
move the data themselves and need the group only to exchange buffer
handles and to meet at barriers, and NCCL refuses two ranks on one card,
which is how ``chip_smoke.py`` runs its four sequence-parallel ranks.

``launch_local`` starts N local ranks of a command with that env, for the
tests and the smoke run.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import tempfile
import time
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from batch_shipyard_tpu_torch.device import resolve_device

# gloo's timeout for one collective or point-to-point operation.
PROCESS_GROUP_TIMEOUT_S = 600


def _env_int(*names: str, default: int) -> int:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return default


def setup(device=None) -> dict:
    """Initialise the default process group when more than one rank runs
    (RANK/WORLD_SIZE, else SHIPYARD_TASK_INSTANCE/INSTANCES) and pick this
    rank's device: ``cuda:(LOCAL_RANK % device_count)`` unless ``device``
    names the CPU (``resolve_device``: no CUDA and no "cpu" raises).
    Returns the rank and topology as a dict, with ``started``: the
    ``time.perf_counter()`` at the call, from which a workload counts its
    time to the first step."""
    started = time.perf_counter()
    instances = _env_int("SHIPYARD_TASK_INSTANCES", default=1)
    instance = _env_int("SHIPYARD_TASK_INSTANCE", default=0)
    world = _env_int("WORLD_SIZE", default=instances)
    rank = _env_int("RANK", default=instance)
    local_rank = _env_int("LOCAL_RANK", default=rank)
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if world > 1 and not dist.is_initialized():
        if not os.environ.get("MASTER_ADDR") or \
                not os.environ.get("MASTER_PORT"):
            raise RuntimeError(
                f"{world} ranks need MASTER_ADDR and MASTER_PORT (run under "
                f"python -m torch.distributed.run, or set them)")
        os.environ.setdefault("RANK", str(rank))
        os.environ.setdefault("WORLD_SIZE", str(world))
        dist.init_process_group(
            "gloo", init_method="env://", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=PROCESS_GROUP_TIMEOUT_S))
    return {"instances": instances, "instance": instance,
            "process_index": rank, "process_count": world,
            "local_rank": local_rank, "device": dev, "started": started}


def log(ctx: dict, message: str) -> None:
    print(f"[proc {ctx['process_index']}/{ctx['process_count']}] "
          f"{message}", flush=True)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on right now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_local(argv: Sequence[str], nprocs: int, timeout_s: float,
                 env: Optional[dict] = None, cwd=None) -> list[dict]:
    """Run ``nprocs`` local ranks of ``argv`` (a command line) with the
    env ``setup`` reads, on a free localhost port, and wait for all of
    them. Ranks still running after ``timeout_s`` are killed. Output goes
    to files, so a rank never blocks on a full pipe. Returns one
    {"rank", "returncode", "stdout", "stderr", "timed_out"} per rank."""
    port = free_port()
    procs, files = [], []
    for rank in range(nprocs):
        rank_env = dict(os.environ if env is None else env)
        rank_env.update(RANK=str(rank), LOCAL_RANK=str(rank),
                        WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
        files.append((out, err))
        procs.append(subprocess.Popen(list(argv), env=rank_env, cwd=cwd,
                                      stdout=out, stderr=err, text=True))
    deadline = time.monotonic() + timeout_s
    timed_out = set()
    for rank, proc in enumerate(procs):
        try:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            timed_out.update(r for r, p in enumerate(procs)
                             if p.poll() is None)
            for other in procs:
                if other.poll() is None:
                    other.kill()
                    other.wait()
    results = []
    for rank, (proc, (out, err)) in enumerate(zip(procs, files)):
        out.seek(0)
        err.seek(0)
        results.append({"rank": rank, "returncode": proc.returncode,
                        "stdout": out.read(), "stderr": err.read(),
                        "timed_out": rank in timed_out})
        out.close()
        err.close()
    return results
