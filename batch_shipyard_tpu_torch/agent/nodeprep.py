"""Node preparation: make an H100 node ready to run tasks.

The port's copy of batch_shipyard_tpu/agent/nodeprep.py (reference
analog: scripts/shipyard_nodeprep.sh). Where the TPU node counts
/dev/accel* and checks (or pip-installs) JAX, the GPU node counts its
/dev/nvidia<N> devices and checks, in a subprocess with a hard timeout
(utils/util.probe_cuda), that torch imports with CUDA and sees as many
devices as /dev holds. It installs nothing: a node whose probe fails
reports ``torch_cuda_ready:False`` and its tasks fail loudly on the
device (device.resolve_device raises); nothing moves them to the CPU.

Phases (each emits a perf event, in the reference's order, so the
phase breakdown and the gantt read them alike):

  1. env probe        — ``gpus:<n>``; docker present?
  2. docker setup     — registry logins (config from credentials)
  3. torch/CUDA check — ``torch_cuda_ready:<bool>`` on a GPU pool
  4. monitors         — node exporter / cadvisor launch (if enabled)
  5. cascade          — pull the pool's global images (lease-gated)

Idempotency marker handling lives in NodeAgent.start (reboot-resume
fast path, reference nodeprep.sh:1935-1970).
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess

from batch_shipyard_tpu_torch.agent import perf
from batch_shipyard_tpu_torch.agent.cascade import CascadeImageProvisioner
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)


# /dev/nvidia<N> is one GPU; nvidiactl, nvidia-uvm, nvidia-uvm-tools,
# nvidia-modeset and the nvidia-caps dir are the driver's own nodes.
_GPU_NODE = re.compile(r"nvidia(\d+)")


def detect_gpus(dev_root: str = "/dev") -> int:
    """Count the GPUs this node's driver exposes under ``dev_root``."""
    try:
        entries = os.listdir(dev_root)
    except OSError:
        return 0
    return sum(1 for name in entries if _GPU_NODE.fullmatch(name))


def ensure_torch_cuda(expected_gpus: int,
                      timeout: float = 75.0) -> tuple[bool, str]:
    """Whether torch imports with CUDA and counts at least one and at
    most ``expected_gpus`` devices, probed in a subprocess
    (utils/util.probe_cuda). Returns (ok, what the probe saw). Fewer
    devices than /dev holds is ready: a container or
    $CUDA_VISIBLE_DEVICES may give this node's processes a subset of the
    host's device nodes (a container can show /dev/nvidia0 and
    /dev/nvidia7 where torch counts one H100). Never installs
    anything."""
    info, error = util.probe_cuda(timeout)
    if error is not None:
        return False, error
    if not info.get("cuda"):
        return False, f"torch {info.get('torch')} is built without CUDA"
    seen = (f"torch {info.get('torch')} (CUDA {info['cuda']}) counts "
            f"{info['count']} of {expected_gpus} /dev/nvidia<N>")
    return 1 <= info["count"] <= expected_gpus, seen


def run_node_prep(agent) -> None:
    """Full node prep for a real (or localhost) node agent."""
    store = agent.store
    pool_id = agent.identity.pool_id
    node_id = agent.identity.node_id
    pool = agent.pool

    perf.emit(store, pool_id, node_id, "nodeprep", "start")
    gpus = detect_gpus()
    perf.emit(store, pool_id, node_id, "nodeprep", f"gpus:{gpus}")

    if "docker" in pool.container_runtimes:
        if shutil.which("docker") is None:
            logger.warning(
                "docker runtime requested but docker not installed on "
                "%s; docker tasks will fail", node_id)
        perf.emit(store, pool_id, node_id, "nodeprep", "docker_install")
    if ("kata_containers" in pool.container_runtimes or
            pool.container_runtime_default == "kata_containers"):
        if shutil.which("kata-runtime") is None:
            logger.warning(
                "kata_containers runtime requested but kata-runtime "
                "not installed on %s; kata tasks will fail", node_id)
        perf.emit(store, pool_id, node_id, "nodeprep", "kata_install")

    if pool.is_gpu_pool:
        ok, seen = ensure_torch_cuda(gpus)
        if not ok:
            logger.error("node %s: torch/CUDA not ready: %s", node_id,
                         seen)
        perf.emit(store, pool_id, node_id, "nodeprep",
                  f"torch_cuda_ready:{ok}", message=seen)

    for idx, command in enumerate(pool.additional_node_prep_commands):
        rc = subprocess.call(["/bin/bash", "-c", command])
        perf.emit(store, pool_id, node_id, "nodeprep",
                  f"additional_command:{idx}", message=str(rc))
        if rc != 0:
            raise RuntimeError(
                f"additional node prep command {idx} failed rc={rc}")

    if pool.node_exporter.enabled or pool.cadvisor.enabled:
        _launch_monitors(agent)

    # Cascade: prefetch pool images (blocks if pool policy says so).
    provisioner = getattr(agent, "_image_provisioner", None)
    if provisioner is None:
        provisioner = CascadeImageProvisioner(store)
    if isinstance(provisioner, CascadeImageProvisioner) and (
            pool.block_until_all_global_resources_loaded):
        provisioner.distribute_global_resources(agent)

    perf.emit(store, pool_id, node_id, "nodeprep", "end")


def _launch_monitors(agent) -> None:
    """Start prometheus node_exporter / cadvisor if present on PATH
    (reference: nodeprep.sh:1752-1827)."""
    pool = agent.pool
    if pool.node_exporter.enabled and shutil.which("node_exporter"):
        subprocess.Popen(
            ["node_exporter", "--web.listen-address",
             f":{pool.node_exporter.port}"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    if pool.cadvisor.enabled and shutil.which("cadvisor"):
        subprocess.Popen(
            ["cadvisor", "-port", str(pool.cadvisor.port)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    perf.emit(agent.store, agent.identity.pool_id,
              agent.identity.node_id, "nodeprep", "monitors_launched")
