"""Compute substrate interface: where nodes come from.

The port's copy of batch_shipyard_tpu/substrate/base.py. The reference's
L0 is Azure Batch pool allocation (create_pool batch.py:921 -> service
allocates VMs -> start task runs nodeprep). The port's substrates
provision cloud H100 VMs (``tpu_vm``, the schema's value for the cloud
substrate: one GCE A3 VM a node, substrate/gcp_gpu.py), simulate nodes
in-process (fake — the test substrate SURVEY.md section 4 calls for) or
run agents as local processes (localhost — used to drive the host's GPUs
end-to-end).

Pool semantics note (SURVEY.md section 7 hard parts): in the reference a
TPU pod slice is allocated atomically with N workers, so the substrate
interface exposes slice-granular operations and the pool manager maps
node-granular recovery requests onto them. The port keeps that
interface: a local GPU pool is one slice of N nodes, and a cloud GPU
pool's VM is a slice of its own (each VM is its unit of recovery).
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Optional

from batch_shipyard_tpu_torch.config.settings import (
    CredentialsSettings, PoolSettings)
from batch_shipyard_tpu_torch.state.base import StateStore


@dataclasses.dataclass(frozen=True)
class NodeInfo:
    node_id: str
    state: str
    hostname: str
    internal_ip: str
    node_index: int
    slice_index: int
    worker_index: int
    # Self-healing surface: the agent's health score in [0, 1] and
    # whether the node quarantined itself (auto-drain; excluded from
    # claims and gang formation).
    health: float = 1.0
    quarantined: bool = False


class ComputeSubstrate(abc.ABC):
    """Allocates and manages the machines of one or more pools."""

    @abc.abstractmethod
    def allocate_pool(self, pool: PoolSettings) -> None:
        """Begin allocation of all slices/nodes; returns immediately.
        Node state convergence is observed via TABLE_NODES."""

    @abc.abstractmethod
    def deallocate_pool(self, pool_id: str) -> None: ...

    @abc.abstractmethod
    def resize_pool(self, pool: PoolSettings, num_slices: int) -> None:
        """Grow/shrink to num_slices slices (TPU) or num nodes
        (VM pools)."""

    @abc.abstractmethod
    def recreate_slice(self, pool: PoolSettings, slice_index: int) -> None:
        """Tear down and re-allocate one slice ('reboot' analog)."""

    def deallocate_slice(self, pool: PoolSettings,
                         slice_index: int) -> None:
        """Tear down one slice WITHOUT replacement ('pool nodes del'
        analog — TPU removal granularity is the slice; the pool
        shrinks until a resize grows it back)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support slice "
            f"deallocation")

    @abc.abstractmethod
    def get_remote_login(self, pool_id: str,
                         node_id: str) -> Optional[tuple[str, int]]:
        """(ip, ssh port) for a node, if reachable."""

    def suspend_pool(self, pool: PoolSettings) -> None:
        """Stop the pool's machines without losing its definition
        (suspend/start parity: reference fleet.py:3203+ for fs/monitor/
        fed/slurm resources; TPU VMs support stop/start)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support suspend")

    def start_pool(self, pool: PoolSettings) -> None:
        """Restart a suspended pool's machines."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support start")

    def ensure_attached(self, pool: PoolSettings) -> None:
        """Re-attach to an existing pool from a fresh process.

        Real substrates are no-ops (nodes are independent machines);
        the in-process fake substrate revives its simulated agents so
        CLI invocations in separate processes keep working.
        """


def create_substrate(kind: str, store: StateStore,
                     credentials: CredentialsSettings,
                     **kwargs) -> ComputeSubstrate:
    if kind == "fake":
        from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate
        return FakePodSubstrate(store, **kwargs)
    if kind == "localhost":
        from batch_shipyard_tpu_torch.substrate.localhost import (
            LocalhostSubstrate)
        return LocalhostSubstrate(store, credentials, **kwargs)
    if kind == "tpu_vm":
        from batch_shipyard_tpu_torch.substrate.gcp_gpu import (
            GcpGpuSubstrate)
        return GcpGpuSubstrate(store, credentials, **kwargs)
    raise ValueError(f"unknown substrate {kind!r}")
