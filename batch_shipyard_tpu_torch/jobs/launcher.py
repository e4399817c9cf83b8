"""Gang-task launcher: torch.distributed env synthesis for GPU pools.

The port's copy of batch_shipyard_tpu/jobs/launcher.py, the replacement
for the reference's MPI command-line synthesis (_construct_mpi_command,
convoy/batch.py:4362-4487). The coordinator election is the reference's
(lowest slice, worker, instance), so both packages pick the same member
for the same gang. In place of the JAX/TPU variables each member gets
the env that ``torch.distributed`` reads:

  - ``MASTER_ADDR`` / ``MASTER_PORT``: the coordinator's internal IP and
    the job's ``jax_distributed.coordinator_port`` (default 8476, the
    port the reference's PyTorch/XLA env uses too);
  - ``WORLD_SIZE`` = instances, ``RANK`` = this instance,
    ``LOCAL_RANK`` 0 and ``LOCAL_WORLD_SIZE`` 1: one process a member,
    which workloads/distributed.setup reads as it is;
  - torch.distributed.run's own ``PET_NNODES``, ``PET_NODE_RANK``,
    ``PET_NPROC_PER_NODE`` (the node's GPUs), ``PET_MASTER_ADDR`` and
    ``PET_MASTER_PORT``, so ``python -m torch.distributed.run -m
    <workload>`` on a node with several GPUs needs no flags; its
    children get their own ``RANK`` and ``LOCAL_RANK`` from it.

``multi_instance.jax_distributed.enabled`` and ``pytorch_xla`` both give
this env, and it never holds ``PJRT_DEVICE``. The reference's
multi-slice ``MEGASCALE_*`` has no counterpart: a GPU pool's nodes form
one flat gang, so ``transport`` and ``num_slices`` change nothing here.

The application command runs on EVERY instance (SPMD), as on the
reference's TPU pods; the optional coordination_command (reference:
MultiInstanceSettings coordination command, batch.py:4616) still runs on
all instances before it.
"""

from __future__ import annotations

import dataclasses

from batch_shipyard_tpu_torch.config.settings import (
    MultiInstanceSettings, PoolSettings)


@dataclasses.dataclass(frozen=True)
class GangMember:
    """One task instance's placement, resolved at rendezvous time."""

    instance: int           # global process index [0, num_instances)
    node_id: str
    hostname: str
    internal_ip: str
    slice_index: int = 0
    worker_index: int = 0   # worker index within its slice


def _coordinator(members: list[GangMember]) -> GangMember:
    """Deterministic coordinator election: lowest (slice, worker,
    instance). Reference analog: MI 'primary' node; ours must be stable
    across restarts (SURVEY.md section 7 hard parts: no PMI)."""
    return min(members,
               key=lambda m: (m.slice_index, m.worker_index, m.instance))


def synthesize_pytorch_xla_env(members: list[GangMember],
                               member: GangMember,
                               coordinator_port: int = 8476,
                               ) -> dict[str, str]:
    """The rendezvous four that torch.distributed's env:// init reads:
    the reference's PyTorch/XLA env without its ``PJRT_DEVICE``."""
    coord = _coordinator(members)
    return {
        "MASTER_ADDR": coord.internal_ip,
        "MASTER_PORT": str(coordinator_port),
        "WORLD_SIZE": str(len(members)),
        "RANK": str(member.instance),
    }


def synthesize_torch_distributed_env(members: list[GangMember],
                                     member: GangMember,
                                     coordinator_port: int = 8476,
                                     gpus_per_node: int = 1,
                                     ) -> dict[str, str]:
    """The full env of one gang member (module doc)."""
    env = synthesize_pytorch_xla_env(members, member, coordinator_port)
    env.update({
        "LOCAL_RANK": "0",
        "LOCAL_WORLD_SIZE": "1",
        "PET_NNODES": str(len(members)),
        "PET_NODE_RANK": str(member.instance),
        "PET_NPROC_PER_NODE": str(max(1, gpus_per_node)),
        "PET_MASTER_ADDR": env["MASTER_ADDR"],
        "PET_MASTER_PORT": env["MASTER_PORT"],
    })
    return env


def synthesize_gang_env(members: list[GangMember],
                        member: GangMember,
                        mi: MultiInstanceSettings,
                        pool: PoolSettings) -> dict[str, str]:
    """Full env for one gang member per the task's multi_instance
    settings and the pool's GPUs a node."""
    if not (mi.jax_distributed.enabled or mi.pytorch_xla):
        return {}
    return synthesize_torch_distributed_env(
        members, member, mi.jax_distributed.coordinator_port,
        gpus_per_node=pool.gpus_per_node)
