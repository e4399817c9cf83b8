"""The port's gang env (jobs/launcher.py) against the reference's: the
same coordinator, torch.distributed's rendezvous where the reference puts
JAX's, the reference's PyTorch/XLA env without PJRT_DEVICE, and no JAX,
TPU, MEGASCALE or PJRT key, over gang sizes, member orders and
multi-slice member lists."""

import random

import pytest

from batch_shipyard_tpu.config import settings as ref_settings
from batch_shipyard_tpu.jobs import launcher as ref_launcher
from batch_shipyard_tpu_torch.config import settings as port_settings
from batch_shipyard_tpu_torch.jobs import launcher

FOREIGN = ("JAX_", "TPU_", "MEGASCALE_", "PJRT_")


def _members(module, size: int, slices: int, shuffle: bool) -> list:
    per_slice = size // slices
    members = [module.GangMember(
        instance=k, node_id=f"node-{k}", hostname=f"host-{k}",
        internal_ip=f"10.{k // per_slice}.0.{k % per_slice + 1}",
        slice_index=k // per_slice, worker_index=k % per_slice)
        for k in range(size)]
    if shuffle:
        random.Random(size * 31 + slices).shuffle(members)
    return members


def _mi(module, size: int, port: int, xla: bool):
    return module.MultiInstanceSettings(
        num_instances=size, min_instances=None, coordination_command=None,
        resource_files=(),
        jax_distributed=module.JaxDistributedSettings(
            enabled=not xla, coordinator_port=port, transport="auto",
            heartbeat_timeout_seconds=100),
        pytorch_xla=xla)


@pytest.mark.parametrize("size,slices,shuffle", [
    (1, 1, False), (2, 1, False), (4, 1, False), (8, 1, False),
    (4, 1, True), (8, 1, True), (8, 2, True), (4, 2, False)])
def test_gang_env_matches_the_reference(size, slices, shuffle):
    port = 8476 + size
    ref_pool = ref_settings.pool_settings({"pool_specification": {
        "id": "p", "substrate": "fake",
        "tpu": {"accelerator_type": "v5litepod-16", "num_slices": slices}}})
    pool = port_settings.pool_settings({"pool_specification": {
        "id": "p", "substrate": "fake",
        "vm_configuration": {"vm_size": "a3-highgpu-8g",
                             "vm_count": {"dedicated": size}}}})
    ref_members = _members(ref_launcher, size, slices, shuffle)
    members = _members(launcher, size, slices, shuffle)
    coord = launcher._coordinator(members)
    assert coord.instance == ref_launcher._coordinator(ref_members).instance
    for ref_member, member in zip(ref_members, members):
        ref_env = ref_launcher.synthesize_gang_env(
            ref_members, ref_member, _mi(ref_settings, size, port, False),
            ref_pool)
        env = launcher.synthesize_gang_env(
            members, member, _mi(port_settings, size, port, False), pool)
        assert (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}" ==
                ref_env["JAX_COORDINATOR_ADDRESS"] ==
                f"{coord.internal_ip}:{port}")
        assert env["RANK"] == ref_env["JAX_PROCESS_ID"] == str(
            member.instance)
        assert env["WORLD_SIZE"] == ref_env["JAX_NUM_PROCESSES"] == str(size)
        assert env["LOCAL_RANK"] == "0" and env["LOCAL_WORLD_SIZE"] == "1"
        assert env["PET_NNODES"] == str(size)
        assert env["PET_NODE_RANK"] == env["RANK"]
        assert env["PET_NPROC_PER_NODE"] == "8"
        assert env["PET_MASTER_ADDR"] == env["MASTER_ADDR"]
        assert env["PET_MASTER_PORT"] == env["MASTER_PORT"]
        assert not [k for k in env if k.startswith(FOREIGN)]
        # pytorch_xla: the reference's PJRT env less PJRT_DEVICE, and the
        # same gang env as jax_distributed.
        ref_xla = ref_launcher.synthesize_gang_env(
            ref_members, ref_member, _mi(ref_settings, size, port, True),
            ref_pool)
        xla = launcher.synthesize_gang_env(
            members, member, _mi(port_settings, size, port, True), pool)
        assert ref_xla.pop("PJRT_DEVICE") == "TPU"
        assert launcher.synthesize_pytorch_xla_env(
            members, member, port) == ref_xla
        assert {k: xla[k] for k in ref_xla} == ref_xla
        assert xla == env
