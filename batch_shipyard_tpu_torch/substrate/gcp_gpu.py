"""The cloud H100 pool: one GCE A3 VM per pool node.

The port's counterpart of batch_shipyard_tpu/substrate/gcp_tpu.py, built
by ``create_substrate("tpu_vm", ...)`` for a GPU pool (``tpu_vm`` is the
pool schema's value and default for "the cloud substrate"). A pool of
``vm_configuration.vm_size: a3-highgpu-8g`` is ``vm_count.dedicated`` +
``vm_count.low_priority`` Compute Engine VMs of that machine type, each
created through substrate/gce_vm.py. A3 machine types carry their GPUs,
so no ``--accelerator`` flag is given; GPU VMs cannot live-migrate, so
every VM has ``--maintenance-policy=TERMINATE``; low-priority nodes are
spot VMs (``--provisioning-model=SPOT``) deleted when reclaimed. The
boot image is ``vm_configuration.image``, the network and subnet the
pool's ``virtual_network``, the zone the pool's or the credentials'.

A VM pool resizes in nodes, and each VM is its own unit of recovery:
node i is VM ``shipyard-<pool>-n<i>``, with ``slice_index`` = i, so
``recreate_slice`` / ``deallocate_slice`` act on that one VM. The VM's
startup script (``_bootstrap_script``, run at every boot) writes the
node agent's bootstrap and starts ``python3 -m
batch_shipyard_tpu_torch.agent``, which then pulls work from the state
store like the fake and localhost substrates' agents. Failed creates are
classified (substrate/gcloud_errors.py) onto the pool entity, with the
zones that still offer the GPU type after a stockout
(substrate/quota.py).

The agent's first state write replaces its node row, so nothing here
depends on columns the substrate wrote: a node's VM is named from its
``node_index`` and its zone is the pool's, and ``pool del`` from a fresh
process deletes the pool's VMs by their rows.

Requires the ``gcloud`` CLI (or an injected ``runner``) and
``credentials.gcp``; constructing the substrate without them raises.
"""

from __future__ import annotations

import base64
import json
import shutil
import time as _time
from typing import Optional

from batch_shipyard_tpu_torch.config.settings import (
    CredentialsSettings, PoolSettings)
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import NotFoundError, StateStore
from batch_shipyard_tpu_torch.substrate import base
from batch_shipyard_tpu_torch.substrate import gcloud_errors
from batch_shipyard_tpu_torch.substrate import quota as quota_mod
from batch_shipyard_tpu_torch.substrate.gce_vm import GceVmError, GceVmManager
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

# Where the agent lives on a node (its bootstrap, log and work dir).
NODE_WORK_DIR = "/var/shipyard"
# Boot disk of a node: the image, the task images and the compile cache.
BOOT_DISK_GB = 200
# What a reclaimed spot VM becomes: deleted (its disk and address go with
# it), and the pool recreates the node.
SPOT_TERMINATION_ACTION = "DELETE"


def node_id(pool_id: str, node_index: int) -> str:
    return f"{pool_id}-n{node_index}"


def vm_name(pool_id: str, node_index: int) -> str:
    """The VM of a pool node. Compute Engine names are lower case
    letters, digits and hyphens."""
    return f"shipyard-{pool_id}-n{node_index}".lower().replace("_", "-")


def _image_args(image: Optional[str]) -> list[str]:
    """``instances create`` flags for vm_configuration.image: a bare
    name, ``projects/P/global/images/NAME`` or
    ``projects/P/global/images/family/FAMILY``."""
    if not image:
        return []
    parts = image.strip("/").split("/")
    if len(parts) >= 4 and parts[0] == "projects" and \
            parts[2:4] == ["global", "images"]:
        project = f"--image-project={parts[1]}"
        if len(parts) == 6 and parts[4] == "family":
            return [f"--image-family={parts[5]}", project]
        if len(parts) == 5:
            return [f"--image={parts[4]}", project]
    return [f"--image={image}"]


class GcpGpuSubstrate(base.ComputeSubstrate):
    def __init__(self, store: StateStore,
                 credentials: CredentialsSettings,
                 bootstrap_bundle_key: Optional[str] = None,
                 runner=None, quota_client=None) -> None:
        if runner is None and shutil.which("gcloud") is None:
            raise RuntimeError(
                "gcloud CLI is required for the tpu_vm substrate; use "
                "substrate: fake or localhost without it")
        if credentials.gcp is None:
            raise ValueError(
                "credentials.gcp is required for the tpu_vm substrate")
        self.store = store
        self.credentials = credentials
        self.project = credentials.gcp.project
        self.zone = credentials.gcp.zone
        self.bootstrap_bundle_key = bootstrap_bundle_key
        self._runner = runner or util.subprocess_capture
        self.quota_client = quota_client

    # ------------------------------ helpers ----------------------------

    def _vms(self, zone: Optional[str],
             network: Optional[str] = None) -> GceVmManager:
        return GceVmManager(self.project, zone=zone, network=network,
                            runner=self._runner)

    @staticmethod
    def _require_gpus(pool: PoolSettings) -> None:
        if not pool.is_gpu_pool:
            raise ValueError(
                f"pool {pool.id}: the tpu_vm substrate provisions GPU "
                f"VMs, and vm_configuration.vm_size {pool.vm_size!r} has "
                f"no GPUs (name an A3 machine type, e.g. a3-highgpu-8g)")

    def _pool_zone(self, pool_id: str) -> Optional[str]:
        """The zone of a pool known only by id (a fresh process): its
        stored spec's, else the credentials'."""
        try:
            entity = self.store.get_entity(names.TABLE_POOLS, "pools",
                                           pool_id)
        except NotFoundError:
            return self.zone
        spec = (entity.get("spec") or {}).get("pool_specification") or {}
        return spec.get("zone") or self.zone

    def _node_rows(self, pool_id: str) -> list[dict]:
        return sorted(self.store.query_entities(
            names.TABLE_NODES, partition_key=pool_id),
            key=lambda row: int(row.get("node_index", 0)))

    def _row_vm(self, pool_id: str, row: dict) -> tuple[str, Optional[str]]:
        """(VM name, zone) of a node row."""
        name = row.get("vm_name") or vm_name(
            pool_id, int(row.get("node_index", 0)))
        return name, row.get("zone") or self._pool_zone(pool_id)

    @staticmethod
    def _spot(pool: PoolSettings, node_index: int) -> bool:
        """Nodes [dedicated, dedicated + low_priority) are the pool's
        low-priority ones; any index past them (a resize beyond the
        configured counts) is on demand."""
        return (pool.vm_count_dedicated <= node_index <
                pool.vm_count_dedicated + pool.vm_count_low_priority)

    def _create_args(self, pool: PoolSettings, node_index: int) -> list[str]:
        args = ["--maintenance-policy=TERMINATE"]
        if self._spot(pool, node_index):
            args += ["--provisioning-model=SPOT",
                     f"--instance-termination-action="
                     f"{SPOT_TERMINATION_ACTION}"]
        args += _image_args(pool.image)
        if pool.subnetwork:
            args.append(f"--subnet={pool.subnetwork}")
        return args

    # ---------------------------- interface ----------------------------

    def allocate_pool(self, pool: PoolSettings) -> None:
        self._require_gpus(pool)
        for i in range(pool.current_node_count):
            self._create_node(pool, i)

    def _create_node(self, pool: PoolSettings, node_index: int) -> None:
        name = vm_name(pool.id, node_index)
        zone = pool.zone or self.zone
        nid = node_id(pool.id, node_index)
        # Registered before the create: the VM's startup script may
        # start the agent (whose first write replaces this row) before
        # the create returns.
        self.store.upsert_entity(names.TABLE_NODES, pool.id, nid, {
            "state": "creating", "hostname": name, "internal_ip": "",
            "node_index": node_index, "slice_index": node_index,
            "worker_index": 0, "vm_name": name, "zone": zone,
            "low_priority": self._spot(pool, node_index),
            "registered_at": _time.time()})
        vms = self._vms(zone, pool.network)
        script = _bootstrap_script(
            pool, self.credentials.storage, node_index,
            bundle_key=self.bootstrap_bundle_key or "")
        try:
            vms.create_vm(name, pool.vm_size, startup_script=script,
                          boot_disk_size_gb=BOOT_DISK_GB,
                          extra_args=self._create_args(pool, node_index))
        except GceVmError as exc:
            self._record_allocation_error(pool, exc)
            self.store.delete_entity(names.TABLE_NODES, pool.id, nid)
            raise
        desc = vms.describe(name)
        nic = (desc.get("networkInterfaces") or [{}])[0]
        access = (nic.get("accessConfigs") or [{}])[0]
        try:
            self.store.merge_entity(names.TABLE_NODES, pool.id, nid, {
                "internal_ip": nic.get("networkIP", ""),
                "external_ip": access.get("natIP", ""),
                "vm_name": name, "zone": zone})
        except NotFoundError:
            pass  # deleted while it was being created

    def _record_allocation_error(self, pool: PoolSettings,
                                 exc: Exception) -> None:
        err = gcloud_errors.classify(str(exc))
        record = {
            "allocation_error": str(exc),
            "allocation_error_kind": err.kind,
            "allocation_error_fatal": err.fatal,
            "allocation_error_retry": err.retry}
        if err.retry == "other_zone":
            advisory = self._stockout_advisory(pool)
            if advisory:
                record["allocation_error_advisory"] = advisory
        self.store.merge_entity(
            names.TABLE_POOLS, "pools", pool.id, record)

    def _stockout_advisory(self, pool: PoolSettings) -> Optional[str]:
        """On stockout, name sibling zones still offering the GPU type
        (substrate/quota.py; advisory only — never raises)."""
        try:
            gpu = quota_mod.gpu_type(pool.vm_size)
            if gpu is None:
                return None
            client = self.quota_client or quota_mod.GpuQuotaClient(
                self.project, runner=self._runner)
            failed_zone = pool.zone or self.zone or ""
            region = quota_mod._zone_region(failed_zone)
            candidates = [f"{region}-{s}" for s in "abcdef"]
            return quota_mod.stockout_advisory(
                client, gpu[0], failed_zone, candidates)
        except Exception:  # noqa: BLE001 - advisory only
            return None

    def _delete_node(self, pool_id: str, row: dict) -> None:
        name, zone = self._row_vm(pool_id, row)
        try:
            self._vms(zone).delete_vm(name)
        except GceVmError as exc:
            if gcloud_errors.classify(str(exc)).kind != "not_found":
                raise
            logger.info("VM %s was already gone", name)
        try:
            self.store.delete_entity(names.TABLE_NODES, pool_id,
                                     row["_rk"])
        except NotFoundError:
            pass

    def deallocate_pool(self, pool_id: str) -> None:
        for row in self._node_rows(pool_id):
            try:
                self._delete_node(pool_id, row)
            except GceVmError:
                logger.exception("failed deleting the VM of node %s",
                                 row["_rk"])

    def resize_pool(self, pool: PoolSettings, num_nodes: int) -> None:
        """Grow or shrink to ``num_nodes`` VMs: new nodes take the
        lowest free indices, a shrink deletes the highest."""
        self._require_gpus(pool)
        rows = self._node_rows(pool.id)
        if num_nodes > len(rows):
            have = {int(row.get("node_index", -1)) for row in rows}
            free = [i for i in range(num_nodes + len(rows))
                    if i not in have][:num_nodes - len(rows)]
            for i in free:
                self._create_node(pool, i)
        else:
            for row in rows[num_nodes:]:
                self._delete_node(pool.id, row)

    def _row_of(self, pool_id: str, node_index: int) -> Optional[dict]:
        for row in self._node_rows(pool_id):
            if int(row.get("node_index", -1)) == node_index:
                return row
        return None

    def recreate_slice(self, pool: PoolSettings, slice_index: int) -> None:
        row = self._row_of(pool.id, slice_index)
        if row is not None:
            try:
                self._delete_node(pool.id, row)
            except GceVmError:
                logger.warning("delete of node %d failed; recreating "
                               "anyway", slice_index)
        self._create_node(pool, slice_index)

    def deallocate_slice(self, pool: PoolSettings,
                         slice_index: int) -> None:
        row = self._row_of(pool.id, slice_index)
        if row is not None:
            self._delete_node(pool.id, row)

    def refresh_node_states(self, pool: PoolSettings) -> None:
        """Poll each VM's status and mark the nodes of reclaimed VMs
        'preempted' — the preemption sample feeding autoscale
        rebalance_preemption_percentage and node-recreate recovery.
        Called by the autoscale tick; one describe a node. A node the
        pool suspended reads TERMINATED like a reclaimed one, so its
        row's ``suspended`` state exempts it."""
        for row in self._node_rows(pool.id):
            if row.get("state") == "preempted":
                continue
            name, zone = self._row_vm(pool.id, row)
            try:
                status = self._vms(zone).vm_status(name)
            except GceVmError as exc:
                if gcloud_errors.classify(str(exc)).kind == "not_found":
                    # The VM is gone: a spot VM is deleted when
                    # reclaimed.
                    status = "TERMINATED"
                else:
                    # A transient describe failure is NOT evidence of
                    # preemption.
                    logger.warning(
                        "describe of %s failed (%s); skipping the "
                        "preemption check this tick", name, exc)
                    continue
            if not gcloud_errors.is_preemption_state(
                    status, stopped_by_pool=row.get("state") ==
                    "suspended"):
                continue
            logger.warning("VM %s is %s; marking node %s preempted",
                           name, status, row["_rk"])
            self.store.merge_entity(names.TABLE_NODES, pool.id,
                                    row["_rk"], {"state": "preempted"})

    def suspend_pool(self, pool: PoolSettings) -> None:
        """``instances stop`` on every node's VM (billing pause; the
        disks stay)."""
        for row in self._node_rows(pool.id):
            name, zone = self._row_vm(pool.id, row)
            self._vms(zone).stop_vm(name)
            self.store.merge_entity(names.TABLE_NODES, pool.id,
                                    row["_rk"], {"state": "suspended"})

    def start_pool(self, pool: PoolSettings) -> None:
        """``instances start`` on every node's VM; its startup script
        starts the agent again at boot."""
        for row in self._node_rows(pool.id):
            name, zone = self._row_vm(pool.id, row)
            self._vms(zone).start_vm(name)

    def get_remote_login(self, pool_id: str,
                         node_id: str) -> Optional[tuple[str, int]]:
        try:
            row = self.store.get_entity(names.TABLE_NODES, pool_id,
                                        node_id)
        except KeyError:
            return None
        ip = row.get("external_ip")
        if not ip:
            # The agent's row holds no external address: ask the VM.
            name, zone = self._row_vm(pool_id, row)
            try:
                nic = (self._vms(zone).describe(name).get(
                    "networkInterfaces") or [{}])[0]
                ip = (nic.get("accessConfigs") or [{}])[0].get("natIP")
            except GceVmError:
                ip = None
        ip = ip or row.get("internal_ip")
        return (ip, 22) if ip else None


def _bootstrap_script(pool: PoolSettings, storage, node_index: int,
                      bundle_key: str) -> str:
    """The VM's startup script: it runs as root at every boot and starts
    the node agent.

    The boot template travels base64-encoded (no quoting hazards); a
    small python fills in what only the VM knows, its hostname and
    internal IP (the metadata server's, else the resolver's). The pool
    fields are the ones the agent and its node prep read: with
    ``vm_size`` the node prep sees a GPU pool and checks the cards."""
    template = {
        "storage": {"backend": storage.backend,
                    "bucket": storage.bucket or "",
                    "prefix": storage.prefix,
                    "root": storage.root},
        "pool_config": {"pool_specification": {
            "id": pool.id,
            "substrate": "tpu_vm",
            "vm_configuration": {
                "vm_size": pool.vm_size,
                "vm_count": {"dedicated": pool.vm_count_dedicated,
                             "low_priority": pool.vm_count_low_priority},
            },
            "task_slots_per_node": pool.task_slots_per_node,
            # Agents poll the queue fan-out; the shard count MUST
            # match what producers read from the stored pool spec or
            # messages on shards > 0 are never consumed.
            "task_queue_shards": pool.task_queue_shards,
            "inter_node_communication_enabled":
                pool.inter_node_communication_enabled,
            "container_runtimes": list(pool.container_runtimes),
            "container_runtime_default": pool.container_runtime_default,
            "environment_variables": dict(pool.environment_variables),
            "node_prep": {"additional_commands":
                          list(pool.additional_node_prep_commands)},
        }},
        "identity": {
            "pool_id": pool.id,
            "node_id": node_id(pool.id, node_index),
            "node_index": node_index,
            "hostname": "", "internal_ip": "",
            "slice_index": node_index, "worker_index": 0,
        },
        "work_dir": NODE_WORK_DIR,
        "run_nodeprep": True,
        "output_upload_cap_bytes": (
            pool.output_upload_cap_mb * 1024 * 1024
            if pool.output_upload_cap_mb else None),
    }
    b64 = base64.b64encode(json.dumps(template).encode()).decode()
    fill_py = (
        'import json,socket,urllib.request as u\n'
        f't=json.load(open("{NODE_WORK_DIR}/boot_t.json"))\n'
        'i=t["identity"]\n'
        'i["hostname"]=socket.gethostname()\n'
        'try:\n'
        ' r=u.Request("http://metadata.google.internal/computeMetadata/'
        'v1/instance/network-interfaces/0/ip",'
        'headers={"Metadata-Flavor":"Google"})\n'
        ' i["internal_ip"]=u.urlopen(r,timeout=10).read().decode()\n'
        'except OSError:\n'
        ' i["internal_ip"]=socket.gethostbyname(socket.gethostname())\n'
        f'json.dump(t,open("{NODE_WORK_DIR}/boot.json","w"))\n')
    lines = [
        "#!/bin/bash",
        "# Start the batch_shipyard_tpu_torch node agent (every boot).",
        "set -e",
        f"mkdir -p {NODE_WORK_DIR}",
        f"chmod 777 {NODE_WORK_DIR}",
        f"echo {b64} | base64 -d > {NODE_WORK_DIR}/boot_t.json",
        f"python3 - <<'SHIPYARD_FILL'\n{fill_py}SHIPYARD_FILL",
    ]
    pythonpath = ""
    if bundle_key:
        # The package bundle from the state bucket.
        if not storage.bucket:
            raise ValueError(
                "a bootstrap bundle is fetched from the state bucket: "
                "credentials storage.bucket is required")
        lines += [
            f"gcloud storage cp gs://{storage.bucket}/{bundle_key} "
            f"{NODE_WORK_DIR}/bundle.tar.gz",
            f"mkdir -p {NODE_WORK_DIR}/bundle",
            f"tar xzf {NODE_WORK_DIR}/bundle.tar.gz -C "
            f"{NODE_WORK_DIR}/bundle"]
        pythonpath = f"PYTHONPATH={NODE_WORK_DIR}/bundle "
    lines += [
        f"cd {NODE_WORK_DIR}",
        f"{pythonpath}nohup python3 -m batch_shipyard_tpu_torch.agent "
        f"{NODE_WORK_DIR}/boot.json >>{NODE_WORK_DIR}/agent.log 2>&1 &",
    ]
    return "\n".join(lines) + "\n"
