"""GCE VM lifecycle helper: the VM layer under the cloud substrate.

The port's copy of batch_shipyard_tpu/substrate/gce_vm.py: a thin
gcloud-driven manager of Compute Engine VMs and disks, giving the
reference's argv for the reference's calls. The A3 VM substrate
(substrate/gcp_gpu.py) creates each pool node through it; a standalone
VM next to a pool (an NFS server, a monitoring or slurm controller VM)
would stand on it too. ``create_vm`` takes the flags a GPU VM needs
beyond the reference's as ``extra_args``, appended after its own.

All gcloud invocations go through an injectable ``runner`` (argv ->
(rc, stdout, stderr)), so every caller is unit-testable without cloud
access.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Callable, Optional, Sequence

from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

Runner = Callable[..., tuple[int, str, str]]


class GceVmError(RuntimeError):
    pass


class GceVmManager:
    """Create/stop/start/resize/delete GCE VMs and disks."""

    def __init__(self, project: str, zone: Optional[str] = None,
                 network: Optional[str] = None,
                 runner: Optional[Runner] = None):
        if runner is None and shutil.which("gcloud") is None:
            raise GceVmError(
                "gcloud CLI is required for GCE VM provisioning")
        self.project = project
        self.zone = zone
        self.network = network
        self._run = runner or util.subprocess_capture

    # ------------------------------ plumbing ---------------------------

    def _scope(self) -> list[str]:
        args = [f"--project={self.project}"]
        if self.zone:
            args.append(f"--zone={self.zone}")
        return args

    def _gcloud(self, *args: str) -> str:
        rc, out, err = self._run(["gcloud", "compute", *args,
                                  *self._scope()])
        if rc != 0:
            raise GceVmError(
                f"gcloud compute {args[0]} {args[1] if len(args) > 1 else ''} "
                f"failed: {err.strip() or out.strip()}")
        return out

    # ------------------------------- disks -----------------------------

    def create_disk(self, name: str, size_gb: int,
                    disk_type: str = "pd-ssd") -> None:
        self._gcloud("disks", "create", name, f"--size={size_gb}GB",
                     f"--type={disk_type}")

    def delete_disk(self, name: str) -> None:
        self._gcloud("disks", "delete", name, "--quiet")

    def attach_disk(self, vm_name: str, disk_name: str,
                    device_name: str) -> None:
        self._gcloud("instances", "attach-disk", vm_name,
                     f"--disk={disk_name}",
                     f"--device-name={device_name}")

    # -------------------------------- vms ------------------------------

    def create_vm(self, name: str, machine_type: str,
                  startup_script: Optional[str] = None,
                  disks: Sequence[tuple[str, str]] = (),
                  tags: Sequence[str] = (),
                  boot_disk_size_gb: int = 64,
                  public_ip: bool = True,
                  extra_args: Sequence[str] = ()) -> str:
        """Create a VM; returns its internal IP.

        disks: (disk_name, device_name) pairs to attach at create.
        public_ip=False creates the VM with no external address
        (private-VPC-only service VMs). extra_args: more ``instances
        create`` flags (a GPU VM's maintenance policy, provisioning
        model, image, subnet), after the ones above.
        """
        args = ["instances", "create", name,
                f"--machine-type={machine_type}",
                f"--boot-disk-size={boot_disk_size_gb}GB"]
        if not public_ip:
            args.append("--no-address")
        if self.network:
            args.append(f"--network={self.network}")
        if tags:
            args.append(f"--tags={','.join(tags)}")
        for disk_name, device in disks:
            args += ["--disk", f"name={disk_name},"
                     f"device-name={device},mode=rw"]
        args += list(extra_args)
        script_path = None
        try:
            if startup_script is not None:
                # Startup scripts can embed secrets (db passwords,
                # bundle payloads) — never leave them in /tmp.
                with tempfile.NamedTemporaryFile(
                        "w", suffix=".sh", delete=False) as fh:
                    fh.write(startup_script)
                    script_path = fh.name
                args.append(
                    f"--metadata-from-file=startup-script="
                    f"{script_path}")
            self._gcloud(*args)
        finally:
            if script_path is not None:
                os.unlink(script_path)
        return self.internal_ip(name)

    def internal_ip(self, name: str) -> str:
        out = self._gcloud(
            "instances", "describe", name,
            "--format=value(networkInterfaces[0].networkIP)")
        return out.strip()

    def describe(self, name: str) -> dict:
        """The instance resource (``instances describe --format=json``):
        its status, ``networkInterfaces`` and scheduling."""
        out = self._gcloud("instances", "describe", name, "--format=json")
        return json.loads(out) if out.strip() else {}

    def vm_status(self, name: str) -> str:
        out = self._gcloud("instances", "describe", name,
                           "--format=value(status)")
        return out.strip()

    def stop_vm(self, name: str) -> None:
        self._gcloud("instances", "stop", name)

    def start_vm(self, name: str) -> None:
        self._gcloud("instances", "start", name)

    def set_machine_type(self, name: str, machine_type: str) -> None:
        """VM must be stopped first (gcloud enforces this)."""
        self._gcloud("instances", "set-machine-type", name,
                     f"--machine-type={machine_type}")

    def delete_vm(self, name: str) -> None:
        self._gcloud("instances", "delete", name, "--quiet")
