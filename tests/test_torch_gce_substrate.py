"""The port's cloud H100 pool on the CPU, against a stand-in gcloud: the
error taxonomy (every reference payload classified as the reference's
classifier does, and Compute Engine's A3 payloads as the port needs),
the VM layer (both packages' GceVmManagers give the same argv), the GPU
quota client and preflight (the scenarios of tests/test_quota_preflight.py
on GCE's region quotas), and the A3 VM substrate (the scenarios of
tests/test_gcp_substrate.py on VMs: allocation, the create argv,
registration, classified failures, resize in nodes, suspend/start, a
suspended pool not marked preempted, remote login, the bootstrap that
boots the port's agent as a GPU pool, and a pool through the CLI's
processes whose gcloud is chip_smoke's stand-in)."""

import base64
import json
import os
import re
import subprocess
import sys

import pytest
import yaml
from click.testing import CliRunner

from batch_shipyard_tpu.cli.main import cli as ref_cli
from batch_shipyard_tpu.substrate import gce_vm as ref_gce_vm
from batch_shipyard_tpu.substrate import gcloud_errors as ref_ge
from batch_shipyard_tpu.substrate import quota as ref_quota
from batch_shipyard_tpu_torch import fleet
from batch_shipyard_tpu_torch.cli.main import cli as port_cli
from batch_shipyard_tpu_torch.config import settings
from batch_shipyard_tpu_torch.pool import manager as pool_mgr
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
from batch_shipyard_tpu_torch.substrate import base
from batch_shipyard_tpu_torch.substrate import gce_vm
from batch_shipyard_tpu_torch.substrate import gcloud_errors as ge
from batch_shipyard_tpu_torch.substrate import gcp_gpu
from batch_shipyard_tpu_torch.substrate import quota as quota_mod
from tests.test_gcloud_errors import CORPUS as TPU_CORPUS
from tests.test_quota_preflight import (
    ACCEL_TYPES as TPU_ACCEL_TYPES, FakeGcloudRunner as TpuRunner)

CREDS = settings.credentials_settings({"credentials": {
    "gcp": {"project": "proj", "zone": "us-central1-a"},
    "storage": {"backend": "localfs", "root": "/srv/store",
                "prefix": "shipyardtpu"}}})

# --------------------------- the error taxonomy ---------------------------

# Compute Engine's A3 create failures (its public documentation's
# wording): (payload, kind, fatal, retry, the reference's kind).
GCE_CORPUS = [
    ("ERROR: (gcloud.compute.instances.create) Could not fetch resource:\n"
     " - Quota 'NVIDIA_H100_GPUS' exceeded.  Limit: 0.0 in region "
     "us-central1.", "quota", True, "none", "unknown"),
    ('{"error": {"code": 403, "message": "Quota '
     "'PREEMPTIBLE_NVIDIA_H100_GPUS' exceeded.  Limit: 8.0 in region "
     'us-central1.", "errors": [{"domain": "usageLimits", "reason": '
     '"quotaExceeded"}]}}', "quota", True, "none", "unknown"),
    ('{"code": "ZONE_RESOURCE_POOL_EXHAUSTED", "message": "The zone '
     "'projects/p/zones/us-central1-a' does not have enough resources "
     'available to fulfill the request.  Try a different zone, or try '
     'again later."}', "stockout", False, "other_zone", "stockout"),
    ("ERROR: (gcloud.compute.instances.create) Could not fetch resource:\n"
     " - ZONE_RESOURCE_POOL_EXHAUSTED_WITH_DETAILS: A a3-highgpu-8g VM is "
     "currently unavailable in the us-central1-a zone. Alternatively, you "
     "can try your request again with a different VM hardware "
     "configuration or at a later time.", "stockout", False, "other_zone",
     "unavailable"),
    ('{"errors": [{"code": "ZONE_RESOURCE_POOL_EXHAUSTED", "message": '
     '"Zone us-central1-a has no resources for this machine type."}]}',
     "stockout", False, "other_zone", "unknown"),
    ("ERROR: (gcloud.compute.instances.create) Could not fetch resource:\n"
     " - The resource 'projects/p/zones/us-east1-b/machineTypes/"
     "a3-highgpu-8g' was not found", "invalid_argument", True, "none",
     "not_found"),
    ("ERROR: (gcloud.compute.instances.create) Could not fetch resource:\n"
     " - Invalid value for field 'resource.machineType': "
     "'zones/us-east1-b/machineTypes/a3-megagpu-8g'. Machine type with "
     "name 'a3-megagpu-8g' does not exist in zone 'us-east1-b'.",
     "invalid_argument", True, "none", "invalid_argument"),
    ("ERROR: (gcloud.compute.instances.create) Could not fetch resource:\n"
     " - The resource 'projects/my-images/global/images/family/"
     "no-such-family' was not found", "invalid_argument", True, "none",
     "not_found"),
    # Deleting a VM that is already gone stays a non-fatal not_found.
    ("ERROR: (gcloud.compute.instances.delete) Could not fetch resource:\n"
     " - The resource 'projects/p/zones/us-central1-a/instances/"
     "shipyard-pool-n0' was not found", "not_found", False, "none",
     "not_found"),
]


@pytest.mark.parametrize("payload,kind,fatal,retry", TPU_CORPUS,
                         ids=[f"{r[1]}-{i}" for i, r in
                              enumerate(TPU_CORPUS)])
def test_tpu_corpus_classified_as_the_reference(payload, kind, fatal,
                                                retry):
    got, want = ge.classify(payload), ref_ge.classify(payload)
    assert (got.kind, got.fatal, got.retry, got.rule) == (
        want.kind, want.fatal, want.retry, want.rule)
    assert (got.kind, got.fatal, got.retry) == (kind, fatal, retry)


@pytest.mark.parametrize("payload,kind,fatal,retry,ref_kind", GCE_CORPUS,
                         ids=[f"{r[1]}-{i}" for i, r in
                              enumerate(GCE_CORPUS)])
def test_gce_corpus_classification(payload, kind, fatal, retry, ref_kind):
    got = ge.classify(payload)
    assert (got.kind, got.fatal, got.retry) == (kind, fatal, retry), got
    # The reference's TPU table files the A3 wording elsewhere.
    assert ref_ge.classify(payload).kind == ref_kind


@pytest.mark.parametrize("module", [ref_ge, ge], ids=["reference", "port"])
def test_generic_rules_hold_in_both(module):
    unknown = module.classify("ERROR: something nobody has seen before")
    assert (unknown.kind, unknown.fatal, unknown.retry) == (
        "unknown", False, "backoff")
    quota = module.classify('{"status": "RESOURCE_EXHAUSTED", "message": '
                            "\"Quota exceeded for quota metric 'TPU v5 "
                            "cores'\"}")
    assert quota.kind == "quota" and quota.fatal
    rate = module.classify('{"error": {"code": 429, "status": '
                           '"RESOURCE_EXHAUSTED", "message": "Too many '
                           'requests; try again later."}}')
    assert (rate.kind, rate.retry) == ("unavailable", "backoff")
    dry = module.classify('{"status": "RESOURCE_EXHAUSTED", "message": '
                          '"There is no more capacity in the zone '
                          '\\"us-central2-b\\"."}')
    assert (dry.kind, dry.retry) == ("stockout", "other_zone")
    accel = module.classify("ERROR: Accelerator type v5litepod-4 was not "
                            "found in zone us-east1-d")
    assert (accel.kind, accel.fatal) == ("invalid_argument", True)


def test_preemption_states():
    for state in ("PREEMPTED", "terminated", "SUSPENDED", "READY",
                  "RUNNING", None):
        assert ge.is_preemption_state(state) == \
            ref_ge.is_preemption_state(state)
    # A VM the pool stopped shows TERMINATED too: never a preemption.
    for state in ("TERMINATED", "PREEMPTED", "RUNNING"):
        assert not ge.is_preemption_state(state, stopped_by_pool=True)


# ------------------------------ the VM layer ------------------------------

class Recorder:
    """A runner that records argv (the startup script's temp path
    replaced by its text) and answers from ``answers`` by verb."""

    def __init__(self, fail=None):
        self.calls = []
        self.fail = fail

    def __call__(self, argv, **_kw):
        argv = list(argv)
        for i, arg in enumerate(argv):
            if arg.startswith("--metadata-from-file=startup-script="):
                path = arg.split("=", 2)[2]
                with open(path) as fh:
                    argv[i] = "--startup-script:" + fh.read()
        self.calls.append(argv)
        if self.fail and argv[2:4] == ["instances", "create"]:
            return 1, "", self.fail
        if "--format=value(networkInterfaces[0].networkIP)" in argv:
            return 0, "10.0.0.7\n", ""
        if "--format=value(status)" in argv:
            return 0, "RUNNING\n", ""
        return 0, "", ""


def _exercise(manager):
    manager.create_disk("d", 100)
    manager.delete_disk("d")
    manager.attach_disk("vm", "d", "data")
    ip = manager.create_vm("vm", "n2-standard-8", startup_script="#!/bin/sh",
                           disks=[("d", "data")], tags=["a", "b"],
                           boot_disk_size_gb=32, public_ip=False)
    manager.create_vm("vm2", "e2-small")
    status = manager.vm_status("vm")
    manager.stop_vm("vm")
    manager.start_vm("vm")
    manager.set_machine_type("vm", "n2-standard-16")
    manager.delete_vm("vm")
    return ip, status


def test_both_vm_managers_give_the_same_argv(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    got, want = Recorder(), Recorder()
    out = _exercise(gce_vm.GceVmManager("p", zone="z", network="net",
                                        runner=got))
    ref_out = _exercise(ref_gce_vm.GceVmManager("p", zone="z",
                                                network="net", runner=want))
    assert got.calls == want.calls and out == ref_out == ("10.0.0.7",
                                                          "RUNNING")
    # The startup script never stays on disk.
    assert os.listdir(tmp_path) == []


def test_vm_create_failure_unlinks_the_script_and_raises(tmp_path,
                                                         monkeypatch):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    runner = Recorder(fail="Quota 'NVIDIA_H100_GPUS' exceeded.")
    manager = gce_vm.GceVmManager("p", zone="z", runner=runner)
    with pytest.raises(gce_vm.GceVmError, match="NVIDIA_H100_GPUS"):
        manager.create_vm("vm", "a3-highgpu-8g", startup_script="secret",
                          extra_args=["--maintenance-policy=TERMINATE"])
    assert os.listdir(tmp_path) == []
    assert runner.calls[0][-3:] == ["--startup-script:secret",
                                    "--project=p", "--zone=z"]
    assert "--maintenance-policy=TERMINATE" in runner.calls[0]


def test_vm_manager_needs_gcloud_or_a_runner(monkeypatch):
    monkeypatch.setattr(gce_vm.shutil, "which", lambda _name: None)
    with pytest.raises(gce_vm.GceVmError, match="gcloud CLI"):
        gce_vm.GceVmManager("p")


# ------------------------------ quota client ------------------------------

ZONE = "us-central1-a"
def gpu_types(zone):
    """``accelerator-types list --filter=zone:ZONE --format=json``."""
    return json.dumps([
        {"name": "nvidia-h100-80gb", "zone": f"https://www.googleapis.com/"
         f"compute/v1/projects/p/zones/{zone}",
         "maximumCardsPerInstance": 8},
        {"name": "nvidia-h100-mega-80gb", "zone": f"projects/p/zones/{zone}"},
        {"name": "nvidia-l4", "zone": f"projects/p/zones/{zone}"},
        # A row of another zone the filter let through.
        {"name": "nvidia-a100-80gb", "zone": f"projects/p/zones/{zone}b"},
    ])


GPU_TYPES = gpu_types(ZONE)
REGION = json.dumps({"name": "us-central1", "quotas": [
    {"metric": "CPUS", "limit": 2400.0, "usage": 96.0},
    {"metric": "NVIDIA_H100_GPUS", "limit": 16.0, "usage": 0.0},
    {"metric": "PREEMPTIBLE_NVIDIA_H100_GPUS", "limit": 8.0, "usage": 0.0},
    {"metric": "NVIDIA_H100_MEGA_GPUS", "limit": 0.0, "usage": 0.0},
    {"metric": "NVIDIA_L4_GPUS", "limit": 4.0, "usage": 1.0},
]})


class GpuRunner:
    def __init__(self, types_by_zone=None, region=REGION):
        self.types_by_zone = types_by_zone or {ZONE: GPU_TYPES}
        self.region = region
        self.calls = []

    def __call__(self, argv, **_kw):
        self.calls.append(argv)
        if argv[1:3] == ["compute", "accelerator-types"]:
            zone = [a for a in argv if a.startswith("--filter=zone:")][0]
            payload = self.types_by_zone.get(zone.split(":", 1)[1])
            if payload is None:
                return 1, "", "zone not found"
            return 0, payload, ""
        if argv[1:4] == ["compute", "regions", "describe"]:
            return 0, self.region, ""
        return 1, "", f"unexpected argv {argv}"


def client(**kw):
    return quota_mod.GpuQuotaClient("proj", runner=GpuRunner(**kw))


def make_pool(vm_size="a3-highgpu-8g", dedicated=1, low_priority=0,
              zone=ZONE, substrate="tpu_vm", **spec):
    conf = {"id": "qp", "substrate": substrate,
            "vm_configuration": {"vm_size": vm_size, "vm_count": {
                "dedicated": dedicated, "low_priority": low_priority}},
            **spec}
    if zone:
        conf["zone"] = zone
    return settings.pool_settings({"pool_specification": conf})


def test_accelerator_types_keep_the_zones_rows():
    assert client().accelerator_types(ZONE) == [
        "nvidia-h100-80gb", "nvidia-h100-mega-80gb", "nvidia-l4"]
    assert quota_mod.gpu_type("a3-highgpu-8g")[0] == "nvidia-h100-80gb"
    assert quota_mod.gpu_type("a3-megagpu-8g")[1] == "NVIDIA_H100_MEGA_GPUS"
    assert quota_mod.gpu_type("n2-standard-8") is None


def test_quota_limits_are_the_regions_gpu_quotas():
    rows = {r["metric"]: r for r in client().quota_limits("us-central1")}
    assert set(rows) == {"NVIDIA_H100_GPUS", "PREEMPTIBLE_NVIDIA_H100_GPUS",
                         "NVIDIA_H100_MEGA_GPUS", "NVIDIA_L4_GPUS"}
    assert rows["NVIDIA_L4_GPUS"] == {
        "metric": "NVIDIA_L4_GPUS", "unit": "GPUs", "region": "us-central1",
        "limit": 4, "usage": 1}
    assert client().quota_limits(None) == []


def test_quota_report_has_the_references_keys():
    report = quota_mod.quota_report(client(), ZONE)
    ref = ref_quota.quota_report(ref_quota.TpuQuotaClient(
        "proj", runner=TpuRunner()), ZONE)
    assert set(report) == set(ref)
    assert set(report["quota_limits"][0]) >= set(ref["quota_limits"][0])
    assert report["project"] == "proj" and report["zone"] == ZONE
    broken = quota_mod.quota_report(client(), "europe-west4-a")
    assert "accelerator_types_error" in broken


def test_preflight_ok_is_silent():
    assert quota_mod.preflight_pool(make_pool(dedicated=2), client()) == []


def test_preflight_warns_on_an_unoffered_type():
    offered = json.dumps([{"name": "nvidia-l4"}])
    warnings = quota_mod.preflight_pool(
        make_pool(), client(types_by_zone={ZONE: offered}))
    assert len(warnings) == 1
    assert "nvidia-h100-80gb (a3-highgpu-8g) is not offered in zone " \
        f"{ZONE}" in warnings[0]


def test_preflight_warns_when_gpus_times_nodes_exceed_the_quota():
    # 3 x 8 = 24 GPUs > the 16 of NVIDIA_H100_GPUS.
    warnings = quota_mod.preflight_pool(make_pool(dedicated=3), client())
    assert len(warnings) == 1
    assert "needs 24 NVIDIA_H100_GPUS" in warnings[0]
    assert "is 16 (0 in use)" in warnings[0]
    # The Mega metric is 0: one a3-megagpu-8g node cannot be had.
    mega = quota_mod.preflight_pool(make_pool("a3-megagpu-8g"), client())
    assert any("needs 8 NVIDIA_H100_MEGA_GPUS" in w for w in mega)


def test_preflight_counts_spot_nodes_against_the_preemptible_quota():
    # 1 x 8 spot GPUs fit the preemptible 8: silent.
    assert quota_mod.preflight_pool(
        make_pool(dedicated=0, low_priority=1), client()) == []
    # 2 x 8 spot GPUs exceed the preemptible 8 but fit the on-demand 16,
    # which spot VMs fall back to: not proven, silent.
    assert quota_mod.preflight_pool(
        make_pool(dedicated=0, low_priority=2), client()) == []
    # 1 on demand + 2 spot = 24 > 16 and 16 > 8: proven.
    warnings = quota_mod.preflight_pool(
        make_pool(dedicated=1, low_priority=2), client())
    assert len(warnings) == 1
    assert "needs 16 PREEMPTIBLE_NVIDIA_H100_GPUS" in warnings[0]


def test_preflight_degrades_when_gcloud_fails():
    warnings = quota_mod.preflight_pool(make_pool(zone="europe-west4-a"),
                                        client())
    assert len(warnings) == 1 and "preflight unavailable" in warnings[0]


def test_preflight_without_a_zone_or_a_gpu_size():
    assert quota_mod.preflight_pool(make_pool(zone=None), client()) == []
    skipped = quota_mod.preflight_pool(make_pool("n2-standard-8"), client())
    assert len(skipped) == 1 and "skipping quota preflight" in skipped[0]


def test_stockout_advisory_names_sibling_zones():
    c = client(types_by_zone={ZONE: GPU_TYPES,
                              "us-central1-b": gpu_types("us-central1-b"),
                              "us-central1-c": json.dumps([])})
    advisory = quota_mod.stockout_advisory(
        c, "nvidia-h100-80gb", ZONE,
        ["us-central1-b", "us-central1-c", "us-central1-d"])
    assert "us-central1-b" in advisory and "us-central1-c" not in advisory
    assert quota_mod.stockout_advisory(
        c, "nvidia-b200", ZONE, ["us-central1-b"]) is None


def test_pool_add_preflight_via_fleet():
    class Ctx:
        pool = make_pool(dedicated=3)
        credentials = CREDS

    warnings = fleet._quota_preflight(Ctx(), client())
    assert any("needs 24 NVIDIA_H100_GPUS" in w for w in warnings)
    # Only a cloud pool is preflighted.
    Ctx.pool = make_pool(dedicated=3, substrate="fake")
    assert fleet._quota_preflight(Ctx(), client()) == []


def _quota_configdir(tmp_path, name):
    base_dir = tmp_path / name
    base_dir.mkdir()
    (base_dir / "credentials.yaml").write_text(yaml.safe_dump({
        "credentials": {"gcp": {"project": "proj", "zone": ZONE},
                        "storage": {"backend": "localfs",
                                    "root": str(base_dir / "store")}}}))
    return str(base_dir)


def test_account_quota_raw_gives_the_references_keys(tmp_path,
                                                     monkeypatch):
    monkeypatch.setattr(quota_mod.util, "subprocess_capture", GpuRunner())
    port = CliRunner().invoke(port_cli, [
        "--configdir", _quota_configdir(tmp_path, "port"), "--raw",
        "account", "quota"])
    monkeypatch.setattr(ref_quota.util, "subprocess_capture", TpuRunner())
    ref = CliRunner().invoke(ref_cli, [
        "--configdir", _quota_configdir(tmp_path, "ref"), "--raw",
        "account", "quota", "--zone", ZONE])
    assert port.exit_code == ref.exit_code == 0, (port.output, ref.output)
    got, want = json.loads(port.output), json.loads(ref.output)
    assert set(got) == set(want)
    assert got["accelerator_types"] == [
        "nvidia-h100-80gb", "nvidia-h100-mega-80gb", "nvidia-l4"]
    assert [r["limit"] for r in got["quota_limits"]] == [16, 8, 0, 4]


# ------------------------------ the substrate ------------------------------

class FakeCloud:
    """A runner standing in for gcloud over a set of VMs: create records
    the startup script; describe answers each VM's status and addresses;
    stop/start/delete change it. ``fail_create`` fails the next create
    with that stderr; ``describe_error`` fails describes."""

    def __init__(self):
        self.calls = []
        self.vms = {}
        self.scripts = {}
        self.fail_create = None
        self.describe_error = None

    def __call__(self, argv, **_kw):
        argv = list(argv)
        self.calls.append(argv)
        if argv[1] != "compute":
            return 1, "", f"unexpected {argv}"
        if argv[2] in ("accelerator-types", "regions"):
            return GpuRunner()(argv)
        verb, name = argv[3], argv[4]
        if verb == "create":
            if self.fail_create:
                err, self.fail_create = self.fail_create, None
                return 1, "", err
            path = [a for a in argv if a.startswith(
                "--metadata-from-file=startup-script=")][0].split("=", 2)[2]
            with open(path) as fh:
                self.scripts[name] = fh.read()
            n = len(self.vms) + 1
            self.vms[name] = {"status": "RUNNING", "ip": f"10.1.0.{n}",
                              "nat": f"34.0.0.{n}"}
            return 0, "", ""
        vm = self.vms.get(name)
        if vm is None:
            return 1, "", (f"ERROR: (gcloud.compute.instances.{verb}) "
                           f"The resource 'projects/proj/zones/z/instances/"
                           f"{name}' was not found")
        if verb == "describe":
            if self.describe_error:
                return 1, "", self.describe_error
            fmt = [a for a in argv if a.startswith("--format=")][0]
            if fmt == "--format=json":
                return 0, json.dumps({"name": name, "status": vm["status"],
                                      "networkInterfaces": [{
                                          "networkIP": vm["ip"],
                                          "accessConfigs": [{
                                              "natIP": vm["nat"]}]}]}), ""
            if fmt == "--format=value(status)":
                return 0, vm["status"] + "\n", ""
            return 0, vm["ip"] + "\n", ""
        if verb == "stop":
            vm["status"] = "TERMINATED"
        elif verb == "start":
            vm["status"] = "RUNNING"
        elif verb == "delete":
            del self.vms[name]
        return 0, "", ""

    def verbs(self, verb):
        return [c for c in self.calls
                if c[2] == "instances" and c[3] == verb]


@pytest.fixture()
def cloud():
    store = MemoryStateStore()
    fake = FakeCloud()
    sub = gcp_gpu.GcpGpuSubstrate(store, CREDS, runner=fake)
    return store, sub, fake


def _pool_entity(store, pool, conf=None):
    store.insert_entity(names.TABLE_POOLS, "pools", pool.id,
                        {"state": "creating", "spec": conf or {}})


def test_create_substrate_builds_the_a3_substrate(monkeypatch):
    monkeypatch.setattr(gcp_gpu.shutil, "which", lambda _: "/usr/bin/gcloud")
    sub = base.create_substrate("tpu_vm", MemoryStateStore(), CREDS)
    assert isinstance(sub, gcp_gpu.GcpGpuSubstrate)
    no_gcp = settings.credentials_settings({"credentials": {
        "storage": {"backend": "memory"}}})
    with pytest.raises(ValueError, match="credentials.gcp"):
        base.create_substrate("tpu_vm", MemoryStateStore(), no_gcp)
    monkeypatch.setattr(gcp_gpu.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="gcloud CLI"):
        base.create_substrate("tpu_vm", MemoryStateStore(), CREDS)


def test_allocate_registers_nodes_and_boots_agents(cloud):
    store, sub, fake = cloud
    pool = make_pool(dedicated=2)
    _pool_entity(store, pool)
    sub.allocate_pool(pool)
    nodes = sorted(pool_mgr.list_nodes(store, "qp"),
                   key=lambda n: n.node_index)
    assert [n.node_id for n in nodes] == ["qp-n0", "qp-n1"]
    assert [(n.slice_index, n.worker_index) for n in nodes] == [(0, 0),
                                                                (1, 0)]
    assert {n.internal_ip for n in nodes} == {"10.1.0.1", "10.1.0.2"}
    rows = {r["_rk"]: r for r in store.query_entities(names.TABLE_NODES,
                                                      "qp")}
    assert {r["external_ip"] for r in rows.values()} == {"34.0.0.1",
                                                         "34.0.0.2"}
    assert rows["qp-n0"]["vm_name"] == "shipyard-qp-n0"
    assert rows["qp-n0"]["hostname"] == "shipyard-qp-n0"
    assert len(fake.verbs("create")) == 2
    for script in fake.scripts.values():
        assert "python3 -m batch_shipyard_tpu_torch.agent" in script
        assert "TPU_WORKER_ID" not in script
    # No per-worker ssh bootstrap: the startup script is the boot.
    assert not [c for c in fake.calls if "ssh" in c]


def test_the_create_argv(cloud):
    store, sub, fake = cloud
    pool = make_pool(dedicated=1, low_priority=1, vm_configuration={
        "vm_size": "a3-highgpu-8g", "image":
        "projects/deeplearning-platform-release/global/images/family/"
        "common-cu128-ubuntu-2204-nvidia-570",
        "vm_count": {"dedicated": 1, "low_priority": 1}},
        virtual_network={"name": "gpu-net", "subnet_name": "gpu-subnet"})
    _pool_entity(store, pool)
    sub.allocate_pool(pool)
    creates = {c[4]: c for c in fake.verbs("create")}
    on_demand, spot = creates["shipyard-qp-n0"], creates["shipyard-qp-n1"]
    for argv in (on_demand, spot):
        assert "--machine-type=a3-highgpu-8g" in argv
        assert "--maintenance-policy=TERMINATE" in argv
        assert "--image-family=common-cu128-ubuntu-2204-nvidia-570" in argv
        assert "--image-project=deeplearning-platform-release" in argv
        assert "--network=gpu-net" in argv and "--subnet=gpu-subnet" in argv
        assert "--zone=us-central1-a" in argv and "--project=proj" in argv
        assert not any(a.startswith("--accelerator") for a in argv)
    assert "--provisioning-model=SPOT" in spot
    assert "--instance-termination-action=DELETE" in spot
    assert not any("SPOT" in a or "termination" in a for a in on_demand)
    assert gcp_gpu._image_args("my-image") == ["--image=my-image"]
    assert gcp_gpu._image_args("projects/p/global/images/img-1") == [
        "--image=img-1", "--image-project=p"]
    rows = {r["_rk"]: r for r in store.query_entities(names.TABLE_NODES,
                                                      "qp")}
    assert (rows["qp-n0"]["low_priority"], rows["qp-n1"]["low_priority"]) \
        == (False, True)


def test_a_pool_without_gpus_is_refused(cloud):
    store, sub, fake = cloud
    with pytest.raises(ValueError, match="has no GPUs"):
        sub.allocate_pool(make_pool("n2-standard-8"))
    assert fake.calls == []


def test_fatal_allocation_error_classified(cloud):
    store, sub, fake = cloud
    pool = make_pool()
    _pool_entity(store, pool)
    fake.fail_create = ("ERROR: (gcloud.compute.instances.create) Could not "
                        "fetch resource:\n - Quota 'NVIDIA_H100_GPUS' "
                        "exceeded.  Limit: 0.0 in region us-central1.")
    with pytest.raises(RuntimeError):
        sub.allocate_pool(pool)
    entity = store.get_entity(names.TABLE_POOLS, "pools", "qp")
    assert entity["allocation_error_kind"] == "quota"
    assert entity["allocation_error_fatal"] is True
    assert entity["allocation_error_retry"] == "none"
    assert pool_mgr.list_nodes(store, "qp") == []


def test_transient_allocation_error_not_fatal(cloud):
    store, sub, fake = cloud
    pool = make_pool()
    _pool_entity(store, pool)
    fake.fail_create = "gcloud failed (1): deadline exceeded"
    with pytest.raises(RuntimeError):
        sub.allocate_pool(pool)
    entity = store.get_entity(names.TABLE_POOLS, "pools", "qp")
    assert entity["allocation_error_fatal"] is False
    assert entity["allocation_error_retry"] == "backoff"


def test_stockout_folds_the_advisory_and_fails_the_wait_fast(cloud):
    store, sub, fake = cloud
    sub.quota_client = client(types_by_zone={
        "us-central1-b": gpu_types("us-central1-b")})
    pool = make_pool(max_wait_time_seconds=300)
    _pool_entity(store, pool)
    fake.fail_create = ("ZONE_RESOURCE_POOL_EXHAUSTED_WITH_DETAILS: A "
                        "a3-highgpu-8g VM is currently unavailable in the "
                        "us-central1-a zone.")
    with pytest.raises(RuntimeError):
        sub.allocate_pool(pool)
    row = store.get_entity(names.TABLE_POOLS, "pools", "qp")
    assert (row["allocation_error_kind"], row["allocation_error_retry"]) \
        == ("stockout", "other_zone")
    assert "us-central1-b" in row["allocation_error_advisory"]
    with pytest.raises(pool_mgr.PoolAllocationError, match="stockout"):
        pool_mgr.wait_for_pool_ready(store, sub, pool, poll_interval=0.01)


def test_resize_counts_nodes_and_pool_del_deletes_by_rows(cloud):
    store, sub, fake = cloud
    pool = make_pool(dedicated=1)
    _pool_entity(store, pool)
    sub.allocate_pool(pool)
    sub.resize_pool(pool, 3)
    assert sorted(n.node_index for n in pool_mgr.list_nodes(store, "qp")) \
        == [0, 1, 2]
    assert sorted(fake.vms) == ["shipyard-qp-n0", "shipyard-qp-n1",
                                "shipyard-qp-n2"]
    sub.resize_pool(pool, 1)
    assert [n.node_id for n in pool_mgr.list_nodes(store, "qp")] == ["qp-n0"]
    assert [c[4] for c in fake.verbs("delete")] == ["shipyard-qp-n1",
                                                    "shipyard-qp-n2"]
    # The agent's first write replaces its row: a fresh process still
    # finds the VM from node_index and the zone from the stored spec.
    store.upsert_entity(names.TABLE_NODES, "qp", "qp-n0", {
        "state": "idle", "hostname": "shipyard-qp-n0", "node_index": 0,
        "slice_index": 0, "worker_index": 0})
    fresh = gcp_gpu.GcpGpuSubstrate(store, CREDS, runner=fake)
    fresh.deallocate_pool("qp")
    assert fake.vms == {} and pool_mgr.list_nodes(store, "qp") == []
    assert fake.verbs("delete")[-1][-1] == "--zone=us-central1-a"


def test_pool_zone_from_the_stored_spec(cloud):
    store, sub, fake = cloud
    conf = {"pool_specification": {"id": "qp", "zone": "europe-west4-b"}}
    pool = make_pool(zone="europe-west4-b")
    _pool_entity(store, pool, conf)
    sub.allocate_pool(pool)
    assert fake.verbs("create")[0][-1] == "--zone=europe-west4-b"
    store.upsert_entity(names.TABLE_NODES, "qp", "qp-n0", {
        "state": "idle", "node_index": 0})
    gcp_gpu.GcpGpuSubstrate(store, CREDS, runner=fake).deallocate_pool("qp")
    assert fake.verbs("delete")[0][-1] == "--zone=europe-west4-b"


def test_recreate_and_deallocate_one_node(cloud):
    store, sub, fake = cloud
    pool = make_pool(dedicated=2)
    _pool_entity(store, pool)
    sub.allocate_pool(pool)
    sub.recreate_slice(pool, 1)
    assert [c[4] for c in fake.verbs("delete")] == ["shipyard-qp-n1"]
    assert [c[4] for c in fake.verbs("create")][2:] == ["shipyard-qp-n1"]
    sub.deallocate_slice(pool, 0)
    assert [n.node_id for n in pool_mgr.list_nodes(store, "qp")] == ["qp-n1"]
    assert sorted(fake.vms) == ["shipyard-qp-n1"]


def test_suspend_and_start(cloud):
    store, sub, fake = cloud
    pool = make_pool(dedicated=2)
    _pool_entity(store, pool)
    sub.allocate_pool(pool)
    sub.suspend_pool(pool)
    assert {n.state for n in pool_mgr.list_nodes(store, "qp")} == {
        "suspended"}
    assert {vm["status"] for vm in fake.vms.values()} == {"TERMINATED"}
    sub.start_pool(pool)
    assert len(fake.verbs("stop")) == len(fake.verbs("start")) == 2
    assert {vm["status"] for vm in fake.vms.values()} == {"RUNNING"}
    # The startup script starts the agent at boot: nothing else runs.
    assert len(fake.verbs("create")) == 2


def test_a_suspended_pool_is_not_marked_preempted(cloud):
    store, sub, fake = cloud
    pool = make_pool(dedicated=2)
    _pool_entity(store, pool)
    sub.allocate_pool(pool)
    sub.refresh_node_states(pool)
    assert {n.state for n in pool_mgr.list_nodes(store, "qp")} == {
        "creating"}
    sub.suspend_pool(pool)
    sub.refresh_node_states(pool)
    assert {n.state for n in pool_mgr.list_nodes(store, "qp")} == {
        "suspended"}


def test_a_reclaimed_vm_is_marked_preempted(cloud):
    store, sub, fake = cloud
    pool = make_pool(dedicated=1, low_priority=2)
    _pool_entity(store, pool)
    sub.allocate_pool(pool)
    for name in ("shipyard-qp-n0", "shipyard-qp-n1", "shipyard-qp-n2"):
        store.merge_entity(names.TABLE_NODES, "qp", name[9:],
                           {"state": "idle"})
    fake.vms["shipyard-qp-n1"]["status"] = "TERMINATED"  # stopped spot
    del fake.vms["shipyard-qp-n2"]  # a spot VM deleted when reclaimed
    sub.refresh_node_states(pool)
    states = {n.node_id: n.state for n in pool_mgr.list_nodes(store, "qp")}
    assert states == {"qp-n0": "idle", "qp-n1": "preempted",
                      "qp-n2": "preempted"}
    # A describe that fails for another reason is no evidence.
    fake.describe_error = "ERROR: (gcloud) deadline exceeded"
    store.merge_entity(names.TABLE_NODES, "qp", "qp-n1", {"state": "idle"})
    sub.refresh_node_states(pool)
    assert pool_mgr.list_nodes(store, "qp")[1].state == "idle"


def test_remote_login(cloud):
    store, sub, fake = cloud
    pool = make_pool()
    _pool_entity(store, pool)
    sub.allocate_pool(pool)
    assert sub.get_remote_login("qp", "qp-n0") == ("34.0.0.1", 22)
    # After the agent's own row write there is no external_ip column:
    # the VM is asked.
    store.upsert_entity(names.TABLE_NODES, "qp", "qp-n0", {
        "state": "idle", "internal_ip": "10.1.0.1", "node_index": 0})
    assert sub.get_remote_login("qp", "qp-n0") == ("34.0.0.1", 22)
    assert sub.get_remote_login("qp", "nope") is None


def _template(script):
    b64 = re.search(r"echo (\S+) \| base64 -d", script).group(1)
    return json.loads(base64.b64decode(b64))


def test_the_bootstrap_boots_the_ports_agent_as_a_gpu_pool(cloud, tmp_path):
    from batch_shipyard_tpu_torch.agent import __main__ as agent_main
    from batch_shipyard_tpu_torch.state import resilient
    store, sub, fake = cloud
    pool = make_pool(dedicated=2, task_slots_per_node=4,
                     task_queue_shards=3,
                     inter_node_communication_enabled=True)
    _pool_entity(store, pool)
    sub.allocate_pool(pool)
    script = fake.scripts["shipyard-qp-n1"]
    boot = _template(script)
    assert boot["storage"] == {"backend": "localfs", "bucket": "",
                               "prefix": "shipyardtpu",
                               "root": "/srv/store"}
    assert boot["identity"] == {
        "pool_id": "qp", "node_id": "qp-n1", "node_index": 1,
        "hostname": "", "internal_ip": "", "slice_index": 1,
        "worker_index": 0}
    assert "resilience" not in boot and boot["run_nodeprep"] is True
    assert script.startswith("#!/bin/bash\n")
    assert "TPU_WORKER_ID" not in script and "gcloud storage" not in script
    assert "nohup python3 -m batch_shipyard_tpu_torch.agent " \
        "/var/shipyard/boot.json" in script
    # The node's agent, as its process builds it from this template.
    boot["work_dir"] = str(tmp_path / "node")
    boot["identity"].update(hostname="h", internal_ip="10.1.0.2")
    agent = agent_main.build_agent(boot, store=MemoryStateStore())
    assert isinstance(agent.store, resilient.ResilientStore)
    assert agent.pool.is_gpu_pool and agent.pool.gpus_per_node == 8
    assert agent.pool.vm_size == "a3-highgpu-8g"
    assert (agent.pool.task_slots_per_node, agent.pool.task_queue_shards,
            agent.pool.inter_node_communication_enabled) == (4, 3, True)


def test_the_bundle_comes_from_the_state_bucket():
    gcs_creds = settings.credentials_settings({"credentials": {
        "gcp": {"project": "proj", "zone": ZONE},
        "storage": {"backend": "gcs", "bucket": "state-bkt"}}})
    script = gcp_gpu._bootstrap_script(make_pool(), gcs_creds.storage, 0,
                                       "bundles/port.tar.gz")
    assert _template(script)["storage"]["bucket"] == "state-bkt"
    assert "gcloud storage cp gs://state-bkt/bundles/port.tar.gz " in script
    assert "PYTHONPATH=/var/shipyard/bundle nohup python3 -m " \
        "batch_shipyard_tpu_torch.agent" in script
    with pytest.raises(ValueError, match="storage.bucket"):
        gcp_gpu._bootstrap_script(make_pool(), CREDS.storage, 0,
                                  "bundles/port.tar.gz")


def test_the_fill_script_takes_the_identity_from_the_vm(tmp_path):
    """The startup script's python, run against a copy of its template:
    hostname and internal IP come from the machine it runs on (here the
    metadata server is out of reach, so the resolver's address)."""
    pool = make_pool()
    script = gcp_gpu._bootstrap_script(pool, CREDS.storage, 0, "")
    fill = script.split("<<'SHIPYARD_FILL'\n", 1)[1].split(
        "SHIPYARD_FILL", 1)[0].replace(gcp_gpu.NODE_WORK_DIR, str(tmp_path))
    fill = fill.replace("http://metadata.google.internal/", "http://[::1]:9/")
    (tmp_path / "boot_t.json").write_text(json.dumps(_template(script)))
    subprocess.run([sys.executable, "-c", fill], check=True, timeout=60)
    boot = json.loads((tmp_path / "boot.json").read_text())
    import socket
    assert boot["identity"]["hostname"] == socket.gethostname()
    assert boot["identity"]["internal_ip"]


def test_a_cloud_pool_through_the_cli_with_a_stand_in_gcloud(tmp_path):
    """The CPU rehearsal of chip_smoke's (n5): the CLI's processes on a
    ``tpu_vm`` pool whose gcloud is chip_smoke's stand-in, which starts
    the port's agent from the VM's startup script (node prep off: no
    card here). account quota, pool add, a task, pool del from a fresh
    process: the VM is deleted and no agent is left."""
    import chip_smoke as cs
    vms = tmp_path / "vms"
    cs.write_gcloud_standin(tmp_path / "bin", vms, run_nodeprep=False)
    configdir = tmp_path / "configdir"
    configdir.mkdir()
    confs = {
        "credentials": {"credentials": {
            "gcp": {"project": cs.CLOUD_PROJECT, "zone": cs.CLOUD_ZONE},
            "storage": {"backend": "localfs",
                        "root": str(tmp_path / "store")}}},
        "pool": {"pool_specification": {
            "id": "cpool", "substrate": "tpu_vm",
            "vm_configuration": {"vm_size": "a3-highgpu-1g",
                                 "vm_count": {"dedicated": 1}},
            "max_wait_time_seconds": 60}},
        "jobs": {"job_specifications": [{"id": "j", "tasks": [{
            "id": "t", "command": "echo from-the-cloud-pool"}]}]}}
    for name, data in confs.items():
        (configdir / f"{name}.yaml").write_text(yaml.safe_dump(data))
    env = dict(os.environ, TMPDIR=str(tmp_path), PATH=os.pathsep.join(
        [str(tmp_path / "bin"), os.environ.get("PATH", "")]))

    def run(*argv):
        proc = subprocess.run(cs.CLI + ["--configdir", str(configdir),
                                        *argv], env=env, cwd=str(
            cs._build.REPO_ROOT), capture_output=True, text=True,
            timeout=120)
        assert proc.returncode == 0, (argv, proc.stdout[-2000:],
                                      proc.stderr[-3000:])
        return proc.stdout

    try:
        quota = json.loads(run("--raw", "account", "quota"))
        assert [r["metric"] for r in quota["quota_limits"]] == [
            q["metric"] for q in cs.CLOUD_REGION["quotas"]
            if "GPU" in q["metric"]]
        run("pool", "add")
        assert "from-the-cloud-pool" in run("jobs", "add", "--tail",
                                            "stdout.txt")
        nodes = json.loads(run("--raw", "pool", "nodes", "list"))["nodes"]
        assert [(n["node_id"], n["internal_ip"], n["hostname"])
                for n in nodes] == [("cpool-n0", "127.0.0.1",
                                     "shipyard-cpool-n0")]
        assert len(cs._agent_pids(vms)) == 1
        run("pool", "del", "--yes")
        left = cs._await_agents_gone(vms, 10.0)
    finally:
        stopped = cs._stop_agents(vms)
    assert left == [] and stopped == 0
    calls = cs.gcloud_calls(vms)
    create, = [c for c in calls if c[:3] == ["compute", "instances",
                                             "create"]]
    assert "--machine-type=a3-highgpu-1g" in create
    assert "--maintenance-policy=TERMINATE" in create
    assert [c[3] for c in calls if c[:3] == [
        "compute", "instances", "delete"]] == ["shipyard-cpool-n0"]
    log = (vms / "shipyard-cpool-n0" / "agent.log").read_text()
    assert "store-outage ride-through on" in log
    assert "journal backlog 0 at exit" in log
