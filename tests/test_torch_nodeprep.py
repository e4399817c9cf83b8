"""The port's node prep (agent/nodeprep.py): GPU counting over a device
root, the reference's event sequence with ``gpus:<n>`` and
``torch_cuda_ready:<bool>`` in place of ``tpu_chips:`` and
``jax_ready:``, no pip ever, and on this CPU-only torch a node that
reports ``torch_cuda_ready:False`` and still completes its prep."""

import subprocess
import types

import pytest

from batch_shipyard_tpu.agent import nodeprep as ref_nodeprep
from batch_shipyard_tpu.agent import perf as ref_perf
from batch_shipyard_tpu.config import settings as ref_settings
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu_torch.agent import nodeprep, perf
from batch_shipyard_tpu_torch.config import settings
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
from batch_shipyard_tpu_torch.utils import util


def _agent(store, pool, node_id="n0"):
    return types.SimpleNamespace(
        store=store, pool=pool, _image_provisioner=None,
        identity=types.SimpleNamespace(pool_id="p", node_id=node_id))


@pytest.mark.parametrize("names,want", [
    (("nvidia0", "nvidia1", "nvidia2", "nvidia3", "nvidiactl",
      "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset"), 4),
    (("nvidiactl", "nvidia-uvm"), 0),
    (("nvidia7", "nvidia10", "accel0", "nvidia-caps"), 2)])
def test_detect_gpus_counts_device_nodes(tmp_path, names, want):
    for name in names:
        (tmp_path / name).touch()
    assert nodeprep.detect_gpus(str(tmp_path)) == want
    assert nodeprep.detect_gpus(str(tmp_path / "missing")) == 0


def test_events_match_the_reference_with_the_two_renamed(monkeypatch):
    """The same pool YAML through both packages' node prep (the reference
    on a TPU slice, the port on an A3 node), with pip and every other
    subprocess refused: the event sequences are equal once the two
    accelerator events are mapped across."""
    calls = []

    def refuse(*args, **kwargs):
        calls.append(args)
        raise AssertionError(f"node prep ran a subprocess: {args}")

    for name in ("call", "run", "Popen", "check_call", "check_output"):
        monkeypatch.setattr(subprocess, name, refuse)
    monkeypatch.setattr(util, "probe_cuda", lambda timeout=75.0: (
        {"count": 2, "cuda": "12.4", "torch": "2.6"}, None))
    monkeypatch.setattr(nodeprep, "detect_gpus", lambda dev_root="/dev": 2)
    monkeypatch.setattr(ref_nodeprep, "detect_tpu_chips", lambda: 4)
    monkeypatch.setattr(ref_nodeprep, "ensure_jax",
                        lambda *a, **k: True)
    spec = {"id": "p", "substrate": "fake",
            "container_runtimes": ["docker", "kata_containers"]}
    ref_pool = ref_settings.pool_settings({"pool_specification": dict(
        spec, tpu={"accelerator_type": "v5litepod-8"})})
    pool = settings.pool_settings({"pool_specification": dict(
        spec, vm_configuration={"vm_size": "a3-highgpu-2g"})})
    ref_store, store = RefStore(), MemoryStateStore()
    ref_nodeprep.run_node_prep(_agent(ref_store, ref_pool))
    nodeprep.run_node_prep(_agent(store, pool))
    rename = {"tpu_chips:4": "gpus:2", "jax_ready:True":
              "torch_cuda_ready:True"}
    ref_events = [rename.get(e["event"], e["event"])
                  for e in ref_perf.query(ref_store, "p")]
    events = [e["event"] for e in perf.query(store, "p")]
    assert events == ref_events
    assert events[0] == "start" and events[-1] == "end"
    assert not calls


def test_cpu_torch_reports_not_ready_and_completes(monkeypatch):
    """The real probe (a subprocess importing torch) on this CPU-only
    torch: the node reports torch_cuda_ready:False, with the reason, and
    its prep still ends. pip is never invoked."""
    real_run = subprocess.run

    def no_pip(argv, *args, **kwargs):
        assert "pip" not in " ".join(map(str, argv)), argv
        return real_run(argv, *args, **kwargs)

    monkeypatch.setattr(subprocess, "run", no_pip)
    monkeypatch.setattr(subprocess, "call", no_pip)
    monkeypatch.setattr(nodeprep, "detect_gpus", lambda dev_root="/dev": 1)
    pool = settings.pool_settings({"pool_specification": {
        "id": "p", "substrate": "fake", "container_runtimes": [],
        "vm_configuration": {"vm_size": "a3-highgpu-1g"}}})
    store = MemoryStateStore()
    nodeprep.run_node_prep(_agent(store, pool))
    rows = perf.query(store, "p")
    assert [r["event"] for r in rows] == [
        "start", "gpus:1", "torch_cuda_ready:False",
        "global_resources_loaded", "end"]
    assert rows[2]["message"]
    ok, reason = nodeprep.ensure_torch_cuda(1)
    assert not ok and reason


@pytest.mark.parametrize("count,expected,ready", [
    (1, 1, True), (1, 2, True), (8, 8, True), (0, 1, False),
    (2, 1, False)])
def test_ready_takes_one_to_all_of_the_device_nodes(monkeypatch, count,
                                                   expected, ready):
    """A container may show more /dev/nvidia<N> than torch gets: ready
    with at least one and at most as many; not with none or more."""
    monkeypatch.setattr(util, "probe_cuda", lambda timeout=75.0: (
        {"count": count, "cuda": "12.4", "torch": "2.6"}, None))
    ok, seen = nodeprep.ensure_torch_cuda(expected)
    assert ok is ready and f"{count} of {expected}" in seen
    monkeypatch.setattr(util, "probe_cuda", lambda timeout=75.0: (
        {"count": count, "cuda": None, "torch": "2.6"}, None))
    assert nodeprep.ensure_torch_cuda(expected)[0] is False


def test_pool_settings_refuse_a_tpu_block():
    with pytest.raises(ValueError, match="pool_specification.tpu"):
        settings.pool_settings({"pool_specification": {
            "id": "p", "tpu": {"accelerator_type": "v5litepod-8"}}})
    pool = settings.pool_settings({"pool_specification": {
        "id": "p", "vm_configuration": {"vm_size": "a3-megagpu-8g",
                                        "vm_count": {"dedicated": 3}}}})
    assert pool.is_gpu_pool and pool.gpus_per_node == 8
    assert pool.current_node_count == 3
    plain = settings.pool_settings({"pool_specification": {"id": "p"}})
    assert not plain.is_gpu_pool and plain.gpus_per_node == 0
