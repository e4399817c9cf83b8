"""The node operator verbs through both packages' CLIs
(tests/test_cli_fleet.py::test_cli_pool_nodes_operator_verbs): on a fake
pool of two GPU nodes, count / grls / ps answer and reboot / del act on
the pool's one slice, with the same --raw outputs apart from times and
addresses. The verbs wait on the revived agents' replies, so the two
packages run side by side, each in a process of its own."""

import json
import os
import pathlib
import subprocess
import sys

import yaml

REPO = pathlib.Path(__file__).resolve().parent.parent

# One package's run of the scenario (argv: package, configdir), printing
# what the comparison reads as one JSON line.
_SCENARIO = r"""
import importlib, json, sys, time
from click.testing import CliRunner
pkg, configdir = sys.argv[1:]
cli = importlib.import_module(pkg + ".cli.main").cli
runner = CliRunner()


def run(*argv):
    result = runner.invoke(cli, ["--configdir", configdir, *argv],
                           catch_exceptions=False)
    assert result.exit_code == 0, (argv, result.output)
    return result.output


seen = {}
run("pool", "add")
seen["count"] = json.loads(run("--raw", "pool", "nodes", "count"))
grls = json.loads(run("--raw", "pool", "nodes", "grls"))["remote_login"]
seen["grls"] = sorted((g["node_id"], sorted(g)) for g in grls)
deadline = time.monotonic() + 70
while True:
    ps = json.loads(run("--raw", "pool", "nodes", "ps"))["nodes"]
    if all("running_tasks" in n for n in ps) or \
            time.monotonic() > deadline:
        break
    time.sleep(0.2)
seen["ps"] = sorted((n.get("node_id"), n.get("running_tasks"))
                    for n in ps)
node_id = grls[0]["node_id"]
seen["reboot"] = run("pool", "nodes", "reboot", node_id, "-y")
deadline = time.monotonic() + 30
while True:
    by_state = json.loads(run("--raw", "pool", "nodes", "count"))[
        "by_state"]
    if by_state.get("idle", 0) + by_state.get("running", 0) == 2 or \
            time.monotonic() > deadline:
        break
    time.sleep(0.2)
seen["rebooted_ready"] = by_state.get("idle", 0) + by_state.get(
    "running", 0)
seen["del"] = run("pool", "nodes", "del", node_id, "-y")
seen["after_del"] = json.loads(run("--raw", "pool", "nodes", "count"))
print(json.dumps(seen))
"""


def _configdir(base: pathlib.Path) -> str:
    base.mkdir()
    confs = {
        "credentials": {"credentials": {"storage": {
            "backend": "localfs", "root": str(base / "store")}}},
        "config": {"global_resources": {"docker_images": []}},
        "pool": {"pool_specification": {
            "id": "clipool", "substrate": "fake",
            "vm_configuration": {"vm_size": "a3-highgpu-1g",
                                 "vm_count": {"dedicated": 2}},
            "max_wait_time_seconds": 30}}}
    for name, data in confs.items():
        with open(base / f"{name}.yaml", "w") as fh:
            yaml.safe_dump(data, fh)
    return str(base)


def test_pool_nodes_operator_verbs_match_the_reference(tmp_path):
    procs = {
        pkg: subprocess.Popen(
            [sys.executable, "-c", _SCENARIO, pkg,
             _configdir(tmp_path / pkg)],
            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=dict(os.environ, PYTHONPATH=str(REPO)))
        for pkg in ("batch_shipyard_tpu", "batch_shipyard_tpu_torch")}
    seen = {}
    for pkg, proc in procs.items():
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, (pkg, err[-3000:])
        seen[pkg] = json.loads(out.strip().splitlines()[-1])
    port, ref = seen["batch_shipyard_tpu_torch"], seen["batch_shipyard_tpu"]
    assert port == ref
    assert port["count"]["total"] == 2
    assert [node for node, _keys in port["grls"]] == [
        "clipool-s0-w0", "clipool-s0-w1"]
    assert port["ps"] == [["clipool-s0-w0", []], ["clipool-s0-w1", []]]
    assert "recreated_slice" in port["reboot"]
    assert port["rebooted_ready"] == 2
    assert "deallocated_slice" in port["del"]
    # The pool's one slice is gone with the node.
    assert port["after_del"]["total"] == 0
