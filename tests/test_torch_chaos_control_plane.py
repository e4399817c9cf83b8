"""The port's control-plane drills at the seeds of
tests/test_control_plane.py:975, :983 and :994, asserting what those
tests assert: the store outage ridden out by the port's resilient store,
the partitioned sweep leader deposed on its lease's clock, the agent
process restarted under a running task. And `chaos drill` through the
port's CLI and fleet layer."""

import json

import pytest
from click.testing import CliRunner

from batch_shipyard_tpu_torch import fleet
from batch_shipyard_tpu_torch.chaos import drill
from batch_shipyard_tpu_torch.cli.main import cli as port_cli


def test_store_outage_drill():
    report = drill.run_store_outage_drill(seed=0)
    assert report["invariants"]["ok"] is True
    assert report["invariants"]["retries"] == 0
    assert report["invariants"]["store_outage_seconds"] > 0


def test_leader_partition_drill():
    report = drill.run_leader_partition_drill(seed=0)
    inv = report["invariants"]
    assert inv["ok"] is True
    assert inv["preempt_notices"] == 1
    assert inv["stamp_epoch"] == inv["epoch_after"]
    assert inv["epoch_after"] > inv["epoch_before"]
    assert len(inv["lease_holders"]) == 1


def test_agent_restart_drill():
    report = drill.run_agent_restart_drill(seed=0)
    inv = report["invariants"]
    assert inv["ok"] is True
    assert inv["task_starts"] == 1
    assert inv["retries"] == 0
    assert inv["adoption_seconds"] > 0


def test_cli_chaos_drill_restart_raw():
    """`shipyard-tpu-torch --raw chaos drill --restart`: the drill's
    report as JSON, exit 0."""
    result = CliRunner().invoke(port_cli, ["--raw", "chaos", "drill",
                                           "--restart", "--seed", "0"])
    assert result.exit_code == 0, result.output
    payload = json.loads(result.output[result.output.index("{"):])
    assert set(payload) == {"seed", "fingerprint", "invariants",
                            "applied", "goodput"}
    assert payload["invariants"]["ok"] is True
    assert payload["invariants"]["task_starts"] == 1


def test_fleet_refuses_two_drill_flags():
    with pytest.raises(ValueError, match="at most one drill flag"):
        fleet.action_chaos_drill(None, 0, outage=True, restart=True)
