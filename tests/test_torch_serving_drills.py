"""The port's serving drills (chaos/serving_drill.py) on the CPU, at the
seed of tests/test_serving_resilience.py:385-405 and asserting what it
asserts: the replica-drain and router-restart drills, and the
replica-kill drill (slow there and here), each with ``device="cpu"``.
The router-restart drill again on the reference's weights (flax's init
at PRNGKey(7), through ``params_from_flax``): every stream the clients
assemble across the router's death equals the reference's clean greedy
decode (its ``_reference_outputs``) token for token, fp32 greedy on the
CPU. Without a card and without ``device="cpu"`` every serving drill
raises before it starts a replica."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from batch_shipyard_tpu.chaos import serving_drill as ref_drill
from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu_torch import fleet
from batch_shipyard_tpu_torch.chaos import serving_drill
from batch_shipyard_tpu_torch.cli.main import cli as port_cli
from batch_shipyard_tpu_torch.models import convert

DRILLS = {"kill": serving_drill.run_replica_kill_drill,
          "drain": serving_drill.run_replica_drain_drill,
          "router": serving_drill.run_router_restart_drill}


@pytest.mark.slow
def test_replica_kill_drill_end_to_end():
    report = serving_drill.run_replica_kill_drill(seed=1, device="cpu")
    assert report["invariants"]["ok"]
    assert report["invariants"]["recoveries"] >= 1
    assert report["device"] == ["cpu"]


def test_replica_drain_drill_end_to_end():
    report = serving_drill.run_replica_drain_drill(seed=1, device="cpu")
    assert report["invariants"]["ok"]
    assert report["invariants"]["recoveries"] >= 1
    assert report["goodput"]["badput_seconds"]["serving_recovery"] > 0
    assert report["device"] == ["cpu"]


def test_router_restart_drill_end_to_end():
    report = serving_drill.run_router_restart_drill(seed=1, device="cpu")
    assert report["invariants"]["ok"]
    assert report["invariants"]["resumed_clients"] >= 1
    assert report["invariants"]["lost_streams"] == 0
    assert report["device"] == ["cpu"]


def test_router_restart_on_the_reference_weights_streams_its_decode(
        monkeypatch):
    cfg = jtfm.TransformerConfig(
        vocab_size=97, d_model=32, n_layers=2, n_heads=2, d_head=16,
        d_ff=64, max_seq_len=64, dtype=jnp.float32,
        param_dtype=jnp.float32)
    flax = jtfm.TransformerLM(cfg).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))["params"]
    state = convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                            flax))
    monkeypatch.setattr(serving_drill, "drill_params",
                        lambda cfg, device: dict(state))
    streams = {}
    check = serving_drill._check_stream

    def capture(client, reference):
        streams[client.spec["request_id"]] = client.tokens()
        check(client, reference)

    monkeypatch.setattr(serving_drill, "_check_stream", capture)
    report = serving_drill.run_router_restart_drill(seed=1, device="cpu")
    assert report["invariants"]["ok"]
    assert report["invariants"]["resumed_clients"] >= 1
    specs = serving_drill._drill_requests(1, 4, 28)
    assert specs == ref_drill._drill_requests(1, 4, 28)
    want = ref_drill._reference_outputs(cfg, flax, specs)
    assert streams == want
    assert all(len(tokens) == 28 for tokens in want.values())


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_serving_drill_needs_a_card_unless_asked(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DRILLS[name](seed=1)


def test_cli_serving_drill_on_the_cpu_when_asked():
    result = CliRunner().invoke(port_cli, [
        "--raw", "chaos", "drill", "--serve-router", "--seed", "1",
        "--device", "cpu"])
    assert result.exit_code == 0, result.output
    payload = json.loads(result.output[result.output.index("{"):])
    assert payload["invariants"]["ok"] is True
    assert payload["device"] == ["cpu"]


def test_fleet_serving_drill_raises_without_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fleet.action_chaos_drill(None, 1, serve_drain=True)
