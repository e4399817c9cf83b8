"""The port's ChaosPlan against the reference's: over a grid of seeds,
durations, node counts, kind sets and injections per kind, the same
``to_dict()`` and ``fingerprint()`` byte for byte; the same for
``preemption_wave``; round trips through ``from_dict``; unknown kinds
refused (tests/test_chaos_recovery.py:60-83); and ``chaos plan --raw``
through both CLIs with identical output."""

import itertools
import json

import pytest
from click.testing import CliRunner

from batch_shipyard_tpu.chaos import plan as ref_plan
from batch_shipyard_tpu.cli.main import cli as ref_cli
from batch_shipyard_tpu_torch.chaos import plan as port_plan
from batch_shipyard_tpu_torch.cli.main import cli as port_cli

SEEDS = (0, 1, 5, 7, 11, 42, 2**31 - 1)
DURATIONS = (1.0, 3.0, 4.0, 6.0, 10.0)
NODES = (1, 2, 4, 16)
PER_KIND = (1, 2, 3)
KIND_SETS = ([None, port_plan.DEFAULT_DRILL_KINDS,
              port_plan.INJECTION_KINDS]
             + [(kind,) for kind in port_plan.INJECTION_KINDS])


def _dump(plan) -> str:
    return json.dumps(plan.to_dict(), sort_keys=True)


def test_vocabulary_is_the_references():
    assert port_plan.INJECTION_KINDS == ref_plan.INJECTION_KINDS
    assert port_plan.DEFAULT_DRILL_KINDS == ref_plan.DEFAULT_DRILL_KINDS


@pytest.mark.parametrize("kinds", KIND_SETS,
                         ids=lambda k: "default" if k is None else
                         k[0] if len(k) == 1 else f"{len(k)}-kinds")
def test_generate_matches_the_reference_byte_for_byte(kinds):
    for seed, duration, nodes, per_kind in itertools.product(
            SEEDS, DURATIONS, NODES, PER_KIND):
        args = dict(duration=duration, num_nodes=nodes, kinds=kinds,
                    injections_per_kind=per_kind)
        want = ref_plan.ChaosPlan.generate(seed, **args)
        got = port_plan.ChaosPlan.generate(seed, **args)
        assert got.fingerprint() == want.fingerprint(), (seed, args)
        assert _dump(got) == _dump(want), (seed, args)


@pytest.mark.parametrize("fraction", (0.1, 0.3, 0.5, 1.0))
def test_preemption_wave_matches_the_reference(fraction):
    for seed, nodes, at, revive, stagger in itertools.product(
            SEEDS, (1, 3, 10, 64), (0.0, 12.5), (5.0, 60.0),
            (0.0, 5.0)):
        args = dict(at=at, num_nodes=nodes, fraction=fraction,
                    revive_after=revive, stagger=stagger)
        want = ref_plan.ChaosPlan.preemption_wave(seed, **args)
        got = port_plan.ChaosPlan.preemption_wave(seed, **args)
        assert _dump(got) == _dump(want), (seed, args)
        assert got.fingerprint() == want.fingerprint()


@pytest.mark.parametrize("seed", SEEDS)
def test_from_dict_round_trips_either_packages_json(seed):
    plan = port_plan.ChaosPlan.generate(
        seed, duration=6.0, num_nodes=4,
        kinds=port_plan.INJECTION_KINDS, injections_per_kind=2)
    for payload in (plan.to_dict(), ref_plan.ChaosPlan.generate(
            seed, duration=6.0, num_nodes=4,
            kinds=ref_plan.INJECTION_KINDS,
            injections_per_kind=2).to_dict()):
        rt = port_plan.ChaosPlan.from_dict(
            json.loads(json.dumps(payload)))
        assert rt == plan
        assert rt.fingerprint() == payload["fingerprint"]


def test_same_seed_same_schedule():
    """test_chaos_recovery.py:60 on the port."""
    a = port_plan.ChaosPlan.generate(7, duration=10.0, num_nodes=4)
    b = port_plan.ChaosPlan.generate(7, duration=10.0, num_nodes=4)
    assert a.fingerprint() == b.fingerprint()
    assert a.injections == b.injections
    assert a.fingerprint() != port_plan.ChaosPlan.generate(8).fingerprint()
    ats = [i.at for i in a.injections]
    assert ats == sorted(ats)
    assert all(0 < at < 10.0 for at in ats)


@pytest.mark.parametrize("kinds", [("task_wedge", "bogus"), ("bogus",),
                                   ("replica_kill", "migrate")])
def test_unknown_kind_refused_by_both(kinds):
    for mod in (ref_plan, port_plan):
        with pytest.raises(ValueError, match="unknown injection kinds"):
            mod.ChaosPlan.generate(0, kinds=kinds)


@pytest.mark.parametrize("argv", [
    [],
    ["--seed", "5", "--kinds",
     "task_wedge,task_kill,node_preempt,heartbeat_blackout"],
    ["--seed", "11", "--duration", "3.0", "--kinds",
     "store_delay,store_error", "--injections-per-kind", "2"],
    ["--seed", "1", "--num-nodes", "2", "--kinds", "host_loss_resize"],
    ["--seed", "3", "--num-nodes", "16", "--kinds",
     ",".join(port_plan.INJECTION_KINDS), "--injections-per-kind", "3"],
])
def test_cli_chaos_plan_raw_matches_the_reference(argv):
    ref = CliRunner().invoke(ref_cli, ["--raw", "chaos", "plan", *argv])
    port = CliRunner().invoke(port_cli, ["--raw", "chaos", "plan", *argv])
    assert ref.exit_code == port.exit_code == 0, (ref.output, port.output)
    assert port.output == ref.output
    assert json.loads(port.output)["injections"]


def test_cli_chaos_plan_yaml_matches_the_reference():
    argv = ["chaos", "plan", "--seed", "9", "--kinds",
            "replica_drain_notice,router_restart"]
    ref = CliRunner().invoke(ref_cli, argv)
    port = CliRunner().invoke(port_cli, argv)
    assert ref.exit_code == port.exit_code == 0
    assert port.output == ref.output
