"""The port's elastic-training drills at the seeds of the reference's
tests, asserting what they assert: the preemption and victim-selection
drills (tests/test_preemption.py:470, :482, slow there and here), the
eviction and host-resize drills (tests/test_fleet_elasticity.py:144,
:159). The probes they launch are the port's
(``python -m batch_shipyard_tpu_torch.workloads.preempt_probe`` /
``reshard_probe``) on GPU pools of a3-highgpu-1g nodes. The migration
drill (:171 there) needs the federation and is not ported."""

import pytest

from batch_shipyard_tpu_torch.chaos import drill
from batch_shipyard_tpu_torch.parallel import restore_plan


@pytest.mark.slow
def test_preemption_drill_acceptance():
    report = drill.run_preemption_drill(seed=1)
    assert report["invariants"]["ok"]
    assert report["invariants"]["retries"] == 0
    assert report["invariants"]["preempt_count"] >= 1


@pytest.mark.slow
def test_victim_selection_drill_acceptance():
    report = drill.run_victim_selection_drill(seed=0)
    assert report["invariants"]["ok"]
    assert report["invariants"]["retries"] == 0
    assert report["invariants"]["cheap_preempt_count"] >= 1
    assert report["invariants"]["costly_preempt_count"] == 0
    costs = report["invariants"]["victim_costs"]
    assert costs["aa-costly"] > costs["zz-cheap"]


def test_eviction_drill_acceptance():
    report = drill.run_eviction_drill(seed=1)
    invariants = report["invariants"]
    assert invariants["ok"]
    assert invariants["retries"] == 0
    assert invariants["evict_count"] >= 1
    assert invariants["resumed_from"] <= invariants["notice_step"]
    assert invariants["eviction_seconds"] > 0


def test_host_resize_drill_acceptance():
    report = drill.run_host_resize_drill(seed=1)
    invariants = report["invariants"]
    assert invariants["ok"]
    assert invariants["gang_size"] == 1
    assert invariants["state_bit_exact"]
    assert invariants["recorded_reads"][-2:] == \
        invariants["planned_reads"]
    assert invariants["planned_reads"] == [
        f"shard={r.shard}of2 [{r.lo}..{r.hi})"
        for r in restore_plan.host_reads(24, 2, 1, 0)]


def test_resize_oracle_is_the_probes_update():
    state = drill._resize_oracle(4, 3)
    assert state == [6.0, 12.0, 18.0, 24.0]
