"""Pure scheduling policies: goodput-as-controller decision functions.

The port's copy of batch_shipyard_tpu/sched/policy.py.

The goodput ledger (goodput/accounting.py) prices every second of
fleet time into productive / badput legs — but a meter alone changes
nothing. This module closes the loop: placement, victim selection,
and autoscale decisions are expressed as PURE functions over plain
values, each returning (or minimizing) an *estimated badput cost in
seconds*, so every decision is directly comparable against the
ledger that later prices it.

Shared by construction: the live paths (agent/node_agent.py claim +
preemption sweep, pool/autoscale.py) and the discrete-event fleet
simulator (sim/simulator.py) import THESE functions — never copies —
so a simulated policy delta is evidence about production decision
code (asserted by tests/test_fleet_sim.py).

Decisions:

* ``claim_score``     — expected badput seconds of claiming a task on
                        a given node: a cold compile-cache claim pays
                        the cold-compile leg, an unhealthy node pays
                        an expected-failure debit, a node with recent
                        claim failures pays a backoff debit.
* ``should_defer_claim`` — warm-cache affinity window: a cold/risky
                        node hands a *young* task back to the queue so
                        a warm node can claim it; past the window any
                        node claims (affinity must never starve work).
* ``victim_cost``     — expected badput seconds of preempting a
                        running task: replay rework since the last
                        COMMITTED checkpoint plus the warm compile
                        state destroyed, scaled by gang width.
* ``autoscale_target``— explicit provisioning-badput vs
                        queueing-badput trade: add nodes only while a
                        node's provisioning cost buys back more
                        expected queueing seconds than it spends.

Every knob lives in ``PolicyKnobs`` and is declared in pool settings
(config/settings.py ``sched_policy``) + the pool schema — enforced by
tests/test_names_consistency.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class PolicyKnobs:
    """Tunable constants for every policy decision, all in seconds
    (costs) so decisions compose by addition. Defaults are
    production-shaped; drills and sim scenarios override via pool
    settings (``sched_policy:``)."""

    # --- claim scoring (placement) ---
    # Cold-compile seconds a warm compile-cache claim avoids: the
    # debit a cold node pays when the task names a cache identity.
    warm_cache_bonus_seconds: float = 30.0
    # Expected-failure debit at health 0.0 (scaled linearly by
    # 1 - health): claiming on a flaky node risks a retry round trip.
    health_debit_seconds: float = 120.0
    # Debit per recent claim failure on the node (backoff badput the
    # next failure would add), capped at 4 failures.
    backoff_debit_seconds: float = 30.0
    # Affinity window: a cold/risky node defers a task younger than
    # this (queue age) back to the queue; past it, anyone claims.
    # Sized to the cold-compile cost it can save: waiting up to C
    # seconds of queueing to avoid C seconds of compile badput is
    # the break-even frontier, and a warm slot usually frees well
    # inside it.
    claim_affinity_wait_seconds: float = 30.0

    # --- victim selection (preemption / eviction) ---
    # Warm compile state destroyed by evicting a warm-cache victim
    # (it recompiles on resume).
    victim_warm_cost_seconds: float = 30.0
    # Weight on replay rework (steps past the last COMMITTED
    # checkpoint x step seconds) — 1.0 means rework is priced at
    # wall value.
    victim_step_cost_weight: float = 1.0

    # --- autoscale (provisioning vs queueing badput) ---
    # Provisioning badput one added node pays before it serves.
    provision_seconds_per_node: float = 120.0
    # Mean task service seconds assumed when sizing the backlog
    # drain (live autoscale has no per-task duration oracle).
    avg_task_seconds: float = 60.0
    # Pending wait considered acceptable before scaling up at all.
    queue_tolerance_seconds: float = 30.0


# Ready-made policy bundles: which decisions are active. ``baseline``
# reproduces the pre-policy scheduler (scan-order placement,
# priority-then-task-id victims, reactive autoscale) so every sim
# comparison has an honest control.
@dataclasses.dataclass(frozen=True)
class PolicyConfig:
    name: str
    claim_scoring: bool = False
    victim_by_cost: bool = False
    autoscale_goodput: bool = False


POLICIES: dict = {
    "baseline": PolicyConfig("baseline"),
    "affinity": PolicyConfig("affinity", claim_scoring=True),
    "victim_cost": PolicyConfig("victim_cost", victim_by_cost=True),
    "autoscale": PolicyConfig("autoscale", autoscale_goodput=True),
    "combined": PolicyConfig("combined", claim_scoring=True,
                             victim_by_cost=True,
                             autoscale_goodput=True),
}


def claim_score(*, warm: bool, health: float = 1.0,
                recent_failures: int = 0,
                has_identity: bool = True,
                knobs: Optional[PolicyKnobs] = None) -> float:
    """Expected badput seconds of claiming a task on this node
    (lower is better; 0.0 is a perfect claim).

    ``warm``            — node holds a warm compile cache for the
                          task's identity digest.
    ``health``          — node health in [0, 1] (agent-tracked).
    ``recent_failures`` — node's recent claim-failure count.
    ``has_identity``    — task advertises a compile-cache identity at
                          all; without one there is no cold-compile
                          leg to price (health/backoff still count).
    """
    knobs = knobs or PolicyKnobs()
    score = 0.0
    if has_identity and not warm:
        score += knobs.warm_cache_bonus_seconds
    health = min(1.0, max(0.0, health))
    score += (1.0 - health) * knobs.health_debit_seconds
    score += min(int(recent_failures), 4) * knobs.backoff_debit_seconds
    return score


def should_defer_claim(score: float, queued_seconds: float,
                       knobs: Optional[PolicyKnobs] = None) -> bool:
    """Warm-cache affinity window: hand the task back to the queue
    when this claim would pay a material cost AND the task is young
    enough that a cheaper node plausibly exists. Past the window the
    claim always proceeds — affinity may trade seconds of queueing
    for a cold compile, never starvation."""
    knobs = knobs or PolicyKnobs()
    if queued_seconds >= knobs.claim_affinity_wait_seconds:
        return False
    return score > 0.5 * knobs.warm_cache_bonus_seconds


def victim_cost(*, warm: bool, steps_since_commit: float,
                step_seconds: float, gang_size: int = 1,
                knobs: Optional[PolicyKnobs] = None) -> float:
    """Expected badput seconds of preempting this running task:
    replay rework (steps executed past the last COMMITTED checkpoint
    are re-run on resume, priced at wall value by the accounting
    engine) plus the warm compile state destroyed, scaled by gang
    width (every instance replays)."""
    knobs = knobs or PolicyKnobs()
    rework = max(0.0, float(steps_since_commit)) * \
        max(0.0, float(step_seconds))
    cost = knobs.victim_step_cost_weight * rework
    if warm:
        cost += knobs.victim_warm_cost_seconds
    return cost * max(1, int(gang_size))


def victim_cost_from_row(row: dict,
                         knobs: Optional[PolicyKnobs] = None,
                         ) -> float:
    """Victim cost for a live task entity: reads the sched-hints
    column the agent syncs from the workload's hints file
    (agent/progress.py ``record_sched_hints``). A task that never
    published hints prices at 0.0 — nothing committed, nothing warm,
    nothing to replay that we know of — and falls back to the
    deterministic (priority, cost, task_id) tie-break."""
    from batch_shipyard_tpu_torch.state import names
    hints = row.get(names.TASK_COL_SCHED_HINTS)
    if not isinstance(hints, dict):
        return 0.0
    spec = row.get("spec") or {}
    gang = int((spec.get("multi_instance") or {})
               .get("num_instances", 1) or 1)
    step = float(hints.get("step", 0) or 0)
    ckpt = float(hints.get("ckpt_step", 0) or 0)
    return victim_cost(
        warm=bool(hints.get("cache_identity")),
        steps_since_commit=step - ckpt,
        step_seconds=float(hints.get("step_seconds", 0.0) or 0.0),
        gang_size=gang, knobs=knobs)


def victim_sort_key(priority: int, cost: float, task_id: str) -> tuple:
    """THE deterministic victim order, shared by the live sweep, the
    drill, and the sim: lowest priority first, then cheapest goodput
    cost, then task id — never scan order, so assertions on the
    elected victim cannot flake on dict ordering."""
    return (int(priority), float(cost), str(task_id))


def autoscale_target(*, pending_tasks: int, active_tasks: int,
                     current_nodes: int, slots_per_node: int,
                     knobs: Optional[PolicyKnobs] = None,
                     ) -> tuple[int, str]:
    """Target node count that explicitly trades provisioning badput
    against queueing badput; returns (target, reason).

    Model: the pending backlog is ``pending * avg_task_seconds`` of
    work; with n serving nodes it drains in ``backlog / (n*slots)``
    and each pending task waits half the horizon on average, so the
    expected queueing badput with n nodes is
    ``pending * horizon(n) / 2``. Starting from the busy-node floor,
    nodes are added while one more node saves more expected queueing
    seconds than the ``provision_seconds_per_node`` it costs — the
    marginal-value stopping rule. With an empty queue the fleet
    shrinks to the busy floor (idle badput has no offsetting
    queueing saving)."""
    knobs = knobs or PolicyKnobs()
    slots = max(1, int(slots_per_node))
    busy = -(-max(0, int(active_tasks)) // slots)  # ceil division
    pending = max(0, int(pending_tasks))
    if pending == 0:
        # Drain TOWARD the busy floor, at most 10% of the fleet per
        # call: a retired node costs a full provisioning round trip
        # to get back, so an empty queue on one tick is weak evidence
        # the capacity is surplus. Damping turns trough scale-down
        # into a ramp instead of a cliff and kills the
        # shrink/re-provision churn a reactive target exhibits.
        step = max(1, current_nodes // 10)
        target = max(busy, current_nodes - step)
        if target < current_nodes:
            return target, (f"drain toward busy floor {busy}: no "
                            f"queue, idle badput unpaid-for")
        return max(target, current_nodes), "steady: no pending work"
    backlog = pending * knobs.avg_task_seconds

    def queueing(n: int) -> float:
        horizon = backlog / (max(1, n) * slots)
        return pending * horizon / 2.0

    n = max(busy, 1)
    if queueing(max(n, current_nodes)) <= \
            pending * knobs.queue_tolerance_seconds / 2.0:
        # Backlog drains inside tolerance with what we have.
        return max(n, current_nodes), "queue within tolerance"
    while queueing(n) - queueing(n + 1) > \
            knobs.provision_seconds_per_node:
        n += 1
    saved = queueing(max(busy, 1)) - queueing(n)
    paid = (n - max(busy, 1)) * knobs.provision_seconds_per_node
    return max(n, busy), (
        f"marginal trade: +{n - max(busy, 1)} node(s) pay "
        f"{paid:.0f}s provisioning to save {saved:.0f}s queueing")


def knobs_from_settings(sched_policy) -> PolicyKnobs:
    """PolicyKnobs from a pool's ``SchedPolicySettings`` (or None →
    defaults); kept here so every consumer derives knobs the same
    way."""
    if sched_policy is None:
        return PolicyKnobs()
    fields = {f.name for f in dataclasses.fields(PolicyKnobs)}
    values = {name: getattr(sched_policy, name)
              for name in fields
              if getattr(sched_policy, name, None) is not None}
    return PolicyKnobs(**values)
