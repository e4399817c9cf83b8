"""Scenario-based pool autoscale.

The port's copy of batch_shipyard_tpu/pool/autoscale.py. Reference
analog: convoy/autoscale.py — generates Azure Batch autoscale *formula
text* from scenario names (_AUTOSCALE_SCENARIOS :351: active_tasks,
pending_tasks, workday, workday_with_offpeak_max_low_priority, weekday,
weekend) with knobs for min/max/max-increment, bias_last_sample,
rebalance_preemption_percentage (:92-300).

There is no hosted formula evaluator, so this module IS the evaluator —
`evaluate` samples live task/node state from the state store and
produces a target node count; `autoscale_tick` applies it through the
substrate. The same scenario names and knobs are honored. A user
`formula` is a restricted Python expression evaluated over the sampled
variables (the power-user escape hatch the reference gives via raw
formulas).

Node counts, not slices: a GPU pool is one flat set of nodes, one slice
(substrate/fakepod.py), so every target here is a count of nodes in the
units of ``vm_configuration.vm_count``, applied as one
``substrate.resize_pool(pool, nodes)``. ``target_slices`` stays None,
as the reference reports it for a pool without a ``tpu:`` block.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Optional

from batch_shipyard_tpu_torch.config.settings import (
    AutoscaleScenarioSettings, PoolSettings)
from batch_shipyard_tpu_torch.goodput import events as goodput_events
from batch_shipyard_tpu_torch.pool import manager as pool_mgr
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import StateStore
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)


@dataclasses.dataclass(frozen=True)
class Samples:
    """The $ActiveTasks/$PendingTasks/$CurrentDedicated analog."""

    active_tasks: int       # running + assigned
    pending_tasks: int      # pending (incl. waiting deps)
    current_nodes: int
    # Nodes the provider reclaimed (spot/low-priority preemption) —
    # the $PreemptedNodeCount sample of the reference's formulas
    # (autoscale.py:92-104).
    preempted_nodes: int
    task_slots_per_node: int
    now: datetime.datetime


def sample(store: StateStore, pool: PoolSettings,
           now: Optional[datetime.datetime] = None) -> Samples:
    active = 0
    pending = 0
    for job in store.query_entities(names.TABLE_JOBS,
                                    partition_key=pool.id):
        if job.get("state") != "active":
            continue
        pk = names.task_pk(pool.id, job["_rk"])
        for task in store.query_entities(names.TABLE_TASKS,
                                         partition_key=pk):
            state = task.get("state")
            if state in ("running", "assigned"):
                active += 1
            elif state in names.CLAIMABLE_TASK_STATES:
                # pending + preempted-awaiting-reclaim: both are
                # demand the pool has not yet placed.
                pending += 1
    all_nodes = pool_mgr.list_nodes(store, pool.id)
    nodes = [n for n in all_nodes if n.state in pool_mgr.READY_STATES]
    preempted = [n for n in all_nodes if n.state == "preempted"]
    return Samples(
        active_tasks=active, pending_tasks=pending,
        current_nodes=len(nodes),
        preempted_nodes=len(preempted),
        task_slots_per_node=pool.task_slots_per_node,
        now=now or util.utcnow())


def _clamp(value: int, scenario: AutoscaleScenarioSettings,
           current: int) -> int:
    lo = scenario.minimum_vm_count_dedicated
    hi = scenario.maximum_vm_count_dedicated
    value = max(lo, min(hi, value))
    inc = scenario.maximum_vm_increment_dedicated
    if inc > 0 and value > current:
        value = min(value, current + inc)
    return value


def _in_time_range(now: datetime.datetime, scenario_name: str,
                   time_ranges: dict) -> bool:
    """Work-hours check for the workday/weekday scenarios. Defaults
    mirror the reference: Mon-Fri, 08:00-18:00 (autoscale.py:211+)."""
    work_days = time_ranges.get("weekdays", {"start": 0, "end": 4})
    work_hours = time_ranges.get("work_hours", {"start": 8, "end": 17})
    is_work_day = work_days["start"] <= now.weekday() <= work_days["end"]
    is_work_hour = (work_hours["start"] <= now.hour
                    <= work_hours["end"])
    if scenario_name == "weekend":
        return not is_work_day
    if scenario_name == "weekday":
        return is_work_day
    return is_work_day and is_work_hour


def evaluate(store: StateStore, pool: PoolSettings,
             now: Optional[datetime.datetime] = None) -> dict:
    """Compute the autoscale decision for a pool. Returns
    {target_nodes, target_slices, reason} without applying it."""
    autoscale = pool.autoscale
    samples = sample(store, pool, now)
    rebalance_applied = False
    if autoscale.formula:
        target = _eval_formula(autoscale.formula, samples)
        reason = "user formula"
    else:
        scenario = autoscale.scenario
        if scenario is None:
            return {"target_nodes": samples.current_nodes,
                    "target_slices": None,
                    "reason": "no scenario configured"}
        name = scenario.name
        if name in ("active_tasks", "pending_tasks"):
            backlog = (samples.active_tasks if name == "active_tasks"
                       else samples.active_tasks + samples.pending_tasks)
            needed = math.ceil(backlog / max(
                1, samples.task_slots_per_node))
            if scenario.bias_last_sample:
                # Weight current demand 2:1 over capacity inertia.
                needed = math.ceil(
                    (2 * needed + samples.current_nodes) / 3)
            target = _clamp(needed, scenario, samples.current_nodes)
            reason = (f"{name}: backlog={backlog} "
                      f"slots/node={samples.task_slots_per_node}")
        elif name == "goodput":
            # Goodput-as-controller: size the fleet where the marginal
            # node stops paying for its own provisioning badput with
            # saved queueing badput (sched/policy.py autoscale_target —
            # the SAME function the fleet simulator prices, so the sim's
            # measured goodput deltas transfer to this live path).
            from batch_shipyard_tpu_torch.sched import policy as sched_policy
            knobs = sched_policy.knobs_from_settings(
                getattr(pool, "sched_policy", None))
            raw, why = sched_policy.autoscale_target(
                pending_tasks=samples.pending_tasks,
                active_tasks=samples.active_tasks,
                current_nodes=samples.current_nodes,
                slots_per_node=samples.task_slots_per_node,
                knobs=knobs)
            target = _clamp(raw, scenario, samples.current_nodes)
            reason = f"goodput: {why}"
        elif name in ("workday", "weekday", "weekend",
                      "workday_with_offpeak_max_low_priority"):
            in_range = _in_time_range(samples.now, name,
                                      scenario.time_ranges)
            if in_range:
                dedicated = scenario.maximum_vm_count_dedicated
                low_priority = scenario.minimum_vm_count_low_priority
            elif name == "workday_with_offpeak_max_low_priority":
                # Off-peak: dedicated drops to minimum while cheap
                # low-priority capacity rises to its maximum
                # (reference offpeak semantics, autoscale.py:211+).
                dedicated = scenario.minimum_vm_count_dedicated
                low_priority = scenario.maximum_vm_count_low_priority
            else:
                dedicated = scenario.minimum_vm_count_dedicated
                low_priority = scenario.minimum_vm_count_low_priority
            if _rebalance_triggered(scenario, samples):
                # Preemption pressure: the provider is reclaiming
                # low-priority capacity faster than the threshold —
                # shift the low-priority share of the target into
                # dedicated (reference rebalance formula,
                # autoscale.py:92-135).
                dedicated = min(dedicated + low_priority,
                                scenario.maximum_vm_count_dedicated)
                low_priority = 0
                rebalance_applied = True
            target = _clamp(dedicated, scenario,
                            samples.current_nodes) + low_priority
            reason = (f"{name}: in_range={in_range} at {samples.now}"
                      + (" [rebalanced to dedicated on preemption]"
                         if rebalance_applied else ""))
        else:
            raise ValueError(f"unknown autoscale scenario {name!r}")
    return {"target_nodes": target, "target_slices": None,
            "current_nodes": samples.current_nodes,
            "active_tasks": samples.active_tasks,
            "pending_tasks": samples.pending_tasks,
            "preempted_nodes": samples.preempted_nodes,
            # True only when the dedicated/low-priority shift was
            # actually applied (the workday-family branch) — backlog
            # scenarios and user formulas have no class mix to shift.
            "rebalance": rebalance_applied,
            "reason": reason}


def _rebalance_triggered(scenario: AutoscaleScenarioSettings,
                         samples: Samples) -> bool:
    """Preemption-pressure signal: percentage of current capacity the
    provider has reclaimed >= rebalance_preemption_percentage
    (reference autoscale.py:121-131 'preemptedpercent >= threshold';
    the knob is 0-100)."""
    rpp = scenario.rebalance_preemption_percentage
    if rpp is None:
        return False
    total = samples.current_nodes + samples.preempted_nodes
    if total == 0:
        return False
    return 100.0 * samples.preempted_nodes / total >= float(rpp)


_FORMULA_BUILTINS = {"min": min, "max": max, "ceil": math.ceil,
                     "floor": math.floor, "abs": abs, "round": round}

_ALLOWED_AST_NODES = (
    "Expression", "BinOp", "UnaryOp", "BoolOp", "Compare", "IfExp",
    "Call", "Name", "Load", "Constant", "Add", "Sub", "Mult", "Div",
    "FloorDiv", "Mod", "Pow", "USub", "UAdd", "And", "Or", "Not",
    "Eq", "NotEq", "Lt", "LtE", "Gt", "GtE", "Tuple", "List",
)


def _validate_formula_ast(formula: str, allowed_names: set[str]) -> None:
    """AST allowlist: arithmetic/comparison expressions over known
    names only. No attribute access, subscripts, lambdas, or
    comprehensions — which closes the empty-__builtins__ escape chains
    (().__class__... style)."""
    import ast
    try:
        tree = ast.parse(formula, mode="eval")
    except SyntaxError as exc:
        raise ValueError(f"autoscale formula syntax error: {exc}")
    for node in ast.walk(tree):
        kind = type(node).__name__
        if kind not in _ALLOWED_AST_NODES:
            raise ValueError(
                f"autoscale formula: disallowed construct {kind}")
        if isinstance(node, ast.Name) and node.id not in allowed_names:
            raise ValueError(
                f"autoscale formula: unknown name {node.id!r}")
        if isinstance(node, ast.Call) and not isinstance(
                node.func, ast.Name):
            raise ValueError(
                "autoscale formula: only direct function calls to "
                "the math subset are allowed")


def _eval_formula(formula: str, samples: Samples) -> int:
    """Evaluate a user formula over sampled variables; AST-validated
    against an allowlist before eval."""
    variables = {
        "active_tasks": samples.active_tasks,
        "pending_tasks": samples.pending_tasks,
        "current_nodes": samples.current_nodes,
        "task_slots_per_node": samples.task_slots_per_node,
        "hour": samples.now.hour,
        "weekday": samples.now.weekday(),
    }
    _validate_formula_ast(
        formula, set(_FORMULA_BUILTINS) | set(variables))
    try:
        result = eval(  # noqa: S307 - AST-allowlisted above
            formula, {"__builtins__": {}},
            {**_FORMULA_BUILTINS, **variables})
    except Exception as exc:
        raise ValueError(f"autoscale formula error: {exc}") from exc
    if not isinstance(result, (int, float)):
        raise ValueError("autoscale formula must yield a number")
    return int(result)


def enable_autoscale(store: StateStore, pool: PoolSettings) -> None:
    store.merge_entity(names.TABLE_POOLS, "pools", pool.id,
                       {"autoscale_enabled": True})


def disable_autoscale(store: StateStore, pool: PoolSettings) -> None:
    store.merge_entity(names.TABLE_POOLS, "pools", pool.id,
                       {"autoscale_enabled": False})


def autoscale_tick(store: StateStore, substrate, pool: PoolSettings,
                   now: Optional[datetime.datetime] = None) -> dict:
    """One evaluation + application cycle (the hosted evaluator loop the
    reference delegates to Azure Batch, batch.py:1636-1755)."""
    entity = pool_mgr.get_pool(store, pool.id)
    if not entity.get("autoscale_enabled"):
        decision = evaluate(store, pool, now)
        decision["applied"] = False
        return decision
    # Substrates that can detect provider reclamation refresh node
    # states first, so the preemption sample feeding
    # rebalance_preemption_percentage is live (fake/localhost have
    # nothing to poll).
    refresh = getattr(substrate, "refresh_node_states", None)
    if refresh is not None:
        try:
            refresh(pool)
        except Exception:
            logger.exception("node-state refresh failed for %s",
                             pool.id)
    decision = evaluate(store, pool, now)
    _record_preemptions(store, entity, pool.id,
                        decision["preempted_nodes"])
    # A GPU pool resizes by node count (module doc).
    current = len(pool_mgr.list_nodes(store, pool.id))
    if decision["target_nodes"] != current:
        logger.info("autoscale: %s nodes %d -> %d (%s)", pool.id,
                    current, decision["target_nodes"],
                    decision["reason"])
        with goodput_events.span(
                store, pool.id, goodput_events.NODE_PROVISIONING,
                attrs={"reason": "autoscale_resize",
                       "from_nodes": current,
                       "to_nodes": decision["target_nodes"]}):
            substrate.resize_pool(pool, decision["target_nodes"])
        decision["applied"] = True
        return decision
    decision["applied"] = False
    return decision


def _record_preemptions(store: StateStore, pool_entity: dict,
                        pool_id: str, preempted_nodes: int) -> None:
    """Goodput: record provider reclamation as it is OBSERVED. A
    rising count emits an instantaneous marker (the preemption
    counter); when the count drains back to zero the whole outage is
    emitted as ONE preempted->recovered SPAN (tick-granular downtime,
    priced as provisioning badput). State rides the pool entity so
    dedupe and the open-outage start survive daemon restarts."""
    import time as time_mod
    last = int(pool_entity.get("goodput_preempted_nodes", 0) or 0)
    since = pool_entity.get("goodput_preempted_since")
    now = time_mod.time()
    patch: dict = {}
    if preempted_nodes != last:
        patch["goodput_preempted_nodes"] = preempted_nodes
    if preempted_nodes > last:
        if since is None:
            patch["goodput_preempted_since"] = now
        goodput_events.emit(
            store, pool_id, goodput_events.NODE_PREEMPTED,
            start=now, end=now,
            attrs={"preempted_nodes": preempted_nodes,
                   "newly_preempted": preempted_nodes - last})
    elif preempted_nodes == 0 and last > 0 and since is not None:
        goodput_events.emit(
            store, pool_id, goodput_events.NODE_PREEMPTED,
            start=float(since), end=now,
            attrs={"recovered": True, "nodes": last})
        patch["goodput_preempted_since"] = None
    if patch:
        try:
            store.merge_entity(names.TABLE_POOLS, "pools", pool_id,
                               patch)
        except Exception:  # noqa: BLE001 - accounting is advisory
            logger.exception("preemption bookkeeping failed for %s",
                             pool_id)


def run_daemon(store: StateStore, substrate, pool: PoolSettings,
               stop_event=None, interval: Optional[float] = None) -> None:
    """Periodic evaluation loop honoring
    autoscale.evaluation_interval_seconds (the hosted evaluator's
    cadence)."""
    import threading
    import time as time_mod
    stop = stop_event or threading.Event()
    period = interval or pool.autoscale.evaluation_interval_seconds
    while not stop.wait(period):
        try:
            autoscale_tick(store, substrate, pool)
        except Exception:
            logger.exception("autoscale tick failed for %s", pool.id)
