"""Chaos drill: run a seeded fault schedule against a real fakepod
pool and assert the self-healing invariants.

The drill is the proof the recovery layer demands: it builds a pool of
REAL NodeAgents (threads over a shared state store), submits a batch
of watchdog-protected tasks, replays a ChaosPlan's injections at their
scheduled offsets — wedges, mid-run kills, node preemptions, heartbeat
blackouts, store faults — then verifies that the system healed:

  * every task reached ``completed`` (bounded retries beat every
    injected fault),
  * exactly-once effects (each task's output holds exactly its line),
  * no orphaned coordination state (gang rows, queue messages),
  * the goodput partition stayed exact (productive + badput +
    overlapped == wall) — chaos may move seconds between categories
    but can never lose any.

The port's copy of batch_shipyard_tpu/chaos/drill.py over the port's
fakepod, agents, store and managers, used by `shipyard-tpu-torch chaos
drill` and the port's tests. Its pools are GPU pools of a3-highgpu-1g
nodes (``_pool_conf``): the reference's v5litepod-16 slice is four hosts,
so its drills here run four nodes, and every plan and fingerprint equals
the reference's. Left out: the cross-pool migration drill, which needs the
federation. One repair: ``_check_invariants`` lets a task whose stdout
upload an injected store error cut (the agent records ``output_error``
and goes on, by design) pass without its blob, but only as the bounded
outcome of the faults the drill applied (``_check_lost_output``).
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import sys
import tempfile
import threading
import time
from typing import Optional

from batch_shipyard_tpu_torch.chaos import injectors as injectors_mod
from batch_shipyard_tpu_torch.chaos.plan import ChaosPlan
from batch_shipyard_tpu_torch.config import settings as settings_mod
from batch_shipyard_tpu_torch.goodput import accounting
from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
from batch_shipyard_tpu_torch.pool import manager as pool_mgr
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state import resilient as state_resilient
from batch_shipyard_tpu_torch.state.base import NotFoundError
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)


def _submit_jobs(store, pool, jobs) -> dict:
    """Every drill's submission leg rides the group-commit lane
    (state/resilient.py ``group_commit``): task rows and queue
    messages buffer, coalesce, and land in combined round trips —
    the same seeds that pin the recovery layer now also pin that
    write-combining preserves submission semantics exactly (any
    lost or double-applied write breaks the drill's completion,
    exactly-once, or goodput-partition invariants)."""
    gc_store = state_resilient.ResilientStore(
        store,
        journal_path=os.path.join(
            tempfile.gettempdir(),
            f"shipyard-drill-gc-{os.getpid()}-{id(store)}.jsonl"))
    with gc_store.group_commit():
        return jobs_mgr.add_jobs(gc_store, pool, jobs)

POOL_ID = "chaos-drill"
JOB_ID = "drill"
# Every drill workload carries one real gang task alongside the
# regular tasks: without it TABLE_GANGS is empty by construction and
# the "no orphaned gang rows" invariant would be vacuously true — a
# leak in _clear_gang_rows/_recover_broken_gang under chaos would
# pass every drill.
GANG_TASK_ID = "g000"
GANG_INSTANCES = 2
# The drill pools' node type: a GPU node, one per host the reference's
# TPU slice has.
VM_SIZE = "a3-highgpu-1g"
# The generic drill's node count: the hosts of the reference's
# v5litepod-16 slice, which keeps its plans equal to the reference's.
DRILL_NODES = 4


def _pool_conf(nodes: int, slots: int) -> dict:
    return {"pool_specification": {
        "id": POOL_ID, "substrate": "fake",
        "vm_configuration": {"vm_size": VM_SIZE,
                             "vm_count": {"dedicated": nodes}},
        "task_slots_per_node": slots,
        "max_wait_time_seconds": 60}}


def run_drill(seed: int = 0, tasks: int = 16,
              duration: float = 4.0,
              kinds: Optional[tuple[str, ...]] = None,
              injections_per_kind: int = 1,
              task_sleep: float = 1.2,
              wait_timeout: float = 120.0,
              plan: Optional[ChaosPlan] = None) -> dict:
    """Run one drill; returns the report dict (invariants + plan
    fingerprint + goodput decomposition). Raises AssertionError when
    an invariant does not hold.

    Defaults are tuned so the submitted work SPANS the injection
    window (tasks * task_sleep ≈ 2-3x duration / slots): a kill
    scheduled at t=3 must find a victim actually running, or the
    drill proves nothing about the kill paths. ``tasks`` counts the
    regular tasks; one gang task (``GANG_TASK_ID``) always rides
    along so the gang-row cleanup invariant is actually exercised."""
    from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

    raw_store = MemoryStateStore()
    chaos_store = injectors_mod.ChaosStore(raw_store)
    # Agents live on the chaos-wrapped store (they must survive the
    # faults); the drill driver itself orchestrates through the raw
    # store so an injected error never masquerades as a driver bug.
    substrate = FakePodSubstrate(chaos_store, node_stale_seconds=3.0)
    substrate.agent_kwargs = {
        "retry_backoff_base": 0.2, "retry_backoff_cap": 2.0,
        # The claimed-message window floors crashed-node recovery
        # latency; production's 60s would dominate a seconds-scale
        # drill.
        "claim_visibility_seconds": 5.0,
        # Fast janitor cadence: a cleanup lost to an injected store
        # fault must be swept inside the invariant-check window.
        "gang_sweep_interval": 1.0}
    conf = _pool_conf(DRILL_NODES, 2)
    pool = settings_mod.pool_settings(conf)
    if plan is None:
        plan = ChaosPlan.generate(
            seed, duration=duration, num_nodes=DRILL_NODES,
            kinds=kinds, injections_per_kind=injections_per_kind)
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    try:
        pool_mgr.create_pool(raw_store, substrate, pool,
                             settings_mod.global_settings({}), conf)
        jobs = settings_mod.job_settings_list({"job_specifications": [{
            "id": JOB_ID,
            "tasks": [{"id": f"t{i:03d}",
                       "command": (f"sleep {task_sleep} && "
                                   f"echo drill-{i}"),
                       "max_task_retries": 8,
                       "progress_deadline_seconds": 2}
                      for i in range(tasks)]
                     + [{"id": GANG_TASK_ID,
                         "command": (f"sleep {task_sleep} && "
                                     "echo drill-gang"),
                         "max_task_retries": 8,
                         "progress_deadline_seconds": 2,
                         "multi_instance": {
                             "num_instances": GANG_INSTANCES}}],
        }]})
        started = time.monotonic()
        _submit_jobs(raw_store, pool, jobs)
        driver = threading.Thread(
            target=_inject_schedule,
            args=(plan, started, substrate, chaos_store, report),
            daemon=True, name="chaos-driver")
        driver.start()
        task_rows = jobs_mgr.wait_for_tasks(
            raw_store, POOL_ID, JOB_ID, timeout=wait_timeout,
            poll_interval=0.25)
        driver.join(timeout=max(0.0, duration -
                                (time.monotonic() - started)) + 5.0)
        report["injected_errors"] = chaos_store.injected_errors()
        _check_invariants(raw_store, task_rows, tasks, report)
    finally:
        substrate.stop_all()
    return report


def run_preemption_drill(seed: int = 0, instances: int = 4,
                         steps: int = 60, step_seconds: float = 0.08,
                         duration: float = 4.0,
                         wait_timeout: float = 120.0) -> dict:
    """Preemption-recovery drill: a seeded node_preempt_notice
    schedule preempts a RUNNING ``instances``-wide gang mid-training
    (the preempt_probe workload — real beats, real step windows, the
    real COMMITTED-marker commit protocol). Asserts the elastic-
    training acceptance invariants:

      * the gang drained cooperatively, requeued with the distinct
        preempted status, and resumed from the forced COMMITTED
        checkpoint with ZERO lost steps beyond the barrier (the step
        ledger is contiguous and replay-free),
      * the retry budget was untouched (retries == 0) and
        preempt_count advanced,
      * node health was not debited (an externally-caused exit says
        nothing about the node),
      * the goodput partition stayed exact AND the
        preemption_recovery leg is actually populated.

    Raises AssertionError on any violation; returns the report."""
    from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

    store = MemoryStateStore()
    # Fast heartbeats: preempt-request delivery rides the heartbeat
    # loop, and the drill's notice windows must dwarf one beat.
    substrate = FakePodSubstrate(store, heartbeat_interval=0.2,
                                 node_stale_seconds=5.0)
    substrate.agent_kwargs = {"claim_visibility_seconds": 5.0,
                              "gang_sweep_interval": 1.0}
    conf = _pool_conf(4, 1)
    pool = settings_mod.pool_settings(conf)
    plan = ChaosPlan.generate(seed, duration=duration,
                              num_nodes=instances,
                              kinds=("node_preempt_notice",))
    # Deterministic cooperation: widen every notice window well past
    # one heartbeat + one step, so the drill always exercises the
    # COOPERATIVE path (the hard-kill fallback is the generic drill's
    # territory). Pure function of the seed, still.
    plan = dataclasses.replace(plan, injections=tuple(
        dataclasses.replace(inj, params=tuple(sorted(
            {**dict(inj.params), "notice": 2.5}.items())))
        for inj in plan.injections))
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    ckpt = os.path.join(substrate.work_root, "probe", "state.json")
    repo_root = str(pathlib.Path(__file__).resolve().parents[2])
    try:
        pool_mgr.create_pool(store, substrate, pool,
                             settings_mod.global_settings({}), conf)
        jobs = settings_mod.job_settings_list({"job_specifications": [{
            "id": JOB_ID,
            "tasks": [{"id": GANG_TASK_ID,
                       "command": (
                           f"{sys.executable} -m batch_shipyard_tpu_torch"
                           f".workloads.preempt_probe "
                           f"--steps {steps} "
                           f"--step-seconds {step_seconds} "
                           f"--ckpt {ckpt}"),
                       "environment_variables": {
                           "PYTHONPATH": repo_root},
                       "max_task_retries": 3,
                       "multi_instance": {
                           "num_instances": instances,
                           "jax_distributed": {"enabled": False}}}],
        }]})
        started = time.monotonic()
        _submit_jobs(store, pool, jobs)
        driver = threading.Thread(
            target=_inject_schedule,
            args=(plan, started, substrate, None, report),
            daemon=True, name="chaos-preempt-driver")
        driver.start()
        task_rows = jobs_mgr.wait_for_tasks(
            store, POOL_ID, JOB_ID, timeout=wait_timeout,
            poll_interval=0.25)
        driver.join(timeout=5.0)
        _check_preemption_invariants(store, task_rows, ckpt, steps,
                                     report)
    finally:
        substrate.stop_all()
    return report


def _check_preemption_invariants(store, task_rows: list, ckpt: str,
                                 steps: int, report: dict) -> None:
    invariants = report["invariants"]
    task = task_rows[0]
    invariants["state"] = task.get("state")
    assert task.get("state") == "completed", task
    # Full budget preserved: preemption consumed ZERO retries.
    invariants["retries"] = int(task.get("retries", 0))
    invariants["preempt_count"] = int(
        task.get(names.TASK_COL_PREEMPT_COUNT, 0) or 0)
    assert invariants["retries"] == 0, (
        f"preemption consumed retry budget: {task}")
    assert invariants["preempt_count"] >= 1, (
        f"drill never preempted the gang: {report['applied']}")
    # Zero lost steps beyond the barrier: the writer's step ledger is
    # contiguous (each preempted attempt's commit is exactly where
    # the next attempt resumed — no replay, no gap) and covers every
    # step exactly once.
    with open(ckpt + ".steps.log", encoding="utf-8") as fh:
        ledger = [line.split() for line in fh if line.strip()]
    invariants["step_ledger"] = [" ".join(parts) for parts in ledger]
    cursor = 0
    for _inst, span, _status in ledger:
        lo, hi = span.split("..")
        assert int(lo) == cursor, (
            f"step ledger not contiguous (lost or replayed steps): "
            f"{invariants['step_ledger']}")
        cursor = int(hi)
    assert cursor == steps, invariants["step_ledger"]
    assert ledger[-1][2] == "completed", invariants["step_ledger"]
    # Node health untouched: externally-caused exits are neutral.
    for node in store.query_entities(names.TABLE_NODES,
                                     partition_key=POOL_ID):
        health = float(node.get(names.NODE_COL_HEALTH, 1.0) or 1.0)
        assert health >= 1.0, (
            f"preemption debited node health: "
            f"{node['_rk']}={health}")
        assert not node.get(names.NODE_COL_QUARANTINED), node
    invariants["node_health_untouched"] = True
    # Goodput: partition exact AND the preemption_recovery leg is
    # actually populated by the drill (the recovery interval from
    # preempted exit to re-claim).
    pool_report = _assert_partition_exact(store, POOL_ID, invariants)
    recovery = pool_report["badput_seconds"].get(
        "preemption_recovery", 0.0)
    invariants["preemption_recovery_seconds"] = recovery
    assert recovery > 0.0, (
        f"preemption_recovery not populated: "
        f"{pool_report['badput_seconds']}")
    report["goodput"] = {
        "goodput_ratio": pool_report["goodput_ratio"],
        "badput_seconds": pool_report["badput_seconds"],
    }
    invariants["ok"] = True


def _assert_partition_exact(store, pool_id: str,
                            invariants: dict) -> dict:
    """THE shared acceptance check of every drill: chaos may move
    seconds between goodput categories but can never create or lose
    any — productive + badput + overlapped == wall to fp tolerance.
    Returns the pool report so callers assert their leg-specific
    invariants against the same snapshot."""
    pool_report = accounting.pool_report(store, pool_id,
                                         include_jobs=False)
    total = (pool_report["productive_seconds"]
             + sum(pool_report["badput_seconds"].values())
             + sum(pool_report["overlapped_seconds"].values()))
    invariants["goodput_wall_seconds"] = pool_report["wall_seconds"]
    invariants["goodput_partition_total"] = total
    assert abs(total - pool_report["wall_seconds"]) <= max(
        1e-6 * max(1.0, pool_report["wall_seconds"]), 1e-6), (
        f"goodput partition broke: {total} != "
        f"{pool_report['wall_seconds']}")
    return pool_report


def _await_no_gang_rows(store, invariants: dict,
                        timeout: float = 30.0) -> None:
    """No-orphaned-coordination-state invariant: gang rendezvous
    rows must all be retired within a bounded window (cleanups lost
    to injected faults are repaired by the janitor sweep)."""
    deadline = time.monotonic() + timeout
    while True:
        leftover = list(store.query_entities(names.TABLE_GANGS))
        if not leftover or time.monotonic() >= deadline:
            break
        time.sleep(0.25)
    invariants["orphaned_gang_rows"] = len(leftover)
    assert not leftover, leftover


def run_victim_selection_drill(seed: int = 0, steps: int = 160,
                               step_seconds: float = 0.05,
                               wait_timeout: float = 120.0) -> dict:
    """Victim-SELECTION drill: the preemption drill's missing half.
    The preemption drill proves a victim drains correctly; this one
    proves the sweep picks the RIGHT victim. Two eligible victims run
    side by side on a two-node pool:

      * ``aa-costly`` — never commits mid-run and advertises a warm
        compile-cache identity: killing it destroys warm state and
        replays every executed step (high goodput cost). Its task id
        sorts FIRST, so the pre-policy (priority, task_id) tie-break
        would elect it.
      * ``zz-cheap``  — commits EVERY step (steps-since-commit ~= 0)
        and holds nothing warm: killing it costs almost nothing.

    A strictly higher-priority task then starves. The sweep's shared
    goodput-cost ordering (sched/policy.py ``victim_cost_from_row`` +
    ``victim_sort_key``, the very functions the fleet simulator
    prices) must deterministically elect ``zz-cheap`` — the id order
    guarantees the choice can only come from the cost term, pinning
    the policy in the LIVE sweep path. Asserts:

      * both victims' sched hints were mirrored into their task rows
        (the heartbeat `_sync_sched_hints` leg) and priced the costly
        victim strictly dearer BEFORE the starver existed,
      * ``zz-cheap`` was preempted (cooperatively, zero retries) and
        ``aa-costly`` was NOT touched (no preempt, no evict),
      * the starver and both victims all completed,
      * the goodput partition stayed exact with the
        preemption_recovery leg populated."""
    from batch_shipyard_tpu_torch.sched import policy as sched_policy
    from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

    store = MemoryStateStore()
    substrate = FakePodSubstrate(store, heartbeat_interval=0.2,
                                 node_stale_seconds=5.0)
    substrate.agent_kwargs = {
        "claim_visibility_seconds": 5.0, "gang_sweep_interval": 1.0,
        # One election per starvation episode: the sweep interval must
        # dwarf drain + re-claim latency (~0.5s), or a second sweep
        # fires while the starver is still queued and elects the
        # costly victim too — the drill asserts it is never touched.
        "preempt_sweep_interval": 2.5,
        "preempt_grace_seconds": 1.0}
    conf = _pool_conf(2, 1)
    pool = settings_mod.pool_settings(conf)
    report: dict = {"seed": seed, "fingerprint": f"victim-sel-{seed}",
                    "applied": [], "invariants": {}}
    work = os.path.join(substrate.work_root, "probe")
    repo_root = str(pathlib.Path(__file__).resolve().parents[2])
    victims_job = "victims"
    starver_job = "starver"
    try:
        pool_mgr.create_pool(store, substrate, pool,
                             settings_mod.global_settings({}), conf)
        probe = (f"{sys.executable} -m batch_shipyard_tpu_torch"
                 f".workloads.preempt_probe "
                 f"--steps {steps} --step-seconds {step_seconds} ")
        jobs = settings_mod.job_settings_list({"job_specifications": [{
            "id": victims_job,
            "priority": 0,
            "tasks": [
                {"id": "aa-costly",
                 "command": (probe +
                             f"--cache-identity drill-warm "
                             f"--ckpt {work}/costly.json"),
                 "environment_variables": {"PYTHONPATH": repo_root},
                 "max_task_retries": 3},
                {"id": "zz-cheap",
                 "command": (probe +
                             f"--checkpoint-every 1 "
                             f"--ckpt {work}/cheap.json"),
                 "environment_variables": {"PYTHONPATH": repo_root},
                 "max_task_retries": 3},
            ]}]})
        _submit_jobs(store, pool, jobs)
        # Gate the starver on mirrored hints: the election is only a
        # policy decision once both victims' costs are priceable from
        # their rows.
        pk = names.task_pk(POOL_ID, victims_job)
        deadline = time.monotonic() + wait_timeout / 2.0
        rows: dict = {}
        while time.monotonic() < deadline:
            rows = {r["_rk"]: r for r in store.query_entities(
                names.TABLE_TASKS, partition_key=pk)}
            costly = rows.get("aa-costly", {})
            cheap = rows.get("zz-cheap", {})
            ch = costly.get(names.TASK_COL_SCHED_HINTS)
            zh = cheap.get(names.TASK_COL_SCHED_HINTS)
            if (costly.get("state") == "running"
                    and cheap.get("state") == "running"
                    and isinstance(ch, dict)
                    and ch.get("cache_identity")
                    and isinstance(zh, dict)
                    and float(zh.get("ckpt_step", 0) or 0) >= 1):
                break
            time.sleep(0.2)
        else:
            raise AssertionError(
                f"sched hints never mirrored into victim rows: {rows}")
        cost_costly = sched_policy.victim_cost_from_row(
            rows["aa-costly"])
        cost_cheap = sched_policy.victim_cost_from_row(
            rows["zz-cheap"])
        report["invariants"]["victim_costs"] = {
            "aa-costly": cost_costly, "zz-cheap": cost_cheap}
        assert cost_costly > cost_cheap, (
            f"policy priced the warm never-committer cheaper: "
            f"{report['invariants']['victim_costs']}")
        _submit_jobs(store, pool, settings_mod.job_settings_list(
            {"job_specifications": [{
                "id": starver_job,
                "priority": 100,
                "tasks": [{"id": "hipri",
                           "command": (f"{sys.executable} -c "
                                       f"'import time; "
                                       f"time.sleep(0.5)'")}],
            }]}))
        jobs_mgr.wait_for_tasks(store, POOL_ID, starver_job,
                                timeout=wait_timeout,
                                poll_interval=0.25)
        victim_rows = jobs_mgr.wait_for_tasks(
            store, POOL_ID, victims_job, timeout=wait_timeout,
            poll_interval=0.25)
        _check_victim_selection_invariants(store, victim_rows, report)
    finally:
        substrate.stop_all()
    return report


def _check_victim_selection_invariants(store, victim_rows: list,
                                       report: dict) -> None:
    invariants = report["invariants"]
    rows = {r["_rk"]: r for r in victim_rows}
    for rk, row in rows.items():
        assert row.get("state") == "completed", row
        assert int(row.get("retries", 0)) == 0, (
            f"preemption consumed retry budget: {row}")
    invariants["retries"] = max(
        int(row.get("retries", 0)) for row in rows.values())
    cheap = rows["zz-cheap"]
    costly = rows["aa-costly"]
    invariants["cheap_preempt_count"] = int(
        cheap.get(names.TASK_COL_PREEMPT_COUNT, 0) or 0)
    invariants["costly_preempt_count"] = int(
        costly.get(names.TASK_COL_PREEMPT_COUNT, 0) or 0)
    invariants["costly_evict_count"] = int(
        costly.get(names.TASK_COL_EVICT_COUNT, 0) or 0)
    assert invariants["cheap_preempt_count"] >= 1, (
        f"the cheap victim was never elected: {invariants}")
    assert invariants["costly_preempt_count"] == 0, (
        f"the sweep touched the EXPENSIVE victim — goodput-cost "
        f"ordering did not drive the election: {invariants}")
    assert invariants["costly_evict_count"] == 0, invariants
    pool_report = _assert_partition_exact(store, POOL_ID, invariants)
    recovery = pool_report["badput_seconds"].get(
        "preemption_recovery", 0.0)
    invariants["preemption_recovery_seconds"] = recovery
    assert recovery > 0.0, pool_report["badput_seconds"]
    report["goodput"] = {
        "goodput_ratio": pool_report["goodput_ratio"],
        "badput_seconds": pool_report["badput_seconds"],
    }
    invariants["ok"] = True


def run_eviction_drill(seed: int = 0, steps: int = 140,
                       step_seconds: float = 0.05,
                       checkpoint_every: int = 8,
                       duration: float = 4.0,
                       wait_timeout: float = 120.0) -> dict:
    """Forcible-eviction drill: a seeded ``victim_ignore_notice``
    schedule stamps a cooperative preempt request on a running
    --ignore-notice probe — a victim that acknowledges the notice in
    its ledger and keeps squatting. The injector does NOT kill
    anything: the sweep's escalation (grace lapsed -> escalated_at
    stamped) and the owning agent's enforcement (docker rm -f +
    SIGKILL) are the code under test. Asserts the fleet-elasticity
    acceptance invariants:

      * the hard kill fired and the exit was classified ``evicted``
        (claimable, full retry budget — retries == 0) and never
        ``wedged``/failed,
      * the rerun resumed from the last COMMITTED barrier strictly
        BEFORE the notice (the drain never happened) and completed
        with no committed work lost,
      * node health untouched (externally-caused exits are neutral),
      * the goodput partition stayed exact AND the ``eviction`` leg
        is actually populated (TASK_EVICTED marker + recovery
        interval)."""
    from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

    store = MemoryStateStore()
    substrate = FakePodSubstrate(store, heartbeat_interval=0.2,
                                 node_stale_seconds=5.0)
    substrate.agent_kwargs = {
        "claim_visibility_seconds": 5.0, "gang_sweep_interval": 1.0,
        # Tight escalation clock: sweep every 0.4s, 0.8s of grace
        # past the notice, and a short preempt-cache TTL so the
        # enforcement heartbeat sees the escalation promptly.
        "preempt_sweep_interval": 0.4,
        "preempt_grace_seconds": 0.8,
        "job_state_ttl": 0.2}
    conf = _pool_conf(1, 1)
    pool = settings_mod.pool_settings(conf)
    plan = ChaosPlan.generate(seed, duration=duration, num_nodes=1,
                              kinds=("victim_ignore_notice",))
    # Deterministic sequencing (the preemption drill's notice-widening
    # trick): the stamp must land after the probe's first cadenced
    # commit, so the "resume strictly pre-notice" assertion is never
    # vacuous. Still a pure function of the seed.
    plan = dataclasses.replace(plan, injections=tuple(
        dataclasses.replace(inj, at=max(inj.at, 1.2))
        for inj in plan.injections))
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    ckpt = os.path.join(substrate.work_root, "probe", "state.json")
    repo_root = str(pathlib.Path(__file__).resolve().parents[2])
    try:
        pool_mgr.create_pool(store, substrate, pool,
                             settings_mod.global_settings({}), conf)
        jobs = settings_mod.job_settings_list({"job_specifications": [{
            "id": JOB_ID,
            "tasks": [{"id": "t0",
                       "command": (
                           f"{sys.executable} -m batch_shipyard_tpu_torch"
                           f".workloads.preempt_probe "
                           f"--steps {steps} "
                           f"--step-seconds {step_seconds} "
                           f"--checkpoint-every {checkpoint_every} "
                           f"--ignore-notice --ckpt {ckpt}"),
                       "environment_variables": {
                           "PYTHONPATH": repo_root},
                       "max_task_retries": 2}],
        }]})
        started = time.monotonic()
        _submit_jobs(store, pool, jobs)
        driver = threading.Thread(
            target=_inject_schedule,
            args=(plan, started, substrate, None, report),
            daemon=True, name="chaos-evict-driver")
        driver.start()
        task_rows = jobs_mgr.wait_for_tasks(
            store, POOL_ID, JOB_ID, timeout=wait_timeout,
            poll_interval=0.25)
        driver.join(timeout=5.0)
        _check_eviction_invariants(store, task_rows, ckpt, steps,
                                   checkpoint_every, report)
    finally:
        substrate.stop_all()
    return report


def _check_eviction_invariants(store, task_rows: list, ckpt: str,
                               steps: int, checkpoint_every: int,
                               report: dict) -> None:
    invariants = report["invariants"]
    task = task_rows[0]
    invariants["state"] = task.get("state")
    assert task.get("state") == "completed", task
    # Classified evicted, never wedged/failed: the retry budget is
    # untouched and the eviction counter advanced.
    invariants["retries"] = int(task.get("retries", 0))
    invariants["evict_count"] = int(
        task.get(names.TASK_COL_EVICT_COUNT, 0) or 0)
    assert invariants["retries"] == 0, (
        f"eviction consumed retry budget: {task}")
    assert invariants["evict_count"] >= 1, (
        f"drill never evicted the victim: {report['applied']}")
    assert not task.get(names.TASK_COL_PREEMPT_COUNT), (
        f"uncooperative victim cannot have drained: {task}")
    # Resume strictly from the PRE-NOTICE barrier: the ledger's
    # notice-ignored line pins when the victim saw (and burned) its
    # notice; the completed rerun must start at a cadenced COMMITTED
    # step at or before it, and cover through the end — no committed
    # work lost.
    with open(ckpt + ".steps.log", encoding="utf-8") as fh:
        ledger = [line.split() for line in fh if line.strip()]
    invariants["step_ledger"] = [" ".join(parts) for parts in ledger]
    assert ledger and ledger[0][2] == "notice-ignored", (
        invariants["step_ledger"])
    assert ledger[-1][2] == "completed", invariants["step_ledger"]
    notice_step = int(ledger[0][1].split("..")[1])
    resume_lo, resume_hi = (int(x) for x in
                            ledger[-1][1].split(".."))
    invariants["notice_step"] = notice_step
    invariants["resumed_from"] = resume_lo
    assert resume_hi == steps, invariants["step_ledger"]
    assert resume_lo > 0, (
        "rerun restarted from scratch — the pre-notice barrier was "
        f"lost: {invariants['step_ledger']}")
    assert resume_lo % checkpoint_every == 0, (
        f"resume point {resume_lo} is not a cadenced barrier")
    assert resume_lo <= notice_step, (
        f"resume point {resume_lo} is past the notice at "
        f"{notice_step} — an uncooperative victim cannot have "
        f"committed after its notice")
    # Node health untouched: eviction is externally caused.
    for node in store.query_entities(names.TABLE_NODES,
                                     partition_key=POOL_ID):
        health = float(node.get(names.NODE_COL_HEALTH, 1.0) or 1.0)
        assert health >= 1.0, (
            f"eviction debited node health: {node['_rk']}={health}")
        assert not node.get(names.NODE_COL_QUARANTINED), node
    invariants["node_health_untouched"] = True
    # Goodput: partition exact AND the eviction leg populated.
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    kinds = [e["kind"] for e in gp_events.query(store, POOL_ID)]
    invariants["evicted_events"] = kinds.count(
        gp_events.TASK_EVICTED)
    assert invariants["evicted_events"] >= 1, kinds
    pool_report = _assert_partition_exact(store, POOL_ID, invariants)
    eviction = pool_report["badput_seconds"].get("eviction", 0.0)
    invariants["eviction_seconds"] = eviction
    assert eviction > 0.0, (
        f"eviction leg not populated: "
        f"{pool_report['badput_seconds']}")
    report["goodput"] = {
        "goodput_ratio": pool_report["goodput_ratio"],
        "badput_seconds": pool_report["badput_seconds"],
    }
    invariants["ok"] = True


def run_host_resize_drill(seed: int = 0, steps: int = 100,
                          step_seconds: float = 0.06, dim: int = 24,
                          checkpoint_every: int = 5,
                          duration: float = 4.0,
                          wait_timeout: float = 120.0) -> dict:
    """Multi-host reshard-on-restore drill: a 2-host (multi-process
    fakepod) gang runs the SHARDED reshard probe — each instance owns
    half the state vector and the commit protocol writes per-host
    shard files + a .LAYOUT sidecar (the .MESH analog). A seeded
    ``host_loss_resize`` injection permanently crashes one host; the
    elastic recovery re-forms the gang at 1 host, whose restore must
    follow the per-host plan (parallel/restore_plan.py): read BOTH
    source shards, exactly the slices its new range needs. Asserts:

      * the gang completed at size 1 with a GANG_RESIZE event,
      * params/opt-state BIT-EXACT vs a pure replay oracle (resume
        from the committed barrier loses nothing, reshard included),
      * the rerun's recorded reads == the restore plan (each host
        read only what it needed, from the shards that had it),
      * the loss trajectory at every commit matches the oracle,
      * goodput partition exact, no orphaned gang rows."""
    from batch_shipyard_tpu_torch.parallel import restore_plan
    from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

    store = MemoryStateStore()
    substrate = FakePodSubstrate(store, heartbeat_interval=0.2,
                                 node_stale_seconds=2.0)
    substrate.agent_kwargs = {
        "claim_visibility_seconds": 3.0, "gang_sweep_interval": 1.0,
        "gang_timeout": 10.0, "retry_backoff_base": 0.2,
        "retry_backoff_cap": 1.0}
    conf = _pool_conf(2, 1)
    pool = settings_mod.pool_settings(conf)
    plan = ChaosPlan.generate(seed, duration=duration, num_nodes=2,
                              kinds=("host_loss_resize",))
    # The crash must land after formation + the first sharded commit
    # (else the reads-match-plan assertion is vacuous — a fresh start
    # reads nothing). Pure function of the seed, still.
    plan = dataclasses.replace(plan, injections=tuple(
        dataclasses.replace(inj, at=max(inj.at, 2.0))
        for inj in plan.injections))
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    ckpt = os.path.join(substrate.work_root, "probe", "state.json")
    repo_root = str(pathlib.Path(__file__).resolve().parents[2])
    try:
        pool_mgr.create_pool(store, substrate, pool,
                             settings_mod.global_settings({}), conf)
        jobs = settings_mod.job_settings_list({"job_specifications": [{
            "id": JOB_ID,
            "tasks": [{"id": GANG_TASK_ID,
                       "command": (
                           f"{sys.executable} -m batch_shipyard_tpu_torch"
                           f".workloads.reshard_probe "
                           f"--steps {steps} "
                           f"--step-seconds {step_seconds} "
                           f"--dim {dim} "
                           f"--checkpoint-every {checkpoint_every} "
                           f"--ckpt {ckpt}"),
                       "environment_variables": {
                           "PYTHONPATH": repo_root},
                       "max_task_retries": 3,
                       "multi_instance": {
                           "num_instances": 2, "min_instances": 1,
                           "jax_distributed": {"enabled": False}}}],
        }]})
        started = time.monotonic()
        _submit_jobs(store, pool, jobs)
        driver = threading.Thread(
            target=_inject_schedule,
            args=(plan, started, substrate, None, report),
            daemon=True, name="chaos-resize-driver")
        driver.start()
        task_rows = jobs_mgr.wait_for_tasks(
            store, POOL_ID, JOB_ID, timeout=wait_timeout,
            poll_interval=0.25)
        driver.join(timeout=5.0)
        _check_resize_invariants(store, task_rows, ckpt, steps, dim,
                                 restore_plan, report)
    finally:
        substrate.stop_all()
    return report


def _resize_oracle(dim: int, steps: int) -> list[float]:
    """Pure replay of the probe's deterministic per-element update —
    state[i] after S steps is sum_{s=1..S} s*(i+1), accumulated the
    same way the probe accumulates it (bit-exactness is the claim)."""
    state = [0.0] * dim
    for step in range(steps):
        for i in range(dim):
            state[i] += float((step + 1) * (i + 1))
    return state


def _check_resize_invariants(store, task_rows: list, ckpt: str,
                             steps: int, dim: int, restore_plan,
                             report: dict) -> None:
    import json as json_mod

    invariants = report["invariants"]
    task = task_rows[0]
    invariants["state"] = task.get("state")
    assert task.get("state") == "completed", task
    invariants["gang_size"] = task.get(names.TASK_COL_GANG_SIZE)
    assert invariants["gang_size"] == 1, (
        f"gang did not resize to the surviving host: {task}")
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    resizes = [e for e in gp_events.query(store, POOL_ID)
               if e["kind"] == gp_events.GANG_RESIZE]
    assert resizes and \
        resizes[-1]["attrs"].get("new_size") == 1, resizes
    invariants["gang_resize_events"] = len(resizes)
    # Bit-exact params/opt-state: the committed final state (1 shard
    # covering the full vector) equals the pure replay oracle.
    with open(f"{ckpt}.s{steps}.shard0of1", encoding="utf-8") as fh:
        final = json_mod.load(fh)
    assert final["step"] == steps, final
    expected = _resize_oracle(dim, steps)
    assert final["values"] == expected, (
        "restored+resumed state is not bit-exact vs the oracle")
    invariants["state_bit_exact"] = True
    # The rerun read EXACTLY its per-host plan: 1 target host of a
    # 2-shard source — both shards, full slices, in order.
    with open(ckpt + ".reads.log", encoding="utf-8") as fh:
        read_lines = [ln.strip() for ln in fh if "i0of1" in ln]
    planned = restore_plan.host_reads(dim, 2, 1, 0)
    expected_reads = [
        f"shard={r.shard}of2 [{r.lo}..{r.hi})" for r in planned]
    got_reads = [" ".join(ln.split()[2:]) for ln in read_lines]
    invariants["planned_reads"] = expected_reads
    invariants["recorded_reads"] = got_reads
    assert got_reads[-len(expected_reads):] == expected_reads, (
        f"per-host reads diverge from the restore plan: "
        f"{got_reads} vs {expected_reads}")
    # Loss-trajectory oracle: every recorded commit loss matches the
    # pure replay at that (step, size) — instance 0's shard is the
    # first dim/size elements.
    with open(ckpt + ".loss.log", encoding="utf-8") as fh:
        losses = [ln.split() for ln in fh if ln.strip()]
    assert losses, "no loss trajectory recorded"
    for entry in losses:
        rec = dict(part.split("=", 1) for part in entry)
        step, size = int(rec["step"]), int(rec["size"])
        shard = _resize_oracle(dim, step)[: dim // size]
        assert abs(float(rec["loss"]) - sum(shard)) < 1e-6, (
            f"loss trajectory diverged at {rec}")
    invariants["loss_trajectory_ok"] = True
    # No orphaned coordination state; partition exact.
    _await_no_gang_rows(store, invariants)
    pool_report = _assert_partition_exact(store, POOL_ID, invariants)
    report["goodput"] = {
        "goodput_ratio": pool_report["goodput_ratio"],
        "badput_seconds": pool_report["badput_seconds"],
    }
    invariants["ok"] = True


def _wait_for(probe, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = probe()
        if value:
            return value
        time.sleep(0.1)
    raise AssertionError(f"timed out waiting for {what}")


def run_store_outage_drill(seed: int = 0, tasks: int = 6,
                           outage: float = 2.0,
                           task_sleep: float = 1.0,
                           duration: float = 6.0,
                           wait_timeout: float = 120.0) -> dict:
    """Store-outage ride-through drill: agents run on the resilient
    wrapper (state/resilient.py) over a chaos store, and a seeded
    ``store_outage`` injection takes the store DOWN for a sustained
    window mid-run — every op fails, not a per-op burst. Asserts the
    control-plane acceptance invariants:

      * every task completed with ZERO retries — the outage never
        killed or requeued running work (critical ops rode it out),
      * zero lost advisory events: exactly one TASK_QUEUED and one
        TASK_RUNNING interval per task survive into the store (the
        WAL journaled what the outage would have dropped and
        replayed it in order),
      * the ``store_outage`` badput leg is populated with the exact
        outage window and the journal actually replayed entries,
      * every agent's journal drained to zero after recovery,
      * the goodput partition stayed exact ACROSS the outage."""
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

    raw_store = MemoryStateStore()
    chaos_store = injectors_mod.ChaosStore(raw_store)
    substrate = FakePodSubstrate(chaos_store,
                                 heartbeat_interval=0.2,
                                 node_stale_seconds=30.0)
    substrate.agent_kwargs = {
        "claim_visibility_seconds": 5.0,
        "gang_sweep_interval": 1.0,
        # THE knob under test: the resilient wrapper, tuned for a
        # seconds-scale drill (production keeps the defaults).
        "resilience": {"retry_base": 0.05, "retry_cap": 0.5,
                       "probe_interval": 0.25,
                       "max_outage_seconds": 60.0}}
    conf = _pool_conf(2, 2)
    pool = settings_mod.pool_settings(conf)
    plan = ChaosPlan.generate(seed, duration=duration, num_nodes=2,
                              kinds=("store_outage",))
    # Deterministic sequencing: the outage must land with work in
    # flight (claims made, tasks running) and last the configured
    # window. Pure function of the seed, still.
    plan = dataclasses.replace(plan, injections=tuple(
        dataclasses.replace(
            inj, at=min(max(inj.at, 1.2), 2.0),
            params=tuple(sorted(
                {**dict(inj.params), "window": outage}.items())))
        for inj in plan.injections))
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    try:
        pool_mgr.create_pool(raw_store, substrate, pool,
                             settings_mod.global_settings({}), conf)
        jobs = settings_mod.job_settings_list({"job_specifications": [{
            "id": JOB_ID,
            "tasks": [{"id": f"t{i:03d}",
                       "command": (f"sleep {task_sleep} && "
                                   f"echo outage-{i}"),
                       "max_task_retries": 3}
                      for i in range(tasks)],
        }]})
        started = time.monotonic()
        _submit_jobs(raw_store, pool, jobs)
        driver = threading.Thread(
            target=_inject_schedule,
            args=(plan, started, substrate, chaos_store, report),
            daemon=True, name="chaos-outage-driver")
        driver.start()
        task_rows = jobs_mgr.wait_for_tasks(
            raw_store, POOL_ID, JOB_ID, timeout=wait_timeout,
            poll_interval=0.25)
        driver.join(timeout=5.0)
        invariants = report["invariants"]
        states = {}
        total_retries = 0
        for task in task_rows:
            states[task.get("state")] = \
                states.get(task.get("state"), 0) + 1
            total_retries += int(task.get("retries", 0) or 0)
        invariants["tasks"] = states
        assert states == {"completed": tasks}, states
        invariants["retries"] = total_retries
        assert total_retries == 0, (
            f"the outage cost retries: {total_retries}")
        # Zero lost advisory events: with zero retries there is
        # EXACTLY one queued + one running interval per task — any
        # event the outage swallowed breaks the count.
        events = gp_events.query(raw_store, POOL_ID)
        queued = [e for e in events
                  if e["kind"] == gp_events.TASK_QUEUED]
        running = [e for e in events
                   if e["kind"] == gp_events.TASK_RUNNING]
        invariants["queued_events"] = len(queued)
        invariants["running_events"] = len(running)
        assert len(queued) == tasks, (
            f"lost queued intervals: {len(queued)} != {tasks}")
        assert len(running) == tasks, (
            f"lost running intervals: {len(running)} != {tasks}")
        outages = [e for e in events
                   if e["kind"] == gp_events.STORE_OUTAGE]
        invariants["outage_events"] = len(outages)
        assert outages, "no store_outage interval was recorded"
        replayed = sum(int((e.get("attrs") or {})
                           .get("replayed", 0)) for e in outages)
        invariants["journal_replayed"] = replayed
        assert replayed >= 1, (
            "the WAL never buffered anything — the outage was "
            "vacuous")
        # Journals drained on every agent.
        deadline = time.monotonic() + 15.0
        backlog = None
        while time.monotonic() < deadline:
            backlog = sum(
                agent.store.journal_backlog()
                for agent in injectors_mod._live_agents(substrate,
                                                        POOL_ID))
            if backlog == 0:
                break
            time.sleep(0.2)
        invariants["journal_backlog"] = backlog
        assert backlog == 0, f"undrained WAL backlog: {backlog}"
        pool_report = _assert_partition_exact(raw_store, POOL_ID,
                                              invariants)
        leg = pool_report["badput_seconds"].get("store_outage", 0.0)
        invariants["store_outage_seconds"] = leg
        assert leg > 0.0, (
            f"store_outage leg not populated: "
            f"{pool_report['badput_seconds']}")
        report["goodput"] = {
            "goodput_ratio": pool_report["goodput_ratio"],
            "badput_seconds": pool_report["badput_seconds"],
        }
        invariants["ok"] = True
    finally:
        substrate.stop_all()
    return report


def run_leader_partition_drill(seed: int = 0,
                               victim_steps: int = 140,
                               step_seconds: float = 0.05,
                               wait_timeout: float = 120.0) -> dict:
    """Leader-partition drill: the preempt-sweep LEADER's heartbeats
    and lease renewals stall (its sweep loop keeps running — the
    exact shape the old heartbeat-freshness election double-fired
    under) while a starved high-priority task is waiting. Asserts
    the lease acceptance invariants:

      * exactly ONE preemption stamp fired across the leadership
        change (zero double-fired stamps: the deposed leader
        abdicated on its own clock before the successor could act),
      * the stamp carries the SUCCESSOR's fencing epoch — strictly
        newer than the pre-partition term — and that epoch is the
        one live term at drill end (exactly one local lease holder),
      * the victim drained cooperatively with its retry budget
        untouched; every task completed; partition exact."""
    from batch_shipyard_tpu_torch.state import leases as state_leases
    from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate

    store = MemoryStateStore()
    substrate = FakePodSubstrate(store, heartbeat_interval=0.2,
                                 node_stale_seconds=5.0)
    substrate.agent_kwargs = {
        "claim_visibility_seconds": 5.0,
        "gang_sweep_interval": 1.0,
        # Sweep fast, short lease: failover must fit the drill
        # window. Grace doubles as the starvation threshold, so it
        # must EXCEED the partitioned leader's residual authority
        # (one lease duration) — the stamp then provably belongs to
        # the successor's term.
        "preempt_sweep_interval": 0.8,
        "preempt_grace_seconds": 2.0,
        "leader_lease_seconds": 1.0,
        "job_state_ttl": 0.2}
    conf = _pool_conf(2, 1)
    pool = settings_mod.pool_settings(conf)
    plan = ChaosPlan.generate(seed, duration=6.0, num_nodes=2,
                              kinds=("leader_partition",))
    plan = dataclasses.replace(plan, injections=tuple(
        dataclasses.replace(inj, params=tuple(sorted(
            {**dict(inj.params), "window": 4.0}.items())))
        for inj in plan.injections))
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    epoch_key = names.leader_epoch_key(
        POOL_ID, state_leases.ROLE_PREEMPT_SWEEP)
    ckpt = os.path.join(substrate.work_root, "probe", "state.json")
    repo_root = str(pathlib.Path(__file__).resolve().parents[2])
    try:
        pool_mgr.create_pool(store, substrate, pool,
                             settings_mod.global_settings({}), conf)
        victims = settings_mod.job_settings_list(
            {"job_specifications": [{
                "id": "victims",
                # Long enough that the stamp — landing AFTER the
                # grace window + the leadership failover — always
                # finds its victim still running with drain runway:
                # a victim finishing naturally before the drain
                # races would make the preemption vacuous.
                # priority -1: victims live in the LO queue band, so
                # the starved task's normal-band message — which the
                # worker scan never idle-skips — deterministically
                # wins the freed slot ahead of the drained victim's
                # own requeue. (With both in the same band, the
                # rerun can win the race and the sweep legitimately
                # re-stamps each interval — correct behavior, but it
                # would make the exactly-one-stamp assertion about
                # claim-race luck instead of leadership.)
                "tasks": [{"id": f"v{i}",
                           "command": (
                               f"{sys.executable} -m "
                               f"batch_shipyard_tpu_torch.workloads"
                               f".preempt_probe "
                               f"--steps {victim_steps} "
                               f"--step-seconds {step_seconds} "
                               f"--checkpoint-every 10 "
                               f"--ckpt {ckpt}.v{i}"),
                           "environment_variables": {
                               "PYTHONPATH": repo_root},
                           "priority": -1,
                           "max_task_retries": 3}
                          for i in range(2)],
            }]})
        _submit_jobs(store, pool, victims)
        # Both victims running + a preempt-sweep term recorded: only
        # then is "partition the leader" well-defined.
        _wait_for(
            lambda: (sum(1 for t in jobs_mgr.list_tasks(
                store, POOL_ID, "victims")
                if t.get("state") == "running") == 2) or None,
            30.0, "both victims running")
        before = _wait_for(
            lambda: state_leases.read_leader(store, epoch_key),
            30.0, "preempt-sweep leadership term")
        report["leader_before"] = before
        hi = settings_mod.job_settings_list({"job_specifications": [{
            "id": "hi",
            "tasks": [{"id": "h0", "command": "echo placed",
                       "priority": 0, "max_task_retries": 2}],
        }]})
        _submit_jobs(store, pool, hi)
        # Partition the leader NOW — before the starvation grace can
        # elapse — so the stamp decision crosses the failover.
        for injection in plan.injections:
            try:
                record = injectors_mod.apply_injection(
                    injection, substrate, POOL_ID)
            except Exception as exc:  # noqa: BLE001 - record it
                record = {"kind": injection.kind, "error": str(exc)}
            logger.info("chaos injection %s", record)
            report["applied"].append(record)
        hi_rows = jobs_mgr.wait_for_tasks(
            store, POOL_ID, "hi", timeout=wait_timeout,
            poll_interval=0.25)
        victim_rows = jobs_mgr.wait_for_tasks(
            store, POOL_ID, "victims", timeout=wait_timeout,
            poll_interval=0.25)
        _check_partition_invariants(
            store, substrate, state_leases, epoch_key, before,
            hi_rows, victim_rows, report)
    finally:
        substrate.stop_all()
    return report


def _check_partition_invariants(store, substrate, state_leases,
                                epoch_key: str, before: dict,
                                hi_rows: list, victim_rows: list,
                                report: dict) -> None:
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    invariants = report["invariants"]
    assert hi_rows[0].get("state") == "completed", hi_rows[0]
    states = {t["_rk"]: t.get("state") for t in victim_rows}
    invariants["victim_states"] = states
    assert all(s == "completed" for s in states.values()), states
    # ZERO double-fired stamps: exactly one preemption notice across
    # the whole drill, leadership change included.
    notices = [e for e in gp_events.query(store, POOL_ID)
               if e["kind"] == gp_events.TASK_PREEMPT_NOTICE]
    invariants["preempt_notices"] = len(notices)
    fired = [(n.get("job_id"), n.get("task_id"), n.get("attrs"))
             for n in notices]
    assert len(notices) == 1, (
        f"double-fired preemption stamps under partition: {fired}")
    # The stamp belongs to the SUCCESSOR's term: its fencing epoch
    # is strictly newer than the pre-partition term and matches the
    # term live at drill end.
    after = state_leases.read_leader(store, epoch_key)
    report["leader_after"] = after
    invariants["epoch_before"] = before["epoch"]
    invariants["epoch_after"] = after["epoch"]
    assert after["epoch"] > before["epoch"], (
        f"no leadership term change: {before} -> {after}")
    assert after.get("owner") != before.get("owner"), (
        f"the partitioned leader kept the lease: {after}")
    stamp_epoch = (notices[0].get("attrs") or {}).get("leader_epoch")
    invariants["stamp_epoch"] = stamp_epoch
    assert stamp_epoch == after["epoch"], (
        f"stamp epoch {stamp_epoch} is not the successor term "
        f"{after['epoch']} — a deposed leader fired it")
    # Exactly one LIVE lease holder at drill end.
    holders = [
        agent.identity.node_id
        for agent in injectors_mod._live_agents(substrate, POOL_ID)
        if (lease := agent._sweep_leases.get(
            state_leases.ROLE_PREEMPT_SWEEP)) is not None
        and lease.held_locally()]
    invariants["lease_holders"] = holders
    assert len(holders) == 1, (
        f"not exactly one live lease epoch: holders={holders}")
    # The preempted victim paid NO retry budget; the other victim
    # was never touched.
    preempted = [t for t in victim_rows
                 if int(t.get(names.TASK_COL_PREEMPT_COUNT, 0)
                        or 0) > 0]
    invariants["victims_preempted"] = len(preempted)
    assert len(preempted) == 1, (
        f"expected exactly one preempted victim: {states}")
    assert int(preempted[0].get("retries", 0) or 0) == 0, (
        f"preemption consumed retry budget: {preempted[0]}")
    pool_report = _assert_partition_exact(store, POOL_ID, invariants)
    report["goodput"] = {
        "goodput_ratio": pool_report["goodput_ratio"],
        "badput_seconds": pool_report["badput_seconds"],
    }
    invariants["ok"] = True


def run_agent_restart_drill(seed: int = 0, task_sleep: float = 2.5,
                            wait_timeout: float = 120.0) -> dict:
    """Agent crash-restart adoption drill: a seeded ``agent_restart``
    injection kills the agent PROCESS under a running task — no
    offline write, no lease release, every in-flight completion path
    abandoned — while the task's own session keeps running; the
    revived agent on the same work_dir must re-adopt it from the
    slot ledger. Asserts the adoption acceptance invariants:

      * the task ran EXACTLY once (its start marker appears once —
        adoption, not the reclaim-rerun path) and completed with
        retries == 0,
      * the adopted completion ran the full exit path (stdout
        uploaded),
      * the ``adoption`` badput leg is populated (the control-plane
        gap: last pre-crash heartbeat -> re-adoption) and a
        SPAN_AGENT_RESTART span joined the task's trace,
      * node health neutral (an agent crash says nothing about the
        task), queues drained, partition exact."""
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
    from batch_shipyard_tpu_torch.substrate.fakepod import FakePodSubstrate
    from batch_shipyard_tpu_torch.trace import spans as trace_spans

    store = MemoryStateStore()
    substrate = FakePodSubstrate(store, heartbeat_interval=0.2,
                                 node_stale_seconds=5.0)
    substrate.agent_kwargs = {"claim_visibility_seconds": 3.0,
                              "gang_sweep_interval": 1.0}
    conf = _pool_conf(1, 1)
    pool = settings_mod.pool_settings(conf)
    plan = ChaosPlan.generate(seed, duration=4.0, num_nodes=1,
                              kinds=("agent_restart",))
    # The crash must land while the task RUNS (claimed within
    # ~0.3s; finishes at ~task_sleep) and the revival must leave
    # adoption runway. Pure function of the seed, still.
    plan = dataclasses.replace(plan, injections=tuple(
        dataclasses.replace(
            inj, at=min(max(inj.at, 0.8), task_sleep - 1.0),
            params=tuple(sorted(
                {**dict(inj.params),
                 "revive_after": max(0.4, inj.param(
                     "revive_after", 0.5))}.items())))
        for inj in plan.injections))
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    probe_dir = os.path.join(substrate.work_root, "probe")
    starts_log = os.path.join(probe_dir, "starts.log")
    try:
        os.makedirs(probe_dir, exist_ok=True)
        pool_mgr.create_pool(store, substrate, pool,
                             settings_mod.global_settings({}), conf)
        jobs = settings_mod.job_settings_list({"job_specifications": [{
            "id": JOB_ID,
            "tasks": [{"id": "t0",
                       "command": (f"echo start-$$ >> {starts_log} "
                                   f"&& sleep {task_sleep} && "
                                   f"echo adopted-done"),
                       "max_task_retries": 2}],
        }]})
        started = time.monotonic()
        _submit_jobs(store, pool, jobs)
        driver = threading.Thread(
            target=_inject_schedule,
            args=(plan, started, substrate, None, report),
            daemon=True, name="chaos-restart-driver")
        driver.start()
        task_rows = jobs_mgr.wait_for_tasks(
            store, POOL_ID, JOB_ID, timeout=wait_timeout,
            poll_interval=0.25)
        driver.join(timeout=5.0)
        invariants = report["invariants"]
        task = task_rows[0]
        invariants["state"] = task.get("state")
        assert task.get("state") == "completed", task
        invariants["retries"] = int(task.get("retries", 0) or 0)
        assert invariants["retries"] == 0, (
            f"the restart cost retries (reclaim-rerun, not "
            f"adoption): {task}")
        assert any(r.get("applied") for r in report["applied"]), (
            f"agent_restart never applied: {report['applied']}")
        # Exactly ONE start: the process ran THROUGH the restart.
        with open(starts_log, encoding="utf-8") as fh:
            starts = [ln for ln in fh.read().splitlines() if ln]
        invariants["task_starts"] = len(starts)
        assert len(starts) == 1, (
            f"task re-ran instead of being adopted: {starts}")
        # The adopted completion ran the full exit path.
        out = jobs_mgr.get_task_output(store, POOL_ID, JOB_ID, "t0")
        assert out.strip() == b"adopted-done", out
        # Adoption leg + trace span.
        adoptions = [e for e in gp_events.query(store, POOL_ID)
                     if e["kind"] == gp_events.TASK_ADOPTION]
        invariants["adoption_events"] = len(adoptions)
        assert adoptions, "no adoption interval was recorded"
        assert all(float(e["end"]) > float(e["start"])
                   for e in adoptions), adoptions
        restart_spans = [
            s for s in trace_spans.query(store, POOL_ID)
            if s.get("kind") == trace_spans.SPAN_AGENT_RESTART]
        invariants["agent_restart_spans"] = len(restart_spans)
        assert restart_spans, "no SPAN_AGENT_RESTART recorded"
        # Neutral health: an agent crash says nothing about the node
        # or the task.
        for node in store.query_entities(names.TABLE_NODES,
                                         partition_key=POOL_ID):
            health = float(node.get(names.NODE_COL_HEALTH, 1.0)
                           or 1.0)
            assert health >= 1.0, (
                f"adoption debited node health: "
                f"{node['_rk']}={health}")
            assert not node.get(names.NODE_COL_QUARANTINED), node
        invariants["node_health_untouched"] = True
        # Queues drain once the redelivered message meets the
        # terminal entity.
        deadline = time.monotonic() + 30.0
        queues = names.task_queues(POOL_ID, 1)
        depth = None
        while time.monotonic() < deadline:
            depth = sum(store.queue_length(q) for q in queues)
            if depth == 0:
                break
            time.sleep(0.25)
        invariants["queue_depth"] = depth
        assert depth == 0, f"undrained task queues: {depth}"
        pool_report = _assert_partition_exact(store, POOL_ID,
                                              invariants)
        leg = pool_report["badput_seconds"].get("adoption", 0.0)
        invariants["adoption_seconds"] = leg
        assert leg > 0.0, (
            f"adoption leg not populated: "
            f"{pool_report['badput_seconds']}")
        report["goodput"] = {
            "goodput_ratio": pool_report["goodput_ratio"],
            "badput_seconds": pool_report["badput_seconds"],
        }
        invariants["ok"] = True
    finally:
        substrate.stop_all()
    return report


def _inject_schedule(plan: ChaosPlan, started: float, substrate,
                     chaos_store, report: dict) -> None:
    for injection in plan.injections:
        delay = injection.at - (time.monotonic() - started)
        if delay > 0:
            time.sleep(delay)
        try:
            record = injectors_mod.apply_injection(
                injection, substrate, POOL_ID, store=chaos_store)
        except Exception as exc:  # noqa: BLE001 - record, keep going
            record = {"kind": injection.kind, "error": str(exc)}
        logger.info("chaos injection %s", record)
        report["applied"].append(record)


def _check_invariants(store, task_rows: list, expected: int,
                      report: dict) -> None:
    invariants = report["invariants"]
    # 1. Every task completed (exactly the expected set, each once —
    # entities are unique by id, so completion is single-valued).
    states: dict = {}
    for task in task_rows:
        states[task.get("state")] = states.get(task.get("state"), 0) + 1
    invariants["tasks"] = states
    assert states == {"completed": expected + 1}, (
        f"drill tasks not all completed: {states}")
    # 2. Exactly-once effects: the final output of each task is its
    # single line (a double-completed task would have been re-run
    # after success and is a claim-protocol bug). Gang instance 0's
    # final output holds its single line (a recovered attempt
    # overwrites the same key, so this checks the LAST attempt ran
    # cleanly). A blob an injected store error kept from the store is
    # the one loss the agent allows itself (it records output_error,
    # best effort, and finishes the task rather than run it twice):
    # such a task passes only as _check_lost_output says, and no more
    # of them than the store errors the drill injected.
    lost = []
    successes = _successful_runs(store)
    faulted = {target for op, target in report.get("injected_errors", ())
               if op == "put_object_stream"}
    for task in task_rows:
        task_id = task["_rk"]
        gang = task_id == GANG_TASK_ID
        want = (b"drill-gang" if gang
                else f"drill-{int(task_id[1:])}".encode())
        try:
            out = jobs_mgr.get_task_output(
                store, POOL_ID, JOB_ID, task_id,
                instance=0 if gang else None)
        except NotFoundError as exc:
            _check_lost_output(task, None if gang
                               else successes.get(task_id, 0),
                               upload_faulted=exc.args[0] in faulted)
            lost.append(task_id)
            continue
        assert out.strip() == want, (
            f"{task_id}: unexpected output {out!r}")
    injected = _injected_store_errors(report)
    invariants["lost_outputs"] = lost
    invariants["injected_store_errors"] = injected
    assert len(lost) <= injected, (
        f"{len(lost)} outputs lost to {injected} injected store "
        f"errors: {lost}")
    # 3. No orphaned coordination state: gang rows are gone and the
    # task queues drain, each within a bounded window (terminal-task
    # messages get deleted on next delivery; a gang cleanup lost to
    # an injected store fault is repaired by the agents' orphan
    # janitor sweep). The workload's gang task guarantees gang rows
    # EXISTED during the drill, so an empty table here proves
    # cleanup, not absence of gangs.
    deadline = time.monotonic() + 30.0
    queues = names.task_queues(POOL_ID, 1)
    while True:
        leftover_gangs = list(store.query_entities(names.TABLE_GANGS))
        depth = sum(store.queue_length(q) for q in queues)
        if (not leftover_gangs and depth == 0) or \
                time.monotonic() >= deadline:
            break
        time.sleep(0.25)
    invariants["orphaned_gang_rows"] = len(leftover_gangs)
    assert not leftover_gangs, leftover_gangs
    invariants["queue_depth"] = depth
    assert depth == 0, f"undrained task queues: {depth} messages"
    # 4. Goodput partition exactness: chaos moves time between
    # categories; it must never create or lose a second.
    pool_report = _assert_partition_exact(store, POOL_ID, invariants)
    invariants["retries"] = pool_report.get("retries", 0)
    invariants["backoff_seconds"] = (
        pool_report["badput_seconds"].get("backoff", 0.0))
    report["goodput"] = {
        "goodput_ratio": pool_report["goodput_ratio"],
        "badput_seconds": pool_report["badput_seconds"],
        "overlapped_seconds": pool_report["overlapped_seconds"],
    }
    invariants["ok"] = True


def _injected_store_errors(report: dict) -> int:
    """The store-op errors the drill injected: the ``ops`` of every
    applied store_error injection (records follow the plan's order)."""
    return sum(int(injection["params"].get("ops", 3))
               for injection, record in zip(report["plan"]["injections"],
                                            report["applied"])
               if record.get("kind") == "store_error"
               and record.get("applied"))


def _successful_runs(store) -> dict:
    """Task id -> the drill job's running intervals that exited 0 (the
    agent's TASK_RUNNING goodput rows; best-effort writes, so a count
    can fall short under store faults but never overstate)."""
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    counts: dict = {}
    for event in gp_events.query(store, POOL_ID):
        if (event["kind"] == gp_events.TASK_RUNNING
                and event.get("job_id") == JOB_ID
                and (event.get("attrs") or {}).get("exit_code") == 0):
            counts[event.get("task_id")] = \
                counts.get(event.get("task_id"), 0) + 1
    return counts


def _check_lost_output(task: dict, successes: Optional[int],
                       upload_faulted: bool = False) -> None:
    """A task whose stdout blob is missing passes only when an injected
    store error cut the upload — its row's ``output_error`` names the
    fault, or (when the agent's best-effort note of it fell to a further
    injected error) the chaos store failed that very upload
    (``upload_faulted``) — it completed with exit 0, and it ran to
    success once: no earlier attempt exited 0 and (for a regular task,
    ``successes`` not None) at most one running interval did."""
    task_id = task["_rk"]
    error = task.get("output_error") or ""
    assert injectors_mod.INJECTED_ERROR in error or upload_faulted, (
        f"{task_id}: output missing without an injected upload fault "
        f"(output_error {error!r})")
    assert task.get("state") == "completed" and \
        task.get("exit_code") == 0, task
    earlier = [a for a in task.get("attempt_history") or []
               if a.get("exit_code") == 0]
    assert not earlier, (
        f"{task_id}: an earlier attempt also exited 0: {earlier}")
    assert successes is None or successes <= 1, (
        f"{task_id}: completed {successes} times")
