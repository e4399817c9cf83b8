"""Chaos injectors: apply one Injection through a framework seam.

Each injector exercises a failure mode the recovery layer claims to
survive, through surfaces the framework ALREADY exposes (no
monkey-patching):

  * ChaosStore wraps a StateStore and adds windowed latency or a
    bounded burst of op errors — the agent's worker/heartbeat/control
    loops must absorb them (requeue, retry next tick).
  * heartbeat blackout flips the agent's blackout attribute — node
    keeps running, looks partitioned.
  * task kill / task wedge signal a live task's process group —
    SIGKILL exercises the retry supervisor, SIGSTOP the progress
    watchdog (alive, zero progress: the TPU-wedge shape).
  * node preempt crash-kills the fakepod agent and revives it later —
    orphan reclaim + gang recovery territory.

The port's copy of batch_shipyard_tpu/chaos/injectors.py over the port's
fakepod, agents, state/leases, state/names and jobs/manager. The error
messages are named (INJECTED_ERROR, OUTAGE_ERROR) so a drill can tell an
injected fault from any other in a task row's ``output_error``.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional

from batch_shipyard_tpu_torch.chaos.plan import Injection
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

# Store methods subject to delay/error injection: the coordination hot
# path. Mutators and readers both — a flaky store is flaky everywhere.
_FAULTED_OPS = frozenset({
    "put_object", "get_object", "get_object_meta", "delete_object",
    "insert_entity", "upsert_entity", "merge_entity", "get_entity",
    "query_entities", "delete_entity", "insert_entities",
    "count_entities_by",
    "put_message", "put_messages", "get_messages", "delete_message",
    "update_message",
    # Stream ops fault at CALL time (before any chunk moves) so the
    # outage drill proves output uploads ride through too — the
    # resilient wrapper spools-and-retries put, opens-and-retries get.
    "put_object_stream", "get_object_stream",
})


# The messages an injected failure carries.
INJECTED_ERROR = "chaos: injected store error"
OUTAGE_ERROR = "chaos: store outage in progress"


class ChaosError(RuntimeError):
    """An injected state-store failure."""


class ChaosStore:
    """StateStore wrapper with windowed fault injection.

    Delegates everything to the wrapped store; ops named in
    _FAULTED_OPS first pass the fault gate: an active delay window
    sleeps them, an armed error budget raises ChaosError and
    decrements. Thread-safe — agents hit this from many threads.
    ``injected_errors()`` lists the (op, first argument) each injected
    error failed, so a drill can tell what its faults hit (the port's
    addition; the gates are the reference's)."""

    def __init__(self, inner) -> None:
        self._inner = inner
        self._lock = threading.Lock()
        self._delay_until = 0.0
        self._delay_seconds = 0.0
        self._error_budget = 0
        self._outage_until = 0.0
        self._injected: list[tuple] = []

    # -- fault control (called by the drill driver) --------------------

    def inject_delay(self, delay_seconds: float,
                     window_seconds: float) -> None:
        with self._lock:
            self._delay_seconds = delay_seconds
            self._delay_until = time.monotonic() + window_seconds

    def inject_errors(self, ops: int) -> None:
        with self._lock:
            self._error_budget += max(0, int(ops))

    def inject_outage(self, window_seconds: float) -> None:
        """Sustained outage: EVERY faulted op fails for the window —
        the store is down, not flaky. Only the resilient-store
        ride-through (state/resilient.py) survives this shape."""
        with self._lock:
            self._outage_until = time.monotonic() + window_seconds

    # -- delegation ----------------------------------------------------

    def injected_errors(self) -> list[tuple]:
        """(op name, its first argument — an object key or table) of
        every op an injected error failed, in order."""
        with self._lock:
            return list(self._injected)

    def _gate(self, op: str = "", target=None) -> None:
        with self._lock:
            outage = time.monotonic() < self._outage_until
            delay = (self._delay_seconds
                     if time.monotonic() < self._delay_until else 0.0)
            err = self._error_budget > 0 and not outage
            if err:
                self._error_budget -= 1
                self._injected.append((op, target))
        if outage:
            raise ChaosError(OUTAGE_ERROR)
        if err:
            raise ChaosError(INJECTED_ERROR)
        if delay:
            time.sleep(delay)

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name in _FAULTED_OPS and callable(attr):
            def faulted(*args, **kwargs):
                self._gate(name, args[0] if args else None)
                return attr(*args, **kwargs)
            return faulted
        return attr


def apply_injection(injection: Injection, substrate,
                    pool_id: str,
                    store: Optional[ChaosStore] = None) -> dict:
    """Apply one scheduled injection against a live fakepod pool.
    Returns an application record (what was actually hit) for the
    drill report. Node targets resolve by index modulo the live
    agent set, so a plan generated for N nodes applies to any pool."""
    record = {"kind": injection.kind, "at": injection.at,
              "node_index": injection.node_index, "applied": False}
    if injection.kind == "store_delay":
        if store is not None:
            store.inject_delay(injection.param("delay", 0.02),
                               injection.param("window", 1.0))
            record["applied"] = True
        return record
    if injection.kind == "store_error":
        if store is not None:
            store.inject_errors(injection.param("ops", 3))
            record["applied"] = True
        return record
    if injection.kind == "store_outage":
        if store is not None:
            store.inject_outage(injection.param("window", 2.0))
            record["applied"] = True
        return record

    agents = _live_agents(substrate, pool_id)
    if not agents:
        return record
    agent = agents[injection.node_index % len(agents)]
    record["node_id"] = agent.identity.node_id

    if injection.kind == "heartbeat_blackout":
        agent.heartbeat_blackout_until = (
            time.time() + injection.param("window", 2.0))
        record["applied"] = True
    elif injection.kind == "leader_partition":
        # Partition exactly the CURRENT sweep leader from the
        # control plane: heartbeats AND lease renewals stall while
        # its sweep loop keeps running — the shape the old
        # heartbeat-freshness election double-fired under. The
        # leader is resolved from the preempt-sweep epoch object
        # (the observable record of the live term); fall back to
        # the scheduled target when no term exists yet.
        from batch_shipyard_tpu_torch.state import leases as state_leases
        from batch_shipyard_tpu_torch.state import names as names_mod
        target = agent
        leader = state_leases.read_leader(
            agents[0].store,
            names_mod.leader_epoch_key(
                pool_id, state_leases.ROLE_PREEMPT_SWEEP))
        if leader is not None:
            for candidate in agents:
                if candidate.identity.node_id == \
                        leader.get("owner"):
                    target = candidate
                    break
        window = injection.param("window", 3.0)
        target.heartbeat_blackout_until = time.time() + window
        target.lease_blackout_until = time.time() + window
        record["node_id"] = target.identity.node_id
        record["window"] = window
        record["leader_epoch"] = (leader or {}).get("epoch")
        record["applied"] = True
    elif injection.kind == "agent_restart":
        # The agent PROCESS dies — in-flight completion paths
        # abandoned, no offline write, no lease release — while its
        # task subprocesses (own sessions) keep running; the revived
        # agent on the SAME work_dir must re-adopt them from the
        # slot ledgers.
        victim = _pick_live_proc(agents, preferred=agent)
        deadline = time.monotonic() + 2.0
        while victim is None and time.monotonic() < deadline:
            time.sleep(0.05)
            victim = _pick_live_proc(
                _live_agents(substrate, pool_id), preferred=None)
        if victim is None:
            return record
        node, _proc = victim
        record["node_id"] = node.identity.node_id
        context = substrate.crash_agent_hard(pool_id,
                                             node.identity.node_id)
        if context is not None:
            record["applied"] = True
            revive_after = injection.param("revive_after", 0.5)

            def _revive_restart():
                time.sleep(revive_after)
                substrate.revive_node(pool_id, context)

            threading.Thread(target=_revive_restart, daemon=True,
                             name="chaos-agent-restart").start()
    elif injection.kind in ("task_kill", "task_wedge"):
        # Prefer the target node's live task; fall back to any node
        # actually running one (the schedule is deterministic, the
        # scheduler's placement is not). A scheduled kill landing in
        # a claim gap waits briefly for a victim — the drill's point
        # is to exercise the kill paths, not to miss by 100ms.
        victim = _pick_live_proc(agents, preferred=agent)
        deadline = time.monotonic() + 2.0
        while victim is None and time.monotonic() < deadline:
            time.sleep(0.05)
            victim = _pick_live_proc(
                _live_agents(substrate, pool_id), preferred=None)
        if victim is None:
            return record
        node, proc = victim
        record["node_id"] = node.identity.node_id
        sig = (signal.SIGKILL if injection.kind == "task_kill"
               else signal.SIGSTOP)
        try:
            os.killpg(os.getpgid(proc.pid), sig)
            record["applied"] = True
            record["pid"] = proc.pid
        except (ProcessLookupError, PermissionError, OSError):
            pass
    elif injection.kind == "node_preempt":
        context = substrate.crash_node(pool_id,
                                       agent.identity.node_id)
        if context is not None:
            record["applied"] = True
            revive_after = injection.param("revive_after", 0.5)

            def _revive():
                time.sleep(revive_after)
                substrate.revive_node(pool_id, context)

            threading.Thread(target=_revive, daemon=True,
                             name="chaos-revive").start()
    elif injection.kind == "victim_ignore_notice":
        # Forcible-eviction shape: stamp the cooperative request on a
        # RUNNING task and stop there. The victim (an
        # --ignore-notice probe) squats past preempt_grace_seconds;
        # the sweep's escalation + the owning agent's enforcement —
        # the code under test — must do the killing, so unlike
        # node_preempt_notice there is NO injector follow-through.
        victim = _pick_live_proc(agents, preferred=agent)
        deadline = time.monotonic() + 2.0
        while victim is None and time.monotonic() < deadline:
            time.sleep(0.05)
            victim = _pick_live_proc(
                _live_agents(substrate, pool_id), preferred=None)
        if victim is None:
            return record
        node, _proc = victim
        live = list(node._live_procs.items())
        if not live:
            return record
        (job_id, task_id), _proc = live[0]
        record["node_id"] = node.identity.node_id
        record["job_id"] = job_id
        record["task_id"] = task_id
        from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
        record["applied"] = bool(jobs_mgr.request_preemption(
            node.store, pool_id, job_id, task_id,
            reason="chaos victim_ignore_notice"))
    elif injection.kind == "host_loss_resize":
        # Permanent capacity loss: crash `count` nodes with NO
        # revive — the elastic gang must re-form smaller and
        # reshard-on-restore across the size change.
        count = max(1, int(injection.param("count", 1)))
        crashed = []
        for k in range(count):
            target = agents[(injection.node_index + k) % len(agents)]
            if _crash_host(substrate, pool_id, target):
                crashed.append(target.identity.node_id)
        record["crashed"] = crashed
        record["applied"] = bool(crashed)
    elif injection.kind == "pool_capacity_loss":
        # Total capacity loss: crash EVERY node of the pool, no
        # revive. Nothing inside the pool can finish the job —
        # recovery is the federation's cross-pool migration.
        crashed = []
        for target in agents:
            if _crash_host(substrate, pool_id, target):
                crashed.append(target.identity.node_id)
        record["crashed"] = crashed
        record["applied"] = bool(crashed)
    elif injection.kind == "node_preempt_notice":
        # Advance-notice preemption (the cloud spot shape): stamp a
        # cooperative preempt request on a RUNNING task, give the
        # workload the notice window to drain + commit + exit
        # EXIT_PREEMPTED, then follow through with the hard node
        # crash only if the task is still live — exactly what a
        # provider does when the notice lapses.
        victim = _pick_live_proc(agents, preferred=agent)
        deadline = time.monotonic() + 2.0
        while victim is None and time.monotonic() < deadline:
            time.sleep(0.05)
            victim = _pick_live_proc(
                _live_agents(substrate, pool_id), preferred=None)
        if victim is None:
            return record
        node, _proc = victim
        # Resolve the (job, task) of the victim's live proc.
        live = list(node._live_procs.items())
        if not live:
            return record
        (job_id, task_id), proc = live[0]
        record["node_id"] = node.identity.node_id
        record["job_id"] = job_id
        record["task_id"] = task_id
        from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
        stamped = jobs_mgr.request_preemption(
            node.store, pool_id, job_id, task_id,
            reason="chaos node_preempt_notice")
        record["applied"] = bool(stamped)
        if not stamped:
            return record
        notice = injection.param("notice", 0.6)
        revive_after = injection.param("revive_after", 0.5)

        def _follow_through():
            # The notice is about THIS attempt's process vacating:
            # once the stamped proc exits (cooperative drain), the
            # kill is withheld — even if a requeued rerun has already
            # reclaimed the same (job, task) key on this node.
            deadline = time.monotonic() + notice
            while time.monotonic() < deadline:
                if node._live_procs.get((job_id, task_id)) is not \
                        proc:
                    return  # drained cooperatively: no hard kill
                time.sleep(0.05)
            if node._live_procs.get((job_id, task_id)) is not proc:
                return
            context = substrate.crash_node(pool_id,
                                           node.identity.node_id)
            if context is not None:
                time.sleep(revive_after)
                substrate.revive_node(pool_id, context)

        threading.Thread(target=_follow_through, daemon=True,
                         name="chaos-preempt-notice").start()
    return record


def _crash_host(substrate, pool_id: str, agent) -> bool:
    """Kill a whole fakepod 'host': its task processes die WITH it
    (a real host loss takes the workload down too — crash_node alone
    only stops the agent threads), then the agent is crashed with no
    offline write and no revival."""
    for proc in list(agent._live_procs.values()):
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass
    return substrate.crash_node(pool_id,
                                agent.identity.node_id) is not None


def _live_agents(substrate, pool_id: str) -> list:
    with substrate._lock:
        agents = list(substrate._agents.get(pool_id, {}).values())
    return sorted(agents, key=lambda a: a.identity.node_index)


def _pick_live_proc(agents: list, preferred=None):
    ordered = ([preferred] if preferred is not None else []) + [
        a for a in agents if a is not preferred]
    for agent in ordered:
        # The agent's worker threads mutate _live_procs without a
        # lock; retry the snapshot instead of letting a concurrent
        # pop turn a scheduled injection into a silent skip.
        procs = []
        for _ in range(3):
            try:
                procs = list(agent._live_procs.items())
                break
            except RuntimeError:
                continue
        if procs:
            return agent, procs[0][1]
    return None
