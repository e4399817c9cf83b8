"""ChaosPlan: a deterministic, seeded fault schedule.

Reproducibility is the whole point: a drill that only fails one run in
twenty is useless for regression-testing recovery code. A plan is a
pure function of (seed, shape parameters) — same seed, same injection
sequence, byte for byte — so a failing drill replays exactly, and two
operators comparing notes can name a fault scenario by its seed.

The schedule is substrate-agnostic: targets are logical node INDICES
(resolved against the live pool at apply time by chaos/drill.py) and
times are offsets from drill start.

The port's copy of batch_shipyard_tpu/chaos/plan.py, with its code
unchanged: the same seed, duration, node count and kinds give the same
schedule, the same JSON and the same fingerprint, byte for byte.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
from typing import Optional

# Injection vocabulary. Each kind maps onto one existing framework
# seam (see chaos/injectors.py):
#   store_delay        — latency on every state-store op for a window
#   store_error        — a burst of injected store-op failures
#   heartbeat_blackout — node keeps working, heartbeats suppressed
#   task_kill          — SIGKILL a running task's process group
#   task_wedge         — SIGSTOP a running task: alive, zero progress
#                        (the TPU-wedge shape; only the progress
#                        watchdog can catch it)
#   node_preempt       — hard-kill a node agent (no offline write),
#                        revive after a delay
#   node_preempt_notice — ADVANCE-NOTICE preemption (the cloud
#                        spot/preemptible shape): stamp a cooperative
#                        preempt request on the node's running task,
#                        then crash the node after the notice window
#                        if the task is still running — a
#                        preempt-aware workload drains and exits
#                        first; an oblivious one eats the hard kill
#   victim_ignore_notice — stamp a cooperative preempt request on a
#                        running task and do NOTHING else: the
#                        victim (an --ignore-notice probe) squats
#                        past the grace window, and the sweep's
#                        eviction escalation — not the injector —
#                        must hard-kill it (the forcible-eviction
#                        drill's shape)
#   host_loss_resize   — crash `count` nodes of the pool with no
#                        revive: permanent capacity loss mid-gang,
#                        forcing the elastic resize + multi-host
#                        reshard-on-restore path
#   pool_capacity_loss — crash EVERY node of the pool: the gang can
#                        never re-form here, and only cross-pool
#                        migration (federation) can finish the job
#   store_outage       — the state store goes DOWN for a sustained
#                        window (every faulted op fails, not a
#                        per-op burst): only the resilient-store
#                        ride-through (critical retry + advisory
#                        WAL, state/resilient.py) survives it
#   leader_partition   — stall ONLY the current sweep leader's
#                        heartbeats and lease renewals while its
#                        sweep loop keeps running: the exact shape
#                        the old heartbeat-freshness election
#                        double-fired under; the lease must make it
#                        abdicate on its own clock
#   agent_restart      — the agent PROCESS dies (in-flight
#                        completion paths cut off, no offline write)
#                        while its task subprocesses keep running,
#                        then restarts on the same work_dir: the
#                        crash-restart adoption shape
#   replica_kill       — SIGKILL-shaped death of a serving replica
#                        mid-decode (socket torn down, no drain, no
#                        final stream line): the router must resume
#                        every live stream on a sibling with
#                        exactly-once token delivery
#   replica_drain_notice — a preempt/evict notice lands on a serving
#                        replica: it must flip to draining (healthz
#                        503+marker, no new admissions, in-flight
#                        decodes run to the grace deadline) while the
#                        router routes around it and resumes any
#                        drain-abandoned decode elsewhere
#   router_restart     — the serving ROUTER process dies mid-stream
#                        and a fresh one takes over the same fleet:
#                        clients re-submit with resume_tokens
#                        (cancel-then-resume), and the replicas'
#                        duplicate gates keep delivery exactly-once
INJECTION_KINDS = ("store_delay", "store_error", "heartbeat_blackout",
                   "task_kill", "task_wedge", "node_preempt",
                   "node_preempt_notice", "victim_ignore_notice",
                   "host_loss_resize", "pool_capacity_loss",
                   "store_outage", "leader_partition",
                   "agent_restart", "replica_kill",
                   "replica_drain_notice", "router_restart")

# Kinds a GENERIC drill's recovery invariants can absorb — the
# default schedule. The fleet-elasticity kinds are excluded: they
# exist to drive their dedicated drills (eviction / host-resize /
# migration, chaos/drill.py), and e.g. pool_capacity_loss in a
# single-pool generic drill is unrecoverable by construction (only
# cross-pool migration finishes the job). The control-plane kinds
# (store_outage / leader_partition / agent_restart) are likewise
# dedicated-drill shapes: a sustained outage without the resilient
# wrapper armed is unrecoverable by construction, and the other two
# need their drills' orchestrated setups to make the invariants
# non-vacuous. The serving kinds (replica_kill /
# replica_drain_notice / router_restart) target a serving fleet —
# replicas + router, not a batch pool — so they only make sense
# inside the serving drills (chaos/serving_drill.py), which stand
# that fleet up around the plan.
DEFAULT_DRILL_KINDS = ("store_delay", "store_error",
                       "heartbeat_blackout", "task_kill",
                       "task_wedge", "node_preempt",
                       "node_preempt_notice")


@dataclasses.dataclass(frozen=True)
class Injection:
    at: float           # seconds from drill start
    kind: str           # one of INJECTION_KINDS
    node_index: int     # logical target node (resolved at apply time)
    params: tuple       # sorted (key, value) pairs — hashable/frozen

    def param(self, key: str, default=None):
        return dict(self.params).get(key, default)

    def to_dict(self) -> dict:
        return {"at": self.at, "kind": self.kind,
                "node_index": self.node_index,
                "params": dict(self.params)}


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    seed: int
    duration: float
    num_nodes: int
    injections: tuple[Injection, ...]

    @classmethod
    def generate(cls, seed: int, duration: float = 4.0,
                 num_nodes: int = 4,
                 kinds: Optional[tuple[str, ...]] = None,
                 injections_per_kind: int = 1) -> "ChaosPlan":
        """Deterministic schedule: for each requested kind, draw
        ``injections_per_kind`` (time, target, params) tuples from a
        seed-keyed RNG. Faults land in the middle 70% of the drill
        window so the pool has formed before the first one and has
        runway to recover after the last. Default kinds are the
        generic-drill-recoverable set (DEFAULT_DRILL_KINDS); the
        fleet-elasticity kinds must be requested explicitly."""
        kinds = tuple(kinds or DEFAULT_DRILL_KINDS)
        unknown = [k for k in kinds if k not in INJECTION_KINDS]
        if unknown:
            raise ValueError(f"unknown injection kinds {unknown}")
        rng = random.Random(seed)
        out: list[Injection] = []
        lo, hi = 0.1 * duration, 0.8 * duration
        for kind in kinds:
            for _ in range(max(1, injections_per_kind)):
                at = round(rng.uniform(lo, hi), 3)
                node_index = rng.randrange(max(1, num_nodes))
                params: dict = {}
                if kind == "store_delay":
                    params = {"delay": round(rng.uniform(0.01, 0.05),
                                             3),
                              "window": round(rng.uniform(0.5, 1.5),
                                              3)}
                elif kind == "store_error":
                    params = {"ops": rng.randrange(2, 6)}
                elif kind == "heartbeat_blackout":
                    params = {"window": round(rng.uniform(1.0, 2.5),
                                              3)}
                elif kind == "node_preempt":
                    params = {"revive_after":
                              round(rng.uniform(0.3, 1.0), 3)}
                elif kind == "node_preempt_notice":
                    params = {"notice":
                              round(rng.uniform(0.4, 1.2), 3),
                              "revive_after":
                              round(rng.uniform(0.3, 1.0), 3)}
                elif kind == "host_loss_resize":
                    params = {"count": 1}
                elif kind == "store_outage":
                    params = {"window": round(rng.uniform(1.0, 2.5),
                                              3)}
                elif kind == "leader_partition":
                    params = {"window": round(rng.uniform(2.0, 4.0),
                                              3)}
                elif kind == "agent_restart":
                    params = {"revive_after":
                              round(rng.uniform(0.3, 0.8), 3)}
                elif kind == "replica_drain_notice":
                    params = {"grace":
                              round(rng.uniform(0.5, 2.0), 3)}
                elif kind == "router_restart":
                    params = {"downtime":
                              round(rng.uniform(0.1, 0.4), 3)}
                out.append(Injection(
                    at=at, kind=kind, node_index=node_index,
                    params=tuple(sorted(params.items()))))
        out.sort(key=lambda i: (i.at, i.kind, i.node_index))
        return cls(seed=seed, duration=duration, num_nodes=num_nodes,
                   injections=tuple(out))

    @classmethod
    def preemption_wave(cls, seed: int, at: float, num_nodes: int,
                        fraction: float = 0.3,
                        revive_after: float = 60.0,
                        stagger: float = 5.0) -> "ChaosPlan":
        """A provider preemption WAVE: ``fraction`` of the fleet is
        reclaimed without notice inside a short window starting at
        ``at`` (targets and offsets drawn from a seed-keyed RNG —
        distinct nodes, staggered like a real zone reclaim, and a
        pure function of the arguments). The fleet-simulator's
        chaos-schedule scenario; also drivable against a live pool
        via the generic injector path."""
        rng = random.Random(seed)
        count = max(1, int(num_nodes * fraction))
        targets = rng.sample(range(max(1, num_nodes)),
                             min(count, max(1, num_nodes)))
        out = [Injection(
            at=round(at + rng.uniform(0.0, stagger), 3),
            kind="node_preempt", node_index=idx,
            params=tuple(sorted(
                {"revive_after": revive_after}.items())))
            for idx in targets]
        out.sort(key=lambda i: (i.at, i.kind, i.node_index))
        return cls(seed=seed, duration=at + revive_after + stagger,
                   num_nodes=num_nodes, injections=tuple(out))

    def to_dict(self) -> dict:
        return {"seed": self.seed, "duration": self.duration,
                "num_nodes": self.num_nodes,
                "fingerprint": self.fingerprint(),
                "injections": [i.to_dict() for i in self.injections]}

    @classmethod
    def from_dict(cls, data: dict) -> "ChaosPlan":
        return cls(
            seed=int(data["seed"]), duration=float(data["duration"]),
            num_nodes=int(data["num_nodes"]),
            injections=tuple(
                Injection(at=float(i["at"]), kind=i["kind"],
                          node_index=int(i["node_index"]),
                          params=tuple(sorted(
                              (i.get("params") or {}).items())))
                for i in data["injections"]))

    def fingerprint(self) -> str:
        """Stable digest of the injection sequence — two plans with
        the same fingerprint inject identically (the determinism
        acceptance check)."""
        payload = json.dumps(
            [i.to_dict() for i in self.injections], sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]
