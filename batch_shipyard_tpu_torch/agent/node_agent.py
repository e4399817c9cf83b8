"""Node agent: the per-node daemon that executes scheduled work.

The reference never had to write this loop — Azure Batch's hosted agent
did task pickup, retries, and exit-code plumbing (SURVEY.md section 7
'hard parts'). Ours is storage-mediated like everything else: tasks
arrive on a per-pool queue, assignment is won by optimistic-concurrency
claims on task entities, gang (multi-instance) tasks rendezvous through
a gang table, and results flow back through tables + object uploads.

Lifecycle of a node (entity in TABLE_NODES):
    creating -> starting (node prep) -> idle <-> running -> offline
                 \\-> start_task_failed            \\-> unusable

Lifecycle of a task (entity in TABLE_TASKS):
    pending -> assigned -> running -> completed | failed
         \\-> blocked (dependency permanently unsatisfiable)

The agent runs identically under the fake substrate (thread per node)
and the localhost substrate (process).

This is the port's copy of batch_shipyard_tpu/agent/node_agent.py. It
reads and writes the reference's tables, queues and objects byte for
byte, so either package's agent runs the jobs either package submits.
The accelerator reaches it only through node prep (agent/nodeprep.py:
the node's GPUs and a torch/CUDA probe), the task runner's passthrough
(agent/task_runner.py) and the gang env (jobs/launcher.py:
torch.distributed's). The compile-cache hooks seed the node's cache
(``<work_dir>/compilecache``, exported to tasks as
$SHIPYARD_COMPILE_CACHE_DIR) from the pool's artifact before a task and
export it after (compilecache/seeding.py). Node 0 runs the pool-resident
schedule and autoscale services when pool_services asks for them
(jobs/schedules.py, pool/autoscale.py; autoscale needs the substrate
handle, which only the fake substrate passes). With ``resilience`` set
(every agent process sets it, agent/__main__.py), the agent's store is
the store-outage ride-through wrapper (state/resilient.py) over
``<work_dir>/store_wal.jsonl``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import subprocess
import threading
import time
import uuid
from typing import Callable, Optional

from batch_shipyard_tpu_torch.agent import preemption as preempt_mod
from batch_shipyard_tpu_torch.agent import progress as progress_mod
from batch_shipyard_tpu_torch.agent import task_runner
from batch_shipyard_tpu_torch.compilecache import manager as cc_manager
from batch_shipyard_tpu_torch.compilecache import seeding as cc_seeding
from batch_shipyard_tpu_torch.config.settings import (
    JaxDistributedSettings, MultiInstanceSettings, PoolSettings)
from batch_shipyard_tpu_torch.goodput import events as goodput_events
from batch_shipyard_tpu_torch.jobs import launcher
from batch_shipyard_tpu_torch.sched import policy as sched_policy
from batch_shipyard_tpu_torch.state import leases as state_leases
from batch_shipyard_tpu_torch.state import resilient as state_resilient
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, EtagMismatchError, NotFoundError, StateStore)
from batch_shipyard_tpu_torch.trace import context as trace_context
from batch_shipyard_tpu_torch.trace import profiling as trace_profiling
from batch_shipyard_tpu_torch.trace import spans as trace_spans
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

_OUTPUT_STREAM_CHUNK = 4 * 1024 * 1024

# How often a worker slot re-reads the pool's task-queue shard count
# to pick up grow-only autoscale (jobs/manager.py). Slow on purpose:
# a stale scan only under-uses new fan-out, it never loses messages.
_SHARD_REFRESH_SECONDS = 20.0

# Identity file worker 0 writes inside a shared scratch dir; other
# workers read it THROUGH the published path to decide whether they
# already share the host's filesystem.
_SCRATCH_NONCE = ".shipyard_scratch_nonce"


class TaskEnvError(Exception):
    """Task environment synthesis failed (unresolvable secret,
    malformed env block): the task must FAIL with the reason — an
    exception escaping to the worker loop would bounce its queue
    message forever."""


class NodeUnusableError(Exception):
    """Raised by a nodeprep callable to mark the node unusable (as
    opposed to start-task-failed): the node finished booting but cannot
    serve tasks — triggers attempt_recovery_on_unusable handling."""


class _AdoptedProc:
    """Handle for a process this agent did not spawn (crash-restart
    adoption): exposes the ``pid`` every _live_procs consumer —
    term_task, eviction enforcement, zap, the chaos injectors —
    actually uses. There is no Popen to wait() on; the adoption
    watcher polls liveness and reads the exit-code sentinel."""

    def __init__(self, pid: Optional[int]) -> None:
        self.pid = pid or -1


@dataclasses.dataclass
class NodeIdentity:
    pool_id: str
    node_id: str
    node_index: int
    hostname: str
    internal_ip: str
    slice_index: int = 0
    worker_index: int = 0


class NodeAgent:
    def __init__(self, store: StateStore, identity: NodeIdentity,
                 pool: PoolSettings, work_dir: str,
                 heartbeat_interval: float = 5.0,
                 poll_interval: float = 0.2,
                 gang_timeout: float = 600.0,
                 node_stale_seconds: float = 30.0,
                 job_state_ttl: float = 5.0,
                 nodeprep: Optional[Callable[["NodeAgent"], None]] = None,
                 image_provisioner: Optional[
                     Callable[["NodeAgent", list[str]], None]] = None,
                 output_upload_cap_bytes: Optional[int] = None,
                 substrate=None,
                 scratch_mount_runner: Optional[
                     Callable[[str, str], int]] = None,
                 scratch_export_runner: Optional[
                     Callable[[str], int]] = None,
                 scratch_unexport_runner: Optional[
                     Callable[[str], int]] = None,
                 scratch_umount_runner: Optional[
                     Callable[[str], int]] = None,
                 force_remote_scratch: bool = False,
                 scratch_finalize_timeout: float = 120.0,
                 retry_backoff_base: float = 2.0,
                 retry_backoff_cap: float = 300.0,
                 health_quarantine_threshold: float = 0.25,
                 health_probation_seconds: float = 300.0,
                 claim_visibility_seconds: float = 60.0,
                 gang_sweep_interval: float = 60.0,
                 preempt_sweep_interval: float = 30.0,
                 preempt_grace_seconds: float = 20.0,
                 leader_lease_seconds: Optional[float] = None,
                 resilience: Optional[dict] = None,
                 ) -> None:
        # Store-outage ride-through (state/resilient.py): when
        # configured, every store op this agent issues goes through
        # the resilient wrapper — critical ops retry through outages,
        # advisory ops (goodput/trace/heartbeat) ride the per-node
        # local WAL and replay in order on recovery. The agent process
        # (agent/__main__.py) enables it by default; in-process agents
        # opt in via the kwarg.
        if resilience is not None:
            journal = os.path.join(work_dir, "store_wal.jsonl")
            store = state_resilient.ResilientStore(
                store, journal_path=journal,
                pool_id=identity.pool_id,
                node_id=identity.node_id,
                stop_check=lambda: self.stop_event.is_set(),
                **resilience)
            logger.info("store-outage ride-through on; journal %s",
                        journal)
        self.store = store
        self.identity = identity
        self.pool = pool
        self.work_dir = work_dir
        self.heartbeat_interval = heartbeat_interval
        self.poll_interval = poll_interval
        self.gang_timeout = gang_timeout
        self.node_stale_seconds = node_stale_seconds
        self._nodeprep = nodeprep
        self._image_provisioner = image_provisioner
        # Substrate handle for pool-resident services that act on the
        # pool (autoscale resize); None disables those services.
        self._substrate = substrate
        # None = upload task outputs in full (streamed). A configured
        # cap keeps head+tail around an explicit truncation marker.
        self.output_upload_cap_bytes = output_upload_cap_bytes
        # Shared-scratch plumbing commands, injectable so mount/export
        # synthesis and their failure modes run under fault injection
        # (on real pools these shell out to mount/umount/exportfs).
        self._scratch_mount = scratch_mount_runner or self._nfs_mount
        self._scratch_export = (scratch_export_runner or
                                self._nfs_export)
        self._scratch_unexport = (scratch_unexport_runner or
                                  self._nfs_unexport)
        self._scratch_umount = (scratch_umount_runner or
                                self._nfs_umount)
        self._force_remote_scratch = force_remote_scratch
        self._scratch_finalize_timeout = scratch_finalize_timeout
        self.stop_event = threading.Event()
        self._threads: list[threading.Thread] = []
        self._running_tasks = 0
        self._running_lock = threading.Lock()
        # Resolved shared-scratch paths per job (auto_scratch: shared).
        self._shared_scratch: dict[str, str] = {}
        # Short-TTL job cache ((state, profile_request, at)): the
        # disabled/terminated check runs on every queue poll and must
        # not cost a store round trip each time on cloud backends;
        # the profile-request forwarding rides the same read.
        self._job_state_cache: dict[str, tuple] = {}
        self._job_state_ttl = job_state_ttl
        # (job_id, task_id) -> live Popen, for task termination relay.
        self._live_procs: dict[tuple[str, str], object] = {}
        # (job_id, task_id) -> last gang-health probe (rate limiting
        # the claim-failure bounce path).
        self._gang_probe_at: dict[tuple[str, str], float] = {}
        # (gang_pk, instance) claims held LIVE by a worker slot of
        # this process. A claim whose slot crashed (store fault after
        # _gang_claim) leaves joined rows owned by a live node that
        # nothing is running — no observer ever judges them stale, so
        # the gang would wedge forever. Redelivery resumes such a
        # claim, but only when no slot here still holds it (a
        # duplicate message copy must not double-run the instance).
        self._active_gang_claims: set[tuple[str, int]] = set()
        # Orphaned-gang-row janitor cadence (heartbeat loop).
        self.gang_sweep_interval = gang_sweep_interval
        self._last_gang_sweep = time.monotonic()
        # Cooperative-preemption sweep cadence (heartbeat loop,
        # leader-gated like the gang janitor: one unpartitioned task
        # scan per pool per interval). grace = how long a pending
        # higher-priority task must have waited before lower-priority
        # running work is evicted for it (<=0 disables the sweep).
        self.preempt_sweep_interval = preempt_sweep_interval
        self.preempt_grace_seconds = preempt_grace_seconds
        self._last_preempt_sweep = time.monotonic()
        # Lease-based sweep leadership (state/leases.py): one named
        # lease per leader-gated loop, acquired at the loop's own
        # cadence and renewed every heartbeat; the term's fencing
        # epoch is stamped into every sweep write. Default duration
        # scales with the heartbeat so failover latency tracks the
        # deployment's clock (drills with 0.2s beats fail over in
        # ~2s; production's 5s beats in ~20s).
        self.leader_lease_seconds = (
            leader_lease_seconds
            if leader_lease_seconds is not None
            else max(2.0, 4.0 * heartbeat_interval))
        self._sweep_leases: dict[str, state_leases.LeaderLease] = {}
        # Claim batching: a worker poll takes up to slot-count
        # messages (capped) under one visibility window and parks the
        # surplus on this node-local deque; every slot drains the
        # deque before touching the store again, so a busy node pays
        # ~1 queue round trip per k tasks instead of per task.
        self._claim_prefetch: collections.deque = collections.deque()
        self._claim_prefetch_lock = threading.Lock()
        # Server-side task-factory expansion (jobs/expansion.py):
        # the ROLE_EXPANDER leader materializes parked generator
        # specs on a dedicated thread; the heartbeat sweep only
        # checks for work and spawns it (lint forbids slow sweeps).
        self._expander_thread: Optional[threading.Thread] = None
        self._last_expansion_sweep = 0.0
        self.expansion_sweep_interval = max(2.0, heartbeat_interval)
        # Chaos seam (leader_partition): while wall-clock < this, NO
        # lease traffic reaches the store — the leader is partitioned
        # from it, and its authority decays on the local clock alone.
        self.lease_blackout_until = 0.0
        # Chaos seam (agent_restart, fakepod crash_agent_hard):
        # threads cannot be killed, so a simulated agent-process
        # death sets this flag — in-flight completion paths cut off
        # before their first post-exit store write, exactly like the
        # real process dying mid-task. The REVIVED agent's adoption
        # path owns the task from there.
        self._abandoned = False
        # Crash-restart adoption: slots whose previous-process task
        # is still running under an adoption watcher — the worker
        # slot waits its turn instead of oversubscribing the node.
        self._adopted_slots: set[int] = set()
        # Predecessor's last heartbeat (captured by start() before
        # the first upsert overwrites it): the adoption leg's start.
        self._pre_restart_heartbeat: Optional[float] = None
        # (path, requested_at) preempt requests already delivered —
        # same dedup protocol as _profile_delivered (one drain per
        # request; disk markers persist the dedup across restarts).
        self._preempt_delivered: set[tuple] = set()
        # First-seen clock per stale-epoch preempt stamp being held
        # for confirmation before delivery (consumer-side fence for
        # the author-retraction race; _confirm_stale_epoch_request),
        # plus the TTL-cached observer view of the sweep lease term.
        self._preempt_forward_hold: dict[tuple, float] = {}
        self._preempt_leader_cache: Optional[tuple] = None
        # (job_id, task_id) keys THIS agent hard-killed through the
        # eviction escalation: the completion path classifies the
        # exit as evicted (claimable, full budget, neutral health)
        # instead of a wedge/failure. Popped at classification.
        self._evicted_locally: set[tuple[str, str]] = set()
        # Stale preempt-request file janitor cadence (heartbeat
        # loop, per-node disk sweep — shares the gang janitor's
        # interval knob but needs no leader gate: each node owns its
        # own task dirs).
        self._last_preempt_file_sweep = time.monotonic()
        # Short-TTL per-task preempt_request cache ((request, at)):
        # the heartbeat forwarding loop must not cost one store read
        # per live task per beat on cloud backends just to learn no
        # preemption is pending (the _job_state_cache rule). TTL
        # shares _job_state_ttl.
        self._task_preempt_cache: dict[tuple, tuple] = {}
        # (job_id, secret_id) -> resolved env block: one provider
        # round trip per job per node, not per task launch.
        self._env_block_cache: dict[tuple[str, str], dict] = {}
        # Pool image-manifest cache for the strict
        # allow_run_on_missing_image gate: (expires_at, image set)
        # per runtime kind — the hot launch path must not query the
        # whole images table per task.
        self._image_manifest_cache: dict[str, tuple[float, set]] = {}
        # Goodput accounting: wall-clock instant this node last went
        # idle (no claimed/running work); the idle interval is emitted
        # when work next starts. None while work is in flight.
        # _goodput_busy_slots holds slots with a CLAIMED task
        # (claim -> finish/abandon) so a slot mid-prep blocks idle
        # re-arm even before its _running_tasks increment; slot-keyed
        # so an exception path can release idempotently without ever
        # stealing another slot's unit. Both under _running_lock.
        self._goodput_idle_since: Optional[float] = None
        self._goodput_busy_slots: set[int] = set()
        # Pool-wide compile-cache seeding (compilecache/seeding.py):
        # remember the latest.json generation last seeded so the
        # pre-task seed check costs one metadata read, not a download,
        # when nothing changed. Exports run on a background thread
        # (one at a time) so a multi-GB cache upload never sits on
        # the task-completion path.
        self._compile_cache_seen_gen: Optional[int] = None
        self._compile_cache_export_thread: Optional[
            threading.Thread] = None
        # Retry supervisor: exponential backoff parameters for
        # requeued failures (delay = base * 2^retries, capped, with
        # deterministic per-(task, attempt) jitter).
        self.retry_backoff_base = retry_backoff_base
        self.retry_backoff_cap = retry_backoff_cap
        # Claimed-message invisibility window: also the recovery-
        # latency floor after a node crash (the dead node's claim
        # redelivers only when this lapses). Chaos drills shrink it.
        self.claim_visibility_seconds = claim_visibility_seconds
        # Node health score in [0, 1]: decayed by task failures
        # (harder by wedges), recovered by successes. Below the
        # threshold the node quarantines itself — auto-drain: running
        # work finishes, no new claims — and publishes the
        # health/quarantined columns on its node entity so observers
        # (gang recovery, heimdall) exclude it too.
        self._health = 1.0
        self._health_quarantine_threshold = health_quarantine_threshold
        self._node_quarantined = False
        # Quarantine is probational, never permanent: a quarantined
        # node claims nothing, so it can never earn the successes that
        # restore its score — without a timer, a poison job of
        # ordinary buggy tasks (exit 1) would drain EVERY node in the
        # pool forever. After this window the score resets to the
        # threshold: one more failure re-quarantines immediately, one
        # success starts real recovery.
        self._health_probation_seconds = health_probation_seconds
        self._quarantined_at = 0.0
        self._health_lock = threading.Lock()
        # Shared scheduling policy (sched/policy.py): knobs derived
        # once from pool settings; claim_scoring opts the claim path
        # into warm-cache affinity deferral. The preemption sweep's
        # goodput-cost victim ordering and the health/backoff debits
        # are always on — with no hints/failures they price to 0.0
        # and reduce to the historical (priority, task_id) order.
        self._policy_knobs = sched_policy.knobs_from_settings(
            getattr(pool, "sched_policy", None))
        self._claim_scoring = bool(
            getattr(getattr(pool, "sched_policy", None),
                    "claim_scoring", False))
        # Recent task-failure count for the claim-scoring backoff
        # debit: bumped on failure/wedge, drained by successes.
        self._recent_failures = 0
        # Last synced sched-hints JSON per live task, so the
        # heartbeat mirror writes the row only on change.
        self._sched_hints_sent: dict[tuple[str, str], str] = {}
        # Chaos injection seam: heartbeats are suppressed while
        # wall-clock < this (simulated network partition).
        self.heartbeat_blackout_until = 0.0
        # On-demand profiling: (request-file path, requested_at)
        # pairs this agent already delivered — keyed per TARGET FILE
        # so every gang instance dir on a multi-slot node gets its
        # copy, yet no file is ever re-dropped after the harness
        # consumed it (one store flag, one capture per instance).
        self._profile_delivered: set[tuple] = set()
        # Retention sweeps: (monotonic deadline, task dir) for
        # completed tasks whose spec sets retention_time_seconds —
        # the Azure Batch task-constraint retention_time analog
        # (reference batch.py:4859): working files stay on the node
        # for the window, then a heartbeat-loop sweep removes them.
        self._retention: list[tuple[float, str]] = []
        self._retention_lock = threading.Lock()

    # ------------------------- node lifecycle --------------------------

    @property
    def _nid(self) -> tuple[str, str]:
        return self.identity.pool_id, self.identity.node_id

    def _set_node_state(self, state: str, **extra) -> None:
        pool_id, node_id = self._nid
        entity = {
            "state": state,
            "hostname": self.identity.hostname,
            "internal_ip": self.identity.internal_ip,
            "node_index": self.identity.node_index,
            "slice_index": self.identity.slice_index,
            "worker_index": self.identity.worker_index,
            "heartbeat_at": time.time(),
            "task_slots": self.pool.task_slots_per_node,
            names.NODE_COL_HEALTH: self._health,
            names.NODE_COL_QUARANTINED: self._node_quarantined,
        }
        entity.update(extra)
        self.store.upsert_entity(names.TABLE_NODES, pool_id, node_id, entity)

    def _heartbeat(self, **extra) -> None:
        # Chaos seam (chaos/injectors.py heartbeat_blackout): a
        # suppressed heartbeat simulates a partitioned-but-running
        # node without touching the network stack.
        if time.time() < self.heartbeat_blackout_until:
            return
        pool_id, node_id = self._nid
        # Health/quarantine ride on every heartbeat so a one-shot
        # publish lost to a blackout window or store hiccup
        # self-repairs on the next periodic write.
        with self._health_lock:
            health_cols = {
                names.NODE_COL_HEALTH: self._health,
                names.NODE_COL_QUARANTINED: self._node_quarantined,
            }
        # Resilient-store WAL backlog rides every heartbeat so
        # heimdall exports shipyard_journal_backlog_entries per node
        # (0 when the wrapper is off or the journal is drained).
        backlog_fn = getattr(self.store, "journal_backlog", None)
        if callable(backlog_fn):
            health_cols[names.NODE_COL_JOURNAL_BACKLOG] = backlog_fn()
        try:
            self.store.merge_entity(
                names.TABLE_NODES, pool_id, node_id,
                {"heartbeat_at": time.time(),
                 "running_tasks": self._running_tasks,
                 **health_cols, **extra})
        except NotFoundError:
            pass

    def start(self) -> None:
        """Run node prep, then start worker + heartbeat threads."""
        # Crash-restart adoption needs the PREDECESSOR's last
        # heartbeat (the adoption leg's start) BEFORE the first state
        # upsert below overwrites it. One read, only when a previous
        # process left slot ledgers behind.
        slots_dir = os.path.join(self.work_dir, "slots")
        if os.path.isdir(slots_dir) and os.listdir(slots_dir):
            try:
                # Bounded: a restart DURING a store outage must not
                # park the boot thread in the resilient wrapper's
                # 900s retry loop before adoption or any worker slot
                # exists — fail fast into the degrade path instead.
                with self._store_bounded(
                        max(10.0, 2.0 * self.heartbeat_interval)):
                    row = self.store.get_entity(names.TABLE_NODES,
                                                *self._nid)
                self._pre_restart_heartbeat = \
                    float(row.get("heartbeat_at") or 0) or None
            except Exception:  # noqa: BLE001 - adoption degrades
                logger.debug("pre-restart heartbeat probe failed",
                             exc_info=True)
        self._set_node_state("starting")
        marker = os.path.join(self.work_dir, ".nodeprep_finished")
        prep_started = time.time()
        try:
            os.makedirs(self.work_dir, exist_ok=True)
            # Idempotency marker: reboot-resume fast path (reference:
            # $nodeprepfinished, shipyard_nodeprep.sh:1935-1970).
            if not os.path.exists(marker):
                if self._nodeprep is not None:
                    self._nodeprep(self)
                with open(marker, "w", encoding="utf-8") as fh:
                    fh.write(util.datetime_utcnow_iso())
                goodput_events.emit(
                    self.store, self.identity.pool_id,
                    goodput_events.NODE_PREP,
                    node_id=self.identity.node_id,
                    start=prep_started, end=time.time())
        except NodeUnusableError as exc:
            logger.warning("node %s unusable: %s",
                           self.identity.node_id, exc)
            self._set_node_state("unusable", error=str(exc))
            return
        except Exception as exc:
            logger.exception("node prep failed on %s", self.identity.node_id)
            self._set_node_state("start_task_failed", error=str(exc))
            return
        self._set_node_state("idle")
        self._goodput_idle_since = time.time()
        self._rescan_retention_markers()
        # Re-adopt the previous process's still-running work BEFORE
        # the worker slots start polling: the live-proc registry must
        # already name the adopted tasks when the first redelivered
        # message asks whether they are orphans.
        self._adopt_restart_state()
        for slot in range(self.pool.task_slots_per_node):
            thread = threading.Thread(
                target=self._worker_loop, args=(slot,),
                name=f"agent-{self.identity.node_id}-s{slot}", daemon=True)
            thread.start()
            self._threads.append(thread)
        hb = threading.Thread(target=self._heartbeat_loop,
                              name=f"hb-{self.identity.node_id}",
                              daemon=True)
        hb.start()
        self._threads.append(hb)
        # Control messages get their own thread: worker slots block
        # while running tasks, and controls (task termination,
        # shutdown) must still be honored.
        ctrl = threading.Thread(target=self._control_loop,
                                name=f"ctrl-{self.identity.node_id}",
                                daemon=True)
        ctrl.start()
        self._threads.append(ctrl)
        self._start_pool_services()

    def _start_pool_services(self) -> None:
        """Pool-resident daemons on node 0 (reference: the recurrent
        job manager runs as a job-manager task ON the pool,
        cargo/recurrent_job_manager.py:187 — schedules keep firing
        with no operator terminal alive). Gated by
        pool_specification.pool_services."""
        services = getattr(self.pool, "pool_services", None)
        if services is None or self.identity.node_index != 0:
            return
        if services.schedules:
            from batch_shipyard_tpu_torch.jobs import schedules
            thread = threading.Thread(
                target=schedules.run_pool_schedule_service,
                args=(self.store, self.pool),
                kwargs={"stop_event": self.stop_event,
                        "poll_interval":
                            services.poll_interval_seconds},
                name=f"svc-sched-{self.identity.node_id}", daemon=True)
            thread.start()
            self._threads.append(thread)
            logger.info("pool schedule service running on %s",
                        self.identity.node_id)
        if services.autoscale:
            if self._substrate is None:
                logger.warning(
                    "pool_services.autoscale enabled but this agent "
                    "has no substrate handle; service not started")
                return
            from batch_shipyard_tpu_torch.pool import autoscale as as_mod
            thread = threading.Thread(
                target=as_mod.run_daemon,
                args=(self.store, self._substrate, self.pool),
                kwargs={"stop_event": self.stop_event,
                        "interval": services.poll_interval_seconds},
                name=f"svc-as-{self.identity.node_id}", daemon=True)
            thread.start()
            self._threads.append(thread)
            logger.info("pool autoscale service running on %s",
                        self.identity.node_id)

    def stop(self) -> None:
        self.stop_event.set()

    def join(self, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        for thread in self._threads:
            remaining = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            thread.join(remaining)

    def _heartbeat_loop(self) -> None:
        while not self.stop_event.wait(self.heartbeat_interval):
            # A transient store error must not kill the heartbeat
            # thread forever — that would turn one hiccup into a
            # permanently "dead" node (orphan reclaim would then
            # steal its running tasks).
            try:
                # Never-blocking duties first: the advisory heartbeat
                # publish (journals through an outage), lease renewal
                # (unwrapped — fails fast so a partitioned leader
                # abdicates honestly) and retention deletes (purely
                # local) must keep their cadence even when the store
                # is dark.
                self._heartbeat()
                self._renew_sweep_leases()
                self._sweep_retention()
            except Exception:
                logger.exception("heartbeat iteration failed; "
                                 "continuing")
            try:
                # Store-coordination duties ride a bounded critical-
                # retry window: without it, one get_entity inside a
                # store outage would park THIS thread in the
                # resilient wrapper's retry loop for up to
                # max_outage_seconds, starving every duty above —
                # the sleep-in-sweep class the lint rules forbid.
                # On the bound firing, skip the rest of the beat;
                # the next beat re-probes.
                with self._store_bounded(
                        max(5.0, 2.0 * self.heartbeat_interval)):
                    self._sweep_orphaned_gangs()
                    self._sweep_task_expansions()
                    self._sweep_preemptions()
                    self._sweep_stale_preempt_files()
                    self._forward_profile_requests()
                    self._forward_preempt_requests()
                    self._ingest_live_trace_spans()
                    self._sync_sched_hints()
            except state_resilient.StoreOutageError:
                logger.warning(
                    "store outage: coordination sweeps skipped "
                    "this beat")
            except Exception:
                logger.exception("heartbeat iteration failed; "
                                 "continuing")
        # Graceful abdication: release any held sweep leases so the
        # successor acquires immediately instead of waiting out the
        # expiry. A simulated crash (_abandoned) must NOT release —
        # a real dead process couldn't, and the failover-by-expiry
        # path is exactly what the partition drill exercises.
        if not self._abandoned:
            for lease in self._sweep_leases.values():
                try:
                    lease.release()
                except Exception:  # noqa: BLE001 - expiry reclaims
                    pass
        # Final state write must NOT resurrect a node entity the
        # substrate already deleted (teardown race) — _heartbeat
        # merges and tolerates a missing row. Best-effort: a store
        # failure here just leaves the row to go heartbeat-stale.
        try:
            self._heartbeat(state="offline")
        except Exception:
            logger.exception("final offline heartbeat failed")

    # --------------------------- work loop -----------------------------

    def _control_loop(self) -> None:
        pool_id, node_id = self._nid
        ctrlq = names.control_queue(pool_id, node_id)
        while not self.stop_event.is_set():
            try:
                msgs = self.store.get_messages(
                    ctrlq, max_messages=4, visibility_timeout=60.0)
            except Exception:
                # Same survival rule as the heartbeat loop: a store
                # hiccup must not permanently deafen the node to
                # control verbs (term_task, shutdown).
                logger.exception("control poll failed; retrying")
                time.sleep(self.poll_interval)
                continue
            for msg in msgs:
                try:
                    self._handle_control(json.loads(msg.payload))
                except Exception:
                    logger.exception("control message failed")
                self.store.delete_message(msg)
            if not msgs:
                time.sleep(self.poll_interval)

    def _worker_loop(self, slot: int) -> None:
        pool_id, node_id = self._nid
        shards = max(self.pool.task_queue_shards, 1)
        # Strict priority-band drain order (hi before normal before
        # lo): within each band, stagger each slot's starting shard so
        # pollers spread over the fan-out instead of convoying on
        # shard 0. A worker restarts its scan from the hi band after
        # every message, so a high-priority job overtakes any backlog
        # sitting in lower bands.
        bands = names.task_queues_by_band(pool_id, shards)
        stagger = self.identity.node_index + slot
        # Claim batch size: up to one message per node slot (capped)
        # per poll. A 1-slot node claims one at a time — exactly the
        # legacy behavior — while an 8-slot node amortizes the queue
        # round trip 8x. The cap bounds how long a surplus claim can
        # sit parked relative to its visibility window.
        claim_batch = max(
            1, min(int(self.pool.task_slots_per_node), 16))
        # Queue-shard autoscale pickup: the submitter may grow the
        # pool's shard fan-out mid-run (jobs/manager.py
        # maybe_autoscale_queue_shards, grow-only). Refresh the
        # cached count on a slow cadence and rebuild the band scan —
        # old shard names are a strict subset of the new set, so a
        # stale scan misses no in-flight message, it only under-uses
        # the new fan-out until the refresh lands.
        shards_checked = time.monotonic()
        # Idle-poll backoff for the hi/lo bands: most pools only ever
        # use priority 0, and probing three bands instead of one
        # every cycle would triple steady-state store traffic. A band
        # seen empty gets skipped for a growing number of cycles
        # (capped so a newly-submitted high-priority task waits at
        # most ~4 poll intervals before the scan sees it).
        skip = {0: 0, 2: 0}  # band index -> cycles left to skip
        streak = {0: 0, 2: 0}
        while not self.stop_event.is_set():
            # An adoption watcher owns this slot's capacity until the
            # adopted task finishes: polling for NEW work here would
            # oversubscribe the node past task_slots_per_node.
            if slot in self._adopted_slots:
                time.sleep(self.poll_interval)
                continue
            # Quarantined node: auto-drain means claim NOTHING — do
            # not even pop messages. Each pop would hide a message
            # from healthy nodes for a visibility window and churn
            # the store for the whole probation period. (The
            # per-message guard in _process_task_message stays as a
            # backstop for races across this check.)
            if self.node_quarantined():
                self._release_prefetched()
                time.sleep(self.poll_interval)
                continue
            if (time.monotonic() - shards_checked
                    >= _SHARD_REFRESH_SECONDS):
                shards_checked = time.monotonic()
                fresh = self._current_queue_shards(shards)
                if fresh > shards:
                    shards = fresh
                    bands = names.task_queues_by_band(pool_id, shards)
            # Drain the node-local prefetch before polling: surplus
            # claims from a prior batched poll are already invisible
            # to other nodes, so they must be worked first.
            msg = self._pop_prefetched()
            if msg is not None:
                stagger += 1
                self._dispatch_task_message(slot, msg)
                continue
            for b, band_queues in enumerate(bands):
                if b in skip and skip[b] > 0:
                    skip[b] -= 1
                    continue
                n = len(band_queues)
                found = False
                for k in range(n):
                    taskq = band_queues[(stagger + k) % n]
                    try:
                        msgs = self.store.get_messages(
                            taskq, max_messages=claim_batch,
                            visibility_timeout=(
                                self.claim_visibility_seconds))
                    except Exception:  # noqa: BLE001 - slot survives
                        # A transient store error on the poll path
                        # must not kill the worker slot forever.
                        logger.exception("queue poll failed; "
                                         "retrying")
                        msgs = []
                    if msgs:
                        msg = msgs[0]
                        if len(msgs) > 1:
                            with self._claim_prefetch_lock:
                                self._claim_prefetch.extend(msgs[1:])
                        found = True
                        break
                if b in skip:
                    if found:
                        streak[b] = 0
                    else:
                        streak[b] = min(streak[b] + 1, 4)
                        skip[b] = streak[b]
                if msg is not None:
                    break
            if msg is None:
                # Re-arm the idle marker if a failed launch path
                # cleared it without a task ever running (goodput:
                # idle time must not become unaccounted forever).
                with self._running_lock:
                    if (not self._goodput_busy_slots
                            and self._running_tasks == 0
                            and self._goodput_idle_since is None):
                        self._goodput_idle_since = time.time()
                time.sleep(self.poll_interval)
                continue
            stagger += 1
            self._dispatch_task_message(slot, msg)
        # Shutdown: surplus claims parked here would hide from the
        # rest of the pool until their visibility window lapsed.
        self._release_prefetched()

    def _dispatch_task_message(self, slot: int, msg) -> None:
        try:
            self._process_task_message(
                slot, json.loads(msg.payload), msg)
        except Exception:
            logger.exception("error processing task message; requeue")
            # Release this slot's goodput claim (idempotent; the
            # exception may have struck before or after the
            # claim) so idle accounting survives the crash.
            self._goodput_work_done(slot)
            try:
                self.store.update_message(msg, visibility_timeout=5.0)
            except Exception:  # noqa: BLE001 - slot must survive
                # A store error in the error handler must not
                # kill the worker slot; visibility timeout will
                # redeliver the message anyway.
                pass

    def _pop_prefetched(self):
        with self._claim_prefetch_lock:
            if self._claim_prefetch:
                return self._claim_prefetch.popleft()
        return None

    def _release_prefetched(self) -> None:
        """Hand surplus batched claims straight back (quarantine or
        shutdown): a parked message would otherwise stay invisible to
        healthy nodes for a full visibility window."""
        while True:
            msg = self._pop_prefetched()
            if msg is None:
                return
            try:
                self.store.update_message(msg, visibility_timeout=0.0)
            except Exception:  # noqa: BLE001 - expiry redelivers
                pass

    def _current_queue_shards(self, fallback: int) -> int:
        """The pool's current task-queue shard count via the jobs
        manager's TTL cache (one pool-entity read per TTL across
        every slot on the node)."""
        try:
            from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
            return max(int(jobs_mgr.pool_queue_shards(
                self.store, self.identity.pool_id)), 1)
        except Exception:  # noqa: BLE001 - scan keeps old fan-out
            return fallback

    def _handle_control(self, control: dict) -> None:
        kind = control.get("type")
        if kind == "shutdown":
            self.stop_event.set()
        elif kind == "job_release":
            self._run_job_release(control["job_id"])
        elif kind == "load_images":
            self._image_manifest_cache.clear()
            if self._image_provisioner is not None:
                self._image_provisioner(
                    self, control.get("images", []),
                    kind=control.get("kind", "docker"))
        elif kind == "cleanup_mi":
            self._cleanup_mi_containers()
        elif kind == "upload_logs":
            self._upload_node_logs()
        elif kind == "install_ssh_key":
            self._install_ssh_key(control.get("username", "shipyard"),
                                  control.get("public_key", ""))
        elif kind == "remove_ssh_user":
            self._remove_ssh_user(control.get("username", "shipyard"))
        elif kind == "term_task":
            self._terminate_running_task(control["job_id"],
                                         control["task_id"])
        elif kind in ("ps", "zap", "prune"):
            # A verb that outlived its caller's wait must not execute:
            # a zap landing minutes after the operator saw "offline"
            # would kill tasks nobody asked about anymore (the reply
            # would also never be read — skip writing it).
            expires_at = control.get("expires_at")
            if expires_at is not None and time.time() > expires_at:
                logger.warning("dropping expired %s control "
                               "(%.0fs past deadline)", kind,
                               time.time() - expires_at)
                return
            if kind == "ps":
                self._control_reply(control, self._ps_report())
            elif kind == "zap":
                self._control_reply(control, self._zap())
            else:
                self._control_reply(control, self._prune_images())

    def _control_reply(self, control: dict, payload: dict) -> None:
        """Write a request/reply control verb's result to the object
        store under the caller-supplied reply key (pool/manager.py
        send_control_and_wait polls it). Fire-and-forget when the
        caller did not ask for a reply."""
        reply_key = control.get("reply_key")
        if not reply_key:
            return
        payload = dict(payload,
                       node_id=self.identity.node_id,
                       replied_at=util.datetime_utcnow_iso())
        self.store.put_object(reply_key,
                              json.dumps(payload).encode())

    def _ps_report(self) -> dict:
        """Live task/container inventory (pool nodes ps analog:
        reference docker-ps-over-ssh, convoy/fleet.py:2468 — here the
        agent answers directly over the control channel, no ssh)."""
        import shutil as shutil_mod
        tasks = []
        for (job_id, task_id), proc in list(self._live_procs.items()):
            entry = {"job_id": job_id, "task_id": task_id,
                     "pid": getattr(proc, "pid", None)}
            tasks.append(entry)
        report = {"running_tasks": tasks,
                  "task_slots": self.pool.task_slots_per_node}
        if shutil_mod.which("docker"):
            rc, out, _err = util.subprocess_capture(
                ["docker", "ps", "--filter", "name=shipyard-",
                 "--format", "{{.Names}}\t{{.Image}}\t{{.Status}}"])
            if rc == 0:
                report["containers"] = [
                    dict(zip(("name", "image", "status"),
                             line.split("\t")))
                    for line in out.splitlines() if line.strip()]
        return report

    def _zap(self) -> dict:
        """Kill every live task process group and running shipyard
        container (pool nodes zap analog, reference
        shipyard.py:1906)."""
        import shutil as shutil_mod
        import signal as signal_mod
        import subprocess as subprocess_mod
        killed = []
        for (job_id, task_id), proc in list(self._live_procs.items()):
            try:
                os.killpg(os.getpgid(proc.pid), signal_mod.SIGKILL)
                killed.append({"job_id": job_id, "task_id": task_id})
            except (ProcessLookupError, PermissionError, OSError):
                pass
        containers = []
        if shutil_mod.which("docker"):
            rc, out, _err = util.subprocess_capture(
                ["docker", "ps", "--filter", "name=shipyard-",
                 "--format", "{{.Names}}"])
            for name in (out.split() if rc == 0 else []):
                subprocess_mod.call(
                    ["docker", "kill", name],
                    stdout=subprocess_mod.DEVNULL,
                    stderr=subprocess_mod.DEVNULL)
                containers.append(name)
        return {"killed_tasks": killed, "killed_containers": containers}

    def _prune_images(self) -> dict:
        """Remove cached image tarballs whose image left the pool's
        global-resources manifest, plus `docker image prune` when
        docker is present (pool nodes prune analog, reference
        shipyard.py:1919 — TPU-native: the cascade direct-download
        cache is this node's image store when docker is absent)."""
        import shutil as shutil_mod
        import subprocess as subprocess_mod
        removed: list[str] = []
        freed = 0
        prov = self._image_provisioner
        cache_dir = getattr(prov, "_cache_dir", None)
        if prov is not None and cache_dir and os.path.isdir(cache_dir):
            keep = set()
            for row in self.store.query_entities(
                    names.TABLE_IMAGES,
                    partition_key=self.identity.pool_id):
                blob = row.get("source_blob") or ""
                if blob:
                    keep.add(os.path.basename(blob))
                    keep.add(os.path.basename(blob) + ".sif")
            for fname in os.listdir(cache_dir):
                if fname.endswith(".part") or fname in keep:
                    continue
                path = os.path.join(cache_dir, fname)
                try:
                    freed += os.path.getsize(path)
                    os.remove(path)
                    removed.append(fname)
                except OSError:
                    pass
        report = {"removed_cached": sorted(removed),
                  "freed_bytes": freed}
        if shutil_mod.which("docker"):
            rc = subprocess_mod.call(
                ["docker", "image", "prune", "-f"],
                stdout=subprocess_mod.DEVNULL,
                stderr=subprocess_mod.DEVNULL)
            report["docker_prune_rc"] = rc
        return report

    # ------------------------ task processing --------------------------

    def _task_entity(self, job_id: str, task_id: str) -> dict:
        return self.store.get_entity(
            names.TABLE_TASKS, names.task_pk(self.identity.pool_id, job_id),
            task_id)

    def _merge_task(self, job_id: str, task_id: str, patch: dict,
                    if_match: Optional[str] = None) -> str:
        return self.store.merge_entity(
            names.TABLE_TASKS, names.task_pk(self.identity.pool_id, job_id),
            task_id, patch, if_match=if_match)

    def _deps_status(self, job_id: str, spec: dict) -> str:
        """'ready' | 'wait' | 'blocked' per depends_on semantics
        (reference: batch.py:4177-4242 + exit_conditions
        dependency_action)."""
        deps = list(spec.get("depends_on", []))
        rng = spec.get("depends_on_range")
        if rng:
            deps.extend(str(i) for i in range(rng[0], rng[1] + 1))
        for dep in deps:
            try:
                ent = self._task_entity(job_id, dep)
            except NotFoundError:
                return "wait"
            state = ent.get("state")
            if state == "completed":
                continue
            if state in ("failed", "blocked",
                         names.TASK_STATE_QUARANTINED):
                dep_action = (ent.get("spec", {}).get("exit_options", {})
                              .get("dependency_action", "block"))
                if dep_action == "satisfy":
                    continue
                return "blocked"
            return "wait"
        return "ready"

    def _process_task_message(self, slot: int, payload: dict,
                              msg) -> None:
        job_id = payload["job_id"]
        task_id = payload["task_id"]
        instance = payload.get("instance")
        try:
            entity = self._task_entity(job_id, task_id)
        except NotFoundError:
            self.store.delete_message(msg)
            return
        if entity.get("state") in names.TERMINAL_TASK_STATES:
            self.store.delete_message(msg)
            return
        # Disabled jobs keep their tasks queued but unscheduled
        # (jobs disable --requeue semantics).
        job_state = self._cached_job_state(job_id)
        if job_state == "disabled":
            self.store.update_message(msg, visibility_timeout=5.0)
            return
        if job_state in ("terminated", "deleted"):
            self.store.delete_message(msg)
            return
        spec = entity["spec"]
        # Node-pinned task (federation required-target select): only
        # the named node may claim it. Everyone else makes the message
        # immediately visible again and backs off THEIR OWN polling —
        # re-hiding it for seconds would let a fast non-pinned poller
        # starve the pinned node of visibility windows.
        required = spec.get("required_node")
        if required and required != self.identity.node_id:
            # Hide only for one poll interval: long hides starve the
            # pinned node of visibility windows, while zero-hide plus
            # an in-handler sleep would park worker slots on the
            # queue-head pinned message instead of the work behind it.
            self.store.update_message(
                msg, visibility_timeout=self.poll_interval)
            return
        # Retry-supervisor backoff: a requeued task is not claimable
        # before its not_before. The requeue message already carries
        # the delay; this guards redelivered older copies of the
        # message from defeating the backoff.
        not_before = entity.get("not_before")
        if not_before and time.time() < float(not_before):
            self.store.update_message(
                msg, visibility_timeout=min(
                    5.0, max(0.1, float(not_before) - time.time())))
            return
        # Quarantined node: auto-drain. Make the message promptly
        # visible for healthy nodes and claim nothing new.
        if self.node_quarantined():
            self.store.update_message(
                msg, visibility_timeout=self.poll_interval)
            time.sleep(self.poll_interval)
            return
        # Warm-cache affinity window (shared sched/policy.py, the
        # same functions the fleet simulator prices): when this claim
        # would pay a material expected-badput cost — cold persistent
        # compile cache for the task's declared identity, degraded
        # health, recent failures — and the task is still YOUNG, hand
        # the message back briefly so a warm/healthy node can claim
        # it. Past the affinity window any node claims: deferral
        # trades bounded queueing badput for compile badput, never
        # starvation.
        if self._claim_scoring and self._should_defer_claim(entity,
                                                            spec):
            self.store.update_message(
                msg, visibility_timeout=max(0.5, min(
                    5.0,
                    self._policy_knobs.claim_affinity_wait_seconds
                    / 4.0)))
            return
        deps = self._deps_status(job_id, spec)
        if deps == "blocked":
            try:
                self._merge_task(job_id, task_id, {"state": "blocked"},
                                 if_match=entity["_etag"])
            except (EtagMismatchError, NotFoundError):
                pass
            self.store.delete_message(msg)
            return
        if deps == "wait":
            self.store.update_message(msg, visibility_timeout=1.0)
            return
        # Dead-node recovery: a redelivered message whose task is still
        # assigned/running on a node with a stale heartbeat means that
        # node died mid-task — reclaim it (the responsibility Azure
        # Batch's hosted agent handled for the reference).
        entity = self._maybe_reclaim_orphan(job_id, task_id, entity)
        if entity is None:
            self.store.update_message(msg, visibility_timeout=10.0)
            return
        if instance is None:
            self._run_regular_task(slot, job_id, task_id, entity, msg)
        else:
            self._run_gang_instance(
                slot, job_id, task_id, entity, instance, msg)

    def _should_defer_claim(self, entity: dict, spec: dict) -> bool:
        """Price THIS node's claim with the shared scoring policy and
        ask the shared affinity-window rule whether to hand the task
        back. Identical decision code to the fleet simulator's claim
        path — a simulated affinity delta is evidence about this
        function's behavior in production."""
        identity = spec.get("compile_cache_identity")
        warm = bool(identity) and identity in cc_manager.\
            list_identity_dirs(self._compile_cache_dir())
        with self._health_lock:
            health = self._health
            failures = self._recent_failures
        score = sched_policy.claim_score(
            warm=warm, health=health, recent_failures=failures,
            has_identity=bool(identity), knobs=self._policy_knobs)
        since = goodput_events.iso_to_epoch(
            entity.get("requeued_at") or entity.get("submitted_at"))
        queued = 0.0 if since is None else max(0.0,
                                               time.time() - since)
        return sched_policy.should_defer_claim(
            score, queued, knobs=self._policy_knobs)

    def _cached_job_state(self, job_id: str) -> Optional[str]:
        return self._cached_job(job_id)[0]

    def _cached_job_profile_request(self,
                                    job_id: str) -> Optional[dict]:
        """The job's pending on-demand profile request (or None);
        rides the same short-TTL cache as the disabled/terminated
        check so the heartbeat forwarding loop costs no extra store
        round trips."""
        return self._cached_job(job_id)[1]

    def _cached_job(self, job_id: str) -> tuple:
        now = time.monotonic()
        cached = self._job_state_cache.get(job_id)
        if cached is not None and now - cached[-1] < self._job_state_ttl:
            return cached
        try:
            job = self.store.get_entity(
                names.TABLE_JOBS, self.identity.pool_id, job_id)
            state = job.get("state")
            profile = job.get(trace_profiling.COL_PROFILE_REQUEST)
            if not isinstance(profile, dict):
                profile = None
        except NotFoundError:
            state = None
            profile = None
        self._job_state_cache[job_id] = (state, profile, now)
        return self._job_state_cache[job_id]

    def _maybe_reclaim_orphan(self, job_id: str, task_id: str,
                              entity: dict) -> Optional[dict]:
        """Return a claimable entity, resetting orphans to pending.

        None means the task is legitimately held by a live node (or we
        lost a reset race); the caller should back off.
        """
        state = entity.get("state")
        owner = entity.get("node_id")
        if state not in ("assigned", "running") or not owner:
            return entity
        if owner == self.identity.node_id:
            if (job_id, task_id) in self._live_procs:
                # Crash-restart ADOPTION (not reclaim): the restarted
                # agent found the pre-crash process still running and
                # adopted it (slot ledger, _adopt_restart_state).
                # Resetting here would double-run the task under its
                # own feet — back off; the adoption watcher owns the
                # completion, and the redelivered message dies on the
                # terminal-state check afterwards.
                return None
            # Our own pre-crash claim with NO surviving process:
            # take it back (the pre-adoption restart semantics).
        else:
            if self._node_alive(owner):
                return None
        logger.warning(
            "task %s/%s orphaned by %s; resetting to pending",
            job_id, task_id, owner)
        try:
            self._merge_task(
                job_id, task_id,
                {"state": "pending", "node_id": None,
                 # Queue-time accounting restarts here: the dead
                 # node's runtime is not queueing badput.
                 "requeued_at": util.datetime_utcnow_iso()},
                if_match=entity["_etag"])
        except (EtagMismatchError, NotFoundError):
            return None
        return self._task_entity(job_id, task_id)

    def _message_keepalive(self, msg, interval: Optional[float] = None,
                           visibility: Optional[float] = None):
        """Keep a claimed queue message invisible while work runs.

        Without this, a task running past the visibility timeout gets
        redelivered and double-executed (on this node if it has spare
        slots, or on another via the orphan-reclaim path). The window
        follows claim_visibility_seconds: it is also the FLOOR on
        crashed-node recovery latency (a dead node's claimed message
        only redelivers when its window lapses), which is why chaos
        drills and tests shrink it."""
        if visibility is None:
            visibility = self.claim_visibility_seconds
        if interval is None:
            interval = max(0.5, visibility / 3.0)
        stop = threading.Event()

        def _renew() -> None:
            while not stop.wait(interval):
                if self._abandoned:
                    # Simulated agent death: a dead process renews
                    # nothing — the claim must lapse so observers see
                    # the truth (the adoption watcher keeps the task,
                    # not the message).
                    return
                try:
                    self.store.update_message(
                        msg, visibility_timeout=visibility)
                except Exception:
                    return

        thread = threading.Thread(target=_renew, daemon=True)
        thread.start()

        class _Guard:
            def __enter__(self_inner):
                return self_inner

            def __exit__(self_inner, *exc):
                stop.set()
                thread.join(timeout=1.0)
                return False

        return _Guard()

    # ------------------------ goodput hooks ----------------------------

    def _goodput_work_started(self, slot: int, job_id: str,
                              task_id: str, entity: dict,
                              emit_queued: bool = True) -> None:
        """Close the node's open idle interval and emit the task's
        queueing span (submit -> first claim; requeue -> re-claim for
        retries) — the scheduling-leg badput of the decomposition.
        Gang instances pass emit_queued only for instance 0 so an
        8-wide gang doesn't report 8x queue time."""
        with self._running_lock:
            idle_since = self._goodput_idle_since
            self._goodput_idle_since = None
            self._goodput_busy_slots.add(slot)
        now = time.time()
        if idle_since is not None and now > idle_since:
            goodput_events.emit(
                self.store, self.identity.pool_id,
                goodput_events.NODE_IDLE,
                node_id=self.identity.node_id,
                start=idle_since, end=now)
        ctx = trace_context.TraceContext.from_entity(entity)
        # Claim marker: instantaneous, but it pins WHICH node won the
        # claim (and when) on the submission's causal chain.
        trace_spans.emit(
            self.store, self.identity.pool_id, trace_spans.SPAN_CLAIM,
            ctx, job_id=job_id, task_id=task_id,
            node_id=self.identity.node_id,
            attrs={"retries": entity.get("retries", 0)})
        if not emit_queued:
            return
        # A retried task waited since its REQUEUE, not its original
        # submit — the first attempt's runtime is not queue time.
        submitted = goodput_events.iso_to_epoch(
            entity.get("requeued_at") or entity.get("submitted_at"))
        if submitted is not None and now > submitted:
            goodput_events.emit(
                self.store, self.identity.pool_id,
                goodput_events.TASK_QUEUED, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id,
                start=submitted, end=now,
                attrs={"retries": entity.get("retries", 0)},
                trace_id=entity.get(trace_context.COL_TRACE_ID),
                span_id=entity.get(trace_context.COL_TRACE_SPAN))
            trace_spans.emit(
                self.store, self.identity.pool_id,
                trace_spans.SPAN_QUEUE_WAIT, ctx, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id,
                start=submitted, end=now,
                attrs={"retries": entity.get("retries", 0)})
        # Retry supervisor's deliberate backoff wait: priced on claim
        # (never at requeue — that would future-date the interval).
        # The window [requeue, not_before] sits inside the queue span
        # above; backoff outranks queueing in the overlap sweep, so
        # the deliberate wait lands in its own category without
        # double counting. A task terminated mid-backoff simply never
        # re-claims, and no unelapsed second is ever charged.
        not_before = entity.get("not_before")
        if (submitted is not None and not_before
                and entity.get("requeued_at")):
            end = min(float(not_before), now)
            if end > submitted:
                goodput_events.emit(
                    self.store, self.identity.pool_id,
                    goodput_events.TASK_BACKOFF, job_id=job_id,
                    task_id=task_id, node_id=self.identity.node_id,
                    start=submitted, end=end,
                    attrs={"retries": entity.get("retries", 0),
                           "delay_seconds": end - submitted},
                    trace_id=entity.get(trace_context.COL_TRACE_ID),
                    span_id=entity.get(trace_context.COL_TRACE_SPAN))
                trace_spans.emit(
                    self.store, self.identity.pool_id,
                    trace_spans.SPAN_BACKOFF_WAIT, ctx,
                    job_id=job_id, task_id=task_id,
                    node_id=self.identity.node_id,
                    start=submitted, end=end,
                    attrs={"retries": entity.get("retries", 0)})
        # Preemption-recovery interval: preempted exit -> this claim.
        # Priced once per preemption (the claim patch clears
        # preempted_at; gang width dedup rides the emit_queued flag,
        # so an 8-wide gang reports the leg once). This is the badput
        # every preemption actually costs — the drill's
        # "preemption_recovery now populated" acceptance.
        preempted_at = entity.get(names.TASK_COL_PREEMPTED_AT)
        if preempted_at and now > float(preempted_at):
            goodput_events.emit(
                self.store, self.identity.pool_id,
                goodput_events.TASK_PREEMPT_RECOVERY, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id,
                start=float(preempted_at), end=now,
                attrs={"preempt_count": entity.get(
                    names.TASK_COL_PREEMPT_COUNT, 0)},
                trace_id=entity.get(trace_context.COL_TRACE_ID),
                span_id=entity.get(trace_context.COL_TRACE_SPAN))
        # Eviction-recovery interval: hard-killed exit -> this claim,
        # priced as the distinct `eviction` leg (same claim-side,
        # once-per-eviction protocol as the preemption leg above).
        evicted_at = entity.get(names.TASK_COL_EVICTED_AT)
        if evicted_at and now > float(evicted_at):
            goodput_events.emit(
                self.store, self.identity.pool_id,
                goodput_events.TASK_EVICTION_RECOVERY, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id,
                start=float(evicted_at), end=now,
                attrs={"evict_count": entity.get(
                    names.TASK_COL_EVICT_COUNT, 0)},
                trace_id=entity.get(trace_context.COL_TRACE_ID),
                span_id=entity.get(trace_context.COL_TRACE_SPAN))

    def _ensure_images_timed(self, job_id: str, task_id: str,
                             spec: dict,
                             entity: Optional[dict] = None) -> None:
        """_ensure_images under an image_pull goodput span (only when
        the task actually names a container image)."""
        if spec.get("image") and spec.get("runtime") in (
                "docker", "singularity"):
            entity = entity or {}
            with goodput_events.span(
                    self.store, self.identity.pool_id,
                    goodput_events.TASK_IMAGE_PULL, job_id=job_id,
                    task_id=task_id, node_id=self.identity.node_id,
                    attrs={"image": spec.get("image")},
                    trace_id=entity.get(trace_context.COL_TRACE_ID),
                    span_id=entity.get(trace_context.COL_TRACE_SPAN)):
                self._ensure_images(spec)
        else:
            self._ensure_images(spec)

    def _goodput_task_finished(self, slot: int, job_id: str,
                               task_id: str,
                               result: task_runner.TaskResult,
                               entity: Optional[dict] = None,
                               instance: Optional[int] = None) -> None:
        entity = entity or {}
        started = goodput_events.iso_to_epoch(result.started_at)
        if started is not None and result.wall_seconds > 0:
            goodput_events.emit(
                self.store, self.identity.pool_id,
                goodput_events.TASK_RUNNING, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id,
                start=started, end=started + result.wall_seconds,
                attrs={"exit_code": result.exit_code,
                       "timed_out": result.timed_out},
                trace_id=entity.get(trace_context.COL_TRACE_ID),
                span_id=entity.get(trace_context.COL_TRACE_SPAN))
            # The task's ROOT span (the id every program phase inside
            # the process parented under via $SHIPYARD_TRACE_SPAN_ID)
            # is recorded as the run span itself: launch -> exit.
            # Gang instances share the root id; only instance 0
            # writes it (one row), the rest annotate via attrs on
            # their own child spans.
            ctx = trace_context.TraceContext.from_entity(entity)
            if ctx is not None and (instance is None or instance == 0):
                trace_spans.emit(
                    self.store, self.identity.pool_id,
                    trace_spans.SPAN_TASK_RUN, ctx, job_id=job_id,
                    task_id=task_id, node_id=self.identity.node_id,
                    start=started, end=started + result.wall_seconds,
                    attrs={"exit_code": result.exit_code,
                           "wedged": result.wedged,
                           "retries": entity.get("retries", 0)},
                    self_span=True)
        self._goodput_work_done(slot)

    def _goodput_work_done(self, slot: int) -> None:
        """Release a slot's claimed-work unit (idempotent — safe to
        call from exception handlers that can't know whether the
        claim happened); re-arm the idle marker once the node has
        NOTHING claimed or running."""
        with self._running_lock:
            self._goodput_busy_slots.discard(slot)
            if (not self._goodput_busy_slots
                    and self._running_tasks == 0
                    and self._goodput_idle_since is None):
                self._goodput_idle_since = time.time()

    def _ingest_goodput(self, job_id: str, task_id: str,
                        execution: task_runner.TaskExecution) -> None:
        """Fold the task's process-local program-phase events (compile
        / step windows / checkpoint spans the workload recorded to
        $SHIPYARD_GOODPUT_FILE) into the store with the task's
        identity attached."""
        path = execution.env.get(goodput_events.GOODPUT_FILE_ENV)
        if path:
            count = goodput_events.ingest_local_events(
                self.store, self.identity.pool_id, path, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id)
            if count:
                logger.debug("ingested %d goodput events from %s/%s",
                             count, job_id, task_id)
        # Trace spans ride the same post-task ingest: program spans
        # the workload recorded to $SHIPYARD_TRACE_FILE join the
        # submission's trace in TABLE_TRACE. Rename-first (the same
        # protocol as the heartbeat drain) so a drain racing this
        # exit path can never ingest the same lines twice — exactly
        # one reader wins any given inode.
        trace_path = execution.env.get(trace_context.TRACE_FILE_ENV)
        if trace_path:
            count = self._drain_trace_file(trace_path, job_id,
                                           task_id)
            if count:
                logger.debug("ingested %d trace spans from %s/%s",
                             count, job_id, task_id)

    def _drain_trace_file(self, path: str, job_id: str,
                          task_id: str) -> int:
        """Atomically claim and ingest one trace-span JSONL. The
        os.replace is the mutual exclusion between the heartbeat
        drain and the post-task ingest: a loser gets ENOENT and
        ingests nothing; a writer mid-append follows the inode into
        the renamed file (still ingested), and the recorder's next
        append re-creates the original path."""
        if not os.path.exists(path):
            return 0
        drained = f"{path}.{uuid.uuid4().hex[:6]}.ingest"
        try:
            os.replace(path, drained)
        except OSError:
            return 0
        return trace_spans.ingest_local_spans(
            self.store, self.identity.pool_id, drained,
            job_id=job_id, task_id=task_id,
            node_id=self.identity.node_id)

    def _ingest_live_trace_spans(self) -> None:
        """Drain LIVE tasks' trace-span JSONL mid-run, so long-lived
        serving tasks feed heimdall's latency export while running
        instead of only at exit. The drain is an atomic rename: a
        writer mid-append follows the inode into the renamed file
        (still ingested), and the recorder's next append re-creates
        the original path — no line is ever lost or read twice."""
        for job_id, task_id in list(self._live_procs.keys()):
            root = os.path.join(self.work_dir, "tasks", job_id,
                                task_id)
            candidates = [os.path.join(root, "trace_spans.jsonl")]
            try:
                candidates += [
                    os.path.join(root, d, "trace_spans.jsonl")
                    for d in os.listdir(root) if d.startswith("i")]
            except OSError:
                continue
            for path in candidates:
                self._drain_trace_file(path, job_id, task_id)

    def _sync_sched_hints(self) -> None:
        """Mirror LIVE tasks' sched-hints files
        (agent/progress.py record_sched_hints) into their task rows'
        sched_hints column, where the preemption sweep's shared
        victim-cost policy prices replay rework. Advisory and cheap:
        one local read per live task per beat, a store write only
        when the hints CHANGED (a step-cadenced writer is throttled
        by content, not another timer). For a gang, the instance
        with the highest step wins — rework is priced by the
        furthest-ahead shard that would replay."""
        for job_id, task_id in list(self._live_procs.keys()):
            root = os.path.join(self.work_dir, "tasks", job_id,
                                task_id)
            candidates = [os.path.join(root, "sched_hints.json")]
            try:
                candidates += [
                    os.path.join(root, d, "sched_hints.json")
                    for d in os.listdir(root) if d.startswith("i")]
            except OSError:
                continue
            best: Optional[dict] = None
            for path in candidates:
                hints = progress_mod.read_sched_hints(path)
                if hints is None:
                    continue
                if best is None or (hints.get("step") or 0) > \
                        (best.get("step") or 0):
                    best = hints
            if best is None:
                continue
            fingerprint = json.dumps(best, sort_keys=True)
            key = (job_id, task_id)
            if self._sched_hints_sent.get(key) == fingerprint:
                continue
            try:
                self._merge_task(job_id, task_id,
                                 {names.TASK_COL_SCHED_HINTS: best})
                self._sched_hints_sent[key] = fingerprint
            except (NotFoundError, EtagMismatchError):
                continue

    # ----------------------- profiling hooks ---------------------------

    def _forward_profile_requests(self) -> None:
        """On-demand profiling, mid-run leg: the heartbeat loop drops
        the job's pending profile request into the task dirs of this
        node's LIVE tasks (launch-time delivery covers tasks that
        start after the flag was set). One delivery per (task,
        request): the harness consumes the file when capture starts,
        and re-dropping it would trigger a second capture."""
        for job_id, task_id in list(self._live_procs.keys()):
            request = self._cached_job_profile_request(job_id)
            if request is None:
                continue
            self._deliver_profile_request(job_id, task_id, request)

    def _deliver_profile_request(self, job_id: str, task_id: str,
                                 request: dict) -> None:
        for task_dir in self._task_dir_targets(job_id, task_id):
            self._deliver_profile_file(
                os.path.join(task_dir, "profile_request.json"),
                request)

    def _deliver_profile_file(self, path: str,
                              request: dict) -> None:
        """Write one request file, deduped per (path, request). The
        delivered mark is taken only AFTER a successful write, so a
        transient OSError retries on the next heartbeat instead of
        silently losing the request forever. A sibling ``.delivered``
        marker persists the dedup across agent restarts — without it
        a restarted agent would re-drop a request the harness already
        consumed and trigger a second capture."""
        requested_at = str(request.get("requested_at"))
        key = (path, requested_at)
        if key in self._profile_delivered:
            return
        marker = path + ".delivered"
        try:
            with open(marker, encoding="utf-8") as fh:
                if fh.read().strip() == requested_at:
                    self._profile_delivered.add(key)
                    return
        except OSError:
            pass
        try:
            steps = max(1, int(request.get("steps", 1)))
        except (TypeError, ValueError):
            steps = 1
        try:
            trace_profiling.write_request(
                path, steps,
                requested_at=request.get("requested_at"))
            with open(marker, "w", encoding="utf-8") as fh:
                fh.write(requested_at)
        except OSError:
            logger.debug("profile request delivery failed for %s",
                         path, exc_info=True)
            return
        # Bound the in-memory set (the disk markers keep the dedup):
        # a long-lived agent across many `jobs profile` invocations
        # must not grow it forever.
        if len(self._profile_delivered) > 4096:
            self._profile_delivered.clear()
        self._profile_delivered.add(key)

    def _upload_profile_artifacts(self, job_id: str, task_id: str,
                                  execution: task_runner.TaskExecution,
                                  suffix: str = "") -> None:
        """Post-task: ship the torch.profiler capture (if one was
        taken) through the store next to the task's other outputs and
        stamp the artifact prefix on the task entity, where
        ``jobs tasks list`` surfaces it."""
        profile_dir = execution.env.get(
            trace_profiling.PROFILE_DIR_ENV)
        if not profile_dir or not os.path.isdir(profile_dir):
            return
        uploaded = 0
        prefix = f"{suffix}/profile" if suffix else "profile"
        for root, _dirs, files in os.walk(profile_dir):
            for name in files:
                path = os.path.join(root, name)
                rel = os.path.relpath(path, profile_dir)
                try:
                    with open(path, "rb") as fh:
                        self.store.put_object(
                            names.task_output_key(
                                self.identity.pool_id, job_id,
                                task_id, f"{prefix}/{rel}"),
                            fh.read())
                    uploaded += 1
                except Exception:  # noqa: BLE001 - best effort
                    logger.exception("profile artifact upload failed "
                                     "for %s", path)
        if not uploaded:
            return
        try:
            self._merge_task(job_id, task_id, {
                trace_profiling.COL_PROFILE_ARTIFACT:
                    names.task_output_key(
                        self.identity.pool_id, job_id, task_id,
                        prefix),
                "profile_files": uploaded,
            })
        except NotFoundError:
            pass
        logger.info("uploaded %d profile file(s) for %s/%s",
                    uploaded, job_id, task_id)

    # ---------------------- preemption scheduling ----------------------

    def _sweep_preemptions(self) -> None:
        """Numeric-priority preemption sweep (leader-gated, like the
        gang janitor — one unpartitioned task scan per pool per
        interval). A pending task that has waited past the grace
        window while STRICTLY lower-priority work runs cannot place:
        the sweep elects the lowest-priority running victim (gangs
        included — one stamped entity preempts every instance) and
        stamps a cooperative preempt request on it. The victim's
        agent delivers the request over the heartbeat path, the
        workload drains to a step boundary, commits, and exits
        EXIT_PREEMPTED — requeued at full budget. One victim per
        starved task per sweep: cooperative preemption converges over
        sweeps instead of mass-evicting a pool in one pass.

        ESCALATION (the same scan): a victim whose pending request is
        older than preempt_grace_seconds never drained — the sweep
        stamps the request escalated, and the owning node's heartbeat
        loop hard-kills the process (_enforce_eviction). The exit is
        then classified `evicted`: claimable at full budget like
        `preempted`, but resuming from the last COMMITTED checkpoint
        BEFORE the notice, and priced as the distinct `eviction`
        badput leg."""
        if self.preempt_sweep_interval <= 0:
            return
        if (time.monotonic() - self._last_preempt_sweep
                < self.preempt_sweep_interval):
            return
        self._last_preempt_sweep = time.monotonic()
        epoch = self._sweep_leader_epoch(
            state_leases.ROLE_PREEMPT_SWEEP)
        if epoch is None:
            return
        lease = self._sweep_lease(state_leases.ROLE_PREEMPT_SWEEP)
        prefix = f"{self.identity.pool_id}$"
        now = time.time()
        starved: list[tuple] = []   # (priority, waited_since, row)
        victims: list[tuple] = []   # (priority, row)
        for row in self.store.query_entities(names.TABLE_TASKS):
            if not row["_pk"].startswith(prefix):
                continue
            state = row.get("state")
            priority = int(
                (row.get("spec") or {}).get("priority", 0) or 0)
            if state in names.CLAIMABLE_TASK_STATES:
                not_before = row.get("not_before")
                if not_before and now < float(not_before):
                    continue  # deliberate backoff, not starvation
                since = goodput_events.iso_to_epoch(
                    row.get("requeued_at") or row.get("submitted_at"))
                if since is None or \
                        now - since < self.preempt_grace_seconds:
                    continue
                starved.append((priority, since, row))
            elif state in ("assigned", "running"):
                request = row.get(names.TASK_COL_PREEMPT_REQUEST)
                if isinstance(request, dict):
                    # Already draining — unless the notice lapsed, in
                    # which case the ladder's next rung fires: stamp
                    # the escalation so the owning node hard-kills.
                    # Fenced like every other sweep write.
                    if not lease.fenced(epoch):
                        return
                    self._maybe_escalate_eviction(row, request, now,
                                                  leader_epoch=epoch)
                    continue
                if request:
                    continue  # malformed stamp; never a victim twice
                # Goodput-cost victim ordering (shared
                # sched/policy.py, the functions the fleet simulator
                # prices): lowest priority first, then CHEAPEST
                # expected rework — replay steps past the last
                # committed checkpoint plus warm compile state
                # destroyed, from the sched_hints column the
                # heartbeat mirrors — then task id. Hint-less tasks
                # price 0.0, so the order degrades to the
                # deterministic (priority, task_id) tie-break instead
                # of scan order (dict/row order must never elect a
                # victim).
                cost = sched_policy.victim_cost_from_row(
                    row, knobs=self._policy_knobs)
                victims.append((sched_policy.victim_sort_key(
                    priority, cost, row["_rk"]), row))
        if not starved or not victims:
            return
        starved.sort(key=lambda t: (-t[0], t[1]))
        victims.sort(key=lambda t: t[0])
        from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
        for priority, _since, row in starved:
            if not victims or victims[0][0][0] >= priority:
                break  # nothing running is strictly lower anymore
            # Fencing re-check BEFORE each stamp (satellite audit):
            # the scan above can outlive the term, and a preemption
            # stamp is NOT idempotent across two leaders — two terms
            # electing different victims for the same starved task is
            # exactly the double-fire the partition drill forbids.
            if not lease.fenced(epoch):
                return
            victim_key, victim = victims.pop(0)
            victim_priority = victim_key[0]
            victim_job = victim["_pk"][len(prefix):]
            starved_job = row["_pk"][len(prefix):]
            stamped = jobs_mgr.request_preemption(
                self.store, self.identity.pool_id, victim_job,
                victim["_rk"],
                reason=(f"priority {priority} task "
                        f"{starved_job}/{row['_rk']} cannot place "
                        f"(victim priority {victim_priority})"),
                by_job_id=starved_job, by_task_id=row["_rk"],
                leader_epoch=epoch, defer_notice=True)
            if stamped and not lease.fenced(epoch):
                # The pre-write fence cannot bound the WRITE's own
                # latency: under store retries the merge can land
                # after our term ended, while the successor elects a
                # DIFFERENT victim for the same starved task. The
                # author is the only party that can tell "issued in
                # term E, landed late" apart from a legitimate term-E
                # stamp — so it retracts its own late stamp. The
                # notice was deferred, so the retraction leaves no
                # dangling TASK_PREEMPT_NOTICE event behind either.
                self._retract_stale_preempt_stamp(
                    victim["_pk"], victim["_rk"], epoch)
                return
            if callable(stamped):
                stamped()  # the stamp stands: publish its notice

    def _retract_stale_preempt_stamp(self, pk: str, rk: str,
                                     epoch: int) -> None:
        """Undo OUR OWN preemption stamp that landed after the term
        ended (write latency outlived the lease margin). Only a
        still-unescalated request carrying exactly our epoch is
        retracted; anything else means the world moved on."""
        try:
            row = self.store.get_entity(names.TABLE_TASKS, pk, rk)
        except Exception:  # noqa: BLE001 - stamp stays attributable
            logger.warning("could not retract stale preempt stamp "
                           "for %s/%s", pk, rk, exc_info=True)
            return
        request = row.get(names.TASK_COL_PREEMPT_REQUEST)
        if not (isinstance(request, dict)
                and request.get("leader_epoch") == epoch
                and not request.get("escalated_at")):
            return
        try:
            self.store.merge_entity(
                names.TABLE_TASKS, pk, rk,
                {names.TASK_COL_PREEMPT_REQUEST: None},
                if_match=row["_etag"])
            logger.warning(
                "retracted preempt stamp on %s/%s: it landed after "
                "leadership term %d ended", pk, rk, epoch)
        except (EtagMismatchError, NotFoundError):
            pass  # a concurrent transition owns the row now
        except Exception:  # noqa: BLE001 - best effort
            logger.warning("could not retract stale preempt stamp "
                           "for %s/%s", pk, rk, exc_info=True)

    def _forward_preempt_requests(self) -> None:
        """Heartbeat-loop delivery of pending preempt requests into
        this node's LIVE tasks' dirs (the profile-request channel):
        one short-TTL-cached entity read per live task, one file drop
        per (target, requested_at). Stale-epoch stamps are held for
        one confirmation cycle before delivery (see
        _confirm_stale_epoch_request)."""
        for job_id, task_id in list(self._live_procs.keys()):
            request = self._cached_task_preempt_request(job_id,
                                                        task_id)
            if not isinstance(request, dict):
                continue
            request = self._confirm_stale_epoch_request(
                job_id, task_id, request)
            if request is None:
                continue
            self._deliver_preempt_request(job_id, task_id, request)
            # Escalation enforcement is LOCAL: the leader stamped the
            # decision on the entity; only the node holding the live
            # process can actually kill it (gang instances each die
            # on their own node).
            if request.get("escalated_at"):
                self._enforce_eviction(job_id, task_id)

    def _maybe_escalate_eviction(self, row: dict, request: dict,
                                 now: float,
                                 leader_epoch: Optional[int] = None,
                                 ) -> None:
        """Leader-side escalation decision: a pending preempt request
        older than preempt_grace_seconds means the victim ignored its
        notice — stamp ``escalated_at`` on the request (etag-guarded,
        exactly one escalation per request) so the owning node's
        heartbeat loop hard-kills it. The stamp is what classifies
        the subsequent exit as ``evicted`` rather than a failure.
        ``leader_epoch`` (the sweep term's fencing epoch) rides the
        stamp so a deposed leader's in-flight escalation is
        attributable — and its etag merge loses cleanly to any write
        the successor landed first."""
        if request.get("escalated_at"):
            return
        requested = goodput_events.iso_to_epoch(
            request.get("requested_at"))
        if requested is None or \
                now - requested <= self.preempt_grace_seconds:
            return
        pk_parts = row["_pk"].split("$", 1)
        job_id = pk_parts[1] if len(pk_parts) == 2 else row["_pk"]
        try:
            self.store.merge_entity(
                names.TABLE_TASKS, row["_pk"], row["_rk"],
                {names.TASK_COL_PREEMPT_REQUEST: {
                    **request,
                    "escalated_at": util.datetime_utcnow_iso(),
                    "leader_epoch": leader_epoch}},
                if_match=row["_etag"])
        except (EtagMismatchError, NotFoundError):
            return  # a concurrent transition (e.g. the drain) won
        logger.warning(
            "task %s/%s ignored its preempt notice for %.1fs "
            "(grace %.1fs); escalating to forcible eviction",
            job_id, row["_rk"], now - requested,
            self.preempt_grace_seconds)

    def _enforce_eviction(self, job_id: str, task_id: str) -> None:
        """Hard-kill an escalated victim's live process group on THIS
        node: docker containers are force-removed first (SIGKILL is
        never proxied by the docker client — the task_runner wedge
        lesson), then the group eats SIGKILL. The local marker makes
        the completion path classify the exit as evicted."""
        key = (job_id, task_id)
        proc = self._live_procs.get(key)
        if proc is None or key in self._evicted_locally:
            return
        self._evicted_locally.add(key)
        logger.warning("evicting %s/%s: hard kill after ignored "
                       "preempt notice", job_id, task_id)
        self._hard_kill_task_group(job_id, task_id, proc.pid)

    def _sweep_stale_preempt_files(self) -> None:
        """Per-node janitor for stale preempt-request files: an
        EVICTED (never-drained) task's request file + .delivered
        marker are only cleaned at next-attempt launch on the same
        node — a node that never reclaims the task would leak them
        forever (and its in-memory dedup key with them). Sweep this
        node's task dirs on the gang-janitor cadence: any request
        file whose task is not live here and no longer pending a
        request (terminal, gone, re-owned, or already re-requested
        under a newer requested_at) is garbage."""
        if (time.monotonic() - self._last_preempt_file_sweep
                < self.gang_sweep_interval):
            return
        self._last_preempt_file_sweep = time.monotonic()
        root = os.path.join(self.work_dir, "tasks")
        if not os.path.isdir(root):
            return
        for job_id in os.listdir(root):
            job_dir = os.path.join(root, job_id)
            if not os.path.isdir(job_dir):
                continue
            for task_id in os.listdir(job_dir):
                if (job_id, task_id) in self._live_procs:
                    continue  # delivery may still be in flight
                targets = self._task_dir_targets(job_id, task_id)
                paths = [os.path.join(d, "preempt_request.json")
                         for d in targets]
                if not any(os.path.exists(p) or
                           os.path.exists(p + ".delivered")
                           for p in paths):
                    continue
                try:
                    entity = self._task_entity(job_id, task_id)
                    pending = entity.get(
                        names.TASK_COL_PREEMPT_REQUEST)
                    stale = (
                        entity.get("state")
                        in names.TERMINAL_TASK_STATES
                        or entity.get("node_id")
                        != self.identity.node_id
                        or not isinstance(pending, dict))
                except NotFoundError:
                    stale = True
                except Exception:  # noqa: BLE001 - janitor survives
                    logger.debug("preempt-file sweep probe failed",
                                 exc_info=True)
                    continue
                if not stale:
                    continue
                for path in paths:
                    for victim in (path, path + ".delivered"):
                        try:
                            os.remove(victim)
                        except OSError:
                            pass
                    self._preempt_delivered = {
                        k for k in self._preempt_delivered
                        if k[0] != path}

    def _cached_task_preempt_request(self, job_id: str,
                                     task_id: str) -> Optional[dict]:
        """The task's pending preempt request (or None), cached for
        _job_state_ttl so the common no-preemption case costs no
        store round trip per live task per beat."""
        key = (job_id, task_id)
        now = time.monotonic()
        cached = self._task_preempt_cache.get(key)
        if cached is not None and now - cached[1] < self._job_state_ttl:
            return cached[0]
        request = None
        try:
            entity = self._task_entity(job_id, task_id)
            request = entity.get(names.TASK_COL_PREEMPT_REQUEST)
        except NotFoundError:
            pass
        except Exception:  # noqa: BLE001 - heartbeat survives
            logger.debug("preempt forward probe failed",
                         exc_info=True)
            return None  # transient: do not cache, retry next beat
        if len(self._task_preempt_cache) > 256:
            self._task_preempt_cache.clear()
        self._task_preempt_cache[key] = (request, now)
        return request

    def _confirm_stale_epoch_request(self, job_id: str, task_id: str,
                                     request: dict
                                     ) -> Optional[dict]:
        """Consumer-side fence for the author-retraction race: a
        request stamped with a leader_epoch OLDER than the preempt
        sweep's current term is exactly the shape of a deposed
        leader's late-landing stamp — which its author is about to
        retract (_retract_stale_preempt_stamp). Delivering it in
        that window drains a victim for a decision that no longer
        stands, while the successor may stamp a DIFFERENT victim for
        the same starved task: a double drain the partition drill's
        notice count cannot see, because the deferred notice was
        never published. A stale epoch alone is NOT proof of a bad
        stamp, though — a legitimate term-E stamp survives into term
        E+1 whenever leadership turns over mid-drain, and the
        successor deliberately escalates rather than re-stamps it
        (the "already draining" branch of the sweep). So first
        delivery of a stale-epoch stamp is HELD for one confirmation
        cycle, then re-read fresh: a retracted stamp has vanished; a
        stamp that survives confirmation is the world's will and is
        delivered. Current-term and epoch-less (manual ``jobs
        preempt``) stamps pass straight through."""
        stamp_epoch = request.get("leader_epoch")
        if stamp_epoch is None:
            return request
        leader = self._observed_preempt_leader()
        if (leader is None or leader.get("epoch") is None
                or stamp_epoch >= leader["epoch"]):
            return request
        key = (job_id, task_id, str(request.get("requested_at")),
               bool(request.get("escalated_at")))
        now = time.monotonic()
        first_seen = self._preempt_forward_hold.get(key)
        if first_seen is None:
            if len(self._preempt_forward_hold) > 256:
                self._preempt_forward_hold.clear()
            self._preempt_forward_hold[key] = now
            return None
        if now - first_seen < max(self.heartbeat_interval, 0.5):
            return None
        try:
            entity = self._task_entity(job_id, task_id)
        except NotFoundError:
            self._preempt_forward_hold.pop(key, None)
            return None
        except Exception:  # noqa: BLE001 - heartbeat survives
            return None  # transient: hold stands, retry next beat
        fresh = entity.get(names.TASK_COL_PREEMPT_REQUEST)
        if not (isinstance(fresh, dict)
                and fresh.get("requested_at")
                == request.get("requested_at")):
            # Retracted (or replaced): the hold did its job — drop
            # the cached copy so the next beat sees the fresh world.
            self._preempt_forward_hold.pop(key, None)
            self._task_preempt_cache.pop((job_id, task_id), None)
            logger.warning(
                "held stale-epoch preempt stamp on %s/%s was "
                "retracted before delivery (epoch %s < current %s)",
                job_id, task_id, stamp_epoch, leader["epoch"])
            return None
        self._preempt_forward_hold.pop(key, None)
        return fresh

    def _observed_preempt_leader(self) -> Optional[dict]:
        """Observer view of the preempt-sweep lease's current term,
        cached for _job_state_ttl — the epoch comparison above runs
        every beat for as long as any live task is draining, and must
        not cost two store reads each time."""
        now = time.monotonic()
        cached = self._preempt_leader_cache
        if cached is not None and now - cached[1] < self._job_state_ttl:
            return cached[0]
        leader = state_leases.read_leader(
            self.store,
            names.leader_epoch_key(self.identity.pool_id,
                                   state_leases.ROLE_PREEMPT_SWEEP))
        self._preempt_leader_cache = (leader, now)
        return leader

    def _escalated_request_pending(self, job_id: str,
                                   task_id: str) -> bool:
        """True when the task's pending preempt request carries the
        sweep's escalation stamp — the durable classification signal
        for an evicted exit (one cached entity read)."""
        request = self._cached_task_preempt_request(job_id, task_id)
        return (isinstance(request, dict)
                and bool(request.get("escalated_at")))

    def _task_dir_targets(self, job_id: str,
                          task_id: str) -> list[str]:
        """A task's dir plus its gang-instance subdirs — every
        location a per-task request file (profile, preempt) must land
        in on this node."""
        root = os.path.join(self.work_dir, "tasks", job_id, task_id)
        targets = [root]
        try:
            targets += [os.path.join(root, d)
                        for d in os.listdir(root)
                        if d.startswith("i")
                        and os.path.isdir(os.path.join(root, d))]
        except OSError:
            pass
        return [t for t in targets if os.path.isdir(t)]

    def _deliver_preempt_request(self, job_id: str, task_id: str,
                                 request: dict) -> None:
        for task_dir in self._task_dir_targets(job_id, task_id):
            self._deliver_preempt_file(
                os.path.join(task_dir, "preempt_request.json"),
                request)

    def _deliver_preempt_file(self, path: str, request: dict) -> None:
        """One request file per (path, requested_at) — the profile
        delivery protocol: a persisted .delivered marker survives
        agent restarts (a re-dropped request after the harness
        consumed it would trigger a second drain of the RERUN), and
        the mark is taken only after a successful write so transient
        OSErrors retry next heartbeat."""
        requested_at = str(request.get("requested_at"))
        key = (path, requested_at)
        if key in self._preempt_delivered:
            return
        marker = path + ".delivered"
        try:
            with open(marker, encoding="utf-8") as fh:
                if fh.read().strip() == requested_at:
                    self._preempt_delivered.add(key)
                    return
        except OSError:
            pass
        try:
            preempt_mod.write_request(
                path, reason=str(request.get("reason") or ""),
                requested_at=request.get("requested_at"),
                by_job_id=request.get("by_job_id"),
                by_task_id=request.get("by_task_id"))
            with open(marker, "w", encoding="utf-8") as fh:
                fh.write(requested_at)
        except OSError:
            logger.debug("preempt request delivery failed for %s",
                         path, exc_info=True)
            return
        if len(self._preempt_delivered) > 4096:
            self._preempt_delivered.clear()
        self._preempt_delivered.add(key)
        logger.warning("preempt request delivered to %s", path)

    def _requeue_preempted(self, job_id: str, task_id: str,
                           spec: dict,
                           instances: Optional[int] = None) -> bool:
        """Preempted requeue: the task drained cooperatively, so this
        is a scheduling transition, not a failure — the retry counter
        is NOT bumped (full budget preserved), no backoff is stamped
        (the wait was deliberate on the scheduler's side, not the
        task's), and any stale not_before from an earlier failure is
        cleared. The entity passes through the distinct ``preempted``
        state, which the claim path treats like pending; the rerun's
        restore pulls the forced COMMITTED checkpoint. Returns False
        when a concurrent transition won the merge."""
        now = time.time()
        try:
            entity = self._task_entity(job_id, task_id)
        except NotFoundError:
            return False
        if entity.get("state") in names.TERMINAL_TASK_STATES:
            return False
        request = entity.get(names.TASK_COL_PREEMPT_REQUEST)
        if not isinstance(request, dict):
            # EXIT_PREEMPTED with NO pending preempt request is not a
            # preemption: a buggy task exiting 75 unprompted would
            # otherwise requeue at full budget forever. The caller
            # falls back to the retry supervisor (budgeted).
            logger.warning(
                "task %s/%s exited with the preempted status but no "
                "preempt request is pending; treating as a failure",
                job_id, task_id)
            return False
        count = int(
            entity.get(names.TASK_COL_PREEMPT_COUNT, 0) or 0) + 1
        try:
            self._merge_task(job_id, task_id, {
                "state": names.TASK_STATE_PREEMPTED,
                "node_id": None,
                names.TASK_COL_PREEMPTED_AT: now,
                names.TASK_COL_PREEMPT_COUNT: count,
                names.TASK_COL_PREEMPT_REQUEST: None,
                "not_before": None,
                "requeued_at": util.datetime_utcnow_iso(),
            }, if_match=entity["_etag"])
        except (EtagMismatchError, NotFoundError):
            return False
        goodput_events.emit(
            self.store, self.identity.pool_id,
            goodput_events.TASK_PREEMPT_EXIT, job_id=job_id,
            task_id=task_id, node_id=self.identity.node_id,
            attrs={"preempt_count": count,
                   "reason": request.get("reason")},
            trace_id=entity.get(trace_context.COL_TRACE_ID),
            span_id=entity.get(trace_context.COL_TRACE_SPAN))
        # The cooperative window (notice -> drained exit) on the
        # trace: how long the drain + forced commit actually took.
        requested = goodput_events.iso_to_epoch(
            request.get("requested_at"))
        trace_spans.emit(
            self.store, self.identity.pool_id,
            trace_spans.SPAN_PREEMPT,
            trace_context.TraceContext.from_entity(entity),
            job_id=job_id, task_id=task_id,
            node_id=self.identity.node_id,
            start=(requested if requested and requested < now
                   else now),
            end=now,
            attrs={"preempt_count": count,
                   "reason": request.get("reason")})
        queue = names.task_queue_for(
            self.identity.pool_id, task_id,
            self.pool.task_queue_shards,
            priority=int(spec.get("priority", 0) or 0))
        message = {"job_id": job_id, "task_id": task_id}
        if entity.get(trace_context.COL_TRACE_ID):
            message["trace_id"] = entity[trace_context.COL_TRACE_ID]
        if instances:
            self.store.put_messages(
                queue,
                [json.dumps({**message, "instance": k}).encode()
                 for k in range(instances)])
        else:
            self.store.put_message(queue,
                                   json.dumps(message).encode())
        logger.warning(
            "task %s/%s preempted (count %d); requeued at full "
            "retry budget", job_id, task_id, count)
        return True

    def _requeue_evicted(self, job_id: str, task_id: str,
                         spec: dict,
                         instances: Optional[int] = None) -> bool:
        """Evicted requeue: the victim ignored its notice and was
        hard-killed after the grace window. Externally caused — so,
        like a preemption, the retry counter is untouched (full
        budget), no backoff is stamped, and node health is never
        debited. UNLIKE a preemption the drain never happened: the
        rerun resumes from the last COMMITTED checkpoint BEFORE the
        notice, and the steps since that barrier are replayed — the
        rework the distinct `eviction` badput leg prices. Requires a
        pending ESCALATED preempt request on the entity (the sweep's
        stamp is the classification); returns False otherwise so the
        caller falls back to the retry supervisor."""
        now = time.time()
        try:
            entity = self._task_entity(job_id, task_id)
        except NotFoundError:
            return False
        if entity.get("state") in names.TERMINAL_TASK_STATES:
            return False
        request = entity.get(names.TASK_COL_PREEMPT_REQUEST)
        if not isinstance(request, dict) or \
                not request.get("escalated_at"):
            # A hard-killed exit WITHOUT an escalated request is not
            # an eviction — the retry supervisor prices it (the
            # spurious-75 rule's forcible sibling).
            return False
        count = int(
            entity.get(names.TASK_COL_EVICT_COUNT, 0) or 0) + 1
        try:
            self._merge_task(job_id, task_id, {
                "state": names.TASK_STATE_EVICTED,
                "node_id": None,
                names.TASK_COL_EVICTED_AT: now,
                names.TASK_COL_EVICT_COUNT: count,
                names.TASK_COL_PREEMPT_REQUEST: None,
                "not_before": None,
                "requeued_at": util.datetime_utcnow_iso(),
            }, if_match=entity["_etag"])
        except (EtagMismatchError, NotFoundError):
            return False
        goodput_events.emit(
            self.store, self.identity.pool_id,
            goodput_events.TASK_EVICTED, job_id=job_id,
            task_id=task_id, node_id=self.identity.node_id,
            attrs={"evict_count": count,
                   "reason": request.get("reason")},
            trace_id=entity.get(trace_context.COL_TRACE_ID),
            span_id=entity.get(trace_context.COL_TRACE_SPAN))
        # The burned notice window (notice -> hard-killed exit) on
        # the trace: how long the victim squatted past its notice.
        requested = goodput_events.iso_to_epoch(
            request.get("requested_at"))
        trace_spans.emit(
            self.store, self.identity.pool_id,
            trace_spans.SPAN_EVICT,
            trace_context.TraceContext.from_entity(entity),
            job_id=job_id, task_id=task_id,
            node_id=self.identity.node_id,
            start=(requested if requested and requested < now
                   else now),
            end=now,
            attrs={"evict_count": count,
                   "reason": request.get("reason")})
        queue = names.task_queue_for(
            self.identity.pool_id, task_id,
            self.pool.task_queue_shards,
            priority=int(spec.get("priority", 0) or 0))
        message = {"job_id": job_id, "task_id": task_id}
        if entity.get(trace_context.COL_TRACE_ID):
            message["trace_id"] = entity[trace_context.COL_TRACE_ID]
        if instances:
            self.store.put_messages(
                queue,
                [json.dumps({**message, "instance": k}).encode()
                 for k in range(instances)])
        else:
            self.store.put_message(queue,
                                   json.dumps(message).encode())
        logger.warning(
            "task %s/%s evicted (count %d); requeued at full retry "
            "budget — rerun resumes from the pre-notice COMMITTED "
            "barrier", job_id, task_id, count)
        return True

    def _elastic_size(self, spec: dict,
                      entity: dict) -> tuple[int, int]:
        """(current effective gang size, next attempt's size).

        Rigid gangs (no min_instances floor) never change size. An
        elastic gang's next attempt re-forms at whatever the pool can
        actually supply: max(min_instances, min(spec size, live
        nodes)) — shrinking when nodes were lost, growing back toward
        the spec size when capacity returned."""
        num_instances = spec["multi_instance"]["num_instances"]
        eff = int(entity.get(names.TASK_COL_GANG_SIZE)
                  or num_instances)
        min_inst = spec["multi_instance"].get("min_instances")
        if not min_inst or int(min_inst) >= num_instances:
            return eff, eff
        live = self._count_live_nodes()
        return eff, max(int(min_inst), min(num_instances, live))

    def _emit_gang_resize(self, job_id: str, task_id: str,
                          entity: dict, old_size: int,
                          new_size: int, attempt: int) -> None:
        goodput_events.emit(
            self.store, self.identity.pool_id,
            goodput_events.GANG_RESIZE, job_id=job_id,
            task_id=task_id,
            attrs={"old_size": old_size, "new_size": new_size,
                   "spec_size":
                       entity["spec"]["multi_instance"][
                           "num_instances"],
                   "attempt": attempt},
            trace_id=entity.get(trace_context.COL_TRACE_ID),
            span_id=entity.get(trace_context.COL_TRACE_SPAN))
        trace_spans.emit(
            self.store, self.identity.pool_id,
            trace_spans.SPAN_GANG_RESIZE,
            trace_context.TraceContext.from_entity(entity),
            job_id=job_id, task_id=task_id,
            node_id=self.identity.node_id,
            attrs={"old_size": old_size, "new_size": new_size,
                   "attempt": attempt})
        logger.warning(
            "gang %s/%s re-forming at size %d (was %d) for attempt "
            "%d", job_id, task_id, new_size, old_size, attempt)

    def _count_live_nodes(self) -> int:
        """Fresh, non-quarantined nodes of this pool — the capacity
        an elastic gang can actually re-form on (the _node_alive
        freshness rule, registration grace included)."""
        now = time.time()
        live = 0
        for node in self.store.query_entities(
                names.TABLE_NODES,
                partition_key=self.identity.pool_id):
            if node.get("state") in ("offline",):
                continue
            if node.get(names.NODE_COL_QUARANTINED):
                continue
            heartbeat = float(node.get("heartbeat_at", 0) or 0)
            if heartbeat > 0:
                fresh = now - heartbeat < self.node_stale_seconds
            else:
                registered = float(node.get("registered_at", 0) or 0)
                fresh = (registered > 0 and
                         now - registered < self.node_stale_seconds)
            if fresh:
                live += 1
        return live

    # ----------------------- compile-cache hooks -----------------------

    def _compile_cache_dir(self) -> str:
        """Node-local persistent compile cache, shared by every task
        on this node (exported as $SHIPYARD_COMPILE_CACHE_DIR)."""
        return os.path.join(self.work_dir, "compilecache")

    def _seed_compile_cache(self) -> None:
        """Pre-task seed: pull the pool's cache artifact so this task
        compiles warm (the image-prefetch pattern for executables).
        Generation-gated — an unchanged latest.json costs one
        metadata read, never a download. Best-effort by design."""
        try:
            meta = self.store.get_object_meta(
                names.compile_cache_latest_key(self.identity.pool_id))
        except NotFoundError:
            return
        except Exception:  # noqa: BLE001 - warm start is optional
            logger.debug("compile cache meta probe failed",
                         exc_info=True)
            return
        if meta.generation == self._compile_cache_seen_gen:
            return
        status = cc_seeding.seed_cache(
            self.store, self.identity.pool_id,
            self._compile_cache_dir())
        # Durable outcomes (seeded / refused-identity / already-warm)
        # latch on the artifact generation so an unchanged latest.json
        # is never re-downloaded; a TRANSIENT failure must not latch —
        # the next task retries, or one store hiccup would leave this
        # node cold until some other node publishes a newer artifact.
        if status != cc_seeding.ERROR:
            self._compile_cache_seen_gen = meta.generation

    def _export_compile_cache(self) -> None:
        """Post-task export: publish this node's cache subdirs as the
        pool seed (lease-guarded inside export_cache — one uploader
        per identity; nodes with nothing newer skip). Runs on a
        background thread: a first cold compile can leave a cache
        that takes real time to tar+upload, and that must not delay
        task finish accounting (the zero-stall lesson of the async
        checkpoint pipeline). No generation latch here — the export
        bumps latest.json, and the NEXT pre-task seed probe
        re-reads it: this node's own identities skip instantly on
        entry counts, while an identity another node published
        concurrently (whose records the export's read-modify-write
        may have folded in) still gets seeded rather than latched
        past."""
        thread = self._compile_cache_export_thread
        if thread is not None and thread.is_alive():
            return  # one in-flight export; the next finish retries

        def _run() -> None:
            cc_seeding.export_cache(
                self.store, self.identity.pool_id,
                self._compile_cache_dir(), self.identity.node_id)

        thread = threading.Thread(target=_run, daemon=True,
                                  name="compilecache-export")
        self._compile_cache_export_thread = thread
        thread.start()

    # ------------------ retry supervisor + node health -----------------

    def _backoff_seconds(self, task_id: str, retries: int) -> float:
        """Exponential backoff with deterministic jitter for attempt
        ``retries`` (1-based): base * 2^(n-1), capped, +-25% jitter
        keyed on (task, attempt) so a burst of simultaneous failures
        doesn't re-thunder onto the store in lockstep — and so chaos
        drills with a fixed seed replay the exact same schedule."""
        import zlib
        n = max(1, retries)
        delay = min(self.retry_backoff_cap,
                    self.retry_backoff_base * (2.0 ** (n - 1)))
        jitter = (zlib.crc32(f"{task_id}#{n}".encode()) % 1000) / 1000.0
        return delay * (0.75 + 0.5 * jitter)

    @staticmethod
    def _retry_decision(retries: int, max_retries: int) -> str:
        """THE supervisor policy, shared by the regular-task,
        gang-recovery, and gang-finalize paths: 'requeue' while the
        budget lasts (max_retries < 0 = unlimited), 'quarantine' once
        a configured budget is burned, 'fail' when no budget was ever
        configured (max_task_retries=0 keeps the legacy fail-fast
        contract)."""
        if max_retries < 0 or retries < max_retries:
            return "requeue"
        if max_retries > 0:
            return "quarantine"
        return "fail"

    def _append_attempt(self, entity: dict, exit_code: int,
                        reason: str) -> list[dict]:
        """Attempt-history entry for the quarantine diagnostics
        bundle, trimmed to the last 16 attempts."""
        history = list(entity.get("attempt_history") or [])
        history.append({"node_id": self.identity.node_id,
                        "exit_code": exit_code, "reason": reason,
                        "at": util.datetime_utcnow_iso()})
        return history[-16:]

    def _requeue_with_backoff(self, job_id: str, task_id: str,
                              spec: dict, retries: int,
                              exit_code: int, reason: str,
                              instances: Optional[int] = None,
                              if_match: Optional[str] = None,
                              extra: Optional[dict] = None) -> bool:
        """Retry supervisor requeue: bump the retry counter, stamp
        not_before (honored by the claim path; the queue message also
        carries the delay) and append the attempt to the diagnostics
        history. The backoff wait itself is priced by the claim side
        once it has elapsed (see _goodput_work_started). Returns
        False when the optimistic merge lost (someone else already
        transitioned the task)."""
        delay = self._backoff_seconds(task_id, retries)
        now = time.time()
        try:
            entity = self._task_entity(job_id, task_id)
        except NotFoundError:
            return False
        try:
            self._merge_task(job_id, task_id, {
                "state": "pending", "retries": retries,
                "last_exit_code": exit_code,
                "last_error": reason,
                "not_before": now + delay,
                "requeued_at": util.datetime_utcnow_iso(),
                "attempt_history": self._append_attempt(
                    entity, exit_code, reason),
                "node_id": None,
                # A pending preempt request dies with the attempt it
                # targeted: the failure requeue supersedes the drain
                # (the next sweep re-elects victims from live state).
                names.TASK_COL_PREEMPT_REQUEST: None,
                **(extra or {}),
            }, if_match=if_match)
        except (EtagMismatchError, NotFoundError):
            return False
        goodput_events.emit(
            self.store, self.identity.pool_id,
            goodput_events.TASK_RETRY, job_id=job_id,
            task_id=task_id, node_id=self.identity.node_id,
            attrs={"retries": retries, "exit_code": exit_code,
                   "reason": reason},
            trace_id=entity.get(trace_context.COL_TRACE_ID),
            span_id=entity.get(trace_context.COL_TRACE_SPAN))
        # Requeue marker on the trace: instantaneous, carrying the
        # supervisor's decision so the exported waterfall shows WHY
        # the next queue_wait span exists.
        trace_spans.emit(
            self.store, self.identity.pool_id,
            trace_spans.SPAN_REQUEUE,
            trace_context.TraceContext.from_entity(entity),
            job_id=job_id, task_id=task_id,
            node_id=self.identity.node_id,
            attrs={"retries": retries, "exit_code": exit_code,
                   "reason": reason, "backoff_seconds": delay})
        # The TASK_BACKOFF interval is emitted by the CLAIM side
        # (_goodput_work_started) once the wait has actually elapsed:
        # emitting [now, now+delay] here would future-date the event,
        # and any report or heimdall scrape taken during the window
        # would extend wall past the present and charge seconds that
        # never elapsed yet.
        queue = names.task_queue_for(
            self.identity.pool_id, task_id,
            self.pool.task_queue_shards,
            priority=int(spec.get("priority", 0) or 0))
        message = {"job_id": job_id, "task_id": task_id}
        if entity.get(trace_context.COL_TRACE_ID):
            message["trace_id"] = entity[trace_context.COL_TRACE_ID]
        if instances:
            self.store.put_messages(
                queue,
                [json.dumps({**message, "instance": k}).encode()
                 for k in range(instances)],
                delay_seconds=delay)
        else:
            self.store.put_message(
                queue, json.dumps(message).encode(),
                delay_seconds=delay)
        logger.warning(
            "task %s/%s requeued (attempt %d, %s); backoff %.1fs",
            job_id, task_id, retries, reason, delay)
        return True

    def _quarantine_task(self, job_id: str, task_id: str,
                         exit_code: int, reason: str,
                         stderr_path: Optional[str] = None,
                         if_match: Optional[str] = None) -> bool:
        """Poison quarantine: the task exhausted its retry budget.
        Park it terminally with a diagnostics bundle (last stderr
        tail, per-attempt node/exit history) so the operator reads
        the post-mortem off `jobs tasks list` instead of grepping
        node logs. Returns False when the merge lost."""
        tail = ""
        if stderr_path:
            try:
                with open(stderr_path, "rb") as fh:
                    fh.seek(max(0, os.path.getsize(stderr_path) - 2048))
                    tail = fh.read().decode(errors="replace")
            except OSError:
                pass
        try:
            entity = self._task_entity(job_id, task_id)
        except NotFoundError:
            return False
        history = self._append_attempt(entity, exit_code, reason)
        try:
            self._merge_task(job_id, task_id, {
                "state": names.TASK_STATE_QUARANTINED,
                "exit_code": exit_code,
                "error": f"retry budget exhausted: {reason}",
                "completed_at": util.datetime_utcnow_iso(),
                "node_id": None,
                # node/exit-code histories are projections of
                # attempt_history — derived at display time
                # (fleet.action_jobs_tasks_list), not stored thrice.
                "diagnostics": {
                    "stderr_tail": tail,
                    "attempt_history": history,
                },
            }, if_match=if_match)
        except (EtagMismatchError, NotFoundError):
            return False
        logger.error("task %s/%s quarantined after retry budget: %s",
                     job_id, task_id, reason)
        return True

    def _drop_live_proc(self, key: tuple[str, str],
                        mine: list) -> None:
        """Remove this run's proc from the live-proc registry — and
        ONLY this run's. A superseded gang zombie (its attempt was
        recovered while it ran) must not unregister the recovered
        attempt's proc on the same node, or term_task / chaos
        task_kill would silently miss the live rerun."""
        if mine and self._live_procs.get(key) is mine[-1]:
            self._live_procs.pop(key, None)

    def _run_task_registered(self, key: tuple[str, str],
                             execution: task_runner.TaskExecution,
                             ledger_slot: Optional[int] = None,
                             ledger_gang: bool = False,
                             ) -> task_runner.TaskResult:
        """run_task with live-proc registration (term_task control
        verbs and chaos task_kill/task_wedge target the proc through
        _live_procs), unregistering only its own entry on exit (see
        _drop_live_proc). Shared by the regular and gang paths.
        ``ledger_slot`` arms the crash-restart slot ledger: the
        launched pid is persisted so a restarted agent can re-adopt
        the still-running process instead of reclaim-rerunning it
        (the ledger is cleared by the completion path, not here — a
        crash between exit and classification must stay
        adoptable). ``ledger_gang`` marks the record as a gang
        member, which a restarted agent fences (kills) rather than
        adopts."""
        mine: list = []

        def _register(proc):
            mine.append(proc)
            self._live_procs[key] = proc
            if ledger_slot is not None:
                self._write_slot_ledger(ledger_slot, key, execution,
                                        proc, gang=ledger_gang)

        try:
            return task_runner.run_task(execution,
                                        on_start=_register)
        finally:
            self._drop_live_proc(key, mine)

    def _note_task_outcome(self, ok: bool,
                           wedged: bool = False,
                           neutral: bool = False) -> None:
        """Node health scoring: failures decay the score (wedges
        harder — a wedge usually implicates the node's accelerator
        state, not the task), successes recover it. Crossing the
        threshold quarantines the node: auto-drain via
        claim-exclusion (this agent stops claiming; observers read
        the column). Recovery back above the threshold un-drains.

        ``neutral=True`` skips scoring entirely: an EXTERNALLY-caused
        exit (cooperative preemption, chaos preempt notice) says
        nothing about this node's health — debiting it would let a
        burst of scheduler preemptions quarantine perfectly healthy
        nodes."""
        if neutral:
            return
        with self._health_lock:
            if ok:
                self._health = min(1.0, self._health + 0.1)
                self._recent_failures = max(
                    0, self._recent_failures - 1)
            elif wedged:
                self._health *= 0.5
                self._recent_failures += 1
            else:
                self._health *= 0.7
                self._recent_failures += 1
            was = self._node_quarantined
            self._node_quarantined = (
                self._health < self._health_quarantine_threshold)
            if self._node_quarantined and not was:
                self._quarantined_at = time.monotonic()
            health = self._health
            quarantined = self._node_quarantined
        if quarantined and not was:
            logger.error(
                "node %s health %.3f below threshold %.2f; "
                "quarantining (draining: no further claims)",
                self.identity.node_id, health,
                self._health_quarantine_threshold)
        elif was and not quarantined:
            logger.warning("node %s recovered (health %.3f); "
                           "resuming claims",
                           self.identity.node_id, health)
        # Advisory publish on the task-completion critical path: a
        # store hiccup here must not discard a finished task's result
        # (the periodic heartbeat now carries these columns, so a
        # lost publish self-repairs).
        try:
            self._heartbeat()
        except Exception:
            logger.exception("health publish failed; will ride the "
                             "next periodic heartbeat")

    def node_quarantined(self) -> bool:
        released = False
        with self._health_lock:
            if self._node_quarantined and (
                    time.monotonic() - self._quarantined_at
                    >= self._health_probation_seconds):
                # Probation lapsed: resume claims at exactly the
                # threshold score (see __init__ — quarantine must not
                # be a terminal state for the node).
                self._health = self._health_quarantine_threshold
                self._node_quarantined = False
                released = True
            health = self._health
            quarantined = self._node_quarantined
        if released:
            logger.warning(
                "node %s quarantine probation lapsed after %.0fs; "
                "resuming claims at health %.3f",
                self.identity.node_id,
                self._health_probation_seconds, health)
            try:
                self._heartbeat()
            except Exception:
                logger.exception("probation-release publish failed; "
                                 "will ride the next periodic "
                                 "heartbeat")
        return quarantined

    # ----------------------- regular task path -------------------------

    def _claim_regular(self, job_id: str, task_id: str,
                       entity: dict) -> Optional[str]:
        if entity.get("state") not in names.CLAIMABLE_TASK_STATES:
            return None
        if self.node_quarantined():
            return None
        try:
            # preempted_at/evicted_at are consumed here: the claim
            # closes the recovery intervals (_goodput_work_started
            # emits them from the pre-claim entity snapshot), and a
            # LATER failure-requeue of this attempt must not re-open
            # the old windows.
            return self._merge_task(
                job_id, task_id,
                {"state": "assigned",
                 "node_id": self.identity.node_id,
                 names.TASK_COL_PREEMPTED_AT: None,
                 names.TASK_COL_EVICTED_AT: None},
                if_match=entity["_etag"])
        except (EtagMismatchError, NotFoundError):
            return None

    def _run_regular_task(self, slot: int, job_id: str, task_id: str,
                          entity: dict, msg) -> None:
        if self._claim_regular(job_id, task_id, entity) is None:
            # Someone else claimed it; drop our copy of the message if
            # it is now terminal, else let visibility re-deliver.
            self.store.update_message(msg, visibility_timeout=10.0)
            return
        self._goodput_work_started(slot, job_id, task_id, entity)
        spec = entity["spec"]
        with self._message_keepalive(msg):
            if not self._ensure_job_prep(job_id, spec):
                self._merge_task(job_id, task_id, {
                    "state": "failed", "exit_code": -2,
                    "error": "job preparation failed on node "
                             f"{self.identity.node_id}"})
                self.store.delete_message(msg)
                self._maybe_autocomplete_job(job_id)
                self._goodput_work_done(slot)
                return
            try:
                self._ensure_images_timed(job_id, task_id, spec,
                                          entity=entity)
                execution = self._build_execution(slot, job_id,
                                                  task_id, spec,
                                                  entity=entity)
            except TaskEnvError as exc:
                self._merge_task(job_id, task_id, {
                    "state": "failed", "exit_code": -4,
                    "error": str(exc)})
                self.store.delete_message(msg)
                self._maybe_autocomplete_job(job_id)
                self._goodput_work_done(slot)
                return
            try:
                self._stage_inputs(spec, execution)
            except Exception as exc:
                logger.exception("input staging failed for %s/%s",
                                 job_id, task_id)
                self._merge_task(job_id, task_id, {
                    "state": "failed", "exit_code": -3,
                    "error": f"input staging failed: {exc}"})
                self.store.delete_message(msg)
                self._maybe_autocomplete_job(job_id)
                self._goodput_work_done(slot)
                return
            self._merge_task(job_id, task_id, {
                "state": "running",
                "started_at": util.datetime_utcnow_iso()})
            self._heartbeat(state="running")
            with self._running_lock:
                self._running_tasks += 1
            try:
                result = self._run_task_registered(
                    (job_id, task_id), execution, ledger_slot=slot)
            finally:
                with self._running_lock:
                    self._running_tasks -= 1
        if self._abandoned:
            # Simulated agent-process death (chaos agent_restart):
            # this thread is a zombie of the dead "process" — the
            # completion belongs to the restarted agent's adoption
            # watcher, which reads the slot ledger + exit-code
            # sentinel. A single store write here would
            # double-classify the exit.
            return
        self._finish_regular_result(slot, job_id, task_id, spec,
                                    entity, execution, result,
                                    msg=msg)

    def _finish_regular_result(self, slot: int, job_id: str,
                               task_id: str, spec: dict,
                               entity: dict,
                               execution: task_runner.TaskExecution,
                               result: task_runner.TaskResult,
                               msg=None) -> None:
        """Post-exit half of the regular-task path: uploads, goodput
        ingest, exit classification, requeue/quarantine/finish.
        Shared by the worker slot (msg = the claimed queue message)
        and the crash-restart adoption watcher (msg=None — the
        redelivered message dies on the terminal-state check once
        the entity goes terminal). Clears the slot ledger last: a
        crash anywhere before that leaves the task adoptable."""
        try:
            self._upload_outputs(job_id, task_id, execution)
        except Exception as exc:  # noqa: BLE001 - classify anyway
            # Classification must never be hostage to an upload: an
            # exception escaping here (store outage past the retry
            # ceiling, injected fault) would skip the exit handling
            # below and orphan-reclaim a FINISHED task into a rerun.
            # Lost stdout/stderr blobs are recorded and survivable;
            # a double execution is not.
            logger.exception("output upload failed for %s/%s",
                             job_id, task_id)
            try:
                self._merge_task(job_id, task_id,
                                 {"output_error": str(exc)})
            except Exception:  # noqa: BLE001 - best effort
                pass
        self._ingest_goodput(job_id, task_id, execution)
        self._upload_profile_artifacts(job_id, task_id, execution)
        self._export_compile_cache()
        self._goodput_task_finished(slot, job_id, task_id, result,
                                    entity=entity)
        try:
            self._collect_outputs(spec, execution, job_id, task_id)
        except Exception as exc:
            logger.exception("output collection failed for %s/%s",
                             job_id, task_id)
            self._merge_task(job_id, task_id,
                             {"output_error": str(exc)})
        try:
            ok = result.exit_code == 0
            # The distinct preempted status: a cooperative drain is a
            # scheduling transition, never a failure — full retry
            # budget, no node-health debit, no backoff.
            preempted = result.exit_code == preempt_mod.EXIT_PREEMPTED
            # The evicted status (the escalation ladder's hard kill):
            # we killed it ourselves (local marker), or the sweep's
            # escalation stamp is on the entity (cached read — covers
            # a restart between kill and classification). Externally
            # caused either way: never a wedge, never a node-health
            # debit.
            evicted = not ok and not preempted and (
                (job_id, task_id) in self._evicted_locally
                or self._escalated_request_pending(job_id, task_id))
            self._evicted_locally.discard((job_id, task_id))
            self._note_task_outcome(ok, wedged=result.wedged,
                                    neutral=preempted or evicted)
            retries = entity.get("retries", 0)
            max_retries = spec.get("max_task_retries", 0)
            reason = ("wedged: no progress beat within "
                      f"{spec.get('progress_deadline_seconds')}s"
                      if result.wedged else
                      f"exit code {result.exit_code}")
            decision = ("complete" if ok
                        else "preempted" if preempted
                        else "evicted" if evicted
                        else self._retry_decision(retries,
                                                  max_retries))
            if decision == "preempted":
                if self._requeue_preempted(job_id, task_id, spec):
                    self._heartbeat(state="idle")
                    self._ack_message(msg)
                    return
                decision = self._retry_decision(retries, max_retries)
            if decision == "evicted":
                if self._requeue_evicted(job_id, task_id, spec):
                    self._heartbeat(state="idle")
                    self._ack_message(msg)
                    return
                decision = self._retry_decision(retries, max_retries)
            if decision == "requeue":
                # Retry supervisor: exponential backoff + jitter, the
                # not_before stamp honored by every claimer.
                self._requeue_with_backoff(
                    job_id, task_id, spec, retries + 1,
                    result.exit_code, reason)
                self._heartbeat(state="idle")
                self._ack_message(msg)
                return
            if decision == "quarantine":
                # Poison quarantine: the budget is burned — park the
                # task with its post-mortem instead of plain "failed".
                if self._quarantine_task(
                        job_id, task_id, result.exit_code, reason,
                        stderr_path=result.stderr_path):
                    self._schedule_retention(spec, job_id, task_id)
                    self._heartbeat(state="idle")
                    self._ack_message(msg)
                    self._maybe_autocomplete_job(job_id)
                    return
            self._schedule_retention(spec, job_id, task_id)
            self._finish_task(job_id, task_id, result,
                              error=None if ok else reason)
            self._ack_message(msg)
            self._maybe_autocomplete_job(job_id)
        finally:
            self._clear_slot_ledger(slot, (job_id, task_id))

    def _ack_message(self, msg) -> None:
        """delete_message tolerant of the adoption path's msg=None
        (the watcher holds no queue message; redelivered copies die
        on the terminal-state check)."""
        if msg is not None:
            self.store.delete_message(msg)

    _RETENTION_MARKER = ".shipyard_retention_deadline"

    def _schedule_retention(self, spec: dict, job_id: str,
                            task_id: str) -> None:
        seconds = spec.get("retention_time_seconds")
        if seconds is None:
            return
        task_dir = os.path.join(self.work_dir, "tasks", job_id,
                                task_id)
        # Marker survives agent restarts: startup rescans for them so
        # pending sweeps are never orphaned (disk would otherwise
        # leak until the node dies).
        try:
            with open(os.path.join(task_dir, self._RETENTION_MARKER),
                      "w", encoding="utf-8") as fh:
                fh.write(str(time.time() + float(seconds)))
        except OSError:
            pass
        with self._retention_lock:
            self._retention.append(
                (time.monotonic() + float(seconds), task_dir))

    def _rescan_retention_markers(self) -> None:
        """Re-register sweeps recorded by a previous agent process
        (markers hold wall-clock deadlines)."""
        root = os.path.join(self.work_dir, "tasks")
        if not os.path.isdir(root):
            return
        now_wall = time.time()
        now_mono = time.monotonic()
        found = 0
        for job_id in os.listdir(root):
            job_dir = os.path.join(root, job_id)
            if not os.path.isdir(job_dir):
                continue
            for task_id in os.listdir(job_dir):
                marker = os.path.join(job_dir, task_id,
                                      self._RETENTION_MARKER)
                try:
                    with open(marker, encoding="utf-8") as fh:
                        wall_deadline = float(fh.read().strip())
                except (OSError, ValueError):
                    continue
                mono_deadline = now_mono + max(
                    0.0, wall_deadline - now_wall)
                with self._retention_lock:
                    self._retention.append(
                        (mono_deadline,
                         os.path.join(job_dir, task_id)))
                found += 1
        if found:
            logger.info("re-registered %d retention sweeps from "
                        "markers", found)

    # --------------------- crash-restart adoption ----------------------

    def _slot_ledger_path(self, slot: int) -> str:
        return os.path.join(self.work_dir, "slots",
                            f"slot{slot}.json")

    def _write_slot_ledger(self, slot: int, key: tuple[str, str],
                           execution: task_runner.TaskExecution,
                           proc, gang: bool = False) -> None:
        """Persist this slot's live claim (task identity, pid,
        container, the post-task env paths) at launch — the
        _atomic_write idiom (tmp + fsync + rename) so a crash
        mid-write can never surface a torn ledger. A restarted agent
        re-adopts from exactly this record instead of letting the
        janitor/orphan paths quarantine-rerun a task that never
        stopped running. ``gang`` marks a gang-member launch, whose
        restart handling is fence-by-kill rather than adoption (see
        _adopt_restart_state)."""
        pid = getattr(proc, "pid", None)
        record = {
            "slot": slot, "job_id": key[0], "task_id": key[1],
            "pid": pid,
            # Pid-identity anchor for _ledger_pid_matches: a pid the
            # OS recycled while the agent was down won't carry it.
            "pid_start_ticks": self._proc_start_ticks(pid),
            "runtime": execution.runtime,
            "container": task_runner.container_name(execution),
            "task_dir": execution.task_dir,
            "command": execution.command,
            # Only the framework's own path contract survives the
            # restart (goodput/trace sinks, profile dirs): resolved
            # user secrets must never touch the node's disk.
            "env": {k: v for k, v in execution.env.items()
                    if k.startswith("SHIPYARD_")},
            "started_at": util.datetime_utcnow_iso(),
        }
        path = self._slot_ledger_path(slot)
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            util.atomic_write(path,
                              json.dumps(record).encode("utf-8"))
        except OSError:
            logger.exception("slot ledger write failed for slot %d",
                             slot)

    def _clear_slot_ledger(self, slot: int,
                           key: Optional[tuple[str, str]] = None
                           ) -> None:
        """Retire a slot's ledger once its task is fully classified.
        ``key`` guards cross-task races: a ledger now naming a
        DIFFERENT task (the slot moved on) is someone else's."""
        path = self._slot_ledger_path(slot)
        if key is not None:
            try:
                with open(path, encoding="utf-8") as fh:
                    record = json.load(fh)
                if (record.get("job_id"),
                        record.get("task_id")) != key:
                    return
            except (OSError, ValueError):
                return
        try:
            os.remove(path)
        except OSError:
            pass

    @staticmethod
    def _pid_alive(pid: Optional[int]) -> bool:
        if not pid or pid <= 0:
            return False
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return False
        except (PermissionError, OSError):
            return True
        return True

    @staticmethod
    def _proc_start_ticks(pid: Optional[int]) -> Optional[int]:
        """Kernel start time (clock ticks since boot) of ``pid`` from
        /proc — the cheap pid-identity disambiguator: a recycled pid
        never shares its predecessor's start tick. None off-Linux or
        once the process is gone."""
        if not pid or pid <= 0:
            return None
        try:
            with open(f"/proc/{pid}/stat", "rb") as fh:
                stat = fh.read().decode("ascii", "replace")
            # Field 22 (starttime); comm can embed spaces/parens, so
            # split only after the closing paren.
            return int(stat.rpartition(")")[2].split()[19])
        except (OSError, ValueError, IndexError):
            return None

    def _ledger_pid_matches(self, pid: Optional[int],
                            record: dict) -> bool:
        """Liveness AND identity of a ledgered pid: alive, still a
        session/group leader (every task launches with
        start_new_session, so pgid == pid), and carrying the same
        kernel start tick the ledger recorded at launch. An agent
        down long enough for the OS to recycle the number must not
        adopt-wait on — or worse, hard-kill — the stranger that
        inherited it."""
        if not self._pid_alive(pid):
            return False
        try:
            if os.getpgid(pid) != pid:
                return False
        except OSError:
            return False
        recorded = record.get("pid_start_ticks")
        current = self._proc_start_ticks(pid)
        if recorded is not None and current is not None \
                and recorded != current:
            return False
        return True

    @staticmethod
    def _read_adopted_exit(record: dict) -> Optional[int]:
        """The exit-code sentinel the task's own session (or the
        reaping runner) persisted — task_runner.EXIT_CODE_FILENAME
        in the ledgered task_dir. None while the task still runs (or
        when the outcome is truly unknown)."""
        task_dir = record.get("task_dir") or ""
        try:
            with open(os.path.join(
                    task_dir, task_runner.EXIT_CODE_FILENAME),
                    encoding="utf-8") as fh:
                return int(fh.read().strip())
        except (OSError, ValueError):
            return None

    def _adopt_restart_state(self) -> int:
        """Crash-restart adoption (start()-time): every slot ledger a
        previous agent process left behind is either ADOPTED — the
        claim is still ours and the process (or its exit-code
        sentinel) survives, so a watcher thread takes over the wait +
        completion path and the task finishes with retries untouched
        and neutral health — or retired, leaving the ordinary
        orphan-reclaim rerun semantics. The control-plane gap (last
        pre-crash heartbeat -> adoption) is priced as the `adoption`
        badput leg and traced as SPAN_AGENT_RESTART."""
        root = os.path.join(self.work_dir, "slots")
        if not os.path.isdir(root):
            return 0
        adopted = 0
        now = time.time()
        window_start = self._pre_restart_heartbeat
        if not window_start or window_start > now:
            window_start = now
        for name in sorted(os.listdir(root)):
            path = os.path.join(root, name)
            try:
                with open(path, encoding="utf-8") as fh:
                    record = json.load(fh)
                slot = int(record["slot"])
                job_id = record["job_id"]
                task_id = record["task_id"]
            except (OSError, ValueError, KeyError, TypeError):
                try:
                    os.remove(path)
                except OSError:
                    pass
                continue
            if record.get("gang"):
                # Gang members are FENCED, not adopted: the
                # rendezvous context this launch belonged to (member
                # list, gang env, the i{instance} row merge and gang
                # finalize) died with the old agent process, so no
                # watcher could classify the exit honestly — and the
                # gang recovery paths (orphaned-gang janitor,
                # requeue-as-a-unit) already own the rerun. What must
                # NOT survive is the process itself: a live leftover
                # member writing into the task dir while the requeued
                # gang re-runs is exactly the double execution the
                # ledger exists to prevent. No store read needed —
                # fencing is purely local, so it works with the store
                # dark at boot.
                pid = record.get("pid")
                if self._ledger_pid_matches(pid, record) and \
                        self._read_adopted_exit(record) is None:
                    logger.warning(
                        "fencing leftover gang member %s/%s (pid %s) "
                        "after agent restart", job_id, task_id, pid)
                    self._hard_kill_task_group(job_id, task_id, pid)
                self._clear_slot_ledger(slot)
                continue
            try:
                # Bounded like the heartbeat probe above: boot must
                # not block max_outage_seconds per ledger when the
                # store is dark.
                with self._store_bounded(
                        max(10.0, 2.0 * self.heartbeat_interval)):
                    entity = self._task_entity(job_id, task_id)
            except NotFoundError:
                entity = None
            except Exception:  # noqa: BLE001 - store down at boot
                logger.debug("adoption probe failed", exc_info=True)
                continue  # ledger kept: retry next restart
            if (entity is None
                    or entity.get("node_id") != self.identity.node_id
                    or entity.get("state") not in ("assigned",
                                                   "running")):
                # The world moved on (terminal, re-owned, gone):
                # nothing left to adopt. A leftover process that IS
                # still ours-by-ledger gets fenced first — the claim
                # it served no longer exists, and the rerun that
                # replaced it must never share output dirs with a
                # live predecessor.
                pid = record.get("pid")
                if self._ledger_pid_matches(pid, record) and \
                        self._read_adopted_exit(record) is None:
                    logger.warning(
                        "fencing leftover process for re-owned task "
                        "%s/%s (pid %s) after agent restart",
                        job_id, task_id, pid)
                    self._hard_kill_task_group(job_id, task_id, pid)
                self._clear_slot_ledger(slot)
                continue
            pid = record.get("pid")
            alive = self._ledger_pid_matches(pid, record)
            exit_code = self._read_adopted_exit(record)
            if not alive and exit_code is None:
                # Process gone AND outcome unknown: adoption cannot
                # classify honestly — leave the rerun to the
                # orphan-reclaim path (retries budgeted, as today).
                self._clear_slot_ledger(slot)
                continue
            proc = _AdoptedProc(pid)
            self._adopted_slots.add(slot)
            # Register EVERY adoption (dead-pid ones included): the
            # registration is what makes _maybe_reclaim_orphan back
            # off a redelivered message on a SIBLING slot — without
            # it, a dead-pid adoption races its own reclaim-rerun
            # into a double execution. Kill-path consumers tolerate
            # a dead pid (ProcessLookupError handled everywhere).
            self._live_procs[(job_id, task_id)] = proc
            ctx = trace_context.TraceContext.from_entity(entity)
            goodput_events.emit(
                self.store, self.identity.pool_id,
                goodput_events.TASK_ADOPTION, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id,
                start=window_start, end=now,
                attrs={"pid": pid, "proc_alive": alive,
                       "retries": entity.get("retries", 0)},
                trace_id=entity.get(trace_context.COL_TRACE_ID),
                span_id=entity.get(trace_context.COL_TRACE_SPAN))
            trace_spans.emit(
                self.store, self.identity.pool_id,
                trace_spans.SPAN_AGENT_RESTART, ctx, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id,
                start=window_start, end=now,
                attrs={"pid": pid, "proc_alive": alive})
            thread = threading.Thread(
                target=self._adopt_watch,
                args=(record, entity, proc, alive),
                name=(f"adopt-{self.identity.node_id}"
                      f"-s{slot}"), daemon=True)
            thread.start()
            self._threads.append(thread)
            adopted += 1
            logger.warning(
                "adopted %s task %s/%s on slot %d after agent "
                "restart (pid %s)",
                "running" if alive else "exited", job_id, task_id,
                slot, pid)
        return adopted

    def _adopt_watch(self, record: dict, entity: dict, proc,
                     was_alive: bool) -> None:
        """Adoption watcher: stand in for the dead worker slot's
        blocking wait — poll the adopted pid, read the exit-code
        sentinel its session persisted, and drive the SAME
        completion path a live slot would have (uploads, goodput,
        classification). The task's retry budget is untouched by
        construction: no requeue ever happened."""
        slot = int(record["slot"])
        job_id, task_id = record["job_id"], record["task_id"]
        key = (job_id, task_id)
        counted = False
        # Adoption must not shed the task's runtime limits: the
        # original run_task watchdog died with the old agent, so THIS
        # loop re-arms wall-time (elapsed since the original launch)
        # and the progress watchdog (the beat file's mtime survives
        # the restart). Without them a wedged adopted task would hold
        # its slot forever — the exact hang class the watchdog
        # exists to bound.
        spec = entity.get("spec") or {}
        wall_limit = spec.get("max_wall_time_seconds")
        watchdog = spec.get("progress_deadline_seconds")
        progress_file = (record.get("env") or {}).get(
            progress_mod.PROGRESS_FILE_ENV)
        started_epoch = goodput_events.iso_to_epoch(
            record.get("started_at"))
        adopted_at = time.time()
        timed_out = False
        wedged = False
        try:
            with self._running_lock:
                self._goodput_idle_since = None
                self._goodput_busy_slots.add(slot)
                if was_alive:
                    self._running_tasks += 1
                    counted = True
            while self._ledger_pid_matches(proc.pid, record) and \
                    not self.stop_event.is_set():
                # The sentinel outranks pid liveness: once the task's
                # own session wrote its exit code, the command IS
                # done. Liveness itself is the full identity check
                # (_ledger_pid_matches, not _pid_alive): a pid the OS
                # recycles MID-WATCH would otherwise strand this
                # watcher "running" forever — or worse, hand the
                # wall/wedge enforcement below a stranger's process
                # group to hard-kill.
                if self._read_adopted_exit(record) is not None:
                    break
                now = time.time()
                elapsed = now - (started_epoch or adopted_at)
                if wall_limit is not None and elapsed > wall_limit:
                    timed_out = True
                    logger.warning(
                        "adopted task %s/%s exceeded wall time "
                        "%.1fs; killing", job_id, task_id,
                        float(wall_limit))
                    self._hard_kill_task_group(job_id, task_id,
                                             proc.pid)
                    break
                if watchdog is not None and progress_file:
                    beat = progress_mod.last_beat(progress_file)
                    # A missing beat file restarts the clock at
                    # adoption (conservative: the full deadline
                    # again, never a false wedge from lost state).
                    stale = (now - beat if beat is not None
                             else now - adopted_at)
                    if stale > watchdog:
                        wedged = True
                        logger.warning(
                            "adopted task %s/%s made no progress "
                            "for %.1fs (deadline %.1fs); killing as "
                            "wedged", job_id, task_id, stale,
                            float(watchdog))
                        self._hard_kill_task_group(job_id, task_id,
                                                 proc.pid)
                        break
                time.sleep(max(0.05, min(0.25, self.poll_interval)))
            if self.stop_event.is_set() and \
                    self._ledger_pid_matches(proc.pid, record) and \
                    self._read_adopted_exit(record) is None:
                # Stopping again mid-adoption: the ledger stays — the
                # NEXT restart adopts the still-running task.
                return
            if timed_out or wedged:
                # Our own kill: the classification is known — no
                # sentinel will appear (SIGKILL never runs the
                # trailer) and a handback would erase a genuine
                # wall/wedge verdict.
                exit_code = -9
            else:
                # The sentinel can lag the pid death by the shell
                # trailer's mv; poll briefly.
                exit_code = None
                deadline = time.monotonic() + 5.0
                while exit_code is None and \
                        time.monotonic() < deadline:
                    exit_code = self._read_adopted_exit(record)
                    if exit_code is None:
                        time.sleep(0.05)
                if exit_code is None and record.get("container"):
                    # Containerized task: only the shell trailer of
                    # runtime "none" writes the sentinel from inside
                    # the task's session, so ask the runtime itself.
                    exit_code = self._container_exit_code(
                        record["container"])
                if exit_code is None:
                    if record.get("runtime", "none") == "none":
                        # The trailer writes the sentinel on ANY
                        # normal exit; its absence means the session
                        # was hard-killed externally — classify as
                        # the kill it was; the retry supervisor
                        # prices the rerun.
                        exit_code = -9
                    else:
                        # Containerized outcome genuinely unknowable
                        # (e.g. --rm removed the container before we
                        # could ask). Never guess a FAILURE for a
                        # task that may have succeeded: hand it back
                        # through the orphan-reclaim semantics —
                        # reset pending, no retry consumed, no
                        # health debit.
                        self._abandon_adoption_to_reclaim(
                            job_id, task_id, slot)
                        return
            task_dir = record.get("task_dir") or os.path.join(
                self.work_dir, "tasks", job_id, task_id)
            execution = task_runner.TaskExecution(
                pool_id=self.identity.pool_id, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id,
                node_index=self.identity.node_index,
                command=record.get("command", ""),
                runtime=record.get("runtime", "none"),
                env=dict(record.get("env") or {}),
                task_dir=task_dir, slot=slot,
                record_exit_code=True)
            started_at = record.get("started_at") or \
                util.datetime_utcnow_iso()
            started = goodput_events.iso_to_epoch(started_at) or \
                time.time()
            result = task_runner.TaskResult(
                exit_code=exit_code,
                stdout_path=os.path.join(task_dir, "stdout.txt"),
                stderr_path=os.path.join(task_dir, "stderr.txt"),
                started_at=started_at,
                completed_at=util.datetime_utcnow_iso(),
                wall_seconds=max(0.0, time.time() - started),
                timed_out=timed_out, wedged=wedged)
            try:
                fresh = self._task_entity(job_id, task_id)
            except Exception:  # noqa: BLE001 - keep the snapshot
                fresh = entity
            self._finish_regular_result(
                slot, job_id, task_id, fresh.get("spec") or {},
                fresh, execution, result, msg=None)
        except Exception:
            logger.exception("adoption watcher failed for %s/%s",
                             job_id, task_id)
        finally:
            if counted:
                with self._running_lock:
                    self._running_tasks -= 1
            if self._live_procs.get(key) is proc:
                self._live_procs.pop(key, None)
            self._goodput_work_done(slot)
            self._adopted_slots.discard(slot)

    @staticmethod
    def _hard_kill_task_group(job_id: str, task_id: str,
                              pid: int) -> None:
        """Hard-kill a task's live process group on THIS node
        (eviction enforcement, adopted-task wall/wedge enforcement):
        docker containers force-removed first — SIGKILL is never
        proxied by the docker client (the task_runner wedge lesson;
        fixed-name convention from task_runner.container_name, one
        rm -f per possible instance container) — then the session
        group eats SIGKILL (tasks launch with start_new_session, so
        pgid == pid)."""
        import shutil as shutil_mod
        import signal as signal_mod
        import subprocess as subprocess_mod
        if shutil_mod.which("docker"):
            rc, out, _err = util.subprocess_capture(
                ["docker", "ps", "--filter",
                 f"name=shipyard-{job_id}-{task_id}-",
                 "--format", "{{.Names}}"])
            for name in (out.split() if rc == 0 else []):
                subprocess_mod.call(
                    ["docker", "rm", "-f", name],
                    stdout=subprocess_mod.DEVNULL,
                    stderr=subprocess_mod.DEVNULL)
        try:
            os.killpg(os.getpgid(pid), signal_mod.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            pass

    @staticmethod
    def _container_exit_code(container: str) -> Optional[int]:
        """The runtime's own record of a finished container's exit
        code (`docker inspect`); None when docker is absent or the
        container is gone (e.g. --rm already removed it)."""
        import shutil as shutil_mod
        if not shutil_mod.which("docker"):
            return None
        rc, out, _err = util.subprocess_capture(
            ["docker", "inspect", "-f", "{{.State.ExitCode}}",
             container])
        if rc != 0:
            return None
        try:
            return int(out.strip())
        except ValueError:
            return None

    def _abandon_adoption_to_reclaim(self, job_id: str,
                                     task_id: str,
                                     slot: int) -> None:
        """Unknown-outcome adoption exit: reset the claim exactly
        like the orphan-reclaim path would (pending, no retry bump,
        requeued_at restarts the queue clock) so the rerun costs
        repeat work but never budget or health."""
        logger.warning(
            "adopted task %s/%s finished with an unknowable exit; "
            "handing back to the reclaim path", job_id, task_id)
        try:
            entity = self._task_entity(job_id, task_id)
            if entity.get("state") in ("assigned", "running") and \
                    entity.get("node_id") == self.identity.node_id:
                self._merge_task(
                    job_id, task_id,
                    {"state": "pending", "node_id": None,
                     "requeued_at": util.datetime_utcnow_iso()},
                    if_match=entity["_etag"])
        except (EtagMismatchError, NotFoundError):
            pass
        except Exception:  # noqa: BLE001 - orphan reclaim retries
            logger.exception("adoption handback failed for %s/%s",
                             job_id, task_id)
        self._clear_slot_ledger(slot, (job_id, task_id))

    def _sweep_retention(self) -> None:
        now = time.monotonic()
        expired: list[str] = []
        with self._retention_lock:
            keep: list[tuple[float, str]] = []
            for deadline, task_dir in self._retention:
                if deadline <= now:
                    expired.append(task_dir)
                else:
                    keep.append((deadline, task_dir))
            self._retention = keep
        if expired:
            import shutil as shutil_mod
            for task_dir in expired:
                shutil_mod.rmtree(task_dir, ignore_errors=True)
                logger.info("retention expired; removed %s", task_dir)

    def _finish_task(self, job_id: str, task_id: str,
                     result: task_runner.TaskResult,
                     error: Optional[str] = None) -> None:
        patch = {
            "state": "completed" if result.exit_code == 0 else "failed",
            "exit_code": result.exit_code,
            "timed_out": result.timed_out,
            "wedged": result.wedged,
            "completed_at": result.completed_at,
            "wall_seconds": result.wall_seconds,
        }
        if error:
            patch["error"] = error
        self._merge_task(job_id, task_id, patch)
        self._heartbeat(state="idle")

    # ------------------------ gang (MI) task path ----------------------

    @staticmethod
    def _gang_attempt(entity: dict) -> int:
        """Rendezvous attempt index: retries + preempt_count +
        evict_count. A preempted/evicted requeue keeps the retry
        budget untouched but must STILL re-form in a fresh partition
        — reusing the drained attempt's partition would race its row
        cleanup against the rerun's claims (a fast claimer could
        insert rows the finalizer's clear then deletes, wedging the
        rendezvous)."""
        return (int(entity.get("retries", 0) or 0)
                + int(entity.get(names.TASK_COL_PREEMPT_COUNT, 0)
                      or 0)
                + int(entity.get(names.TASK_COL_EVICT_COUNT, 0)
                      or 0))

    def _gang_pk(self, job_id: str, task_id: str,
                 entity: dict) -> str:
        """Attempt-namespaced gang partition: each recovery attempt —
        retry OR preemption — rendezvouses in a fresh partition, so a
        zombie member of a recovered gang can never corrupt the
        rerun's rows (see names.gang_pk)."""
        return names.gang_pk(self.identity.pool_id, job_id, task_id,
                             attempt=self._gang_attempt(entity))

    def _gang_claim(self, gang_pk: str, instance: int) -> bool:
        """Claim gang instance k for this node. One instance per node:
        a second claim by the same node is released and requeued.
        Quarantined nodes never join a gang — one sick participant
        wedges the whole ICI collective.

        A True return registers the claim in _active_gang_claims;
        the caller must release it on exit (_run_gang_instance's
        finally)."""
        if self.node_quarantined():
            return False
        try:
            self.store.insert_entity(
                names.TABLE_GANGS, gang_pk, f"node${self.identity.node_id}",
                {"instance": instance})
        except EntityExistsError:
            # Our marker already exists: either another slot of this
            # node is live in this gang (bounce), or a crashed slot
            # abandoned its claim (resume).
            return self._resume_own_gang_claim(gang_pk, instance)
        try:
            self.store.insert_entity(
                names.TABLE_GANGS, gang_pk, f"i{instance}", {
                    "node_id": self.identity.node_id,
                    "hostname": self.identity.hostname,
                    "internal_ip": self.identity.internal_ip,
                    "slice_index": self.identity.slice_index,
                    "worker_index": self.identity.worker_index,
                    "state": "joined",
                })
            with self._running_lock:
                self._active_gang_claims.add((gang_pk, instance))
            return True
        except EntityExistsError:
            # Our own instance row with the marker missing (a partial
            # crash undid the marker but leaked the row): resume it,
            # keeping the marker just re-inserted.
            if self._resume_own_gang_claim(gang_pk, instance):
                return True
            # Instance already claimed elsewhere; undo node marker.
            self.store.delete_entity(
                names.TABLE_GANGS, gang_pk,
                f"node${self.identity.node_id}")
            return False
        except Exception:
            # Store fault between the two inserts: without the undo
            # the marker leaks (orphaned gang row) and this node is
            # locked out of the attempt partition forever.
            try:
                self.store.delete_entity(
                    names.TABLE_GANGS, gang_pk,
                    f"node${self.identity.node_id}")
            except Exception:
                logger.exception("gang claim undo failed for %s "
                                 "(terminal sweep will retire it)",
                                 gang_pk)
            raise

    def _resume_own_gang_claim(self, gang_pk: str,
                               instance: int) -> bool:
        """Take back this node's own ABANDONED claim: the instance
        row is ours and still 'joined', but no worker slot here holds
        it live — a store fault after _gang_claim crashed the slot
        out of the rendezvous. The node stays alive, so no gang
        observer will ever judge the row stale, and no other node can
        insert over it: without resume the gang wedges forever.
        Registers the claim atomically with the liveness check so a
        duplicate message copy in another slot cannot double-run."""
        try:
            row = self.store.get_entity(
                names.TABLE_GANGS, gang_pk, f"i{instance}")
        except NotFoundError:
            return False
        if (row.get("node_id") != self.identity.node_id
                or row.get("state") != "joined"):
            return False
        with self._running_lock:
            if (gang_pk, instance) in self._active_gang_claims:
                return False
            self._active_gang_claims.add((gang_pk, instance))
        logger.warning(
            "resuming abandoned gang claim %s i%d (a prior worker "
            "slot crashed out of the rendezvous)", gang_pk, instance)
        return True

    def _gang_members(self, gang_pk: str) -> list[dict]:
        return [e for e in self.store.query_entities(
            names.TABLE_GANGS, partition_key=gang_pk, row_key_prefix="i")]

    def _node_alive(self, node_id: str) -> bool:
        """THE liveness predicate (shared by orphan reclaim and gang
        health): node entity present, not offline, heartbeat fresh.

        Registration grace: a node entity exists from the moment the
        substrate registers it, but its FIRST heartbeat only lands
        once the agent boots — judging heartbeat_at=0 as "dead" let a
        gang observer fail a healthy just-booted member (the startup
        race). A node that has never heartbeated is alive while its
        registration is younger than the staleness window."""
        try:
            node = self.store.get_entity(
                names.TABLE_NODES, self.identity.pool_id, node_id)
        except NotFoundError:
            return False
        if node.get("state") in ("offline",):
            return False
        heartbeat = float(node.get("heartbeat_at", 0) or 0)
        if heartbeat <= 0:
            registered = float(node.get("registered_at", 0) or 0)
            return (registered > 0 and
                    time.time() - registered < self.node_stale_seconds)
        return time.time() - heartbeat < self.node_stale_seconds

    def _stale_gang_members(self, members: list[dict]) -> list[dict]:
        """Joined (not yet done) members whose node died — a
        crashed/preempted gang participant. A broken gang cannot
        produce a correct collective result; the observer fails the
        task fast instead of letting the rendezvous (or the job) hang.
        Critical for gangs on preemptible TPU slices."""
        stale = []
        for member in members:
            if member.get("state") == "done":
                continue
            node_id = member.get("node_id")
            if node_id == self.identity.node_id:
                continue
            if not self._node_alive(node_id):
                stale.append(member)
        return stale

    def _clear_gang_rows(self, gang_pk: str) -> None:
        for row in list(self.store.query_entities(
                names.TABLE_GANGS, partition_key=gang_pk)):
            try:
                self.store.delete_entity(names.TABLE_GANGS, gang_pk,
                                         row["_rk"])
            except NotFoundError:
                pass

    def _sweep_task_expansions(self) -> None:
        """Leader-gated pickup of parked server-side task-factory
        expansions (jobs/expansion.py). The sweep itself only looks —
        one partition query to learn whether any row owes work — then
        spawns at most one dedicated expander thread for the slow
        materialization: a 10^6-task expansion runs for minutes and
        must never ride the heartbeat thread. Every chunk the thread
        commits is fenced on this term's epoch, so a deposed leader's
        in-flight expander goes inert instead of double-writing."""
        if (time.monotonic() - self._last_expansion_sweep
                < self.expansion_sweep_interval):
            return
        self._last_expansion_sweep = time.monotonic()
        thread = self._expander_thread
        if thread is not None and thread.is_alive():
            return  # the running expander drains pending rows itself
        # Look BEFORE leading: the pending probe is one tiny
        # partition query, and taking the lease first would keep the
        # whole pool churning expander terms forever after the last
        # expansion completes. Pending rows only ever appear via
        # `jobs add`, so a pre-lease probe can't miss work for longer
        # than one sweep interval.
        from batch_shipyard_tpu_torch.jobs import expansion as expansion_mod
        if not expansion_mod.pending_expansions(
                self.store, self.identity.pool_id):
            return
        epoch = self._sweep_leader_epoch(state_leases.ROLE_EXPANDER)
        if epoch is None:
            return
        lease = self._sweep_lease(state_leases.ROLE_EXPANDER)

        def _run() -> None:
            try:
                expansion_mod.run_pending_expansions(
                    self.store, self.identity.pool_id,
                    node_id=self.identity.node_id,
                    fenced=lambda: lease.fenced(epoch),
                    stop_check=self.stop_event.is_set)
            except Exception:
                logger.exception("task expansion run failed")

        thread = threading.Thread(
            target=_run,
            name=f"expander-{self.identity.node_id}", daemon=True)
        self._expander_thread = thread
        thread.start()

    def _sweep_lease(self, role: str) -> state_leases.LeaderLease:
        """The named leadership lease of one leader-gated loop,
        created lazily so a node whose sweep never runs (disabled
        preempt interval) never competes for its lease."""
        lease = self._sweep_leases.get(role)
        if lease is None:
            lease = state_leases.LeaderLease(
                self.store,
                key=names.leader_lease_key(self.identity.pool_id,
                                           role),
                epoch_key=names.leader_epoch_key(
                    self.identity.pool_id, role),
                owner=self.identity.node_id,
                duration_seconds=self.leader_lease_seconds,
                blocked=lambda: (time.time()
                                 < self.lease_blackout_until))
            self._sweep_leases[role] = lease
        return lease

    def _sweep_leader_epoch(self, role: str) -> Optional[int]:
        """Leadership gate for leader-gated sweeps: the current
        term's fencing epoch while THIS node holds the role's lease,
        None otherwise. Replaces the old heartbeat-freshness election
        (`_is_gang_sweep_leader`): a lease can only be extended
        through the store, so a partitioned leader abdicates on its
        own clock strictly before a successor can acquire — there is
        no double-leader window — and the epoch fences every sweep
        write a deposed leader might still have in flight."""
        try:
            return self._sweep_lease(role).epoch()
        except Exception:  # noqa: BLE001 - store hiccup = not leader
            logger.debug("sweep lease check failed for %s", role,
                         exc_info=True)
            return None

    def _store_bounded(self, seconds: float):
        """Bounded critical-retry window when the store wrapper
        supports it (state/resilient.py ``bounded``); an identity
        context on a bare store, where transport errors surface
        immediately anyway."""
        bounded = getattr(self.store, "bounded", None)
        if callable(bounded):
            return bounded(seconds)
        return contextlib.nullcontext()

    def _renew_sweep_leases(self) -> None:
        """Heartbeat-cadence renewal of HELD sweep leases (sweep
        intervals can exceed the lease duration; the heartbeat is
        the keepalive). Renew-only: acquisition belongs to the gated
        loops themselves."""
        for lease in self._sweep_leases.values():
            try:
                lease.maintain()
            except Exception:  # noqa: BLE001 - heartbeat survives
                logger.debug("sweep lease renew failed",
                             exc_info=True)

    def _sweep_orphaned_gangs(self) -> None:
        """Janitor for leaked rendezvous rows: a gang cleanup
        interrupted mid-flight (store fault between a task's state
        transition and its row clear, or a claim whose second insert
        failed) is never retried by the member that owed it — the
        rows would outlive their task forever. Any partition whose
        task is terminal, gone, or already past that attempt
        (entity retries advanced) is garbage. Clearing is
        idempotent, so concurrent sweepers on other nodes are
        harmless."""
        if (time.monotonic() - self._last_gang_sweep
                < self.gang_sweep_interval):
            return
        self._last_gang_sweep = time.monotonic()
        # One sweeper per pool: the table scan below is unpartitioned
        # (no prefix query in the store interface), so N nodes each
        # scanning every interval would multiply fleet-wide read
        # traffic for zero extra safety. The janitor lease elects
        # exactly one sweeper per term (state/leases.py) — no
        # failover window at all, unlike the old heartbeat-freshness
        # election.
        epoch = self._sweep_leader_epoch(
            state_leases.ROLE_GANG_JANITOR)
        if epoch is None:
            return
        prefix = f"{self.identity.pool_id}$"
        seen: set[str] = set()
        lease = self._sweep_lease(state_leases.ROLE_GANG_JANITOR)
        for row in list(self.store.query_entities(names.TABLE_GANGS)):
            pk = row["_pk"]
            if pk in seen or not pk.startswith(prefix):
                continue
            seen.add(pk)
            base, _, suffix = pk.partition("#g")
            try:
                attempt = int(suffix) if suffix else 0
            except ValueError:
                continue
            parts = base.split("$")
            if len(parts) != 3:
                continue
            _, job_id, task_id = parts
            try:
                entity = self._task_entity(job_id, task_id)
            except NotFoundError:
                entity = None
            if (entity is not None
                    and entity.get("state")
                    not in names.TERMINAL_TASK_STATES
                    and self._gang_attempt(entity) <= attempt):
                # Live (or future) rendezvous attempt — not garbage.
                continue
            # Fencing re-check BEFORE the write: the scan above can
            # outlive the term (satellite audit — the verdict cached
            # at the top of the loop must not authorize a stale
            # clear). Clearing is idempotent, so this only bounds
            # the deposed leader's wasted work, but the discipline
            # is uniform across every fenced sweep.
            if not lease.fenced(epoch):
                return
            logger.warning("sweeping orphaned gang rows in %s", pk)
            self._clear_gang_rows(pk)

    def _clear_gang_history(self, job_id: str, task_id: str,
                            attempts: int) -> None:
        """Retire EVERY attempt's rendezvous partition once the task
        is terminal. An earlier attempt can leak rows when its
        cleanup was cut short mid-flight (a store fault between the
        requeue transition and its clear, or a claim whose second
        insert failed): nothing retries those clears, so the
        terminal transition sweeps attempts 0..attempts (the combined
        retries+preempt_count index, _gang_attempt) to self-repair.
        Best-effort per partition — a fault here leaves at most what
        was already leaked."""
        for attempt in range(attempts + 1):
            pk = names.gang_pk(self.identity.pool_id, job_id,
                               task_id, attempt=attempt)
            try:
                self._clear_gang_rows(pk)
            except Exception:
                logger.exception("gang row sweep failed for %s", pk)

    def _recover_broken_gang(self, job_id: str, task_id: str,
                             gang_pk: str, stale: list[dict],
                             msg, attempt: int = 0) -> None:
        """Checkpoint-aware gang requeue: a gang that lost a member
        (preemption, crash, wedge-killed node) is RE-RUN from its
        latest COMMITTED checkpoint instead of failed terminally —
        within the retry budget the whole gang requeues with backoff
        (the rerun's restore pulls the committed step, so only the
        steps since that checkpoint are rework: exactly the
        preemption_recovery badput the goodput engine prices).
        Exhausting the budget quarantines the task with diagnostics.

        Every surviving member observes the same breakage; the
        etag-guarded requeue/quarantine merge elects one recoverer —
        losers only drop their message."""
        dead = sorted({m.get("node_id", "?") for m in stale})
        try:
            entity = self._task_entity(job_id, task_id)
        except NotFoundError:
            self.store.delete_message(msg)
            return
        retries = int(entity.get("retries", 0))
        if entity.get("state") in names.TERMINAL_TASK_STATES or \
                self._gang_attempt(entity) != attempt:
            # Terminally resolved, or a peer already recovered this
            # attempt (every recovery bumps the combined attempt
            # index — state alone can't discriminate: a gang broken
            # during FORMATION is still legitimately "pending").
            self.store.delete_message(msg)
            return
        spec = entity["spec"]
        max_retries = spec.get("max_task_retries", 0)
        num_instances = spec["multi_instance"]["num_instances"]
        # Elastic resize: the rerun re-forms at whatever the pool can
        # actually supply — shrinking when nodes were lost, growing
        # back toward the spec size when capacity returned. The
        # rerun's restore re-shards the committed checkpoint onto the
        # new mesh (parallel/sharding.reshard_on_restore).
        eff_size, new_size = self._elastic_size(spec, entity)
        reason = f"gang member(s) lost: {dead}"
        decision = self._retry_decision(retries, max_retries)
        logger.warning("gang %s/%s lost member(s) %s; %s",
                       job_id, task_id, dead,
                       (f"requeuing at size {new_size} from "
                        f"committed checkpoint")
                       if decision == "requeue"
                       else "retry budget exhausted")
        if decision == "requeue":
            if self._requeue_with_backoff(
                    job_id, task_id, spec, retries + 1, -4, reason,
                    instances=new_size,
                    if_match=entity["_etag"],
                    extra={names.TASK_COL_GANG_SIZE:
                           new_size if new_size != num_instances
                           else None}):
                goodput_events.emit(
                    self.store, self.identity.pool_id,
                    goodput_events.NODE_PREEMPTED, job_id=job_id,
                    task_id=task_id,
                    attrs={"dead_nodes": dead, "gang": True})
                if new_size != eff_size:
                    self._emit_gang_resize(job_id, task_id, entity,
                                           eff_size, new_size,
                                           retries + 1)
                self._clear_gang_rows(gang_pk)
        elif decision == "quarantine":
            # A configured budget got burned: poison quarantine with
            # the diagnostics bundle.
            if self._quarantine_task(job_id, task_id, -4, reason,
                                     if_match=entity["_etag"]):
                self._clear_gang_history(job_id, task_id,
                                         self._gang_attempt(entity))
                self._maybe_autocomplete_job(job_id)
        else:
            # No retry budget configured (max_task_retries=0): the
            # legacy fail-fast contract — terminal "failed", exit -4.
            try:
                self._merge_task(job_id, task_id, {
                    "state": "failed", "exit_code": -4,
                    "error": reason,
                    "completed_at": util.datetime_utcnow_iso()},
                    if_match=entity["_etag"])
            except (EtagMismatchError, NotFoundError):
                self.store.delete_message(msg)
                return
            self._clear_gang_history(job_id, task_id,
                                     self._gang_attempt(entity))
            self._maybe_autocomplete_job(job_id)
        self.store.delete_message(msg)

    def _run_gang_instance(self, slot: int, job_id: str, task_id: str,
                           entity: dict, instance: int, msg) -> None:
        spec = entity["spec"]
        # Elastic resize: the CURRENT attempt's effective size may be
        # below the spec's num_instances (gang_size stamped by
        # _recover_broken_gang when nodes were lost).
        num_instances = int(
            entity.get(names.TASK_COL_GANG_SIZE)
            or spec["multi_instance"]["num_instances"])
        if instance >= num_instances:
            # Stale message from a larger pre-resize attempt: this
            # instance index no longer exists at the current size —
            # joining would corrupt the smaller rendezvous.
            self.store.delete_message(msg)
            return
        gang_pk = self._gang_pk(job_id, task_id, entity)
        if not self._gang_claim(gang_pk, instance):
            # This node can't take this instance. Probe gang health at
            # most once per heartbeat interval per gang — the bounce
            # path spins during normal formation on large pools.
            probe_key = (job_id, task_id)
            now = time.monotonic()
            if now - self._gang_probe_at.get(probe_key, 0.0) > max(
                    1.0, self.heartbeat_interval):
                self._gang_probe_at[probe_key] = now
                members = self._gang_members(gang_pk)
                if (len(members) >= num_instances and all(
                        m.get("state") == "done" for m in members)):
                    # Whole gang finished but the last member crashed
                    # between marking done and finalizing: finish the
                    # aggregation on its behalf.
                    self._gang_finalize(job_id, task_id, gang_pk,
                                        num_instances)
                    self.store.delete_message(msg)
                    self._maybe_autocomplete_job(job_id)
                    return
                stale = self._stale_gang_members(members)
                if stale:
                    self._recover_broken_gang(
                        job_id, task_id, gang_pk, stale, msg,
                        attempt=self._gang_attempt(entity))
                    return
            # Otherwise make the message promptly available for other
            # nodes.
            self.store.update_message(msg, visibility_timeout=0.0)
            time.sleep(self.poll_interval)
            return
        try:
            self._run_gang_claimed(slot, job_id, task_id, entity,
                                   instance, msg, gang_pk,
                                   num_instances, spec)
        finally:
            # Release the slot-local claim registration taken by
            # _gang_claim however we exit; a crash here leaves the
            # rows joined+ours, and the redelivered message resumes
            # them through _resume_own_gang_claim.
            with self._running_lock:
                self._active_gang_claims.discard((gang_pk, instance))

    def _run_gang_claimed(self, slot: int, job_id: str, task_id: str,
                          entity: dict, instance: int, msg,
                          gang_pk: str, num_instances: int,
                          spec: dict) -> None:
        """Post-claim gang path: rendezvous, run, aggregate. The
        caller holds this node's active-claim registration for
        (gang_pk, instance) and releases it when this returns."""
        self._goodput_work_started(slot, job_id, task_id, entity,
                                   emit_queued=(instance == 0))
        # Rendezvous: wait for all instances to join, watching for
        # members dying underneath us (preemption/crash).
        deadline = time.monotonic() + self.gang_timeout
        keepalive = time.monotonic()
        last_stale_check = 0.0
        rendezvous_started = time.time()
        while True:
            members = self._gang_members(gang_pk)
            if len(members) >= num_instances:
                break
            if time.monotonic() - last_stale_check > max(
                    1.0, self.heartbeat_interval):
                stale = self._stale_gang_members(members)
                if stale:
                    self._recover_broken_gang(
                        job_id, task_id, gang_pk, stale, msg,
                        attempt=self._gang_attempt(entity))
                    self._goodput_work_done(slot)
                    return
                last_stale_check = time.monotonic()
            if time.monotonic() > deadline:
                retries = int(entity.get("retries", 0))
                attempt = self._gang_attempt(entity)
                try:
                    fresh = self._task_entity(job_id, task_id)
                except NotFoundError:
                    fresh = None
                if (fresh is not None
                        and fresh.get("state")
                        not in names.TERMINAL_TASK_STATES
                        and self._gang_attempt(fresh) == attempt):
                    # Elastic gang stuck in FORMATION because the
                    # pool shrank below its size (members that never
                    # joined have no stale row to observe): re-form
                    # at what the pool can supply instead of failing
                    # — the resize analog of _recover_broken_gang.
                    eff_size, new_size = self._elastic_size(
                        spec, fresh)
                    if (new_size != eff_size
                            and self._retry_decision(
                                retries,
                                spec.get("max_task_retries", 0))
                            == "requeue"):
                        if self._requeue_with_backoff(
                                job_id, task_id, spec, retries + 1,
                                -1, "gang rendezvous timeout "
                                    "(resizing)",
                                instances=new_size,
                                if_match=fresh["_etag"],
                                extra={names.TASK_COL_GANG_SIZE:
                                       new_size
                                       if new_size != spec[
                                           "multi_instance"][
                                           "num_instances"]
                                       else None}):
                            self._emit_gang_resize(
                                job_id, task_id, fresh, eff_size,
                                new_size, retries + 1)
                            self._clear_gang_rows(gang_pk)
                        self.store.delete_message(msg)
                        self._goodput_work_done(slot)
                        return
                    try:
                        self._merge_task(job_id, task_id, {
                            "state": "failed", "exit_code": -1,
                            "error": "gang rendezvous timeout",
                            "completed_at":
                                util.datetime_utcnow_iso()},
                            if_match=fresh["_etag"])
                    except (EtagMismatchError, NotFoundError):
                        # A peer recovered/terminated the task
                        # concurrently — its transition wins.
                        self.store.delete_message(msg)
                        self._goodput_work_done(slot)
                        return
                    # Terminal: retire the rendezvous rows now, not
                    # at the janitor's next leader pass.
                    self._clear_gang_history(job_id, task_id, attempt)
                self.store.delete_message(msg)
                self._goodput_work_done(slot)
                return
            if self.stop_event.is_set():
                self._goodput_work_done(slot)
                return
            # Renew the claim on the same cadence as
            # _message_keepalive: the visibility window is
            # configurable (drills shrink it below the old hardcoded
            # 30s renew), and a lapsed window mid-rendezvous means
            # duplicate redeliveries churning the bounce path.
            if time.monotonic() - keepalive > max(
                    0.5, self.claim_visibility_seconds / 3.0):
                self.store.update_message(
                    msg,
                    visibility_timeout=self.claim_visibility_seconds)
                keepalive = time.monotonic()
            time.sleep(self.poll_interval)
        # Full formation: the rendezvous span is per INSTANCE (each
        # member's own wait — the straggler analysis the gang
        # scheduler needs is exactly the spread of these).
        trace_spans.emit(
            self.store, self.identity.pool_id,
            trace_spans.SPAN_RENDEZVOUS,
            trace_context.TraceContext.from_entity(entity),
            job_id=job_id, task_id=task_id,
            node_id=self.identity.node_id,
            start=rendezvous_started, end=time.time(),
            attrs={"instance": instance,
                   "gang_size": num_instances,
                   "attempt": self._gang_attempt(entity)})
        if instance == 0:
            try:
                self._merge_task(job_id, task_id, {
                    "state": "running",
                    "started_at": util.datetime_utcnow_iso(),
                    # Recovery intervals closed by this attempt (the
                    # gang analog of _claim_regular's clear).
                    names.TASK_COL_PREEMPTED_AT: None,
                    names.TASK_COL_EVICTED_AT: None})
            except NotFoundError:
                pass
        gang_members = [
            launcher.GangMember(
                instance=int(m["_rk"][1:]), node_id=m["node_id"],
                hostname=m["hostname"], internal_ip=m["internal_ip"],
                slice_index=m.get("slice_index", 0),
                worker_index=m.get("worker_index", 0))
            for m in sorted(self._gang_members(gang_pk),
                            key=lambda e: int(e["_rk"][1:]))]
        me = next(m for m in gang_members if m.instance == instance)
        mi = _mi_settings_from_spec(spec["multi_instance"],
                                    num_instances=num_instances)
        gang_env = launcher.synthesize_gang_env(
            gang_members, me, mi, self.pool)
        with self._message_keepalive(msg):
            jp_ok = self._ensure_job_prep(job_id, spec)
            try:
                self._ensure_images_timed(job_id, task_id, spec,
                                          entity=entity)
                execution = self._build_execution(
                    slot, job_id, task_id, spec, instance=instance,
                    instances=num_instances,
                    host_list=tuple(m.internal_ip
                                    for m in gang_members),
                    extra_env=gang_env, entity=entity)
            except TaskEnvError as exc:
                # Record the instance failure through the normal gang
                # aggregation (a raise here would bounce the message
                # forever — the same hazard as the scratch-mount
                # failure above), and surface the REASON on the task
                # entity so the user doesn't have to grep node logs.
                logger.error("gang %s/%s i%d: %s", job_id, task_id,
                             instance, exc)
                try:
                    self._merge_task(job_id, task_id,
                                     {"error": str(exc)})
                except NotFoundError:
                    pass
                jp_ok = False
                execution = self._build_execution(
                    slot, job_id, task_id,
                    {**spec, "environment_variables": {},
                     "environment_variables_secret_id": None},
                    instance=instance, instances=num_instances,
                    host_list=tuple(m.internal_ip
                                    for m in gang_members),
                    extra_env=gang_env, entity=entity)
            try:
                self._stage_inputs(spec, execution)
            except Exception as exc:
                logger.exception("gang input staging failed for %s/%s",
                                 job_id, task_id)
                jp_ok = False
            with self._running_lock:
                self._running_tasks += 1
            try:
                if not jp_ok:
                    result = task_runner.TaskResult(
                        exit_code=-2, stdout_path="", stderr_path="",
                        started_at=util.datetime_utcnow_iso(),
                        completed_at=util.datetime_utcnow_iso(),
                        wall_seconds=0.0)
                else:
                    if spec["multi_instance"].get("coordination_command"):
                        coordination = dataclasses.replace(
                            execution,
                            command=spec["multi_instance"][
                                "coordination_command"],
                            task_dir=os.path.join(
                                execution.task_dir, "coord"))
                        task_runner.run_task(coordination)
                    # Register the live proc like the regular path:
                    # term_task control verbs and chaos task_kill/
                    # task_wedge injections target gang instances too.
                    # The slot ledger is armed as a GANG record: a
                    # restarted agent cannot re-join the in-memory
                    # rendezvous this launch belonged to, but it must
                    # learn a member process may still be alive and
                    # fence it before the gang's requeue re-runs it.
                    result = self._run_task_registered(
                        (job_id, task_id), execution,
                        ledger_slot=slot, ledger_gang=True)
            finally:
                with self._running_lock:
                    self._running_tasks -= 1
        if self._abandoned:
            # Simulated agent-process death mid-gang-run (chaos
            # agent_restart): a dead process writes nothing — the
            # gang's recovery paths own the task from here.
            return
        # The member process exited and we're alive to record it: the
        # gang ledger's only job (fencing a leftover live process on
        # restart) is done.
        self._clear_slot_ledger(slot, (job_id, task_id))
        gang_evicted = (job_id, task_id) in self._evicted_locally
        self._evicted_locally.discard((job_id, task_id))
        self._note_task_outcome(
            result.exit_code == 0, wedged=result.wedged,
            neutral=(result.exit_code == preempt_mod.EXIT_PREEMPTED
                     or gang_evicted))
        try:
            self.store.merge_entity(
                names.TABLE_GANGS, gang_pk, f"i{instance}",
                {"state": "done", "exit_code": result.exit_code})
        except NotFoundError:
            # The gang was recovered (requeued under a new attempt
            # partition) while this instance was running: its result
            # belongs to a superseded attempt. Clean up and bow out —
            # the rerun owns the task entity now.
            logger.warning(
                "gang %s/%s i%d finished after the gang was "
                "recovered; discarding superseded result",
                job_id, task_id, instance)
            self._goodput_task_finished(slot, job_id, task_id, result,
                                        entity=entity,
                                        instance=instance)
            self.store.delete_message(msg)
            return
        try:
            self._upload_outputs(job_id, task_id, execution,
                                 suffix=f"i{instance}")
        except Exception as exc:  # noqa: BLE001 - classify anyway
            # Same rule as _finish_regular_result: the gang finalize
            # below must run even when the blob upload fails.
            logger.exception("gang output upload failed for %s/%s",
                             job_id, task_id)
            try:
                self._merge_task(job_id, task_id,
                                 {"output_error": str(exc)})
            except Exception:  # noqa: BLE001 - best effort
                pass
        self._ingest_goodput(job_id, task_id, execution)
        self._upload_profile_artifacts(job_id, task_id, execution,
                                       suffix=f"i{instance}")
        self._export_compile_cache()
        self._goodput_task_finished(slot, job_id, task_id, result,
                                    entity=entity, instance=instance)
        try:
            self._collect_outputs(spec, execution, job_id, task_id)
        except Exception as exc:
            logger.exception("gang output collection failed for %s/%s",
                             job_id, task_id)
            self._merge_task(job_id, task_id,
                             {"output_error": str(exc)})
        self._schedule_retention(spec, job_id, task_id)
        self.store.delete_message(msg)
        self._gang_finalize(job_id, task_id, gang_pk, num_instances)
        self._maybe_autocomplete_job(job_id)

    def _gang_finalize(self, job_id: str, task_id: str, gang_pk: str,
                       num_instances: int) -> None:
        """Last instance to finish aggregates the gang exit code. A
        failing gang (any nonzero member) retries WHOLE — same
        supervisor as regular tasks: backoff requeue within the
        budget (the rerun restores from the committed checkpoint),
        quarantine past it."""
        members = self._gang_members(gang_pk)
        done = [m for m in members if m.get("state") == "done"]
        if len(done) < num_instances:
            return
        # First nonzero wins (max() would mask negative signal-kill
        # codes behind a zero).
        nonzero = [m.get("exit_code", 0) for m in done
                   if m.get("exit_code", 0) != 0]
        exit_code = nonzero[0] if nonzero else 0
        # A gang is preempted only when EVERY nonzero member drained
        # cooperatively: one real failure among the 75s is a failure
        # (the retry supervisor's budget applies), not a preemption.
        if nonzero and all(c == preempt_mod.EXIT_PREEMPTED
                           for c in nonzero):
            exit_code = preempt_mod.EXIT_PREEMPTED
        elif exit_code == preempt_mod.EXIT_PREEMPTED:
            exit_code = next(c for c in nonzero
                             if c != preempt_mod.EXIT_PREEMPTED)
        try:
            entity = self._task_entity(job_id, task_id)
        except NotFoundError:
            return
        if entity.get("state") in names.TERMINAL_TASK_STATES or \
                entity.get("state") in names.CLAIMABLE_TASK_STATES:
            # Terminal, or already requeued (pending/preempted) by a
            # concurrent recoverer — nothing left to aggregate.
            return
        spec = entity["spec"]
        retries = int(entity.get("retries", 0))
        max_retries = spec.get("max_task_retries", 0)
        # An escalated request on the entity classifies a nonzero
        # gang exit as evicted: every member was hard-killed (or died
        # with the kill racing its own exit) — one externally-caused
        # transition for the whole gang, never a budgeted failure.
        request = entity.get(names.TASK_COL_PREEMPT_REQUEST)
        evicted = (exit_code not in (0, preempt_mod.EXIT_PREEMPTED)
                   and isinstance(request, dict)
                   and bool(request.get("escalated_at")))
        decision = ("complete" if exit_code == 0
                    else "preempted"
                    if exit_code == preempt_mod.EXIT_PREEMPTED
                    else "evicted" if evicted
                    else self._retry_decision(retries, max_retries))
        if decision == "evicted":
            if self._requeue_evicted(job_id, task_id, spec,
                                     instances=num_instances):
                self._clear_gang_rows(gang_pk)
                return
            decision = self._retry_decision(retries, max_retries)
        if decision == "preempted":
            # The whole gang drained cooperatively (every member ran
            # the same preempt-aware program): requeue all instances
            # at full budget. The effective size is preserved — a
            # resized gang stays at its size until a recovery path
            # recomputes it from live capacity.
            if self._requeue_preempted(job_id, task_id, spec,
                                       instances=num_instances):
                self._clear_gang_rows(gang_pk)
                return
            # No pending request (spurious 75) or a lost merge: the
            # retry supervisor prices it like any failure.
            decision = self._retry_decision(retries, max_retries)
        if decision == "requeue":
            # The rerun's size follows live capacity too: a gang
            # whose members were killed by dying nodes finalizes with
            # their exit codes (the nodes' threads flushed them
            # before dying), and requeuing at the spec size onto a
            # shrunken pool would wedge the rendezvous.
            eff_size, new_size = self._elastic_size(spec, entity)
            if self._requeue_with_backoff(
                    job_id, task_id, spec, retries + 1, exit_code,
                    f"gang exit code {exit_code}",
                    instances=new_size,
                    if_match=entity["_etag"],
                    extra={names.TASK_COL_GANG_SIZE:
                           new_size
                           if new_size != spec["multi_instance"][
                               "num_instances"]
                           else None}):
                if new_size != eff_size:
                    self._emit_gang_resize(job_id, task_id, entity,
                                           eff_size, new_size,
                                           retries + 1)
                self._clear_gang_rows(gang_pk)
            return
        if decision == "quarantine":
            if self._quarantine_task(
                    job_id, task_id, exit_code,
                    f"gang exit code {exit_code}",
                    if_match=entity["_etag"]):
                self._clear_gang_history(job_id, task_id,
                                         self._gang_attempt(entity))
            return
        try:
            self._merge_task(job_id, task_id, {
                "state": "completed" if exit_code == 0 else "failed",
                "exit_code": exit_code,
                "completed_at": util.datetime_utcnow_iso(),
            }, if_match=entity["_etag"])
        except (EtagMismatchError, NotFoundError):
            return
        # Terminal: retire the rendezvous partitions (every attempt)
        # so no gang rows outlive their task (the drill's
        # no-orphaned-state invariant). Late zombie members of this
        # attempt get NotFoundError on their done-merge and bow out.
        self._clear_gang_history(job_id, task_id,
                                 self._gang_attempt(entity))

    # --------------------------- helpers -------------------------------

    def _resolve_env_secrets(self, env: dict) -> dict:
        """Resolve secret:// values in task/job environment_variables
        ON NODE at launch time (reference analog: convoy/batch.py
        :4556-4577 merges keyvault secret ids into per-task env, with
        on-node decrypt via nodeprep :1281). The state store only ever
        holds the refs; the plaintext exists in the task process env
        and nowhere else. SHIPYARD_SECRETS_FILE points the agent at a
        file-provider secrets YAML when one is used."""
        from batch_shipyard_tpu_torch.utils import secrets as secrets_mod
        resolved = {}
        secrets_file = os.environ.get("SHIPYARD_SECRETS_FILE")
        for key, value in env.items():
            if secrets_mod.is_secret_id(value):
                value = secrets_mod.resolve_secret(
                    value, secrets_file=secrets_file)
            resolved[key] = value
        return resolved

    def _resolve_env_block(self, job_id: str,
                           secret_id: str) -> dict:
        """Resolve a secret holding a WHOLE env-var map (YAML/JSON
        mapping, or KEY=VALUE lines) — the reference's
        environment_variables_keyvault_secret_id (keyvault.py:176).
        Explicit per-key env always wins over the block. Cached per
        (job, secret) so a 1000-task job costs one provider round
        trip per node. Raises ValueError on an unparseable/empty
        block — running a task silently missing its env vars is
        worse than failing it."""
        cache_key = (job_id, secret_id)
        cached = self._env_block_cache.get(cache_key)
        if cached is not None:
            return cached
        from batch_shipyard_tpu_torch.utils import secrets as secrets_mod
        raw = secrets_mod.resolve_secret(
            secret_id,
            secrets_file=os.environ.get("SHIPYARD_SECRETS_FILE"))
        import yaml
        block = None
        try:
            # YAML is a JSON superset: one parse covers both
            # documented map formats. A dotenv line like
            # 'MSG=hello: world' also parses as a YAML mapping — but
            # with '=' inside the key, which no real env map has; in
            # that case fall through to the KEY=VALUE parser.
            parsed = yaml.safe_load(raw)
            if isinstance(parsed, dict) and not any(
                    "=" in str(k) for k in parsed):
                block = parsed
        except yaml.YAMLError:
            pass
        if block is None:
            block = {}
            for line in raw.splitlines():
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                key, _, value = line.partition("=")
                block[key.strip()] = value.strip()
        if not block:
            raise ValueError(
                f"env-block secret {secret_id} resolved to no "
                f"variables (expect a YAML/JSON mapping or KEY=VALUE "
                f"lines)")
        resolved = {str(k): str(v) for k, v in block.items()}
        # Bounded: jobs that never trigger a release fan-out on this
        # node (no prep/inputs/scratch) must not pin secret material
        # in memory for the process lifetime.
        if len(self._env_block_cache) >= 32:
            self._env_block_cache.pop(
                next(iter(self._env_block_cache)))
        self._env_block_cache[cache_key] = resolved
        return resolved

    def _build_execution(self, slot: int, job_id: str, task_id: str,
                         spec: dict, instance: int = 0, instances: int = 1,
                         host_list: tuple[str, ...] = (),
                         extra_env: Optional[dict] = None,
                         entity: Optional[dict] = None,
                         ) -> task_runner.TaskExecution:
        from batch_shipyard_tpu_torch.utils import secrets as secrets_mod
        try:
            env = self._resolve_env_secrets(
                dict(spec.get("environment_variables", {})))
            env_secret = spec.get("environment_variables_secret_id")
            if env_secret:
                for key, value in self._resolve_env_block(
                        job_id, env_secret).items():
                    env.setdefault(key, value)
        except (secrets_mod.SecretResolutionError, ValueError) as exc:
            raise TaskEnvError(
                f"environment synthesis failed: {exc}") from exc
        env["SHIPYARD_JOB_SHARED_DIR"] = self._job_shared_dir(job_id)
        if spec.get("auto_scratch"):
            try:
                env["SHIPYARD_JOB_SCRATCH"] = self._resolve_scratch(
                    job_id, spec)
            except RuntimeError:
                # Shared-scratch resolution can only fail here when
                # job prep already failed on this node (success caches
                # the path) — the task will not run, but the gang path
                # still needs a constructible execution to record the
                # instance's failure instead of bouncing the message
                # forever.
                env["SHIPYARD_JOB_SCRATCH"] = \
                    self._job_scratch_dir(job_id)
        if extra_env:
            env.update(extra_env)
        task_dir = os.path.join(
            self.work_dir, "tasks", job_id, task_id,
            f"i{instance}" if instances > 1 else "")
        # Program-phase goodput sink: workloads record compile / step
        # windows / checkpoint spans here; the agent ingests the file
        # into TABLE_GOODPUT after the task exits.
        env.setdefault(
            goodput_events.GOODPUT_FILE_ENV,
            os.path.join(task_dir.rstrip("/"),
                         "goodput_events.jsonl"))
        # Wedge-watchdog liveness file: instrumented workloads beat it
        # every step (agent/progress.py); the task runner kills tasks
        # whose spec declares progress_deadline_seconds when it goes
        # stale.
        env.setdefault(
            progress_mod.PROGRESS_FILE_ENV,
            os.path.join(task_dir.rstrip("/"), "progress_beat"))
        if spec.get("progress_deadline_seconds") is not None:
            # Export the deadline too: beat() scales its write
            # throttle to it, so a tight deadline can't be starved by
            # the throttle itself.
            env.setdefault(
                progress_mod.PROGRESS_DEADLINE_ENV,
                str(spec["progress_deadline_seconds"]))
        # Scheduling-hints contract: instrumented workloads publish
        # {step, ckpt_step, step_seconds, cache_identity} here
        # (agent/progress.py record_sched_hints); the heartbeat loop
        # mirrors the file into the task row's sched_hints column for
        # the preemption sweep's victim-cost policy.
        env.setdefault(
            progress_mod.SCHED_HINTS_FILE_ENV,
            os.path.join(task_dir.rstrip("/"), "sched_hints.json"))
        # Declared compile-cache identity (claim affinity's key),
        # exported so the workload enables the persistent cache under
        # the same identity the scheduler placed it by.
        if spec.get("compile_cache_identity"):
            env.setdefault("SHIPYARD_COMPILE_CACHE_IDENTITY",
                           str(spec["compile_cache_identity"]))
        # Cooperative-preemption contract: the heartbeat loop drops a
        # preempt request here; instrumented workloads poll it each
        # step (PreemptWatcher), drain, force-commit, and exit
        # EXIT_PREEMPTED.
        env.setdefault(
            preempt_mod.PREEMPT_REQUEST_FILE_ENV,
            os.path.join(task_dir.rstrip("/"),
                         "preempt_request.json"))
        # A request file left by a PREVIOUS attempt must not drain
        # the new one on its first step: the request was consumed by
        # the attempt it preempted (the .delivered marker keeps the
        # heartbeat loop from re-dropping that requested_at), so the
        # rerun starts clean.
        try:
            os.remove(env[preempt_mod.PREEMPT_REQUEST_FILE_ENV])
        except OSError:
            pass
        # Distributed-trace contract: the task row's context is
        # exported so every program span/goodput event the process
        # records parents under the task's run span; the JSONL span
        # sink is ingested post-task like the goodput file.
        ctx = trace_context.TraceContext.from_entity(entity or {})
        if ctx is not None:
            for key, value in ctx.env().items():
                env.setdefault(key, value)
            env.setdefault(
                trace_context.TRACE_FILE_ENV,
                os.path.join(task_dir.rstrip("/"),
                             "trace_spans.jsonl"))
        # On-demand profiling contract: the harness watches the
        # request file (trace/profiling.StepProfiler) and writes the
        # torch.profiler artifact into the profile dir, which the agent
        # uploads post-task. A request already pending at launch is
        # delivered right here; requests arriving mid-run are
        # delivered by the heartbeat loop.
        env.setdefault(
            trace_profiling.PROFILE_REQUEST_FILE_ENV,
            os.path.join(task_dir.rstrip("/"),
                         "profile_request.json"))
        env.setdefault(
            trace_profiling.PROFILE_DIR_ENV,
            os.path.join(task_dir.rstrip("/"), "profile"))
        request = self._cached_job_profile_request(job_id)
        if request is not None:
            # Launch-time delivery goes straight to this instance's
            # env path (the task dir may not exist yet —
            # write_request creates it); the per-path dedup keeps the
            # heartbeat loop from re-dropping the same request after
            # the harness consumed it, without starving sibling gang
            # instances of their own copies.
            self._deliver_profile_file(
                env[trace_profiling.PROFILE_REQUEST_FILE_ENV],
                request)
        # Warm-start compilation: every task sees the node's
        # persistent compile cache dir, seeded from the pool artifact
        # just before launch so restarts and late pool joiners
        # deserialize instead of compiling.
        env.setdefault(cc_manager.CACHE_DIR_ENV,
                       self._compile_cache_dir())
        with trace_spans.span(
                self.store, self.identity.pool_id,
                trace_spans.SPAN_CACHE_SEED, ctx, job_id=job_id,
                task_id=task_id, node_id=self.identity.node_id):
            self._seed_compile_cache()
        return task_runner.TaskExecution(
            pool_id=self.identity.pool_id, job_id=job_id, task_id=task_id,
            node_id=self.identity.node_id,
            node_index=self.identity.node_index,
            command=spec.get("command", ""),
            runtime=spec.get("runtime", "none"),
            container_runtime=spec.get("container_runtime", "runc"),
            image=spec.get("image"),
            env=env, task_dir=task_dir.rstrip("/"), slot=slot,
            instances=instances, instance=instance, host_list=host_list,
            max_wall_time_seconds=spec.get("max_wall_time_seconds"),
            progress_deadline_seconds=spec.get(
                "progress_deadline_seconds"),
            remove_container_after_exit=spec.get(
                "remove_container_after_exit", True),
            shm_size=spec.get("shm_size"),
            additional_docker_run_options=tuple(
                spec.get("additional_docker_run_options", [])),
            additional_singularity_options=tuple(
                spec.get("additional_singularity_options", [])),
            # Crash-restart adoption contract: the task's exit code
            # is persisted in its task_dir so a restarted agent can
            # classify an exit it never wait()ed on.
            record_exit_code=True,
        )

    def _ensure_job_prep(self, job_id: str, spec: dict,
                         wait_timeout: float = 600.0) -> bool:
        """Run job preparation exactly once per (job, node); other slots
        wait for it. Returns False if prep failed — the caller must not
        run the task on this node (Azure Batch jobPreparationTask
        semantics)."""
        jp_command = spec.get("job_preparation_command")
        job_inputs = spec.get("job_input_data") or []
        auto_scratch = spec.get("auto_scratch")
        if not jp_command and not job_inputs and not auto_scratch:
            return True
        pk = names.task_pk(self.identity.pool_id, job_id)
        try:
            self.store.insert_entity(
                names.TABLE_JOBPREP, pk, self.identity.node_id,
                {"state": "running", "at": util.datetime_utcnow_iso()})
        except EntityExistsError:
            # Another slot owns prep: wait for completion.
            deadline = time.monotonic() + wait_timeout
            while time.monotonic() < deadline:
                row = self.store.get_entity(
                    names.TABLE_JOBPREP, pk, self.identity.node_id)
                if row.get("state") == "done":
                    return row.get("exit_code", 0) == 0
                if self.stop_event.is_set():
                    return False
                time.sleep(self.poll_interval)
            return False
        exit_code = 0
        try:
            if auto_scratch:
                # Per-job scratch with job lifetime (BeeOND analog):
                # created here, removed by job release.
                os.makedirs(self._resolve_scratch(job_id, spec),
                            exist_ok=True)
            # Job-level input_data lands in the job's shared dir
            # (exposed to tasks as SHIPYARD_JOB_SHARED_DIR; the
            # $AZ_BATCH_NODE_SHARED_DIR analog).
            if job_inputs:
                from batch_shipyard_tpu_torch.data import movement
                shared = self._job_shared_dir(job_id)
                os.makedirs(shared, exist_ok=True)
                movement.stage_task_inputs(
                    self.store,
                    self._resolved_inputs(
                        {"input_data": job_inputs}, job_id),
                    shared)
            if jp_command:
                jp_env = {
                    **self._resolve_env_secrets(
                        dict(spec.get("environment_variables", {}))),
                    "SHIPYARD_JOB_SHARED_DIR":
                        self._job_shared_dir(job_id),
                }
                if auto_scratch:
                    # Prep commands pre-populate scratch (the
                    # canonical BeeOND prep pattern).
                    jp_env["SHIPYARD_JOB_SCRATCH"] = (
                        self._resolve_scratch(job_id, spec))
                execution = task_runner.TaskExecution(
                    pool_id=self.identity.pool_id, job_id=job_id,
                    task_id="jobprep",
                    node_id=self.identity.node_id,
                    node_index=self.identity.node_index,
                    command=jp_command, runtime="none",
                    env=jp_env,
                    task_dir=os.path.join(self.work_dir, "jobprep",
                                          job_id))
                exit_code = task_runner.run_task(execution).exit_code
        except Exception as exc:
            logger.exception("job prep failed for %s", job_id)
            exit_code = -3
        self.store.merge_entity(
            names.TABLE_JOBPREP, pk, self.identity.node_id,
            {"state": "done", "exit_code": exit_code})
        return exit_code == 0

    def _job_shared_dir(self, job_id: str) -> str:
        return os.path.join(self.work_dir, "shared", job_id)

    def _job_scratch_dir(self, job_id: str) -> str:
        return os.path.join(self.work_dir, "scratch", job_id)

    def _resolve_scratch(self, job_id: str, spec: dict) -> str:
        """The job's scratch path on THIS node.

        auto_scratch: true   -> node-local dir (BeeOND-lite).
        auto_scratch: shared -> ONE POSIX namespace across the gang
        (the reference's BeeOND shared parallel fs,
        shipyard_auto_scratch.sh:1-82): worker 0 hosts the directory,
        exports it over NFS, and publishes {path, host_ip} in the
        jobprep table; other workers reuse the path directly when it
        is visible on their filesystem (fake/localhost substrates) or
        NFS-mount it (real multi-VM pools)."""
        if spec.get("auto_scratch") != "shared":
            return self._job_scratch_dir(job_id)
        cached = self._shared_scratch.get(job_id)
        if cached is not None:
            return cached
        pk = names.task_pk(self.identity.pool_id, job_id)
        if self.identity.node_index == 0:
            path = self._job_scratch_dir(job_id)
            os.makedirs(path, exist_ok=True)
            # Nonce: lets non-host workers decide "same filesystem"
            # by reading it THROUGH the published path rather than by
            # bare directory existence (a stale preserved scratch at
            # the identical layout path would otherwise silently
            # become a private local dir).
            nonce = uuid.uuid4().hex
            with open(os.path.join(path, _SCRATCH_NONCE), "w",
                      encoding="utf-8") as fh:
                fh.write(nonce)
            rc = self._scratch_export(path)
            if rc != 0:
                raise RuntimeError(
                    f"job {job_id}: NFS export of shared scratch "
                    f"{path} failed rc={rc}")
            self.store.upsert_entity(
                names.TABLE_JOBPREP, pk, "#scratchhost", {
                    "path": path,
                    "host_ip": self.identity.internal_ip,
                    "node_id": self.identity.node_id,
                    "nonce": nonce})
            self._shared_scratch[job_id] = path
            return path
        deadline = time.monotonic() + 60.0
        while True:
            try:
                row = self.store.get_entity(
                    names.TABLE_JOBPREP, pk, "#scratchhost")
                break
            except NotFoundError:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"job {job_id}: shared scratch host never "
                        f"published (is worker 0 alive?)")
                time.sleep(self.poll_interval)
        host_path = row["path"]
        if not self._force_remote_scratch and \
                self._nonce_matches(host_path, row.get("nonce")):
            # Same filesystem (fake/localhost substrates): the host
            # path IS the shared namespace.
            self._shared_scratch[job_id] = host_path
            return host_path
        mount_point = os.path.join(self.work_dir, "scratch-nfs",
                                   job_id)
        os.makedirs(mount_point, exist_ok=True)
        rc = self._scratch_mount(
            f"{row['host_ip']}:{host_path}", mount_point)
        if rc != 0:
            raise RuntimeError(
                f"job {job_id}: NFS mount of shared scratch "
                f"{row['host_ip']}:{host_path} failed rc={rc}")
        self._shared_scratch[job_id] = mount_point
        return mount_point

    @staticmethod
    def _nonce_matches(host_path: str, nonce: Optional[str]) -> bool:
        if not nonce:
            return False
        try:
            with open(os.path.join(host_path, _SCRATCH_NONCE),
                      encoding="utf-8") as fh:
                return fh.read().strip() == nonce
        except OSError:
            return False

    # Default NFS plumbing (used when no runner is injected). Export
    # and unexport are no-ops without exportfs/root — the
    # same-filesystem substrates don't need them.

    def _nfs_mount(self, remote: str, mount_point: str) -> int:
        return subprocess.call(["mount", "-t", "nfs", remote,
                                mount_point])

    def _nfs_umount(self, mount_point: str) -> int:
        return subprocess.call(["umount", mount_point])

    def _nfs_export(self, path: str) -> int:
        import shutil as shutil_mod
        if shutil_mod.which("exportfs") is None or os.geteuid() != 0:
            return 0
        line = f"{path} *(rw,sync,no_subtree_check,no_root_squash)"
        try:
            with open("/etc/exports", "r+", encoding="utf-8") as fh:
                if line not in fh.read():
                    fh.write(line + "\n")
            return subprocess.call(["exportfs", "-ra"])
        except OSError as exc:
            logger.warning("shared-scratch export failed: %s", exc)
            return 1

    def _nfs_unexport(self, path: str) -> int:
        """Remove the job's line from /etc/exports and re-sync —
        without this, root pools accumulate rw,no_root_squash exports
        of deleted paths across jobs."""
        import shutil as shutil_mod
        if shutil_mod.which("exportfs") is None or os.geteuid() != 0:
            return 0
        try:
            with open("/etc/exports", encoding="utf-8") as fh:
                lines = fh.readlines()
            keep = [ln for ln in lines
                    if not ln.startswith(path + " ")]
            if keep != lines:
                with open("/etc/exports", "w", encoding="utf-8") as fh:
                    fh.writelines(keep)
                return subprocess.call(["exportfs", "-ra"])
            return 0
        except OSError as exc:
            logger.warning("shared-scratch unexport failed: %s", exc)
            return 1

    def _release_shared_scratch(self, job_id: str) -> None:
        """End of a shared scratch's lifetime on this node. Mounters
        unmount and record completion; the host node records its own
        completion and DEFERS deletion to a finalize thread that
        waits for every jobprep-listed node to record release — a
        fan-out peer may still be harvesting through the mount, and
        an early rmtree would vanish data mid-copy."""
        path = self._shared_scratch.pop(job_id, None)
        pk = names.task_pk(self.identity.pool_id, job_id)
        if self.identity.node_index != 0:
            if path is not None and path.startswith(
                    os.path.join(self.work_dir, "scratch-nfs")):
                self._scratch_umount(path)
        try:
            self.store.merge_entity(names.TABLE_JOBPREP, pk,
                                    self.identity.node_id,
                                    {"released": True})
        except NotFoundError:
            pass
        if self.identity.node_index == 0:
            thread = threading.Thread(
                target=self._finalize_shared_scratch, args=(job_id,),
                name=f"scratch-fin-{job_id}", daemon=True)
            thread.start()
            self._threads.append(thread)

    def _finalize_shared_scratch(self, job_id: str) -> None:
        """Host-side deferred teardown: delete the exported tree only
        after the whole release fan-out has completed (or preserve it
        on timeout — a node that never finished harvesting must not
        lose its data)."""
        pk = names.task_pk(self.identity.pool_id, job_id)
        deadline = time.monotonic() + self._scratch_finalize_timeout
        while True:
            if self.stop_event.is_set():
                # Agent stopping mid-wait: a peer may still be
                # harvesting — preserve, exactly like the timeout path.
                logger.warning(
                    "job %s: agent stopping before release fan-out "
                    "completed; preserving shared scratch", job_id)
                return
            rows = [r for r in self.store.query_entities(
                        names.TABLE_JOBPREP, partition_key=pk)
                    if not r["_rk"].startswith("#")]
            if rows and all(r.get("released") for r in rows):
                break
            if time.monotonic() > deadline:
                # Preserve AND keep the export up: a merely-slow
                # peer may still be copying through its NFS mount;
                # revoking the export would kill its in-flight reads.
                logger.warning(
                    "job %s: release fan-out incomplete after %.0fs "
                    "(released: %s); preserving shared scratch (and "
                    "its export) for manual harvest", job_id,
                    self._scratch_finalize_timeout,
                    {r["_rk"]: bool(r.get("released")) for r in rows})
                return
            time.sleep(self.poll_interval)
        import shutil as shutil_mod
        self._scratch_unexport(self._job_scratch_dir(job_id))
        shutil_mod.rmtree(self._job_scratch_dir(job_id),
                          ignore_errors=True)
        try:
            self.store.delete_entity(names.TABLE_JOBPREP, pk,
                                     "#scratchhost")
        except NotFoundError:
            pass

    def _terminate_running_task(self, job_id: str,
                                task_id: str) -> None:
        """Kill a task's live process group (tasks term analog incl.
        the docker kill signal relay, batch.py:2630 — docker run
        processes are killed through their process group here)."""
        proc = self._live_procs.get((job_id, task_id))
        if proc is None:
            return
        import signal as signal_mod
        try:
            os.killpg(os.getpgid(proc.pid), signal_mod.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass

    def _upload_node_logs(self, max_bytes: int = 8 * 1024 * 1024
                          ) -> None:
        """Ship node-side logs to the object store (diag logs upload
        analog, batch.py:3151). Uploads the agent log (if present)
        and the nodeprep marker."""
        candidates = [
            os.path.join(self.work_dir, "agent.log"),
            os.path.join(os.path.dirname(self.work_dir), "agent.log"),
            os.path.join(self.work_dir, ".nodeprep_finished"),
        ]
        for path in candidates:
            if not os.path.exists(path):
                continue
            with open(path, "rb") as fh:
                data = fh.read(max_bytes)
            self.store.put_object(
                names.node_log_key(self.identity.pool_id,
                                   self.identity.node_id,
                                   os.path.basename(path)), data)

    def _install_ssh_key(self, username: str, public_key: str) -> None:
        """Append a public key to the agent user's authorized_keys
        (pool user add analog, batch.py:1045 add_ssh_user). On real
        nodes this manages ~username; under fake/localhost substrates
        it records into the work dir for inspection."""
        if not public_key:
            return
        ssh_dir = os.path.expanduser(f"~{username}/.ssh")
        if ssh_dir.startswith("~"):
            # User does not exist on this host (expanduser returned
            # the literal): record under the work dir instead.
            ssh_dir = os.path.join(self.work_dir, "ssh", username)
        try:
            os.makedirs(ssh_dir, mode=0o700, exist_ok=True)
        except (PermissionError, OSError):
            ssh_dir = os.path.join(self.work_dir, "ssh", username)
            os.makedirs(ssh_dir, exist_ok=True)
        auth = os.path.join(ssh_dir, "authorized_keys")
        existing = ""
        if os.path.exists(auth):
            with open(auth, "r", encoding="utf-8") as fh:
                existing = fh.read()
        if public_key.strip() not in existing:
            with open(auth, "a", encoding="utf-8") as fh:
                fh.write(public_key.strip() + "\n")
            os.chmod(auth, 0o600)

    def _remove_ssh_user(self, username: str) -> None:
        for base in (os.path.expanduser(f"~{username}/.ssh"),
                     os.path.join(self.work_dir, "ssh", username)):
            auth = os.path.join(base, "authorized_keys")
            if os.path.exists(auth):
                try:
                    os.remove(auth)
                except OSError:
                    pass

    def _cleanup_mi_containers(self) -> None:
        """Remove orphaned (exited/created, NOT running) shipyard-*
        containers (jobs cmi analog; reference reaps leftover MI
        coordination containers, batch.py:2322). Running task
        containers are never touched."""
        import shutil
        import subprocess
        if shutil.which("docker") is None:
            return
        names_seen: set[str] = set()
        for status in ("exited", "created", "dead"):
            rc, out, _err = util.subprocess_capture(
                ["docker", "ps", "-a", "--filter", "name=shipyard-",
                 "--filter", f"status={status}",
                 "--format", "{{.Names}}"])
            if rc == 0:
                names_seen.update(out.split())
        for name in names_seen:
            subprocess.call(["docker", "rm", "-f", name],
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)

    def _run_job_release(self, job_id: str) -> None:
        for key in [k for k in self._env_block_cache
                    if k[0] == job_id]:
            self._env_block_cache.pop(key, None)
        try:
            job = self.store.get_entity(
                names.TABLE_JOBS, self.identity.pool_id, job_id)
        except NotFoundError:
            return
        spec = job.get("spec", {})
        jr_command = spec.get("job_release_command")
        if jr_command:
            # The shared dir may not exist yet (it is only created by
            # job-input staging) — release commands harvesting into it
            # must find it present.
            os.makedirs(self._job_shared_dir(job_id), exist_ok=True)
            jr_env = {"SHIPYARD_JOB_SHARED_DIR":
                      self._job_shared_dir(job_id)}
            if spec.get("auto_scratch"):
                # Release commands harvest scratch (archive/copy out)
                # BEFORE the rmtree below ends its lifetime.
                jr_env["SHIPYARD_JOB_SCRATCH"] = (
                    self._resolve_scratch(job_id, spec))
            execution = task_runner.TaskExecution(
                pool_id=self.identity.pool_id, job_id=job_id,
                task_id="jobrelease", node_id=self.identity.node_id,
                node_index=self.identity.node_index,
                command=jr_command, runtime="none", env=jr_env,
                task_dir=os.path.join(self.work_dir, "jobrelease",
                                      job_id))
            result = task_runner.run_task(execution)
            if result.exit_code != 0:
                logger.warning(
                    "job %s release command exited %d", job_id,
                    result.exit_code)
                if spec.get("auto_scratch"):
                    # The release command harvests scratch; if it
                    # failed, deleting scratch would irrecoverably
                    # destroy the un-harvested data. Leave it for the
                    # operator.
                    logger.warning(
                        "preserving job %s auto-scratch at %s for "
                        "manual harvest", job_id,
                        self._resolve_scratch(job_id, spec))
                    return
        if spec.get("auto_scratch") == "shared":
            self._release_shared_scratch(job_id)
        elif spec.get("auto_scratch"):
            # End of the scratch drive's lifetime (the release half of
            # the BeeOND analog).
            import shutil

            shutil.rmtree(self._job_scratch_dir(job_id),
                          ignore_errors=True)

    def _resolved_inputs(self, spec: dict, job_id: str) -> list[dict]:
        resolved = []
        for item in spec.get("input_data") or []:
            if item.get("kind") == "task_output":
                item = dict(item)
                item.setdefault("pool_id", self.identity.pool_id)
                item.setdefault("job_id", job_id)
            resolved.append(item)
        return resolved

    def _stage_inputs(self, spec: dict,
                      execution: task_runner.TaskExecution) -> None:
        input_data = self._resolved_inputs(spec, execution.job_id)
        if not input_data:
            return
        from batch_shipyard_tpu_torch.data import movement
        os.makedirs(execution.task_dir, exist_ok=True)
        movement.stage_task_inputs(self.store, input_data,
                                   execution.task_dir)

    def _collect_outputs(self, spec: dict,
                         execution: task_runner.TaskExecution,
                         job_id: str, task_id: str) -> None:
        output_data = spec.get("output_data") or []
        if not output_data:
            return
        from batch_shipyard_tpu_torch.data import movement
        exclude = movement.staged_input_rels(
            self.store, self._resolved_inputs(spec, job_id))
        movement.collect_task_outputs(
            self.store, output_data, execution.task_dir,
            self.identity.pool_id, job_id, task_id,
            exclude_rels=exclude)

    def _load_image_manifest(self, runtime: str) -> set:
        manifest = {
            row.get("image")
            for row in self.store.query_entities(
                names.TABLE_IMAGES,
                partition_key=self.identity.pool_id)
            if row.get("kind") == runtime}
        self._image_manifest_cache[runtime] = (
            time.monotonic() + 30.0, manifest)
        return manifest

    def _ensure_images(self, spec: dict) -> None:
        """Provision the task's image; with allow_run_on_missing_image
        false (the default), an image absent from the pool's
        replicated global resources FAILS the task instead of being
        pulled ad hoc (reference batch.py:4747 — missing images only
        run when the job opts in)."""
        image = spec.get("image")
        runtime = spec.get("runtime")
        if not image or runtime not in ("docker", "singularity"):
            return
        if not spec.get("allow_run_on_missing_image", False):
            cached = self._image_manifest_cache.get(runtime)
            if cached is not None and cached[0] > time.monotonic():
                manifest = cached[1]
            else:
                manifest = self._load_image_manifest(runtime)
            if image not in manifest:
                # The image may have been added moments ago (pool
                # images update racing the submit): refresh once
                # before declaring terminal failure.
                manifest = self._load_image_manifest(runtime)
            if image not in manifest:
                raise TaskEnvError(
                    f"image {image} is not in the pool's global "
                    f"resources and the job does not set "
                    f"allow_run_on_missing_image")
        if self._image_provisioner is not None:
            self._image_provisioner(self, [image], kind=runtime)

    def _upload_outputs(self, job_id: str, task_id: str,
                        execution: task_runner.TaskExecution,
                        suffix: str = "") -> None:
        for name in ("stdout.txt", "stderr.txt"):
            path = os.path.join(execution.task_dir, name)
            if not os.path.exists(path):
                continue
            key = names.task_output_key(
                self.identity.pool_id, job_id, task_id,
                f"{suffix}/{name}" if suffix else name)
            size = os.path.getsize(path)
            cap = self.output_upload_cap_bytes
            if cap is None or size <= cap:
                # Full upload, streamed — no whole-buffer read, no
                # silent 4MB truncation (round-1 weak #6).
                def chunks(p=path):
                    with open(p, "rb") as fh:
                        while True:
                            block = fh.read(_OUTPUT_STREAM_CHUNK)
                            if not block:
                                return
                            yield block
                self.store.put_object_stream(key, chunks())
            else:
                # Explicitly configured cap: keep head + tail around
                # an unmistakable marker instead of a silent cut.
                half = cap // 2
                with open(path, "rb") as fh:
                    head = fh.read(half)
                    fh.seek(max(size - half, half))
                    tail = fh.read()
                marker = (f"\n...[shipyard: output truncated, "
                          f"{size} bytes total, cap {cap}]...\n"
                          ).encode()
                self.store.put_object_stream(
                    key, iter([head, marker, tail]))

    def _maybe_autocomplete_job(self, job_id: str) -> None:
        """auto_complete: when every task of the job is terminal, mark
        the job completed and fan out job-release control messages
        (reference: on_all_tasks_complete / jobs term semantics)."""
        try:
            job = self.store.get_entity(
                names.TABLE_JOBS, self.identity.pool_id, job_id)
        except NotFoundError:
            return
        if not job.get("spec", {}).get("auto_complete"):
            return
        if job.get("state") != "active":
            return
        pk = names.task_pk(self.identity.pool_id, job_id)
        tasks = list(self.store.query_entities(
            names.TABLE_TASKS, partition_key=pk))
        if not tasks or any(
                t.get("state") not in names.TERMINAL_TASK_STATES
                for t in tasks):
            return
        try:
            self.store.merge_entity(
                names.TABLE_JOBS, self.identity.pool_id, job_id,
                {"state": "completed",
                 "completed_at": util.datetime_utcnow_iso()},
                if_match=job["_etag"])
        except (EtagMismatchError, NotFoundError):
            return
        # Fan out job release to nodes that ran job prep ("#"-prefixed
        # rows are metadata, e.g. the shared-scratch host record).
        for row in self.store.query_entities(
                names.TABLE_JOBPREP, partition_key=pk):
            if row["_rk"].startswith("#"):
                continue
            # Distinct per-node control queue each iteration — there
            # is nothing to batch.
            self.store.put_message(  # shipyard-lint: disable=store-write-in-loop
                names.control_queue(self.identity.pool_id, row["_rk"]),
                json.dumps({
                    "type": "job_release", "job_id": job_id}).encode())


def _mi_settings_from_spec(mi_spec: dict,
                           num_instances: Optional[int] = None
                           ) -> MultiInstanceSettings:
    """``num_instances`` overrides the spec's size — the elastic
    resize path runs the gang at the attempt's EFFECTIVE size, and
    the synthesized jax-distributed env must agree with the actual
    rendezvous width."""
    jd = mi_spec.get("jax_distributed", {})
    return MultiInstanceSettings(
        num_instances=(num_instances if num_instances is not None
                       else mi_spec["num_instances"]),
        min_instances=mi_spec.get("min_instances"),
        coordination_command=mi_spec.get("coordination_command"),
        resource_files=tuple(mi_spec.get("resource_files", [])),
        jax_distributed=JaxDistributedSettings(
            enabled=jd.get("enabled", True),
            coordinator_port=jd.get("coordinator_port", 8476),
            transport=jd.get("transport", "auto"),
            heartbeat_timeout_seconds=jd.get(
                "heartbeat_timeout_seconds", 100),
        ),
        pytorch_xla=mi_spec.get("pytorch_xla", {}).get("enabled", False),
    )
