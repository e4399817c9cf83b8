"""Canonical state-store naming: tables, queues, object key prefixes.

The port's copy of batch_shipyard_tpu/state/names.py: the values are
the reference's, so both packages read and write the same rows, queues
and objects.

Reference analog: the _STORAGE_CONTAINERS registry (convoy/storage.py:68)
that names every blob container/table/queue. Centralized so clients,
daemons, and node agents agree on the schema.
"""

from __future__ import annotations

import zlib

# Tables (partition key scheme in comments)
TABLE_POOLS = "pools"          # pk="pools",           rk=pool_id
TABLE_NODES = "nodes"          # pk=pool_id,           rk=node_id
TABLE_JOBS = "jobs"            # pk=pool_id,           rk=job_id
TABLE_TASKS = "tasks"          # pk=f"{pool}${job}",   rk=task_id
TABLE_GANGS = "gangs"          # pk=f"{pool}${job}${task}", rk=f"i{k}"
TABLE_JOBPREP = "jobprep"      # pk=f"{pool}${job}",   rk=node_id
TABLE_PERF = "perf"            # pk=f"{pool}",         rk=f"{ts}${uniq}"
TABLE_GOODPUT = "goodput"      # pk=pool_id,           rk=f"{ts}${uniq}"
TABLE_TRACE = "trace"          # pk=pool_id,           rk=f"{ts}${uniq}"
TABLE_IMAGES = "images"        # pk=pool_id,           rk=image hash
TABLE_JOBSCHEDULES = "jobschedules"  # pk=pool_id (templates:
#                                      f"{pool}#templates"), rk=job_id
TABLE_MONITOR = "monitor"      # pk="monitor",         rk=resource id
TABLE_FEDERATIONS = "federations"  # pk="fed",         rk=federation_id
TABLE_FEDJOBS = "fedjobs"      # pk=federation_id,     rk=job id
TABLE_SLURM = "slurm"          # pk=cluster_id,        rk=host/partition
TABLE_REMOTEFS = "remotefs"    # pk="remotefs",        rk=cluster_id
TABLE_REMOTEFS_NODES = "remotefs_nodes"  # pk=cluster_id, rk=node name
TABLE_EXPANSIONS = "expansions"  # pk=pool_id,         rk=job_id


# Entity state vocabularies. Every "state" literal written to a task
# or node entity must come from these tuples (enforced by an AST scan
# in tests/test_names_consistency.py) — a typo'd state string would
# otherwise silently dodge every terminal-state check in the fleet.
#
# "quarantined" is the poison-task terminal state: the retry
# supervisor parks a task there after its retry budget is exhausted,
# with a diagnostics bundle on the entity (agent/node_agent.py).
TASK_STATE_QUARANTINED = "quarantined"
# "preempted" is the cooperative-preemption waiting state: the task
# drained to a step boundary, committed a checkpoint, and exited with
# the distinct preempted status (agent/preemption.EXIT_PREEMPTED).
# NON-terminal and claimable like "pending" — the requeue consumed no
# retry budget, and the next claim restores from the forced commit.
TASK_STATE_PREEMPTED = "preempted"
# "evicted" is the FORCIBLE sibling of "preempted": the victim never
# honored its preempt notice within preempt_grace_seconds, so the
# escalation path hard-killed it (no drain, no forced commit). Still
# externally caused — claimable, full retry budget, neutral node
# health — but the rerun resumes from the last COMMITTED checkpoint
# BEFORE the notice, and the wait is priced as the distinct
# "eviction" badput leg.
TASK_STATE_EVICTED = "evicted"
TASK_STATES = ("pending", "assigned", "running", "completed",
               "failed", "blocked", TASK_STATE_QUARANTINED,
               TASK_STATE_PREEMPTED, TASK_STATE_EVICTED)
TERMINAL_TASK_STATES = ("completed", "failed", "blocked",
                        TASK_STATE_QUARANTINED)
# Task states a node may claim for execution: "preempted"/"evicted"
# are requeued-waiting states, not failures — the claim path treats
# them exactly like "pending".
CLAIMABLE_TASK_STATES = ("pending", TASK_STATE_PREEMPTED,
                         TASK_STATE_EVICTED)
NODE_STATES = ("creating", "starting", "idle", "running", "offline",
               "unusable", "start_task_failed", "suspended",
               "preempted")
# Auxiliary coordination states (jobprep fan-out rows, gang member
# rows, job lifecycle, remotefs/slurm cluster lifecycle) — same
# registry, same AST enforcement.
AUX_STATES = ("joined", "done", "active", "disabled", "terminated",
              "completed", "resizing", "ready", "allocation_failed",
              "deleted", "defined", "provisioned", "expanding")

# Server-side task-factory expansion rows (TABLE_EXPANSIONS): one row
# per `jobs add --server-expand` job holding the raw generator spec;
# the leader-gated pool expander (jobs/expansion.py) walks it through
# pending -> expanding -> completed/failed, etag-fencing a resumable
# cursor so a crashed expander's successor re-derives the factory
# deterministically and continues where the chunk commits stopped.
EXPANSION_STATES = ("pending", "expanding", "completed", "failed")
#   cursor — count of tasks already materialized (rows + messages
#            committed); the deterministic factory replays past it
#   stats  — submit-leg breakdown stamped at completion:
#            {expanded, expand_seconds, entity_seconds,
#             enqueue_seconds, encode_seconds}
EXPANSION_COL_CURSOR = "cursor"
EXPANSION_COL_STATS = "stats"

# Node-entity health columns (written by the node agent's health
# scorer, read by claim exclusion + heimdall gauges).
NODE_COL_HEALTH = "health"
NODE_COL_QUARANTINED = "quarantined"

# Task-entity preemption columns (single-sourced: stamped by the
# preempt sweep / chaos node_preempt_notice injector, delivered by the
# agent heartbeat loop, cleared by the preempted requeue):
#   preempt_request — {"requested_at", "reason", "by_job_id",
#                      "by_task_id"} while a preempt is pending
#   preempted_at    — epoch of the last preempted exit (the recovery
#                     interval's start; cleared at next claim)
#   preempt_count   — lifetime preemptions survived (never consumes
#                     the retry budget)
#   gang_size       — elastic gang override: the CURRENT attempt's
#                     effective size when resized below the spec's
#                     num_instances (absent = spec size)
TASK_COL_PREEMPT_REQUEST = "preempt_request"
TASK_COL_PREEMPTED_AT = "preempted_at"
TASK_COL_PREEMPT_COUNT = "preempt_count"
TASK_COL_GANG_SIZE = "gang_size"
# Forcible-eviction columns (the escalation ladder's bookkeeping):
#   evicted_at  — epoch of the last hard-killed (evicted) exit; the
#                 eviction-recovery interval's start, cleared at the
#                 next claim (the preempted_at pattern)
#   evict_count — lifetime forcible evictions survived (never
#                 consumes the retry budget; namespaces the gang
#                 rendezvous attempt like preempt_count)
TASK_COL_EVICTED_AT = "evicted_at"
TASK_COL_EVICT_COUNT = "evict_count"
# Scheduling hints the agent mirrors from the workload's hints file
# (agent/progress.py record_sched_hints) on each heartbeat:
#   {"step", "ckpt_step", "step_seconds", "cache_identity"} — the
# inputs the shared victim-cost policy (sched/policy.py
# victim_cost_from_row) prices preemption rework from. Advisory: a
# task that never writes hints costs 0.0 and tie-breaks on
# (priority, task_id) exactly as before.
TASK_COL_SCHED_HINTS = "sched_hints"


def task_pk(pool_id: str, job_id: str) -> str:
    return f"{pool_id}${job_id}"


def gang_pk(pool_id: str, job_id: str, task_id: str,
            attempt: int = 0) -> str:
    """Gang rendezvous partition. ``attempt`` (the task's retry count)
    namespaces each recovery attempt: a zombie member of a recovered
    gang finishing late merges into the OLD attempt's (deleted)
    partition and gets NotFoundError, instead of corrupting the fresh
    rendezvous that reuses its instance index. Attempt 0 keeps the
    historical name so existing pools are unchanged on disk."""
    base = f"{pool_id}${job_id}${task_id}"
    return base if attempt <= 0 else f"{base}#g{attempt}"


# Queues
#
# Priority bands: job.priority maps onto separate queue families that
# agents drain strictly in band order (hi before normal before lo), so
# a high-priority job overtakes a 10k-task sweep backlog the way Azure
# Batch's job priority does for the reference (jobs.yaml priority,
# -1000..1000). Band "" (normal, priority 0) keeps the historical
# queue names so existing pools are unchanged on disk.
PRIORITY_BANDS = ("hi", "", "lo")


def priority_band(priority: int) -> str:
    if priority > 0:
        return "hi"
    if priority < 0:
        return "lo"
    return ""


def task_queue(pool_id: str, shard: int = 0, band: str = "") -> str:
    """Task queue name for one shard+band. Shard 0 of the normal band
    keeps the unsharded name, so pools with task_queue_shards=1 (the
    default) are unchanged on disk."""
    suffix = f"-{band}" if band else ""
    if shard == 0:
        return f"taskq-{pool_id}{suffix}"
    return f"taskq-{pool_id}{suffix}-{shard}"


def task_queues(pool_id: str, shards: int) -> list[str]:
    """Every task queue of a pool, all bands — the set over which
    backlog lengths (autoscale, federation facts) are summed."""
    return [task_queue(pool_id, k, band)
            for band in PRIORITY_BANDS
            for k in range(max(shards, 1))]


def task_queues_by_band(pool_id: str, shards: int) -> list[list[str]]:
    """Queues grouped by band in strict drain order (hi, normal, lo):
    agents exhaust earlier bands before popping later ones."""
    return [[task_queue(pool_id, k, band)
             for k in range(max(shards, 1))]
            for band in PRIORITY_BANDS]


def task_queue_for(pool_id: str, task_id: str, shards: int,
                   priority: int = 0) -> str:
    """Deterministic shard for a task: every producer (submit,
    migrate, retry requeue) routes a task's messages to the same
    shard (reference analog: the 100-task TaskAddCollection fan-in,
    batch.py:4313 — re-designed as queue fan-OUT so 10^4-task pools
    don't serialize on one queue)."""
    band = priority_band(priority)
    if shards <= 1:
        return task_queue(pool_id, 0, band)
    return task_queue(pool_id, zlib.crc32(task_id.encode()) % shards,
                      band)


def control_queue(pool_id: str, node_id: str) -> str:
    """Per-node control messages (job release, shutdown, reboot)."""
    return f"ctrlq-{pool_id}-{node_id}"


def federation_queue(federation_id: str) -> str:
    return f"fedq-{federation_id}"


def control_reply_key(pool_id: str, node_id: str, nonce: str) -> str:
    """Object key where a node agent parks the reply to a
    request/reply control verb (nodes ps/zap/prune)."""
    return f"ctrlreply/{pool_id}/{node_id}/{nonce}.json"


# Object key prefixes
def resource_file_key(pool_id: str, filename: str) -> str:
    return f"resourcefiles/{pool_id}/{filename}"


def task_output_key(pool_id: str, job_id: str, task_id: str,
                    filename: str) -> str:
    return f"taskdata/{pool_id}/{job_id}/{task_id}/{filename}"


def node_log_key(pool_id: str, node_id: str, filename: str) -> str:
    return f"nodelogs/{pool_id}/{node_id}/{filename}"


def global_resource_lock_key(pool_id: str, resource_hash: str,
                             slot: int) -> str:
    """Cascade concurrency-gate lock names (reference: hash.{0..N} lock
    blobs, storage.py:1946)."""
    return f"grlocks/{pool_id}/{resource_hash}.{slot}"


def federation_job_blob_key(federation_id: str, job_id: str,
                            unique: str) -> str:
    return f"fedjobs/{federation_id}/{job_id}/{unique}"


# Leader leases (state/leases.py): one named lease per leader-gated
# loop — the gang janitor, the preempt sweep, the federation elastic
# evaluator — plus a per-lease epoch object whose generation is the
# monotonic fencing epoch stamped into every sweep write. ``scope``
# is the pool id for agent sweeps, "fed-<federation_id>" for the
# federation evaluator.
def leader_lease_key(scope: str, role: str) -> str:
    return f"leader/{scope}/{role}"


def leader_epoch_key(scope: str, role: str) -> str:
    return f"leader/{scope}/{role}.epoch"


# Node-entity column: the local store-outage WAL backlog
# (state/resilient.py), published on every heartbeat so heimdall can
# export shipyard_journal_backlog_entries per node.
NODE_COL_JOURNAL_BACKLOG = "journal_backlog"


# Pool-wide compile-cache seeding (compilecache/seeding.py): one tar
# artifact per cache identity, a latest.json pointer read before
# download, and a lease so exactly one node uploads per identity.
def compile_cache_key(pool_id: str, identity: str) -> str:
    return f"compilecache/{pool_id}/{identity}.tar"


def compile_cache_latest_key(pool_id: str) -> str:
    return f"compilecache/{pool_id}/latest.json"


def compile_cache_lease_key(pool_id: str, identity: str) -> str:
    return f"compilecache/{pool_id}/{identity}.lock"
