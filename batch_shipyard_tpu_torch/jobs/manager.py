"""Job/task submission and monitoring.

The port's copy of batch_shipyard_tpu/jobs/manager.py: it writes the
reference's job and task rows and queue messages, so either package's
agents run the jobs it submits.

Reference analog: convoy/batch.py add_jobs(:5056 — the 850-line loop) +
_construct_task(:4489) + _add_task_collection(:4313). Our submission
writes task entities + queue messages instead of Batch REST calls; the
node agents do the rest.

Task id generation follows the reference convention (task-%05d,
batch.py:4177) so depends_on_range works identically.
"""

from __future__ import annotations

import json
import math
import queue as queue_mod
import re
import threading
import time
import weakref
from typing import Iterator, Optional

from batch_shipyard_tpu_torch.config import settings as settings_mod
from batch_shipyard_tpu_torch.config.settings import (
    JobSettings, PoolSettings, TaskSettings)
from batch_shipyard_tpu_torch.jobs.task_factory import expand_task_factory
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, EtagMismatchError, NotFoundError, StateStore)
from batch_shipyard_tpu_torch.trace import context as trace_ctx
from batch_shipyard_tpu_torch.trace import spans as trace_spans
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)


class JobExistsError(RuntimeError):
    pass


class JobNotFoundError(RuntimeError):
    pass


def _task_spec(task: TaskSettings, job: JobSettings,
               pool: PoolSettings) -> dict:
    """Serializable task spec stored in the task entity and consumed by
    the node agent (the TaskAddParameter analog)."""
    spec = {
        "command": task.command,
        "runtime": task.runtime,
        "image": task.image,
        "environment_variables": dict(task.environment_variables),
        "tpu": task.tpu,
        "gpus": task.gpus,
        "depends_on": list(task.depends_on),
        "depends_on_range": (list(task.depends_on_range)
                             if task.depends_on_range else None),
        "max_task_retries": task.max_task_retries,
        "max_wall_time_seconds": task.max_wall_time_seconds,
        "progress_deadline_seconds": task.progress_deadline_seconds,
        "compile_cache_identity": task.compile_cache_identity,
        "retention_time_seconds": task.retention_time_seconds,
        "remove_container_after_exit": task.remove_container_after_exit,
        "shm_size": task.shm_size,
        "container_runtime": (pool.container_runtime_default
                              if pool is not None else "runc"),
        "additional_docker_run_options": list(
            task.additional_docker_run_options),
        "additional_singularity_options": list(
            task.additional_singularity_options),
        "input_data": list(task.input_data),
        "output_data": list(task.output_data),
        "resource_files": list(task.resource_files),
        "environment_variables_secret_id":
            job.environment_variables_secret_id,
        "allow_run_on_missing_image": job.allow_run_on_missing_image,
        "job_preparation_command": job.job_preparation_command,
        "job_input_data": list(job.input_data),
        "auto_scratch": job.auto_scratch,
        "exit_options": dict(task.default_exit_options),
        # Numeric priority: selects the queue band by sign (hi/lo
        # drain order, and retry requeues must land back on the same
        # band) and orders tasks WITHIN the band for the preempt
        # sweep — a pending task with a strictly higher number can
        # evict lower-priority running work.
        "priority": task.priority,
    }
    if task.multi_instance is not None:
        mi = task.multi_instance
        spec["multi_instance"] = {
            "num_instances": mi.resolve_num_instances(pool),
            "min_instances": mi.min_instances,
            "coordination_command": mi.coordination_command,
            "resource_files": list(mi.resource_files),
            "jax_distributed": {
                "enabled": mi.jax_distributed.enabled,
                "coordinator_port": mi.jax_distributed.coordinator_port,
                "transport": mi.jax_distributed.transport,
                "heartbeat_timeout_seconds":
                    mi.jax_distributed.heartbeat_timeout_seconds,
            },
            "pytorch_xla": {"enabled": mi.pytorch_xla},
        }
    return spec


def _expand_job_tasks(store: StateStore, job: JobSettings,
                      pool: PoolSettings,
                      required_node: Optional[str] = None,
                      start_number: int = 0,
                      ) -> list[tuple[str, dict]]:
    """Expand a job's task factories into (task_id, spec) pairs.
    Generic ids are numbered task-%05d from ``start_number``
    (reference id convention, batch.py:4177)."""
    task_number = start_number
    all_task_ids: list[str] = []
    pending: list[tuple[str, dict]] = []
    # Spec memoization: a repeat/sweep factory yields runs of equal
    # raw tasks, and settings-merge + spec construction dominate
    # large expansions (they are pure functions of the raw dict).
    # Re-deriving only when the raw task changes turns a 10^6-repeat
    # expansion from 10^6 merges into 1 — and the shared spec object
    # also collapses the submission's memory footprint. The spec must
    # then never be mutated per-task below (required_node is uniform
    # across the call), which also holds for every downstream reader.
    prev_raw: Optional[dict] = None
    prev_spec: Optional[dict] = None
    prev_explicit_id: Optional[str] = None
    for raw_task in job.tasks:
        for expanded in expand_task_factory(raw_task, store):
            if prev_raw is not None and (
                    expanded is prev_raw or expanded == prev_raw):
                spec = prev_spec
                task_id = prev_explicit_id or \
                    f"task-{task_number:05d}"
            else:
                task = settings_mod.task_settings(expanded, job, pool)
                spec = _task_spec(task, job, pool)
                if required_node:
                    spec["required_node"] = required_node
                prev_raw = expanded if expanded is not raw_task \
                    else dict(expanded)
                prev_spec = spec
                prev_explicit_id = task.id
                task_id = task.id or f"task-{task_number:05d}"
            task_number += 1
            pending.append((task_id, spec))
            all_task_ids.append(task_id)
    if job.merge_task is not None:
        # Merge task: runs after every other task of the job
        # (reference batch.py merge_task handling :4177-4242).
        merge_raw = dict(job.merge_task)
        merge_raw["depends_on"] = all_task_ids
        task = settings_mod.task_settings(merge_raw, job, pool)
        merge_id = task.id or "merge-task"
        spec = _task_spec(task, job, pool)
        if required_node:
            spec["required_node"] = required_node
        pending.append((merge_id, spec))
    return pending


def add_jobs(store: StateStore, pool: PoolSettings,
             jobs: list[JobSettings],
             pool_id_override: Optional[str] = None,
             required_node: Optional[str] = None) -> dict[str, int]:
    """Submit jobs + tasks; returns {job_id: task_count}.

    ``required_node`` pins every task to one node (federation
    required-target select): agents bounce non-matching deliveries.
    """
    submitted: dict[str, int] = {}
    for job in jobs:
        pool_id = pool_id_override or job.pool_id or pool.id
        # The distributed trace is born HERE: one trace per job
        # submission, whose root is the submit span. Every task row
        # carries the trace id + its own root span id, so the whole
        # chain (queue wait, claim, rendezvous, program phases) is
        # attributable to this `jobs add`.
        trace = trace_ctx.TraceContext.new()
        submit_started = time.time()
        try:
            # One insert-as-claim per JOB (EntityExistsError below is
            # the duplicate-submission guard); jobs-per-call is O(1),
            # the per-task fan-out under it is fully batched.
            store.insert_entity(names.TABLE_JOBS, pool_id, job.id, {  # shipyard-lint: disable=store-write-in-loop
                "state": "active",
                trace_ctx.COL_TRACE_ID: trace.trace_id,
                trace_ctx.COL_TRACE_SPAN: trace.span_id,
                "spec": {
                    "auto_complete": job.auto_complete,
                    "priority": job.priority,
                    "job_release_command": job.job_release_command,
                    "auto_scratch": job.auto_scratch,
                    "recurrence": (
                        {"interval":
                         job.recurrence.recurrence_interval_seconds}
                        if job.recurrence else None),
                },
                "created_at": util.datetime_utcnow_iso(),
            })
        except EntityExistsError:
            raise JobExistsError(f"job {job.id} exists on pool {pool_id}")
        if job.server_side_expansion:
            # O(1) client leg: park the generator spec as ONE
            # expansion row; the pool's leader-gated expander
            # (jobs/expansion.py) materializes rows + messages.
            from batch_shipyard_tpu_torch.jobs import expansion as \
                expansion_mod
            expansion_mod.submit_expansion(
                store, pool_id, job, trace=trace,
                required_node=required_node)
            trace_spans.emit(
                store, pool_id, trace_spans.SPAN_SUBMIT, trace,
                job_id=job.id, start=submit_started, end=time.time(),
                attrs={"tasks": 0, "server_side_expansion": True},
                self_span=True)
            logger.info(
                "job %s submitted for server-side expansion under "
                "trace %s", job.id, trace.trace_id)
            submitted[job.id] = 0
            continue
        pending = _expand_job_tasks(store, job, pool,
                                    required_node=required_node)
        _submit_tasks_batched(store, pool_id, job.id, pending,
                              priority=job.priority, trace=trace)
        # The submit span covers entity+message fan-out; recorded
        # LAST so its end time is honest. Its own span_id is the
        # trace root (parent of every task's root span).
        trace_spans.emit(
            store, pool_id, trace_spans.SPAN_SUBMIT, trace,
            job_id=job.id, start=submit_started, end=time.time(),
            attrs={"tasks": len(pending)}, self_span=True)
        logger.info("job %s submitted under trace %s", job.id,
                    trace.trace_id)
        submitted[job.id] = len(pending)
    return submitted


_GENERIC_TASK_ID = re.compile(r"^task-(\d{5,})$")


def merge_tasks_into_job(store: StateStore, pool: PoolSettings,
                         job: JobSettings, pool_id: str,
                         required_node: Optional[str] = None) -> int:
    """Add a job spec's tasks to an ALREADY EXISTING job, remapping
    colliding task ids.

    Reference analog: federation schedule_tasks task-id fixup
    (federation/federation.py:2605 fixup + :2699
    regenerate_next_generic_task_id) — a federated action targeting a
    job that already ran on the pool re-numbers generic ids past the
    job's current maximum so the merge never collides; depends_on
    references within the incoming batch are remapped consistently.
    Explicit (non-generic) ids that collide are an error. Returns the
    number of tasks added.
    """
    job_entity = get_job(store, pool_id, job.id)  # must exist
    # Merged tasks join the job's EXISTING trace (their root spans
    # parent under the original submit span); None for legacy jobs.
    trace = trace_ctx.TraceContext.from_entity(job_entity)
    existing = {t["_rk"] for t in list_tasks(store, pool_id, job.id)}
    next_number = 0
    for tid in existing:
        match = _GENERIC_TASK_ID.match(tid)
        if match:
            next_number = max(next_number, int(match.group(1)) + 1)
    # Expand under the batch's OWN numbering (task-00000...), so
    # depends_on references within the incoming batch resolve to
    # batch members; collisions with existing ids are then renumbered
    # past the job's current maximum and the references remapped.
    pending = _expand_job_tasks(store, job, pool,
                                required_node=required_node)
    remap: dict[str, str] = {}
    out: list[tuple[str, dict]] = []
    has_range_deps = any(spec.get("depends_on_range")
                         for _, spec in pending)
    # Renumbered ids must dodge existing ids, ids already assigned in
    # this merge, AND not-yet-processed ids of the incoming batch —
    # otherwise renaming task-00000 to task-00005 collides with an
    # incoming task-00005 later in the same batch.
    taken = set(existing) | {tid for tid, _ in pending}
    for task_id, spec in pending:
        new_id = task_id
        if task_id in existing:
            if has_range_deps:
                # depends_on_range references numeric ids positionally;
                # re-numbering would silently retarget them (the
                # reference likewise skips re-id when dependencies are
                # present, federation.py:2686).
                raise JobExistsError(
                    f"cannot merge tasks into job {job.id}: id "
                    f"{task_id} collides and the batch uses "
                    f"depends_on_range")
            if _GENERIC_TASK_ID.match(task_id) or task_id == "merge-task":
                while f"task-{next_number:05d}" in taken:
                    next_number += 1
                new_id = f"task-{next_number:05d}"
                next_number += 1
            else:
                raise JobExistsError(
                    f"task {task_id} already exists in job {job.id} "
                    f"on pool {pool_id} and is not a generic id")
        taken.add(new_id)
        remap[task_id] = new_id
        out.append((new_id, spec))
    for _, spec in out:
        spec["depends_on"] = [remap.get(d, d)
                              for d in spec.get("depends_on", [])]
    _submit_tasks_batched(store, pool_id, job.id, out,
                          priority=job.priority, trace=trace)
    return len(out)


# Adaptive submission chunking: start at the reference's 100-task
# TaskAddCollection size and grow while a chunk's store-commit time
# stays under the target — large batches amortize round trips, but an
# unbounded chunk would turn one slow backend call into a visibility
# cliff (and a giant all-or-nothing batch on the atomic backends).
_SUBMIT_CHUNK_MIN = 100
_SUBMIT_CHUNK_MAX = 10_000
_SUBMIT_CHUNK_TARGET_SECONDS = 0.25

# Queue-shard autoscale: grow the pool's task_queue_shards while the
# observed submission rate exceeds what the current shard set should
# carry. Grow-only — the old shard names are a strict subset of the
# new set (names.task_queue), so in-flight messages stay claimable
# and producers/consumers may disagree about the count transiently
# without stranding a queue.
_SHARD_TASKS_PER_SECOND = 2500.0
_MAX_AUTOSCALE_SHARDS = 32

# pool_queue_shards cache: per-(store, pool), TTL-bounded. Bulk
# submission used to pay one pool-entity read per chunk for a value
# that changes only on resize/autoscale; the WeakKey keeps a store's
# cache from outliving the store (tests build thousands).
_SHARDS_CACHE_TTL = 15.0
_shards_cache: "weakref.WeakKeyDictionary[StateStore, dict]" = \
    weakref.WeakKeyDictionary()
_shards_cache_lock = threading.Lock()


def pool_queue_shards(store: StateStore, pool_id: str,
                      ttl: Optional[float] = _SHARDS_CACHE_TTL) -> int:
    """Task-queue shard count for a pool, read from its stored spec
    (so cross-pool producers — federation, migrate — route to the
    TARGET pool's sharding, not the caller's). Cached per
    (store, pool) for ``ttl`` seconds; pass ``ttl=0`` to force a
    fresh read. Resize/autoscale invalidate the writer's own cache
    eagerly (invalidate_pool_queue_shards); other processes converge
    within the TTL, which grow-only sharding makes safe."""
    now = time.monotonic()
    if ttl:
        with _shards_cache_lock:
            hit = _shards_cache.get(store, {}).get(pool_id)
            if hit is not None and now - hit[1] < ttl:
                return hit[0]
    try:
        pool = store.get_entity(names.TABLE_POOLS, "pools", pool_id)
        shards = int(pool.get("spec", {})
                     .get("pool_specification", {})
                     .get("task_queue_shards", 1))
    except NotFoundError:
        return 1  # transient (pool mid-create): never cache it
    with _shards_cache_lock:
        try:
            _shards_cache.setdefault(store, {})[pool_id] = (shards,
                                                            now)
        except TypeError:
            pass  # un-weakref-able store stand-in: skip caching
    return shards


def invalidate_pool_queue_shards(store: Optional[StateStore] = None,
                                 pool_id: Optional[str] = None
                                 ) -> None:
    """Drop cached shard counts — for one (store, pool), one store,
    or everything. Called by pool resize and the submission-rate
    autoscale so the writer's next routing decision sees its own
    update immediately."""
    with _shards_cache_lock:
        if store is None:
            for per_store in _shards_cache.values():
                if pool_id is None:
                    per_store.clear()
                else:
                    per_store.pop(pool_id, None)
        elif pool_id is None:
            _shards_cache.pop(store, None)
        else:
            _shards_cache.get(store, {}).pop(pool_id, None)


def maybe_autoscale_queue_shards(store: StateStore, pool_id: str,
                                 tasks_per_second: float) -> int:
    """Grow ``task_queue_shards`` to match an observed submission
    rate (the tentpole's autoscale hook: called by the streaming
    submitter and the server-side expander once they can measure
    their own throughput). Returns the effective shard count.
    Grow-only and etag-guarded; a lost race just means the other
    writer's (also grow-only) value stands."""
    desired = min(_MAX_AUTOSCALE_SHARDS,
                  max(1, math.ceil(tasks_per_second
                                   / _SHARD_TASKS_PER_SECOND)))
    current = pool_queue_shards(store, pool_id, ttl=0)
    if desired <= current:
        return current
    try:
        pool = store.get_entity(names.TABLE_POOLS, "pools", pool_id)
        spec = dict(pool.get("spec", {}))
        pool_spec = dict(spec.get("pool_specification", {}))
        if int(pool_spec.get("task_queue_shards", 1)) >= desired:
            return int(pool_spec["task_queue_shards"])
        pool_spec["task_queue_shards"] = desired
        spec["pool_specification"] = pool_spec
        store.merge_entity(names.TABLE_POOLS, "pools", pool_id,
                           {"spec": spec}, if_match=pool["_etag"])
    except (NotFoundError, EtagMismatchError):
        return current
    invalidate_pool_queue_shards(store, pool_id)
    logger.info("task queue shards for pool %s grown %d -> %d "
                "(observed %.0f tasks/s)", pool_id, current, desired,
                tasks_per_second)
    return desired


def _encode_chunk_messages(pool_id: str, job_id: str,
                           chunk: list[tuple[str, dict]],
                           shards: int, priority: int,
                           trace: Optional[trace_ctx.TraceContext],
                           ) -> dict[str, list[bytes]]:
    """Encode one chunk's queue payloads, amortizing the JSON work:
    the shared head/tail of every message is serialized once and the
    per-task/per-instance remainder is string-assembled — emitting
    bytes identical to a per-message json.dumps of
    {"job_id", "task_id"[, "trace_id"][, "instance"]} in that key
    order (the equivalence property test pins this)."""
    head = '{"job_id": ' + json.dumps(job_id) + ', "task_id": '
    tail = (', "trace_id": ' + json.dumps(trace.trace_id)
            if trace is not None else '')
    by_queue: dict[str, list[bytes]] = {}
    for task_id, spec in chunk:
        # Per-task numeric priority routes the band (a task may
        # override its job's priority); the job-level param is the
        # legacy fallback for specs without one.
        queue = names.task_queue_for(
            pool_id, task_id, shards,
            priority=int(spec.get("priority", priority) or 0))
        base = head + json.dumps(task_id) + tail
        num_instances = (spec.get("multi_instance") or {}).get(
            "num_instances")
        if num_instances:
            # Gang fan-out is part of the batched encode: one shared
            # body + the instance index, not one json.dumps per
            # instance.
            by_queue.setdefault(queue, []).extend(
                (base + ', "instance": ' + str(k) + '}').encode()
                for k in range(num_instances))
        else:
            by_queue.setdefault(queue, []).append(
                (base + '}').encode())
    return by_queue


def _insert_rows_tolerant(store: StateStore, rows: list[tuple]) -> None:
    """Batch insert that treats EntityExistsError as already-applied
    (the WAL replay discipline): the server-side expander's resume
    path re-submits the chunk its predecessor may have half-landed,
    and re-inserted rows must converge instead of erroring."""
    try:
        store.insert_entities(names.TABLE_TASKS, rows)
    except EntityExistsError:
        for pk, rk, entity in rows:
            try:
                store.insert_entity(names.TABLE_TASKS, pk, rk,  # shipyard-lint: disable=store-write-in-loop
                                    entity)
            except EntityExistsError:
                pass


def _submit_tasks_batched(store: StateStore, pool_id: str, job_id: str,
                          tasks: list[tuple[str, dict]],
                          priority: int = 0,
                          trace: Optional[
                              trace_ctx.TraceContext] = None,
                          stats: Optional[dict] = None,
                          tolerate_existing: bool = False) -> None:
    """Streaming pipelined batch submission (supersedes the fixed
    100-task chunks of the reference's TaskAddCollection,
    batch.py:4313). Three overlapped legs connected by bounded
    queues:

        encode (caller thread) -> entity insert -> queue enqueue

    so while chunk N's rows commit, chunk N+1 encodes and chunk N-1's
    messages enqueue — a chunk's messages still strictly FOLLOW its
    rows (an agent must never claim a message whose task row is not
    yet readable). Chunk size adapts to the measured store-commit
    time (slow start from _SUBMIT_CHUNK_MIN toward the target
    seconds), and the shard autoscale hook runs once a rate is
    observable.

    ``priority`` selects the queue band agents drain first. ``trace``
    stamps each row with the trace id + its own root span and each
    message with the trace id. ``stats`` (optional dict) accumulates
    the submit-leg breakdown: encode/entity/enqueue seconds and task/
    message counts. ``tolerate_existing`` re-applies rows
    idempotently (expander resume)."""
    if not tasks:
        return
    pk = names.task_pk(pool_id, job_id)
    shards = pool_queue_shards(store, pool_id)
    submitted_at = util.datetime_utcnow_iso()
    out: dict = {"encode_seconds": 0.0, "entity_seconds": 0.0,
                 "enqueue_seconds": 0.0, "tasks": 0, "messages": 0,
                 "chunks": 0, "shards": shards}
    insert_rows = _insert_rows_tolerant if tolerate_existing else (
        lambda s, rows: s.insert_entities(names.TABLE_TASKS, rows))

    if len(tasks) <= _SUBMIT_CHUNK_MIN:
        # Inline path: one chunk needs no pipeline (and retry
        # requeues / unit submissions shouldn't pay two thread
        # spawns per task).
        t0 = time.monotonic()
        rows = []
        for task_id, spec in tasks:
            entity = {"state": "pending", "spec": spec, "retries": 0,
                      "submitted_at": submitted_at}
            if trace is not None:
                entity.update(trace.child().entity_columns())
            rows.append((pk, task_id, entity))
        by_queue = _encode_chunk_messages(pool_id, job_id, tasks,
                                          shards, priority, trace)
        out["encode_seconds"] = time.monotonic() - t0
        t0 = time.monotonic()
        insert_rows(store, rows)
        out["entity_seconds"] = time.monotonic() - t0
        t0 = time.monotonic()
        for queue_name, payloads in by_queue.items():
            store.put_messages(queue_name, payloads)
            out["messages"] += len(payloads)
        out["enqueue_seconds"] = time.monotonic() - t0
        out["tasks"] = len(tasks)
        out["chunks"] = 1
        if stats is not None:
            for key, value in out.items():
                if isinstance(value, (int, float)) and key != "shards":
                    stats[key] = stats.get(key, 0) + value
            stats["shards"] = out["shards"]
        return

    # Bounded handoffs: depth 2 keeps all three legs busy without
    # letting a fast encoder pile unbounded row batches in memory.
    entity_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
    enqueue_q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
    errors: list[BaseException] = []
    # Feedback from the store legs to the (caller-thread) encoder:
    # the slowest observed store-commit time for the last chunk size
    # drives the adaptation.
    feedback = {"commit_seconds": 0.0, "rows": 0}
    feedback_lock = threading.Lock()

    def entity_leg() -> None:
        try:
            while True:
                item = entity_q.get()
                if item is None:
                    enqueue_q.put(None)
                    return
                rows, by_queue = item
                t0 = time.monotonic()
                insert_rows(store, rows)
                dt = time.monotonic() - t0
                out["entity_seconds"] += dt
                with feedback_lock:
                    feedback["commit_seconds"] = dt
                    feedback["rows"] = len(rows)
                enqueue_q.put((len(rows), by_queue))
        except BaseException as exc:  # noqa: BLE001 - rethrown below
            errors.append(exc)
            enqueue_q.put(None)
            # Drain so the producer's bounded put never deadlocks.
            while entity_q.get() is not None:
                pass

    def enqueue_leg() -> None:
        try:
            while True:
                item = enqueue_q.get()
                if item is None:
                    return
                nrows, by_queue = item
                t0 = time.monotonic()
                for queue_name, payloads in by_queue.items():
                    store.put_messages(queue_name, payloads)
                    out["messages"] += len(payloads)
                out["enqueue_seconds"] += time.monotonic() - t0
                out["tasks"] += nrows
                out["chunks"] += 1
        except BaseException as exc:  # noqa: BLE001 - rethrown below
            errors.append(exc)
            while enqueue_q.get() is not None:
                pass

    threads = [threading.Thread(target=entity_leg,
                                name="submit-entities", daemon=True),
               threading.Thread(target=enqueue_leg,
                                name="submit-enqueue", daemon=True)]
    for t in threads:
        t.start()
    chunk_size = _SUBMIT_CHUNK_MIN
    started = time.monotonic()
    autoscaled = False
    position = 0
    try:
        while position < len(tasks) and not errors:
            chunk = tasks[position:position + chunk_size]
            position += len(chunk)
            t0 = time.monotonic()
            rows = []
            if trace is not None:
                for task_id, spec in chunk:
                    entity = {"state": "pending", "spec": spec,
                              "retries": 0,
                              "submitted_at": submitted_at}
                    entity.update(trace.child().entity_columns())
                    rows.append((pk, task_id, entity))
            else:
                rows = [(pk, task_id,
                         {"state": "pending", "spec": spec,
                          "retries": 0, "submitted_at": submitted_at})
                        for task_id, spec in chunk]
            by_queue = _encode_chunk_messages(
                pool_id, job_id, chunk, shards, priority, trace)
            out["encode_seconds"] += time.monotonic() - t0
            entity_q.put((rows, by_queue))
            # Adapt: grow while the store leg commits chunks faster
            # than the target, shrink when a chunk blew past it.
            with feedback_lock:
                commit, nrows = (feedback["commit_seconds"],
                                 feedback["rows"])
            if nrows:
                if commit < _SUBMIT_CHUNK_TARGET_SECONDS / 2:
                    chunk_size = min(_SUBMIT_CHUNK_MAX,
                                     chunk_size * 2)
                elif commit > _SUBMIT_CHUNK_TARGET_SECONDS * 2:
                    chunk_size = max(_SUBMIT_CHUNK_MIN,
                                     chunk_size // 2)
            if not autoscaled:
                elapsed = time.monotonic() - started
                if elapsed >= 1.0 and position < len(tasks):
                    autoscaled = True
                    rate = position / elapsed
                    new_shards = maybe_autoscale_queue_shards(
                        store, pool_id, rate)
                    if new_shards > shards:
                        # Grow-only: chunks already routed with the
                        # old count stay claimable (subset property).
                        shards = new_shards
                        out["shards"] = shards
    finally:
        entity_q.put(None)
        for t in threads:
            t.join()
    if stats is not None:
        for key, value in out.items():
            if isinstance(value, (int, float)) and key != "shards":
                stats[key] = stats.get(key, 0) + value
        stats["shards"] = out["shards"]
    if errors:
        raise errors[0]


def _submit_task(store: StateStore, pool_id: str, job_id: str,
                 task_id: str, spec: dict) -> None:
    _submit_tasks_batched(store, pool_id, job_id, [(task_id, spec)])


def list_jobs(store: StateStore, pool_id: str) -> list[dict]:
    return list(store.query_entities(names.TABLE_JOBS,
                                     partition_key=pool_id))


def get_job(store: StateStore, pool_id: str, job_id: str) -> dict:
    try:
        return store.get_entity(names.TABLE_JOBS, pool_id, job_id)
    except NotFoundError:
        raise JobNotFoundError(job_id)


def list_tasks(store: StateStore, pool_id: str,
               job_id: str) -> list[dict]:
    return list(store.query_entities(
        names.TABLE_TASKS, partition_key=names.task_pk(pool_id, job_id)))


def get_task(store: StateStore, pool_id: str, job_id: str,
             task_id: str) -> dict:
    try:
        return store.get_entity(
            names.TABLE_TASKS, names.task_pk(pool_id, job_id), task_id)
    except NotFoundError:
        raise JobNotFoundError(f"{job_id}/{task_id}")


def job_task_summary(store: StateStore, pool_id: str,
                     job_id: str) -> dict:
    """Terminal-state summary of one job via the server-side group
    count (count_entities_by): {"total", "terminal", "by_state"} —
    one aggregate read instead of listing every task row. At 10^6
    tasks this is what makes a wait poll loop usable."""
    counts = store.count_entities_by(
        names.TABLE_TASKS, names.task_pk(pool_id, job_id))
    total = sum(counts.values())
    terminal = sum(counts.get(state, 0)
                   for state in names.TERMINAL_TASK_STATES)
    return {"total": total, "terminal": terminal, "by_state": counts}


def wait_for_job_summary(store: StateStore, pool_id: str, job_id: str,
                         timeout: float = 600.0,
                         poll_interval: float = 0.2,
                         on_progress=None) -> dict:
    """Block until every task of a job is terminal, polling the O(1)
    summary (never the task list). A pending server-side expansion
    gates completion: until the expander reports the job fully
    materialized, an all-terminal count only covers the prefix it has
    landed so far. Returns the final summary; ``on_progress`` (if
    given) is called with each interim summary."""
    from batch_shipyard_tpu_torch.jobs import expansion as expansion_mod
    deadline = time.monotonic() + timeout
    while True:
        summary = job_task_summary(store, pool_id, job_id)
        expansion = expansion_mod.expansion_state(store, pool_id,
                                                 job_id)
        if expansion == "failed":
            raise RuntimeError(
                f"server-side expansion of {job_id} failed: "
                f"{expansion_mod.expansion_error(store, pool_id, job_id)}")
        expanded = expansion is None or expansion == "completed"
        if expanded and summary["total"] and \
                summary["terminal"] == summary["total"]:
            return summary
        if on_progress is not None:
            on_progress(summary)
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"tasks of {job_id} not terminal after {timeout}s: "
                f"{summary['by_state']}"
                + ("" if expanded else
                   f" (expansion {expansion})"))
        time.sleep(poll_interval)


def wait_for_tasks(store: StateStore, pool_id: str, job_id: str,
                   timeout: float = 600.0,
                   poll_interval: float = 0.2) -> list[dict]:
    """Block until all tasks of a job are terminal; returns them.
    Polls the counting summary (one aggregate read per tick) and
    lists the full task set exactly once, at the end."""
    wait_for_job_summary(store, pool_id, job_id, timeout=timeout,
                         poll_interval=poll_interval)
    return list_tasks(store, pool_id, job_id)


def get_task_output(store: StateStore, pool_id: str, job_id: str,
                    task_id: str, filename: str = "stdout.txt",
                    instance: Optional[int] = None) -> bytes:
    name = (f"i{instance}/{filename}" if instance is not None
            else filename)
    key = names.task_output_key(pool_id, job_id, task_id, name)
    return store.get_object(key)


def stream_task_output(store: StateStore, pool_id: str, job_id: str,
                       task_id: str, filename: str = "stdout.txt",
                       timeout: float = 600.0,
                       poll_interval: float = 0.5) -> Iterator[bytes]:
    """Poll-follow a task's output until the task is terminal
    (stream_file_and_wait_for_task analog, batch.py:3243)."""
    offset = 0
    deadline = time.monotonic() + timeout
    key = names.task_output_key(pool_id, job_id, task_id, filename)
    while True:
        task = get_task(store, pool_id, job_id, task_id)
        try:
            data = store.get_object(key)
            if len(data) > offset:
                yield data[offset:]
                offset = len(data)
        except NotFoundError:
            pass
        if task.get("state") in names.TERMINAL_TASK_STATES:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"stream of {task_id} timed out")
        time.sleep(poll_interval)


def terminate_job(store: StateStore, pool_id: str, job_id: str,
                  wait: bool = False) -> None:
    """Terminate: mark job + non-terminal tasks; fan out job-release
    (jobs term analog, batch.py:2770 terminate_tasks +
    del_or_term_jobs)."""
    job = get_job(store, pool_id, job_id)
    store.merge_entity(names.TABLE_JOBS, pool_id, job_id,
                       {"state": "terminated",
                        "completed_at": util.datetime_utcnow_iso()})
    pk = names.task_pk(pool_id, job_id)
    for task in list_tasks(store, pool_id, job_id):
        if task.get("state") not in names.TERMINAL_TASK_STATES:
            try:
                store.merge_entity(
                    names.TABLE_TASKS, pk, task["_rk"],
                    {"state": "failed", "exit_code": -9,
                     "error": "job terminated"},
                    if_match=task["_etag"])
            except Exception:
                pass
    for row in store.query_entities(names.TABLE_JOBPREP,
                                    partition_key=pk):
        # One message per DISTINCT per-node control queue — there is
        # no batch to combine across queues.
        store.put_message(  # shipyard-lint: disable=store-write-in-loop
            names.control_queue(pool_id, row["_rk"]),
            json.dumps({"type": "job_release",
                        "job_id": job_id}).encode())


def disable_job(store: StateStore, pool_id: str, job_id: str) -> None:
    """Disable: pending tasks stay queued but agents will not start
    them until re-enabled (jobs disable --requeue analog,
    batch.py:2102). Only active jobs can be disabled — a terminated/
    completed job must not be resurrectable via disable+enable."""
    job = get_job(store, pool_id, job_id)
    if job.get("state") != "active":
        raise ValueError(
            f"job {job_id} is {job.get('state')}; only active jobs "
            f"can be disabled")
    store.merge_entity(names.TABLE_JOBS, pool_id, job_id,
                       {"state": "disabled"}, if_match=job["_etag"])


def enable_job(store: StateStore, pool_id: str, job_id: str) -> None:
    job = get_job(store, pool_id, job_id)
    if job.get("state") != "disabled":
        raise ValueError(f"job {job_id} is not disabled")
    store.merge_entity(names.TABLE_JOBS, pool_id, job_id,
                       {"state": "active"})


def migrate_job(store: StateStore, src_pool_id: str, job_id: str,
                dst_pool_id: str) -> int:
    """Live job migration between pools: move the job entity and
    re-enqueue all non-terminal tasks on the destination pool's queue
    (jobs migrate analog, batch.py:1855 check_pool_for_job_migration +
    :1911 update_job_with_pool). Returns moved task count."""
    job = get_job(store, src_pool_id, job_id)
    try:
        get_job(store, dst_pool_id, job_id)
        raise JobExistsError(
            f"job {job_id} already exists on pool {dst_pool_id}")
    except JobNotFoundError:
        pass
    try:
        store.get_entity(names.TABLE_POOLS, "pools", dst_pool_id)
    except NotFoundError:
        raise ValueError(
            f"destination pool {dst_pool_id} does not exist")
    src_pk = names.task_pk(src_pool_id, job_id)
    dst_pk = names.task_pk(dst_pool_id, job_id)
    # Validate BEFORE any mutation: a half-migrated job is
    # unrecoverable without manual store surgery. Requiring the job to
    # be disabled (not merely no-running-tasks) closes the race where
    # a source-pool agent claims a pending task mid-migration.
    if job.get("state") == "active":
        raise RuntimeError(
            f"job {job_id} is active; run jobs disable first, wait "
            f"for running tasks to drain, then migrate")
    tasks = list(store.query_entities(names.TABLE_TASKS,
                                      partition_key=src_pk))
    running = [t["_rk"] for t in tasks
               if t.get("state") in ("assigned", "running")]
    if running:
        raise RuntimeError(
            f"tasks {running} are still running; wait for them to "
            f"drain before migrating")
    moved = 0
    store.insert_entity(names.TABLE_JOBS, dst_pool_id, job_id, {
        "state": job.get("state", "active"), "spec": job.get("spec", {}),
        "created_at": job.get("created_at"),
        "migrated_from": src_pool_id,
    })
    dst_shards = pool_queue_shards(store, dst_pool_id, ttl=0)
    job_priority = int(job.get("spec", {}).get("priority", 0) or 0)
    # Batched commit (the store-write-in-loop showcase fix): build
    # every destination row and message first, then land them as
    # batches — rows strictly before messages, so a destination
    # agent can never claim a message whose task row is unreadable.
    # Source-row deletes follow last: a crash mid-migrate leaves
    # duplicate claim-proof rows (job stays disabled), never a task
    # that exists nowhere.
    rows: list[tuple[str, str, dict]] = []
    by_queue: dict[str, list[bytes]] = {}
    for task in tasks:
        entity = {k: v for k, v in task.items()
                  if not k.startswith("_")}
        rows.append((dst_pk, task["_rk"], entity))
        if entity.get("state") in names.CLAIMABLE_TASK_STATES:
            # Per-task priority routes the band, same rule as
            # submission — a hi-band task must not lose its drain
            # precedence by migrating.
            dst_queue = names.task_queue_for(
                dst_pool_id, task["_rk"], dst_shards,
                priority=int((entity.get("spec") or {}).get(
                    "priority", job_priority) or 0))
            message = {"job_id": job_id, "task_id": task["_rk"]}
            if entity.get(trace_ctx.COL_TRACE_ID):
                message["trace_id"] = entity[trace_ctx.COL_TRACE_ID]
            num_instances = (entity.get("spec", {}).get(
                "multi_instance") or {}).get("num_instances")
            if num_instances:
                # Elastic override: a resized gang migrates at its
                # CURRENT effective size — fanning out the spec size
                # onto the destination would wedge the rendezvous the
                # same way it would have on the source.
                effective = int(
                    entity.get(names.TASK_COL_GANG_SIZE)
                    or num_instances)
                by_queue.setdefault(dst_queue, []).extend(
                    json.dumps({**message, "instance": k}).encode()
                    for k in range(effective))
            else:
                by_queue.setdefault(dst_queue, []).append(
                    json.dumps(message).encode())
            moved += 1
        if (entity.get("spec", {}).get("multi_instance")
                or {}).get("num_instances"):
            # Source-pool rendezvous rows would otherwise orphan:
            # gang partitions are POOL-scoped, so the destination's
            # janitor can never sweep them, and the source pool may
            # have no live agents left to (the migration trigger).
            attempts = (int(entity.get("retries", 0) or 0)
                        + int(entity.get(
                            names.TASK_COL_PREEMPT_COUNT, 0) or 0)
                        + int(entity.get(
                            names.TASK_COL_EVICT_COUNT, 0) or 0))
            for attempt in range(attempts + 1):
                gang_pk = names.gang_pk(src_pool_id, job_id,
                                        task["_rk"], attempt=attempt)
                for gang_row in list(store.query_entities(
                        names.TABLE_GANGS, partition_key=gang_pk)):
                    try:
                        store.delete_entity(names.TABLE_GANGS,
                                            gang_pk,
                                            gang_row["_rk"])
                    except NotFoundError:
                        pass
    for start in range(0, len(rows), _SUBMIT_CHUNK_MIN):
        store.insert_entities(names.TABLE_TASKS,
                              rows[start:start + _SUBMIT_CHUNK_MIN])
    for dst_queue, payloads in by_queue.items():
        store.put_messages(dst_queue, payloads)
    for task in tasks:
        store.delete_entity(names.TABLE_TASKS, src_pk, task["_rk"])
    store.delete_entity(names.TABLE_JOBS, src_pool_id, job_id)
    return moved


def cleanup_mi_containers(store: StateStore, pool_id: str) -> int:
    """Fan out orphaned multi-instance container cleanup to every node
    (jobs cmi analog, batch.py:2322). Returns node count."""
    count = 0
    for node in store.query_entities(names.TABLE_NODES,
                                     partition_key=pool_id):
        # One message per DISTINCT per-node control queue — no batch
        # exists across queues.
        store.put_message(  # shipyard-lint: disable=store-write-in-loop
            names.control_queue(pool_id, node["_rk"]),
            json.dumps({"type": "cleanup_mi"}).encode())
        count += 1
    return count


def terminate_task(store: StateStore, pool_id: str, job_id: str,
                   task_id: str, wait: bool = False,
                   timeout: float = 60.0) -> None:
    """Terminate one task (tasks term analog, batch.py:2770): pending
    tasks are marked failed; running tasks get a kill relayed to their
    node's agent."""
    task = get_task(store, pool_id, job_id, task_id)
    state = task.get("state")
    if state in names.TERMINAL_TASK_STATES:
        return
    if state in names.CLAIMABLE_TASK_STATES:
        # pending OR preempted-awaiting-reclaim: nothing is running,
        # mark terminal directly.
        try:
            store.merge_entity(
                names.TABLE_TASKS, names.task_pk(pool_id, job_id),
                task_id, {"state": "failed", "exit_code": -9,
                          "error": "terminated by user"},
                if_match=task["_etag"])
            return
        except EtagMismatchError:
            task = get_task(store, pool_id, job_id, task_id)
    node_id = task.get("node_id")
    if node_id:
        store.put_message(
            names.control_queue(pool_id, node_id),
            json.dumps({"type": "term_task", "job_id": job_id,
                        "task_id": task_id}).encode())
    if wait:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            task = get_task(store, pool_id, job_id, task_id)
            if task.get("state") in names.TERMINAL_TASK_STATES:
                return
            time.sleep(0.2)
        raise TimeoutError(f"task {task_id} did not terminate")


def request_preemption(store: StateStore, pool_id: str, job_id: str,
                       task_id: str, reason: str = "",
                       by_job_id: Optional[str] = None,
                       by_task_id: Optional[str] = None,
                       leader_epoch: Optional[int] = None,
                       defer_notice: bool = False):
    """Stamp a cooperative preempt request on a RUNNING task. The
    owning node's agent heartbeat loop delivers it into the live task
    dirs (every gang instance gets its copy); an instrumented workload
    drains to its next step boundary, forces a COMMITTED checkpoint,
    and exits EXIT_PREEMPTED — requeued at full retry budget. Returns
    False when the task is not in a preemptible state (or a concurrent
    transition won the merge). Idempotent: re-stamping an already
    pending request is a no-op (one drain per request).

    ``leader_epoch`` is the preempt-sweep term's fencing epoch
    (state/leases.py): stamped into the request and the notice event
    so every stamp is attributable to exactly one leadership term —
    the partition drill's zero-double-fire invariant reads it.
    Manual CLI preemptions carry None (no term to fence).

    ``defer_notice``: return the notice-emitting closure (truthy)
    instead of publishing the TASK_PREEMPT_NOTICE event here — for
    the leader sweep, whose post-write fence check may RETRACT a
    stamp that landed after its term ended; emitting eagerly would
    leave a dangling notice event for a preemption that never
    happened. The caller invokes the closure once the stamp is known
    to stand."""
    from batch_shipyard_tpu_torch.goodput import events as goodput_events
    task = get_task(store, pool_id, job_id, task_id)
    if task.get("state") not in ("assigned", "running"):
        return False
    if task.get(names.TASK_COL_PREEMPT_REQUEST):
        return True  # already pending; one request, one drain
    request = {
        "requested_at": util.datetime_utcnow_iso(),
        "reason": reason or "preempted by scheduler",
        "by_job_id": by_job_id, "by_task_id": by_task_id,
        "leader_epoch": leader_epoch,
    }
    try:
        store.merge_entity(
            names.TABLE_TASKS, names.task_pk(pool_id, job_id),
            task_id, {names.TASK_COL_PREEMPT_REQUEST: request},
            if_match=task["_etag"])
    except (EtagMismatchError, NotFoundError):
        return False

    def _emit_notice() -> None:
        goodput_events.emit(
            store, pool_id, goodput_events.TASK_PREEMPT_NOTICE,
            job_id=job_id, task_id=task_id,
            attrs={"reason": request["reason"],
                   "by_job_id": by_job_id, "by_task_id": by_task_id,
                   "leader_epoch": leader_epoch},
            trace_id=task.get(trace_ctx.COL_TRACE_ID),
            span_id=task.get(trace_ctx.COL_TRACE_SPAN))
        logger.warning("preempt requested for %s/%s: %s", job_id,
                       task_id, request["reason"])

    if defer_notice:
        return _emit_notice
    _emit_notice()
    return True


def list_task_files(store: StateStore, pool_id: str, job_id: str,
                    task_id: str) -> list[str]:
    """List a task's uploaded files (data files list analog)."""
    prefix = names.task_output_key(pool_id, job_id, task_id, "")
    return [k[len(prefix):] for k in store.list_objects(prefix)]


def delete_task(store: StateStore, pool_id: str, job_id: str,
                task_id: str, require_terminal: bool = True) -> None:
    """Delete a task's entity and its uploaded objects (tasks del
    analog). Non-terminal tasks must be terminated first."""
    task = get_task(store, pool_id, job_id, task_id)
    if require_terminal and task.get("state") not in \
            names.TERMINAL_TASK_STATES:
        raise ValueError(
            f"task {task_id} is {task.get('state')}; terminate first")
    prefix = names.task_output_key(pool_id, job_id, task_id, "")
    for key in store.list_objects(prefix):
        store.delete_object(key)
    store.delete_entity(names.TABLE_TASKS,
                        names.task_pk(pool_id, job_id), task_id)


def delete_job(store: StateStore, pool_id: str, job_id: str) -> None:
    get_job(store, pool_id, job_id)
    pk = names.task_pk(pool_id, job_id)
    for task in list(store.query_entities(names.TABLE_TASKS,
                                          partition_key=pk)):
        delete_task(store, pool_id, job_id, task["_rk"],
                    require_terminal=False)
    for row in list(store.query_entities(names.TABLE_JOBPREP,
                                         partition_key=pk)):
        store.delete_entity(names.TABLE_JOBPREP, pk, row["_rk"])
    store.delete_entity(names.TABLE_JOBS, pool_id, job_id)


def job_stats(store: StateStore, pool_id: str,
              job_id: Optional[str] = None) -> dict:
    """jobs stats analog (batch.py:1972), plus queue/run aggregates
    sourced from the goodput event log: queue_seconds sums queued
    spans (submit->first claim; requeue->re-claim for retries, one
    span per gang regardless of width), run_seconds sums running
    spans (node-seconds: gang tasks contribute one span per
    instance)."""
    from batch_shipyard_tpu_torch.goodput import events as goodput_events
    jobs = ([get_job(store, pool_id, job_id)] if job_id
            else list_jobs(store, pool_id))
    stats = {"jobs": len(jobs), "tasks": 0, "by_state": {},
             "wall_seconds_total": 0.0,
             "queue_seconds": 0.0, "run_seconds": 0.0}
    job_ids = {job["_rk"] for job in jobs}
    for job in jobs:
        for task in list_tasks(store, pool_id, job["_rk"]):
            stats["tasks"] += 1
            state = task.get("state", "pending")
            stats["by_state"][state] = stats["by_state"].get(state, 0) + 1
            stats["wall_seconds_total"] += float(
                task.get("wall_seconds", 0.0) or 0.0)
    # One unsorted pass over the pool's event partition (no need for
    # events.query's time ordering here; the log is bounded by
    # `goodput prune` retention).
    for event in store.query_entities(names.TABLE_GOODPUT,
                                      partition_key=pool_id):
        if event.get("job_id") not in job_ids or \
                event.get("kind") not in (goodput_events.TASK_QUEUED,
                                          goodput_events.TASK_RUNNING):
            continue
        duration = max(0.0, float(event.get("end", 0.0))
                       - float(event.get("start", 0.0)))
        if event.get("kind") == goodput_events.TASK_QUEUED:
            stats["queue_seconds"] += duration
        else:
            stats["run_seconds"] += duration
    return stats
