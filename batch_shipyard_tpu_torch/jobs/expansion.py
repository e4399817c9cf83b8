"""Server-side task-factory expansion.

The port's copy of batch_shipyard_tpu/jobs/expansion.py.

`jobs add` with ``server_side_expansion: true`` submits a job's
GENERATOR spec (jobs/task_factory.py) as one expansion row instead of
materializing N task rows + N queue messages from the client — the
client round-trips O(1) while the pool's leader-gated expander
materializes chunks pool-side, right next to the store. This is the
submission analog of moving work from the control CLI onto the fleet
(the reference's federation proxy pattern), and what makes a 10^6-task
`jobs add` return in under a second.

Protocol (TABLE_EXPANSIONS, pk=pool_id, rk=job_id):

  * The client parks {state: "pending", spec: job_settings_to_raw(job)}
    plus the submission's trace columns, and stamps the job entity
    with ``expansion: pending`` so waiters gate on materialization.
  * Exactly one agent per pool — the ROLE_EXPANDER leader
    (state/leases.py) — claims rows and expands them on a dedicated
    thread (the heartbeat sweep only spawns/uses it; lint forbids slow
    sweeps). Each chunk is fenced: the expander re-checks its lease
    epoch before committing, and persists a cursor (etag-guarded)
    after.
  * Resume is deterministic re-expansion: task factories are
    deterministic (seeded rng, sorted file listings), so a successor
    leader re-derives the same (task_id, spec) sequence, skips
    ``cursor`` entries, and re-applies the boundary chunk idempotently
    (EntityExistsError == already landed; duplicate queue messages are
    the at-least-once contract agents already dedupe via the claim
    transition).
  * Completion merges {state: "completed", stats} with the submit-leg
    breakdown and prices the whole run as one "expansion" goodput
    interval — scheduling badput, so the 10^6 bench shows exactly
    where the submit work went.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

from batch_shipyard_tpu_torch.config import settings as settings_mod
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, EtagMismatchError, NotFoundError, StateStore)
from batch_shipyard_tpu_torch.trace import context as trace_ctx
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

# Tasks per fenced commit: large enough that the pipelined submitter
# amortizes, small enough that a leader handover replays at most one
# chunk's worth of duplicate messages.
EXPANSION_CHUNK = 20_000


def _check_deterministic(job) -> None:
    """Server-side expansion re-runs the factory on resume, so the
    factory must expand identically every time. An unseeded `random`
    factory would hand a successor leader a DIFFERENT task set than
    the one already half-submitted — reject it at the client leg
    where the user can still fix the spec."""
    for raw_task in job.tasks:
        factory = raw_task.get("task_factory") or {}
        rand = factory.get("random")
        if rand is not None and rand.get("seed") is None:
            raise ValueError(
                f"job {job.id}: server_side_expansion requires a "
                "deterministic task factory; add a `seed` to the "
                "`random` factory or submit client-side")


def submit_expansion(store: StateStore, pool_id: str,
                     job, trace: Optional[trace_ctx.TraceContext] = None,
                     required_node: Optional[str] = None) -> None:
    """Client leg: one expansion row + the job-entity gate column."""
    _check_deterministic(job)
    entity = {
        "state": "pending",
        "spec": settings_mod.job_settings_to_raw(job),
        names.EXPANSION_COL_CURSOR: 0,
        "submitted_at": util.datetime_utcnow_iso(),
    }
    if required_node:
        entity["required_node"] = required_node
    if trace is not None:
        entity[trace_ctx.COL_TRACE_ID] = trace.trace_id
        entity[trace_ctx.COL_TRACE_SPAN] = trace.span_id
    store.insert_entity(names.TABLE_EXPANSIONS, pool_id, job.id,
                        entity)
    store.merge_entity(names.TABLE_JOBS, pool_id, job.id,
                       {"expansion": "pending"})


def expansion_state(store: StateStore, pool_id: str,
                    job_id: str) -> Optional[str]:
    """The job's expansion row state, or None when the job was not
    submitted for server-side expansion."""
    try:
        row = store.get_entity(names.TABLE_EXPANSIONS, pool_id,
                               job_id)
    except NotFoundError:
        return None
    return str(row.get("state") or "pending")


def expansion_error(store: StateStore, pool_id: str,
                    job_id: str) -> str:
    try:
        row = store.get_entity(names.TABLE_EXPANSIONS, pool_id,
                               job_id)
    except NotFoundError:
        return ""
    return str(row.get("error") or "")


def pending_expansions(store: StateStore, pool_id: str) -> list[dict]:
    """Rows the expander leader still owes work: fresh submissions
    plus "expanding" rows a crashed predecessor left behind (the
    fencing lease guarantees no LIVE predecessor — only the leader
    calls this)."""
    return [row for row in store.query_entities(
                names.TABLE_EXPANSIONS, partition_key=pool_id)
            if row.get("state") in ("pending", "expanding")]


def run_expansion(store: StateStore, pool_id: str, row: dict,
                  node_id: Optional[str] = None,
                  fenced: Optional[Callable[[], bool]] = None,
                  stop_check: Optional[Callable[[], bool]] = None,
                  chunk: int = EXPANSION_CHUNK) -> bool:
    """Materialize one expansion row. Returns True when the row
    reached "completed"; False when the run yielded (lost fence /
    stop requested) with the cursor persisted for the successor.
    Unparseable specs fail the row (state="failed" + error) — a bad
    generator must surface to `jobs wait`, not loop forever."""
    from batch_shipyard_tpu_torch.goodput import events as gp_events
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    fenced = fenced or (lambda: True)
    stop_check = stop_check or (lambda: False)
    job_id = row["_rk"]
    etag = row["_etag"]
    started = time.time()
    try:
        etag = store.merge_entity(
            names.TABLE_EXPANSIONS, pool_id, job_id,
            {"state": "expanding", "claimed_by": node_id,
             "claimed_at": util.datetime_utcnow_iso()},
            if_match=etag)
    except (EtagMismatchError, NotFoundError):
        return False  # someone else moved it; not ours this round
    trace = trace_ctx.TraceContext.from_entity(row)
    try:
        job = settings_mod._job_settings(dict(row.get("spec") or {}))
        pool_entity = store.get_entity(names.TABLE_POOLS, "pools",
                                       pool_id)
        pool = settings_mod.pool_settings(
            dict(pool_entity.get("spec") or {}))
        pending = jobs_mgr._expand_job_tasks(
            store, job, pool,
            required_node=row.get("required_node") or None)
    except Exception as exc:  # noqa: BLE001 - bad spec: fail the row
        logger.exception("expansion of %s/%s failed to expand",
                         pool_id, job_id)
        _finish(store, pool_id, job_id, etag, "failed",
                error=f"{type(exc).__name__}: {exc}")
        return False
    cursor = int(row.get(names.EXPANSION_COL_CURSOR, 0) or 0)
    stats: dict = {"expanded": len(pending)}
    expand_started = time.monotonic()
    while cursor < len(pending):
        if stop_check() or not fenced():
            logger.info(
                "expansion of %s/%s yielding at cursor %d/%d",
                pool_id, job_id, cursor, len(pending))
            return False
        batch = pending[cursor:cursor + chunk]
        # tolerate_existing: the boundary chunk of a predecessor's
        # crash may be half-landed; re-applying converges.
        jobs_mgr._submit_tasks_batched(
            store, pool_id, job_id, batch, priority=job.priority,
            trace=trace, stats=stats, tolerate_existing=True)
        cursor += len(batch)
        if not fenced():
            # The chunk landed but this term ended mid-commit: do
            # NOT advance the cursor — the successor re-applies the
            # chunk idempotently under its own epoch.
            return False
        try:
            etag = store.merge_entity(
                names.TABLE_EXPANSIONS, pool_id, job_id,
                {names.EXPANSION_COL_CURSOR: cursor},
                if_match=etag)
        except (EtagMismatchError, NotFoundError):
            return False  # row moved under us: yield
    stats["expand_seconds"] = time.monotonic() - expand_started
    if not _finish(store, pool_id, job_id, etag, "completed",
                   stats=stats):
        return False
    gp_events.emit(
        store, pool_id, gp_events.TASK_EXPANSION, job_id=job_id,
        node_id=node_id, start=started, end=time.time(),
        attrs=stats,
        trace_id=(trace.trace_id if trace else None),
        span_id=(trace.span_id if trace else None))
    logger.info("expansion of %s/%s materialized %d task(s)",
                pool_id, job_id, stats["expanded"])
    return True


def _finish(store: StateStore, pool_id: str, job_id: str, etag: str,
            state: str, stats: Optional[dict] = None,
            error: Optional[str] = None) -> bool:
    patch: dict = {"state": state,
                   "completed_at": util.datetime_utcnow_iso()}
    if stats is not None:
        patch[names.EXPANSION_COL_STATS] = stats
    if error is not None:
        patch["error"] = error
    try:
        store.merge_entity(names.TABLE_EXPANSIONS, pool_id, job_id,
                           patch, if_match=etag)
    except (EtagMismatchError, NotFoundError):
        return False
    try:
        store.merge_entity(names.TABLE_JOBS, pool_id, job_id,
                           {"expansion": state})
    except NotFoundError:
        pass  # job deleted mid-expansion; nothing to gate
    return True


def run_pending_expansions(store: StateStore, pool_id: str,
                           node_id: Optional[str] = None,
                           fenced: Optional[Callable[[], bool]] = None,
                           stop_check: Optional[
                               Callable[[], bool]] = None) -> int:
    """Expander-thread entry: drain every claimable expansion row.
    Returns the number of rows completed this run."""
    done = 0
    for row in pending_expansions(store, pool_id):
        if (stop_check and stop_check()) or \
                (fenced and not fenced()):
            break
        if run_expansion(store, pool_id, row, node_id=node_id,
                         fenced=fenced, stop_check=stop_check):
            done += 1
    return done
