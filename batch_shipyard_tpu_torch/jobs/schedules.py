"""Job schedules: recurrence-driven job instantiation.

The port's copy of batch_shipyard_tpu/jobs/schedules.py.

Reference analog: job schedules with the recurrent job manager task
(batch.py:5392+ recurrence -> JobScheduleAddParameter;
cargo/recurrent_job_manager.py regenerating the task collection each
recurrence and optionally terminating the job when tasks complete).

Ours is a storage-mediated scheduler loop: schedule state (next run
number, timestamps) lives in a table row, each recurrence submits a
fresh job ``<job-id>:NNNNN`` with the template's tasks, and an optional
monitor waits for completion and terminates the instance (the
monitor_task_completion knob). Runs in-process (tests), as a CLI
daemon verb, or on a service VM.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Optional

from batch_shipyard_tpu_torch.config.settings import JobSettings, PoolSettings
from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, EtagMismatchError, NotFoundError, StateStore)
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

_SCHED_TABLE = names.TABLE_JOBSCHEDULES


def _parse_ts(value: Optional[str]) -> Optional[float]:
    if not value:
        return None
    return datetime.datetime.fromisoformat(
        value.replace("Z", "+00:00")).timestamp()


def instance_id(job_id: str, run_number: int) -> str:
    return f"{job_id}-r{run_number:05d}"


def schedule_state(store: StateStore, pool_id: str,
                   job_id: str) -> dict:
    try:
        return store.get_entity(_SCHED_TABLE, pool_id, job_id)
    except NotFoundError:
        return {"run_number": 0, "last_run_at": None}


def run_due_schedules(store: StateStore, pool: PoolSettings,
                      jobs: list[JobSettings],
                      now: Optional[float] = None) -> list[str]:
    """One evaluation pass: submit an instance for every schedule whose
    interval has elapsed. Returns new job instance ids."""
    now = now if now is not None else time.time()
    launched: list[str] = []
    for job in jobs:
        rec = job.recurrence
        if rec is None:
            continue
        not_before = _parse_ts(rec.do_not_run_until)
        not_after = _parse_ts(rec.do_not_run_after)
        if not_before and now < not_before:
            continue
        if not_after and now > not_after:
            continue
        state = schedule_state(store, pool.id, job.id)
        last = state.get("last_run_at")
        if last is not None and now - last < (
                rec.recurrence_interval_seconds):
            continue
        if rec.run_exclusive and state.get("active_instance"):
            active = state["active_instance"]
            try:
                entity = jobs_mgr.get_job(store, pool.id, active)
                if entity.get("state") == "active":
                    continue  # previous recurrence still running
            except jobs_mgr.JobNotFoundError:
                pass
        run_number = int(state.get("run_number", 0))
        inst = instance_id(job.id, run_number)
        # Claim the recurrence BEFORE submitting: evaluators run
        # concurrently (CLI daemon + pool service VM are both
        # documented run modes, docs/04), and the old blind upsert
        # after add_jobs let two of them read run_number=N and both
        # launch instance N. insert-as-claim covers the first run,
        # etag-guarded merge every later one; losing the race means
        # another evaluator owns this recurrence. If add_jobs then
        # fails, the claimed run is skipped — the next interval fires
        # normally — which beats a double submission.
        claim = {
            "run_number": run_number + 1,
            "last_run_at": now,
            "active_instance": inst,
        }
        try:
            etag = state.get("_etag")
            if etag:
                store.merge_entity(_SCHED_TABLE, pool.id, job.id,
                                   claim, if_match=etag)
            else:
                # Insert-as-claim: EntityExistsError IS the
                # concurrent-evaluator signal; batching would
                # destroy the per-schedule claim semantics.
                store.insert_entity(_SCHED_TABLE, pool.id, job.id,  # shipyard-lint: disable=store-write-in-loop
                                    claim)
        except (EtagMismatchError, EntityExistsError):
            logger.info("schedule %s: recurrence %d claimed by a "
                        "concurrent evaluator; skipping", job.id,
                        run_number)
            continue
        instance_settings = _instantiate(job, inst)
        jobs_mgr.add_jobs(store, pool, [instance_settings])
        launched.append(inst)
        logger.info("schedule %s launched instance %s", job.id, inst)
    return launched


def _instantiate(job: JobSettings, inst_id: str) -> JobSettings:
    import dataclasses
    return dataclasses.replace(
        job, id=inst_id, recurrence=None,
        auto_complete=(job.auto_complete or
                       job.recurrence.monitor_task_completion))


def register_schedules(store: StateStore, pool_id: str,
                       jobs_config: dict) -> list[str]:
    """Persist the recurrence-bearing job templates from a raw jobs
    config into the state store, so a POOL-RESIDENT scheduler (the
    reference runs its recurrent job manager as a job-manager task on
    the pool, cargo/recurrent_job_manager.py:187) can fire them with
    no CLI process alive. Returns the registered job ids."""
    from batch_shipyard_tpu_torch.config import settings as settings_mod
    registered = []
    for raw in jobs_config.get("job_specifications") or []:
        if not raw.get("recurrence"):
            continue
        # Parse NOW so a malformed template fails registration rather
        # than poisoning every pool-service pass later.
        parsed = settings_mod.job_settings_list(
            {"job_specifications": [raw]})[0]
        if parsed.recurrence.recurrence_interval_seconds is None:
            raise ValueError(
                f"schedule {raw['id']}: recurrence.schedule."
                f"recurrence_interval_seconds is required")
        # Template rows are operator-CLI single-writer surface and
        # re-registration REPLACES the spec by design — blind upsert
        # is the intended semantics here, unlike the multi-evaluator
        # schedule-state rows above.
        # shipyard-lint: disable=store-blind-upsert
        store.upsert_entity(
            _SCHED_TABLE, f"{pool_id}#templates", raw["id"],
            {"spec": raw})
        registered.append(raw["id"])
    return registered


def unregister_schedule(store: StateStore, pool_id: str,
                        job_id: str) -> None:
    store.delete_entity(_SCHED_TABLE, f"{pool_id}#templates", job_id)


def stored_schedule_jobs(store: StateStore,
                         pool_id: str) -> list[JobSettings]:
    """Parse the registered templates back into JobSettings (re-read
    every pass so new registrations are picked up live)."""
    from batch_shipyard_tpu_torch.config import settings as settings_mod
    specs = [row["spec"] for row in store.query_entities(
        _SCHED_TABLE, partition_key=f"{pool_id}#templates")]
    if not specs:
        return []
    return settings_mod.job_settings_list(
        {"job_specifications": specs})


def run_pool_schedule_service(store: StateStore, pool: PoolSettings,
                              stop_event: Optional[
                                  threading.Event] = None,
                              poll_interval: float = 1.0) -> int:
    """The pool-resident scheduler loop: like run_schedule_daemon but
    template-driven from the state store instead of a CLI process's
    parsed config. Runs on worker 0 when
    pool_specification.pool_services.schedules is enabled."""
    stop = stop_event or threading.Event()
    total = 0
    while not stop.is_set():
        try:
            jobs = stored_schedule_jobs(store, pool.id)
            if jobs:
                total += len(run_due_schedules(store, pool, jobs))
        except Exception:
            logger.exception("pool schedule service pass failed")
        if stop.wait(poll_interval):
            break
    return total


def run_schedule_daemon(store: StateStore, pool: PoolSettings,
                        jobs: list[JobSettings],
                        stop_event: Optional[threading.Event] = None,
                        poll_interval: float = 1.0,
                        max_recurrences: Optional[int] = None) -> int:
    """Scheduler loop (the recurrent-job-manager daemon). Returns the
    number of instances launched."""
    stop = stop_event or threading.Event()
    total = 0
    while not stop.is_set():
        launched = run_due_schedules(store, pool, jobs)
        total += len(launched)
        if max_recurrences is not None and total >= max_recurrences:
            break
        if stop.wait(poll_interval):
            break
    return total
