"""Goodput interval events: typed, append-only, store-persisted.

Counterpart of batch_shipyard_tpu/goodput/events.py. Two producer
surfaces feed one log:

  * **Process-local** (``record`` / ``phase``): workload code inside a
    task process appends one JSON line an event to
    ``$SHIPYARD_GOODPUT_FILE``, with the task's trace context
    (trace/context.py) attached. No-op without a file; never raises.
  * **Store-backed** (``emit`` / ``span`` / ``query`` / ``prune``): the
    node side, holding a state store (state/), writes events into
    TABLE_GOODPUT partitioned by pool, RowKey = timestamp + a uuid
    suffix; after a task it folds the task's file into the store with
    the task's identity (``ingest_local_events``).

The pool's accounting prices the intervals (the step windows as
productive time, a blocking checkpoint save as checkpoint badput, an
overlapped async persist as overlapped, a compile phase as compile
badput with its ``cache_hit`` / ``saved_seconds``). Rows and lines are
the reference's schema::

    {"kind", "start", "end", "attrs": {...}, ["trace_id", "span_id"],
     ["job_id", "task_id", "node_id"]}
"""

from __future__ import annotations

import contextlib
import datetime
import json
import logging
import os
import time
import uuid
from typing import Any, Iterator, Optional

from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import StateStore
from batch_shipyard_tpu_torch.trace import context as trace_ctx

logger = logging.getLogger(__name__)

GOODPUT_FILE_ENV = "SHIPYARD_GOODPUT_FILE"

# Node lifecycle (the node side's emitters).
NODE_PROVISIONING = "provisioning"
NODE_PREP = "nodeprep"
NODE_IDLE = "idle"
NODE_PREEMPTED = "preempted"
# Task lifecycle.
TASK_QUEUED = "queued"
TASK_IMAGE_PULL = "image_pull"
TASK_CONTAINER_START = "container_start"
TASK_RUNNING = "running"
TASK_RETRY = "retry"
TASK_BACKOFF = "backoff"
TASK_PREEMPT_NOTICE = "preempt_notice"
TASK_PREEMPT_EXIT = "preempt_exit"
TASK_PREEMPT_RECOVERY = "preempt_recovery"
TASK_EVICTED = "evicted"
TASK_EVICTION_RECOVERY = "eviction_recovery"
GANG_RESIZE = "gang_resize"
GANG_MIGRATE = "gang_migrate"
# Control-plane legs.
STORE_OUTAGE = "store_outage"
TASK_EXPANSION = "expansion"
TASK_ADOPTION = "adoption"

PROGRAM_COMPILE = "compile"            # warm-up steps
PROGRAM_WARMUP = "warmup"              # serving engine warm-up
PROGRAM_STEP_WINDOW = "step_window"    # productive steps; attrs carry
                                       # step_start/step_end/tokens
PROGRAM_CHECKPOINT_SAVE = "checkpoint_save"
PROGRAM_CHECKPOINT_RESTORE = "checkpoint_restore"
# The async pipeline's persist, in its writer thread under live step
# windows (workloads/checkpoint.AsyncCheckpointManager).
PROGRAM_CHECKPOINT_ASYNC = "checkpoint_async"
PROGRAM_EVAL = "eval"
# The serving router's mid-stream failover (models/router.py): from
# finding a dead or draining replica mid-decode to the resumed stream
# opening on a sibling; attrs carry request_id and resumed_tokens.
SERVE_RECOVERY = "serve_recovery"

# Every kind the reference accepts: emit and ingest drop any other.
EVENT_KINDS = frozenset({
    NODE_PROVISIONING, NODE_PREP, NODE_IDLE, NODE_PREEMPTED,
    TASK_QUEUED, TASK_IMAGE_PULL, TASK_CONTAINER_START, TASK_RUNNING,
    TASK_RETRY, TASK_BACKOFF,
    TASK_PREEMPT_NOTICE, TASK_PREEMPT_EXIT, TASK_PREEMPT_RECOVERY,
    TASK_EVICTED, TASK_EVICTION_RECOVERY,
    GANG_RESIZE, GANG_MIGRATE, STORE_OUTAGE, TASK_ADOPTION,
    TASK_EXPANSION,
    PROGRAM_COMPILE, PROGRAM_WARMUP, PROGRAM_STEP_WINDOW,
    PROGRAM_CHECKPOINT_SAVE, PROGRAM_CHECKPOINT_RESTORE,
    PROGRAM_CHECKPOINT_ASYNC, PROGRAM_EVAL,
    SERVE_RECOVERY,
})


def iso_to_epoch(value: Optional[str]) -> Optional[float]:
    """The framework's UTC ISO timestamps to epoch seconds; None on
    junk."""
    if not value:
        return None
    try:
        return datetime.datetime.strptime(
            value, "%Y-%m-%dT%H:%M:%S.%fZ").replace(
            tzinfo=datetime.timezone.utc).timestamp()
    except ValueError:
        try:
            return datetime.datetime.fromisoformat(
                value.replace("Z", "+00:00")).timestamp()
        except ValueError:
            return None


# ----------------------------- store-backed ----------------------------

def emit(store: StateStore, pool_id: str, kind: str, *,
         job_id: Optional[str] = None, task_id: Optional[str] = None,
         node_id: Optional[str] = None,
         start: Optional[float] = None, end: Optional[float] = None,
         attrs: Optional[dict] = None,
         trace_id: Optional[str] = None,
         span_id: Optional[str] = None) -> None:
    """Append one event. An instantaneous event omits ``end`` (it
    defaults to ``start``). ``trace_id``/``span_id`` join the event to a
    submission's trace. Never raises: accounting is an observer, not a
    participant."""
    if kind not in EVENT_KINDS:
        logger.warning("unknown goodput event kind %r dropped", kind)
        return
    try:
        # Coerced inside the guard: start/end/attrs may come from a
        # task-written line, and junk there drops the event.
        ts = time.time() if start is None else float(start)
        entity = {
            "kind": kind, "job_id": job_id, "task_id": task_id,
            "node_id": node_id, "start": ts,
            "end": ts if end is None else float(end),
            "attrs": dict(attrs or {}),
        }
        if trace_id:
            entity["trace_id"] = str(trace_id)
            if span_id:
                entity["span_id"] = str(span_id)
        row_key = f"{ts:017.6f}${uuid.uuid4().hex[:8]}"
        store.insert_entity(names.TABLE_GOODPUT, pool_id, row_key, entity)
    except Exception:  # noqa: BLE001 - observer must not fail work
        logger.debug("goodput emit failed", exc_info=True)


@contextlib.contextmanager
def span(store: StateStore, pool_id: str, kind: str, *,
         job_id: Optional[str] = None, task_id: Optional[str] = None,
         node_id: Optional[str] = None,
         attrs: Optional[dict] = None,
         trace_id: Optional[str] = None,
         span_id: Optional[str] = None) -> Iterator[dict]:
    """Time a block as one interval event; yields the attrs dict so the
    body can add counters before the event is emitted."""
    out_attrs = dict(attrs or {})
    start = time.time()
    try:
        yield out_attrs
    finally:
        emit(store, pool_id, kind, job_id=job_id, task_id=task_id,
             node_id=node_id, start=start, end=time.time(),
             attrs=out_attrs, trace_id=trace_id, span_id=span_id)


def query(store: StateStore, pool_id: str,
          job_id: Optional[str] = None,
          task_id: Optional[str] = None,
          trace_id: Optional[str] = None) -> list[dict]:
    """Events of a pool (optionally one job, task or trace), sorted by
    start."""
    out = []
    for row in store.query_entities(names.TABLE_GOODPUT,
                                    partition_key=pool_id):
        if job_id is not None and row.get("job_id") != job_id:
            continue
        if task_id is not None and row.get("task_id") != task_id:
            continue
        if trace_id is not None and row.get("trace_id") != trace_id:
            continue
        out.append(row)
    return sorted(out, key=lambda e: (e.get("start", 0.0),
                                      e.get("end", 0.0)))


def prune(store: StateStore, pool_id: str,
          older_than_seconds: float) -> int:
    """Retention sweep: delete the events that ENDED more than
    ``older_than_seconds`` ago. Returns the number of rows removed."""
    cutoff = time.time() - older_than_seconds
    removed = 0
    for row in list(store.query_entities(names.TABLE_GOODPUT,
                                         partition_key=pool_id)):
        if float(row.get("end", row.get("start", 0.0))) < cutoff:
            try:
                store.delete_entity(names.TABLE_GOODPUT, pool_id,
                                    row["_rk"])
                removed += 1
            except Exception:  # noqa: BLE001 - best effort
                logger.debug("goodput prune failed", exc_info=True)
    return removed


# ---------------------------- process-local ----------------------------


def local_events_path() -> Optional[str]:
    """The JSONL sink for THIS process, or None (recorder disabled)."""
    return os.environ.get(GOODPUT_FILE_ENV) or None


def record(kind: str, start: float, end: Optional[float] = None,
           **attrs: Any) -> None:
    """Append one event to $SHIPYARD_GOODPUT_FILE with the task's trace
    ids."""
    path = local_events_path()
    if path is None:
        return
    event = {"kind": kind, "start": float(start),
             "end": float(start if end is None else end), "attrs": attrs}
    ctx = trace_ctx.TraceContext.from_env()
    if ctx is not None:
        event["trace_id"] = ctx.trace_id
        event["span_id"] = ctx.span_id
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(event) + "\n")
    except (OSError, TypeError, ValueError):
        logger.debug("goodput local record failed", exc_info=True)


@contextlib.contextmanager
def phase(kind: str, **attrs: Any) -> Iterator[dict]:
    """Time a block as one event; yields the attrs dict, which the body
    may fill in (step and token counters)."""
    out_attrs = dict(attrs)
    start = time.time()
    try:
        yield out_attrs
    finally:
        record(kind, start, time.time(), **out_attrs)


def ingest_local_events(store: StateStore, pool_id: str, path: str, *,
                        job_id: Optional[str] = None,
                        task_id: Optional[str] = None,
                        node_id: Optional[str] = None) -> int:
    """Fold a task's JSONL into the store with the task's identity.
    Returns the number of events ingested; the file is removed on
    success so a retry does not count twice. The file is task-written:
    a line that does not parse, an unknown kind or a non-numeric time is
    skipped."""
    if not os.path.exists(path):
        return 0
    count = 0
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    event = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(event, dict):
                    continue
                kind = event.get("kind")
                if kind not in EVENT_KINDS:
                    continue
                try:
                    start = float(event.get("start"))
                    end = float(event.get("end", start))
                except (TypeError, ValueError):
                    continue
                attrs = event.get("attrs")
                if not isinstance(attrs, dict):
                    attrs = {}
                trace_id = event.get("trace_id")
                emit(store, pool_id, kind, job_id=job_id,
                     task_id=task_id, node_id=node_id,
                     start=start, end=end, attrs=attrs,
                     trace_id=(str(trace_id) if trace_id else None),
                     span_id=(str(event["span_id"])
                              if trace_id and event.get("span_id")
                              else None))
                count += 1
        os.remove(path)
    except OSError:
        logger.debug("goodput ingest failed for %s", path, exc_info=True)
    return count
