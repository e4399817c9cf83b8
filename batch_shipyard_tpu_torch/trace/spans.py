"""Span kinds and span recorders (process-local and store-backed).

Counterpart of batch_shipyard_tpu/trace/spans.py. Every span carries
(trace_id, span_id, parent_span_id), so trace/export.py can rebuild the
causal chain of one submission. Two producer surfaces feed one log:

  * **Process-local** (``record`` / ``phase``): a span appends one JSON
    line to ``$SHIPYARD_TRACE_FILE``; its trace id comes from the task
    context (trace/context.py) and its parent defaults to the task's own
    span, so program phases chain under the task's run span. With no
    sink or no context it is a no-op.
  * **Store-backed** (``emit`` / ``span`` / ``query`` / ``prune``): the
    node side writes spans into TABLE_TRACE partitioned by pool, and
    after a task folds the task's file in with the task's identity
    (``ingest_local_spans``).

A kind not declared below is dropped; nothing here raises into the
traced work. Row schema::

    {"kind", "trace_id", "span_id", "parent_span_id", "start", "end",
     "attrs": {...}, ["job_id", "task_id", "node_id"]}
"""

from __future__ import annotations

import contextlib
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

# Submission and scheduling (the node side's emitters).
SPAN_SUBMIT = "submit"                   # jobs add -> entities + queued
SPAN_QUEUE_WAIT = "queue_wait"           # submit/requeue -> claim
SPAN_CLAIM = "claim"                     # instantaneous claim marker
SPAN_BACKOFF_WAIT = "backoff_wait"       # retry supervisor delay
SPAN_REQUEUE = "requeue"                 # instantaneous requeue marker
SPAN_RENDEZVOUS = "gang_rendezvous"      # gang join -> full formation
SPAN_IMAGE_PULL = "image_pull"           # image provisioning on node
SPAN_TASK_RUN = "task_run"               # task process start -> exit
SPAN_CACHE_SEED = "compile_cache_seed"   # pre-task pool-cache seed
SPAN_PREEMPT = "preempt"                 # preempt notice -> drained exit
SPAN_EVICT = "evict"                     # preempt notice -> hard kill
SPAN_GANG_RESIZE = "gang_resize"         # instantaneous: gang re-formed
SPAN_AGENT_RESTART = "agent_restart"     # crashed agent -> re-adoption
SPAN_GANG_MIGRATE = "gang_migrate"       # starved -> re-targeted
# Program phases (process-local, inside the task).
SPAN_COMPILE = "compile"                 # warm-up / AOT precompile
SPAN_STEP_WINDOW = "train_step_window"   # productive step run
SPAN_CKPT_SNAPSHOT = "checkpoint_snapshot"   # step-boundary device->host
SPAN_CKPT_PERSIST = "checkpoint_persist"     # write-out; attrs carry
                                             # overlapped=True/False
SPAN_CKPT_RESTORE = "checkpoint_restore"
SPAN_PROFILE = "profile"                 # trace/profiling.py capture
# One served request (models/server.py): the parent span and its
# three phases.
SPAN_SERVE_REQUEST = "serve_request"     # arrival -> completion
SPAN_SERVE_QUEUED = "serve_queued"       # arrival -> engine admission
SPAN_SERVE_PREFILL = "serve_prefill"     # admission -> first token
SPAN_SERVE_DECODE = "serve_decode"       # first token -> last token

SPAN_KINDS = frozenset({
    SPAN_SUBMIT, SPAN_QUEUE_WAIT, SPAN_CLAIM, SPAN_BACKOFF_WAIT,
    SPAN_REQUEUE, SPAN_RENDEZVOUS, SPAN_IMAGE_PULL, SPAN_TASK_RUN,
    SPAN_CACHE_SEED, SPAN_PREEMPT, SPAN_EVICT, SPAN_GANG_RESIZE,
    SPAN_GANG_MIGRATE, SPAN_AGENT_RESTART,
    SPAN_COMPILE, SPAN_STEP_WINDOW, SPAN_CKPT_SNAPSHOT, SPAN_CKPT_PERSIST,
    SPAN_CKPT_RESTORE, SPAN_PROFILE, SPAN_SERVE_REQUEST, SPAN_SERVE_QUEUED,
    SPAN_SERVE_PREFILL, SPAN_SERVE_DECODE,
})


# ----------------------------- store-backed ----------------------------

def emit(store: StateStore, pool_id: str, kind: str,
         ctx: Optional[trace_ctx.TraceContext], *,
         job_id: Optional[str] = None, task_id: Optional[str] = None,
         node_id: Optional[str] = None,
         start: Optional[float] = None, end: Optional[float] = None,
         attrs: Optional[dict] = None,
         self_span: bool = False) -> Optional[str]:
    """Append one span under ``ctx``: a new child span id, parented at
    ctx.span_id; ``self_span=True`` records ctx's OWN span instead (id
    ctx.span_id, parent ctx.parent_span_id), for a span whose id must be
    known in advance, like the submit root. No-op for ctx None or an
    undeclared kind. Returns the span id written, or None. Never
    raises."""
    if ctx is None:
        return None
    if kind not in SPAN_KINDS:
        logger.warning("unknown span kind %r dropped", kind)
        return None
    if self_span:
        span_id, parent = ctx.span_id, ctx.parent_span_id
    else:
        span_id, parent = trace_ctx.new_span_id(), ctx.span_id
    try:
        ts = time.time() if start is None else float(start)
        entity = {
            "kind": kind, "trace_id": ctx.trace_id,
            "span_id": span_id, "parent_span_id": parent,
            "job_id": job_id, "task_id": task_id, "node_id": node_id,
            "start": ts, "end": ts if end is None else float(end),
            "attrs": dict(attrs or {}),
        }
        row_key = f"{ts:017.6f}${uuid.uuid4().hex[:8]}"
        store.insert_entity(names.TABLE_TRACE, pool_id, row_key, entity)
        return span_id
    except Exception:  # noqa: BLE001 - observer must not fail work
        logger.debug("trace emit failed", exc_info=True)
        return None


@contextlib.contextmanager
def span(store: StateStore, pool_id: str, kind: str,
         ctx: Optional[trace_ctx.TraceContext], *,
         job_id: Optional[str] = None, task_id: Optional[str] = None,
         node_id: Optional[str] = None,
         attrs: Optional[dict] = None) -> Iterator[dict]:
    """Time a block as one span; yields the attrs dict so the body can
    add counters before the span is emitted."""
    out_attrs = dict(attrs or {})
    start = time.time()
    try:
        yield out_attrs
    finally:
        emit(store, pool_id, kind, ctx, job_id=job_id, task_id=task_id,
             node_id=node_id, start=start, end=time.time(),
             attrs=out_attrs)


def query(store: StateStore, pool_id: str,
          trace_id: Optional[str] = None,
          job_id: Optional[str] = None) -> list[dict]:
    """Spans of a pool (optionally one trace or job), sorted by start."""
    out = []
    for row in store.query_entities(names.TABLE_TRACE,
                                    partition_key=pool_id):
        if trace_id is not None and row.get("trace_id") != trace_id:
            continue
        if job_id is not None and row.get("job_id") != job_id:
            continue
        out.append(row)
    return sorted(out, key=lambda e: (e.get("start", 0.0),
                                      e.get("end", 0.0)))


def prune(store: StateStore, pool_id: str,
          older_than_seconds: float) -> int:
    """Retention sweep: drop the spans that ENDED more than
    ``older_than_seconds`` ago. Returns the number removed."""
    cutoff = time.time() - older_than_seconds
    removed = 0
    for row in list(store.query_entities(names.TABLE_TRACE,
                                         partition_key=pool_id)):
        if float(row.get("end", row.get("start", 0.0))) < cutoff:
            try:
                store.delete_entity(names.TABLE_TRACE, pool_id, row["_rk"])
                removed += 1
            except Exception:  # noqa: BLE001 - best effort
                logger.debug("trace prune failed", exc_info=True)
    return removed


# ---------------------------- process-local ----------------------------


def local_spans_path() -> Optional[str]:
    """The JSONL sink for THIS process, or None (recorder disabled)."""
    return os.environ.get(trace_ctx.TRACE_FILE_ENV) or None


def record(kind: str, start: float, end: Optional[float] = None,
           parent_span_id: Optional[str] = None,
           span_id: Optional[str] = None, **attrs: Any) -> Optional[str]:
    """Append one span; returns its id, or None when nothing was
    written."""
    return _record(kind, start, end, attrs, parent_span_id=parent_span_id,
                   span_id=span_id)


def _record(kind: str, start: float, end: Optional[float], attrs: dict,
            parent_span_id: Optional[str] = None,
            span_id: Optional[str] = None) -> Optional[str]:
    """record() with the attrs as a dict, so an attr named "start" or
    "end" stays data."""
    path = local_spans_path()
    ctx = trace_ctx.TraceContext.from_env()
    if path is None or ctx is None:
        return None
    if kind not in SPAN_KINDS:
        logger.warning("unknown span kind %r dropped", kind)
        return None
    sid = span_id or trace_ctx.new_span_id()
    event = {
        "kind": kind, "trace_id": ctx.trace_id, "span_id": sid,
        "parent_span_id": parent_span_id or ctx.span_id,
        "start": float(start),
        "end": float(start if end is None else end),
        "attrs": dict(attrs),
    }
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "a", encoding="utf-8") as fh:
            fh.write(json.dumps(event) + "\n")
        return sid
    except (OSError, TypeError, ValueError):
        logger.debug("trace local record failed", exc_info=True)
        return None


@contextlib.contextmanager
def phase(kind: str, **attrs: Any) -> Iterator[dict]:
    """Time a block as one span; yields the attrs dict, which the body
    may fill in."""
    out_attrs = dict(attrs)
    start = time.time()
    try:
        yield out_attrs
    finally:
        _record(kind, start, time.time(), out_attrs)


def ingest_local_spans(store: StateStore, pool_id: str, path: str, *,
                       job_id: Optional[str] = None,
                       task_id: Optional[str] = None,
                       node_id: Optional[str] = None) -> int:
    """Fold a task's JSONL spans into the store with the task's identity,
    in one batched insert. The file is task-written: junk lines are
    skipped. The file is removed either way, so a retry never counts a
    span twice (a failed batch loses spans rather than doubling them).
    Returns the number of spans ingested."""
    if not os.path.exists(path):
        return 0
    count = 0
    rows: list[tuple[str, str, dict]] = []
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
                if not isinstance(event, dict) or \
                        event.get("kind") not in SPAN_KINDS:
                    continue
                trace_id = event.get("trace_id")
                span_id = event.get("span_id")
                if not trace_id or not span_id:
                    continue
                try:
                    start = float(event.get("start"))
                    end = float(event.get("end", start))
                except (TypeError, ValueError):
                    continue
                attrs = event.get("attrs")
                if not isinstance(attrs, dict):
                    attrs = {}
                row_key = f"{start:017.6f}${uuid.uuid4().hex[:8]}"
                rows.append((pool_id, row_key, {
                    "kind": event["kind"],
                    "trace_id": str(trace_id),
                    "span_id": str(span_id),
                    "parent_span_id": event.get("parent_span_id"),
                    "job_id": job_id, "task_id": task_id,
                    "node_id": node_id,
                    "start": start, "end": end,
                    "attrs": attrs,
                }))
        try:
            store.insert_entities(names.TABLE_TRACE, rows)
            count = len(rows)
        except Exception:  # noqa: BLE001 - best effort
            logger.debug("trace ingest insert failed", exc_info=True)
        os.remove(path)
    except OSError:
        logger.debug("trace ingest failed for %s", path, exc_info=True)
    return count
