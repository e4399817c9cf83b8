"""Program spans recorded from inside a task process.

Counterpart of the process-local half of batch_shipyard_tpu/trace/spans.py
(``record`` / ``phase`` and the program span kinds). A span appends one
JSON line to ``$SHIPYARD_TRACE_FILE``; its trace id comes from the task
context (trace/context.py) and its parent defaults to the task's own
span, so program phases chain under the task's run span. The agent
ingests the file after the task. With no sink or no context the
recorder is a no-op; a kind not declared below is dropped; it never
raises. Line schema::

    {"kind", "trace_id", "span_id", "parent_span_id", "start", "end",
     "attrs": {...}}
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Iterator, Optional

from batch_shipyard_tpu_torch.trace import context as trace_ctx

logger = logging.getLogger(__name__)

SPAN_COMPILE = "compile"                 # warm-up
SPAN_STEP_WINDOW = "train_step_window"   # productive step run
SPAN_CKPT_SNAPSHOT = "checkpoint_snapshot"   # step-boundary device->host
SPAN_CKPT_PERSIST = "checkpoint_persist"     # write-out; attrs carry
                                             # overlapped=True/False
SPAN_CKPT_RESTORE = "checkpoint_restore"
SPAN_PROFILE = "profile"                 # trace/profiling.py capture

SPAN_KINDS = frozenset({
    SPAN_COMPILE, SPAN_STEP_WINDOW, SPAN_CKPT_SNAPSHOT, SPAN_CKPT_PERSIST,
    SPAN_CKPT_RESTORE, SPAN_PROFILE,
})


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
