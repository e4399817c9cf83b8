"""Goodput program phases recorded from inside a task process.

Counterpart of the process-local half of
batch_shipyard_tpu/goodput/events.py (``record`` / ``phase`` and the
``PROGRAM_*`` kinds). An event appends one JSON line to
``$SHIPYARD_GOODPUT_FILE``, which the agent ingests after the task with
the task's identity; the pool's accounting prices the intervals (the
step windows as productive time, a blocking checkpoint save as
checkpoint badput, an overlapped async persist as overlapped). The
task's trace context (trace/context.py) is attached. No-op without a
file; never raises. Line schema::

    {"kind", "start", "end", "attrs": {...}, ["trace_id", "span_id"]}
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

GOODPUT_FILE_ENV = "SHIPYARD_GOODPUT_FILE"

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
