"""Trace-context identity and propagation.

Counterpart of batch_shipyard_tpu/trace/context.py. A context is three
ids: ``trace_id`` (one per job submission), ``span_id`` (the current
operation's own) and ``parent_span_id`` (the operation that caused it;
None at the root). A submission's context is stored on its task rows
(``from_entity`` reads it back); the pool's agent exports the task's
trace id and its own span id (``$SHIPYARD_TRACE_ID``,
``$SHIPYARD_TRACE_SPAN_ID``) and a JSONL sink (``$SHIPYARD_TRACE_FILE``)
into the task. Program spans (trace/spans.py) parent under the exported
span, and goodput events (goodput/events.py) carry the same ids, so a
run's intervals join the submission's trace. Ids are short hex: 16
characters for a trace, 8 for a span.
"""

from __future__ import annotations

import dataclasses
import os
import uuid
from typing import Optional

TRACE_ID_ENV = "SHIPYARD_TRACE_ID"
TRACE_SPAN_ENV = "SHIPYARD_TRACE_SPAN_ID"
TRACE_FILE_ENV = "SHIPYARD_TRACE_FILE"

# Task and job entity columns: the task's root span and its parent.
COL_TRACE_ID = "trace_id"
COL_TRACE_SPAN = "trace_span_id"
COL_TRACE_PARENT = "trace_parent_span_id"


def new_trace_id() -> str:
    return uuid.uuid4().hex[:16]


def new_span_id() -> str:
    return uuid.uuid4().hex[:8]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """An immutable (trace, span, parent) triple."""

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None

    @classmethod
    def new(cls) -> "TraceContext":
        """A fresh root context (the submit span of a new trace)."""
        return cls(trace_id=new_trace_id(), span_id=new_span_id())

    def child(self) -> "TraceContext":
        """A new span caused by this one."""
        return TraceContext(trace_id=self.trace_id,
                            span_id=new_span_id(),
                            parent_span_id=self.span_id)

    @classmethod
    def from_entity(cls, entity: dict) -> Optional["TraceContext"]:
        """The context stored on a task or job row, or None for a row
        without one. A row with a trace id but no span id is None too:
        minting a span id per call would give every caller a different
        root and break the parent chain."""
        trace_id = entity.get(COL_TRACE_ID)
        span_id = entity.get(COL_TRACE_SPAN)
        if not trace_id or not span_id:
            return None
        parent = entity.get(COL_TRACE_PARENT)
        return cls(trace_id=str(trace_id), span_id=str(span_id),
                   parent_span_id=str(parent) if parent else None)

    def entity_columns(self) -> dict[str, str]:
        """The columns a task or job row stores for this context."""
        out = {COL_TRACE_ID: self.trace_id,
               COL_TRACE_SPAN: self.span_id}
        if self.parent_span_id:
            out[COL_TRACE_PARENT] = self.parent_span_id
        return out

    @classmethod
    def from_env(cls) -> Optional["TraceContext"]:
        """The context exported into THIS process, or None outside pool
        tasks (tracing is then a no-op). Both ids must be present."""
        trace_id = os.environ.get(TRACE_ID_ENV)
        span_id = os.environ.get(TRACE_SPAN_ENV)
        if not trace_id or not span_id:
            return None
        return cls(trace_id=trace_id, span_id=span_id)

    def env(self) -> dict[str, str]:
        """The env block the pool's agent exports into a task process."""
        return {TRACE_ID_ENV: self.trace_id,
                TRACE_SPAN_ENV: self.span_id}
