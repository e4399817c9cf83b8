"""The trace context a task process runs under.

Counterpart of batch_shipyard_tpu/trace/context.py, the part a task
reads: the pool's agent exports the task's trace id and its own span id
(``$SHIPYARD_TRACE_ID``, ``$SHIPYARD_TRACE_SPAN_ID``) and a JSONL sink
(``$SHIPYARD_TRACE_FILE``). Program spans (trace/spans.py) parent under
the exported span, and goodput events (goodput/events.py) carry the same
ids, so a run's intervals join the submission's trace.
"""

from __future__ import annotations

import dataclasses
import os
import uuid
from typing import Optional

TRACE_ID_ENV = "SHIPYARD_TRACE_ID"
TRACE_SPAN_ENV = "SHIPYARD_TRACE_SPAN_ID"
TRACE_FILE_ENV = "SHIPYARD_TRACE_FILE"


def new_span_id() -> str:
    return uuid.uuid4().hex[:8]


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """An immutable (trace, span, parent) triple."""

    trace_id: str
    span_id: str
    parent_span_id: Optional[str] = None

    @classmethod
    def from_env(cls) -> Optional["TraceContext"]:
        """The context exported into THIS process, or None outside pool
        tasks (tracing is then a no-op). Both ids must be present."""
        trace_id = os.environ.get(TRACE_ID_ENV)
        span_id = os.environ.get(TRACE_SPAN_ENV)
        if not trace_id or not span_id:
            return None
        return cls(trace_id=trace_id, span_id=span_id)
