"""Perf event pipeline: phase-timestamp events into the perf table.

The port's copy of batch_shipyard_tpu/agent/perf.py.

Reference analog: cascade/perf.py:55 process_event — timestamped rows
with microsecond collision bump, emitted at each nodeprep/cascade phase;
consumed offline by graph.py to produce per-node latency breakdowns.
This is the machinery behind the pool-add -> task-start latency metric
(BASELINE.md).
"""

from __future__ import annotations

import time
from typing import Optional

from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import EntityExistsError, StateStore


def emit(store: StateStore, pool_id: str, node_id: str, source: str,
         event: str, message: Optional[str] = None,
         timestamp: Optional[float] = None) -> None:
    """Record one perf event; RowKey is the timestamp with a collision
    bump (reference perf.py RowKey scheme)."""
    ts = time.time() if timestamp is None else timestamp
    for bump in range(100):
        row_key = f"{ts + bump * 1e-6:017.6f}${node_id}${event}"
        try:
            # Collision-bump claim retry: ONE row, re-keyed until the
            # insert wins — not an n-item loop.
            store.insert_entity(names.TABLE_PERF, pool_id, row_key, {  # shipyard-lint: disable=store-write-in-loop
                "node_id": node_id, "source": source, "event": event,
                "message": message, "timestamp": ts,
            })
            return
        except EntityExistsError:
            continue


def query(store: StateStore, pool_id: str) -> list[dict]:
    return sorted(
        store.query_entities(names.TABLE_PERF, partition_key=pool_id),
        key=lambda e: e["timestamp"])
