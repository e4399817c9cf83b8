"""Assemble one trace into Chrome trace-event JSON (Perfetto-loadable).

The port's copy of batch_shipyard_tpu/trace/export.py, over the port's
store. Inputs are the two logs a submission writes:

  * TABLE_TRACE spans (trace/spans.py): the causal chain (submit, queue
    wait, claim, backoff, rendezvous, run, program phases, serving
    requests); every span carries trace/span/parent ids.
  * TABLE_GOODPUT intervals (goodput/events.py): the accounting view,
    whose events carry the same trace/span id fields, so a trace's step
    windows and checkpoint phases ride along.

Output is the Chrome trace-event JSON array format (the one format
both chrome://tracing and https://ui.perfetto.dev load directly):
complete ("ph": "X") events with microsecond timestamps, one PROCESS
track per node (pid) and one THREAD track per task-instance / serving
request (tid), span/parent ids preserved under ``args`` so the causal
chain survives into the UI's flow queries.
"""

from __future__ import annotations

import json
from typing import Any, Optional

from batch_shipyard_tpu_torch.goodput import events as goodput_events
from batch_shipyard_tpu_torch.state.base import StateStore
from batch_shipyard_tpu_torch.trace import spans as trace_spans


def trace_rows(store: StateStore, pool_id: str,
               trace_id: str) -> dict[str, list[dict]]:
    """Every row of one trace: {"spans": [...], "goodput": [...]},
    each sorted by start."""
    span_rows = trace_spans.query(store, pool_id, trace_id=trace_id)
    goodput_rows = goodput_events.query(store, pool_id,
                                        trace_id=trace_id)
    return {"spans": span_rows, "goodput": goodput_rows}


def _track(row: dict) -> tuple[str, str]:
    """(pid, tid) for a row: one process track per node, one thread
    track per task instance / serving request."""
    pid = row.get("node_id") or "client"
    attrs = row.get("attrs") or {}
    if row.get("kind", "").startswith("serve_"):
        tid = f"request {attrs.get('request_id', '?')}"
    else:
        tid = row.get("task_id") or row.get("job_id") or "-"
        instance = attrs.get("instance")
        if instance is not None:
            tid = f"{tid} i{instance}"
    return str(pid), str(tid)


def to_chrome_trace(rows: dict[str, list[dict]],
                    trace_id: str) -> dict[str, Any]:
    """Chrome trace-event JSON object for one trace."""
    events: list[dict] = []
    for source, cat in (("spans", "trace"), ("goodput", "goodput")):
        for row in rows.get(source, ()):
            start = float(row.get("start", 0.0))
            end = float(row.get("end", start))
            pid, tid = _track(row)
            event = {
                "name": row.get("kind", "?"),
                "cat": cat,
                "ph": "X",
                "ts": start * 1e6,
                "dur": max(0.0, end - start) * 1e6,
                "pid": pid,
                "tid": tid,
                "args": {
                    "trace_id": row.get("trace_id"),
                    "span_id": row.get("span_id"),
                    "parent_span_id": row.get("parent_span_id"),
                    "job_id": row.get("job_id"),
                    "task_id": row.get("task_id"),
                    **(row.get("attrs") or {}),
                },
            }
            events.append(event)
    events.sort(key=lambda e: e["ts"])
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"trace_id": trace_id,
                      "spans": len(rows.get("spans", ())),
                      "goodput_events": len(rows.get("goodput", ()))},
    }


def export_trace(store: StateStore, pool_id: str,
                 trace_id: str) -> dict[str, Any]:
    """One-call assemble: rows -> Chrome trace JSON object."""
    return to_chrome_trace(trace_rows(store, pool_id, trace_id),
                           trace_id)


def validate_parent_links(chrome_trace: dict[str, Any]) -> list[str]:
    """Every span-sourced event's parent_span_id must resolve to
    another span of the SAME trace (or be absent at the root), and
    every event must carry the trace id. Returns the list of
    problems (empty = consistent)."""
    problems: list[str] = []
    events = chrome_trace.get("traceEvents", [])
    trace_id = (chrome_trace.get("otherData") or {}).get("trace_id")
    span_ids = {e["args"].get("span_id") for e in events
                if e.get("cat") == "trace"}
    for event in events:
        args = event.get("args", {})
        if args.get("trace_id") != trace_id:
            problems.append(
                f"{event.get('name')}: trace_id "
                f"{args.get('trace_id')!r} != {trace_id!r}")
        if event.get("cat") != "trace":
            continue
        parent = args.get("parent_span_id")
        if parent is not None and parent not in span_ids:
            problems.append(
                f"{event.get('name')}: parent span {parent!r} not in "
                f"this trace")
    return problems


def render_tree(rows: dict[str, list[dict]]) -> str:
    """Terminal waterfall (``shipyard trace show``): spans indented
    under their parents, goodput intervals listed after, all with
    millisecond offsets from the trace's first event."""
    span_rows = rows.get("spans", [])
    goodput_rows = rows.get("goodput", [])
    if not span_rows and not goodput_rows:
        return "(no spans recorded for this trace)"
    all_rows = span_rows + goodput_rows
    t0 = min(float(r.get("start", 0.0)) for r in all_rows)

    def fmt(row: dict, depth: int) -> str:
        start = float(row.get("start", 0.0))
        end = float(row.get("end", start))
        where = row.get("node_id") or "-"
        task = row.get("task_id") or ""
        return (f"{(start - t0) * 1e3:>10.1f}ms "
                f"{(end - start) * 1e3:>9.1f}ms  "
                f"{'  ' * depth}{row.get('kind')}"
                f"  [{where}{' ' + task if task else ''}]")

    children: dict[Optional[str], list[dict]] = {}
    by_id = {r.get("span_id"): r for r in span_rows}
    for row in span_rows:
        parent = row.get("parent_span_id")
        if parent not in by_id:
            parent = None  # orphan/root: show at top level
        children.setdefault(parent, []).append(row)

    lines = [f"{'offset':>12} {'duration':>10}  span [node task]",
             "-" * 64]

    def walk(parent: Optional[str], depth: int) -> None:
        for row in sorted(children.get(parent, ()),
                          key=lambda r: r.get("start", 0.0)):
            lines.append(fmt(row, depth))
            walk(row.get("span_id"), depth + 1)

    walk(None, 0)
    if goodput_rows:
        lines.append("-" * 64)
        lines.append("goodput intervals on this trace:")
        for row in goodput_rows:
            lines.append(fmt(row, 0))
    return "\n".join(lines)


def write_chrome_trace(chrome_trace: dict[str, Any],
                       path: str) -> str:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(chrome_trace, fh, indent=2)
    return path
