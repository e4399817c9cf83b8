"""Offline perf analysis: coalesce perf events into per-node phase
durations and render a timeline.

The port's copy of batch_shipyard_tpu/graph/perf_graph.py, over the
port's perf table (agent/perf.py).

Reference analog: cascade/graph.py — coalesce_data(:169) computing
per-node deltas for nodeprep, docker_install, global_resources_loaded
and per-image pull/save, and graph_data(:270) rendering a matplotlib
gantt. This drives the pool-add -> task-start latency breakdown
(BASELINE.md metric 2).
"""

from __future__ import annotations

from typing import Optional

from batch_shipyard_tpu_torch.agent import perf
from batch_shipyard_tpu_torch.state.base import StateStore

# Phase = (start event, end event) per source.
_PHASES = [
    ("nodeprep", "nodeprep", "start", "end"),
    ("pool_create", "pool", "create.start", "create.end"),
]


def coalesce_data(store: StateStore, pool_id: str) -> dict:
    """Per-node phase durations + per-image pull timings.

    Returns {node_id: {phase: {start, end, seconds}},
             "images": {node_id: {image: seconds}}}.
    """
    events = perf.query(store, pool_id)
    by_node: dict[str, list[dict]] = {}
    for event in events:
        by_node.setdefault(event["node_id"], []).append(event)
    out: dict = {"nodes": {}, "images": {}}
    for node_id, rows in by_node.items():
        phases: dict[str, dict] = {}
        for name, source, start_ev, end_ev in _PHASES:
            start = next((r["timestamp"] for r in rows
                          if r["source"] == source and
                          r["event"] == start_ev), None)
            end = next((r["timestamp"] for r in rows
                        if r["source"] == source and
                        r["event"] == end_ev), None)
            if start is not None and end is not None:
                phases[name] = {"start": start, "end": end,
                                "seconds": end - start}
        # Per-image pulls: cascade pull.start:<image> / pull.end:<image>
        pulls: dict[str, float] = {}
        starts: dict[str, float] = {}
        for row in rows:
            event = row["event"]
            if event.startswith("pull.start:"):
                starts[event.split(":", 1)[1]] = row["timestamp"]
            elif event.startswith("pull.end:"):
                image = event.split(":", 1)[1]
                if image in starts:
                    pulls[image] = row["timestamp"] - starts[image]
        grl = next((r["timestamp"] for r in rows
                    if r["event"] == "global_resources_loaded"), None)
        if grl is not None and "nodeprep" in phases:
            phases["global_resources_loaded"] = {
                "start": phases["nodeprep"]["start"], "end": grl,
                "seconds": grl - phases["nodeprep"]["start"]}
        if phases:
            out["nodes"][node_id] = phases
        if pulls:
            out["images"][node_id] = pulls
    return out


def render_text_gantt(data: dict, width: int = 60) -> str:
    """ASCII gantt of node phases (matplotlib-free default; the
    reference's graph_data drew the same bars with matplotlib)."""
    lines: list[str] = []
    all_times = [p[k] for node in data["nodes"].values()
                 for p in node.values() for k in ("start", "end")]
    if not all_times:
        return "(no perf events)"
    t0, t1 = min(all_times), max(all_times)
    span = max(t1 - t0, 1e-9)
    for node_id in sorted(data["nodes"]):
        for phase, info in sorted(data["nodes"][node_id].items()):
            begin = int((info["start"] - t0) / span * width)
            end = max(begin + 1, int((info["end"] - t0) / span * width))
            bar = " " * begin + "#" * (end - begin)
            lines.append(f"{node_id:24s} {phase:24s} |{bar:<{width}}| "
                         f"{info['seconds']:.3f}s")
    return "\n".join(lines)


def graph_data(store: StateStore, pool_id: str,
               output_path: Optional[str] = None) -> str:
    """Coalesce + render; writes a PNG via matplotlib when available
    and an output path is given, else returns the ASCII gantt."""
    data = coalesce_data(store, pool_id)
    text = render_text_gantt(data)
    if output_path:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            fig, ax = plt.subplots(figsize=(12, 6))
            ypos = 0
            labels = []
            for node_id in sorted(data["nodes"]):
                for phase, info in sorted(data["nodes"][node_id].items()):
                    ax.barh(ypos, info["seconds"], left=info["start"],
                            height=0.8)
                    labels.append(f"{node_id}:{phase}")
                    ypos += 1
            ax.set_yticks(range(len(labels)))
            ax.set_yticklabels(labels, fontsize=6)
            ax.set_xlabel("unix time (s)")
            fig.tight_layout()
            fig.savefig(output_path, dpi=120)
            plt.close(fig)
        except ImportError:
            import logging
            logging.getLogger(__name__).warning(
                "matplotlib not available; %s not written (ASCII "
                "gantt returned instead)", output_path)
    return text
