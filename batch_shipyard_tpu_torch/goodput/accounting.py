"""Goodput accounting engine: events -> the paper's decomposition.

The port's copy of batch_shipyard_tpu/goodput/accounting.py, over
the port's events (goodput/events.py) and store.

"ML Productivity Goodput" (arxiv 2502.06982) decomposes the fraction
of wall-clock time that produces useful progress as::

    goodput = availability x resource x program

  availability — had resources at all (scheduling leg): wall minus
                 provisioning + queueing badput, over wall.
  resource     — resources actually ran the program (runtime leg):
                 minus image-pull, idle and unaccounted time.
  program      — the running program made FRESH progress (program
                 leg): minus compile/warm-up, checkpoint overhead and
                 preemption-recovery rework (steps replayed since the
                 last checkpoint).

Everything here is a pure function over event dicts (the shape
goodput/events.py produces), so the whole engine is testable on the
in-memory store with synthetic timelines.

Overlapping-interval resolution: the timeline is swept over elementary
segments between event boundaries; each segment is charged to exactly
one category — the highest-priority interval covering it (a checkpoint
save inside a step window is checkpoint overhead, not productive
time). Categories therefore PARTITION wall clock: productive +
badput + unaccounted == wall by construction.
"""

from __future__ import annotations

from typing import Any, Optional

from batch_shipyard_tpu_torch.goodput import events as ev
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import StateStore

# Badput categories (the waterfall rows). "unaccounted" is wall time
# no event covers — surfaced explicitly instead of silently inflating
# a real category.
BADPUT_CATEGORIES = (
    "provisioning", "queueing", "expansion", "backoff", "image_pull",
    "compile", "checkpoint", "preemption_recovery", "eviction",
    "migration", "adoption", "serving_recovery", "store_outage",
    "idle", "unaccounted",
)

PRODUCTIVE = "productive"

# Overlapped categories: shown in the waterfall but NOT charged as
# badput. checkpoint_async is the async save pipeline's background
# persist — when live step windows cover it the time stays productive
# (the sweep ranks it below PRODUCTIVE); only its uncovered tail (e.g.
# the drain at loop exit) lands in this bucket. The partition
# invariant extends to: productive + badput + overlapped == wall.
OVERLAPPED_CATEGORIES = ("checkpoint_async",)

# kind -> category. step_window is handled specially (fresh portion is
# productive, replayed portion is preemption_recovery rework); retry is
# instantaneous (counted, zero duration).
_KIND_CATEGORY = {
    ev.NODE_PROVISIONING: "provisioning",
    ev.NODE_PREP: "provisioning",
    ev.NODE_PREEMPTED: "provisioning",   # reclaim -> re-provision time
    ev.TASK_QUEUED: "queueing",
    # Server-side task-factory expansion: the expander leader
    # materializing a generator spec into rows + messages. Scheduling
    # machinery like queueing, but its own leg so the 10^6-task bench
    # can show the submit work that moved pool-side instead of it
    # vanishing into the queued wait it overlaps.
    ev.TASK_EXPANSION: "expansion",
    ev.TASK_BACKOFF: "backoff",
    # Preempted exit -> re-claim: the recovery leg every preemption
    # pays (arxiv 2502.06982) — outranks queueing in the sweep, like
    # backoff, so the wait is charged to its more specific cause.
    ev.TASK_PREEMPT_RECOVERY: "preemption_recovery",
    # Evicted exit -> re-claim: the forcible sibling of the
    # preemption-recovery leg. Distinct because an eviction ALSO pays
    # the steps replayed since the pre-notice barrier (the drain
    # never happened), and fleet operators tune the grace window by
    # comparing exactly these two legs.
    ev.TASK_EVICTION_RECOVERY: "eviction",
    # Cross-pool migration wait: starved/preempted in the source pool
    # -> re-targeted and claimable on the sibling pool.
    ev.GANG_MIGRATE: "migration",
    # Agent crash -> restarted agent re-adopts the still-running
    # task: the control-plane gap an agent restart costs. Distinct
    # from the recovery legs above because NO work was lost — the
    # task ran through it — so the leg prices pure coordination
    # downtime.
    ev.TASK_ADOPTION: "adoption",
    # Serving-tier mid-stream failover (models/router.py): replica
    # death/drain detected -> resumed stream open on a sibling. The
    # re-prefill of prompt+emitted tokens and the drain-abandoned
    # decode are real lost work on the serving path — a priced leg,
    # not an invisible 5xx (arxiv 2502.06982 extended to serving).
    ev.SERVE_RECOVERY: "serving_recovery",
    # State-store outage window (state/resilient.py latch): the
    # control plane was down; whatever productive step windows cover
    # of it stays productive (the sweep ranks productive higher), and
    # only the uncovered remainder is charged here.
    ev.STORE_OUTAGE: "store_outage",
    ev.TASK_IMAGE_PULL: "image_pull",
    ev.TASK_CONTAINER_START: "image_pull",
    ev.PROGRAM_COMPILE: "compile",
    ev.PROGRAM_WARMUP: "compile",
    ev.PROGRAM_CHECKPOINT_SAVE: "checkpoint",
    ev.PROGRAM_CHECKPOINT_RESTORE: "checkpoint",
    ev.PROGRAM_CHECKPOINT_ASYNC: "checkpoint_async",
    ev.NODE_IDLE: "idle",
    ev.PROGRAM_STEP_WINDOW: PRODUCTIVE,
    ev.PROGRAM_EVAL: PRODUCTIVE,
    ev.TASK_RUNNING: "_running",         # container; lowest priority
}

# Decomposition legs: which categories each leg loses. The program
# leg (compile/checkpoint/preemption_recovery plus any uncovered
# overlapped persist) needs no tuple — it is whatever remains of run
# time after productive, so program goodput is computed directly as
# productive / run time.
_SCHEDULING_BADPUT = ("provisioning", "queueing", "expansion",
                      "backoff")
_RESOURCE_BADPUT = ("image_pull", "idle", "unaccounted")

# Sweep priority, highest first. SAME-PROGRAM overheads (rework,
# checkpoint, compile — instrumented as phases nested inside the
# program's own timeline) beat productive time; productive time beats
# the async persist (overlapped-by-design: a background write under a
# live step window must not erase the step's progress) which beats
# CROSS-TASK waits (another task's queued/image-pull span overlapping
# a busy node's step window is concurrency, not wasted node time —
# ranking those above PRODUCTIVE would let one waiting task erase a
# whole pool's productive seconds); waits beat idle beats the bare
# running container beats nothing (unaccounted).
# "backoff" outranks "queueing": the retry supervisor's deliberate
# delay window sits INSIDE the retried task's queued span (requeue ->
# re-claim), and the sweep must charge those seconds to the more
# specific cause exactly once.
_PRIORITY = (
    # "eviction"/"migration" sit with "preemption_recovery": each is
    # a recovery wait nested inside the victim's queued span, charged
    # to its more specific cause exactly once. Migration outranks
    # eviction outranks preemption: a migrated gang's window subsumes
    # the starvation that triggered it.
    # "adoption" rides with them: the restart gap is a recovery wait
    # on the task's timeline, charged to its specific cause before
    # any generic wait could claim the seconds.
    # "serving_recovery" rides at the same rank: a serving failover
    # window is a recovery wait on the request's timeline, charged to
    # its specific cause before productive step windows could absorb
    # the seconds.
    "migration", "eviction", "preemption_recovery", "adoption",
    "serving_recovery",
    "checkpoint", "compile", PRODUCTIVE,
    "checkpoint_async",
    # "store_outage" sits below the work-shaped categories (a task
    # that kept stepping through the outage keeps its productive
    # seconds — the ride-through working is not badput) but above
    # idle: control-plane downtime is a more specific story for
    # uncovered seconds than "nothing scheduled".
    # "expansion" outranks "queueing": while the expander is still
    # materializing a job's rows, that job's queued seconds have a
    # more specific cause than a generic backlog wait.
    "image_pull", "provisioning", "backoff", "expansion", "queueing",
    "store_outage", "idle",
    "_running",
)
_PRIORITY_RANK = {c: i for i, c in enumerate(_PRIORITY)}


def _as_int(value: Any) -> Optional[int]:
    """Counter attrs come from task-written JSONL: coerce defensively
    — junk degrades the window to counter-less, never a crash."""
    try:
        return int(value)
    except (TypeError, ValueError):
        return None


def _split_step_windows(windows: list[dict]) -> list[tuple]:
    """Split step_window events into (start, end, category) pieces:
    the portion covering steps already completed before (replay after
    a checkpoint restore) is preemption-recovery rework; the rest is
    productive. Windows without step counters are wholly productive.

    This is the "lost-step rework since last checkpoint" number: a
    job that checkpointed at step 80, was preempted at step 100 and
    restored to 80 replays steps 80..100 — that whole replayed window
    is badput.

    Step numbering is PER JOB: the high-water mark is tracked within
    each job_id group, so pool/fleet rollups never misprice an
    unrelated job's fresh steps 0..N as another job's replay. Within
    a job, only windows from STRICTLY EARLIER windows count toward
    the high-water mark: a gang's instances all record the same
    step range CONCURRENTLY (SPMD — that is one unit of progress,
    not replay), while a post-restore replay necessarily starts
    after the preempted window ended."""
    pieces: list[tuple] = []
    by_job: dict = {}
    for event in windows:
        by_job.setdefault(event.get("job_id"), []).append(event)
    for group in by_job.values():
        pieces.extend(_split_step_windows_one_job(group))
    return pieces


def _split_step_windows_one_job(windows: list[dict]) -> list[tuple]:
    return [(start, end, category) for (_event, start, end, category)
            in _split_step_windows_one_job_detailed(windows)]


def _split_step_windows_one_job_detailed(windows: list[dict]
                                         ) -> list[tuple]:
    """(event, start, end, category) pieces — the event reference
    lets callers re-attribute a piece to the node that executed it
    (see _replay_recovery_spans)."""
    pieces: list[tuple] = []
    completed: list[tuple] = []  # (end_time, step_end)
    for event in sorted(windows, key=lambda e: (e.get("start", 0.0),
                                                e.get("end", 0.0))):
        start = float(event.get("start", 0.0))
        end = float(event.get("end", start))
        attrs = event.get("attrs") or {}
        step_start = _as_int(attrs.get("step_start"))
        step_end = _as_int(attrs.get("step_end"))
        if step_start is None or step_end is None or \
                step_end <= step_start:
            pieces.append((event, start, end, PRODUCTIVE))
            continue
        # High-water mark over windows that ENDED before this one
        # started — concurrent (overlapping) gang instances never
        # count each other as replay.
        done_before = [se for (et, se) in completed if et <= start]
        replayed = 0
        if done_before:
            replayed = max(0, min(step_end, max(done_before))
                           - step_start)
        frac = min(1.0, replayed / (step_end - step_start))
        cut = start + (end - start) * frac
        if frac > 0:
            pieces.append((event, start, cut, "preemption_recovery"))
        if frac < 1.0:
            pieces.append((event, cut, end, PRODUCTIVE))
        completed.append((end, step_end))
    return pieces


def _replay_recovery_spans(event_list: list[dict]) -> list[dict]:
    """Explicit recovery spans for replayed step-window prefixes,
    computed over the FULL event set.

    ``_split_step_windows`` tracks the per-job step high-water mark,
    but ``decompose_by_node`` sweeps each node's events on its own
    timeline — a task preempted on node A whose replay runs on node B
    has its two windows in different groups, and B's sweep would
    price the rework as productive (it never sees A's completed
    range). This pre-pass finds every replayed prefix globally and
    emits a synthetic preemption-recovery span tagged to the node
    that EXECUTED the replay, so the per-node sweep prices it no
    matter where the task resumed. Same-node replay is double-covered
    (split piece + synthetic span) — harmless, the priority sweep
    charges each elementary second once."""
    windows = [e for e in event_list
               if e.get("kind") == ev.PROGRAM_STEP_WINDOW]
    spans: list[dict] = []
    by_job: dict = {}
    for event in windows:
        by_job.setdefault(event.get("job_id"), []).append(event)
    for group in by_job.values():
        for event, start, end, category in \
                _split_step_windows_one_job_detailed(group):
            if category != "preemption_recovery" or end <= start:
                continue
            spans.append({
                "kind": ev.TASK_PREEMPT_RECOVERY,
                "start": start, "end": end,
                "node_id": event.get("node_id"),
                "job_id": event.get("job_id"),
                "task_id": event.get("task_id"),
                "attrs": {"synthetic": "cross_node_replay"}})
    return spans


def _sweep(intervals: list[tuple], wall_start: float,
           wall_end: float) -> dict[str, float]:
    """Charge every elementary segment of [wall_start, wall_end] to
    the highest-priority covering category; uncovered time is
    "unaccounted". Returns {category: seconds} partitioning wall.

    Sweep line over sorted endpoints with per-category active counts:
    O(N log N) in the interval count — periodic consumers (the
    heimdall export) re-run this every poll, so no quadratic scans."""
    seconds = {c: 0.0 for c in BADPUT_CATEGORIES}
    seconds.update({c: 0.0 for c in OVERLAPPED_CATEGORIES})
    seconds[PRODUCTIVE] = 0.0
    seconds["_running"] = 0.0
    boundary: list[tuple] = [(wall_start, 0, None), (wall_end, 0, None)]
    for start, end, category in intervals:
        start = max(start, wall_start)
        end = min(end, wall_end)
        if end <= start:
            continue
        boundary.append((start, +1, category))
        boundary.append((end, -1, category))
    boundary.sort(key=lambda b: b[0])
    active = [0] * len(_PRIORITY)
    prev = wall_start
    for point, delta, category in boundary:
        left = max(prev, wall_start)
        right = min(point, wall_end)
        if right > left:
            winner = next((c for rank, c in enumerate(_PRIORITY)
                           if active[rank] > 0), None)
            seconds[winner if winner else "unaccounted"] += (
                right - left)
        prev = point
        if delta:
            active[_PRIORITY_RANK[category]] += delta
    # The bare running container (task process alive but no program
    # phase claimed the time) is runtime overhead the program leg
    # can't see; fold it into unaccounted rather than invent a
    # category the paper doesn't have.
    seconds["unaccounted"] += seconds.pop("_running")
    return seconds


def decompose(event_list: list[dict],
              wall: Optional[tuple[float, float]] = None
              ) -> dict[str, Any]:
    """Fold events into the goodput decomposition + badput breakdown.

    ``wall`` overrides the accounting window; by default it spans
    [min start, max end] over the events."""
    event_list = [e for e in event_list
                  if e.get("kind") in ev.EVENT_KINDS]
    if not event_list:
        return _empty_report()
    starts = [float(e.get("start", 0.0)) for e in event_list]
    ends = [float(e.get("end", e.get("start", 0.0)))
            for e in event_list]
    wall_start, wall_end = wall or (min(starts), max(ends))
    wall_seconds = max(0.0, wall_end - wall_start)

    intervals: list[tuple] = []
    step_windows: list[dict] = []
    retries = 0
    preemptions = 0
    steps = 0
    tokens = 0
    # Warm-start compilation detail (compilecache/manager.py): compile
    # and warm-up events carry cache_hit/saved_seconds attrs — the
    # seconds a warm persistent-cache hit did NOT spend compiling.
    # Reported NEXT TO compile badput (it is avoided time, not an
    # interval on the timeline — the partition is untouched).
    compile_saved = 0.0
    compile_hits = 0
    compile_misses = 0
    # Counter dedup: an N-wide SPMD gang ingests N identical step
    # ranges per job (one per instance) — one unit of progress, so
    # each distinct (job, step range) counts its steps/tokens once.
    counted_ranges: set = set()
    for event in event_list:
        kind = event.get("kind")
        if kind == ev.TASK_RETRY:
            retries += 1
            continue
        if kind == ev.PROGRAM_STEP_WINDOW:
            step_windows.append(event)
            attrs = event.get("attrs") or {}
            step_start = _as_int(attrs.get("step_start"))
            step_end = _as_int(attrs.get("step_end"))
            range_key = (event.get("job_id"), step_start, step_end)
            if step_start is not None and step_end is not None and \
                    range_key not in counted_ranges:
                counted_ranges.add(range_key)
                steps += max(0, step_end - step_start)
                tokens += _as_int(attrs.get("tokens")) or 0
            continue
        if kind in (ev.PROGRAM_COMPILE, ev.PROGRAM_WARMUP):
            attrs = event.get("attrs") or {}
            hit = attrs.get("cache_hit")
            if hit is True:
                compile_hits += 1
            elif hit is False:
                compile_misses += 1
            try:
                compile_saved += max(
                    0.0, float(attrs.get("saved_seconds") or 0.0))
            except (TypeError, ValueError):
                pass
        category = _KIND_CATEGORY.get(kind)
        if category is None:
            continue
        start = float(event.get("start", 0.0))
        end = float(event.get("end", start))
        if kind == ev.NODE_PREEMPTED and end <= start:
            # Zero-duration observation marker (autoscale emits these
            # as the count rises); the paired recovery SPAN carries
            # the downtime interval.
            preemptions += 1
            continue
        if end > start:
            intervals.append((start, end, category))
    intervals.extend(_split_step_windows(step_windows))

    seconds = _sweep(intervals, wall_start, wall_end)
    productive = seconds.pop(PRODUCTIVE)
    overlapped = {c: seconds.pop(c) for c in OVERLAPPED_CATEGORIES}
    badput = {c: seconds[c] for c in BADPUT_CATEGORIES}

    sched = sum(badput[c] for c in _SCHEDULING_BADPUT)
    resource = sum(badput[c] for c in _RESOURCE_BADPUT)
    avail_time = max(0.0, wall_seconds - sched)
    run_time = max(0.0, avail_time - resource)
    # The program leg is productive over run time (run time includes
    # both program badput AND any uncovered overlapped persist), so
    # the three legs still multiply out to the headline ratio exactly
    # — the sweep partitions wall into productive + badput +
    # overlapped.
    availability = avail_time / wall_seconds if wall_seconds else 0.0
    resource_g = run_time / avail_time if avail_time else 0.0
    program_g = productive / run_time if run_time else 0.0
    return {
        "wall_seconds": wall_seconds,
        "productive_seconds": productive,
        "goodput_ratio": (productive / wall_seconds
                          if wall_seconds else 0.0),
        "availability_goodput": availability,
        "resource_goodput": resource_g,
        "program_goodput": program_g,
        "badput_seconds": badput,
        "overlapped_seconds": overlapped,
        "compile_saved_seconds": compile_saved,
        "compile_cache_hits": compile_hits,
        "compile_cache_misses": compile_misses,
        "steps": steps,
        "tokens": tokens,
        "retries": retries,
        "preemptions": preemptions,
        "events": len(event_list),
        "window": [wall_start, wall_end],
    }


def _empty_report() -> dict[str, Any]:
    return {
        "wall_seconds": 0.0, "productive_seconds": 0.0,
        "goodput_ratio": 0.0, "availability_goodput": 0.0,
        "resource_goodput": 0.0, "program_goodput": 0.0,
        "badput_seconds": {c: 0.0 for c in BADPUT_CATEGORIES},
        "overlapped_seconds": {c: 0.0 for c in OVERLAPPED_CATEGORIES},
        "compile_saved_seconds": 0.0,
        "compile_cache_hits": 0, "compile_cache_misses": 0,
        "steps": 0, "tokens": 0, "retries": 0, "preemptions": 0,
        "events": 0, "window": None,
    }


def decompose_by_node(event_list: list[dict],
                      left_cutoff: Optional[float] = None
                      ) -> dict[str, Any]:
    """Pool-scope decomposition: events grouped per node and each
    group swept on its OWN timeline, then summed — so wall/badput are
    NODE-seconds and seven idle nodes can never hide behind one busy
    node's productive window (which a single shared timeline's
    priority sweep would let happen). Events without a node (queueing
    spans, pool resize, ingested program phases that predate node
    tagging) form their own group. ``left_cutoff`` clips each group's
    wall at the trailing-window boundary."""
    # Cross-node replay must be priced BEFORE per-node grouping —
    # see _replay_recovery_spans.
    event_list = list(event_list) + _replay_recovery_spans(event_list)
    groups: dict = {}
    for event in event_list:
        groups.setdefault(event.get("node_id"), []).append(event)
    total = _empty_report()
    total["badput_seconds"] = {c: 0.0 for c in BADPUT_CATEGORIES}
    total["overlapped_seconds"] = {c: 0.0
                                   for c in OVERLAPPED_CATEGORIES}
    for group in groups.values():
        starts = [float(e.get("start", 0.0)) for e in group]
        ends = [float(e.get("end", e.get("start", 0.0)))
                for e in group]
        left = min(starts)
        if left_cutoff is not None:
            left = max(left, left_cutoff)
        sub = decompose(group, wall=(left, max(max(ends), left)))
        total["wall_seconds"] += sub["wall_seconds"]
        total["productive_seconds"] += sub["productive_seconds"]
        for category, value in sub["badput_seconds"].items():
            total["badput_seconds"][category] += value
        for category, value in sub["overlapped_seconds"].items():
            total["overlapped_seconds"][category] += value
        for key in ("steps", "tokens", "retries", "preemptions",
                    "events", "compile_saved_seconds",
                    "compile_cache_hits", "compile_cache_misses"):
            total[key] += sub[key]
    wall = total["wall_seconds"]
    sched = sum(total["badput_seconds"][c]
                for c in _SCHEDULING_BADPUT)
    resource = sum(total["badput_seconds"][c]
                   for c in _RESOURCE_BADPUT)
    avail = max(0.0, wall - sched)
    run = max(0.0, avail - resource)
    total["goodput_ratio"] = (total["productive_seconds"] / wall
                              if wall else 0.0)
    total["availability_goodput"] = avail / wall if wall else 0.0
    total["resource_goodput"] = run / avail if avail else 0.0
    total["program_goodput"] = (total["productive_seconds"] / run
                                if run else 0.0)
    total["nodes"] = len(groups)
    return total


# ------------------------------- rollups -------------------------------

def job_report(store: StateStore, pool_id: str, job_id: str,
               trace_id: Optional[str] = None) -> dict[str, Any]:
    """One job's decomposition (job-scoped events only: queue, task
    lifecycle, program phases). ``trace_id`` scopes the waterfall to
    one submission's trace (events carrying that trace id — legacy
    rows without ids never match)."""
    report = decompose(ev.query(store, pool_id, job_id=job_id,
                                trace_id=trace_id))
    report["job_id"] = job_id
    report["pool_id"] = pool_id
    if trace_id is not None:
        report["trace_id"] = trace_id
    return report


def pool_report(store: StateStore, pool_id: str,
                window_seconds: Optional[float] = None,
                include_jobs: bool = True,
                event_list: Optional[list[dict]] = None
                ) -> dict[str, Any]:
    """Pool rollup: ALL events of the pool (node lifecycle included)
    folded into one timeline, plus per-job subreports.

    ``window_seconds`` restricts accounting to the trailing window —
    the append-only log grows with fleet age, and periodic consumers
    (the heimdall gauge export) must not re-sweep history forever.
    ``include_jobs=False`` skips the per-job subreports for callers
    that only read the pool-level numbers (heimdall, fleet).
    ``event_list`` lets a caller that already fetched the pool's
    events (heimdall fetches once per poll for several exports)
    skip the partition re-scan.

    Pool scope aggregates PER NODE (wall/badput are node-seconds, via
    decompose_by_node); job subreports are single-timeline (the job's
    own wall clock)."""
    if event_list is None:
        event_list = ev.query(store, pool_id)
    cutoff = None
    if window_seconds is not None and event_list:
        import time as time_mod
        cutoff = time_mod.time() - window_seconds
        event_list = [e for e in event_list
                      if float(e.get("end", e.get("start", 0.0)))
                      >= cutoff]
    if event_list:
        report = decompose_by_node(event_list, left_cutoff=cutoff)
    else:
        report = _empty_report()
    report["pool_id"] = pool_id
    if include_jobs:
        job_ids = sorted({e.get("job_id") for e in event_list
                          if e.get("job_id")})
        report["jobs"] = {
            job_id: decompose([e for e in event_list
                               if e.get("job_id") == job_id])
            for job_id in job_ids}
    return report


def fleet_report(store: StateStore,
                 window_seconds: Optional[float] = None
                 ) -> dict[str, Any]:
    """Fleet rollup over every registered pool: per-pool reports plus
    a wall-clock-weighted aggregate ratio."""
    pools = {}
    total_wall = 0.0
    total_productive = 0.0
    badput = {c: 0.0 for c in BADPUT_CATEGORIES}
    overlapped = {c: 0.0 for c in OVERLAPPED_CATEGORIES}
    compile_saved = 0.0
    compile_hits = 0
    compile_misses = 0
    for row in store.query_entities(names.TABLE_POOLS,
                                    partition_key="pools"):
        pool_id = row["_rk"]
        report = pool_report(store, pool_id,
                             window_seconds=window_seconds,
                             include_jobs=False)
        pools[pool_id] = report
        total_wall += report["wall_seconds"]
        total_productive += report["productive_seconds"]
        for category, value in report["badput_seconds"].items():
            badput[category] += value
        for category, value in report.get(
                "overlapped_seconds", {}).items():
            overlapped[category] += value
        compile_saved += report.get("compile_saved_seconds", 0.0)
        compile_hits += report.get("compile_cache_hits", 0)
        compile_misses += report.get("compile_cache_misses", 0)
    sched = sum(badput[c] for c in _SCHEDULING_BADPUT)
    resource = sum(badput[c] for c in _RESOURCE_BADPUT)
    avail = max(0.0, total_wall - sched)
    run = max(0.0, avail - resource)
    return {
        "pools": pools,
        "wall_seconds": total_wall,
        "productive_seconds": total_productive,
        "goodput_ratio": (total_productive / total_wall
                          if total_wall else 0.0),
        "availability_goodput": (avail / total_wall
                                 if total_wall else 0.0),
        "resource_goodput": run / avail if avail else 0.0,
        "program_goodput": (total_productive / run
                            if run else 0.0),
        "badput_seconds": badput,
        "overlapped_seconds": overlapped,
        "compile_saved_seconds": compile_saved,
        "compile_cache_hits": compile_hits,
        "compile_cache_misses": compile_misses,
    }


def report_delta(baseline: dict[str, Any],
                 candidate: dict[str, Any]) -> dict[str, Any]:
    """Category-exact comparison of two decompositions (sim policy
    runs, before/after drill snapshots): per-category badput deltas,
    the three goodput legs, and the headline ratio — candidate minus
    baseline, so negative badput deltas are seconds the candidate
    bought back. Pure over report dicts; the fleet-sim bench and
    ``shipyard sim compare`` both render from this."""
    def _f(report: dict, key: str) -> float:
        return float(report.get(key, 0.0) or 0.0)

    badput = {}
    for category in BADPUT_CATEGORIES:
        base = float((baseline.get("badput_seconds") or {})
                     .get(category, 0.0) or 0.0)
        cand = float((candidate.get("badput_seconds") or {})
                     .get(category, 0.0) or 0.0)
        badput[category] = cand - base
    return {
        "goodput_ratio_delta": (_f(candidate, "goodput_ratio")
                                - _f(baseline, "goodput_ratio")),
        "availability_goodput_delta": (
            _f(candidate, "availability_goodput")
            - _f(baseline, "availability_goodput")),
        "resource_goodput_delta": (
            _f(candidate, "resource_goodput")
            - _f(baseline, "resource_goodput")),
        "program_goodput_delta": (
            _f(candidate, "program_goodput")
            - _f(baseline, "program_goodput")),
        "productive_seconds_delta": (
            _f(candidate, "productive_seconds")
            - _f(baseline, "productive_seconds")),
        "wall_seconds_delta": (_f(candidate, "wall_seconds")
                               - _f(baseline, "wall_seconds")),
        "badput_seconds_delta": badput,
    }


# ------------------------------ rendering ------------------------------

def waterfall_table(report: dict[str, Any]) -> str:
    """Badput waterfall: productive first, then every category,
    summing to wall clock. Overlapped categories (the async
    checkpoint persist) render as their own ``~``-marked rows: shown,
    but not badput — the covered portion is already inside
    productive, and only the uncovered tail carries seconds here."""
    wall = report.get("wall_seconds") or 0.0

    def pct(value: float) -> str:
        return f"{100.0 * value / wall:5.1f}%" if wall else "    -"

    lines = [f"{'category':<22}{'seconds':>12}  {'share':>6}",
             "-" * 42]
    lines.append(f"{PRODUCTIVE:<22}"
                 f"{report.get('productive_seconds', 0.0):>12.2f}  "
                 f"{pct(report.get('productive_seconds', 0.0))}")
    for category in BADPUT_CATEGORIES:
        value = report.get("badput_seconds", {}).get(category, 0.0)
        lines.append(f"{category:<22}{value:>12.2f}  {pct(value)}")
    # Rows render only when overlapped time exists — a sync-only
    # job's waterfall is unchanged.
    shown = [(category, report.get("overlapped_seconds", {}).get(
        category, 0.0)) for category in OVERLAPPED_CATEGORIES]
    shown = [(c, v) for c, v in shown if v > 0.0]
    for category, value in shown:
        lines.append(f"{'~' + category:<22}{value:>12.2f}  "
                     f"{pct(value)}")
    if shown:
        lines.append("(~ overlapped persist: not badput; covered "
                     "portions already count as productive)")
    # Warm vs cold compile: charged compile badput is what was PAID;
    # compile_saved_seconds is what the warm persistent cache avoided
    # paying (not an interval — the partition above is untouched).
    saved = report.get("compile_saved_seconds", 0.0)
    if saved > 0.0:
        hits = report.get("compile_cache_hits", 0)
        misses = report.get("compile_cache_misses", 0)
        lines.append(f"{'~compile_saved':<22}{saved:>12.2f}  "
                     f"(warm cache: {hits} hit / {misses} cold)")
        lines.append("(~ compile_saved: wall time AVOIDED by the "
                     "warm compile cache, not badput)")
    lines.append("-" * 42)
    lines.append(f"{'wall':<22}{wall:>12.2f}  {pct(wall)}")
    lines.append(
        f"goodput_ratio = {report.get('goodput_ratio', 0.0):.3f} "
        f"(availability {report.get('availability_goodput', 0.0):.3f}"
        f" x resource {report.get('resource_goodput', 0.0):.3f}"
        f" x program {report.get('program_goodput', 0.0):.3f})")
    if report.get("steps"):
        lines.append(f"steps = {report['steps']}  "
                     f"tokens = {report.get('tokens', 0)}  "
                     f"retries = {report.get('retries', 0)}")
    return "\n".join(lines)


def prometheus_lines(report: dict[str, Any],
                     labels: dict[str, str]) -> list[str]:
    """Gauge export for the heimdall-scraped dashboards:
    goodput_ratio{...} and badput_seconds{...,category=...}."""
    label_str = ",".join(f'{k}="{v}"'
                         for k, v in sorted(labels.items()))
    lines = [
        f"goodput_ratio{{{label_str}}} "
        f"{report.get('goodput_ratio', 0.0):.6f}",
        f"goodput_productive_seconds{{{label_str}}} "
        f"{report.get('productive_seconds', 0.0):.3f}",
    ]
    sep = "," if label_str else ""
    for category in BADPUT_CATEGORIES:
        value = report.get("badput_seconds", {}).get(category, 0.0)
        lines.append(
            f"badput_seconds{{{label_str}{sep}"
            f'category="{category}"}} {value:.3f}')
    for category in OVERLAPPED_CATEGORIES:
        value = report.get("overlapped_seconds", {}).get(category,
                                                         0.0)
        lines.append(
            f"goodput_overlapped_seconds{{{label_str}{sep}"
            f'category="{category}"}} {value:.3f}')
    lines.append(
        f"goodput_compile_saved_seconds{{{label_str}}} "
        f"{report.get('compile_saved_seconds', 0.0):.3f}")
    return lines
