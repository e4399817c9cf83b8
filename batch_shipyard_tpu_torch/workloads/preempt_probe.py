"""Preempt-probe: a featherweight preempt-aware "trainer" for drills.

The preemption drill's acceptance criterion is about the CONTROL
plane — notice delivered, drain to a step boundary, COMMITTED
checkpoint forced, distinct preempted exit, resume with zero lost
steps — not about matmuls. A real train workload would spend seconds
importing torch per gang instance per attempt; this probe speaks the
exact same contracts with stdlib-only imports (it loads no torch):

  * progress beats ($SHIPYARD_PROGRESS_FILE, agent/progress.py)
  * goodput step windows ($SHIPYARD_GOODPUT_FILE, goodput/events.py)
  * preempt requests ($SHIPYARD_PREEMPT_REQUEST_FILE,
    agent/preemption.PreemptWatcher)
  * the COMMITTED-marker checkpoint protocol (a JSON state file +
    sibling marker, atomic tmp+rename — workloads/checkpoint.py's
    commit discipline without the tensor payload)

Step ledger: every attempt appends the step numbers it actually
executed to ``<ckpt>.steps.log`` — the drill's zero-lost-steps
assertion reads it (each step executed exactly once across attempts
when the drain committed the barrier).

The port's copy of batch_shipyard_tpu/workloads/preempt_probe.py over
the port's agent/preemption, agent/progress and goodput/events: run
with the same arguments and ``SHIPYARD_*`` environment, both write the
same ledger, state, marker and goodput event kinds.

Usage (drill/gang task command):
    python -m batch_shipyard_tpu_torch.workloads.preempt_probe \
        --steps 40 --step-seconds 0.05 --ckpt /path/state.json
"""

from __future__ import annotations

import argparse
import json
import os
import time

from batch_shipyard_tpu_torch.agent import preemption
from batch_shipyard_tpu_torch.agent import progress
from batch_shipyard_tpu_torch.goodput import events as goodput_events


def _restore(ckpt: str) -> int:
    """Committed step, honoring the marker protocol: state without a
    sibling .COMMITTED marker is a torn save and restores as 0."""
    if not (ckpt and os.path.exists(ckpt)
            and os.path.exists(ckpt + ".COMMITTED")):
        return 0
    try:
        with open(ckpt, encoding="utf-8") as fh:
            return int(json.load(fh).get("step", 0))
    except (OSError, ValueError):
        return 0


def _commit(ckpt: str, step: int) -> None:
    """state -> fsync'd tmp -> rename -> marker (the checkpoint.py
    commit order: a crash at any point leaves the previous committed
    state or an unmarked torn file, never a torn pickup)."""
    os.makedirs(os.path.dirname(ckpt) or ".", exist_ok=True)
    tmp = ckpt + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(json.dumps({"step": step}))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, ckpt)
    marker_tmp = ckpt + ".COMMITTED.tmp"
    with open(marker_tmp, "w", encoding="utf-8") as fh:
        fh.write(str(step))
    os.replace(marker_tmp, ckpt + ".COMMITTED")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--step-seconds", type=float, default=0.05)
    parser.add_argument("--ckpt", required=True,
                        help="shared state file (job scratch/shared "
                             "dir); instance 0 is the single writer")
    parser.add_argument("--checkpoint-every", type=int, default=0,
                        help="cadenced commits every N steps (the "
                             "preempt drain commits regardless)")
    parser.add_argument("--cache-identity",
                        default=os.environ.get(
                            "SHIPYARD_COMPILE_CACHE_IDENTITY"),
                        help="compile-cache identity advertised via "
                             "sched hints (victim-cost pricing reads "
                             "it from the task row)")
    parser.add_argument("--ignore-notice", action="store_true",
                        help="UNCOOPERATIVE victim mode (eviction "
                             "drills): observe the preempt request, "
                             "log it to the ledger, and keep "
                             "stepping — the sweep's post-grace "
                             "hard kill is the only way off the "
                             "node, exactly the workload shape "
                             "forcible eviction exists for")
    args = parser.parse_args()

    instance = int(os.environ.get("SHIPYARD_TASK_INSTANCE", "0"))
    writer = instance == 0
    start_step = _restore(args.ckpt)
    # Advertise scheduling hints up front: the agent mirrors the hints
    # file into the task row on heartbeats, and the preempt sweep's
    # victim-cost pricing (sched/policy.py victim_cost_from_row) reads
    # them — a victim with a committed checkpoint + warm cache identity
    # is cheap to kill, one without is expensive.
    progress.record_sched_hints(
        step=start_step, ckpt_step=start_step,
        step_seconds=args.step_seconds,
        cache_identity=args.cache_identity)
    watcher = preemption.PreemptWatcher()
    window_started = time.time()
    executed: list[int] = []

    def _flush_window(end_step: int) -> None:
        if executed:
            goodput_events.record(
                goodput_events.PROGRAM_STEP_WINDOW, window_started,
                time.time(), step_start=executed[0],
                step_end=end_step, tokens=len(executed))

    ignoring = False
    for step in range(start_step, args.steps):
        time.sleep(args.step_seconds)
        progress.beat()
        executed.append(step)
        done = step + 1
        progress.record_sched_hints(step=done)
        if watcher.poll() is not None:
            if args.ignore_notice:
                # The uncooperative shape eviction exists for: a
                # victim that neither drains NOR commits once
                # noticed (a healthy cadenced committer would have
                # drained cooperatively) — it squats on the slot,
                # still stepping/beating, until the escalation hard
                # kill. Acknowledge the notice in the ledger so the
                # drill can assert the resume barrier is strictly
                # PRE-notice, then stop committing.
                ignoring = True
                if writer:
                    with open(args.ckpt + ".steps.log", "a",
                              encoding="utf-8") as fh:
                        fh.write(f"i{instance} "
                                 f"{executed[0]}..{done} "
                                 f"notice-ignored\n")
                continue
            # Drain: this boundary is the barrier — commit, ledger,
            # distinct preempted exit. Non-writers exit on the same
            # boundary without touching the shared state (the
            # single-writer convention real save pipelines follow).
            if writer:
                _commit(args.ckpt, done)
                progress.record_sched_hints(ckpt_step=done)
                with open(args.ckpt + ".steps.log", "a",
                          encoding="utf-8") as fh:
                    fh.write(f"i{instance} {executed[0]}..{done} "
                             f"preempted\n")
            _flush_window(done)
            return preemption.EXIT_PREEMPTED
        if writer and not ignoring and args.checkpoint_every and \
                done % args.checkpoint_every == 0:
            _commit(args.ckpt, done)
            progress.record_sched_hints(ckpt_step=done)
    if writer:
        _commit(args.ckpt, args.steps)
        with open(args.ckpt + ".steps.log", "a",
                  encoding="utf-8") as fh:
            fh.write(f"i{instance} {start_step}..{args.steps} "
                     f"completed\n")
    _flush_window(args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
