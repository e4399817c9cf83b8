"""Task progress beats and scheduling hints.

Counterpart of batch_shipyard_tpu/agent/progress.py: the half a task
runs, and ``last_beat``, which the agent's watchdog reads. The agent
exports ``$SHIPYARD_PROGRESS_FILE`` into every task; the
training step (parallel/train.TrainHarness.step) bumps its mtime on
every step, and the agent's wedge watchdog kills a task whose file goes
stale past its ``progress_deadline_seconds``, so a process that is alive
but stuck (a collective waiting on a dead peer) becomes a bounded retry.
Beats are throttled to min(BEAT_INTERVAL, deadline / 4). Scheduling
hints (``$SHIPYARD_SCHED_HINTS_FILE``) tell the preemption sweep what
stopping the task would cost: the checkpointer publishes ``ckpt_step``
after every save. With no file configured both are no-ops, and neither
ever raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

PROGRESS_FILE_ENV = "SHIPYARD_PROGRESS_FILE"
# The task's watchdog deadline, exported beside the file so the
# throttle can scale itself under it.
PROGRESS_DEADLINE_ENV = "SHIPYARD_PROGRESS_DEADLINE"
# The longest gap between two mtime writes of beat().
BEAT_INTERVAL = 1.0

_last_beat_at = 0.0


def _throttle_seconds() -> float:
    """A quarter of the exported deadline, at most BEAT_INTERVAL."""
    raw = os.environ.get(PROGRESS_DEADLINE_ENV)
    if raw:
        try:
            return min(BEAT_INTERVAL, max(0.01, float(raw) / 4.0))
        except ValueError:
            pass
    return BEAT_INTERVAL


def progress_path() -> Optional[str]:
    """The liveness file for THIS process, or None (beats disabled)."""
    return os.environ.get(PROGRESS_FILE_ENV) or None


def beat() -> None:
    """Record one unit of progress: bump the liveness file's mtime (or
    create it). No-op when unset; never raises."""
    global _last_beat_at
    path = progress_path()
    if path is None:
        return
    now = time.monotonic()
    if now - _last_beat_at < _throttle_seconds():
        return
    _last_beat_at = now
    try:
        os.utime(path, None)
    except OSError:
        seed(path)


def seed(path: str) -> None:
    """Write the initial beat (process spawn)."""
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8"):
            pass
    except OSError:
        pass


def last_beat(path: str) -> Optional[float]:
    """Wall-clock time of the task's most recent beat (the file's
    mtime), or None when the file does not exist. The agent's watchdog
    reads it."""
    try:
        return os.stat(path).st_mtime
    except OSError:
        return None


SCHED_HINTS_FILE_ENV = "SHIPYARD_SCHED_HINTS_FILE"


def sched_hints_path() -> Optional[str]:
    """The hints file for THIS process, or None (hints disabled)."""
    return os.environ.get(SCHED_HINTS_FILE_ENV) or None


def record_sched_hints(step: Optional[int] = None,
                       ckpt_step: Optional[int] = None,
                       step_seconds: Optional[float] = None,
                       cache_identity: Optional[str] = None) -> None:
    """Merge the given fields into the hints file (a JSON object; tmp +
    rename, so the agent never reads a torn write). Fields left None are
    left out."""
    path = sched_hints_path()
    if path is None:
        return
    hints: dict = {}
    if step is not None:
        hints["step"] = int(step)
    if ckpt_step is not None:
        hints["ckpt_step"] = int(ckpt_step)
    if step_seconds is not None:
        hints["step_seconds"] = float(step_seconds)
    if cache_identity:
        hints["cache_identity"] = str(cache_identity)
    if not hints:
        return
    try:
        prior = read_sched_hints(path) or {}
        prior.update(hints)
        tmp = f"{path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(prior, fh, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def read_sched_hints(path: str) -> Optional[dict]:
    """The hints dict at ``path``, or None (absent or not a JSON
    object)."""
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
        return data if isinstance(data, dict) else None
    except (OSError, ValueError):
        return None
