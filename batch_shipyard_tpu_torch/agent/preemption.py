"""Cooperative preemption: the process-side contract.

Counterpart of batch_shipyard_tpu/agent/preemption.py: the half a task
runs, and the helpers a drill waits with (``preempt_requested``,
``wait_for_request``). The pool's agent asks a task to stop by dropping a JSON request
file at ``$SHIPYARD_PREEMPT_REQUEST_FILE``; the training loop polls it
once per step (one ``os.path.exists`` while nothing is pending, through
``PreemptWatcher``, usually via
``workloads.checkpoint.TrainCheckpointer.maybe_preempt``), drains to the
step boundary, forces a COMMITTED checkpoint and exits
``EXIT_PREEMPTED``. The agent requeues such a task at its full retry
budget: preemption is a scheduling decision, never a task failure.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from typing import Optional

logger = logging.getLogger(__name__)

# Where a preempt request lands; with no path set the watcher is a
# no-op, so workloads run unchanged outside pools.
PREEMPT_REQUEST_FILE_ENV = "SHIPYARD_PREEMPT_REQUEST_FILE"

# The preempted exit status (EX_TEMPFAIL): "drained cooperatively,
# requeue at full budget".
EXIT_PREEMPTED = 75


def utcnow_iso() -> str:
    """The framework's UTC timestamp format."""
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%S.%fZ")


def request_path() -> Optional[str]:
    """The preempt-request file for THIS process, or None."""
    return os.environ.get(PREEMPT_REQUEST_FILE_ENV) or None


def write_request(path: str, reason: str = "",
                  requested_at: Optional[str] = None, **extra) -> None:
    """Drop one preempt request file atomically (tmp + rename), so a
    watcher never reads a torn JSON."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"requested_at": requested_at or utcnow_iso(),
               "reason": reason, **extra}
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(payload))
    os.replace(tmp, path)


def read_request(path: str) -> Optional[dict]:
    """Parse a request file; None when absent or (transiently) torn."""
    try:
        with open(path, encoding="utf-8") as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return None
    return payload if isinstance(payload, dict) else {}


class PreemptWatcher:
    """Per-step preempt poll. ``poll()`` costs one os.path.exists while
    nothing is pending; the first call that sees the request parses it,
    LATCHES and returns it, and later calls return None, so a loop that
    keeps polling mid-drain cannot drain twice. The file is left in
    place for inspection."""

    def __init__(self, path: Optional[str] = None) -> None:
        self._path = path if path is not None else request_path()
        self._consumed = False

    @property
    def configured(self) -> bool:
        """True when a request path is set, consumed or not."""
        return self._path is not None

    @property
    def armed(self) -> bool:
        return self._path is not None and not self._consumed

    def poll(self) -> Optional[dict]:
        """The pending preempt request, exactly once, else None."""
        if self._path is None or self._consumed:
            return None
        if not os.path.exists(self._path):
            return None
        request = read_request(self._path)
        if request is None:
            return None  # a torn foreign write: retry next poll
        self._consumed = True
        logger.warning("preempt request received (%s); draining to the "
                       "next step boundary",
                       request.get("reason") or "no reason given")
        return request


def preempt_requested() -> bool:
    """One-shot check for simple loops (no latch)."""
    path = request_path()
    return bool(path and os.path.exists(path))


def wait_for_request(path: str, timeout: float,
                     poll_interval: float = 0.05) -> Optional[dict]:
    """Block until a request file appears at ``path`` (or ``timeout``
    seconds pass: None); returns it parsed."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if os.path.exists(path):
            return read_request(path)
        time.sleep(poll_interval)
    return None
