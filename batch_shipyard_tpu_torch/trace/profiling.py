"""On-demand step profiling: ``shipyard jobs profile <job> --steps N``.

Counterpart of batch_shipyard_tpu/trace/profiling.py, with
``torch.profiler`` in place of ``jax.profiler``. The pool's agent
exports ``$SHIPYARD_PROFILE_REQUEST_FILE`` and ``$SHIPYARD_PROFILE_DIR``
into a task and drops a request file (``{"steps": N, ...}``) there when
a user asks; the training loop calls ``StepProfiler.tick(step)`` before
every step. When the request appears it is consumed (removed), then the
next N steps run under ``torch.profiler.profile`` (CPU activity, plus
CUDA on the card), whose Chrome trace lands in the profile dir as
``trace_steps_<start>_<end>.json``. The capture ends in one ``profile``
span (trace/spans.py) over the half-open step range [start, end).
``tick`` costs one stat while nothing is pending; a profiler that fails
to start disarms itself instead of failing the step loop.

trace/train_profile.py (chip_smoke.py's breakdown of a step) is a
separate, always-on reading.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

from batch_shipyard_tpu_torch.agent.preemption import utcnow_iso
from batch_shipyard_tpu_torch.trace import spans as trace_spans

logger = logging.getLogger(__name__)

PROFILE_REQUEST_FILE_ENV = "SHIPYARD_PROFILE_REQUEST_FILE"
PROFILE_DIR_ENV = "SHIPYARD_PROFILE_DIR"

# Job-row column the request is stamped on, which the pool's agent
# polls; task-row column the agent stamps after uploading the capture.
COL_PROFILE_REQUEST = "profile_request"
COL_PROFILE_ARTIFACT = "profile_artifact"


def read_request(path: Optional[str]) -> Optional[dict]:
    """Parse a request file; None when absent or not a JSON object."""
    if not path or not os.path.exists(path):
        return None
    try:
        with open(path, encoding="utf-8") as fh:
            request = json.load(fh)
    except (OSError, ValueError):
        return None
    return request if isinstance(request, dict) else None


def write_request(path: str, steps: int,
                  requested_at: Optional[str] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump({"steps": int(steps),
                   "requested_at": requested_at or utcnow_iso()}, fh)
    os.replace(tmp, path)


def _activities() -> list:
    import torch  # the pool's agent imports this module without torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return activities


class StepProfiler:
    """The profiler a train loop ticks every step; ``close()``
    ends a capture that the loop's exit cut short."""

    def __init__(self, request_path: Optional[str] = None,
                 profile_dir: Optional[str] = None) -> None:
        self.request_path = (request_path if request_path is not None
                             else os.environ.get(PROFILE_REQUEST_FILE_ENV))
        self.profile_dir = (profile_dir if profile_dir is not None
                            else os.environ.get(PROFILE_DIR_ENV))
        self._profiler = None
        self._remaining = 0
        self._requested = 0
        self._started_at = 0.0
        self._start_step: Optional[int] = None
        self._broken = False  # a start failed; stay disarmed
        self.trace_path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self._profiler is not None

    def tick(self, step: int) -> None:
        """Call before running ``step``: arms on a pending request,
        counts captured steps, stops after N."""
        if self.active:
            self._remaining -= 1
            if self._remaining <= 0:
                self._stop(step)
            return
        if self._broken or not self.request_path or not self.profile_dir:
            return
        request = read_request(self.request_path)
        if request is None:
            return
        try:
            steps = max(1, int(request.get("steps", 1)))
        except (TypeError, ValueError):
            steps = 1
        # Consumed before the start: one request, one capture, even if
        # the start fails.
        try:
            os.remove(self.request_path)
        except OSError:
            pass
        self._start(step, steps)

    def _start(self, step: int, steps: int) -> None:
        try:
            os.makedirs(self.profile_dir, exist_ok=True)
            import torch
            profiler = torch.profiler.profile(activities=_activities())
            profiler.start()
        except Exception:  # noqa: BLE001 - never fail the step loop
            logger.exception("torch.profiler start failed; profiling "
                             "disarmed for this process")
            self._broken = True
            return
        self._profiler = profiler
        self._remaining = self._requested = steps
        self._started_at = time.time()
        self._start_step = step
        logger.info("profiling %d step(s) from step %d into %s", steps,
                    step, self.profile_dir)

    def _stop(self, end_step: int) -> None:
        """Ends the capture of [start_step, end_step): tick(N) stops it
        before step N runs."""
        profiler, self._profiler = self._profiler, None
        path = os.path.join(self.profile_dir,
                            f"trace_steps_{self._start_step}_{end_step}.json")
        try:
            import torch
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            profiler.stop()
            profiler.export_chrome_trace(path)
            self.trace_path = path
        except Exception:  # noqa: BLE001
            logger.exception("torch.profiler stop failed")
            path = None
        trace_spans.record(
            trace_spans.SPAN_PROFILE, self._started_at, time.time(),
            step_start=self._start_step, step_end=end_step,
            profile_dir=self.profile_dir, trace_file=path)
        logger.info("profile capture complete (steps [%s, %s))",
                    self._start_step, end_step)

    def close(self) -> None:
        """Stop a capture cut short by loop exit: the exclusive bound is
        start + the steps that actually ran (the arming tick precedes its
        step, so one more step ran than the counter saw)."""
        if self.active:
            captured = min(self._requested,
                           self._requested - self._remaining + 1)
            self._remaining = 0
            self._stop((self._start_step or 0) + captured)
