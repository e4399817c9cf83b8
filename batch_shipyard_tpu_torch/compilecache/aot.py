"""AOT precompile: build before the data shows up.

The port's copy of batch_shipyard_tpu/compilecache/aot.py. A training
step launches its kernels at their first call, so without this the first
step pays every ``nvcc`` build (or, over a warm cache, every library
load) of its kernels on the critical path. With ``--aot-precompile`` the
workload starts ``precompile_async(harness)`` once the harness is built:
``harness.precompile()`` (parallel/train.py) builds and loads every
library the step launches on a thread, while the host sets up the batch
and the restore, and the workload joins it before the warm-up steps.

The reference's ``abstractify`` (arrays to ``ShapeDtypeStruct`` for
lowering without data) has no counterpart: torch has no abstract
lowering, and what the port compiles ahead of time is its kernel
libraries, which need no shapes.
"""

from __future__ import annotations

import logging
import threading
from typing import Callable, Optional

from batch_shipyard_tpu_torch.compilecache import manager

logger = logging.getLogger(__name__)


def precompile_async(harness, label: str = "train_step_aot"
                     ) -> Optional[Callable[[], None]]:
    """Start ``harness.precompile()`` on a thread inside a goodput
    ``compile`` phase (``what="aot_precompile"``), a ``compile`` span
    and ``manager.tracked(attrs, label)``; the returned join callable
    blocks until it finishes. A failure is logged, never raised: the
    step's own first launch then builds the library again, and raises
    there if ``nvcc`` fails. Returns None when the harness has no
    precompile."""
    precompile = getattr(harness, "precompile", None)
    if precompile is None:
        return None
    from batch_shipyard_tpu_torch.goodput import events as goodput_events
    from batch_shipyard_tpu_torch.trace import spans as trace_spans

    def _run() -> None:
        try:
            with goodput_events.phase(
                    goodput_events.PROGRAM_COMPILE,
                    what="aot_precompile") as attrs, \
                    manager.tracked(attrs, label), \
                    trace_spans.phase(trace_spans.SPAN_COMPILE,
                                      what="aot_precompile", label=label):
                precompile()
        except Exception:  # noqa: BLE001 - the step builds on its own
            logger.warning("AOT precompile failed; the first step builds "
                           "its kernels", exc_info=True)

    thread = threading.Thread(target=_run, daemon=True,
                              name="aot-precompile")
    thread.start()
    return thread.join
