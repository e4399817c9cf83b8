"""Where a training step's time goes, on the card.

``profile_steps(harness, batch, steps)`` times ``steps`` train steps on
the host clock with a synchronise, then ``steps`` more under
``torch.profiler``, and returns the step's wall time, the device's busy
time (union of kernel intervals) and idle share, the flash kernels'
(K1, K2) time and share of device time, and the largest device
kernels. chip_smoke.py runs it on bench.py ``bench_transformer``'s
model after its counted training steps. CUDA only.
"""

from __future__ import annotations

import collections
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from batch_shipyard_tpu_torch.trace.decode_profile import busy_us

# Substrings of the flash kernels' mangled names (csrc/flash_attention.cu).
FLASH_FWD = "flash_fwd_kernel"
FLASH_BWD = ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


def profile_steps(harness, batch: dict, steps: int) -> dict:
    """Wall ms per step over ``steps`` synchronised steps, then the
    device's view of ``steps`` more steps under torch.profiler."""
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(steps):
        harness.step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - started) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            harness.step(batch)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name: dict[str, float] = collections.defaultdict(float)
    intervals = []
    for e in kernels:
        intervals.append((e.time_range.start, e.time_range.end))
        by_name[e.name] += e.time_range.end - e.time_range.start
    device_us = sum(by_name.values())
    busy = busy_us(intervals)
    window_us = max(s for _, s in intervals) - min(s for s, _ in intervals)
    fwd_us = sum(us for name, us in by_name.items() if FLASH_FWD in name)
    bwd_us = sum(us for name, us in by_name.items()
                 if any(k in name for k in FLASH_BWD))
    return {
        "steps": steps,
        "wall_ms_per_step": wall_ms,
        "profiled_window_ms_per_step": window_us / 1e3 / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "device_idle_share": 1.0 - busy / window_us,
        "kernel_launches_per_step": len(kernels) / steps,
        "flash_fwd_ms_per_step": fwd_us / 1e3 / steps,
        "flash_bwd_ms_per_step": bwd_us / 1e3 / steps,
        "flash_share_of_device": (fwd_us + bwd_us) / device_us,
        "top_kernels_ms_per_step": {
            name[:80]: us / 1e3 / steps
            for name, us in sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:10]},
    }

