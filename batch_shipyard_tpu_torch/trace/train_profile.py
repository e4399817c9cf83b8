"""Where a training step's time goes, on the card.

``profile_steps(harness, batch, steps)`` times ``steps`` train steps on
the host clock with a synchronise, then ``steps`` more under
``torch.profiler`` (after WARMUP_STEPS, which the reading leaves out),
and returns the step's wall time, the device's busy time (union of
kernel intervals) and idle share, each hand-written kernel's time and
share of device time (flash K1, K2; the fused cross-entropy K3, the
backward's shared pre-pass and dl pass, K4 and K5; the fused
RMSNorm+matmul K9; the int8 quantize K10 and matmul K11, and K10's two
halves that a row-parallel product runs under tp; on a sequence-parallel
ring the permute K12 and the gradient all-reduce K13 + K14), the library
GEMMs' time and share (cuBLAS's kernels: the int8 step's fp32 backward
products, the other steps' projections and slab-loss products), and the
largest device kernels. Over a mesh it also gives each axis's ring
kernels' ms a step (``ring_ms_per_step_by_axis``: the copy kernels of
the sp rotations, the tp all-reduces, the data all-reduce and the fsdp
scatter and gather, told apart by the order in which their calls
launched them on the one stream; the vocab-parallel loss's merge as
"tp:loss" and the int8 absmax gathers as "tp:absmax",
ring_collectives.call_site), each ring group's wait (the time its calls
spent waiting on a neighbour: their stream waits, from the group's event
pairs) and the device kernels each ring call makes (K12: two copies; K13
and K14: ring copies, K14's adding). chip_smoke.py runs it on bench.py
``bench_transformer``'s model after its counted training steps, and
``workloads/train_transformer.py --profile-steps`` on every rank. CUDA
only.
"""

from __future__ import annotations

import collections
import time

import torch
import torch.distributed as dist
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from batch_shipyard_tpu_torch.ops import ring_collectives
from batch_shipyard_tpu_torch.trace.decode_profile import (
    WINDOW, busy_us, window_kernels)

# Steps under the profiler before its window (decode_profile's
# PROFILER_WARMUP_STEPS): one train step lasts hundreds of ms, far past
# the start of the trace, where the profiler can lose kernels.
WARMUP_STEPS = 1
# Profiled windows taken before a reading with every ring kernel is given
# up on (ring_us_by_axis then raises).
PROFILE_ATTEMPTS = 3

# Substrings of the kernels' mangled names: csrc/flash_attention.cu,
# csrc/chunked_loss.cu, csrc/fused_norm.cu and csrc/quantization.cu.
# Flash: the bf16 wgmma kernels (training) and the fp32 FMA kernels.
FLASH_FWD = ("flash_fwd_wgmma_kernel", "flash_fwd_fma_kernel")
FLASH_BWD = ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
             "flash_bwd_dkdv_fma_kernel", "flash_bwd_dq_fma_kernel")
# K3 and K9 count their pre-passes (the TF32 rounding of h and E; the
# row statistics) with their main kernels. The backward's own pre-pass
# (h and E rounded and transposed) and its dl pass, which K4 and K5
# share, have a row of their own (xent_bwd_dl); K4's and K5's rows are
# their products alone.
XENT_FWD = ("xent_fwd_wgmma_kernel", "tf32_round_kernel")
XENT_BWD_PREPASS = "xent_bwd_round_kernel"
XENT_DL_PASS = "xent_dl_kernel"
XENT_BWD_H = "xent_bwd_h_kernel"
XENT_BWD_E = "xent_bwd_e_kernel"
RMSNORM_MATMUL = ("rmsnorm_matmul_wgmma_kernel", "rmsnorm_matmul_fma_kernel",
                  "rms_stats_kernel")
QUANTIZE_INT8 = "quantize_int8_kernel"
INT8_MATMUL = "int8_matmul_wgmma_kernel"
# K10's two halves for rows split over tp (the row-parallel products).
ROW_ABSMAX = "row_absmax_kernel"
QUANTIZE_SCALED = "quantize_scaled_kernel"
# csrc/ring_collectives.cu (the virtual_* kernels do not match these).
RING_PERMUTE = "ring_permute_kernel"
RING_ALL_GATHER = "ring_all_gather_kernel"
RING_REDUCE_SCATTER = "ring_reduce_scatter_kernel"
KERNEL_SYMBOLS = {
    "flash_fwd": FLASH_FWD, "flash_bwd": FLASH_BWD,
    "xent_fwd": XENT_FWD, "xent_bwd_dl": (XENT_BWD_PREPASS, XENT_DL_PASS),
    "xent_bwd_h": (XENT_BWD_H,), "xent_bwd_e": (XENT_BWD_E,),
    "rmsnorm_matmul": RMSNORM_MATMUL,
    "quantize_int8": (QUANTIZE_INT8,), "int8_matmul": (INT8_MATMUL,),
    "row_absmax": (ROW_ABSMAX,), "quantize_scaled": (QUANTIZE_SCALED,),
    "ring_permute": (RING_PERMUTE,), "ring_all_gather": (RING_ALL_GATHER,),
    "ring_reduce_scatter": (RING_REDUCE_SCATTER,),
}
RING_KERNELS = ("ring_permute", "ring_all_gather", "ring_reduce_scatter")
# cuBLAS's GEMM kernels: cutlass / xmma "...gemm..." and its JIT "nvjet_".
LIBRARY_GEMM = ("gemm", "nvjet")
# Host ops kept in op_ms_per_step, by device time.
TOP_OPS = 24
# Host events that are not ops but carry the device time of kernels their
# ops also carry (the CUDA runtime's wait on a full launch queue: on the
# card its "self" time exceeded the step's busy time).
RUNTIME_MARKERS = ("Command Buffer Full",)


def profile_steps(harness, batch: dict, steps: int) -> dict:
    """Wall ms per step over ``steps`` synchronised steps, then the
    device's view of ``steps`` more steps under torch.profiler."""
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(steps):
        harness.step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - started) * 1e3 / steps
    mesh = getattr(harness, "mesh", None)
    groups = [] if mesh is None else mesh.distinct_groups()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(WARMUP_STEPS):
                harness.step(batch)
            torch.cuda.synchronize()
            waited = [group.wait_ns() for group in groups]
            ring_collectives.copy_log = log = []
            try:
                with record_function(WINDOW):
                    for _ in range(steps):
                        harness.step(batch)
                    torch.cuda.synchronize()
            finally:
                ring_collectives.copy_log = None
        if mesh is not None:
            mesh.check()
            waited = [group.wait_ns() - ns
                      for group, ns in zip(groups, waited)]
        kernels = window_kernels(prof.events())
        if not kernels:
            raise RuntimeError("the profiler recorded no device activity")
        # A window can still come back a few kernels short (2 and 3 of
        # 80 ring kernels on two ranks of one run): such a reading is
        # retaken, by every rank together, since each must issue the
        # same ring calls.
        short = bool(groups) and len(_ring_events(kernels)) != len(log)
        if dist.is_available() and dist.is_initialized():
            flag = torch.tensor([int(short)])
            dist.all_reduce(flag, op=dist.ReduceOp.MAX)
            short = bool(flag.item())
        if not short:
            break
    ops = op_us(prof.events())
    by_name: dict[str, float] = collections.defaultdict(float)
    intervals = []
    for e in kernels:
        intervals.append((e.time_range.start, e.time_range.end))
        by_name[e.name] += e.time_range.end - e.time_range.start
    device_us = sum(by_name.values())
    busy = busy_us(intervals)
    window_us = max(s for _, s in intervals) - min(s for s, _ in intervals)
    per_kernel = {
        key: sum(us for name, us in by_name.items()
                 if any(symbol in name for symbol in symbols))
        for key, symbols in KERNEL_SYMBOLS.items()}
    gemm_us = sum(us for name, us in by_name.items()
                  if any(symbol in name.lower() for symbol in LIBRARY_GEMM))
    ring = {}
    if groups:
        ring_us = sum(per_kernel[key] for key in RING_KERNELS)
        calls = {key: sum(1 for e in kernels if any(
                     symbol in e.name for symbol in KERNEL_SYMBOLS[key]))
                 for key in RING_KERNELS}
        wait_by_group = {group.axis: ns / 1e6 / steps
                         for group, ns in zip(groups, waited)}
        ring = {
            "ring_kernel_calls_per_step": {key: n / steps
                                           for key, n in calls.items()},
            "ring_ms_per_step": ring_us / 1e3 / steps,
            "ring_share_of_device": ring_us / device_us,
            "ring_all_reduce_ms_per_step": (
                per_kernel["ring_all_gather"] +
                per_kernel["ring_reduce_scatter"]) / 1e3 / steps,
            "ring_ms_per_step_by_axis": {
                axis: us / 1e3 / steps
                for axis, us in ring_us_by_axis(kernels, log).items()},
            "ring_wait_ms_per_step": sum(wait_by_group.values()),
            "ring_wait_ms_per_step_by_group": wait_by_group,
        }
    return {
        **ring,
        "steps": steps,
        "wall_ms_per_step": wall_ms,
        "profiled_window_ms_per_step": window_us / 1e3 / steps,
        "device_busy_ms_per_step": busy / 1e3 / steps,
        "device_idle_share": 1.0 - busy / window_us,
        "kernel_launches_per_step": len(kernels) / steps,
        "kernel_ms_per_step": {key: us / 1e3 / steps
                               for key, us in per_kernel.items()},
        "kernel_share_of_device": {key: us / device_us
                                   for key, us in per_kernel.items()},
        "library_gemm_ms_per_step": gemm_us / 1e3 / steps,
        "library_gemm_share_of_device": gemm_us / device_us,
        "top_kernels_ms_per_step": {
            name[:80]: us / 1e3 / steps
            for name, us in sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:10]},
        "op_ms_per_step": {
            name: us / 1e3 / steps
            for name, us in sorted(ops.items(),
                                   key=lambda kv: -kv[1])[:TOP_OPS]},
    }


def op_us(events) -> dict:
    """Device µs of the host ops inside the WINDOW range by op name, each
    kernel under the innermost op that launched it (its self time); none
    without the range."""
    start = next((e.time_range.start for e in events
                  if e.name == WINDOW and e.device_type == DeviceType.CPU),
                 None)
    by_op: dict = collections.defaultdict(float)
    if start is None:
        return {}
    for e in events:
        if e.device_type == DeviceType.CPU and \
                e.name not in (WINDOW, *RUNTIME_MARKERS) and \
                e.time_range.start >= start and e.self_device_time_total:
            by_op[e.name] += e.self_device_time_total
    return dict(by_op)



def _ring_events(kernels) -> list:
    """The ring copy kernels among ``kernels``, by start time."""
    return sorted((e for e in kernels
                   if any(symbol in e.name for key in RING_KERNELS
                          for symbol in KERNEL_SYMBOLS[key])),
                  key=lambda e: e.time_range.start)


def ring_us_by_axis(kernels, log: list) -> dict:
    """Device µs of the ring copy kernels by the axis of the call that
    launched them: the ring kernels (one stream, so in launch order by
    start time) matched one to one with ``log``, the (kernel, axis) the
    wrappers appended as they launched them."""
    ring = _ring_events(kernels)
    if len(ring) != len(log):
        raise RuntimeError(f"the profiler saw {len(ring)} ring kernels, the "
                           f"wrappers launched {len(log)}")
    by_axis: dict = collections.defaultdict(float)
    for event, (kernel, axis) in zip(ring, log):
        if not any(symbol in event.name for symbol in KERNEL_SYMBOLS[kernel]):
            raise RuntimeError(f"ring kernel {event.name} ran where the "
                               f"wrappers launched {kernel}")
        by_axis[axis] += event.time_range.end - event.time_range.start
    return dict(by_axis)
