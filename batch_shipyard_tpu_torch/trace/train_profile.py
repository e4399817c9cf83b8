"""Where a training step's time goes, on the card.

``profile_steps(harness, batch, steps)`` times ``steps`` train steps on
the host clock with a synchronise, then ``steps`` more under
``torch.profiler``, and returns the step's wall time, the device's busy
time (union of kernel intervals) and idle share, each hand-written
kernel's time and share of device time (flash K1, K2; the fused
cross-entropy K3, the backward's shared pre-pass and dl pass, K4 and
K5; the fused RMSNorm+matmul K9; the int8 quantize K10 and matmul K11;
on a sequence-parallel ring the permute K12 and the gradient all-reduce
K13 + K14), the library GEMMs' time and share
(cuBLAS's kernels: the int8 step's fp32 backward products, the other
steps' projections and slab-loss products), and the largest device
kernels. On a ring it also gives ring wait (the time this rank's ring
calls spent waiting on a neighbour: their stream waits, from the group's
event pairs) and the device kernels each ring call makes (K12: two
copies; K13 and K14: ring copies, K14's adding). chip_smoke.py runs
it on bench.py ``bench_transformer``'s model after its counted training
steps, and ``workloads/train_transformer.py --profile-steps`` on every
rank. CUDA only.
"""

from __future__ import annotations

import collections
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from batch_shipyard_tpu_torch.trace.decode_profile import busy_us

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
    "ring_permute": (RING_PERMUTE,), "ring_all_gather": (RING_ALL_GATHER,),
    "ring_reduce_scatter": (RING_REDUCE_SCATTER,),
}
RING_KERNELS = ("ring_permute", "ring_all_gather", "ring_reduce_scatter")
# cuBLAS's GEMM kernels: cutlass / xmma "...gemm..." and its JIT "nvjet_".
LIBRARY_GEMM = ("gemm", "nvjet")


def profile_steps(harness, batch: dict, steps: int) -> dict:
    """Wall ms per step over ``steps`` synchronised steps, then the
    device's view of ``steps`` more steps under torch.profiler."""
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(steps):
        harness.step(batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - started) * 1e3 / steps
    group = getattr(harness, "group", None)
    if group is not None:
        wait_ns = group.wait_ns()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            harness.step(batch)
        torch.cuda.synchronize()
    if group is not None:
        group.check()
        wait_ns = group.wait_ns() - wait_ns
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
    per_kernel = {
        key: sum(us for name, us in by_name.items()
                 if any(symbol in name for symbol in symbols))
        for key, symbols in KERNEL_SYMBOLS.items()}
    gemm_us = sum(us for name, us in by_name.items()
                  if any(symbol in name.lower() for symbol in LIBRARY_GEMM))
    ring = {}
    if group is not None:
        ring_us = sum(per_kernel[key] for key in RING_KERNELS)
        calls = {key: sum(1 for e in kernels if any(
                     symbol in e.name for symbol in KERNEL_SYMBOLS[key]))
                 for key in RING_KERNELS}
        ring = {
            "ring_kernel_calls_per_step": {key: n / steps
                                           for key, n in calls.items()},
            "ring_ms_per_step": ring_us / 1e3 / steps,
            "ring_share_of_device": ring_us / device_us,
            "ring_all_reduce_ms_per_step": (
                per_kernel["ring_all_gather"] +
                per_kernel["ring_reduce_scatter"]) / 1e3 / steps,
            "ring_wait_ms_per_step": wait_ns / 1e6 / steps,
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
    }

