"""Where a served decode step's time goes, on the card.

    python -m batch_shipyard_tpu_torch.trace.decode_profile \
        [--kv-cache paged|paged_int8|dense_int8] [--steps 16]
    python -m batch_shipyard_tpu_torch.trace.decode_profile --speculative \
        [--kv-cache dense|paged|paged_int8] [--steps 16]

Builds the serving benchmark engine (``workloads.serve.
build_bench_engine``: bench.py ``bench_serving``'s vocab 32000, d_model
1024, 12 layers, 16 heads, d_ff 2816, bf16, 8 slots, max_decode_len
512, random weights from a fixed seed), fills every slot with a
96-token prompt, and then times ``--steps`` pure decode steps (no
admission, no finished request) twice: on the host clock with a
synchronise, and under ``torch.profiler`` (after PROFILER_WARMUP_STEPS
steps that the profiler runs but the reading leaves out). The steps are
replays of the decode graph the engine's warm-up captured (``graph`` in
the output);
the profiler still sees each kernel of a replay, so the kernels a step
launches are counted from the trace (``launches_per_step_by_kernel``),
not from the wrappers' counters (which count once, at capture). Prints
one JSON line: the step's wall time, the device's busy time (union of
kernel intervals) and idle share (of the profiled window, and of the
unprofiled wall time), the decode-attention kernel's launches and
share, and the largest device kernels and host operators. Runs on CUDA
only.

With ``--speculative`` the engine is bench.py
``bench_serving_speculative``'s (``workloads.serve.
build_bench_speculative_engine``: the same target with the 256-wide
2-layer draft, gamma 4) and each step read is a replay of the captured
draft/verify step; the decode-attention launches then count both
cluster kernels (on that path only the int8 draft's K8 runs, (gamma + 1)
x 2 a step).
"""

from __future__ import annotations

import argparse
import collections
import json
import random
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from batch_shipyard_tpu_torch.models.serving import Request
from batch_shipyard_tpu_torch.workloads.serve import (
    BENCH_SERVING_KV_CACHES, BENCH_SPECULATIVE_CACHES, build_bench_engine,
    build_bench_speculative_engine)

PROMPT = 96
# The decode-attention kernel of each cache, as its mangled name starts
# (ops/csrc/decode_attention.cu): K6/K7's cluster kernel, K8's.
ATTENTION_KERNEL = {"paged": "paged_decode_cluster_kernel",
                    "paged_int8": "paged_decode_cluster_kernel",
                    "dense_int8": "dense_decode_cluster_kernel"}
# Every decode-attention kernel (K6/K7's and K8's).
DECODE_ATTENTION_KERNELS = tuple(sorted(set(ATTENTION_KERNEL.values())))


# The profiler can lose the first kernels it should see while it starts
# tracing: on an H100, one window of 16 replayed decode steps in 40 lost
# the first 504 of its first replay's 910 kernels. So a reading runs
# PROFILER_WARMUP_STEPS steps under the profiler, synchronises, and
# counts only the kernels that start inside the WINDOW range after them.
PROFILER_WARMUP_STEPS = 2
WINDOW = "profiled_window"


def window_kernels(events) -> list:
    """The device kernels among the profiler's ``events`` that start
    inside the host's WINDOW range (the range's own device annotation
    excluded)."""
    start = next(e.time_range.start for e in events
                 if e.name == WINDOW and e.device_type == DeviceType.CPU)
    return [e for e in events
            if e.device_type == DeviceType.CUDA and e.name != WINDOW and
            e.time_range.start >= start]


def busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def fill_slots(engine) -> None:
    """Admit one 96-token prompt into every slot of an idle engine and
    step past admission, so the next steps are pure decode steps."""
    rng = random.Random(0)
    slots = engine.num_slots
    for i in range(slots):
        engine.submit(Request(
            f"profile-{i}", [rng.randrange(engine.config.vocab_size)
                             for _ in range(PROMPT)],
            max_new_tokens=engine.max_decode_len - PROMPT))
    while len(engine.active_request_ids()) < slots:
        engine.step()
    for _ in range(4):
        engine.step()


def profile_engine(engine, kv_cache: str, steps: int,
                   attention: tuple = ()) -> dict:
    """The reading of ``steps`` pure decode steps of a warmed-up engine
    with every slot free (``kv_cache`` names its cache). The attention
    share reads the kernels whose names hold one of ``attention``
    (default: the cache's own kernel)."""
    attention = attention or (ATTENTION_KERNEL[kv_cache],)
    slots = engine.num_slots
    fill_slots(engine)
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - started) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_WARMUP_STEPS):
            engine.step()
        torch.cuda.synchronize()
        with record_function(WINDOW):
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
    if len(engine.active_request_ids()) < slots:
        raise RuntimeError("a request finished inside the window")
    kernels = window_kernels(prof.events())
    if not kernels:
        raise RuntimeError("the profiler recorded no device activity")
    by_name: dict[str, float] = collections.defaultdict(float)
    launches: collections.Counter = collections.Counter()
    intervals = []
    for e in kernels:
        start = e.time_range.start
        stop = e.time_range.end
        intervals.append((start, stop))
        by_name[e.name] += stop - start
        launches[e.name] += 1
    device_us = sum(by_name.values())
    busy = busy_us(intervals)
    window_us = (max(s for _, s in intervals) -
                 min(s for s, _ in intervals))
    attention = [name for name in by_name
                 if any(kernel in name for kernel in attention)]
    attention_us = sum(by_name[name] for name in attention)
    host_ops = collections.Counter()
    for avg in prof.key_averages():
        if avg.device_type == DeviceType.CPU and avg.key.startswith(
                "aten::"):
            host_ops[avg.key] = avg.self_cpu_time_total
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    busy_ms = busy / 1e3 / steps
    return {
        "kv_cache": kv_cache, "card": smi, "steps": steps,
        "graph": engine._graph is not None,
        "speculative": engine.spec_stats(),
        "wall_ms_per_step": wall_ms,
        "profiled_window_ms_per_step": window_us / 1e3 / steps,
        "device_busy_ms_per_step": busy_ms,
        "device_idle_share": 1.0 - busy / window_us,
        # The profiled busy time over the unprofiled wall time.
        "device_idle_share_of_wall": 1.0 - busy_ms / wall_ms,
        "kernel_launches_per_step": len(kernels) / steps,
        "launches_per_step_by_kernel": {
            name: n / steps for name, n in launches.items()},
        "attention_launches_per_step": sum(
            launches[name] for name in attention) / steps,
        "attention_ms_per_step": attention_us / 1e3 / steps,
        "attention_share_of_device": attention_us / device_us,
        "top_kernels_ms_per_step": {
            name[:80]: us / 1e3 / steps
            for name, us in sorted(by_name.items(),
                                   key=lambda kv: -kv[1])[:8]},
        "top_host_ops_ms_per_step": {
            name: us / 1e3 / steps
            for name, us in host_ops.most_common(8)},
    }


def run(kv_cache: str, steps: int, speculative: bool = False) -> dict:
    if speculative:
        engine = build_bench_speculative_engine(kv_cache, "cuda")
        engine.warmup()
        return profile_engine(engine, kv_cache, steps,
                              DECODE_ATTENTION_KERNELS)
    engine = build_bench_engine(kv_cache, "cuda")
    engine.warmup()
    return profile_engine(engine, kv_cache, steps)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kv-cache",
                        choices=sorted(set(BENCH_SERVING_KV_CACHES) |
                                       set(BENCH_SPECULATIVE_CACHES)),
                        default="paged")
    parser.add_argument("--speculative", action="store_true",
                        help="profile bench_serving_speculative's engine "
                        "(caches: dense, paged, paged_int8)")
    parser.add_argument("--steps", type=int, default=16)
    args = parser.parse_args(argv)
    caches = (BENCH_SPECULATIVE_CACHES if args.speculative
              else BENCH_SERVING_KV_CACHES)
    if args.kv_cache not in caches:
        parser.error(f"--kv-cache {args.kv_cache} is not one of "
                     f"{sorted(caches)}")
    print(json.dumps(run(args.kv_cache, args.steps, args.speculative)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
