"""Whether the profiler's trace of replayed decode steps is whole, read
two ways, on the card.

    python -m batch_shipyard_tpu_torch.trace.profiler_window \
        [--kv-cache paged|paged_int8|dense_int8] [--windows 30] \
        [--steps 16]

Builds the serving benchmark engine (``decode_profile``'s), and for
each of ``--windows`` windows fills every slot and reads ``--steps``
replayed decode steps twice: the whole trace of a profiler started just
before the steps, and ``decode_profile.profile_engine``'s reading
(PROFILER_WARMUP_STEPS steps under the profiler first, then only the
kernels inside its window). A replay runs the same kernels every step,
so either reading short of the cache's attention kernel once a layer a
step is a trace that lost kernels. Prints one JSON line a window (for a
short whole trace, each replay's kernels and attention kernels, by the
graph launch they belong to) and a last line with the card's name and
power limit and the count of short windows each way. Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from batch_shipyard_tpu_torch.trace import decode_profile
from batch_shipyard_tpu_torch.workloads.serve import (
    BENCH_SERVING_KV_CACHES, build_bench_engine)

GRAPH_LAUNCH = ("cudaGraphLaunch", "cuGraphLaunch")


def by_replay(prof, own: str) -> dict:
    """Each replay's kernels and attention kernels in a trace, by the
    correlation id of the graph launch that ran them, in launch order."""
    launched, kernels, attention = {}, collections.Counter(), \
        collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            kernels[e.correlation_id()] += 1
            attention[e.correlation_id()] += own in e.name()
        elif e.name() in GRAPH_LAUNCH:
            launched[e.correlation_id()] = e.start_ns()
    order = sorted(launched, key=launched.get)
    return {"kernels": [kernels[c] for c in order],
            "attention": [attention[c] for c in order]}


def whole_trace(engine, own: str, steps: int) -> dict:
    """The attention kernels of a trace started just before ``steps``
    replayed steps, and every kernel it holds."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"attention": sum(own in e.name for e in kernels),
            "kernels": len(kernels), "prof": prof}


def drain(engine) -> None:
    while engine.active_request_ids():
        engine.step()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--kv-cache",
                        choices=sorted(BENCH_SERVING_KV_CACHES),
                        default="paged")
    parser.add_argument("--windows", type=int, default=30)
    parser.add_argument("--steps", type=int, default=16)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_window: no CUDA device", file=sys.stderr)
        return 1
    engine = build_bench_engine(args.kv_cache, "cuda")
    engine.warmup()
    own = decode_profile.ATTENTION_KERNEL[args.kv_cache]
    want = engine.config.n_layers
    short = {"whole_trace": 0, "windowed": 0}
    for window in range(args.windows):
        decode_profile.fill_slots(engine)
        whole = whole_trace(engine, own, args.steps)
        drain(engine)
        reading = decode_profile.profile_engine(engine, args.kv_cache,
                                                args.steps)
        drain(engine)
        row = {"window": window,
               "whole_trace_attention_per_step":
                   whole["attention"] / args.steps,
               "whole_trace_kernels_per_step":
                   whole["kernels"] / args.steps,
               "windowed_attention_per_step":
                   reading["attention_launches_per_step"],
               "windowed_kernels_per_step":
                   reading["kernel_launches_per_step"]}
        if whole["attention"] != want * args.steps:
            short["whole_trace"] += 1
            row["whole_trace_by_replay"] = by_replay(whole["prof"], own)
        short["windowed"] += row["windowed_attention_per_step"] != want
        print(json.dumps(row), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(json.dumps({"card": smi, "kv_cache": args.kv_cache,
                      "windows": args.windows, "steps": args.steps,
                      "attention_per_step_wanted": want,
                      "short_windows": short}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
