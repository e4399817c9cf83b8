"""The training loop every training payload runs: train_transformer.py,
and train_resnet.py, train_vit.py and train_diffusion.py through
vision.py. It is the loop of the reference's payloads:

- with ``--aot-precompile``, the kernel libraries the step launches are
  built and loaded on a thread from the moment the harness exists
  (``start_precompile``, compilecache/aot.py), overlapping the payload's
  batch set-up and the restore, and joined before the warm-up;
- restore the latest COMMITTED step of ``--checkpoint-dir``
  (``resumed from step N``);
- the warm-up steps, the goodput ``compile`` phase: the kernels' first
  launches (their builds, or their loads from the compile cache) and, on
  the card, cuDNN's autotuning fall there, outside the timed window. The
  event carries the cache's ``cache_hit`` and ``saved_seconds``
  (``compilecache.tracked(attrs, "<family>_warmup")``). As in the
  reference the warm-up steps run after the restore and update the state
  without being counted as steps;
- ``--steps`` timed steps with the on-demand profiler hook
  (trace/profiling.StepProfiler), the cooperative preemption drain (a
  committed save, then exit 75: agent/preemption.EXIT_PREEMPTED) and
  cadenced saves;
- goodput ``step_window`` events flushed at every save and at exit, so
  a preempted attempt's finished steps survive and a save's time lies
  outside them; then the final save.

Every step beats the progress file (the harness does). The payload
builds its harness and batches, and its report from ``Run``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from batch_shipyard_tpu_torch.agent import preemption
from batch_shipyard_tpu_torch.compilecache import aot
from batch_shipyard_tpu_torch.compilecache import manager as cc_manager
from batch_shipyard_tpu_torch.goodput import events as goodput_events
from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.trace.profiling import StepProfiler
from batch_shipyard_tpu_torch.workloads import checkpoint
from batch_shipyard_tpu_torch.workloads import distributed


@dataclasses.dataclass
class Run:
    """What the loop did: its steps, losses (warm-up first), timed
    seconds, whether it was preempted, each counter's growth a timed step
    (``per_step[name][key]``) and, with a warm-up, the first step's ms
    and the seconds from ``distributed.setup`` to its end."""
    ckpt: checkpoint.TrainCheckpointer
    start_step: int
    end_step: int
    losses: list
    loss: float
    elapsed: float
    preempted: bool
    per_step: dict
    first_step_ms: Optional[float] = None
    time_to_first_step_s: Optional[float] = None

    @property
    def steps(self) -> int:
        return max(self.end_step - self.start_step, 1)

    @property
    def status(self) -> int:
        return preemption.EXIT_PREEMPTED if self.preempted else 0


def start_precompile(args, harness) -> Optional[Callable[[], None]]:
    """With ``--aot-precompile``: ``harness.precompile()`` started on a
    thread (compilecache/aot.precompile_async); its join, for ``run``'s
    ``join_aot``. None without the flag."""
    if not getattr(args, "aot_precompile", False):
        return None
    return aot.precompile_async(harness)


def run(ctx: dict, args, harness, next_batch: Callable[[], dict],
        work: dict, family: str, mesh=None,
        counters: Optional[dict] = None,
        join_aot: Optional[Callable[[], None]] = None) -> Run:
    """Train ``harness`` on ``next_batch()`` as the module doc says.
    ``work``: a step's work for the step windows (``{"tokens": B * T}``,
    ``{"images": B}``); ``family``: the model family, which labels the
    warm-up's cache measurement (``transformer``, ``resnet``, ...);
    ``mesh``: the RankMesh, checked for a ring timeout after the warm-up
    and the last step; ``counters``: name -> a function returning counts
    so far, read before the timed steps and after the final save;
    ``join_aot``: ``start_precompile``'s join, called before the
    warm-up."""
    counters = counters or {}
    ckpt = checkpoint.TrainCheckpointer.from_args(args)
    start_step = ckpt.restore(harness)
    if start_step:
        distributed.log(ctx, f"resumed from step {start_step}")
    if join_aot is not None:
        join_aot()
    if ctx["device"].type == "cuda":
        torch.cuda.reset_peak_memory_stats(ctx["device"])
    if ctx["process_count"] > 1:
        dist.barrier()
    with goodput_events.phase(goodput_events.PROGRAM_COMPILE,
                              what="warmup", steps=args.warmup) as attrs, \
            cc_manager.tracked(attrs, f"{family}_warmup"):
        first_step_ms = time_to_first_step_s = None
        losses = []
        for i in range(args.warmup):
            t0 = time.perf_counter()
            losses.append(harness.step(next_batch())["loss"])
            if i == 0:
                float(losses[0])  # hard sync: the warm start's reading
                done = time.perf_counter()
                first_step_ms = (done - t0) * 1e3
                time_to_first_step_s = done - ctx["started"]
        if losses:
            float(losses[-1])  # hard sync
    if mesh is not None:
        mesh.check()
    before = {name: read() for name, read in counters.items()}
    start = time.perf_counter()
    window = {"step": start_step, "time": time.time()}

    def flush_window(end_step: int) -> None:
        if end_step > window["step"]:
            done = end_step - window["step"]
            goodput_events.record(
                goodput_events.PROGRAM_STEP_WINDOW, window["time"],
                time.time(), step_start=window["step"], step_end=end_step,
                **{unit: n * done for unit, n in work.items()})
        window["step"], window["time"] = end_step, time.time()

    profiler = StepProfiler()
    end_step, preempted = start_step + args.steps, False
    for step_num in range(start_step, start_step + args.steps):
        profiler.tick(step_num)
        losses.append(harness.step(next_batch())["loss"])
        if ckpt.maybe_preempt(step_num + 1, harness):
            end_step, preempted = step_num + 1, True
            break
        if ckpt.due(step_num + 1):
            flush_window(step_num + 1)
            ckpt.step_save(step_num + 1, harness)
            window["time"] = time.time()  # the save is not steps
    loss = float(losses[-1]) if losses else float("nan")  # hard sync
    profiler.close()
    flush_window(end_step)
    elapsed = time.perf_counter() - start
    if mesh is not None:
        mesh.check()  # a ring timeout in the last step
    if not preempted:
        ckpt.finalize(end_step, harness)
    steps = max(end_step - start_step, 1)
    per_step = {name: {key: (n - before[name].get(key, 0)) / steps
                       for key, n in read().items()}
                for name, read in counters.items()}
    return Run(ckpt=ckpt, start_step=start_step, end_step=end_step,
               losses=[float(x) for x in losses], loss=loss,
               elapsed=elapsed, preempted=preempted, per_step=per_step,
               first_step_ms=first_step_ms,
               time_to_first_step_s=time_to_first_step_s)


def gather_ranks(ctx: dict, args, result: Run, harness, rank: dict,
                 next_batch: Callable[[], dict], mesh=None) -> list:
    """Every rank's entry, in rank order: this rank's ``rank`` with its
    checkpoint record and, with ``--profile-steps N``,
    trace/train_profile's breakdown of N more steps. Closes ``mesh``."""
    if result.ckpt.enabled:
        rank["checkpoint"] = {"restored": result.ckpt.restored,
                              "saves": result.ckpt.saves}
    if args.profile_steps:
        from batch_shipyard_tpu_torch.trace import train_profile
        rank["profile"] = train_profile.profile_steps(
            harness, next_batch(), args.profile_steps)
    ranks = [rank]
    if ctx["process_count"] > 1:
        ranks = [None] * ctx["process_count"]
        dist.all_gather_object(ranks, rank)
    if mesh is not None:
        mesh.close()
    return ranks


def report_fields(args, result: Run) -> dict:
    """The report's steps, warm start (time to the first step, its ms,
    the nvcc seconds of each kernel library this process built, and the
    compile cache's stats: dir, identity, entries, hits, misses, saved
    seconds; None without a cache), checkpoint record (the
    restored step, its ms and read fraction, and the saves) and
    ``"exit": "preempted"``."""
    mgr = cc_manager.current()
    fields = {"start_step": result.start_step, "end_step": result.end_step,
              "warm_start": {
                  "time_to_first_step_s": result.time_to_first_step_s,
                  "first_step_ms": result.first_step_ms,
                  "built": dict(_build.built),
                  "compile_cache": mgr.stats() if mgr is not None
                  else None}}
    if result.ckpt.enabled:
        restored = result.ckpt.restored or {}
        fields["checkpoint"] = {
            "dir": args.checkpoint_dir,
            "restored_step": restored.get("step"),
            "restore_ms": restored.get("restore_ms"),
            "read_fraction": restored.get("read_fraction"),
            "saves": result.ckpt.saves}
    if result.preempted:
        fields["exit"] = "preempted"
    return fields
