"""Reshard-probe: a featherweight SHARDED "trainer" for resize drills.

The host_loss_resize drill's acceptance criterion is about multi-host
reshard-on-restore — an N-host gang re-forms at M hosts and each new
host reads ONLY the checkpoint shards its range needs — not about
matmuls. Like workloads/preempt_probe.py, this speaks the real
contracts with stdlib-only imports:

  * progress beats + goodput step windows + preempt watcher (the
    preempt_probe surfaces),
  * a SHARDED commit protocol mirroring checkpoint.py's: each gang
    instance owns a contiguous shard of a ``--dim``-wide float state
    vector and writes ``<ckpt>.shard{k}of{n}`` atomically; instance 0
    then writes a ``.LAYOUT`` sidecar (the ``.MESH`` analog: source
    shard count + dim) and the ``.COMMITTED`` marker — torn saves are
    never picked up,
  * per-host restore planning (parallel/restore_plan.py — the SAME
    pure math the checkpoint layer's restore plans on): on
    restore at a different gang size, each instance consults the
    sidecar's source layout vs its own target range and reads only
    the overlapping shard files, recording WHICH into the read log
    (``<ckpt>.reads.log``) so the drill can assert reads == plan.

State update is per-element and deterministic —
``state[i] += (step+1) * (i+1)`` — so instances never need to
communicate, any (step, size) point is pure-replayable by the drill's
oracle, and bit-exactness across a resize is a meaningful assertion.
The per-commit "loss" (sum of this instance's shard) appends to
``<ckpt>.loss.log``: the drill's loss-trajectory oracle replays the
expected values from the barrier.

The port's copy of batch_shipyard_tpu/workloads/reshard_probe.py, over
the port's hooks and restore plan, stdlib only (it loads no torch): the
same arguments and environment give the same shard files, ``.LAYOUT``,
``.COMMITTED``, ``.reads.log`` and ``.loss.log``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from batch_shipyard_tpu_torch.agent import preemption
from batch_shipyard_tpu_torch.agent import progress
from batch_shipyard_tpu_torch.goodput import events as goodput_events
from batch_shipyard_tpu_torch.parallel import restore_plan


def _shard_path(ckpt: str, step: int, shard: int,
                parts: int) -> str:
    """STEP-SCOPED shard file (checkpoint.py's per-step dirs): a
    later attempt's staged-but-never-committed write must not
    clobber the committed step's shard — the survivor of a broken
    gang keeps staging right up to the barrier timeout."""
    return f"{ckpt}.s{step}.shard{shard}of{parts}"


def _atomic_write(path: str, payload: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(payload))
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _read_json(path: str):
    try:
        with open(path, encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def _append(path: str, line: str) -> None:
    with open(path, "a", encoding="utf-8") as fh:
        fh.write(line + "\n")


def _commit(ckpt: str, step: int, instance: int, instances: int,
            dim: int, shard: list[float],
            barrier_timeout: float = 3.0) -> bool:
    """The sharded commit: every instance writes its shard for this
    step; instance 0 waits for the full set, then writes the .LAYOUT
    sidecar + .COMMITTED marker (the multi-writer analog of
    checkpoint.py's staging -> barrier -> COMMITTED order: a crash at
    any point leaves the previous committed step pickable, never a
    torn mix of steps). Returns False when the barrier timed out — a
    peer died mid-commit; the previous commit stands, and the CALLER
    latches off further commit attempts (the gang is broken; the
    recovery requeue owns the rerun, and re-waiting the barrier at
    every later cadence boundary would stall the survivor for the
    rest of its zombie life)."""
    _atomic_write(_shard_path(ckpt, step, instance, instances),
                  {"step": step, "values": shard})
    if instance != 0:
        return True
    deadline = time.monotonic() + barrier_timeout
    while time.monotonic() < deadline:
        if all((_read_json(_shard_path(ckpt, step, k, instances))
                or {}).get("step") == step
               for k in range(instances)):
            break
        progress.beat()  # alive, waiting on peers — not wedged
        time.sleep(0.02)
    else:
        return False
    _atomic_write(ckpt + ".LAYOUT",
                  {"step": step, "parts": instances, "dim": dim})
    _atomic_write(ckpt + ".COMMITTED", {"step": step})
    _gc_stale_shards(ckpt, step)
    return True


def _gc_stale_shards(ckpt: str, committed_step: int) -> None:
    """Retention (writer-only, AFTER the marker landed): shard files
    of steps older than the just-committed one can never be restored
    again — a restore only ever reads the COMMITTED step."""
    base = os.path.basename(ckpt) + ".s"
    parent = os.path.dirname(ckpt) or "."
    try:
        names = os.listdir(parent)
    except OSError:
        return
    for name in names:
        if not name.startswith(base):
            continue
        try:
            step = int(name[len(base):].split(".", 1)[0])
        except ValueError:
            continue
        if step < committed_step:
            try:
                os.remove(os.path.join(parent, name))
            except OSError:
                pass


def _restore(ckpt: str, instance: int, instances: int,
             dim: int) -> tuple[int, list[float]]:
    """Per-host planned restore: committed step + THIS instance's
    target shard, assembled by reading only the source shard files
    the restore plan names. Records the reads issued (the drill
    asserts they match restore_plan.host_reads exactly)."""
    committed = _read_json(ckpt + ".COMMITTED")
    layout = _read_json(ckpt + ".LAYOUT")
    lo, hi = restore_plan.shard_ranges(dim, instances)[instance]
    if not committed or not layout or \
            layout.get("step") != committed.get("step"):
        return 0, [0.0] * (hi - lo)
    step = int(committed["step"])
    source_parts = int(layout["parts"])
    reads = restore_plan.host_reads(dim, source_parts, instances,
                                    instance)
    values = [0.0] * (hi - lo)
    for read in reads:
        payload = _read_json(_shard_path(ckpt, step, read.shard,
                                         source_parts))
        if payload is None or payload.get("step") != step:
            return 0, [0.0] * (hi - lo)  # torn source; start fresh
        chunk = payload["values"][read.lo:read.hi]
        values[read.dst_lo:read.dst_lo + len(chunk)] = chunk
        _append(ckpt + ".reads.log",
                f"i{instance}of{instances} step={step} "
                f"shard={read.shard}of{source_parts} "
                f"[{read.lo}..{read.hi})")
    return step, values


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--step-seconds", type=float, default=0.05)
    parser.add_argument("--dim", type=int, default=24,
                        help="global state width (must split over "
                             "every gang size the drill uses)")
    parser.add_argument("--checkpoint-every", type=int, default=10)
    parser.add_argument("--ckpt", required=True,
                        help="shared state prefix (job scratch/"
                             "shared dir)")
    args = parser.parse_args()

    instance = int(os.environ.get("SHIPYARD_TASK_INSTANCE", "0"))
    instances = int(os.environ.get("SHIPYARD_TASK_INSTANCES", "1"))
    lo, hi = restore_plan.shard_ranges(args.dim,
                                       instances)[instance]
    start_step, shard = _restore(args.ckpt, instance, instances,
                                 args.dim)
    watcher = preemption.PreemptWatcher()
    window_started = time.time()

    def _loss() -> float:
        return sum(shard)

    def _record_loss(step: int) -> None:
        if instance == 0:
            _append(args.ckpt + ".loss.log",
                    f"step={step} size={instances} "
                    f"loss={_loss():.6f}")

    peer_lost = False
    for step in range(start_step, args.steps):
        time.sleep(args.step_seconds)
        progress.beat()
        for k in range(len(shard)):
            # Per-element deterministic update: pure-replayable at
            # any (step, size), so resized resumes are bit-exact.
            shard[k] += float((step + 1) * (lo + k + 1))
        done = step + 1
        drain = watcher.poll() is not None
        if not peer_lost and (
                drain or (args.checkpoint_every
                          and done % args.checkpoint_every == 0)):
            if _commit(args.ckpt, done, instance, instances,
                       args.dim, shard):
                _record_loss(done)
            else:
                peer_lost = True  # broken gang: stop committing
        if drain:
            goodput_events.record(
                goodput_events.PROGRAM_STEP_WINDOW, window_started,
                time.time(), step_start=start_step, step_end=done)
            return preemption.EXIT_PREEMPTED
    if not peer_lost:
        if _commit(args.ckpt, args.steps, instance, instances,
                   args.dim, shard):
            _record_loss(args.steps)
    goodput_events.record(
        goodput_events.PROGRAM_STEP_WINDOW, window_started,
        time.time(), step_start=start_step, step_end=args.steps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
