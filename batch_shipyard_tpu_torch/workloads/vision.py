"""What the vision workloads share (train_resnet.py, train_vit.py,
train_diffusion.py): their flags (the compile-cache flags among them),
``enable_cache`` (before the mesh and the harness are built), and
``run``: the training loop of workloads/train_loop.py, counted in
images, and its report.

Rank 0 prints the reference's summary line and then one JSON line:
images/s of the global batch, per card in use and per rank, ms/step,
the losses, MFU where the workload has a FLOPs model and the card a
peak (parallel/mfu.py), peak device memory, the data ring's all-reduces
a step by label (``grads``; ResNet's synced batch norms ``bn_stats`` and
``bn_grads``), and per rank its kernels' launches a step (the flash
kernels, the ring collectives by call and axis) and sha256 digests of
its parameters and buffers (ResNet's running statistics), which dp keeps
equal; with ``--profile-steps N`` (the card only), trace/train_profile's
breakdown of N more steps.
"""

from __future__ import annotations

import hashlib
import json
from typing import Callable, Optional

import torch

from batch_shipyard_tpu_torch.compilecache import manager as cc_manager
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import mfu
from batch_shipyard_tpu_torch.workloads import checkpoint
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_loop


def add_args(parser, batch_per_device: int, steps: int = 50,
             warmup: int = 3) -> None:
    """The flags every vision workload takes: the reference's batch,
    step and warm-up counts, checkpoint and compile-cache flags, and the
    port's ``--device`` and ``--seed``."""
    parser.add_argument("--batch-per-device", type=int,
                        default=batch_per_device)
    parser.add_argument("--steps", type=int, default=steps)
    parser.add_argument("--warmup", type=int, default=warmup)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0,
                        help="weights and synthetic data")
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="then profile this many steps on the card "
                             "(trace/train_profile)")
    checkpoint.add_checkpoint_args(parser)
    cc_manager.add_compile_cache_args(parser)


def enable_cache(args, world: int, config) -> None:
    """The compile cache (``--compile-cache-dir``) for this dp mesh of
    ``world`` ranks and model ``config``. Call it before the mesh is
    built: on the card its rings load the ring collectives' library."""
    cc_manager.enable_from_args(
        args, mesh_shape=mesh_mod.auto_axis_sizes(world),
        model_digest=cc_manager.config_digest(config))


def ring_calls() -> dict:
    """The vision path's data-ring all-reduces so far, by label."""
    from batch_shipyard_tpu_torch.models import resnet
    return dict(resnet.sync_calls)


def launch_counts() -> dict:
    """The flash kernels' and ring collectives' launches so far."""
    from batch_shipyard_tpu_torch.ops import attention, ring_collectives
    counts = dict(attention.launches)
    counts.update(ring_collectives.launches)
    counts.update(ring_collectives.axis_launches)
    return counts


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().reshape(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


def run(ctx: dict, args, harness, next_batch: Callable[[], dict],
        summary: Callable[[dict], str], family: str,
        flops_per_image: Optional[float] = None,
        join_aot: Optional[Callable[[], None]] = None) -> tuple[int, dict]:
    """train_loop.run over ``harness`` (parallel/train.VisionHarness) fed
    by ``next_batch()``; ``summary(report)`` is the reference's line;
    ``family`` and ``join_aot`` as train_loop.run's. Returns (exit
    status, the JSON report, also on ranks other than 0, which print
    nothing)."""
    device = harness.device
    on_card = device.type == "cuda"
    world = ctx["process_count"]
    images = harness.batch_size
    result = train_loop.run(
        ctx, args, harness, next_batch, {"images": images}, family,
        harness.mesh,
        counters={"ring": lambda: {**ring_calls(),
                                   "grads": harness.grad_all_reduces},
                  "launches": launch_counts},
        join_aot=join_aot)
    params = dict(harness.model.named_parameters())
    buffers = [t for name, t in harness.model.state_dict().items()
               if name not in params]
    rank = {
        "rank": ctx["process_index"],
        "launches_per_step": {key: n for key, n in
                              result.per_step["launches"].items() if n},
        "params_sha256": digest(harness.model.parameters()),
        "buffers_sha256": digest(buffers) if buffers else None,
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if on_card else None),
    }
    ranks = train_loop.gather_ranks(ctx, args, result, harness, rank,
                                    next_batch, harness.mesh)
    cards = (min(world, torch.cuda.device_count()) if on_card else None)
    images_per_sec = images * result.steps / result.elapsed
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    report = {
        "device": name, "mesh": dict(harness.layout[0]), "ranks": world,
        "cards": cards, "batch": images,
        "images_per_sec": images_per_sec,
        "images_per_sec_per_card": (images_per_sec / cards if cards
                                    else None),
        "images_per_sec_per_rank": images_per_sec / world,
        "ms_per_step": result.elapsed / result.steps * 1e3,
        "loss": result.loss, "losses": result.losses,
        "mfu_pct": (mfu.mfu_pct(images_per_sec / cards, flops_per_image,
                                mfu.peak_bf16_tflops(name))
                    if flops_per_image and cards else None),
        "peak_mem_gb": ranks[0]["peak_mem_gb"],
        "ring_calls_per_step": result.per_step["ring"],
        "launches_per_step": ranks[0]["launches_per_step"],
        "per_rank": ranks,
        **train_loop.report_fields(args, result),
    }
    if ctx["process_index"] == 0:
        distributed.log(ctx, summary(report))
    return result.status, report


def emit(ctx: dict, report: dict) -> None:
    """Rank 0 prints the JSON line."""
    if ctx["process_index"] == 0:
        print(json.dumps(report), flush=True)
