"""ResNet-50 training payload: bench_resnet's workload (the BASELINE
metric, "ResNet-50 images/sec/chip"), on one card or data parallel.

Counterpart of batch_shipyard_tpu/workloads/train_resnet.py, with its
flags and defaults (``--batch-per-device 128 --image-size 224 --steps 50
--warmup 3 --num-classes 1000 --data-dir --prefetch 2``, the
checkpoint flags and the compile-cache flags ``--compile-cache-dir``,
``--no-compile-cache`` and ``--aot-precompile``) plus ``--device {cuda,cpu}`` and ``--seed``:

    python -m batch_shipyard_tpu_torch.workloads.train_resnet \\
        --batch-per-device 128 --steps 50
    python -m torch.distributed.run --nproc-per-node 8 \\
        -m batch_shipyard_tpu_torch.workloads.train_resnet \\
        --batch-per-device 128 --steps 50
    python -m batch_shipyard_tpu_torch.workloads.train_resnet \\
        --device cpu --image-size 32 --batch-per-device 2 --steps 2

Data parallel over every rank (parallel/train.build_resnet_train: the
gradients all-reduced over the data ring, the batch norms synced), as
the reference shards its batch over every device. Data: ``--data-dir``,
a directory of .npz shards with ``images`` (uint8 [N, H, W, 3]) and
``labels``: each rank reads its round-robin shards (data/loader.py),
prefetched onto the card ``--prefetch`` batches ahead, and normalised
there (uint8 -> bf16, ``img / 127.5 - 1``). Without it, one synthetic
batch repeated every step: the global batch drawn from
``np.random.RandomState(seed)`` (standard normal images cast to bf16,
labels uniform), each rank training its rows, so a run on N ranks sees
the images of a one-rank run at N times the batch (one process at seed
0 draws the reference's single-process batch). On the card cuDNN picks
its convolution algorithms in the warm-up (``cudnn.benchmark``, set for
the run and restored after it), inside the goodput ``compile`` phase. The loop (restore, warm-up, timed steps,
preemption, saves, the profiler hook) and the JSON line are
workloads/vision.py's; MFU is parallel/mfu.resnet50_train_flops_per_image
over the card's peak. Checkpoints hold the parameters and SGD's momentum
only: the reference does not save ``batch_stats`` (its ``ckpt.restore(
params, opt_state)``), so a resumed run starts its running statistics
afresh (they steer evaluation only; training normalises with the batch's
statistics).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from batch_shipyard_tpu_torch.data import loader
from batch_shipyard_tpu_torch.models import resnet as resnet_mod
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import mfu
from batch_shipyard_tpu_torch.parallel import train as train_mod
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_loop
from batch_shipyard_tpu_torch.workloads import vision

# bench.py bench_resnet's shape: ResNet-50 at batch 256, 224x224, bf16.
BENCH_RESNET_BATCH, BENCH_RESNET_IMAGE = 256, 224


def synthetic_batch(batch: int, image_size: int, num_classes: int,
                    seed: int) -> dict:
    """The global synthetic batch: bf16 images, int32 labels (host)."""
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(np.asarray(
        rng.randn(batch, image_size, image_size, 3), np.float32))
    labels = np.asarray(rng.randint(0, num_classes, (batch,)), np.int32)
    return {"images": images.to(torch.bfloat16),
            "labels": torch.from_numpy(labels)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    vision.add_args(parser, batch_per_device=128)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=1000)
    parser.add_argument("--data-dir", default=None,
                        help=".npz shard directory with images/labels "
                             "arrays; synthetic when omitted")
    parser.add_argument("--prefetch", type=int, default=2)
    args = parser.parse_args(argv)

    ctx = distributed.setup(args.device)
    device = ctx["device"]
    world = ctx["process_count"]
    batch_size = args.batch_per_device * world
    config = resnet_mod.ResNetConfig(num_classes=args.num_classes,
                                     dtype=torch.bfloat16)
    vision.enable_cache(args, world, config)
    mesh = mesh_mod.RankMesh.build(device)
    harness = train_mod.build_resnet_train(config, batch_size=batch_size,
                                           seed=args.seed, device=device,
                                           mesh=mesh)
    join_aot = train_loop.start_precompile(args, harness)
    if args.data_dir:
        dataset = loader.ShardedDataset(args.data_dir, harness.local_batch,
                                        ctx["process_index"], world)
        raw = loader.prefetch_to_device(iter(dataset), device,
                                        depth=args.prefetch)
        batches = ({"images": loader.normalize_images(b["images"]),
                    "labels": b["labels"]} for b in raw)
    else:
        batch = synthetic_batch(batch_size, args.image_size,
                                args.num_classes, args.seed)
        mine = loader.place({key: train_mod.local_rows(harness, t)
                             for key, t in batch.items()}, device)
        batches = loader.synthetic_batches(lambda step: mine)

    def summary(r):
        return (f"resnet50: {r['images_per_sec']:.1f} img/s total, "
                f"{r['images_per_sec_per_rank']:.1f} img/s/chip, "
                f"loss={r['loss']:.4f}, {r['ms_per_step']:.1f} ms/step")
    # Autotuning for this run only: a caller in the same process keeps
    # its own setting.
    benchmark = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = device.type == "cuda" or benchmark
    try:
        status, report = vision.run(
            ctx, args, harness, lambda: next(batches), summary, "resnet",
            mfu.resnet50_train_flops_per_image(args.image_size),
            join_aot=join_aot)
    finally:
        torch.backends.cudnn.benchmark = benchmark
    vision.emit(ctx, {"model": "resnet50", **report})
    return status


if __name__ == "__main__":
    raise SystemExit(main())
