"""DiT denoising-diffusion training payload and DDIM sampling, on one
card or data parallel.

Counterpart of batch_shipyard_tpu/workloads/train_diffusion.py, with its
flags and defaults (``--batch-per-device 64 --image-size 32
--patch-size 4 --d-model 512 --layers 8 --heads 8 --num-classes None
--steps 50 --warmup 3 --sample N --sample-steps 50``, d_ff 4 x d_model,
the checkpoint and the compile-cache flags) plus ``--device {cuda,cpu}`` and ``--seed``:

    python -m batch_shipyard_tpu_torch.workloads.train_diffusion \\
        --batch-per-device 64 --steps 50 --sample 4
    python -m batch_shipyard_tpu_torch.workloads.train_diffusion \\
        --device cpu --d-model 128 --layers 2 --heads 2 \\
        --batch-per-device 2 --steps 2 --sample 2 --sample-steps 5

Every block's attention is non-causal K1/K2 on the card
(models/diffusion.py). One synthetic batch, ``tanh`` of standard-normal
images (labels uniform with ``--num-classes``) drawn for the global
batch from ``np.random.RandomState(seed)``, each rank training its rows,
is repeated every step; each step's timesteps and noise come from
parallel/train.diffusion_step_generator(seed, step counter), the counter
starting at 0 in each process as the reference's does. ``--sample N``
then runs DDIM for ``--sample-steps`` steps from noise drawn from a
generator seeded with 0 and prints the samples' shape and range (one
process only: the reference skips it on multi-process runs). The loop
and the JSON line are workloads/vision.py's; the JSON adds ``samples``.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from batch_shipyard_tpu_torch.data import loader
from batch_shipyard_tpu_torch.models import diffusion as dif_mod
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import train as train_mod
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_loop
from batch_shipyard_tpu_torch.workloads import vision


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    vision.add_args(parser, batch_per_device=64)
    parser.add_argument("--image-size", type=int, default=32)
    parser.add_argument("--patch-size", type=int, default=4)
    parser.add_argument("--d-model", type=int, default=512)
    parser.add_argument("--layers", type=int, default=8)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--num-classes", type=int, default=None)
    parser.add_argument("--sample", type=int, default=0,
                        help="generate N DDIM samples at the end")
    parser.add_argument("--sample-steps", type=int, default=50)
    args = parser.parse_args(argv)

    ctx = distributed.setup(args.device)
    device = ctx["device"]
    world = ctx["process_count"]
    batch_size = args.batch_per_device * world
    config = dif_mod.DiTConfig(
        image_size=args.image_size, patch_size=args.patch_size,
        d_model=args.d_model, n_layers=args.layers, n_heads=args.heads,
        d_ff=4 * args.d_model, num_classes=args.num_classes,
        dtype=torch.bfloat16)
    vision.enable_cache(args, world, config)
    mesh = mesh_mod.RankMesh.build(device)
    harness = train_mod.build_diffusion_train(
        config, batch_size=batch_size, seed=args.seed, device=device,
        mesh=mesh)
    join_aot = train_loop.start_precompile(args, harness)
    rng = np.random.RandomState(args.seed)
    batch = {"images": np.tanh(rng.randn(
        batch_size, args.image_size, args.image_size, 3)).astype(np.float32)}
    if args.num_classes:
        batch["labels"] = rng.randint(
            0, args.num_classes, (batch_size,)).astype(np.int32)
    mine = loader.place({key: train_mod.local_rows(harness, a)
                         for key, a in batch.items()}, device)

    def summary(r):
        return (f"dit: mesh={r['mesh']} {r['images_per_sec']:.1f} img/s "
                f"total, loss={r['loss']:.4f}")
    status, report = vision.run(ctx, args, harness, lambda: mine, summary,
                                "diffusion", join_aot=join_aot)
    if status == 0 and args.sample and world > 1:
        distributed.log(ctx, "ddim sampling skipped on multi-process runs; "
                             "sample from a restored checkpoint")
    elif status == 0 and args.sample:
        generator = torch.Generator(device=device).manual_seed(0)
        labels = (torch.zeros(args.sample, dtype=torch.int32, device=device)
                  if args.num_classes else None)
        samples = dif_mod.ddim_sample(harness.model, args.sample,
                                      args.sample_steps, generator, labels)
        low, high = float(samples.min()), float(samples.max())
        distributed.log(ctx, f"ddim samples: shape={tuple(samples.shape)} "
                             f"range=[{low:.3f}, {high:.3f}]")
        report["samples"] = {
            "shape": list(samples.shape), "min": low, "max": high,
            "finite": bool(torch.isfinite(samples).all()),
            "sample_steps": args.sample_steps}
    vision.emit(ctx, {"model": "dit", "seq_len": (
        args.image_size // args.patch_size) ** 2, **report})
    return status


if __name__ == "__main__":
    raise SystemExit(main())
