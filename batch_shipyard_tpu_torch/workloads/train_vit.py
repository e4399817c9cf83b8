"""ViT image-classification training payload, on one card or data
parallel.

Counterpart of batch_shipyard_tpu/workloads/train_vit.py, with its flags
and defaults (ViT-B/16 at 224: ``--batch-per-device 128 --image-size
224 --patch-size 16 --d-model 768 --layers 12 --heads 12 --num-classes
1000 --steps 50 --warmup 3``, d_ff 4 x d_model, the checkpoint and
the compile-cache flags) plus ``--device {cuda,cpu}`` and ``--seed``:

    python -m batch_shipyard_tpu_torch.workloads.train_vit \\
        --batch-per-device 128 --steps 50
    python -m torch.distributed.run --nproc-per-node 2 \\
        -m batch_shipyard_tpu_torch.workloads.train_vit --steps 50
    python -m batch_shipyard_tpu_torch.workloads.train_vit --device cpu \\
        --image-size 32 --patch-size 4 --d-model 128 --layers 2 \\
        --heads 2 --batch-per-device 2 --steps 2

Every block's attention is non-causal K1/K2 on the card (models/vit.py).
One synthetic batch of fp32 standard-normal images and uniform labels,
the global batch drawn from ``np.random.RandomState(seed)`` and each
rank training its rows, is repeated every step. The loop and the JSON
line are workloads/vision.py's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from batch_shipyard_tpu_torch.data import loader
from batch_shipyard_tpu_torch.models import vit as vit_mod
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import train as train_mod
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_loop
from batch_shipyard_tpu_torch.workloads import vision


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    vision.add_args(parser, batch_per_device=128)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--patch-size", type=int, default=16)
    parser.add_argument("--d-model", type=int, default=768)
    parser.add_argument("--layers", type=int, default=12)
    parser.add_argument("--heads", type=int, default=12)
    parser.add_argument("--num-classes", type=int, default=1000)
    args = parser.parse_args(argv)

    ctx = distributed.setup(args.device)
    device = ctx["device"]
    batch_size = args.batch_per_device * ctx["process_count"]
    config = vit_mod.ViTConfig(
        image_size=args.image_size, patch_size=args.patch_size,
        num_classes=args.num_classes, d_model=args.d_model,
        n_layers=args.layers, n_heads=args.heads, d_ff=4 * args.d_model,
        dtype=torch.bfloat16)
    vision.enable_cache(args, ctx["process_count"], config)
    mesh = mesh_mod.RankMesh.build(device)
    harness = train_mod.build_vit_train(config, batch_size=batch_size,
                                        seed=args.seed, device=device,
                                        mesh=mesh)
    join_aot = train_loop.start_precompile(args, harness)
    rng = np.random.RandomState(args.seed)
    batch = {
        "images": np.asarray(rng.randn(batch_size, args.image_size,
                                       args.image_size, 3), np.float32),
        "labels": np.asarray(rng.randint(0, args.num_classes,
                                         (batch_size,)), np.int32)}
    mine = loader.place({key: train_mod.local_rows(harness, a)
                         for key, a in batch.items()}, device)

    def summary(r):
        return (f"vit: mesh={r['mesh']} {r['images_per_sec']:.1f} img/s "
                f"total, {r['images_per_sec_per_rank']:.1f} img/s/chip, "
                f"loss={r['loss']:.4f}")
    status, report = vision.run(ctx, args, harness, lambda: mine, summary,
                                "vit", join_aot=join_aot)
    vision.emit(ctx, {"model": "vit", "seq_len": config.num_patches,
                      **report})
    return status


if __name__ == "__main__":
    raise SystemExit(main())
