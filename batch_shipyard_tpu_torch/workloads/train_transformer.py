"""Transformer LM training payload: one device, or a mesh of ranks.

Counterpart of batch_shipyard_tpu/workloads/train_transformer.py for
the dense path, with its flags and defaults (``--int8``: int8 matmuls for
every projection, a full-precision backward; ``--sp N``: ring attention
over N ranks; ``--tp N``: Megatron tensor parallelism; ``--fsdp N``: the
optimizer state and parameter updates sharded N ways; dp fills the rest
of the world, as the reference's auto_axis_sizes) plus ``--device
{cuda,cpu}``, ``--seed`` and ``--profile-steps``:

    python -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --seq-len 2048 --batch 8 --steps 20
    python -m torch.distributed.run --nproc-per-node 8 \
        -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --seq-len 8192 --sp 4 --tp 2 --steps 20

Weights are drawn from ``--seed`` (models/convert.init_params) at full
shape and sharded; one random batch of tokens and targets from
``np.random.RandomState(seed)`` is repeated every step, as in the
reference; every rank draws the same global batch and trains its block
of it (parallel/train.py). Rank 0 prints the reference's summary line
(with ``mesh=``), then one JSON line with the mesh, tokens/s of the
global batch, ms/step, MFU (None off a card in parallel/mfu's table),
peak device memory and, per rank, its mesh coordinates, its kernel
launches and its ring calls by axis (``ring_all_reduce.tp``,
``ring_permute.sp``, ...), sha256 digests of its replicated parameters
and of its tp shard (equal across the ranks that must hold the same
bits) and, with ``--profile-steps``, trace/train_profile's device
breakdown, per-axis collective time and ring wait.

Not offered yet (ROADMAP): --ep, --moe-experts and the checkpoint and
compile-cache flags.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import mfu
from batch_shipyard_tpu_torch.parallel import sharding
from batch_shipyard_tpu_torch.parallel import train as train_mod
from batch_shipyard_tpu_torch.workloads import distributed

# bench.py ``bench_transformer``'s model and batch (the repo's training
# benchmark): bf16 compute over fp32 parameters, no layer remat.
# chip_smoke.py trains this.
BENCH_TRANSFORMER_MODEL = dict(vocab_size=32000, d_model=1024, n_layers=12,
                               n_heads=16, d_head=64, d_ff=2816)
BENCH_TRANSFORMER_BATCH, BENCH_TRANSFORMER_SEQ = 16, 2048


def build_bench_harness(device, seed: int = 0,
                        batch_size: int = BENCH_TRANSFORMER_BATCH,
                        seq_len: int = BENCH_TRANSFORMER_SEQ,
                        fused_norm: bool = False, quantize: bool = False,
                        group=None, remat: bool = False, mesh=None,
                        n_layers: int = None) -> train_mod.TrainHarness:
    """bench_transformer's model with weights drawn from ``seed``;
    ``fused_norm`` and ``quantize`` as bench_transformer(fused_norm=...,
    quantize=...); ``group``: a sequence-parallel RingGroup (ring
    attention over its ranks), or ``mesh``: a RankMesh; ``remat`` as the
    workload's default; ``n_layers``: a cut depth."""
    model = dict(BENCH_TRANSFORMER_MODEL)
    if n_layers is not None:
        model["n_layers"] = n_layers
    config = train_mod.make_transformer_config(
        sp=group.size if group is not None else 1, group=group, mesh=mesh,
        **model, max_seq_len=seq_len, dtype=torch.bfloat16, remat=remat,
        fused_norm=fused_norm, quantize_matmuls=quantize)
    return train_mod.build_transformer_train(
        config, batch_size=batch_size, seq_len=seq_len, seed=seed,
        device=device, group=group, mesh=mesh)


def random_batch(vocab: int, batch: int, seq_len: int, seed: int,
                 device) -> dict:
    """Tokens, then targets, from np.random.RandomState(seed), as the
    reference's workload and bench_transformer draw them."""
    rng = np.random.RandomState(seed)
    return {name: torch.from_numpy(np.asarray(
        rng.randint(0, vocab, (batch, seq_len)), np.int32)).to(device)
        for name in ("tokens", "targets")}


def _training_ops():
    from batch_shipyard_tpu_torch.ops import (attention, chunked_loss,
                                              fused_norm, quantization,
                                              ring_collectives)
    return (attention, chunked_loss, fused_norm, quantization,
            ring_collectives)


def launch_counts() -> dict:
    """Every training kernel wrapper's launch count so far, by kernel,
    and the ring calls that launched kernels by axis ("call.axis")."""
    from batch_shipyard_tpu_torch.ops import ring_collectives
    counts = {key: n for module in _training_ops()
              for key, n in module.launches.items()}
    counts.update(ring_collectives.axis_launches)
    return counts


def check_mesh_sizes(args, world: int) -> None:
    """Exit with a clear message when the world, the sequence, the batch
    or the model cannot be split the way the flags ask."""
    inner = args.tp * args.sp * args.fsdp
    if inner < 1 or world % inner:
        raise SystemExit(f"{world} ranks are not divisible by tp * sp * "
                         f"fsdp = {inner}")
    for value, by, what, axes in (
            (args.seq_len, args.sp, "--seq-len", "--sp"),
            (args.batch, world // inner * args.fsdp, "--batch",
             "dp * fsdp"),
            (args.n_heads, args.tp, "--n-heads", "--tp"),
            (args.d_ff, args.tp, "--d-ff", "--tp")):
        if value % by:
            raise SystemExit(f"{what} {value} is not divisible by {axes} "
                             f"= {by}")
    if args.tp > 1 and args.int8:
        raise SystemExit("--int8 with --tp is not ported (ROADMAP queue 1: "
                         "fused_norm and int8 under tp)")


def param_digests(harness) -> dict:
    """sha256 of this rank's replicated parameters (the same on every
    rank) and of its tp shard (the same on the ranks of its tp index),
    over their bytes in state-dict order."""
    digests = {"replicated": hashlib.sha256(),
               "tp_shard": hashlib.sha256()}
    for name, tensor in harness.model.state_dict().items():
        kind = ("replicated" if sharding.tp_dim(name) is None
                or harness.model.config.tp == 1 else "tp_shard")
        digests[kind].update(tensor.detach().cpu().numpy().tobytes())
    return {kind: d.hexdigest() for kind, d in digests.items()}


def plain_counts() -> dict:
    """Calls of the training path's plain versions so far, as
    ``module.version`` (``chunked_loss.chunked``, ...)."""
    return {f"{module.__name__.rsplit('.', 1)[-1]}.{key}": n
            for module in _training_ops()
            for key, n in module.plain_calls.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--d-model", type=int, default=1024)
    parser.add_argument("--n-layers", type=int, default=12)
    parser.add_argument("--n-heads", type=int, default=16)
    parser.add_argument("--d-ff", type=int, default=2816)
    parser.add_argument("--vocab", type=int, default=32000)
    parser.add_argument("--seq-len", type=int, default=2048)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel ranks (Megatron); run "
                             "under torch.distributed.run")
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence-parallel ranks (ring attention); "
                             "run under torch.distributed.run")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="ranks the optimizer state and updates are "
                             "sharded over")
    parser.add_argument("--int8", action="store_true",
                        help="int8 matmuls for projections/MLP "
                             "(QAT straight-through backward)")
    parser.add_argument("--no-remat", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="then profile this many steps on the card "
                             "(trace/train_profile)")
    args = parser.parse_args(argv)

    ctx = distributed.setup(args.device)
    device = ctx["device"]
    check_mesh_sizes(args, ctx["process_count"])
    mesh = mesh_mod.RankMesh.build(device, tp=args.tp, sp=args.sp,
                                   fsdp=args.fsdp)
    multi = mesh.world > 1
    config = train_mod.make_transformer_config(
        mesh=mesh, vocab_size=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        d_head=args.d_model // args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.seq_len, dtype=torch.bfloat16,
        quantize_matmuls=args.int8, remat=not args.no_remat)
    harness = train_mod.build_transformer_train(
        config, batch_size=args.batch, seq_len=args.seq_len,
        seed=args.seed, device=device, mesh=mesh)
    batch = random_batch(args.vocab, args.batch, args.seq_len, args.seed,
                         device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    if multi:
        dist.barrier()
    losses = [harness.step(batch)["loss"] for _ in range(args.warmup)]
    if losses:
        float(losses[-1])  # hard sync
    mesh.check()
    counts = launch_counts()
    start = time.perf_counter()
    for _ in range(args.steps):
        losses.append(harness.step(batch)["loss"])
    loss = float(losses[-1])  # hard sync
    elapsed = time.perf_counter() - start
    mesh.check()  # a ring timeout in the last step
    rank = {
        "rank": ctx["process_index"], "coords": mesh.coords,
        "launches": {key: n for key, n in launch_counts().items() if n},
        "launches_per_step": {
            key: (n - counts.get(key, 0)) / args.steps
            for key, n in launch_counts().items()
            if n - counts.get(key, 0)},
        "plain_calls": {key: n for key, n in plain_counts().items() if n},
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if on_card else None),
        "params_sha256": param_digests(harness),
    }
    if args.profile_steps:
        from batch_shipyard_tpu_torch.trace import train_profile
        rank["profile"] = train_profile.profile_steps(
            harness, batch, args.profile_steps)
    ranks = [rank]
    if multi:
        ranks = [None] * mesh.world
        dist.all_gather_object(ranks, rank)
    mesh.close()
    if ctx["process_index"] != 0:
        return 0
    tokens_per_sec = args.batch * args.seq_len * args.steps / elapsed
    ms_per_step = elapsed / args.steps * 1000
    distributed.log(ctx, (
        f"transformer: mesh={mesh.sizes} device={device} "
        f"{tokens_per_sec:.0f} tok/s, loss={loss:.4f}, "
        f"{ms_per_step:.1f} ms/step"))
    peak = mfu.peak_bf16_tflops(torch.cuda.get_device_name(device)
                                if on_card else "cpu")
    print(json.dumps({
        "device": torch.cuda.get_device_name(device) if on_card
        else "cpu",
        "mesh": mesh.sizes, "ranks_per_card": (
            mesh.world // max(torch.cuda.device_count(), 1) if on_card
            else None),
        "tokens_per_sec": tokens_per_sec, "ms_per_step": ms_per_step,
        "loss": loss, "losses": [float(x) for x in losses],
        "mfu_pct": mfu.mfu_pct(
            tokens_per_sec,
            mfu.transformer_train_flops_per_token(config, args.seq_len),
            peak),
        "peak_mem_gb": ranks[0]["peak_mem_gb"],
        "per_rank": ranks,
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
