"""Transformer LM training payload: one device, or a mesh of ranks.

Counterpart of batch_shipyard_tpu/workloads/train_transformer.py for
the dense path, with its flags and defaults (``--int8``: int8 matmuls for
every projection, a full-precision backward; ``--sp N``: ring attention
over N ranks; ``--tp N``: Megatron tensor parallelism with the
vocab-parallel embedding and loss, composing with ``--fused-norm`` and
``--int8`` as in the reference; ``--fsdp N``: the
parameters, their gradients and the optimizer state sharded N ways, each
layer gathered as it runs (parallel/train.py); ``--moe-experts N`` (0:
dense) and ``--moe-every K``: every K-th block's MLP becomes N routed
top-1 SwiGLU experts (models/moe.py), with one routing over the global
batch; ``--ep N``: the experts split over N ranks, the tokens replicated
over them (N must divide the experts); dp fills the rest
of the world, as the reference's auto_axis_sizes; the checkpoint flags
of workloads/checkpoint.py) plus ``--device {cuda,cpu}``, ``--seed``,
``--profile-steps`` and ``--fused-norm`` (bench_transformer's
``fused_norm=True`` lever: K9 for the norm-projections):

    python -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --seq-len 2048 --batch 8 --steps 20
    python -m torch.distributed.run --nproc-per-node 8 \
        -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --seq-len 8192 --sp 4 --tp 2 --steps 20
    python -m torch.distributed.run --nproc-per-node 4 \
        -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --seq-len 8192 --sp 2 --tp 2 --fused-norm --steps 20
    python -m torch.distributed.run --nproc-per-node 2 \
        -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --batch 16 --seq-len 4096 --fsdp 2 --steps 20
    python -m torch.distributed.run --nproc-per-node 4 \
        -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --moe-experts 8 --ep 4 --batch 8 --seq-len 4096 --steps 20

Checkpoints and the pool's hooks, as in the reference's loop (the port's is
workloads/train_loop.py, which the vision payloads share): the run
restores the latest COMMITTED step of ``--checkpoint-dir`` before the
warm-up (``resumed from step N``; on another mesh the state is
resharded), saves every ``--checkpoint-every`` steps (blocking, or
``--async-checkpoint``: only the snapshot blocks) and at the end, keeps
``--keep-last`` steps, and on a preempt request
(``$SHIPYARD_PREEMPT_REQUEST_FILE``; every rank agrees at the same step
boundary) forces a committed save and exits 75
(agent/preemption.EXIT_PREEMPTED). ``--steps`` counts this attempt's
steps from the restored one. It writes goodput events
(``$SHIPYARD_GOODPUT_FILE``: the warm-up as ``compile``, ``step_window``
flushed at every save and at exit, the checkpoint phases) and spans
(``$SHIPYARD_TRACE_FILE``), beats ``$SHIPYARD_PROGRESS_FILE`` every
step, and captures a torch.profiler trace when
``$SHIPYARD_PROFILE_REQUEST_FILE`` asks (trace/profiling.py). Resume
after a preemption or on a resized mesh:

    python -m torch.distributed.run --nproc-per-node 4 \
        -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --sp 2 --fsdp 2 --checkpoint-dir ckpt --checkpoint-every 50 \
        --steps 1000          # preempted: exit 75 at a committed step
    python -m torch.distributed.run --nproc-per-node 4 \
        -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --sp 2 --tp 2 --checkpoint-dir ckpt --checkpoint-every 50 \
        --steps 1000          # resumes there, resharded onto tp 2

As in the reference, the warm-up steps run after the restore and update
the state without being counted as steps: compare a resumed run with an
uninterrupted one at ``--warmup 0``.

Weights are drawn from ``--seed`` (models/convert.init_params) at full
shape and sharded; one random batch of tokens and targets from
``np.random.RandomState(seed)`` is repeated every step, as in the
reference; every rank draws the same global batch and trains its block
of it (parallel/train.py). Rank 0 prints the reference's summary line
(with ``mesh=``), then one JSON line with the mesh, tokens/s of the
global batch, ms/step, MFU (None off a card in parallel/mfu's table),
peak device memory, the parameter bytes a rank holds between steps
(``resident_param_bytes``: its fsdp chunks) and, per rank, its mesh
coordinates, its kernel launches and its ring calls by axis
(``ring_all_reduce.tp``, ``ring_all_reduce.ep``, ``ring_permute.sp``,
``ring_all_gather.data+tokens``, ...), its peak and resident bytes, sha256
digests of its replicated parameters, of its tp shard and of its experts
(its ep shard), gathered over fsdp (equal across the ranks that must hold
the same bits), with MoE the dropped-token share of each MoE layer in
the last step and, with ``--profile-steps``, trace/train_profile's device
breakdown, per-axis collective time and ring wait. With a checkpoint dir
the JSON line and each rank's entry carry ``checkpoint``: the restored
step, its ms and read fraction, and per save its step, blocking,
snapshot and persist ms and the bytes this rank wrote; a preempted run
adds ``"exit": "preempted"``.

Not offered yet (ROADMAP): the compile-cache flags.
"""

from __future__ import annotations

import argparse
import hashlib
import json
from typing import Optional

import numpy as np
import torch

from batch_shipyard_tpu_torch.models import moe as moe_mod
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import mfu
from batch_shipyard_tpu_torch.parallel import sharding
from batch_shipyard_tpu_torch.parallel import train as train_mod
from batch_shipyard_tpu_torch.workloads import checkpoint
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_loop

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
                        n_layers: int = None, moe_experts: int = 0,
                        moe_every: int = 2) -> train_mod.TrainHarness:
    """bench_transformer's model with weights drawn from ``seed``;
    ``fused_norm`` and ``quantize`` as bench_transformer(fused_norm=...,
    quantize=...); ``group``: a sequence-parallel RingGroup (ring
    attention over its ranks), or ``mesh``: a RankMesh; ``remat`` as the
    workload's default; ``n_layers``: a cut depth; ``moe_experts`` and
    ``moe_every`` as the workload's flags."""
    model = dict(BENCH_TRANSFORMER_MODEL)
    if n_layers is not None:
        model["n_layers"] = n_layers
    config = train_mod.make_transformer_config(
        sp=group.size if group is not None else 1, group=group, mesh=mesh,
        **model, max_seq_len=seq_len, dtype=torch.bfloat16, remat=remat,
        fused_norm=fused_norm, quantize_matmuls=quantize,
        moe=moe_config(moe_experts, model["d_model"], model["d_ff"]),
        moe_every=moe_every)
    return train_mod.build_transformer_train(
        config, batch_size=batch_size, seq_len=seq_len, seed=seed,
        device=device, group=group, mesh=mesh)


def moe_config(experts: int, d_model: int, d_ff: int
               ) -> Optional[moe_mod.MoEConfig]:
    """The workload's MoEConfig (the reference's: top-1 token routing,
    capacity factor 1.25, bf16 compute over fp32 parameters), or None for
    0 experts."""
    if not experts:
        return None
    return moe_mod.MoEConfig(num_experts=experts, d_model=d_model,
                             d_ff=d_ff, dtype=torch.bfloat16)


def dropped_shares(model) -> dict:
    """The share of (token, choice) pairs each MoE layer dropped in its
    last forward on this rank (0.0 to 1.0), by layer name."""
    shares = {}
    for i, block in enumerate(model.blocks()):
        routing = getattr(block, "moe", None) and block.moe.last_routing
        if routing is not None:
            shares[f"layer_{i}"] = float(
                (routing.position < 0).float().mean())
    return shares


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
    inner = args.tp * args.sp * args.fsdp * args.ep
    if inner < 1 or world % inner:
        axes = "tp * sp * fsdp" + (" * ep" if args.ep > 1 else "")
        raise SystemExit(f"{world} ranks are not divisible by {axes} = "
                         f"{inner}")
    if args.ep > 1 and not args.moe_experts:
        raise SystemExit("--ep splits the experts: it needs --moe-experts")
    if args.moe_experts % args.ep:
        raise SystemExit(f"--moe-experts {args.moe_experts} is not "
                         f"divisible by --ep {args.ep}")
    for value, by, what, axes in (
            (args.seq_len, args.sp, "--seq-len", "--sp"),
            (args.batch, world // inner * args.fsdp, "--batch",
             "dp * fsdp"),
            (args.n_heads, args.tp, "--n-heads", "--tp"),
            (args.d_ff, args.tp, "--d-ff", "--tp"),
            (args.vocab, args.tp, "--vocab", "--tp")):
        if value % by:
            raise SystemExit(f"{what} {value} is not divisible by {axes} "
                             f"= {by}")
    if args.fused_norm and (args.int8 or args.moe_experts):
        raise SystemExit("--fused-norm composes only with the dense path, "
                         "not --int8 or --moe-experts")


def param_digests(harness) -> dict:
    """sha256 of this rank's replicated parameters (the same on every
    rank), of its tp shard (the same on the ranks of its tp index: the
    split projections, the regrouped fused kernels and the embedding's
    rows) and, with MoE, of its experts (the same on the ranks of its ep
    and tp indices), gathered over fsdp (harness.state_dict: every rank
    must call it), over their bytes in state-dict order."""
    config = harness.model.config
    kinds = ("replicated", "tp_shard") + (
        ("ep_shard",) if config.moe is not None else ())
    digests = {kind: hashlib.sha256() for kind in kinds}
    for name, tensor in harness.state_dict().items():
        digests[digest_kind(name, config.tp)].update(
            tensor.detach().cpu().numpy().tobytes())
    return {kind: d.hexdigest() for kind, d in digests.items()}


def digest_kind(name: str, tp: int) -> str:
    """Which of param_digests' digests parameter ``name`` goes into."""
    if sharding.ep_dim(name) is not None:
        return "ep_shard"
    if sharding.tp_dim(name) is None or tp == 1:
        return "replicated"
    return "tp_shard"


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
                        help="ranks the parameters, gradients and "
                             "optimizer state are sharded over")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel axis (requires --moe-"
                             "experts divisible by ep)")
    parser.add_argument("--moe-experts", type=int, default=0,
                        help="replace every moe-every'th MLP with N "
                             "routed experts (0 = dense)")
    parser.add_argument("--moe-every", type=int, default=2)
    parser.add_argument("--int8", action="store_true",
                        help="int8 matmuls for projections/MLP "
                             "(QAT straight-through backward)")
    parser.add_argument("--fused-norm", action="store_true",
                        help="fuse each RMSNorm into the projection after "
                             "it (bench_transformer's fused_norm)")
    parser.add_argument("--no-remat", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--profile-steps", type=int, default=0,
                        help="then profile this many steps on the card "
                             "(trace/train_profile)")
    checkpoint.add_checkpoint_args(parser)
    args = parser.parse_args(argv)

    ctx = distributed.setup(args.device)
    device = ctx["device"]
    check_mesh_sizes(args, ctx["process_count"])
    mesh = mesh_mod.RankMesh.build(
        device, tp=args.tp, sp=args.sp, fsdp=args.fsdp, ep=args.ep,
        roles=mesh_mod.MOE_ROLES if args.moe_experts else
        tuple(mesh_mod.GROUP_AXES))
    config = train_mod.make_transformer_config(
        mesh=mesh, vocab_size=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        d_head=args.d_model // args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.seq_len, dtype=torch.bfloat16,
        quantize_matmuls=args.int8, fused_norm=args.fused_norm,
        moe=moe_config(args.moe_experts, args.d_model, args.d_ff),
        moe_every=args.moe_every, remat=not args.no_remat)
    harness = train_mod.build_transformer_train(
        config, batch_size=args.batch, seq_len=args.seq_len,
        seed=args.seed, device=device, mesh=mesh)
    batch = random_batch(args.vocab, args.batch, args.seq_len, args.seed,
                         device)
    on_card = device.type == "cuda"
    tokens = args.batch * args.seq_len
    result = train_loop.run(ctx, args, harness, lambda: batch,
                            {"tokens": tokens}, mesh,
                            counters={"launches": launch_counts})
    rank = {
        "rank": ctx["process_index"], "coords": mesh.coords,
        "launches": {key: n for key, n in launch_counts().items() if n},
        "launches_per_step": {key: n for key, n in
                              result.per_step["launches"].items() if n},
        "plain_calls": {key: n for key, n in plain_counts().items() if n},
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if on_card else None),
        "resident_param_bytes": harness.resident_param_bytes,
        "params_sha256": param_digests(harness),
    }
    if config.moe is not None:
        rank["moe_dropped_share"] = dropped_shares(harness.model)
    ranks = train_loop.gather_ranks(ctx, args, result, harness, rank,
                                    lambda: batch, mesh)
    if ctx["process_index"] != 0:
        return result.status
    tokens_per_sec = tokens * result.steps / result.elapsed
    ms_per_step = result.elapsed / result.steps * 1000
    distributed.log(ctx, (
        f"transformer: mesh={mesh.sizes} device={device} "
        f"{tokens_per_sec:.0f} tok/s, loss={result.loss:.4f}, "
        f"{ms_per_step:.1f} ms/step"))
    peak = mfu.peak_bf16_tflops(torch.cuda.get_device_name(device)
                                if on_card else "cpu")
    report = {
        "device": torch.cuda.get_device_name(device) if on_card
        else "cpu",
        "mesh": mesh.sizes, "ranks_per_card": (
            mesh.world // max(torch.cuda.device_count(), 1) if on_card
            else None),
        "tokens_per_sec": tokens_per_sec, "ms_per_step": ms_per_step,
        "loss": result.loss, "losses": result.losses,
        "mfu_pct": mfu.mfu_pct(
            tokens_per_sec,
            mfu.transformer_train_flops_per_token(
                config, args.seq_len, batch_size=args.batch),
            peak),
        "peak_mem_gb": ranks[0]["peak_mem_gb"],
        "resident_param_bytes": ranks[0]["resident_param_bytes"],
        "per_rank": ranks,
        **train_loop.report_fields(args, result),
    }
    if "checkpoint" in report:
        report["read_fraction"] = report["checkpoint"]["read_fraction"]
    print(json.dumps(report), flush=True)
    return result.status


if __name__ == "__main__":
    raise SystemExit(main())
