"""Transformer LM training payload on one device.

Counterpart of batch_shipyard_tpu/workloads/train_transformer.py for
the dense single-device path, with its flags and defaults (``--int8``:
int8 matmuls for every projection, a full-precision backward) plus
``--device {cuda,cpu}`` and ``--seed``:

    python -m batch_shipyard_tpu_torch.workloads.train_transformer \
        --seq-len 2048 --batch 8 --steps 20

Weights are drawn from ``--seed`` (models/convert.init_params); one
random batch of tokens and targets from ``np.random.RandomState(seed)``
is repeated every step, as in the reference. Prints the reference's
summary line, then one JSON line with tokens/s, ms/step, MFU (None off
a card in parallel/mfu's table) and peak device memory.

Not offered yet (ROADMAP): --tp/--sp/--fsdp/--ep, --moe-experts and the
checkpoint and compile-cache flags.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from batch_shipyard_tpu_torch.device import resolve_device
from batch_shipyard_tpu_torch.parallel import mfu
from batch_shipyard_tpu_torch.parallel import train as train_mod

# bench.py ``bench_transformer``'s model and batch (the repo's training
# benchmark): bf16 compute over fp32 parameters, no layer remat.
# chip_smoke.py trains this.
BENCH_TRANSFORMER_MODEL = dict(vocab_size=32000, d_model=1024, n_layers=12,
                               n_heads=16, d_head=64, d_ff=2816)
BENCH_TRANSFORMER_BATCH, BENCH_TRANSFORMER_SEQ = 16, 2048


def build_bench_harness(device, seed: int = 0,
                        batch_size: int = BENCH_TRANSFORMER_BATCH,
                        seq_len: int = BENCH_TRANSFORMER_SEQ,
                        fused_norm: bool = False, quantize: bool = False
                        ) -> train_mod.TrainHarness:
    """bench_transformer's model with weights drawn from ``seed``;
    ``fused_norm`` and ``quantize`` as bench_transformer(fused_norm=...,
    quantize=...)."""
    config = train_mod.make_transformer_config(
        **BENCH_TRANSFORMER_MODEL, max_seq_len=seq_len,
        dtype=torch.bfloat16, remat=False, fused_norm=fused_norm,
        quantize_matmuls=quantize)
    return train_mod.build_transformer_train(
        config, batch_size=batch_size, seq_len=seq_len, seed=seed,
        device=device)


def random_batch(vocab: int, batch: int, seq_len: int, seed: int,
                 device) -> dict:
    """Tokens, then targets, from np.random.RandomState(seed), as the
    reference's workload and bench_transformer draw them."""
    rng = np.random.RandomState(seed)
    return {name: torch.from_numpy(np.asarray(
        rng.randint(0, vocab, (batch, seq_len)), np.int32)).to(device)
        for name in ("tokens", "targets")}


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
    parser.add_argument("--int8", action="store_true",
                        help="int8 matmuls for projections/MLP "
                             "(QAT straight-through backward)")
    parser.add_argument("--no-remat", action="store_true")
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    config = train_mod.make_transformer_config(
        vocab_size=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        d_head=args.d_model // args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.seq_len, dtype=torch.bfloat16,
        quantize_matmuls=args.int8, remat=not args.no_remat)
    harness = train_mod.build_transformer_train(
        config, batch_size=args.batch, seq_len=args.seq_len,
        seed=args.seed, device=device)
    batch = random_batch(args.vocab, args.batch, args.seq_len, args.seed,
                         device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(args.warmup):
        float(harness.step(batch)["loss"])  # hard sync
    start = time.perf_counter()
    for _ in range(args.steps):
        metrics = harness.step(batch)
    loss = float(metrics["loss"])  # hard sync
    elapsed = time.perf_counter() - start
    tokens_per_sec = args.batch * args.seq_len * args.steps / elapsed
    ms_per_step = elapsed / args.steps * 1000
    print(f"transformer: device={device} {tokens_per_sec:.0f} tok/s, "
          f"loss={loss:.4f}, {ms_per_step:.1f} ms/step", flush=True)
    on_card = device.type == "cuda"
    peak = mfu.peak_bf16_tflops(torch.cuda.get_device_name(device)
                                if on_card else "cpu")
    print(json.dumps({
        "device": torch.cuda.get_device_name(device) if on_card
        else "cpu",
        "tokens_per_sec": tokens_per_sec, "ms_per_step": ms_per_step,
        "loss": loss,
        "mfu_pct": mfu.mfu_pct(
            tokens_per_sec,
            mfu.transformer_train_flops_per_token(config, args.seq_len),
            peak),
        "peak_mem_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                        if on_card else None),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
