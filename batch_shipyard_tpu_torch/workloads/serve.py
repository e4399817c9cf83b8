"""Serving workload: HTTP front end over the port's continuous-batching
engine, with an optional built-in Poisson load benchmark.

Counterpart of batch_shipyard_tpu/workloads/serve.py with the same
flags for what the port carries, plus ``--device {cuda,cpu}``:

    python -m batch_shipyard_tpu_torch.workloads.serve \
        --d-model 1024 --n-layers 12 --n-heads 16 --d-ff 2816 \
        --num-slots 8 --max-decode-len 512 --kv-page-size 64 \
        --loadgen 48 --rate 16 --prompt-len 64 128 --gen-tokens 64 128 \
        --report latency_report.json

Weights are drawn from ``--seed`` (models/convert.init_params). Without
--loadgen the server runs until terminated; with it, the benchmark runs
against the in-process server, writes the JSON report, prints it as
the last stdout line and exits nonzero if any request failed.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from batch_shipyard_tpu_torch.device import resolve_device
from batch_shipyard_tpu_torch.models import inference as inf
from batch_shipyard_tpu_torch.models import serving
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.models.convert import init_params
from batch_shipyard_tpu_torch.models.loadgen import run_load
from batch_shipyard_tpu_torch.models.server import ServingFrontEnd

# bench.py ``bench_serving``'s model and engine (the repo's serving
# benchmark), and the KV caches that reach the port's kernels: paged
# page 64 (K6), its ``serving_paged_int8`` variant (K7), dense int8
# (K8). chip_smoke.py and trace/decode_profile.py serve these.
BENCH_SERVING_MODEL = dict(vocab_size=32000, d_model=1024, n_layers=12,
                           n_heads=16, d_head=64, d_ff=2816)
BENCH_SERVING_SLOTS, BENCH_SERVING_MAX_LEN = 8, 512
BENCH_SERVING_KV_CACHES = {
    "paged": (None, dict(kv_page_size=64)),
    "paged_int8": ("int8", dict(kv_page_size=64, overcommit=True,
                                kv_num_pages=40)),
    "dense_int8": ("int8", {}),
}


def build_bench_engine(kv_cache: str, device,
                       seed: int = 0) -> serving.ContinuousBatcher:
    """The bench_serving engine in bf16 with weights drawn from
    ``seed``, on the named entry of BENCH_SERVING_KV_CACHES."""
    kv_dtype, kwargs = BENCH_SERVING_KV_CACHES[kv_cache]
    device = resolve_device(device)
    config = tfm.TransformerConfig(
        **BENCH_SERVING_MODEL, max_seq_len=BENCH_SERVING_MAX_LEN,
        dtype=torch.bfloat16, kv_cache_dtype=kv_dtype)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return serving.ContinuousBatcher(
        config, init_params(config, generator),
        num_slots=BENCH_SERVING_SLOTS,
        max_decode_len=BENCH_SERVING_MAX_LEN, device=device, **kwargs)


def build_config(args) -> tfm.TransformerConfig:
    return tfm.TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        d_head=args.d_model // args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.max_decode_len, dtype=torch.bfloat16,
        kv_cache_dtype=args.kv_cache_dtype)


def build_engine(args) -> serving.ContinuousBatcher:
    device = resolve_device(args.device)
    config = build_config(args)
    generator = torch.Generator(device=device)
    generator.manual_seed(args.seed)
    return serving.ContinuousBatcher(
        config, init_params(config, generator),
        num_slots=args.num_slots, max_decode_len=args.max_decode_len,
        sampling=inf.SamplingConfig(temperature=args.temperature,
                                    top_k=args.top_k),
        seed=args.seed, kv_page_size=args.kv_page_size,
        kv_num_pages=args.kv_num_pages, overcommit=args.overcommit,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=not args.no_prefix_cache, device=device)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", choices=("cuda", "cpu"),
                        default="cuda",
                        help="Run on the card (default) or, explicitly, "
                        "on the CPU")
    parser.add_argument("--d-model", type=int, default=256)
    parser.add_argument("--n-layers", type=int, default=4)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--d-ff", type=int, default=1024)
    parser.add_argument("--vocab", type=int, default=32000)
    parser.add_argument("--num-slots", type=int, default=8)
    parser.add_argument("--max-decode-len", type=int, default=512)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--kv-page-size", type=int, default=None)
    parser.add_argument("--kv-cache-dtype", default=None,
                        choices=["int8"],
                        help="Quantize the decode KV cache (dense or "
                        "paged pool) to int8")
    parser.add_argument("--kv-num-pages", type=int, default=None)
    parser.add_argument("--prefill-chunk", type=int, default=None,
                        help="Chunked prefill segment length (power of "
                        "two)")
    parser.add_argument("--overcommit", action="store_true")
    parser.add_argument("--no-prefix-cache", action="store_true",
                        help="Disable cross-request prefix reuse in the "
                        "paged pool")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8900)
    parser.add_argument("--max-inflight", type=int, default=None,
                        help="Cap accepted-but-unfinished requests; "
                        "excess gets 429")
    parser.add_argument("--io-timeout-s", type=float, default=None,
                        help="Per-connection socket read/write deadline")
    parser.add_argument("--loadgen", type=int, default=0,
                        help="Run N benchmark requests then exit")
    parser.add_argument("--rate", type=float, default=8.0,
                        help="Poisson arrival rate (req/s)")
    parser.add_argument("--shared-prefix-groups", type=int, default=0,
                        help="Loadgen shared prompt-prefix groups")
    parser.add_argument("--shared-prefix-len", type=int, default=0)
    parser.add_argument("--prompt-len", type=int, nargs=2,
                        default=(4, 32), metavar=("MIN", "MAX"))
    parser.add_argument("--gen-tokens", type=int, nargs=2,
                        default=(8, 32), metavar=("MIN", "MAX"))
    parser.add_argument("--report", default="latency_report.json")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    engine = build_engine(args)
    engine.warmup()
    front = ServingFrontEnd(engine, host=args.host, port=args.port,
                            max_inflight=args.max_inflight,
                            io_timeout_s=args.io_timeout_s).start()
    print(f"serving on {front.url} ({engine.device})", flush=True)
    if not args.loadgen:
        try:
            front._http_thread.join()
        except KeyboardInterrupt:
            pass
        finally:
            front.shutdown()
        return 0
    try:
        # One tiny request warms the HTTP dispatch path itself.
        front.generate({"prompt": [1, 2, 3], "max_new_tokens": 2})
        report = run_load(
            front.url, args.loadgen, rate_hz=args.rate,
            prompt_len=tuple(args.prompt_len),
            max_new_tokens=tuple(args.gen_tokens),
            vocab_size=args.vocab, seed=args.seed,
            shared_prefix_groups=args.shared_prefix_groups,
            shared_prefix_len=args.shared_prefix_len)
    finally:
        front.shutdown()
    prefix = engine.prefix_stats()
    if prefix is not None:
        report["prefix_cache"] = {
            key: prefix[key]
            for key in ("hit_tokens", "total_prompt_tokens", "hit_rate")}
    report["device"] = str(engine.device)
    with open(args.report, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report), flush=True)
    return 1 if report["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
