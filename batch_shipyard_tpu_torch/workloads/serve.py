"""Serving workload: HTTP front end over the port's continuous-batching
engine, with an optional built-in Poisson load benchmark.

Counterpart of batch_shipyard_tpu/workloads/serve.py with the same
flags for what the port carries, plus ``--device {cuda,cpu}``:

    python -m batch_shipyard_tpu_torch.workloads.serve \
        --d-model 1024 --n-layers 12 --n-heads 16 --d-ff 2816 \
        --num-slots 8 --max-decode-len 512 --kv-page-size 64 \
        --loadgen 48 --rate 16 --prompt-len 64 128 --gen-tokens 64 128 \
        --report latency_report.json

Weights are drawn from ``--seed`` (models/convert.init_params), or,
with ``--checkpoint-dir D``, restored from the latest committed step of
a train_transformer checkpoint saved on any mesh
(workloads/checkpoint.restore_params, the parameters only), cast to the
model's dtypes and checked against the model flags: a checkpoint whose
tensor names or shapes differ exits with the reference's message (a
fused_norm save is first re-laid out per projection,
models/convert.unfused_params). It prints ``serving checkpoint step N
from D``. Without --loadgen the server runs until terminated; with it, the benchmark runs
against the in-process server, writes the JSON report, prints it as
the last stdout line and exits nonzero if any request failed.

``--speculative`` serves with the engine's draft/verify loop
(models/serving.SpeculativeConfig, greedy only): a draft of
``--draft-d-model`` / ``--draft-n-layers`` / ``--draft-d-ff`` (default 3 x
its d_model) over the target's head count and vocabulary, with the
target's ``--kv-cache-dtype`` on its dense cache, weights from ``--seed``
+ 7 or restored from ``--draft-checkpoint-dir``; ``--gamma`` tokens
drafted a slot a step. The report then carries ``speculative`` (gamma,
proposed, accepted, acceptance_rate).

``--replicas N`` builds N engines over one parameter set (the tensors
live once on ``--device``), warms each in turn (every prefill bucket,
and on the card every graph, before any front end takes traffic),
starts N front ends on ephemeral loopback ports and the fleet router
(models/router.py) on ``--host/--port``; the report then carries the
router's stats, and ``prefix_cache`` and ``speculative`` summed over the
replicas. ``--slo-config default`` (or a JSON config file with a
``serving.slo`` section, config/slo.py) gives the front ends their SLO
classes and the engines their shed grace and stall factor
(``--shed-grace-ms`` / ``--tpot-stall-factor`` override); the load
generator then cycles through the classes. ``--arrival diurnal`` replays
the fleet simulator's day/night curve with ``--rate`` as its peak. A
preempt notice at ``$SHIPYARD_PREEMPT_REQUEST_FILE`` drains every front
end: no new admissions, decodes finish within ``--drain-grace-s``, the
router resumes the rest on a sibling.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Optional

import torch

from batch_shipyard_tpu_torch.config.slo import serving_slo_settings
from batch_shipyard_tpu_torch.device import resolve_device
from batch_shipyard_tpu_torch.models import inference as inf
from batch_shipyard_tpu_torch.models import serving
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.models.convert import (init_params,
                                                    unfused_params)
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
# bench.py ``bench_serving_speculative``: the same target, gamma 4, and a
# draft of d_model 256, 2 layers, the target's 16 heads (depth 16) and
# d_ff 3 x 256, weights from seed + 7, on a dense cache of the target's
# cache dtype. Its caches: dense (the bench's default), paged page 64
# (its kv_page_size variant) and paged int8, whose draft is on the dense
# int8 cache (K8 at depth 16). chip_smoke.py serves these.
BENCH_DRAFT_MODEL = dict(d_model=256, n_layers=2, n_heads=16, d_head=16,
                         d_ff=768)
BENCH_SPEC_GAMMA = 4
BENCH_SPECULATIVE_CACHES = {
    "dense": (None, {}),
    "paged": (None, dict(kv_page_size=64)),
    "paged_int8": ("int8", dict(kv_page_size=64)),
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
    return serving.ContinuousBatcher(
        config, bench_params(config, device, seed),
        num_slots=BENCH_SERVING_SLOTS,
        max_decode_len=BENCH_SERVING_MAX_LEN, device=device, **kwargs)


def bench_params(config: tfm.TransformerConfig, device, seed: int) -> dict:
    """``config``'s weights drawn from ``seed`` on ``device``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return init_params(config, generator)


def build_bench_speculative_engine(
        kv_cache: str, device, seed: int = 0,
        dtype: torch.dtype = torch.bfloat16,
        draft: Optional[tuple] = None) -> serving.ContinuousBatcher:
    """The bench_serving_speculative engine on the named entry of
    BENCH_SPECULATIVE_CACHES: the bench_serving target in ``dtype`` with
    weights from ``seed`` and the bench draft from ``seed`` + 7, or
    ``draft`` = (config, state dict) in its place."""
    kv_dtype, kwargs = BENCH_SPECULATIVE_CACHES[kv_cache]
    device = resolve_device(device)
    config = tfm.TransformerConfig(
        **BENCH_SERVING_MODEL, max_seq_len=BENCH_SERVING_MAX_LEN,
        dtype=dtype, kv_cache_dtype=kv_dtype)
    if draft is None:
        draft_config = tfm.TransformerConfig(
            vocab_size=BENCH_SERVING_MODEL["vocab_size"],
            **BENCH_DRAFT_MODEL, max_seq_len=BENCH_SERVING_MAX_LEN,
            dtype=dtype, kv_cache_dtype=kv_dtype)
        draft = (draft_config, bench_params(draft_config, device, seed + 7))
    return serving.ContinuousBatcher(
        config, bench_params(config, device, seed),
        num_slots=BENCH_SERVING_SLOTS,
        max_decode_len=BENCH_SERVING_MAX_LEN, device=device,
        speculative=serving.SpeculativeConfig(*draft,
                                              gamma=BENCH_SPEC_GAMMA),
        **kwargs)


def build_config(args) -> tfm.TransformerConfig:
    return tfm.TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads,
        d_head=args.d_model // args.n_heads, d_ff=args.d_ff,
        max_seq_len=args.max_decode_len, dtype=torch.bfloat16,
        kv_cache_dtype=args.kv_cache_dtype)


def restored_params(checkpoint_dir: str,
                    config: tfm.TransformerConfig) -> dict:
    """The parameters of the latest committed step in ``checkpoint_dir``,
    checked against ``config``'s names and shapes and cast to its
    dtypes; SystemExit with the reference's messages otherwise."""
    from batch_shipyard_tpu_torch.workloads import checkpoint
    restored = checkpoint.restore_params(checkpoint_dir)
    if restored is None:
        raise SystemExit(f"no checkpoint found in {checkpoint_dir}")
    params, step = restored
    want = tfm.TransformerLM(config, device="meta").state_dict()
    if set(params) != set(want):
        params = unfused_params(params)
    if set(params) != set(want):
        raise SystemExit("checkpoint params do not match the model "
                         "architecture flags (tree structure differs)")
    mismatched = [f"{name}: {tuple(t.shape)} != {tuple(params[name].shape)}"
                  for name, t in want.items()
                  if tuple(t.shape) != tuple(params[name].shape)]
    if mismatched:
        raise SystemExit("checkpoint params do not match the model "
                         "architecture flags (shape mismatch): "
                         + "; ".join(mismatched[:4]))
    print(f"serving checkpoint step {step} from {checkpoint_dir}",
          flush=True)
    return {name: params[name].to(t.dtype) for name, t in want.items()}


def build_params(args, config: tfm.TransformerConfig, device) -> dict:
    """``--checkpoint-dir``'s parameters, else weights drawn from
    ``--seed``."""
    if args.checkpoint_dir:
        return restored_params(args.checkpoint_dir, config)
    return bench_params(config, device, args.seed)


def build_draft(args, device) -> serving.SpeculativeConfig:
    """The draft for --speculative: a small dense-cache transformer over
    the target's head count and vocabulary, with the target's cache
    dtype; weights from --seed + 7, or --draft-checkpoint-dir's (a random
    draft is the worst case: near-zero acceptance, every round falls back
    to the target's correction token)."""
    draft_config = tfm.TransformerConfig(
        vocab_size=args.vocab, d_model=args.draft_d_model,
        n_layers=args.draft_n_layers, n_heads=args.n_heads,
        d_head=args.draft_d_model // args.n_heads,
        d_ff=args.draft_d_ff or args.draft_d_model * 3,
        max_seq_len=args.max_decode_len, dtype=torch.bfloat16,
        kv_cache_dtype=args.kv_cache_dtype)
    draft_args = argparse.Namespace(**vars(args))
    draft_args.seed = args.seed + 7
    draft_args.checkpoint_dir = args.draft_checkpoint_dir
    return serving.SpeculativeConfig(
        draft_config, build_params(draft_args, draft_config, device),
        gamma=args.gamma)


def build_slo(args):
    """The serving SLO configuration (config/slo.serving_slo_settings):
    ``--slo-config default`` the built-in classes, ``--slo-config PATH``
    a JSON config mapping with a serving.slo section, neither None (no
    SLO scheduling). ``--shed-grace-ms`` / ``--tpot-stall-factor``
    override the parsed values."""
    if not args.slo_config:
        return None
    if args.slo_config == "default":
        slo = serving_slo_settings(None)
    else:
        with open(args.slo_config, encoding="utf-8") as fh:
            slo = serving_slo_settings(json.load(fh))
    if args.shed_grace_ms is not None:
        slo = dataclasses.replace(slo, shed_grace_ms=args.shed_grace_ms)
    if args.tpot_stall_factor is not None:
        slo = dataclasses.replace(slo,
                                  tpot_stall_factor=args.tpot_stall_factor)
    return slo


def build_engine(args, config=None, params=None, speculative=None,
                 slo=None) -> serving.ContinuousBatcher:
    """One engine from the flags; ``config``, ``params`` and
    ``speculative`` default to the flags' (a fleet passes one set to
    every replica)."""
    device = resolve_device(args.device)
    if config is None:
        config = build_config(args)
    if params is None:
        params = build_params(args, config, device)
    if speculative is None and args.speculative:
        speculative = build_draft(args, device)
    return serving.ContinuousBatcher(
        config, params,
        num_slots=args.num_slots, max_decode_len=args.max_decode_len,
        sampling=inf.SamplingConfig(temperature=args.temperature,
                                    top_k=args.top_k),
        seed=args.seed, kv_page_size=args.kv_page_size,
        kv_num_pages=args.kv_num_pages, overcommit=args.overcommit,
        prefill_chunk=args.prefill_chunk,
        prefix_cache=not args.no_prefix_cache,
        slo_shed_grace_ms=slo.shed_grace_ms if slo else None,
        tpot_stall_factor=slo.tpot_stall_factor if slo else 4.0,
        device=device, speculative=speculative)


def warm_engine(engine: serving.ContinuousBatcher) -> list[int]:
    """Warm one engine before its front end takes traffic: every
    prefill bucket through throwaway requests, and on the card the
    decode graph and every prefill graph. Returns the buckets."""
    return engine.warmup()


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
    # Speculative decoding inside the engine: a small draft proposes
    # gamma tokens a slot a step, ONE target forward verifies every
    # slot's block, commits are ragged a slot. Greedy-exact: needs
    # --temperature 0.
    parser.add_argument("--speculative", action="store_true",
                        help="Enable engine-integrated speculative "
                        "decoding (draft/verify per engine step; "
                        "greedy-exact)")
    parser.add_argument("--gamma", type=int, default=4,
                        help="Draft tokens proposed per slot per engine "
                        "step")
    parser.add_argument("--draft-d-model", type=int, default=256)
    parser.add_argument("--draft-n-layers", type=int, default=2)
    parser.add_argument("--draft-d-ff", type=int, default=None,
                        help="Draft MLP width (default 3x draft-d-model)")
    parser.add_argument("--draft-checkpoint-dir", default=None,
                        help="serve the draft's parameters from the latest "
                        "committed step of a train_transformer checkpoint "
                        "dir (random from --seed + 7 otherwise)")
    parser.add_argument("--slo-config", default=None,
                        help="SLO scheduling: 'default' for the built-in "
                        "classes, or a JSON config file with a "
                        "serving.slo section")
    parser.add_argument("--shed-grace-ms", type=float, default=None,
                        help="Arm overload shedding: queued requests past "
                        "their TTFT deadline by this grace get 503 "
                        "(with --slo-config)")
    parser.add_argument("--tpot-stall-factor", type=float, default=None,
                        help="Admission defers prefills that would stall "
                        "active decodes past this multiple of the "
                        "tightest TPOT target")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8900)
    parser.add_argument("--max-inflight", type=int, default=None,
                        help="Cap accepted-but-unfinished requests per "
                        "replica; excess gets 429 (resumes are exempt)")
    parser.add_argument("--io-timeout-s", type=float, default=None,
                        help="Per-connection socket read/write deadline")
    parser.add_argument("--drain-grace-s", type=float, default=30.0,
                        help="On a preempt notice, let in-flight decodes "
                        "finish for this long before abandoning them to "
                        "a sibling's resume")
    parser.add_argument("--replicas", type=int, default=1,
                        help="Run N replica engines behind the fleet "
                        "router, which binds --host/--port")
    parser.add_argument("--loadgen", type=int, default=0,
                        help="Run N benchmark requests then exit")
    parser.add_argument("--rate", type=float, default=8.0,
                        help="Arrival rate (req/s; the diurnal peak)")
    parser.add_argument("--arrival", choices=("poisson", "diurnal"),
                        default="poisson",
                        help="Loadgen arrival process (diurnal replays "
                        "the fleet simulator's day/night curve)")
    parser.add_argument("--shared-prefix-groups", type=int, default=0,
                        help="Loadgen shared prompt-prefix groups")
    parser.add_argument("--shared-prefix-len", type=int, default=0)
    parser.add_argument("--prompt-len", type=int, nargs=2,
                        default=(4, 32), metavar=("MIN", "MAX"))
    parser.add_argument("--gen-tokens", type=int, nargs=2,
                        default=(8, 32), metavar=("MIN", "MAX"))
    parser.add_argument("--report", default="latency_report.json")
    parser.add_argument("--checkpoint-dir", default=None,
                        help="serve the parameters of the latest committed "
                        "step of a train_transformer checkpoint dir")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    slo = build_slo(args)
    slo_classes = slo.class_targets() if slo else None
    device = resolve_device(args.device)
    router = None
    if args.replicas > 1:
        from batch_shipyard_tpu_torch.models.router import ServingRouter
        # One parameter set on the device (and one draft) for every
        # replica: the engines share these tensors.
        config = build_config(args)
        params = {name: t.to(device) for name, t in
                  build_params(args, config, device).items()}
        speculative = build_draft(args, device) if args.speculative \
            else None
        engines = [build_engine(args, config, params, speculative, slo)
                   for _ in range(args.replicas)]
        # Every capture before any front end's engine thread runs.
        for engine in engines:
            warm_engine(engine)
        fronts = [ServingFrontEnd(engine, port=0, slo_classes=slo_classes,
                                  max_inflight=args.max_inflight,
                                  io_timeout_s=args.io_timeout_s,
                                  drain_grace_s=args.drain_grace_s).start()
                  for engine in engines]
        router = ServingRouter([f.url for f in fronts], host=args.host,
                               port=args.port).start()
        url = router.url
        print(f"fleet router on {url} over {len(fronts)} replica(s) "
              f"({device})", flush=True)
    else:
        engine = build_engine(args, slo=slo)
        warm_engine(engine)
        fronts = [ServingFrontEnd(engine, host=args.host, port=args.port,
                                  slo_classes=slo_classes,
                                  max_inflight=args.max_inflight,
                                  io_timeout_s=args.io_timeout_s,
                                  drain_grace_s=args.drain_grace_s).start()]
        url = fronts[0].url
        print(f"serving on {url} ({device})", flush=True)
    for front in fronts:
        front.arm_preempt_drain(grace_s=args.drain_grace_s)

    def shutdown():
        if router is not None:
            router.shutdown()
        for front in fronts:
            front.shutdown()

    if not args.loadgen:
        try:
            fronts[0]._http_thread.join()
        except KeyboardInterrupt:
            pass
        finally:
            shutdown()
        return 0
    try:
        # One tiny request a front end warms the HTTP path itself.
        for front in fronts:
            front.generate({"prompt": [1, 2, 3], "max_new_tokens": 2})
        report = run_load(
            url, args.loadgen, rate_hz=args.rate,
            prompt_len=tuple(args.prompt_len),
            max_new_tokens=tuple(args.gen_tokens),
            vocab_size=args.vocab, seed=args.seed, arrival=args.arrival,
            shared_prefix_groups=args.shared_prefix_groups,
            shared_prefix_len=args.shared_prefix_len,
            slo_classes=slo_classes)
        if router is not None:
            report["router"] = router.stats()
    finally:
        shutdown()
    prefix = [f.engine.prefix_stats() for f in fronts]
    if any(prefix):
        hits = sum(p["hit_tokens"] for p in prefix if p)
        total = sum(p["total_prompt_tokens"] for p in prefix if p)
        report["prefix_cache"] = {
            "hit_tokens": hits, "total_prompt_tokens": total,
            "hit_rate": hits / total if total else 0.0}
    if args.speculative:
        spec = [f.engine.spec_stats() for f in fronts]
        proposed = sum(s["proposed"] for s in spec)
        accepted = sum(s["accepted"] for s in spec)
        report["speculative"] = {
            "gamma": args.gamma, "proposed": proposed,
            "accepted": accepted,
            "acceptance_rate": accepted / proposed if proposed else 0.0}
    report["device"] = str(device)
    with open(args.report, "w", encoding="utf-8") as fh:
        json.dump(report, fh, indent=2)
    print(json.dumps(report), flush=True)
    return 1 if report["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
