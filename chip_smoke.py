#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (batch_shipyard_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build the decode-attention kernels from ops/csrc with nvcc (sm_90a);
  2. hold each kernel against its plain PyTorch version on the card:
     ragged lengths (1, a page boundary, a full slot, 0), random block
     tables and a NaN-poisoned dead table tail or cache tail; then time
     kernel, plain version and a scaled_dot_product_attention yardstick
     at the serving shape (8 slots x 16 heads x 64 dims, 512 keys);
  3. serve the repo's serving benchmark model (bench.py bench_serving:
     vocab 32000, d_model 1024, 12 layers, 16 heads, d_ff 2816, bf16,
     8 slots, max_decode_len 512, random weights from a fixed seed)
     three times through ServingFrontEnd + run_load: paged page 64 (K6),
     paged int8 with overcommit over 40 pages (K7), dense int8 (K8).
     Each run must finish every request, must launch its kernel once
     per layer per decode step and no other kernel, and must agree with
     the plain attention in a teacher-forced decode of the same tokens.

The last two stdout lines are the {"kernels": [...]} summary and
{"ok": true, "device": {...}}. Exits nonzero, printing no result, when
no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from batch_shipyard_tpu_torch.models import inference as inf
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.models.loadgen import run_load
from batch_shipyard_tpu_torch.models.server import ServingFrontEnd
from batch_shipyard_tpu_torch.models.serving import ContinuousBatcher
from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops import decode_attention as dense_ops
from batch_shipyard_tpu_torch.ops import paged_attention as paged_ops
from batch_shipyard_tpu_torch.ops.quantization import quantize_int8_rows
from batch_shipyard_tpu_torch.workloads.serve import (
    BENCH_SERVING_KV_CACHES, BENCH_SERVING_MAX_LEN as MAX_LEN,
    BENCH_SERVING_MODEL as MODEL, BENCH_SERVING_SLOTS as SLOTS,
    build_bench_engine)

PAGE = BENCH_SERVING_KV_CACHES["paged"][1]["kv_page_size"]
# Published H100 SXM peaks (NVIDIA data sheet, dense): memory rate and
# the operation rate for each input type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12,
            torch.int8: 1979e12}
# Kernel vs plain version: fp32 differs only in summation order; bf16
# rounds p (and the output) at other points; int8 with bf16 queries:
# the kernel dequantizes to fp32, the plain version to bf16.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Teacher-forced decode logits, as RMS over the RMS logit. bf16
# activations through 12 layers of random weights move the logits by a
# few percent from an fp32 model with the same weights (BF16_FLOOR_MAX
# bounds that floor, so a broken fp32 reference cannot pass). The
# kernel model may differ from the plain bf16 model, and from the fp32
# model, by at most FP32_SLACK times that floor.
BF16_FLOOR_MAX = 0.1
FP32_SLACK = 1.25

KERNELS = {
    "paged_decode": dict(
        label="K6", route="cuda",
        source="batch_shipyard_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="batch_shipyard_tpu/ops/paged_attention.py:78"),
    "paged_decode_int8": dict(
        label="K7", route="cuda",
        source="batch_shipyard_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="batch_shipyard_tpu/ops/paged_attention.py:104"),
    "dense_decode_int8": dict(
        label="K8", route="cuda",
        source="batch_shipyard_tpu_torch/ops/csrc/decode_attention.cu",
        replaces="batch_shipyard_tpu/ops/decode_attention.py:46"),
}


class SmokeFailure(Exception):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def launch_counts() -> dict:
    return {**paged_ops.launches, **dense_ops.launches}


def reset_launch_counts() -> None:
    for counts in (paged_ops.launches, dense_ops.launches):
        for key in counts:
            counts[key] = 0


# ------------------------------ inputs -------------------------------


def paged_case(rng, lengths, heads, depth, page, max_blocks, q_dtype,
               int8, device):
    """Random pool with every slot's live pages drawn without
    replacement. Returns ((q, k_pages, v_pages), lengths, scale kwargs,
    clean table, poisoned table): the clean table's dead tail points at
    a finite stale page, the poisoned one's at a page of NaNs the
    kernel must never read."""
    batch = len(lengths)
    num_pages = batch * max_blocks + 2
    stale, nan_page = num_pages - 2, num_pages - 1
    shape = (num_pages, page, heads, depth)
    k = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    v = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
    k[nan_page] = float("nan")
    v[nan_page] = float("nan")
    q = torch.from_numpy(rng.standard_normal((batch, 1, heads, depth),
                                             dtype=np.float32))
    table = np.full((batch, max_blocks), stale, np.int32)
    poisoned = np.full((batch, max_blocks), nan_page, np.int32)
    order = rng.permutation(batch * max_blocks)
    for b, n in enumerate(lengths):
        live = -(-n // page)
        table[b, :live] = poisoned[b, :live] = order[
            b * max_blocks:b * max_blocks + live]
    kwargs = {}
    if int8:
        k, ks = quantize_int8_rows(k)
        v, vs = quantize_int8_rows(v)
        kwargs = dict(k_scales=ks.to(device), v_scales=vs.to(device))
    else:
        k, v = k.to(q_dtype), v.to(q_dtype)
    args = (q.to(q_dtype).to(device), k.to(device), v.to(device))
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return (args, lens, kwargs, torch.from_numpy(table).to(device),
            torch.from_numpy(poisoned).to(device))


def dense_case(rng, lengths, heads, depth, rows, q_dtype, device):
    """Random int8 dense cache. Returns (q, k, v, clean scales,
    poisoned scales, lengths): the poisoned scales are NaN on every row
    at or past each slot's length."""
    batch = len(lengths)
    shape = (batch, rows, heads, depth)
    k, ks = quantize_int8_rows(torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)))
    v, vs = quantize_int8_rows(torch.from_numpy(
        rng.standard_normal(shape, dtype=np.float32)))
    q = torch.from_numpy(rng.standard_normal((batch, 1, heads, depth),
                                             dtype=np.float32))
    ks_p, vs_p = ks.clone(), vs.clone()
    for b, n in enumerate(lengths):
        ks_p[b, n:] = float("nan")
        vs_p[b, n:] = float("nan")
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    to = [t.to(device) for t in (k, v, ks, vs, ks_p, vs_p)]
    return (q.to(q_dtype).to(device), *to, lens)


# ------------------------------ checks -------------------------------


def check_result(name, got, want, poisoned, lengths, tol) -> float:
    torch.cuda.synchronize()
    require(torch.equal(got, poisoned),
            f"{name}: output changed when the dead tail held NaNs")
    live = lengths > 0
    require(bool(torch.isfinite(got[live]).all()),
            f"{name}: non-finite output")
    require(not bool(got[~live].any()),
            f"{name}: a length-0 slot did not return zeros")
    err = float((got.float() - want.float()).abs().max())
    require(err <= tol, f"{name}: max |kernel - plain| {err:.3g} > {tol}")
    return err


def check_kernels(device) -> None:
    """Phase 2a: every kernel against its plain version on ragged cases,
    at D=64 (the served model) and D=128."""
    rng = np.random.default_rng(0)
    lengths = [1, PAGE, PAGE + 1, MAX_LEN, 0, 200, 333, 17]
    max_blocks = MAX_LEN // PAGE
    for depth in (64, 128):
        for q_dtype in (torch.float32, torch.bfloat16):
            for int8 in (False, True):
                name = (f"paged{'_int8' if int8 else ''} D={depth} "
                        f"q={str(q_dtype)[6:]}")
                args, lens, kw, table, poisoned = paged_case(
                    rng, lengths, 4, depth, PAGE, max_blocks, q_dtype,
                    int8, device)
                got = paged_ops.paged_decode_attention_kernel(
                    *args, table, lens, **kw)
                bad = paged_ops.paged_decode_attention_kernel(
                    *args, poisoned, lens, **kw)
                want = paged_ops.paged_decode_attention_reference(
                    *args, table, lens, **kw)
                err = check_result(name, got, want, bad, lens,
                                   TOL[q_dtype])
                print(f"check {name}: max_abs_err {err:.3g} "
                      f"(tol {TOL[q_dtype]})")
            name = f"dense_int8 D={depth} q={str(q_dtype)[6:]}"
            q, k, v, ks, vs, ks_p, vs_p, lens = dense_case(
                rng, lengths, 4, depth, MAX_LEN, q_dtype, device)
            got = dense_ops.dense_decode_attention_kernel(
                q, k, v, ks, vs, lens)
            bad = dense_ops.dense_decode_attention_kernel(
                q, k, v, ks_p, vs_p, lens)
            want = dense_ops.dense_decode_attention_reference(
                q, k, v, ks, vs, lens)
            err = check_result(name, got, want, bad, lens, TOL[q_dtype])
            print(f"check {name}: max_abs_err {err:.3g} "
                  f"(tol {TOL[q_dtype]})")


# ------------------------------ timing -------------------------------


def device_ms(fn, sets, iters: int) -> float:
    """Device time per call of fn(*sets[i % len(sets)]), from CUDA
    events around ``iters`` calls queued behind a spin kernel, so the
    host's enqueue cost stays off the clock. Fails if the host had not
    finished queueing before the timed region began."""
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 3e9 cycles a second of host time: at least 1.5 s of spin per
    # second of queueing at the H100's clocks.
    torch.cuda._sleep(int(3e9 * host_s) + 1_000_000)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    require(not start.query(), "timing: the host fell behind the card")
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(lengths, heads, depth, kv_dtype, q_dtype, page=None) -> dict:
    """Least time for the work these inputs need: each live K/V row (and
    int8 scale) read once, q read and the output written once, the live
    block-table entries and lengths read once; 4*D operations per live
    (slot, head, key). The larger of bytes / HBM rate and operations /
    the peak rate of the cache's type."""
    kv_elt = torch.empty((), dtype=kv_dtype).element_size()
    q_elt = torch.empty((), dtype=q_dtype).element_size()
    keys = sum(lengths)
    nbytes = keys * heads * depth * 2 * kv_elt
    if kv_dtype == torch.int8:
        nbytes += keys * heads * 2 * 4
    nbytes += 2 * len(lengths) * heads * depth * q_elt + len(lengths) * 4
    if page:
        nbytes += sum(-(-n // page) for n in lengths) * 4
    ops = keys * heads * depth * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS[kv_dtype] * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "ops": ops}


def sdpa_view(rows, scales=None):
    """[B, L, H, D] rows (int8 with [B, L, H] scales, or bf16) -> the
    bf16 [B, H, L, D] layout scaled_dot_product_attention takes."""
    if scales is not None:
        rows = rows.float() * scales[..., None]
    return rows.to(torch.bfloat16).transpose(1, 2).contiguous()


def measure(kernel, plain, sets, lib_sets, **bound_kwargs) -> dict:
    """Check kernel against plain on the first set, then time kernel,
    plain (on 4 sets, still past L2) and the SDPA yardstick."""
    got, want = kernel(*sets[0]), plain(*sets[0])
    err = float((got.float() - want.float()).abs().max())
    require(err <= TOL[torch.bfloat16],
            f"{kernel.__name__}: max |kernel - plain| {err}")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return dict(max_abs_err=err, ms=device_ms(kernel, sets, 96),
                plain_ms=device_ms(plain, sets[:4], 16),
                library_ms=device_ms(sdpa, lib_sets, 96),
                **bound(**bound_kwargs))


def time_kernels(device) -> dict:
    """Phase 2b: kernel, plain version and the SDPA yardstick at the
    serving shape, all slots full (512 keys). Inputs cycle through
    n_layers distinct sets, as a decode step does, so the 50 MB L2
    cannot hold them across calls."""
    batch, heads, depth = SLOTS, MODEL["n_heads"], MODEL["d_head"]
    lengths = [MAX_LEN] * batch
    shape = dict(lengths=lengths, heads=heads, depth=depth,
                 q_dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    out = {}
    for key, int8 in (("paged_decode", False),
                      ("paged_decode_int8", True)):
        sets, lib_sets = [], []
        for _ in range(MODEL["n_layers"]):
            (q, kp, vp), lens, kw, table, _ = paged_case(
                rng, lengths, heads, depth, PAGE, MAX_LEN // PAGE,
                torch.bfloat16, int8, device)
            ks, vs = kw.get("k_scales"), kw.get("v_scales")
            sets.append((q, kp, vp, table, lens, ks, vs))
            flat = table.long()

            def gathered(pages, scales):
                rows = pages[flat].reshape(batch, MAX_LEN, heads, depth)
                if scales is not None:
                    scales = scales[flat].reshape(batch, MAX_LEN, heads)
                return sdpa_view(rows, scales)
            lib_sets.append((sdpa_view(q), gathered(kp, ks),
                             gathered(vp, vs)))
        out[key] = measure(
            paged_ops.paged_decode_attention_kernel,
            paged_ops.paged_decode_attention_reference, sets, lib_sets,
            kv_dtype=torch.int8 if int8 else torch.bfloat16, page=PAGE,
            **shape)
        del sets, lib_sets
    sets, lib_sets = [], []
    for _ in range(MODEL["n_layers"]):
        q, k, v, ks, vs, _, _, lens = dense_case(
            rng, lengths, heads, depth, MAX_LEN, torch.bfloat16, device)
        sets.append((q, k, v, ks, vs, lens))
        lib_sets.append((sdpa_view(q), sdpa_view(k, ks), sdpa_view(v, vs)))
    out["dense_decode_int8"] = measure(
        dense_ops.dense_decode_attention_kernel,
        dense_ops.dense_decode_attention_reference, sets, lib_sets,
        kv_dtype=torch.int8, **shape)
    for key, row in out.items():
        print(f"time {KERNELS[key]['label']} {key}: kernel "
              f"{row['ms'] * 1e3:.2f} us, plain {row['plain_ms'] * 1e3:.2f}"
              f" us, sdpa {row['library_ms'] * 1e3:.2f} us, bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
              f"{row['bytes']} B)")
    return out


# ------------------------------ serving ------------------------------


# BENCH_SERVING_KV_CACHES entry -> the kernel it must launch.
SERVED = (("paged", "paged_decode"), ("paged_int8", "paged_decode_int8"),
          ("dense_int8", "dense_decode_int8"))


def _copy_model(engine, **overrides) -> tfm.TransformerLM:
    cfg = dataclasses.replace(engine.config, **overrides)
    model = tfm.TransformerLM(cfg, device="meta")
    model.load_state_dict({k: t.to(cfg.dtype if t.dtype == torch.bfloat16
                                   else t.dtype)
                           for k, t in engine.model.state_dict().items()},
                          assign=True)
    return model.eval()


def _rel(got, want, reduce) -> float:
    return float(reduce((got - want).abs()) / reduce(want.abs()))


def teacher_forced(engine: ContinuousBatcher, steps: int = 96) -> dict:
    """Feed the same random tokens, every slot at its own depth (slot b
    starts at 9*b, so pages and lengths are ragged), through three
    models with the engine's weights: the engine's own (kernels), a
    copy on the plain attention, and an fp32 copy on the plain
    attention. Returns the kernel-vs-plain logit difference and each
    bf16 model's distance from the fp32 one, as RMS and max over all
    steps relative to the RMS and max of the reference logits."""
    plain_impl = dict(paged_attention_impl="reference",
                      decode_attention_impl="reference")
    cfg = engine.config
    models = (engine.model, _copy_model(engine, **plain_impl),
              _copy_model(engine, dtype=torch.float32, **plain_impl))
    batch = engine.num_slots
    rng = np.random.default_rng(2)
    starts = np.arange(batch, dtype=np.int32) * 9
    caches = [inf.init_cache(m, batch) for m in models]
    dev = engine.device
    start_t = torch.from_numpy(starts).to(dev)
    for cache in caches:
        for layer in cache:
            layer["length" if cfg.kv_page_size else "index"].copy_(start_t)
    if cfg.kv_page_size:
        scratch = cfg.kv_num_pages - 1
        live = -(-(int(starts.max()) + steps) // PAGE)
        order = rng.permutation(scratch)[:batch * live]
        table = np.full((batch, MAX_LEN // PAGE), scratch, np.int32)
        table[:, :live] = order.reshape(batch, live)
        for cache in caches:
            cache[0]["block_table"].copy_(torch.from_numpy(table))
    tokens = rng.integers(0, cfg.vocab_size, (steps, batch))
    logits = [[], [], []]
    with torch.no_grad():
        for t in range(steps):
            tok = torch.from_numpy(tokens[t, :, None]).to(dev)
            pos = (start_t + t)[:, None]
            for out, m, c in zip(logits, models, caches):
                out.append(m(tok, positions=pos, cache=c)[:, 0].float())
    kernel, plain, exact = (torch.cat(out) for out in logits)
    require(bool(torch.isfinite(kernel).all()),
            "teacher-forced: non-finite logits")

    def rms(x):
        return x.square().mean().sqrt()
    return {
        "kernel_vs_plain_rms": _rel(kernel, plain, rms),
        "kernel_vs_plain_max": _rel(kernel, plain, torch.amax),
        "kernel_vs_fp32_rms": _rel(kernel, exact, rms),
        "plain_vs_fp32_rms": _rel(plain, exact, rms),
    }


def serve(name, kernel, device) -> dict:
    """Phase 3: one served configuration, end to end."""
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    engine = build_bench_engine(name, device)
    engine.warmup()
    front = ServingFrontEnd(engine, port=0).start()
    try:
        front.generate({"prompt": [1, 2, 3], "max_new_tokens": 2})
        # bench_serving's profile for max_decode_len 512.
        report = run_load(front.url, 8, rate_hz=16.0,
                          prompt_len=(64, 128), max_new_tokens=(64, 128),
                          vocab_size=MODEL["vocab_size"], seed=0)
    finally:
        front.shutdown()
    torch.cuda.synchronize()
    counts = launch_counts()
    require(report["completed"] == 8 and report["failed"] == 0,
            f"{name}: {report['failed']} failed: {report.get('errors')}")
    require(counts[kernel] > 0, f"{name}: {kernel} never launched")
    others = {k: n for k, n in counts.items() if k != kernel and n}
    require(not others, f"{name}: unexpected launches {others}")
    per_step = counts[kernel] / engine.decode_steps
    require(per_step == MODEL["n_layers"],
            f"{name}: {per_step} launches per decode step")
    forced = teacher_forced(engine)
    floor = forced["plain_vs_fp32_rms"]
    require(floor <= BF16_FLOOR_MAX,
            f"{name}: plain bf16 vs fp32 logits {forced}")
    require(forced["kernel_vs_fp32_rms"] <= FP32_SLACK * floor and
            forced["kernel_vs_plain_rms"] <= FP32_SLACK * floor,
            f"{name}: the kernel path is off by more than bf16 "
            f"rounding: {forced}")
    row = {
        "config": name, "kernel": kernel, "launches": counts[kernel],
        "decode_steps": engine.decode_steps,
        "launches_per_decode_step": per_step,
        "completed": report["completed"], "failed": report["failed"],
        "preemptions": engine.preemptions,
        "ttft_ms": report["ttft_exact_ms"],
        "tpot_ms": report["tpot_exact_ms"],
        "tokens_per_second": report["tokens_per_second"],
        "step_ms": engine.slo_stats()["step_ms"],
        "teacher_forced": forced,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print("serve " + json.dumps(row), flush=True)
    return row


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = nvidia_smi()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    path, seconds = _build.build("decode_attention", force=True)
    print(f"build {path.name}: {seconds:.1f} s", flush=True)
    for line in path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas " + line.strip())

    check_kernels(device)
    timing = time_kernels(device)

    served = {}
    for name, kernel in SERVED:
        served[kernel] = serve(name, kernel, device)

    kernels = []
    for key, meta in KERNELS.items():
        t = timing[key]
        kernels.append({
            "name": f"{meta['label']} {key}", "route": meta["route"],
            "source": meta["source"], "replaces": meta["replaces"],
            "launches": served[key]["launches"],
            "launches_per_decode_step":
                served[key]["launches_per_decode_step"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
