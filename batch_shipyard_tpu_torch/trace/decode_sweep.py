"""The paged decode kernel (K6 bf16 pages, K7 int8 pages) over key
lengths, on the card.

    python -m batch_shipyard_tpu_torch.trace.decode_sweep \
        [--source NAME=PATH ...] [--iters 240]

Times ``ops.paged_attention.paged_decode_attention_kernel`` at the
serving shape (8 slots x 16 heads x 64, bf16 queries, pages of 64, a
512-key block table) with every slot at each length of LENGTHS, and at
the serve load's ragged lengths (SERVED: each input set draws 8 lengths
from 64-256 keys, the lengths bench_serving's 64-128-token prompts and
64-128 new tokens pass through). Each reading: CUDA events around
``--iters`` calls over 12 input sets (one a layer, so the 50 MB L2 does
not hold them), queued behind a spin kernel so the host's enqueue cost
stays off the clock; µs per call. Runs the repo's build of
csrc/decode_attention.cu, then each ``--source`` (an edited copy of that
file, built beside it with the same flags and called through the same
wrapper), in turns. Prints one JSON line per library, with the card's
name and power limit and each cache's largest error against the plain
version (one input set a reading). Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops import paged_attention as paged_ops

SLOTS, HEADS, DEPTH, PAGE, MAX_BLOCKS, SETS = 8, 16, 64, 64, 8, 12
LENGTHS = (32, 64, 104, 128, 160, 200, 256, 384, 512)
SERVED = (64, 257)


def make_sets(rng, lengths_of, int8: bool) -> list:
    """SETS input sets; lengths_of(rng) gives each set's lengths."""
    sets = []
    num_pages = SLOTS * MAX_BLOCKS + 1
    shape = (num_pages, PAGE, HEADS, DEPTH)
    for _ in range(SETS):
        q = torch.randn((SLOTS, 1, HEADS, DEPTH), device="cuda").to(
            torch.bfloat16)
        if int8:
            k, v = (torch.randint(-127, 128, shape, dtype=torch.int8,
                                  device="cuda") for _ in range(2))
            scales = [torch.rand(shape[:3], device="cuda") / 64 + 1e-3
                      for _ in range(2)]
        else:
            k, v = (torch.randn(shape, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
            scales = [None, None]
        table = torch.from_numpy(
            rng.permutation(num_pages - 1)[:SLOTS * MAX_BLOCKS].reshape(
                SLOTS, MAX_BLOCKS).astype(np.int32)).cuda()
        lens = torch.tensor(lengths_of(rng), dtype=torch.int32,
                            device="cuda")
        sets.append((q, k, v, table, lens, *scales))
    return sets


def device_us(fn, sets, iters: int) -> float:
    for s in sets:
        fn(*s)
    torch.cuda.synchronize()
    started = time.perf_counter()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - started
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(3e9 * host_s * 4) + 1_000_000)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    behind = start.query()
    end.synchronize()
    if behind:
        raise RuntimeError("the host fell behind the card")
    return start.elapsed_time(end) * 1e3 / iters


def sweep(library, iters: int) -> dict:
    kwargs = {} if library is None else {"library": library}

    def call(q, k, v, table, lens, ks, vs):
        return paged_ops.paged_decode_attention_kernel(
            q, k, v, table, lens, ks, vs, **kwargs)

    def err(q, k, v, table, lens, ks, vs):
        want = paged_ops.paged_decode_attention_reference(
            q, k, v, table, lens, k_scales=ks, v_scales=vs)
        got = call(q, k, v, table, lens, ks, vs)
        return float((got.float() - want.float()).abs().max())
    out = {}
    for name, int8 in (("paged", False), ("paged_int8", True)):
        rng = np.random.default_rng(0)
        row, worst = {}, 0.0
        cases = [(str(n), lambda r, n=n: [n] * SLOTS) for n in LENGTHS]
        cases.append(("served",
                      lambda r: r.integers(*SERVED, SLOTS).tolist()))
        for key, lengths_of in cases:
            sets = make_sets(rng, lengths_of, int8)
            worst = max(worst, err(*sets[0]))
            row[key] = device_us(call, sets, iters)
        out[name] = {"us": row, "max_abs_err": worst}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", action="append", default=[],
                        metavar="NAME=PATH")
    parser.add_argument("--iters", type=int, default=240)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    libraries = [("repo", None)]
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(
                1 + len(args.source)) as pool:
        # One nvcc a library, all started together.
        builds = [pool.submit(_build.build, "decode_attention")]
        for spec in args.source:
            name, path = spec.split("=", 1)
            target = pathlib.Path(tmp) / f"lib{name}.so"
            builds.append(pool.submit(_build.compile_source,
                                      pathlib.Path(path), target))
            libraries.append((name, target))
        for build in builds:
            build.result()
        for name, lib in libraries:
            if lib is not None:
                lib = _build.load(lib, "decode_attention")
            print(json.dumps({"library": name, "card": smi,
                              **sweep(lib, args.iters)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
