"""The decode-attention kernels (K6 bf16 pages, K7 int8 pages, K8 the
dense int8 cache) over key lengths, on the card.

    python -m batch_shipyard_tpu_torch.trace.decode_sweep \
        [--source NAME=PATH ...] [--dense-variant SPLITSxTILE ...] \
        [--iters 240]

Times ``ops.paged_attention.paged_decode_attention_kernel`` and
``ops.decode_attention.dense_decode_attention_kernel`` at the serving
shape (8 slots x 16 heads x 64, bf16 queries, pages of 64 and a 512-key
block table, or a 512-row dense cache) with every slot at each length of
LENGTHS, and at the serve load's ragged lengths (SERVED: each input set
draws 8 lengths from 64-256 keys, the lengths bench_serving's
64-128-token prompts and 64-128 new tokens pass through). Each reading:
CUDA events around ``--iters`` calls over 12 input sets (one a layer, so
the 50 MB L2 does not hold them), queued behind a spin kernel so the
host's enqueue cost stays off the clock; µs per call. Runs the repo's
build of csrc/decode_attention.cu, then each ``--source`` (an edited
copy of that file, or the file of an earlier tree, built beside it with
the same flags and called through the same wrappers; an earlier build
whose K8 entry point predates the cluster kernel is called through that
entry point's own signature), in turns. ``--dense-variant 2x128`` times
the repo's K8 again at 2 splits and units of 128 rows. Prints one JSON
line per library, with the card's name and power limit and each
cache's largest error against the plain version (one input set a
reading). Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops import decode_attention as dense_ops
from batch_shipyard_tpu_torch.ops import paged_attention as paged_ops

SLOTS, HEADS, DEPTH, PAGE, MAX_BLOCKS, SETS = 8, 16, 64, 64, 8, 12
LENGTHS = (32, 64, 104, 128, 160, 200, 256, 384, 512)
SERVED = (64, 257)


def make_dense_sets(rng, lengths_of) -> list:
    """SETS dense int8 input sets (q, k, v, k scales, v scales, lengths)
    over SLOTS x PAGE * MAX_BLOCKS rows; lengths_of(rng) gives each
    set's lengths."""
    shape = (SLOTS, PAGE * MAX_BLOCKS, HEADS, DEPTH)
    sets = []
    for _ in range(SETS):
        q = torch.randn((SLOTS, 1, HEADS, DEPTH), device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randint(-127, 128, shape, dtype=torch.int8,
                              device="cuda") for _ in range(2))
        ks, vs = (torch.rand(shape[:3], device="cuda") / 64 + 1e-3
                  for _ in range(2))
        lens = torch.tensor(lengths_of(rng), dtype=torch.int32,
                            device="cuda")
        sets.append((q, k, v, ks, vs, lens))
    return sets


def dense_caller(library, splits=None, tile_rows=None):
    """K8 through ``library`` (None: the repo's build). A build whose
    entry point predates the cluster kernel (no bs_dense_decode_plan)
    takes (device, q, k, v, k scales, v scales, lengths, out, batch,
    rows, heads, depth, q dtype, scale, stream)."""
    if library is None or hasattr(library, "bs_dense_decode_plan"):
        return lambda *args: dense_ops.dense_decode_attention_kernel(
            *args, library=library, splits=splits, tile_rows=tile_rows)
    fn = library.bs_dense_decode_attention_int8
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 +
                   [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int

    def call(q, k, v, ks, vs, lens):
        batch, _, heads, depth = q.shape
        out = torch.empty_like(q)
        _build.check(fn(
            q.device.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ks.data_ptr(), vs.data_ptr(), lens.data_ptr(), out.data_ptr(),
            batch, k.shape[1], heads, depth,
            dense_ops.DTYPE_CODES[q.dtype], 1.0 / depth ** 0.5,
            paged_ops.stream_handle(q.device)), "dense decode", library)
        return out
    return call


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


def reading(call, plain, make, iters: int) -> dict:
    """µs of ``call`` at each length of LENGTHS and at SERVED (inputs
    from make(rng, lengths_of)), and its largest error against
    ``plain``."""
    rng = np.random.default_rng(0)
    row, worst = {}, 0.0
    cases = [(str(n), lambda r, n=n: [n] * SLOTS) for n in LENGTHS]
    cases.append(("served", lambda r: r.integers(*SERVED, SLOTS).tolist()))
    for key, lengths_of in cases:
        sets = make(rng, lengths_of)
        got, want = call(*sets[0]), plain(*sets[0])
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        row[key] = device_us(call, sets, iters)
    return {"us": row, "max_abs_err": worst}


def sweep(library, iters: int, dense_variants=()) -> dict:
    kwargs = {} if library is None else {"library": library}

    def paged(q, k, v, table, lens, ks, vs):
        return paged_ops.paged_decode_attention_kernel(
            q, k, v, table, lens, ks, vs, **kwargs)

    def paged_plain(q, k, v, table, lens, ks, vs):
        return paged_ops.paged_decode_attention_reference(
            q, k, v, table, lens, k_scales=ks, v_scales=vs)
    out = {}
    for name, int8 in (("paged", False), ("paged_int8", True)):
        out[name] = reading(
            paged, paged_plain,
            lambda rng, lengths_of, int8=int8: make_sets(rng, lengths_of,
                                                         int8), iters)
    dense_plain = dense_ops.dense_decode_attention_reference
    out["dense_int8"] = reading(dense_caller(library), dense_plain,
                                make_dense_sets, iters)
    for variant in dense_variants:
        splits, tile_rows = (int(x) for x in variant.split("x"))
        out[f"dense_int8 {variant}"] = reading(
            dense_caller(library, splits, tile_rows), dense_plain,
            make_dense_sets, iters)
    return out


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", action="append", default=[],
                        metavar="NAME=PATH")
    parser.add_argument("--dense-variant", action="append", default=[],
                        metavar="SPLITSxTILE")
    parser.add_argument("--iters", type=int, default=240)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
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
            variants = args.dense_variant if lib is None else ()
            print(json.dumps({"library": name, "card": smi,
                              **sweep(lib, args.iters, variants)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
