"""The int8 matmul kernel (K11) at the int8 training path's shapes, on
the card.

    python -m batch_shipyard_tpu_torch.trace.int8_matmul_sweep \
        [--source NAME=PATH ...] [--iters 24]

Times ``ops.quantization.int8_matmul_kernel`` at one layer's seven
projections of bench_transformer(quantize=True) (x [32768, in] against
the [out, in] weights of q/k/v/o, gate/up and down: SHAPES) on random
int8 operands and scales, from the repo's build of csrc/quantization.cu
and from each ``--source`` (an edited copy, built beside it with the
same flags and called through the same wrapper), in turns: every build,
then every build again in reverse order. Each reading: CUDA events
around ``--iters`` calls over two x sets, queued behind a spin kernel
(decode_sweep.device_us); ms per call. Each build is held bit for bit
against ``int8_matmul_reference``. Prints one JSON line per shape with
the card's name and power limit, each build's two readings, and the
least time (bytes over 3.35 TB/s or operations over 1979 TOP/s, the
larger). Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import pathlib
import sys
import tempfile

import torch

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops import quantization as quant_ops
from batch_shipyard_tpu_torch.trace.decode_sweep import card, device_us
from batch_shipyard_tpu_torch.workloads import train_transformer as train_wl

_MODEL = train_wl.BENCH_TRANSFORMER_MODEL
ROWS = train_wl.BENCH_TRANSFORMER_BATCH * train_wl.BENCH_TRANSFORMER_SEQ
# (in features, out features) and how many of a layer's seven run there.
SHAPES = {"qkvo": ((_MODEL["d_model"], _MODEL["d_model"]), 4),
          "gate_up": ((_MODEL["d_model"], _MODEL["d_ff"]), 2),
          "down": ((_MODEL["d_ff"], _MODEL["d_model"]), 1)}
HBM_BYTES_PER_S, INT8_OPS_PER_S = 3.35e12, 1979e12


def operands(gen, rows: int, k: int) -> tuple:
    values = torch.randint(-127, 128, (rows, k), generator=gen,
                           dtype=torch.int8, device="cuda")
    scales = torch.rand(rows, 1, generator=gen, device="cuda") / 64 + 1e-3
    return values, scales


def bound_ms(k: int, n: int) -> float:
    nbytes = ROWS * k + n * k + 4 * ROWS + 4 * n + 4 * ROWS * n
    return max(nbytes / HBM_BYTES_PER_S, 2 * ROWS * k * n / INT8_OPS_PER_S) \
        * 1e3


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--source", action="append", default=[],
                        metavar="NAME=PATH")
    parser.add_argument("--iters", type=int, default=24)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_matmul_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    libraries = {"repo": None}
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(
                1 + len(args.source)) as pool:
        builds = [pool.submit(_build.build, "quantization")]
        for spec in args.source:
            name, path = spec.split("=", 1)
            target = pathlib.Path(tmp) / f"lib{name}.so"
            builds.append(pool.submit(_build.compile_source,
                                      pathlib.Path(path), target))
            libraries[name] = target
        for build in builds:
            build.result()
        libraries = {name: path and _build.load(path, "quantization")
                     for name, path in libraries.items()}
        gen = torch.Generator(device="cuda").manual_seed(0)
        for shape, ((k, n), count) in SHAPES.items():
            x_sets = [operands(gen, ROWS, k) for _ in range(2)]
            w = operands(gen, n, k)
            sets = [(*x, *w) for x in x_sets]
            want = quant_ops.int8_matmul_reference(*sets[0])
            row = {"shape": shape, "count": count, "card": smi,
                   "m_k_n": [ROWS, k, n], "bound_ms": bound_ms(k, n)}
            for turn in (list(libraries), list(reversed(list(libraries)))):
                for name in turn:
                    lib = libraries[name]

                    def call(*a, lib=lib):
                        return quant_ops.int8_matmul_kernel(*a, library=lib)
                    row.setdefault(name, []).append(
                        device_us(call, sets, args.iters) / 1e3)
                    if len(row[name]) == 1:
                        row[f"{name}_bit_exact"] = bool(torch.equal(
                            call(*sets[0]), want))
            print(json.dumps(row), flush=True)
            del x_sets, w, sets, want
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
