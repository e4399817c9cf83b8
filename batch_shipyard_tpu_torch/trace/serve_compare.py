"""The serving phase of two checkouts, in turns, on one card.

    python -m batch_shipyard_tpu_torch.trace.serve_compare TREE [TREE ...]

For each TREE in the order given (a checkout of this repo; name one
twice, as in ``parent change change parent``, to see the spread between
runs), runs in a fresh process from that tree, against its own code:
its ``chip_smoke.time_kernels`` (K6-K8 against SDPA and their bound),
its ``chip_smoke.serve`` for each entry of its ``chip_smoke.SERVED``
(bench_serving's engine under the same 8-request load: TTFT, TPOT,
tokens/s, step ms) and ``trace/decode_profile.py``'s ``run`` for each
cache (wall and device-busy ms of a pure decode step, idle share, the
attention kernel's share). Every line the child prints goes to stdout
after a ``TREE <path> <card>`` header. Both trees must offer these
names (the port's chip_smoke.py has, since the decode kernels came in).
Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

CHILD = """
import json, torch
import chip_smoke as smoke
from batch_shipyard_tpu_torch.trace import decode_profile
torch.backends.cuda.matmul.allow_tf32 = False
device = torch.device("cuda")
smoke.time_kernels(device)
for name, kernel in smoke.SERVED:
    smoke.serve(name, kernel, device)
for name, _ in smoke.SERVED:
    print("profile " + json.dumps(decode_profile.run(name, 16)), flush=True)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_compare: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    failed = 0
    for tree in args.trees:
        print(f"TREE {tree} {smi}", flush=True)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                              capture_output=True, text=True,
                              timeout=1200, check=False)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            failed += 1
            sys.stdout.write(proc.stderr[-4000:])
        sys.stdout.flush()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
