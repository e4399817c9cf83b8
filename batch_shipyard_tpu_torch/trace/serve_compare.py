"""The serving phase (or the int8, the sequence-parallel or the mesh
training phase) of two checkouts, in turns, on one card.

    python -m batch_shipyard_tpu_torch.trace.serve_compare \
        [--phase serve|train_int8|train_sp|train_mesh] TREE [TREE ...]

For each TREE in the order given (a checkout of this repo; name one
twice, as in ``parent change change parent``, to see the spread between
runs), runs in a fresh process from that tree, against its own code.
``serve`` (the default): its ``chip_smoke.time_kernels`` (K6-K8
against SDPA and their bound), its ``chip_smoke.serve`` for each entry
of its ``chip_smoke.SERVED`` (bench_serving's engine under the same
8-request load: TTFT, TPOT, tokens/s, step ms) and
``trace/decode_profile.py``'s ``run`` for each cache (wall and
device-busy ms of a pure decode step, idle share, the attention
kernel's share). ``train_int8``: its ``chip_smoke.train(quantize=True)``
(bench_transformer(quantize=True) with the fused loss selected by a
validation marker in a temp dir: ms a step, the kernels' launches and
the step's profile). ``train_sp``: its ``chip_smoke.train_sp`` (the
``--sp 4`` workload, four ranks on the card, under the same marker: ms a
step, every rank's launches, K12 ms and ring wait a step), after building
the kernels it runs once, so the four ranks do not each compile them.
``train_mesh``: the same, then its ``chip_smoke.train_mesh`` (the mesh
paths' ring calls against their plain versions, with a planted-fault
build of the ring kernels; the eight-rank recipe ``--sp 4 --tp 2`` held
against that train_sp run's losses, the dp x fsdp x sp run and the
killed-rank check).
Every line the child prints goes to stdout after a
``TREE <path> <card>`` header. Both trees must offer these names (the
port's chip_smoke.py has, since the decode kernels and the int8 kernels
came in). Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import subprocess
import sys

import torch

from batch_shipyard_tpu_torch.trace.decode_sweep import card

CHILD = {"serve": """
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
""", "train_int8": """
import json, os, pathlib, tempfile, torch
import chip_smoke as smoke
from batch_shipyard_tpu_torch.ops import chunked_loss, kernel_select
torch.backends.cuda.matmul.allow_tf32 = False
marker = pathlib.Path(tempfile.mkdtemp()) / "KERNEL_VALIDATION.json"
marker.write_text(json.dumps({chunked_loss.VALIDATION_NAME: {
    "ok": True, "backend": kernel_select.BACKEND}}))
os.environ[kernel_select.MARKER_ENV] = str(marker)
smoke.train(torch.device("cuda"), quantize=True)
""", "train_sp": """
import json, pathlib, tempfile, torch
import chip_smoke as smoke
from batch_shipyard_tpu_torch.ops import _build, chunked_loss, kernel_select
for name in ("flash_attention", "chunked_loss", "ring_collectives"):
    _build.build(name)
marker = pathlib.Path(tempfile.mkdtemp()) / "KERNEL_VALIDATION.json"
marker.write_text(json.dumps({chunked_loss.VALIDATION_NAME: {
    "ok": True, "backend": kernel_select.BACKEND}}))
smoke.train_sp(torch.device("cuda"), {kernel_select.MARKER_ENV: str(marker)})
""", "train_mesh": """
import json, pathlib, tempfile, torch
import chip_smoke as smoke
from batch_shipyard_tpu_torch.ops import _build, chunked_loss, kernel_select
for name in ("flash_attention", "chunked_loss", "ring_collectives"):
    _build.build(name)
marker = pathlib.Path(tempfile.mkdtemp()) / "KERNEL_VALIDATION.json"
marker.write_text(json.dumps({chunked_loss.VALIDATION_NAME: {
    "ok": True, "backend": kernel_select.BACKEND}}))
env = {kernel_select.MARKER_ENV: str(marker)}
sp = smoke.train_sp(torch.device("cuda"), env)
faults, _ = smoke.build_fault_library(pathlib.Path(tempfile.mkdtemp()),
                                      "ring_collectives")
smoke.train_mesh(torch.device("cuda"), env, sp["losses"], faults)
"""}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--phase", choices=sorted(CHILD), default="serve")
    parser.add_argument("trees", nargs="+")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_compare: no CUDA device", file=sys.stderr)
        return 1
    smi = card()
    failed = 0
    for tree in args.trees:
        print(f"TREE {tree} {smi}", flush=True)
        proc = subprocess.run([sys.executable, "-c", CHILD[args.phase]],
                              cwd=tree,
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
