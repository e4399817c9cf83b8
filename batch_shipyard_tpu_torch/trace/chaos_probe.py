"""Where chip_smoke.py's chaos leg (x) spends its time, and what its
cold-engine check guards against, on one card.

    python -m batch_shipyard_tpu_torch.trace.chaos_probe \
        [--what start,graph,cold,leg] [--tree .]

Each part runs in fresh processes from TREE (a checkout of this repo),
with one bytecode cache under TREE/build/pycache as chip_smoke.py keeps,
and prints one JSON line after the card's name and power limit:

``start``: the kill drill's CLI process taken apart, each step a process
of its own: ``import torch`` (a cold and a warm bytecode cache), torch
with the card's context, the CLI's and the drills' modules, the serving
modules, then ``--raw chaos drill --serve-kill --seed 1`` twice, seconds
of wall each.

``graph``: chip_smoke's phase 6 decode-graph check (``decode_graph``,
every cache of ``SERVED``) at 2, 12 and again 2 layers
(``GRAPH_LAYERS``), seconds each: what running it at 2 of bench_serving's
12 layers saves on one host.

``cold``: chip_smoke's (x4) ``cold_engines`` (four un-warmed serving
engines stepped by four threads) three times with the serving engine's
device gate (``models/serving.py`` ``_DeviceGate``) replaced by one that
holds nothing, then twice with it: exit code, seconds and the error each.

``leg``: ``chip_smoke.chaos_leg`` alone, its rows and seconds.

Runs on CUDA only.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from batch_shipyard_tpu_torch.trace.decode_sweep import card

COLD_CHILD = """
import contextlib, json, sys, types, torch
import chip_smoke as smoke
from batch_shipyard_tpu_torch.models import serving
if sys.argv[1] == "off":
    serving._DEVICE_GATE = types.SimpleNamespace(
        shared=contextlib.nullcontext, exclusive=contextlib.nullcontext)
print(json.dumps(smoke.cold_engines(torch.device("cuda"))))
"""

GRAPH_CHILD = """
import json, time, torch
import chip_smoke as smoke
from batch_shipyard_tpu_torch.ops import _build
smoke.install_library(_build.build("decode_attention", True)[0])
out = {}
for layers in (2, 12, 2):
    smoke.GRAPH_LAYERS = layers
    for name, _ in smoke.SERVED:
        t0 = time.perf_counter()
        smoke.decode_graph(name, torch.device("cuda"))
        out.setdefault(f"{name}@{layers}", []).append(
            time.perf_counter() - t0)
print(json.dumps(out))
"""

LEG_CHILD = """
import json, time
import chip_smoke as smoke
t0 = time.perf_counter()
rows = smoke.chaos_leg(smoke.nvidia_smi())
print(json.dumps({"rows": rows, "seconds": time.perf_counter() - t0}))
"""


def _run(tree: str, argv: list, env: dict, timeout: float = 600.0):
    """(exit code, seconds, stdout, stderr) of one process from tree."""
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=tree, env=env, capture_output=True,
                          text=True, timeout=timeout)
    return (proc.returncode, time.perf_counter() - t0, proc.stdout,
            proc.stderr)


def _last_json(text: str):
    lines = [line for line in text.splitlines() if line.startswith("{")]
    return json.loads(lines[-1]) if lines else None


def start(tree: str, env: dict) -> dict:
    py = sys.executable
    cli = [py, "-m", "batch_shipyard_tpu_torch.cli.main", "--raw", "chaos",
           "drill", "--serve-kill", "--seed", "1"]
    steps = [
        ("import torch (cold cache)", [py, "-c", "import torch"]),
        ("import torch (warm cache)", [py, "-c", "import torch"]),
        ("torch + CUDA init", [py, "-c", "import torch; torch.zeros(1, "
                               "device='cuda'); torch.cuda.synchronize()"]),
        ("cli + serving_drill modules", [
            py, "-c", "import batch_shipyard_tpu_torch.chaos.serving_drill,"
            " batch_shipyard_tpu_torch.cli.main"]),
        ("serving modules", [
            py, "-c", "import batch_shipyard_tpu_torch.models.serving, "
            "batch_shipyard_tpu_torch.models.server, "
            "batch_shipyard_tpu_torch.models.router"]),
        ("chaos drill --serve-kill", cli),
        ("chaos drill --serve-kill (again)", cli),
    ]
    out = {}
    for label, argv in steps:
        rc, seconds, _, err = _run(tree, argv, env)
        if rc:
            raise RuntimeError(f"{label}: exit {rc}\n{err[-2000:]}")
        out[label] = seconds
    return out


def graph(tree: str, env: dict) -> dict:
    rc, seconds, stdout, err = _run(
        tree, [sys.executable, "-c", GRAPH_CHILD], env)
    if rc:
        raise RuntimeError(f"graph: exit {rc}\n{err[-2000:]}")
    return {"decode_graph_s": _last_json(stdout), "seconds": seconds}


def cold(tree: str, env: dict) -> dict:
    runs = []
    for gate in ("off", "off", "off", "on", "on"):
        rc, seconds, stdout, err = _run(
            tree, [sys.executable, "-c", COLD_CHILD, gate], env, 300.0)
        errors = [line for line in err.splitlines()
                  if "Error" in line and "Traceback" not in line]
        runs.append({"gate": gate, "exit": rc, "seconds": seconds,
                     "row": _last_json(stdout),
                     "error": errors[-1][:300] if errors else None})
    return {"runs": runs}


def leg(tree: str, env: dict) -> dict:
    rc, seconds, stdout, err = _run(
        tree, [sys.executable, "-c", LEG_CHILD], env)
    if rc:
        raise RuntimeError(f"leg: exit {rc}\n{err[-3000:]}")
    return _last_json(stdout)


PARTS = {"start": start, "graph": graph, "cold": cold, "leg": leg}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--what", default="start,graph,cold,leg")
    parser.add_argument("--tree", default=".")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chaos_probe needs a CUDA device")
    tree = os.path.abspath(args.tree)
    # One bytecode cache for every process, as chip_smoke.py keeps.
    env = dict(os.environ, PYTHONPATH=tree,
               PYTHONPYCACHEPREFIX=os.path.join(tree, "build", "pycache"))
    env.pop("PYTHONDONTWRITEBYTECODE", None)
    smi = card()
    print(smi, flush=True)
    for part in args.what.split(","):
        row = PARTS[part](tree, env)
        print(f"{part} on {smi}: " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
