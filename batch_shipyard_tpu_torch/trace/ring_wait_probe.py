"""Does a rank that waits on a neighbour give the card to a rank that has
work?

    python -m batch_shipyard_tpu_torch.trace.ring_wait_probe \
        [--size 8192] [--gemms 100]

Two processes share one card (``workloads/distributed.launch_local``),
each with its own context, which the card time-slices. Process A runs a
fixed loop of bf16 GEMMs [size, size] @ [size, size] and times it with
CUDA events. Process B meanwhile waits for a word in A's ring pad (a
``RingGroup`` buffer that B maps by CUDA IPC), which A raises with a
stream-ordered write after its loop, in turn:

- ``spin``: the in-kernel wait the ring kernels used to make, one
  512-thread block per SM spinning with ``__nanosleep``
  (``spin_wait_kernel``);
- ``stream``: a stream-ordered ``cuStreamWaitValue64(..., GEQ)`` on the
  IPC-mapped word, so B's only pending work is a wait in its stream's
  front end;
- ``event``: ``cudaStreamWaitEvent`` on A's interprocess event, which A
  records after its loop before B enqueues the wait (such a wait follows
  the event's last record at enqueue time, not a given epoch, so it
  cannot stand for the ring's epochs without a host handshake);
- ``idle``: B waits nowhere (first and last, for the spread).

After each wait B writes a word in A's pad through its mapping (a
stream-ordered write into peer memory), and A's stream waits for it,
so each round also checks the remote write. The reading is A's ms per
GEMM in each case: a wait that frees the card reads as ``idle``. Prints
the card's name and power limit, then one JSON line. CUDA only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time

import torch
import torch.distributed as dist

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.parallel import mesh
from batch_shipyard_tpu_torch.workloads import distributed

MODES = ("idle", "spin", "stream", "event", "idle")
SPEC_ENV = "RING_WAIT_PROBE"
TIMEOUT_S = 60.0
ROUND_LIMIT_S = 120.0


def _word(buf: mesh.SymmetricBuffer, rank: int, field: str) -> int:
    return buf.peer(rank) + 8 * mesh.PAD_FIELDS.index(field)


def _drain(stream: torch.cuda.Stream, what: str) -> None:
    """Wait for ``stream`` on the host, failing after ROUND_LIMIT_S
    instead of hanging (a wait that is never released)."""
    done = torch.cuda.Event()
    done.record(stream)
    deadline = time.monotonic() + ROUND_LIMIT_S
    while not done.query():
        if time.monotonic() > deadline:
            raise RuntimeError(f"ring wait probe: {what} not released "
                               f"within {ROUND_LIMIT_S} s")
        time.sleep(0.001)


def rank_main() -> None:
    spec = json.loads(os.environ[SPEC_ENV])
    ctx = distributed.setup()
    device = ctx["device"]
    dev = device.index or 0
    group = mesh.RingGroup(device=device, timeout_s=TIMEOUT_S)
    lib = group.library
    buf = group.buffer("probe", 256)
    me = group.rank
    stream = torch.cuda.current_stream(device)
    handle = stream.cuda_stream
    ready, consumed = _word(buf, 0, "ready0"), _word(buf, 0, "consumed0")
    supported = ctypes.c_int()
    _build.check(lib.bs_stream_mem_ops(dev, ctypes.byref(supported)),
                 mesh.STREAM_MEM_OPS, lib)
    attr = {mesh.STREAM_MEM_OPS: supported.value}
    if me == 0:
        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn(spec["size"], spec["size"], generator=gen,
                        device=device).to(torch.bfloat16)
        w = torch.randn(spec["size"], spec["size"], generator=gen,
                        device=device).to(torch.bfloat16)
        for _ in range(5):
            x @ w
        event = torch.cuda.Event(interprocess=True)
        event.record(stream)
        ipc = event.ipc_handle()
    else:
        ipc = None
    handles = [None, None]
    dist.all_gather_object(handles, ipc)
    if me == 1:
        event = torch.cuda.Event.from_ipc_handle(device, handles[0])
    torch.cuda.synchronize()
    readings = []
    for round_, mode in enumerate(MODES):
        value = round_ + 1
        if me == 0:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)

            def gemms():
                start.record(stream)
                for _ in range(spec["gemms"]):
                    x @ w
                end.record(stream)
            if mode == "event":
                gemms()
                event.record(stream)
                dist.barrier()  # B enqueues its wait after the record
            else:
                dist.barrier()  # B's wait is enqueued
                gemms()
            _build.check(lib.bs_stream_write(dev, ready, value, handle),
                         "probe write", lib)
            _build.check(lib.bs_stream_wait(dev, consumed, value, handle),
                         "probe wait", lib)
            _drain(stream, f"{mode}: B's remote write")
            readings.append({"mode": mode,
                             "ms_per_gemm": start.elapsed_time(end) /
                             spec["gemms"]})
        else:
            if mode == "spin":
                _build.check(lib.bs_ring_spin_wait(
                    dev, ready, value, group.error, group.timeout_ns,
                    _word(buf, 1, "wait_ns"), handle), "probe spin", lib)
            elif mode == "stream":
                _build.check(lib.bs_stream_wait(dev, ready, value, handle),
                             "probe wait", lib)
            dist.barrier()
            if mode == "event":
                stream.wait_event(event)
            _build.check(lib.bs_stream_write(dev, consumed, value, handle),
                         "probe remote write", lib)
            _drain(stream, f"{mode}: B's wait")
        dist.barrier()
    group.check()
    group.close()
    print("PROBE " + json.dumps({"rank": me, "attributes": attr,
                                 "readings": readings}), flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=8192)
    parser.add_argument("--gemms", type=int, default=100)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ring_wait_probe: no CUDA device", file=sys.stderr)
        return 1
    from batch_shipyard_tpu_torch.trace.decode_sweep import card
    print(card(), flush=True)
    _build.build("ring_collectives")
    env = dict(os.environ, **{SPEC_ENV: json.dumps(vars(args))})
    runs = distributed.launch_local(
        [sys.executable, "-c",
         "from batch_shipyard_tpu_torch.trace import ring_wait_probe; "
         "ring_wait_probe.rank_main()"], 2, 600, env=env,
        cwd=_build.REPO_ROOT)
    out = {}
    for run in runs:
        line = next((ln for ln in run["stdout"].splitlines()
                     if ln.startswith("PROBE ")), None)
        if run["returncode"] != 0 or line is None:
            print(f"rank {run['rank']}: rc {run['returncode']} timed out "
                  f"{run['timed_out']}\n{run['stderr'][-3000:]}",
                  file=sys.stderr)
            return 1
        out[run["rank"]] = json.loads(line[len("PROBE "):])
    flops = 2 * args.size ** 3
    print(json.dumps({
        "size": args.size, "gemms": args.gemms,
        "attributes": out[0]["attributes"],
        "ms_per_gemm": [(r["mode"], r["ms_per_gemm"])
                        for r in out[0]["readings"]],
        "tflops": [(r["mode"], flops / r["ms_per_gemm"] / 1e9)
                   for r in out[0]["readings"]]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
