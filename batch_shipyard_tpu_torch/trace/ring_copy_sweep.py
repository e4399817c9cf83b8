"""K12's, K13's and K14's copy kernels, K15 and K16, over grid sizes, on
one card.

    python -m batch_shipyard_tpu_torch.trace.ring_copy_sweep \
        [--blocks 8,16,33,66,132,264,528,0] [--source NAME=PATH ...]

Times one copy of each kind the ring plans launch
(ops/ring_collectives.py ``_enqueue`` -> ``bs_ring_copy``), in one process
on local memory: no ring, so no waits, the copy alone. At the sp training
path's shapes (chip_smoke.py): K12's copy of a (K, V) pair
``PERMUTE_SHAPE`` bf16 (two segments), K13's copy of one rank's chunk
of the fp32 gradient bucket into its output row and its slot, and K14's
add of a partial and this rank's part of a chunk into a slot. Then K15
(``bs_virtual_all_gather``) and K16 (``bs_virtual_reduce_scatter``) at
chip_smoke's timing shape, ring 4 of one rank's chunk each (16-byte
units: K15's bulk, TMA, design; K16's one pass in registers). For each
grid (``0``: the grid the kernels size themselves): ms a call (CUDA
events over ``--iters`` launches after a warm-up; K16's queued behind a
spin kernel as chip_smoke.py's ``device_ms`` times it), GB/s of the
bytes read and written, and the same function computed by PyTorch as
the yardstick (K12, K13: two ``copy_``; K14: ``torch.add`` into the
slot; K15: ``repeat``; K16: ``view(...).sum(dim=0)`` over the members).
K16 is timed from the repo's build and from each ``--source`` (an edited
copy of csrc/ring_collectives.cu with the same entry points, built
beside it with the same flags), in turns: every build over the grids,
then again in reverse order. Each kernel's output is checked (K16's,
every build's, bit for bit against its plain version). Prints the
card's name and power limit, then one JSON line. CUDA only.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import sys
import tempfile

import torch

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops import ring_collectives as rc


def _ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--blocks", default="8,16,33,66,132,264,528,0")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--source", action="append", default=[],
                        metavar="NAME=PATH")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("ring_copy_sweep: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from batch_shipyard_tpu_torch.trace.decode_sweep import card
    print(card(), flush=True)
    device = torch.device("cuda")
    lib = _build.library("ring_collectives")
    flag = ctypes.POINTER(ctypes.c_int)()
    _build.check(lib.bs_ring_flag_alloc(0, ctypes.byref(flag)), "flag", lib)
    abort = torch.zeros(1, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream().cuda_stream
    k = torch.randn(chip_smoke.PERMUTE_SHAPE, device=device).to(torch.bfloat16)
    v = torch.randn_like(k)
    nbytes = k.numel() * k.element_size()
    slot = torch.empty(2 * nbytes, dtype=torch.uint8, device=device)
    chunk = torch.randn(chip_smoke.bucket_elems() // chip_smoke.SP,
                        device=device)
    cbytes = chunk.numel() * 4
    row = torch.empty_like(chunk)
    cslot = torch.empty_like(chunk)

    part = torch.randn_like(chunk)
    aslot = torch.empty_like(chunk)

    def permute(blocks):
        return lambda: _build.check(lib.bs_ring_copy(
            0, 0, k.data_ptr(), slot.data_ptr(), None, v.data_ptr(),
            slot.data_ptr() + nbytes, None, nbytes, 16, 0, None, 0, None, 0,
            flag, abort.data_ptr(), blocks, stream), "copy", lib)

    def gather(blocks):
        return lambda: _build.check(lib.bs_ring_copy(
            0, 1, chunk.data_ptr(), row.data_ptr(), cslot.data_ptr(), None,
            None, None, cbytes, 16, 0, None, 0, None, 0, flag,
            abort.data_ptr(), blocks, stream), "copy", lib)

    def add(blocks):
        return lambda: _build.check(lib.bs_ring_copy(
            0, 2, chunk.data_ptr(), aslot.data_ptr(), None, None, None,
            part.data_ptr(), cbytes, 16, 0, None, 0, None, 0, flag,
            abort.data_ptr(), blocks, stream), "add", lib)
    shards = torch.randn(chip_smoke.SP, chunk.numel(), device=device)
    gathered = shards.new_empty(chip_smoke.SP, shards.numel())
    sbytes = chunk.numel() * 4

    def virtual(blocks):
        return lambda: _build.check(lib.bs_virtual_all_gather(
            0, shards.data_ptr(), gathered.data_ptr(), sbytes,
            chip_smoke.SP, 16, blocks, stream), "K15", lib)
    k_out, v_out = torch.empty_like(k), torch.empty_like(v)

    def permute_copy_():
        k_out.copy_(k)
        v_out.copy_(v)

    def gather_copy_():
        row.copy_(chunk)
        cslot.copy_(chunk)

    def repeat():
        return shards.reshape(1, -1).repeat(chip_smoke.SP, 1)
    rows = {"ring_permute": {"bytes": 4 * nbytes,
                             "copy_ms": _ms(permute_copy_, args.iters)},
            "ring_all_gather": {"bytes": 3 * cbytes,
                                "copy_ms": _ms(gather_copy_, args.iters)},
            "ring_reduce_scatter": {
                "bytes": 3 * cbytes,
                "copy_ms": _ms(lambda: torch.add(chunk, part, out=aslot),
                               args.iters)},
            "virtual_all_gather": {
                "bytes": (1 + chip_smoke.SP) * shards.numel() * 4,
                "copy_ms": _ms(repeat, args.iters)}}
    kinds = (("ring_permute", permute), ("ring_all_gather", gather),
             ("ring_reduce_scatter", add), ("virtual_all_gather", virtual))
    grids = [int(b) for b in args.blocks.split(",")]
    for blocks in grids:
        for key, fn in kinds:
            ms = _ms(fn(blocks), args.iters)
            rows[key][f"blocks {blocks}"] = {
                "ms": ms, "gb_per_s": rows[key]["bytes"] / ms / 1e6}
    torch.cuda.synchronize()
    assert torch.equal(slot[:nbytes].view(torch.bfloat16).view_as(k), k)
    assert torch.equal(slot[nbytes:].view(torch.bfloat16).view_as(v), v)
    assert torch.equal(row, chunk) and torch.equal(cslot, chunk)
    assert torch.equal(aslot, chunk + part)
    assert torch.equal(gathered, repeat())
    assert flag[0] == 0 and int(abort) == 0
    lib.bs_ring_flag_free(flag)
    del k, v, slot, row, cslot, part, aslot, shards, gathered, k_out, v_out
    torch.cuda.empty_cache()
    rows["virtual_reduce_scatter"] = k16_rows(chunk, grids, args.source,
                                              args.iters)
    print(json.dumps(rows), flush=True)
    return 0


def k16_rows(chunk: torch.Tensor, grids: list, sources: list,
             iters: int) -> dict:
    """K16 at chip_smoke's timing shape (ring SP of ``chunk``'s size a
    member) over ``grids``, from the repo's build and each NAME=PATH of
    ``sources``, in turns, beside the member sum."""
    import chip_smoke
    sp = chip_smoke.SP
    members = torch.randn(sp, sp * chunk.numel(), device=chunk.device)
    reduced = members.new_empty(sp, chunk.numel())
    want = rc.ring_reduce_scatter_virtual_reference(
        members.view(sp, -1, 1)).view_as(reduced)
    stream = torch.cuda.current_stream().cuda_stream
    libs = {"repo": _build.library("ring_collectives")}
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(max(1, len(sources))) \
            as pool:
        built = {}
        for spec in sources:
            name, path = spec.split("=", 1)
            target = pathlib.Path(tmp) / f"lib{name}.so"
            built[name] = (target, pool.submit(
                _build.compile_source, pathlib.Path(path), target))
        for name, (target, done) in built.items():
            done.result()
            libs[name] = _build.load(target, "ring_collectives")

    def call(lib, blocks):
        _build.check(lib.bs_virtual_reduce_scatter(
            0, members.data_ptr(), reduced.data_ptr(), chunk.numel() * 4, sp,
            0, 16, blocks, stream), "K16", lib)
    out = {"bytes": (1 + sp) * reduced.numel() * 4,
           "copy_ms": chip_smoke.device_ms(
               lambda: members.view(sp, sp, -1).sum(dim=0), [()], iters)}
    for turn in (list(libs), list(reversed(list(libs)))):
        for name in turn:
            row = out.setdefault(name, {})
            for blocks in grids:
                ms = chip_smoke.device_ms(call, [(libs[name], blocks)], iters)
                row.setdefault(f"blocks {blocks}", []).append(ms)
            reduced.zero_()
            call(libs[name], 0)
            row["bit_exact"] = row.get("bit_exact", True) and bool(
                torch.equal(reduced, want))
    return out


if __name__ == "__main__":
    sys.exit(main())
