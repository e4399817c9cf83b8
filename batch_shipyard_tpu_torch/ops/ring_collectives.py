"""Ring collectives: the ring permute of ring attention (K12), the ring
all-gather (K13) and reduce-scatter (K14), and their one-device schedules
(K15, K16).

Counterpart of batch_shipyard_tpu/ops/ring_collectives.py. The kernels are
``csrc/ring_collectives.cu`` (its head note gives the design: persistent
symmetric buffers mapped by CUDA IPC, a pull protocol on growing epoch
counters, a missing rank turned into an error). Each has a plain version
beside it, which CPU tensors take:

- ``ring_permute`` (K12): one +-1 ring rotation of a (K, V) pair over the
  group. ``ring_permute_pair`` is its autograd Function: the backward is
  the opposite shift, as the reference's custom_vjp.
- ``ring_all_gather`` (K13): a chunk [c, ...] from every rank ->
  [ring * c, ...] in rank order, the reference's ``lax.all_gather(tiled)``.
- ``ring_reduce_scatter`` (K14): [ring * c, ...] from every rank -> this
  rank's reduced chunk [c, ...], ``psum_scatter(tiled)``; the partials add
  in ring order (rs_chunk_index), in the kernel and the plain version alike.
- ``ring_all_gather_virtual`` / ``ring_reduce_scatter_virtual`` (K15,
  K16): the all-gather and reduce-scatter over ring members held on one
  device, pure functions of one tensor. Their plain versions run the
  reference's slot schedules; K15 is one pass over the shards
  (``virtual_gather_tiles``), K16 one pass over the members, adding in
  the schedule's order (``virtual_reduce_tiles``).

The reference's sequence-parallel path calls only K12; XLA inserts its
gradient and tensor-parallel collectives. The port has no XLA, so it
makes them from K13 and K14: ``ring_all_reduce`` is K14 then K13 (each
element summed once, in ring order, by the member that owns its chunk,
then copied to every member, so the result is bit-identical on every
member), which the Megatron operators (``tp_region_input``: f,
``tp_region_output``: g; models/transformer.py and the vocab-parallel
loss) run over the tp ring and parallel/train.py over the data ring.
Over the fsdp ring, ``fsdp_gather`` is the parameter gather of one fsdp
unit as an autograd Function: K13 of this rank's chunk into the unit's
flat, and in the backward K14 of the unit's gradient back to the chunk.

K12-K14 are plans. ``permute_plan``, ``all_gather_plan`` and
``reduce_scatter_plan`` list a call's stream operations in order:
``Wait`` (the stream waits until a pad word reaches a value), ``Copy``
(one launch of the call's copy kernel; K14's adds this rank's part of a
chunk on the way) and ``Write`` (the stream writes a pad word once the
copy is done). The wrappers issue them on the current stream
(``_enqueue``); the CPU tests run the same plans over a model of four
ranks' pads. A rank that waits holds no SM: on a card that time-slices
several ranks, the waiting rank's slices go to the ranks that have work.

K12-K14 take a ring group (parallel/mesh.RingGroup): its rank, size, gloo
subgroup and, on the card, its symmetric buffers, error word and
watchdog (a wait longer than the group's timeout sets the word;
``group.check()``, before each call and after a synchronise, raises). The
plain versions run the same schedule over the group's gloo subgroup with
isend/irecv to the global ranks of its members (gloo takes CPU tensors
only). On a CUDA tensor a wrapper launches its kernel or raises; nothing
falls back, and no NCCL or torch.distributed collective touches it.

What bounds them: bytes. Per call and rank, K12 reads its (K, V) pair and
writes the pair it receives; K13 reads its chunk and writes ring chunks;
K14 reads ring chunks and writes one. On one card that is those bytes over
the memory rate; across cards, the (ring - 1) chunks (K12: the pair) a
rank sends over NVLink. The staging slot doubles a rank's own writes
(pull design, see the .cu note).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops.paged_attention import stream_handle
from batch_shipyard_tpu_torch.parallel.mesh import SLOT_ALIGN, _round_up

# The kernel library (ops/_build.py) this module's wrappers launch.
LIBRARY = "ring_collectives"

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches (one per wrapper call; K12-K14 launch a copy kernel per
# Copy of their plan inside one call).
# chip_smoke.py zeroes and reads these.
launches = {"ring_permute": 0, "ring_all_gather": 0,
            "ring_reduce_scatter": 0, "virtual_all_gather": 0,
            "virtual_reduce_scatter": 0}
plain_calls = dict.fromkeys(launches, 0)
# The ring calls that launched their kernels, as "call.axis", the axis
# being the group's label (RingGroup.axis): each K12, K13 and K14 launch
# under its own name, and each ring_all_reduce, once its K14 and K13 are
# enqueued, under "ring_all_reduce" besides (e.g. "ring_all_reduce.tp").
axis_launches: dict = {}
# While a list (trace/train_profile sets one), every copy kernel a plan
# launches appends (kernel, axis): the device's ring kernels in stream
# order, for the profiler's per-axis times. Inside ``call_site(name)`` the
# axis is logged as "<axis>:<name>" (the vocab-parallel loss's merge, the
# int8 absmax gathers), so their time reads apart from the layers' calls
# on the same ring; the launch counts keep the plain axis.
copy_log = None
_site = None


@contextlib.contextmanager
def call_site(name: str):
    """Log the ring copy kernels launched inside under "<axis>:<name>"."""
    global _site
    outer, _site = _site, name
    try:
        yield
    finally:
        _site = outer


def _count_axis(call: str, axis: str) -> None:
    key = f"{call}.{axis}"
    axis_launches[key] = axis_launches.get(key, 0) + 1


# ---------------------------- schedule arithmetic -------------------------


def ag_source_shard(my_idx: int, step: int, ring: int) -> int:
    """All-gather: the shard that reaches ring member ``my_idx`` at step
    ``step`` (0-based) is the one member (my_idx - step - 1) % ring holds."""
    return (my_idx - step - 1) % ring


def rs_chunk_index(my_idx: int, step: int, ring: int) -> int:
    """Reduce-scatter: the chunk whose partial reaches ``my_idx`` at step
    ``step``; step -1 is the member's first send, (my_idx - 1) % ring. After
    ring - 1 steps member i holds chunk i reduced (psum_scatter's tiled
    layout)."""
    return (my_idx - step - 2) % ring


def copy_unit(*values: int) -> int:
    """The widest access (16, 8, 4, 2 or 1 bytes) that divides every size,
    offset and address given."""
    for unit in (16, 8, 4, 2, 1):
        if all(v % unit == 0 for v in values):
            return unit
    return 1


def permute_slot_bytes(nbytes: int) -> int:
    """K12's slot: K, then V at the next SLOT_ALIGN boundary."""
    return _round_up(nbytes, SLOT_ALIGN) + nbytes


def _vector(chunk_elems: int, dtype: torch.dtype, *tensors) -> int:
    """1 when 16-byte lanes of ``dtype`` fit every chunk and address."""
    lane = 16 // torch.empty((), dtype=dtype).element_size()
    return int(chunk_elems % lane == 0 and
               all(t.data_ptr() % 16 == 0 for t in tensors))


def _lib(library):
    return library or _build.library(LIBRARY)


# ------------------------- K12 and K13 as plans ---------------------------


@dataclasses.dataclass(frozen=True)
class Wait:
    """The stream waits until ``word`` (a pad field, e.g. "ready1") of
    ``rank``'s pad is >= ``value``."""
    rank: int
    word: str
    value: int


@dataclasses.dataclass(frozen=True)
class Write:
    """The stream writes ``value`` into ``word`` of ``rank``'s pad once
    the work before it is done."""
    rank: int
    word: str
    value: int


@dataclasses.dataclass(frozen=True)
class Copy:
    """One copy kernel from ``src`` to each of ``dsts``. An end is
    ("in",) the call's input, ("in", c) chunk c of it (K14), ("out", i)
    chunk i of the output (K12: the output pair) or ("slot", rank, s)
    slot s of ``rank``'s buffer. ``write``: the write number this copy
    puts into its own slot (0: none); ``read``: the write the peer slot it
    reads must hold. ``local`` (K14): an end added to ``src`` on the way,
    T(float(src) + float(local))."""
    src: tuple
    dsts: tuple
    write: int = 0
    read: int = 0
    local: tuple = None


def permute_plan(rank: int, ring: int, shift: int, epoch: int) -> list:
    """K12's call number ``epoch`` (from 1) of its buffer on ``rank``: the
    (K, V) pair into slot epoch % 2 once its previous content was read,
    raise ready; once the source rank r - shift raised its ready, pull
    its slot into the outputs and raise consumed on its pad."""
    s = epoch % 2
    src = (rank - shift) % ring
    plan = [Wait(rank, f"consumed{s}", epoch - 2)] if epoch > 2 else []
    return plan + [
        Copy(("in",), (("slot", rank, s),), write=epoch),
        Write(rank, f"ready{s}", epoch),
        Wait(src, f"ready{s}", epoch),
        Copy(("slot", src, s), (("out", 0),), read=epoch),
        Write(src, f"consumed{s}", epoch),
    ]


def all_gather_plan(rank: int, ring: int, base: int) -> list:
    """K13 on ``rank`` after ``base`` writes into its buffer: the own chunk
    to its output row and write base + 1's slot; at step t the left
    neighbour's write base + 1 + t (chunk ag_source_shard(rank, t)) is
    pulled into its output row and, but at the last step, forwarded as
    the own next write."""
    left = (rank - 1) % ring
    w = base + 1
    s = w % 2
    plan = [Wait(rank, f"consumed{s}", w - 2)] if w > 2 else []
    plan += [Copy(("in",), (("out", rank), ("slot", rank, s)), write=w),
             Write(rank, f"ready{s}", w)]
    for t in range(ring - 1):
        r = base + 1 + t
        rs = r % 2
        plan.append(Wait(left, f"ready{rs}", r))
        dsts = (("out", ag_source_shard(rank, t, ring)),)
        w = 0
        if t < ring - 2:
            w = r + 1
            s = w % 2
            if w > 2:
                plan.append(Wait(rank, f"consumed{s}", w - 2))
            dsts += (("slot", rank, s),)
        plan.append(Copy(("slot", left, rs), dsts, write=w, read=r))
        if w:
            plan.append(Write(rank, f"ready{s}", w))
        plan.append(Write(left, f"consumed{rs}", r))
    return plan


def reduce_scatter_plan(rank: int, ring: int, base: int) -> list:
    """K14 on ``rank`` after ``base`` writes into its buffer: this rank's
    part of chunk rs_chunk_index(rank, -1) into write base + 1's slot; at
    step t the left neighbour's write base + 1 + t (its partial of chunk
    rs_chunk_index(rank, t)) plus this rank's part of that chunk goes to
    the own next write or, at the last step, to the output."""
    left = (rank - 1) % ring
    w = base + 1
    s = w % 2
    plan = [Wait(rank, f"consumed{s}", w - 2)] if w > 2 else []
    plan += [Copy(("in", rs_chunk_index(rank, -1, ring)),
                  (("slot", rank, s),), write=w),
             Write(rank, f"ready{s}", w)]
    for t in range(ring - 1):
        r = base + 1 + t
        rs = r % 2
        plan.append(Wait(left, f"ready{rs}", r))
        dst, w = ("out", 0), 0
        if t < ring - 2:
            w = r + 1
            s = w % 2
            if w > 2:
                plan.append(Wait(rank, f"consumed{s}", w - 2))
            dst = ("slot", rank, s)
        plan.append(Copy(("slot", left, rs), (dst,), write=w, read=r,
                         local=("in", rs_chunk_index(rank, t, ring))))
        if w:
            plan.append(Write(rank, f"ready{s}", w))
        plan.append(Write(left, f"consumed{rs}", r))
    return plan


# bs_ring_copy's kernel argument: which __global__ a plan's copies launch
# (the profiler tells K12's, K13's and K14's time apart by it).
COPY_KERNELS = {"ring_permute": 0, "ring_all_gather": 1,
                "ring_reduce_scatter": 2}


def _enqueue(plan: list, group, buf, ends, nbytes: int, unit: int,
           kernel: str, lib, dtype: int = 0) -> None:
    """Enqueue ``plan`` on the current stream. ``ends(end)``: the
    addresses of one copy end, one per segment (K12: K and V). K14's adds
    are in elements of ``dtype`` (a DTYPE_CODES value)."""
    dev = group.device
    stream = torch.cuda.current_stream(dev)

    def at(end):
        if end[0] == "slot":
            return ends(end, buf.slot(end[1], end[2]))
        return ends(end, None)
    for op in plan:
        if isinstance(op, Wait):
            group.stream_wait(buf.word(op.rank, op.word), op.value, stream)
        elif isinstance(op, Write):
            group.stream_write(buf.word(op.rank, op.word), op.value, stream)
        else:
            src = at(op.src)
            dst = at(op.dsts[0])
            dst2 = at(op.dsts[1]) if len(op.dsts) > 1 else (None,)
            own = next((d for d in op.dsts if d[0] == "slot"), None)
            mark = buf.word(own[1], f"written{own[2]}") if own else None
            filled = (buf.word(op.src[1], f"written{op.src[2]}")
                      if op.read else None)
            local = at(op.local)[0] if op.local else None
            rc = lib.bs_ring_copy(
                dev.index or 0, COPY_KERNELS[kernel], src[0], dst[0],
                dst2[0], src[1] if len(src) > 1 else None,
                dst[1] if len(dst) > 1 else None, local, nbytes, unit,
                dtype, mark, op.write, filled, op.read, group.error,
                group.abort, 0, stream.cuda_stream)
            _build.check(rc, kernel.replace("_", " "), lib)
            if copy_log is not None:
                copy_log.append((kernel, group.axis if _site is None
                                 else f"{group.axis}:{_site}"))


def _check_cuda(name: str, t: torch.Tensor, group) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes CUDA tensors; CPU "
                         f"tensors go to the plain version")
    if t.device != group.device:
        raise ValueError(f"{name} is on {t.device}, the group on "
                         f"{group.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ---------------------- one-device schedules (K15, K16) -------------------


def _check_virtual(x: torch.Tensor, what: str) -> int:
    ring = x.shape[0]
    if ring < 2:
        raise ValueError(f"virtual ring needs >= 2 members, got {ring}")
    if x.dim() < 2:
        raise ValueError(f"{what} must be [ring, rows, ...], got "
                         f"{tuple(x.shape)}")
    return ring


def ring_all_gather_virtual_reference(x_shards: torch.Tensor
                                      ) -> torch.Tensor:
    """Plain version of K15: [ring, chunk, ...] -> [ring, ring * chunk, ...],
    row i what member i holds after the ring all-gather schedule, with
    members' [ring, 2, chunk, ...] slots as in the reference kernel."""
    plain_calls["virtual_all_gather"] += 1
    ring = _check_virtual(x_shards, "x_shards")
    chunk = x_shards.shape[1]
    out = x_shards.new_empty((ring, ring * chunk) + x_shards.shape[2:])
    comm = x_shards.new_empty((ring, 2) + x_shards.shape[1:])
    for i in range(ring):
        out[i, i * chunk:(i + 1) * chunk] = x_shards[i]
        comm[i, 0] = x_shards[i]
    for step in range(ring - 1):
        slot, nxt = step % 2, (step + 1) % 2
        for i in range(ring):
            comm[(i + 1) % ring, nxt] = comm[i, slot]
        if step > 0:
            for i in range(ring):
                src = ag_source_shard(i, step - 1, ring)
                out[i, src * chunk:(src + 1) * chunk] = comm[i, slot]
    for i in range(ring):
        src = ag_source_shard(i, ring - 2, ring)
        out[i, src * chunk:(src + 1) * chunk] = comm[i, (ring - 1) % 2]
    return out


def ring_reduce_scatter_virtual_reference(x_rows: torch.Tensor
                                          ) -> torch.Tensor:
    """Plain version of K16: [ring, ring * chunk, ...] -> [ring, chunk,
    ...], row i member i's chunk reduced in ring order: at each step a
    member adds its own part to the partial that arrived, in fp32, rounded
    to the input's type."""
    plain_calls["virtual_reduce_scatter"] += 1
    ring = _check_virtual(x_rows, "x_rows")
    if x_rows.shape[1] % ring:
        raise ValueError(f"row length {x_rows.shape[1]} must be divisible "
                         f"by the ring size {ring}")
    chunk = x_rows.shape[1] // ring

    def part(i, c):
        return x_rows[i, c * chunk:(c + 1) * chunk]
    comm = x_rows.new_empty((ring, 2, chunk) + x_rows.shape[2:])
    for i in range(ring):
        comm[i, 0] = part(i, rs_chunk_index(i, -1, ring))
    for step in range(ring - 1):
        slot, nxt = step % 2, (step + 1) % 2
        for i in range(ring):
            comm[(i + 1) % ring, nxt] = comm[i, slot]
        for i in range(ring):
            local = part(i, rs_chunk_index(i, step, ring))
            comm[i, nxt] = (comm[i, nxt].float() + local.float()).to(
                x_rows.dtype)
    return comm[:, (ring - 1) % 2].clone()


# K15's tile in copy units: csrc vgather::kTileUnits (kThreads x kUnroll),
# which the library reports (bs_virtual_gather_tile_units). A tile is
# VIRTUAL_TILE_UNITS x unit bytes: in 16-byte units, one 32 KB stage of
# the bulk design.
VIRTUAL_TILE_UNITS = 2048


def virtual_gather_tiles(nbytes: int, ring: int, tile: int):
    """K15's launch arithmetic: the ring shards of ``nbytes`` each, read as
    one run of ring * nbytes bytes in tiles of ``tile`` bytes (the last one
    ragged). Yields each tile's (source offset, bytes, output offsets): it
    is read once and stored at the same offset of every output row, row r
    starting at r * ring * nbytes, so row r's columns of shard s hold
    shard s."""
    total = ring * nbytes
    for start in range(0, total, tile):
        yield (start, min(tile, total - start),
               tuple(r * total + start for r in range(ring)))


# K16's tiles (csrc vreduce): the bulk design (16-byte units) stages one
# tile of every member in VIRTUAL_REDUCE_STAGE_BYTES of shared memory
# (kStageBytes), the register design tiles by VIRTUAL_REDUCE_TILE_UNITS
# (kTileUnits, kBlock x kUnroll).
VIRTUAL_REDUCE_STAGE_BYTES = 65536
VIRTUAL_REDUCE_TILE_UNITS = 1024


def virtual_reduce_tile_units(ring: int, unit: int) -> int:
    """K16's tile, in copy units of ``unit`` bytes, at ``ring`` members
    (csrc vreduce::tile_units; the library's
    bs_virtual_reduce_tile_units)."""
    if unit == 16 and ring <= VIRTUAL_REDUCE_STAGE_BYTES // 16:
        return VIRTUAL_REDUCE_STAGE_BYTES // (16 * ring)
    return VIRTUAL_REDUCE_TILE_UNITS


def virtual_reduce_tiles(elems: int, ring: int, tile: int):
    """K16's launch arithmetic: each output row j (member j's reduced
    chunk, ``elems`` elements) in tiles of ``tile`` elements (the
    virtual_reduce_tile_units of the unit, in elements), the last one of a
    row ragged; grid tile t is tile t % per_row of row t // per_row.
    Yields each tile's (row, offset, length, members): the tile's elements
    of chunk j are read once from each member and added in the order
    ``members`` lists, member j + 1 first (rs_chunk_index(j + 1, -1) is
    j), then j + 2, ..., j, as the slot schedule adds them."""
    per_row = -(-elems // tile)
    for t in range(ring * per_row):
        row, start = divmod(t, per_row)
        start *= tile
        yield (row, start, min(tile, elems - start),
               tuple((row + 1 + k) % ring for k in range(ring)))


def ring_all_gather_virtual_kernel(x_shards: torch.Tensor,
                                   library=None) -> torch.Tensor:
    """K15 on the card (any dtype: it copies bytes), one launch. The unit
    picks the design: the TMA bulk-copy design where shard bytes and
    addresses allow 16-byte units, the register design in narrower units
    (in 16-byte units the bulk design was the faster, 1.3160 against
    1.4562 ms at chip_smoke's timing shape, PERF.md)."""
    ring = _check_virtual(x_shards, "x_shards")
    if not x_shards.is_cuda or not x_shards.is_contiguous():
        raise ValueError("K15 takes a contiguous CUDA tensor")
    chunk = x_shards.shape[1]
    nbytes = x_shards[0].numel() * x_shards.element_size()
    out = x_shards.new_empty((ring, ring * chunk) + x_shards.shape[2:])
    lib = _lib(library)
    dev = x_shards.device
    unit = copy_unit(nbytes, x_shards.data_ptr(), out.data_ptr())
    rc = lib.bs_virtual_all_gather(dev.index or 0, x_shards.data_ptr(),
                                   out.data_ptr(), nbytes, ring, unit, 0,
                                   stream_handle(dev))
    _build.check(rc, "virtual ring all-gather", lib)
    launches["virtual_all_gather"] += 1
    return out


def ring_reduce_scatter_virtual_kernel(x_rows: torch.Tensor,
                                       library=None) -> torch.Tensor:
    """K16 on the card (fp32 or bf16), one launch and no scratch: each
    output unit read from the ring members once, added in the plain
    version's order and stored once (``virtual_reduce_tiles`` mirrors the
    tiling). The unit picks the design: the TMA bulk-copy design where
    the chunk's bytes and the addresses allow 16-byte units, the register
    design in 8-, 4- or bf16's 2-byte units (in 16-byte units the bulk
    design was the faster, 1.2596 against 1.5485 ms on the default grid
    at chip_smoke's timing shape, PERF.md)."""
    ring = _check_virtual(x_rows, "x_rows")
    if not x_rows.is_cuda or not x_rows.is_contiguous():
        raise ValueError("K16 takes a contiguous CUDA tensor")
    if x_rows.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {x_rows.dtype} not in {tuple(DTYPE_CODES)}")
    if x_rows.shape[1] % ring:
        raise ValueError(f"row length {x_rows.shape[1]} must be divisible "
                         f"by the ring size {ring}")
    chunk = x_rows.shape[1] // ring
    nbytes = chunk * math.prod(x_rows.shape[2:]) * x_rows.element_size()
    out = x_rows.new_empty((ring, chunk) + x_rows.shape[2:])
    lib = _lib(library)
    dev = x_rows.device
    unit = copy_unit(nbytes, x_rows.data_ptr(), out.data_ptr())
    rc = lib.bs_virtual_reduce_scatter(
        dev.index or 0, x_rows.data_ptr(), out.data_ptr(), nbytes, ring,
        DTYPE_CODES[x_rows.dtype], unit, 0, stream_handle(dev))
    _build.check(rc, "virtual ring reduce-scatter", lib)
    launches["virtual_reduce_scatter"] += 1
    return out


def ring_all_gather_virtual(x_shards: torch.Tensor) -> torch.Tensor:
    """The all-gather schedule over ``ring`` members on one device: K15
    for a CUDA tensor, its plain version for a CPU tensor."""
    if x_shards.is_cuda:
        return ring_all_gather_virtual_kernel(x_shards)
    return ring_all_gather_virtual_reference(x_shards)


def ring_reduce_scatter_virtual(x_rows: torch.Tensor) -> torch.Tensor:
    """The reduce-scatter schedule over ``ring`` members on one device:
    K16 for a CUDA tensor, its plain version for a CPU tensor."""
    if x_rows.is_cuda:
        return ring_reduce_scatter_virtual_kernel(x_rows)
    return ring_reduce_scatter_virtual_reference(x_rows)


# ------------------------- across ranks (K12-K14) -------------------------


def _exchange(group, send: torch.Tensor, dst: int, recv: torch.Tensor,
              src: int, tag: int = 0) -> list:
    """Post one send to member ``dst`` and one receive from member ``src``
    over the group's gloo subgroup (torch.distributed addresses them by
    global rank); returns the requests."""
    pg = group.process_group
    return [dist.isend(send, group.global_rank(dst), group=pg, tag=tag),
            dist.irecv(recv, group.global_rank(src), group=pg, tag=tag)]


def _check_plain(name: str, t: torch.Tensor) -> None:
    if t.is_cuda:
        raise ValueError(f"{name}: the plain version runs over gloo and "
                         f"takes CPU tensors; CUDA tensors launch the kernel")


def ring_permute_reference(k: torch.Tensor, v: torch.Tensor, group,
                           shift: int = 1):
    """Plain version of K12: rank r sends (k, v) to rank r + shift and
    returns what rank r - shift sent."""
    _check_plain("ring_permute", k)
    plain_calls["ring_permute"] += 1
    ring, me = group.size, group.rank
    dst, src = (me + shift) % ring, (me - shift) % ring
    k, v = k.contiguous(), v.contiguous()
    k_out, v_out = torch.empty_like(k), torch.empty_like(v)
    reqs = (_exchange(group, k, dst, k_out, src, tag=0) +
            _exchange(group, v, dst, v_out, src, tag=1))
    for req in reqs:
        req.wait()
    return k_out, v_out


def _gather_out(x: torch.Tensor, ring: int, out) -> torch.Tensor:
    """K13's output: ``out`` (checked) or a new [ring * c, ...]."""
    shape = (ring * x.shape[0],) + x.shape[1:]
    if out is None:
        return x.new_empty(shape)
    if (tuple(out.shape) != shape or out.dtype != x.dtype or
            out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"all-gather out {tuple(out.shape)} {out.dtype} on "
                         f"{out.device}: want a contiguous {shape} "
                         f"{x.dtype} on {x.device}")
    return out


def _scatter_out(x: torch.Tensor, ring: int, out) -> torch.Tensor:
    """K14's output: ``out`` (checked) or a new [c, ...]."""
    shape = (x.shape[0] // ring,) + x.shape[1:]
    if out is None:
        return x.new_empty(shape)
    if (tuple(out.shape) != shape or out.dtype != x.dtype or
            out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"reduce-scatter out {tuple(out.shape)} {out.dtype} "
                         f"on {out.device}: want a contiguous {shape} "
                         f"{x.dtype} on {x.device}")
    return out


def ring_all_gather_reference(x: torch.Tensor, group,
                              out: torch.Tensor = None) -> torch.Tensor:
    """Plain version of K13: the ring schedule over gloo. Step t forwards
    to the right what arrived from the left at step t - 1 (the own chunk
    first) and files what arrives under ag_source_shard. ``out``: the
    [ring * c, ...] tensor to fill (x may be its own row)."""
    _check_plain("ring_all_gather", x)
    plain_calls["ring_all_gather"] += 1
    ring, me = group.size, group.rank
    chunk = x.shape[0]
    out = _gather_out(x, ring, out)
    out[me * chunk:(me + 1) * chunk] = x
    cur = x.contiguous()
    for step in range(ring - 1):
        nxt = torch.empty_like(cur)
        for req in _exchange(group, cur, group.right, nxt, group.left):
            req.wait()
        src = ag_source_shard(me, step, ring)
        out[src * chunk:(src + 1) * chunk] = nxt
        cur = nxt
    return out


def ring_reduce_scatter_reference(x: torch.Tensor, group,
                                  out: torch.Tensor = None) -> torch.Tensor:
    """Plain version of K14: each step sends the partial to the right and
    adds this rank's part of the chunk rs_chunk_index names to the partial
    that arrived from the left (fp32 sum rounded to x's type, K14's order
    of additions). ``out``: the [c, ...] tensor to fill."""
    _check_plain("ring_reduce_scatter", x)
    plain_calls["ring_reduce_scatter"] += 1
    ring, me = group.size, group.rank
    if x.shape[0] % ring:
        raise ValueError(f"reduce-scatter dim 0 ({x.shape[0]}) must be "
                         f"divisible by the ring size {ring}")
    chunk = x.shape[0] // ring

    def part(c):
        return x[c * chunk:(c + 1) * chunk]
    cur = part(rs_chunk_index(me, -1, ring)).contiguous()
    for step in range(ring - 1):
        arrived = torch.empty_like(cur)
        for req in _exchange(group, cur, group.right, arrived, group.left):
            req.wait()
        local = part(rs_chunk_index(me, step, ring))
        cur = (arrived.float() + local.float()).to(x.dtype)
    if out is None:
        return cur
    _scatter_out(x, ring, out).copy_(cur)
    return out


def ring_permute_kernel(k: torch.Tensor, v: torch.Tensor, group,
                        shift: int = 1, library=None):
    """K12 on the card: k, v (contiguous, one shape and dtype) to rank
    r + shift; returns (k, v) of rank r - shift. ``library``: a loaded
    build of csrc/ring_collectives.cu (default: the group's)."""
    _check_cuda("k", k, group)
    _check_cuda("v", v, group)
    if k.shape != v.shape or k.dtype != v.dtype:
        raise ValueError("ring_permute takes k and v of one shape and dtype")
    group.check()
    ring, me = group.size, group.rank
    nbytes = k.numel() * k.element_size()
    v_offset = _round_up(nbytes, SLOT_ALIGN)
    buf = group.buffer("permute", permute_slot_bytes(nbytes))
    k_out, v_out = torch.empty_like(k), torch.empty_like(v)
    epoch = buf.calls + 1
    unit = copy_unit(nbytes, v_offset, k.data_ptr(), v.data_ptr(),
                     k_out.data_ptr(), v_out.data_ptr())
    pairs = {"in": (k.data_ptr(), v.data_ptr()),
             "out": (k_out.data_ptr(), v_out.data_ptr())}

    def ends(end, slot):
        return pairs[end[0]] if slot is None else (slot, slot + v_offset)
    _enqueue(permute_plan(me, ring, shift, epoch), group, buf, ends, nbytes,
           unit, "ring_permute", library or group.library)
    buf.calls = epoch
    launches["ring_permute"] += 1
    _count_axis("ring_permute", group.axis)
    return k_out, v_out


def ring_all_gather_kernel(x: torch.Tensor, group, library=None,
                           out: torch.Tensor = None) -> torch.Tensor:
    """K13 on the card: x [c, ...] -> [ring * c, ...] (any dtype), into
    ``out`` if given (x may be its own row: that copy is onto itself)."""
    _check_cuda("x", x, group)
    group.check()
    ring, me = group.size, group.rank
    nbytes = x.numel() * x.element_size()
    buf = group.buffer("all_gather", nbytes)
    out = _gather_out(x, ring, out)
    unit = copy_unit(nbytes, x.data_ptr(), out.data_ptr())

    def ends(end, slot):
        if slot is not None:
            return (slot,)
        if end[0] == "in":
            return (x.data_ptr(),)
        return (out.data_ptr() + end[1] * nbytes,)
    _enqueue(all_gather_plan(me, ring, buf.writes), group, buf, ends, nbytes,
           unit, "ring_all_gather", library or group.library)
    buf.writes += ring - 1
    launches["ring_all_gather"] += 1
    _count_axis("ring_all_gather", group.axis)
    return out


def ring_reduce_scatter_kernel(x: torch.Tensor, group, library=None,
                               out: torch.Tensor = None) -> torch.Tensor:
    """K14 on the card: x [ring * c, ...] (fp32 or bf16) -> [c, ...], into
    ``out`` if given."""
    _check_cuda("x", x, group)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not in {tuple(DTYPE_CODES)}")
    ring, me = group.size, group.rank
    if x.shape[0] % ring:
        raise ValueError(f"reduce-scatter dim 0 ({x.shape[0]}) must be "
                         f"divisible by the ring size {ring}")
    group.check()
    chunk = x.numel() // ring
    nbytes = chunk * x.element_size()
    buf = group.buffer("reduce_scatter", nbytes)
    out = _scatter_out(x, ring, out)
    unit = 16 if _vector(chunk, x.dtype, x, out) else x.element_size()

    def ends(end, slot):
        if slot is not None:
            return (slot,)
        if end[0] == "in":
            return (x.data_ptr() + end[1] * nbytes,)
        return (out.data_ptr(),)
    _enqueue(reduce_scatter_plan(me, ring, buf.writes), group, buf, ends,
           nbytes, unit, "ring_reduce_scatter", library or group.library,
           DTYPE_CODES[x.dtype])
    buf.writes += ring - 1
    launches["ring_reduce_scatter"] += 1
    _count_axis("ring_reduce_scatter", group.axis)
    return out


def ring_permute(k, v, group, shift: int = 1, impl=None):
    """One ring rotation of (k, v): impl None picks K12 for CUDA tensors and
    the plain version for CPU tensors; "kernel" or "plain" insist."""
    if impl is None:
        impl = "kernel" if k.is_cuda else "plain"
    if impl == "kernel":
        return ring_permute_kernel(k, v, group, shift)
    if impl == "plain":
        return ring_permute_reference(k, v, group, shift)
    raise ValueError(f"unknown ring permute impl {impl!r}")


def ring_all_gather(x: torch.Tensor, group,
                    out: torch.Tensor = None) -> torch.Tensor:
    """[c, ...] from every rank -> [ring * c, ...] in rank order (into
    ``out`` if given): K13 for a CUDA tensor, its plain version for a CPU
    tensor."""
    if x.is_cuda:
        return ring_all_gather_kernel(x, group, out=out)
    return ring_all_gather_reference(x, group, out)


def ring_reduce_scatter(x: torch.Tensor, group,
                        out: torch.Tensor = None) -> torch.Tensor:
    """[ring * c, ...] from every rank -> the sum over ranks of chunk
    ``group.rank`` (into ``out`` if given): K14 for a CUDA tensor, its
    plain version for a CPU tensor."""
    if x.is_cuda:
        return ring_reduce_scatter_kernel(x, group, out=out)
    return ring_reduce_scatter_reference(x, group, out)


def all_reduce_lanes(n: int, dtype: torch.dtype, ring: int) -> int:
    """``ring_all_reduce``'s padded length: n elements rounded up to ring
    chunks of whole 16-byte lanes of ``dtype`` (K14's vector adds), at
    least one lane a member (so an empty x still makes the call)."""
    lane = 16 // torch.empty((), dtype=dtype).element_size()
    return _round_up(max(n, 1), lane * ring)


def ring_all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x (fp32 or bf16, any shape) over the group's members, on
    every member: x flattened and zero-padded to all_reduce_lanes, K14 then
    K13 (their plain versions for a CPU tensor), unpadded. Each element is
    summed once, in ring order, by the member whose chunk holds it, then
    copied, so every member gets the same bits. A ring of one returns x."""
    if group is None or group.size == 1:
        return x
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {x.dtype} not in {tuple(DTYPE_CODES)}")
    flat = x.reshape(-1)
    n = flat.numel()
    padded = all_reduce_lanes(n, x.dtype, group.size)
    if padded != n:
        flat = torch.cat([flat, flat.new_zeros(padded - n)])
    if x.is_cuda:
        out = ring_all_gather_kernel(ring_reduce_scatter_kernel(flat, group),
                                     group)
        _count_axis("ring_all_reduce", group.axis)
    else:
        out = ring_all_gather_reference(
            ring_reduce_scatter_reference(flat, group), group)
    return out[:n].view(x.shape)


class _RingPermute(torch.autograd.Function):
    """+1 rotation forward; the transpose of a +1 shift is the -1 shift
    (y_i = x_{i-1} => dx_j = dy_{j+1}), so the backward rotates the
    cotangents the other way."""

    @staticmethod
    def forward(ctx, k, v, group, impl):
        ctx.group, ctx.impl = group, impl
        return ring_permute(k, v, group, 1, impl)

    @staticmethod
    def backward(ctx, g_k, g_v):
        g_k, g_v = ring_permute(g_k.contiguous(), g_v.contiguous(),
                                ctx.group, -1, ctx.impl)
        return g_k, g_v, None, None


def ring_permute_pair(k, v, group, impl=None):
    """One +1 ring rotation of the (K, V) pair, differentiable. A ring of
    one returns its input."""
    if group.size == 1:
        return k, v
    return _RingPermute.apply(k, v, group, impl)


# ------------------ the parameter gather over the fsdp ring ----------------


class _FsdpGather(torch.autograd.Function):
    """Forward: this rank's chunk of an fsdp unit -> the unit's flat over
    the fsdp ring (K13; a ring of one: the chunk itself). Backward: the
    unit's gradient reduce-scattered (K14) into ``sink``, this rank's
    chunk of the gradient buffer, in place of a gradient for the chunk."""

    @staticmethod
    def forward(ctx, chunk, group, sink):
        ctx.group, ctx.sink = group, sink
        if group is None:
            return chunk.view_as(chunk)
        return ring_all_gather(chunk.detach(), group)

    @staticmethod
    def backward(ctx, grad):
        if ctx.group is None:
            ctx.sink.copy_(grad)
        else:
            ring_reduce_scatter(grad.contiguous(), ctx.group, out=ctx.sink)
        return None, None, None


def fsdp_gather(chunk: torch.Tensor, group, sink: torch.Tensor
                ) -> torch.Tensor:
    """The flat of an fsdp unit from this rank's ``chunk`` (a leaf that
    requires grad) over the fsdp ``group`` (None: fsdp = 1), for a
    forward; the backward writes this rank's chunk of the unit's summed
    gradient into ``sink`` (the chunk's shape) and gives the chunk no
    .grad. Every member must gather the same units in the same order."""
    return _FsdpGather.apply(chunk, group, sink)


# ------------------ Megatron's f and g over the tp ring -------------------


class _TPRegionInput(torch.autograd.Function):
    """Megatron's "f": identity forward; the backward sums each tp rank's
    partial cotangent over the tp ring."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ring_all_reduce(g.contiguous(), ctx.group), None


class _TPRegionOutput(torch.autograd.Function):
    """Megatron's "g": the forward sums the tp ranks' partial outputs over
    the tp ring; the backward passes the replicated cotangent through."""

    @staticmethod
    def forward(ctx, x, group):
        return ring_all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_region_input(x, group):
    """The reference's tp_region_input over a tp RingGroup (None or a
    ring of one: x)."""
    if group is None or group.size == 1:
        return x
    return _TPRegionInput.apply(x, group)


def tp_region_output(x, group):
    """The reference's tp_region_output over a tp RingGroup (None or a
    ring of one: x)."""
    if group is None or group.size == 1:
        return x
    return _TPRegionOutput.apply(x, group)
