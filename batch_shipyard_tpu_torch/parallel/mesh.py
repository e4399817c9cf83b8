"""The training mesh: parallelism axes, this rank's place on them, and
one ring group per axis.

Counterpart of batch_shipyard_tpu/parallel/mesh.py. The reference maps
named axes onto a jax Mesh and lets XLA insert the collectives; the port
has no XLA, so every multi-rank axis is a ``RingGroup`` over
``torch.distributed``: the ranks of one ring, this rank's place in it,
its neighbours, and, on the card, the symmetric buffers the ring kernels
(ops/ring_collectives.py, K12-K14) write into and read from.

``AXES`` and ``auto_axis_sizes`` keep the reference's names and rules.
``RankMesh`` lays the world's ranks out on ``AXES`` row-major, tp
innermost, as the reference's ``make_mesh`` reshapes its device list,
and builds this rank's groups:

- ``sp``: the ranks that differ only in their sp index (ring attention's
  K12 rotations);
- ``tp``: only in their tp index (the Megatron all-reduces of
  models/transformer.py);
- ``fsdp``: only in their fsdp index (the gradient reduce-scatter and
  the parameter all-gather of parallel/train.py);
- ``data``: the dp x sp ranks that share this rank's fsdp, ep and tp
  indices (the gradient all-reduce). With dp = 1 it has the sp ring's
  ranks, and the sp group serves both;
- ``ep``: only in their ep index (Megatron's pair around the MoE layers'
  expert region, models/moe.py);
- ``tokens`` (a MoE model's mesh only, ``roles=MOE_ROLES``): the dp x
  fsdp x sp ranks that share this rank's ep and tp indices, the ranks
  that hold distinct tokens of the global batch (the MoE layers' one
  global routing gathers its probabilities over it). Where another group
  has its ranks, that group serves both (the data ring with fsdp 1:
  "data+tokens").

Every rank creates every gloo subgroup of every axis, in one fixed order
(``dist.new_group`` is collective over the world), including the groups
it is not in. A group's ``rank``, ``size``, ``left`` and ``right`` are
group-local; ``ranks`` maps them to global ranks.

Symmetric buffers. A peer cannot learn the address of a fresh
``torch.empty`` without an exchange on every call, so a group owns one
device buffer per (kind, slot size): a 256-byte signal pad and two data
slots, allocated once with ``cudaMalloc`` (outside PyTorch's caching
allocator, whose blocks sit at offsets inside larger segments) and mapped
into every other rank of the group once, by CUDA IPC handles exchanged
over the group's gloo subgroup. The ring calls count with epoch counters
in the pad, so a buffer is reused call after call with no reset.

Waits in the stream. K12-K14 wait and signal with ``stream_wait`` and
``stream_write``, which enqueue the CUDA driver's 64-bit stream memory
operations on a pad word (the group raises at construction if the device
does not offer them; nothing falls back), so a rank that waits holds no
SM and the card runs the ranks that have work (csrc/ring_collectives.cu's
head note). No ring kernel spins.

A hang becomes an error. Each stream wait is timed by a pair of CUDA
events around it; a watchdog thread treats a wait as expired once its
"before" event has been seen complete for ``timeout_s`` (default
``DEFAULT_TIMEOUT_S``) while its "after" event is still open. On expiry,
or once the group's error word (host-mapped memory) is set (a copy that
found a neighbour's slot unfilled), it sets the word, then from a private
stream writes it into the group's device-side abort word and a poison
epoch (``POISON``, 2^63) into every pad word this rank's streams stand
waiting on; the copy kernels read the abort word and copy nothing, so
the rank drains instead of hanging in its next synchronise.
``RingGroup.check`` raises on the word: the wrappers call it before
every ring call, the train workload after each synchronise, and
``RingGroup.close`` after its own, so a timeout in the last step raises
too. The same event pairs give ``wait_ns``: the nanoseconds this rank's
ring calls spent waiting on a neighbour.

Across a mesh, a failure travels through the rendezvous store. The
groups of a ``RankMesh`` share one store key: a group whose wait expired
(or found a slot unfilled) writes it, and every group's watchdog reads it
at each poll and, once it is there (or the store is gone), sets its own
word to ``ABORTED`` and poisons its waits. So a rank that dies makes
every rank of the mesh raise about one timeout after its neighbours
reached it, however far they sit from it; chip_smoke.py's mesh phase
kills a rank mid-step and checks every other one raises within twice the
timeout.
"""

from __future__ import annotations

import ctypes
import itertools
import math
import threading
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "ep", "sp", "tp")
DEFAULT_TIMEOUT_S = 120.0
# The kernels' pad (csrc/ring_collectives.cu kPadBytes) and slot alignment.
PAD_BYTES = 256
SLOT_ALIGN = 256
IPC_HANDLE_BYTES = 64
# The counters of a pad, in csrc/ring_collectives.cu's struct Pad order.
PAD_FIELDS = ("ready0", "ready1", "consumed0", "consumed1", "wait_ns",
              "written0", "written1")
# The epoch the watchdog writes into a word to release every wait on it.
POISON = 1 << 63
# The error word's codes (csrc/ring_collectives.cu RingError; ABORTED is
# the port's: another group of the mesh failed, and the copy kernels read
# any nonzero abort word alike).
TIMED_OUT, UNFILLED, ABORTED = 1, 2, 3
# The watchdog's poll while a group's error word is set: each wait the
# stream reaches is poisoned within this, so a long queue drains fast.
ERROR_POLL_S = 0.002
# How many of a group's stream waits the host may enqueue before the
# stream has reached them, and how often it looks while it holds. A host
# thread that fills the stream's queue behind a wait blocks inside the
# CUDA driver, and there it holds up the watchdog's poison writes on the
# same context: on the card, every rank of a mesh with one rank killed
# hung so. A host held here, in Python, raises once the group fails.
RUN_AHEAD_WAITS = 16
RUN_AHEAD_POLL_S = 1e-4
STREAM_MEM_OPS = "CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS"


def auto_axis_sizes(n_devices: int, tp: int = 1, sp: int = 1,
                    fsdp: int = 1, ep: int = 1) -> dict[str, int]:
    """Fill dp with whatever remains after the requested inner axes."""
    inner = tp * sp * fsdp * ep
    if n_devices % inner:
        raise ValueError(
            f"{n_devices} devices not divisible by "
            f"tp*sp*fsdp*ep={inner}")
    return dict(zip(AXES, (n_devices // inner, fsdp, ep, sp, tp)))


def _round_up(n: int, to: int) -> int:
    return -(-n // to) * to


class SymmetricBuffer:
    """One rank's pad + two slots of ``slot_stride`` bytes, and the same
    buffer of every other rank mapped into this process. ``calls`` and
    ``writes`` are the epoch counters of the wrappers' plans (K12 counts
    calls; K13/K14 count slot writes)."""

    def __init__(self, group: "RingGroup", slot_bytes: int) -> None:
        lib = group.library
        dev = group.device.index or 0
        self.slot_stride = _round_up(slot_bytes, SLOT_ALIGN)
        self.nbytes = PAD_BYTES + 2 * self.slot_stride
        ptr = ctypes.c_void_p()
        group.check_rc(lib.bs_ring_alloc(dev, self.nbytes,
                                         ctypes.byref(ptr)), "ring alloc")
        self.ptr = ptr.value
        handle = (ctypes.c_ubyte * IPC_HANDLE_BYTES)()
        group.check_rc(lib.bs_ring_export(dev, self.ptr, handle),
                       "ring export")
        mine = torch.tensor(list(bytes(handle)), dtype=torch.uint8)
        handles = [torch.empty_like(mine) for _ in range(group.size)]
        dist.all_gather(handles, mine, group=group.process_group)
        self._peers = {}
        for rank, peer in enumerate(handles):
            if rank == group.rank:
                continue
            raw = (ctypes.c_ubyte * IPC_HANDLE_BYTES)(*peer.tolist())
            mapped = ctypes.c_void_p()
            group.check_rc(lib.bs_ring_import(dev, raw, ctypes.byref(mapped)),
                           "ring import")
            self._peers[rank] = mapped.value
        self.rank = group.rank
        self.calls = 0
        self.writes = 0

    def peer(self, rank: int) -> int:
        """The address of ``rank``'s buffer in this process."""
        return self.ptr if rank == self.rank else self._peers[rank]

    def word(self, rank: int, field: str) -> int:
        """The address of ``field`` (a PAD_FIELDS name) of ``rank``'s pad."""
        return self.peer(rank) + 8 * PAD_FIELDS.index(field)

    def slot(self, rank: int, s: int) -> int:
        """The address of ``rank``'s slot ``s``."""
        return self.peer(rank) + PAD_BYTES + s * self.slot_stride

    def close(self, group: "RingGroup") -> None:
        dev = group.device.index or 0
        for mapped in self._peers.values():
            group.library.bs_ring_close(dev, mapped)
        group.library.bs_ring_free(dev, self.ptr)
        self._peers = {}


class RingGroup:
    """The ranks ``ranks`` (global ranks, ascending; default: every rank
    of the default process group) as one ring over ``process_group``,
    their gloo subgroup (None: the default group).

    ``rank`` and ``size`` are this rank's place and the ring's length;
    ``left`` and ``right`` its neighbours (rank - 1, rank + 1 mod size),
    the members it receives from and sends to on a +1 rotation, all
    group-local (``global_rank`` maps them). ``axis`` labels the group's
    calls (ops/ring_collectives ``axis_launches``, the profiler): its mesh
    role, or its roles joined by "+" where one ring plays two. On a
    CUDA ``device`` the group loads csrc/ring_collectives.cu and owns the
    symmetric buffers, the error word and the stream waits' watchdog; on
    the CPU it carries only the ranks (the plain versions run over gloo).
    ``abort``: (store, key) through which the groups of a mesh pass a
    failure to each other (RankMesh), or None."""

    # Read by the watchdog; a group made without __init__ has none.
    _abort = None
    _published = False

    def __init__(self, device="cpu", timeout_s: float = DEFAULT_TIMEOUT_S,
                 library=None, ranks=None, process_group=None,
                 axis: str = "sp", abort=None) -> None:
        if not dist.is_initialized():
            raise RuntimeError("RingGroup needs torch.distributed "
                               "initialised (workloads/distributed.setup)")
        self.ranks = (list(range(dist.get_world_size())) if ranks is None
                      else list(ranks))
        if dist.get_rank() not in self.ranks:
            raise ValueError(f"rank {dist.get_rank()} is not in the ring "
                             f"{self.ranks}")
        self.process_group = process_group
        self.axis = axis
        self.rank = self.ranks.index(dist.get_rank())
        self.size = len(self.ranks)
        self.device = torch.device(device)
        self.timeout_s = timeout_s
        self.timeout_ns = int(timeout_s * 1e9)
        self._buffers: dict = {}
        self._library = library
        self._abort = abort
        self.error = None
        self._watchdog = None
        if self.device.type == "cuda":
            dev = self.device.index or 0
            supported = ctypes.c_int()
            self.check_rc(self.library.bs_stream_mem_ops(
                dev, ctypes.byref(supported)), STREAM_MEM_OPS)
            if not supported.value:
                raise RuntimeError(
                    f"ring group on {self.device}: the CUDA driver offers no "
                    f"64-bit stream memory operations ({STREAM_MEM_OPS} "
                    f"is 0), which the ring kernels wait and signal with")
            flag = ctypes.POINTER(ctypes.c_int)()
            self.check_rc(self.library.bs_ring_flag_alloc(
                dev, ctypes.byref(flag)), "ring flag")
            self.error = flag
            # The error word's device-side copy, which the K12/K13 copies
            # read (a zeroed device word).
            abort = ctypes.c_void_p()
            self.check_rc(self.library.bs_ring_alloc(
                dev, PAD_BYTES, ctypes.byref(abort)), "ring abort word")
            self.abort = abort.value
            self._waits: list = []  # [before, after, word, seen] per wait
            self._spare: list = []  # timing events whose wait has ended
            self._waited_ns = 0
            self._lock = threading.Lock()
            poison = ctypes.c_void_p()
            self.check_rc(self.library.bs_ring_stream_create(
                dev, ctypes.byref(poison)), "ring stream")
            self._poison_stream = poison.value
            self._stop = threading.Event()
            self._watchdog = threading.Thread(
                target=self._watch, name=f"ring-watchdog-{self.rank}",
                daemon=True)
            self._watchdog.start()

    @property
    def library(self):
        if self._library is None:
            from batch_shipyard_tpu_torch.ops import _build
            self._library = _build.library("ring_collectives")
        return self._library

    @property
    def left(self) -> int:
        return (self.rank - 1) % self.size

    @property
    def right(self) -> int:
        return (self.rank + 1) % self.size

    def global_rank(self, member: int) -> int:
        """The global rank of group-local ``member``."""
        return self.ranks[member]

    def check_rc(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self.library.bs_error_string(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

    def check(self) -> None:
        """Raise if a ring call of this group waited longer than the
        timeout on a neighbour, or found a neighbour's slot unfilled
        (reads the host-mapped error word; no synchronise)."""
        if self.error is None or self.error[0] == 0:
            return
        what = {UNFILLED: "found a neighbour's slot unfilled (the "
                          "neighbour's ring call failed)",
                ABORTED: "was stopped: another ring group of the mesh "
                         "failed or the rendezvous store is gone"}.get(
            self.error[0],
            f"waited longer than {self.timeout_s} s on a neighbour")
        raise RuntimeError(
            f"ring group rank {self.rank}/{self.size}: a ring call {what} "
            f"(a rank is missing or issued a different sequence of ring "
            f"calls)")

    # ------------------- stream-ordered waits and signals -----------------

    def _event(self) -> torch.cuda.Event:
        return (self._spare.pop() if self._spare else
                torch.cuda.Event(enable_timing=True))

    def stream_wait(self, word: int, value: int, stream) -> None:
        """Enqueue on ``stream``: wait until the pad word at ``word`` is
        >= ``value``, between two timing events the watchdog reads (first
        holding the host while it is RUN_AHEAD_WAITS waits ahead)."""
        self._run_ahead()
        with self._lock:
            before, after = self._event(), self._event()
        before.record(stream)
        self.check_rc(self.library.bs_stream_wait(
            self.device.index or 0, word, value, stream.cuda_stream),
            f"stream wait ({STREAM_MEM_OPS})")
        after.record(stream)
        with self._lock:
            self._waits.append([before, after, word, None])

    def _run_ahead(self) -> None:
        """Hold the host until the stream has reached the wait
        RUN_AHEAD_WAITS back, polling its "before" event; raise as soon as
        the group's error word is set."""
        with self._lock:
            if len(self._waits) < RUN_AHEAD_WAITS:
                return
            before = self._waits[-RUN_AHEAD_WAITS][0]
        while not before.query():
            self.check()
            time.sleep(RUN_AHEAD_POLL_S)

    def stream_write(self, word: int, value: int, stream) -> None:
        """Enqueue on ``stream``: write ``value`` to the pad word at
        ``word`` once the work before it is done (its stores visible
        first)."""
        self.check_rc(self.library.bs_stream_write(
            self.device.index or 0, word, value, stream.cuda_stream),
            f"stream write ({STREAM_MEM_OPS})")

    def _sweep(self) -> None:
        """Fold the waits that ended into the wait time; note when a wait
        is first seen reached; on expiry (or a set error word) set the
        word and poison the words of every wait a stream stands at."""
        now = time.monotonic()
        if self._abort is not None and self.error[0] == 0 and \
                self._aborted_elsewhere():
            self.error[0] = ABORTED
        with self._lock:
            pending = []
            for entry in self._waits:
                before, after, _, seen = entry
                if after.query():
                    self._waited_ns += int(before.elapsed_time(after) * 1e6)
                    self._spare += (before, after)
                    continue
                if seen is None and before.query():
                    entry[3] = now
                pending.append(entry)
            self._waits = pending
            if self.error[0] == 0 and any(
                    seen is not None and now - seen > self.timeout_s
                    for *_, seen in pending):
                self.error[0] = TIMED_OUT
            reached = [word for _, _, word, seen in pending
                       if seen is not None]
            if self.error[0] != 0 and reached:
                # The abort word first: a copy behind a released wait must
                # find it set (one stream, in order).
                for word, value in ([(self.abort, self.error[0])] +
                                    [(word, POISON) for word in reached]):
                    self.library.bs_stream_write(self.device.index or 0, word,
                                                 value, self._poison_stream)
        if self._abort is not None and self.error[0] not in (0, ABORTED) \
                and not self._published:
            self._published = True
            store, key = self._abort
            try:
                store.set(key, f"rank {self.global_rank(self.rank)} "
                               f"({self.axis} ring): error {self.error[0]}")
            except RuntimeError:
                pass  # the store is gone: every other rank sees that too

    def _aborted_elsewhere(self) -> bool:
        """Whether another group of the mesh published a failure, or the
        rendezvous store cannot be reached (its host rank is gone)."""
        store, key = self._abort
        try:
            return store.check([key])
        except RuntimeError:
            return True

    def _watch(self) -> None:
        poll = min(1.0, self.timeout_s / 8)
        while not self._stop.wait(ERROR_POLL_S if self.error[0] else poll):
            self._sweep()

    # ------------------------------ buffers -------------------------------

    def buffer(self, kind: str, slot_bytes: int) -> SymmetricBuffer:
        """The symmetric buffer for ``kind`` with slots of at least
        ``slot_bytes``, allocated and mapped on first use. Every rank must
        ask for the same (kind, slot_bytes) in the same order: the first
        request is a collective over the group."""
        if self.device.type != "cuda":
            raise ValueError("symmetric buffers live on a CUDA device")
        key = (kind, _round_up(slot_bytes, SLOT_ALIGN))
        buf = self._buffers.get(key)
        if buf is None:
            buf = self._buffers[key] = SymmetricBuffer(self, slot_bytes)
        return buf

    def wait_ns(self) -> int:
        """Total wait of this rank's ring calls on neighbours so far: their
        stream waits' time, from the event pairs (synchronises the
        device)."""
        torch.cuda.synchronize(self.device)
        self._sweep()
        return self._waited_ns

    def close(self) -> None:
        """Unmap the peers' buffers and free this rank's, stop the
        watchdog, then raise if a ring call of this group failed. Call on
        every rank after its last ring call (a barrier keeps a peer from
        freeing a buffer another rank still reads)."""
        if self._watchdog is not None:
            torch.cuda.synchronize(self.device)
            self._stop.set()
            self._watchdog.join()
            self._watchdog = None
            self.library.bs_ring_stream_destroy(self.device.index or 0,
                                                self._poison_stream)
            self.library.bs_ring_free(self.device.index or 0, self.abort)
        if self._buffers:
            dist.barrier(group=self.process_group)
            for buf in self._buffers.values():
                buf.close(self)
            self._buffers = {}
        try:
            self.check()
        finally:
            if self.error is not None:
                self.library.bs_ring_flag_free(self.error)
                self.error = None


# ------------------------------- the mesh ---------------------------------


# The mesh's groups, in the order every rank creates them, with the axes
# each one's members differ in.
GROUP_AXES = {"sp": ("sp",), "tp": ("tp",), "fsdp": ("fsdp",),
              "data": ("dp", "sp"), "ep": ("ep",)}
# A MoE model's mesh builds one more (``roles=MOE_ROLES``).
MOE_GROUP_AXES = {**GROUP_AXES, "tokens": ("dp", "fsdp", "sp")}
MOE_ROLES = tuple(MOE_GROUP_AXES)
_mesh_ids = itertools.count()


def axis_groups(sizes: dict, axes) -> list[list[int]]:
    """The global ranks of every group whose members differ only in
    ``axes``, with the world laid out on AXES row-major (tp innermost).
    Each list is ascending, so a member's group-local rank is its index
    (and ``dist.new_group``'s sorted order)."""
    shape = [sizes[a] for a in AXES]
    grid = np.arange(math.prod(shape)).reshape(shape)
    inner = [i for i, a in enumerate(AXES) if a in axes]
    outer = [i for i, a in enumerate(AXES) if a not in axes]
    rows = grid.transpose(outer + inner).reshape(
        -1, math.prod(shape[i] for i in inner))
    return [row.tolist() for row in rows]


class RankMesh:
    """The world's ranks on AXES: ``sizes`` (auto_axis_sizes), this
    rank's ``rank`` and ``coords`` (its index on each axis), and
    ``groups``: a RingGroup for each of MOE_GROUP_AXES this rank shares
    with another rank, None where the axis has one rank or the role was
    not built; a ring that plays two
    roles (the data ring is the sp ring when dp = 1) is one group under
    both, labelled "sp+data". Made with ``sizes`` and ``rank`` alone it
    is the layout only (no groups); ``build`` makes the groups,
    ``of_sp_group`` wraps a sequence-parallel ring that spans the
    world."""

    def __init__(self, sizes: dict, rank: int,
                 groups: Optional[dict] = None) -> None:
        self.sizes = dict(sizes)
        self.world = math.prod(self.sizes.values())
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside a world of {self.world}")
        self.rank = rank
        index = np.unravel_index(rank, [self.sizes[a] for a in AXES])
        self.coords = {a: int(i) for a, i in zip(AXES, index)}
        self.groups = (dict.fromkeys(MOE_GROUP_AXES) if groups is None else
                       groups)

    @classmethod
    def build(cls, device="cpu", tp: int = 1, sp: int = 1, fsdp: int = 1,
              ep: int = 1, world: Optional[int] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S,
              library=None, roles=tuple(GROUP_AXES)) -> "RankMesh":
        """This rank's mesh over the default process group (``world``:
        its size, which it must be). Every rank must call it, with the
        same sizes and ``roles``: it creates every subgroup of each role
        (MOE_GROUP_AXES keys; the others stay None) in that order."""
        if world is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
        sizes = auto_axis_sizes(world, tp=tp, sp=sp, fsdp=fsdp, ep=ep)
        if world == 1:
            return cls(sizes, 0)
        if not dist.is_initialized() or dist.get_world_size() != world:
            raise RuntimeError(f"a mesh of {world} ranks needs a process "
                               f"group of {world} (workloads/distributed)")
        me = dist.get_rank()
        abort = None
        if device is not None and torch.device(device).type == "cuda":
            from torch.distributed import distributed_c10d
            abort = (distributed_c10d._get_default_store(),
                     f"ring_abort/mesh{next(_mesh_ids)}")
        groups, made = {}, {}
        for name, axes in MOE_GROUP_AXES.items():
            groups[name] = None
            if name not in roles:
                continue
            for ranks in axis_groups(sizes, axes):
                if len(ranks) == 1:
                    continue
                key = tuple(ranks)
                if key not in made:
                    pg = (None if len(ranks) == world else
                          dist.new_group(ranks))
                    made[key] = (pg, name)
                if me not in ranks:
                    continue
                pg, owner = made[key]
                if owner == name:
                    groups[name] = RingGroup(device, timeout_s, library,
                                             ranks=ranks, process_group=pg,
                                             axis=name, abort=abort)
                else:
                    groups[name] = groups[owner]
                    groups[name].axis += f"+{name}"
        return cls(sizes, me, groups)

    @classmethod
    def of_sp_group(cls, group: RingGroup) -> "RankMesh":
        """The sp-only mesh of a ring over the whole world: the ring does
        the rotations and, as the data ring, the gradient all-reduce (so
        its label becomes "sp+data", as build gives it)."""
        if dist.is_initialized() and group.size != dist.get_world_size():
            raise ValueError(
                f"an sp ring of {group.size} of {dist.get_world_size()} "
                f"ranks is one of a mesh's: pass the mesh "
                f"(RankMesh.build) instead of the ring")
        group.axis = "sp+data"
        sizes = auto_axis_sizes(group.size, sp=group.size)
        return cls(sizes, group.rank, dict(dict.fromkeys(MOE_GROUP_AXES),
                                           sp=group, data=group))

    @property
    def data_index(self) -> int:
        """This rank's block of batch rows: dp_index * fsdp + fsdp_index
        (the reference's P(("dp", "fsdp"), "sp"))."""
        return self.coords["dp"] * self.sizes["fsdp"] + self.coords["fsdp"]

    @property
    def data_size(self) -> int:
        return self.sizes["dp"] * self.sizes["fsdp"]

    def distinct_groups(self) -> list:
        """This rank's RingGroups, each once, in MOE_GROUP_AXES order."""
        seen = []
        for group in self.groups.values():
            if group is not None and all(group is not g for g in seen):
                seen.append(group)
        return seen

    def check(self) -> None:
        """RingGroup.check for every group of this rank."""
        for group in self.distinct_groups():
            group.check()

    def close(self) -> None:
        """RingGroup.close for every group of this rank (each unmaps and
        frees, even after another raised), then raise the first error."""
        error = None
        for group in self.distinct_groups():
            try:
                group.close()
            except RuntimeError as err:
                error = error or err
        if error is not None:
            raise error
