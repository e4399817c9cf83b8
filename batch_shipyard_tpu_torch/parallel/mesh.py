"""Parallelism axes and the sequence-parallel ring group.

Counterpart of batch_shipyard_tpu/parallel/mesh.py. The reference maps
named axes onto a jax Mesh and lets XLA insert the collectives; the port
has no XLA, so its one multi-rank axis so far, ``sp``, is a ``RingGroup``
over ``torch.distributed``: the ranks of one sequence-parallel ring, this
rank's place in it, its neighbours, and, on the card, the symmetric
buffers the ring kernels (ops/ring_collectives.py, K12-K14) write into and
read from.

``AXES`` and ``auto_axis_sizes`` keep the reference's names and rules.

Symmetric buffers. A peer cannot learn the address of a fresh
``torch.empty`` without an exchange on every call, so a group owns one
device buffer per (kind, slot size): a 256-byte signal pad and two data
slots, allocated once with ``cudaMalloc`` (outside PyTorch's caching
allocator, whose blocks sit at offsets inside larger segments) and mapped
into every other rank of the group once, by CUDA IPC handles exchanged
over the gloo process group. The kernels count calls with epoch
counters in the pad, so a buffer is reused call after call with no reset.

A hang becomes an error: every wait in the kernels is bounded by
``timeout_s`` (default ``DEFAULT_TIMEOUT_S``); a wait that outlives it
writes an error word in host-mapped memory, and ``RingGroup.check``
raises. The wrappers call it before every launch, which sees the kernels
that have finished; the train workload calls it after each synchronise,
and ``RingGroup.close`` after its own, so a timeout in the last step
raises too. A rank that never arrives makes its neighbours' waits time
out, and each rank waiting on one that stopped raises in turn:
chip_smoke.py's check sees every rank raise within twice the timeout.
"""

from __future__ import annotations

import ctypes

import torch
import torch.distributed as dist

AXES = ("dp", "fsdp", "ep", "sp", "tp")
DEFAULT_TIMEOUT_S = 120.0
# The kernels' pad (csrc/ring_collectives.cu kPadBytes) and slot alignment.
PAD_BYTES = 256
SLOT_ALIGN = 256
IPC_HANDLE_BYTES = 64
# The counters of a pad, in csrc/ring_collectives.cu's struct Pad order.
PAD_FIELDS = ("ready0", "ready1", "consumed0", "consumed1", "arrive_w0",
              "arrive_w1", "arrive_r0", "arrive_r1", "wait_ns")


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
    ``writes`` are the epoch counters the wrappers pass to the kernels
    (K12 counts calls; K13/K14 count slot writes)."""

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
        dist.all_gather(handles, mine)
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

    def close(self, group: "RingGroup") -> None:
        dev = group.device.index or 0
        for mapped in self._peers.values():
            group.library.bs_ring_close(dev, mapped)
        group.library.bs_ring_free(dev, self.ptr)
        self._peers = {}


class RingGroup:
    """The ranks of the default (gloo) process group as one
    sequence-parallel ring.

    ``rank`` and ``size`` are this rank's place and the ring's length;
    ``left`` and ``right`` its neighbours (rank - 1, rank + 1 mod size),
    the ranks it receives from and sends to on a +1 rotation. On a CUDA
    ``device`` the group loads csrc/ring_collectives.cu and owns the
    symmetric buffers and the error word of the ring kernels; on the CPU
    it carries only the ranks (the plain versions run over gloo)."""

    def __init__(self, device="cpu", timeout_s: float = DEFAULT_TIMEOUT_S,
                 library=None) -> None:
        if not dist.is_initialized():
            raise RuntimeError("RingGroup needs torch.distributed "
                               "initialised (workloads/distributed.setup)")
        self.rank = dist.get_rank()
        self.size = dist.get_world_size()
        self.device = torch.device(device)
        self.timeout_s = timeout_s
        self.timeout_ns = int(timeout_s * 1e9)
        self._buffers: dict = {}
        self._library = library
        self.error = None
        if self.device.type == "cuda":
            flag = ctypes.POINTER(ctypes.c_int)()
            self.check_rc(self.library.bs_ring_flag_alloc(
                self.device.index or 0, ctypes.byref(flag)), "ring flag")
            self.error = flag

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

    def check_rc(self, rc: int, what: str) -> None:
        if rc != 0:
            msg = self.library.bs_error_string(rc).decode()
            raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

    def check(self) -> None:
        """Raise if a ring kernel of this group timed out waiting on a
        neighbour (reads the host-mapped error word; no synchronise)."""
        if self.error is not None and self.error[0] != 0:
            raise RuntimeError(
                f"ring group rank {self.rank}/{self.size}: a ring kernel "
                f"waited longer than {self.timeout_s} s on a neighbour "
                f"(a rank is missing or issued a different sequence of "
                f"ring calls)")

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

    def pads(self) -> dict:
        """Each buffer's pad counters (synchronises the device): the
        epochs and ``wait_ns``, the nanoseconds block 0 of this rank's
        ring kernels spent waiting on neighbours."""
        out = {}
        for (kind, stride), buf in self._buffers.items():
            raw = (ctypes.c_ulonglong * len(PAD_FIELDS))()
            self.check_rc(self.library.bs_ring_read_pad(
                self.device.index or 0, buf.ptr, raw), "ring read pad")
            out[f"{kind}/{stride}"] = dict(zip(PAD_FIELDS, raw))
        return out

    def wait_ns(self) -> int:
        """Total wait of this rank's ring kernels so far (see pads)."""
        return sum(pad["wait_ns"] for pad in self.pads().values())

    def close(self) -> None:
        """Unmap the peers' buffers and free this rank's, then raise if a
        ring kernel of this group timed out. Call on every rank after its
        last ring call (a barrier keeps a peer from freeing a buffer
        another rank still reads)."""
        if self._buffers:
            torch.cuda.synchronize(self.device)
            dist.barrier()
            for buf in self._buffers.values():
                buf.close(self)
            self._buffers = {}
        try:
            self.check()
        finally:
            if self.error is not None:
                self.library.bs_ring_flag_free(self.error)
                self.error = None
