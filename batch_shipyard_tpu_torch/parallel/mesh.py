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
over the gloo process group. The ring calls count with epoch counters in
the pad, so a buffer is reused call after call with no reset.

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
too. A rank that never arrives makes its neighbours' waits expire, and
each rank waiting on one that stopped raises in turn: chip_smoke.py's
check sees every rank raise within twice the timeout. The same event
pairs give ``wait_ns``: the nanoseconds this rank's ring calls spent
waiting on a neighbour.
"""

from __future__ import annotations

import ctypes
import threading
import time

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
# The error word's codes (csrc/ring_collectives.cu RingError).
TIMED_OUT, UNFILLED = 1, 2
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
    """The ranks of the default (gloo) process group as one
    sequence-parallel ring.

    ``rank`` and ``size`` are this rank's place and the ring's length;
    ``left`` and ``right`` its neighbours (rank - 1, rank + 1 mod size),
    the ranks it receives from and sends to on a +1 rotation. On a CUDA
    ``device`` the group loads csrc/ring_collectives.cu and owns the
    symmetric buffers, the error word and the stream waits' watchdog; on
    the CPU it carries only the ranks (the plain versions run over
    gloo)."""

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
        what = ("found a neighbour's slot unfilled (the neighbour's ring "
                "call failed)" if self.error[0] == UNFILLED else
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
        >= ``value``, between two timing events the watchdog reads."""
        with self._lock:
            before, after = self._event(), self._event()
        before.record(stream)
        self.check_rc(self.library.bs_stream_wait(
            self.device.index or 0, word, value, stream.cuda_stream),
            f"stream wait ({STREAM_MEM_OPS})")
        after.record(stream)
        with self._lock:
            self._waits.append([before, after, word, None])

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

    def _watch(self) -> None:
        poll = min(1.0, self.timeout_s / 8)
        while not self._stop.wait(poll):
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
