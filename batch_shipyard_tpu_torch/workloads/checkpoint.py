"""Training checkpoints: save, resume (on the same mesh or a resized
one), sync or async, and the train loop's checkpointer.

Counterpart of batch_shipyard_tpu/workloads/checkpoint.py, with its file
names and commit protocol and the port's own on-disk format (below).

Commit protocol. A save writes into a staging dir ``.tmp_step_NNNNNNNN``,
meets the other ranks at a barrier once every file is written and
fsynced, and then process 0 replaces ``step_NNNNNNNN`` by it and writes
the sibling files ``step_NNNNNNNN.MESH`` (the mesh the state was saved
on) and then ``step_NNNNNNNN.COMMITTED`` (each tmp + rename); a last
barrier keeps every rank from reading ``latest_step`` before the commit
lands. A crash leaves either an earlier committed step or an unmarked
dir, which ``latest_step`` skips once any marker exists (a dir written
entirely without markers keeps the legacy accept-all reading).
``retention_gc`` keeps the newest N committed steps, removing the
marker first, then the ``.MESH``, then the dir; it never touches the
newest step, a staging dir or an unmarked dir.

Format. Not Orbax's (JAX), and not ``torch.distributed.checkpoint``'s:
DCP reshards DTensor/ShardedTensor layouts, while the port's tp shards
are plain tensors and its fsdp state is a chunk of each fsdp unit
(parallel/sharding.fsdp_units, parallel/train.py). A step dir holds
``layout.json`` (the mesh sizes, every parameter's global shape and
dtype in parameter order, the train step, AdamW's step count, and every
record: a parallel/sharding.py ``Piece``, a range of one tensor's tp
shard, with its writer's file and its offset there) and one
``rankNNNNN.pt`` per writing rank: ``torch.save`` of {dtype name: one
flat host tensor} holding the rank's pieces (sharding.written_pieces:
dp, ep and sp index 0 write, each fsdp index the ranges of the
parameters and moments it holds; nothing is written twice). ``restore``
plans what this rank reads (sharding.restore_plan_for), reads it from
the files memory-mapped (``torch.load(mmap=True, weights_only=True)``,
so a rank touches only the bytes it needs), assembles its pieces on the
host and copies them into the harness. Any layout whose records are
ranges of tp shards restores the same way: a save of the earlier
layout (whole parameters from fsdp index 0, the moments as ranges of
one flat bucket of every parameter) included. ``restore_params``
assembles the parameters whole, from every writer, for serving.

Two save paths share the protocol: ``save`` blocks for the device->host
snapshot and the persist; ``AsyncCheckpointManager`` blocks only for the
snapshot into pinned host buffers (two sets, so the in-flight persist
keeps its own) and persists in a writer thread behind a queue of depth
1, with the retention GC; a background failure re-raises at the next
``save``/``wait_until_finished``/``close``, after which the guard falls
back to the last committed step. With more than one process it takes
the blocking save, as the reference does.

Goodput (goodput/events.py) and spans (trace/spans.py): a blocking save
is ``checkpoint_save`` + ``checkpoint_persist`` (overlapped False), the
async snapshot ``checkpoint_save`` (mode "snapshot") +
``checkpoint_snapshot``, its persist ``checkpoint_async`` +
``checkpoint_persist`` (overlapped True), a restore
``checkpoint_restore`` of both.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import queue
import shutil
import threading
import time
import types
from typing import Optional

import torch
import torch.distributed as dist

from batch_shipyard_tpu_torch.agent import preemption
from batch_shipyard_tpu_torch.agent import progress
from batch_shipyard_tpu_torch.goodput import events as goodput_events
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import sharding
from batch_shipyard_tpu_torch.trace import spans as trace_spans

logger = logging.getLogger(__name__)

COMMIT_MARKER = "COMMITTED"
MESH_MARKER = "MESH"
LAYOUT_FILE = "layout.json"
FORMAT = "batch_shipyard_tpu_torch/1"


def _step_path(checkpoint_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir), f"step_{step:08d}")


def _staging_path(checkpoint_dir: str, step: int) -> str:
    return os.path.join(os.path.abspath(checkpoint_dir),
                        f".tmp_step_{step:08d}")


def _marker_path(checkpoint_dir: str, step: int) -> str:
    return _step_path(checkpoint_dir, step) + "." + COMMIT_MARKER


def _mesh_meta_path(checkpoint_dir: str, step: int) -> str:
    return _step_path(checkpoint_dir, step) + "." + MESH_MARKER


def _shard_file(rank: int) -> str:
    return f"rank{rank:05d}.pt"


def is_committed(checkpoint_dir: str, step: int) -> bool:
    return os.path.exists(_marker_path(checkpoint_dir, step))


def saved_mesh_meta(checkpoint_dir: str, step: int) -> Optional[dict]:
    """{"mesh_shape": {axis: size}, "mesh_devices": N} of a committed
    step, or None when it has no sidecar."""
    try:
        with open(_mesh_meta_path(checkpoint_dir, step),
                  encoding="utf-8") as fh:
            meta = json.load(fh)
    except (OSError, ValueError):
        return None
    return meta if isinstance(meta, dict) else None


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _barrier() -> None:
    """The multi-process commit barrier (the default gloo group): every
    rank's files must be durable before process 0 commits."""
    if _process_count() > 1:
        dist.barrier()


def _write_atomic(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).rsplit(".", 1)[-1]


def state_layout(harness, step: int) -> dict:
    """The layout.json of a save of ``harness``'s state at ``step``: the
    same on every rank (it depends on the mesh sizes and the model
    only)."""
    sizes, _ = harness.layout
    tensors = harness.state_tensors()
    shapes = {name: shape for name, (shape, _) in tensors.items()}
    records, ends = [], {}
    for rank, piece in sharding.written_pieces(shapes, sizes,
                                               harness.state_kinds):
        dtype = _dtype_name(tensors[piece.key][1])
        offset = ends.get((rank, dtype), 0)
        ends[rank, dtype] = offset + piece.size
        records.append({**dataclasses.asdict(piece),
                        "file": _shard_file(rank), "dtype": dtype,
                        "offset": offset})
    return {"format": FORMAT, "step": int(step),
            "optimizer_step": harness.optimizer_step, "mesh": dict(sizes),
            "tensors": [{"name": name, "shape": list(shape),
                         "dtype": _dtype_name(dtype)}
                        for name, (shape, dtype) in tensors.items()],
            "records": records}


def _piece(record: dict) -> sharding.Piece:
    return sharding.Piece(**{f.name: record[f.name]
                             for f in dataclasses.fields(sharding.Piece)})


@dataclasses.dataclass
class Snapshot:
    """One rank's share of a save, on the host: ``flats`` (dtype name ->
    one flat tensor of the pieces it writes, maybe none) and the save's
    layout; ``drain_ms``: the wait for the work already queued on the
    card (the step just enqueued), ``copy_ms``: the device->host copy."""

    step: int
    rank: int
    layout: dict
    flats: dict
    drain_ms: float = 0.0
    copy_ms: float = 0.0


class HostBuffers:
    """Host buffers reused save after save (pinned when the state is on
    the card), ``slots`` sets taken in turn."""

    def __init__(self, slots: int = 1) -> None:
        self._sets = [{} for _ in range(slots)]
        self._next = 0

    def take(self, sizes: dict, pin: bool) -> dict:
        buffers = self._sets[self._next]
        self._next = (self._next + 1) % len(self._sets)
        for dtype, n in sizes.items():
            old = buffers.get(dtype)
            if old is None or old.numel() != n:
                buffers[dtype] = torch.empty(n, dtype=getattr(torch, dtype),
                                             pin_memory=pin)
        return {dtype: buffers[dtype] for dtype in sizes}


def snapshot(harness, step: int,
             buffers: Optional[HostBuffers] = None) -> Snapshot:
    """Copy the pieces this rank writes into host buffers (the step
    boundary's blocking device->host copy), after the work queued on the
    card has drained."""
    started = time.perf_counter()
    on_card = harness.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(harness.device)
    drained = time.perf_counter()
    layout = state_layout(harness, step)
    rank = harness.mesh.rank if harness.mesh is not None else 0
    mine = [rec for rec in layout["records"]
            if rec["file"] == _shard_file(rank)]
    sizes: dict = {}
    for rec in mine:
        sizes[rec["dtype"]] = max(sizes.get(rec["dtype"], 0),
                                  rec["offset"] + rec["hi"] - rec["lo"])
    flats = (buffers or HostBuffers()).take(sizes, pin=on_card)
    pieces = harness.state_pieces()["pieces"]
    for rec in mine:
        flats[rec["dtype"]][rec["offset"]:rec["offset"] + rec["hi"] -
                            rec["lo"]].copy_(pieces[_piece(rec)],
                                             non_blocking=on_card)
    if on_card:
        torch.cuda.synchronize(harness.device)
    return Snapshot(int(step), rank, layout, flats,
                    drain_ms=(drained - started) * 1e3,
                    copy_ms=(time.perf_counter() - drained) * 1e3)


def write_snapshot(directory: str, snap: Snapshot) -> int:
    """Write one rank's file (and, from rank 0, layout.json) into
    ``directory``, fsynced; returns the bytes written."""
    written = 0
    if snap.flats:
        with open(os.path.join(directory, _shard_file(snap.rank)),
                  "wb") as fh:
            torch.save(snap.flats, fh)
            fh.flush()
            os.fsync(fh.fileno())
            written += fh.tell()
    if snap.rank == 0:
        text = json.dumps(snap.layout)
        _write_atomic(os.path.join(directory, LAYOUT_FILE), text)
        written += len(text)
    return written


def commit(checkpoint_dir: str, step: int, mesh_meta: dict) -> str:
    """Process 0's half of the protocol, after the barrier: replace the
    step dir by the staging dir, then write the .MESH sidecar and then
    the COMMITTED marker (each tmp + rename)."""
    path = _step_path(checkpoint_dir, step)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(_staging_path(checkpoint_dir, step), path)
    _write_atomic(_mesh_meta_path(checkpoint_dir, step),
                  json.dumps(mesh_meta))
    _write_atomic(_marker_path(checkpoint_dir, step),
                  preemption.utcnow_iso())
    return path


def _persist(checkpoint_dir: str, snap: Snapshot) -> int:
    """Staging dir -> this rank's files -> barrier -> commit -> barrier;
    returns the bytes this rank wrote. Shared by the blocking save and
    the async writer."""
    staging = _staging_path(checkpoint_dir, snap.step)
    if _process_index() == 0:
        os.makedirs(checkpoint_dir, exist_ok=True)
        shutil.rmtree(staging, ignore_errors=True)  # an earlier torn save
        os.makedirs(staging)
    _barrier()
    written = write_snapshot(staging, snap)
    _barrier()
    if _process_index() == 0:
        sizes = snap.layout["mesh"]
        commit(checkpoint_dir, snap.step, {
            "mesh_shape": sizes, "mesh_devices": math.prod(sizes.values())})
    _barrier()
    logger.info("checkpoint saved: %s", _step_path(checkpoint_dir,
                                                   snap.step))
    return written


def save(checkpoint_dir: str, step: int, harness, *, force: bool = False,
         buffers: Optional[HostBuffers] = None,
         stats: Optional[dict] = None) -> Optional[str]:
    """Save ``harness``'s state as step ``step`` (blocking; every rank of
    a mesh calls it). Returns the step's path, or None when the step is
    not newer than the latest committed one (``force`` overrides).
    ``stats``, when given, gets drain_ms and snapshot_ms (the copy:
    ``Snapshot``), persist_ms, blocking_ms and the bytes this rank
    wrote."""
    latest = latest_step(checkpoint_dir)
    if not force and latest is not None and step <= latest:
        logger.info("skipping checkpoint save of step %d: step %d is "
                    "already committed in %s", step, latest, checkpoint_dir)
        return None
    started = time.perf_counter()
    with goodput_events.phase(goodput_events.PROGRAM_CHECKPOINT_SAVE,
                              step=step), \
            trace_spans.phase(trace_spans.SPAN_CKPT_PERSIST, step=step,
                              overlapped=False):
        snap = snapshot(harness, step, buffers)
        snapped = time.perf_counter()
        written = _persist(checkpoint_dir, snap)
    if stats is not None:
        now = time.perf_counter()
        stats.update(drain_ms=snap.drain_ms, snapshot_ms=snap.copy_ms,
                     persist_ms=(now - snapped) * 1e3,
                     blocking_ms=(now - started) * 1e3, bytes=written)
    return _step_path(checkpoint_dir, step)


def _committed_steps(checkpoint_dir: str) -> list[int]:
    """Sorted steps that carry the COMMITTED marker and have their dir."""
    if not os.path.isdir(checkpoint_dir):
        return []
    steps = []
    for name in os.listdir(checkpoint_dir):
        if not (name.startswith("step_")
                and name.endswith("." + COMMIT_MARKER)):
            continue
        try:
            step = int(name.split("_", 1)[1].split(".", 1)[0])
        except ValueError:
            continue
        if os.path.isdir(_step_path(checkpoint_dir, step)):
            steps.append(step)
    return sorted(steps)


def retention_gc(checkpoint_dir: str, keep_last: int) -> list[int]:
    """Delete all but the newest ``keep_last`` committed steps (process 0
    only); returns the removed steps. Marker first, then .MESH, then the
    dir: a crash mid-GC leaves an unmarked, ignored dir."""
    if keep_last < 1 or _process_index() != 0:
        return []
    victims = _committed_steps(checkpoint_dir)[:-keep_last]
    for step in victims:
        for path in (_marker_path(checkpoint_dir, step),
                     _mesh_meta_path(checkpoint_dir, step)):
            try:
                os.remove(path)
            except OSError:
                pass
        shutil.rmtree(_step_path(checkpoint_dir, step), ignore_errors=True)
        logger.info("checkpoint retention: removed step %d from %s", step,
                    checkpoint_dir)
    return victims


def latest_step(checkpoint_dir: str) -> Optional[int]:
    """The highest committed step; once any marker exists, unmarked step
    dirs are torn saves and skipped (a dir with no marker at all keeps
    the legacy accept-all reading)."""
    if not os.path.isdir(checkpoint_dir):
        return None
    entries = os.listdir(checkpoint_dir)
    any_marker = any(name.endswith("." + COMMIT_MARKER) for name in entries)
    steps = []
    for name in entries:
        if not name.startswith("step_") or "." in name:
            continue
        try:
            step = int(name.split("_", 1)[1])
        except ValueError:
            continue
        if any_marker and not is_committed(checkpoint_dir, step):
            logger.warning("skipping uncommitted checkpoint %s (torn save)",
                           os.path.join(checkpoint_dir, name))
            continue
        steps.append(step)
    return max(steps) if steps else None


def _read_layout(path: str) -> dict:
    with open(os.path.join(path, LAYOUT_FILE), encoding="utf-8") as fh:
        return json.load(fh)


def _read_pieces(path: str, layout: dict, place, kinds) -> tuple:
    """Plan and read the pieces a rank at ``place`` (sizes, coords)
    holds, memory-mapping each file it touches."""
    plan = sharding.restore_plan_for(place, layout, kinds)
    files: dict = {}
    records = layout["records"]

    def fetch(index: int, lo: int, hi: int) -> torch.Tensor:
        rec = records[index]
        if rec["file"] not in files:
            files[rec["file"]] = torch.load(
                os.path.join(path, rec["file"]), mmap=True,
                weights_only=True)
        flat = files[rec["file"]][rec["dtype"]]
        return flat[rec["offset"] + lo:rec["offset"] + hi]

    return sharding.assemble(plan, layout, fetch), plan


def restore(checkpoint_dir: str, harness) -> Optional[dict]:
    """Load the latest committed step into ``harness`` (every rank of a
    mesh calls it), resharding when it was saved on another mesh. Returns
    None when nothing is committed, else {"step", "optimizer_step",
    "resharded", "saved_mesh", "read_fraction", "read_fraction_by_kind",
    "elements_read", "restore_ms"}. A checkpoint of another model's
    shapes raises."""
    step = latest_step(checkpoint_dir)
    if step is None:
        return None
    path = _step_path(checkpoint_dir, step)
    started = time.perf_counter()
    layout = _read_layout(path)
    sizes, coords = harness.layout
    saved = layout["mesh"]
    resharded = dict(saved) != dict(sizes)
    if resharded:
        logger.warning("checkpoint step %d was saved on mesh %s; "
                       "re-sharding onto %s", step, saved, sizes)
    sharding.check_shapes(
        {t["name"]: t["shape"] for t in layout["tensors"]},
        {name: shape for name, (shape, _) in
         harness.state_tensors().items()})
    with goodput_events.phase(goodput_events.PROGRAM_CHECKPOINT_RESTORE,
                              step=step, resharded=resharded), \
            trace_spans.phase(trace_spans.SPAN_CKPT_RESTORE, step=step,
                              resharded=resharded):
        pieces, plan = _read_pieces(
            path, layout, types.SimpleNamespace(sizes=sizes, coords=coords),
            harness.state_kinds)
        harness.load_state_pieces(pieces, layout["optimizer_step"])
        if harness.device.type == "cuda":
            torch.cuda.synchronize(harness.device)
    logger.info("checkpoint restored: %s", path)
    return {"step": layout["step"],
            "optimizer_step": layout["optimizer_step"],
            "resharded": resharded, "saved_mesh": saved,
            "read_fraction": plan["read_fraction"],
            "read_fraction_by_kind": plan["read_fraction_by_kind"],
            "elements_read": plan["elements_read"],
            "restore_ms": (time.perf_counter() - started) * 1e3}


def restore_params(checkpoint_dir: str) -> Optional[tuple]:
    """The parameters of the latest committed step, whole, on the host
    (serving: the optimizer state is not read): (state dict in the saved
    dtypes, step), or None. Any mesh's save assembles."""
    step = latest_step(checkpoint_dir)
    if step is None:
        return None
    path = _step_path(checkpoint_dir, step)
    with goodput_events.phase(goodput_events.PROGRAM_CHECKPOINT_RESTORE,
                              step=step), \
            trace_spans.phase(trace_spans.SPAN_CKPT_RESTORE, step=step):
        layout = _read_layout(path)
        sizes = mesh_mod.auto_axis_sizes(1)
        place = types.SimpleNamespace(
            sizes=sizes, coords=mesh_mod.RankMesh(sizes, 0).coords)
        pieces, _ = _read_pieces(path, layout, place, ("param",))
        by_name = {piece.key: tensor for piece, tensor in pieces.items()}
        params = {t["name"]: by_name[t["name"]].view(t["shape"])
                  for t in layout["tensors"]}
    logger.info("checkpoint params restored: %s", path)
    return params, layout["step"]


# --------------------------- the async pipeline ---------------------------


class AsyncCheckpointManager:
    """Saves that block only for the snapshot: ``save`` copies the state
    into host buffers (two sets, taken in turn: the in-flight persist
    keeps its own), waits for the previous persist (depth-1 queue) and
    enqueues; a writer thread runs the commit protocol and the retention
    GC. A failed persist re-raises at the next ``save`` /
    ``wait_until_finished`` / ``close``; the failed step is then
    forgotten, so the guard falls back to the last committed step."""

    def __init__(self, checkpoint_dir: str, keep_last: int = 0) -> None:
        self.checkpoint_dir = os.path.abspath(checkpoint_dir)
        self.keep_last = int(keep_last or 0)
        self._queue: queue.Queue = queue.Queue(maxsize=1)
        self._buffers = HostBuffers(slots=2)
        self._error: Optional[BaseException] = None
        self._last_enqueued: Optional[int] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._writer_loop, name="ckpt-async-writer", daemon=True)
        self._thread.start()

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                snap, stats = item
                try:
                    started = time.perf_counter()
                    with goodput_events.phase(
                            goodput_events.PROGRAM_CHECKPOINT_ASYNC,
                            step=snap.step), \
                            trace_spans.phase(
                                trace_spans.SPAN_CKPT_PERSIST,
                                step=snap.step, overlapped=True):
                        written = _persist(self.checkpoint_dir, snap)
                    stats.update(persist_ms=(time.perf_counter() -
                                             started) * 1e3, bytes=written)
                    if self.keep_last:
                        retention_gc(self.checkpoint_dir, self.keep_last)
                except BaseException as exc:  # noqa: BLE001 - handed to
                    # the trainer, never dropped
                    logger.error("async checkpoint save of step %d failed: "
                                 "%s", snap.step, exc)
                    self._error = exc
            finally:
                self._queue.task_done()

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            exc, self._error = self._error, None
            self._last_enqueued = latest_step(self.checkpoint_dir)
            raise exc

    def _should_skip(self, step: int) -> bool:
        # An enqueued step supersedes the disk; the dir is read only
        # before the first enqueue and after an error.
        if self._last_enqueued is not None:
            return step <= self._last_enqueued
        high_water = latest_step(self.checkpoint_dir)
        return high_water is not None and step <= high_water

    def save(self, step: int, harness,
             stats: Optional[dict] = None) -> Optional[str]:
        """Snapshot and enqueue; returns the step's eventual path, or None
        when the step is not newer than the latest committed or enqueued
        one. ``stats`` gets drain_ms, snapshot_ms and blocking_ms now,
        persist_ms and bytes once the writer is done."""
        if self._closed:
            raise RuntimeError("AsyncCheckpointManager is closed")
        self._raise_pending_error()
        step = int(step)
        stats = {} if stats is None else stats
        if self._should_skip(step):
            logger.info("skipping async checkpoint save of step %d: not "
                        "newer than the latest committed/in-flight step",
                        step)
            return None
        if _process_count() > 1:
            # The commit barrier in a writer thread would interleave with
            # the step loop's collectives: take the blocking protocol.
            logger.warning("async checkpointing is single-process only; "
                           "falling back to the blocking save for step %d",
                           step)
            path = save(self.checkpoint_dir, step, harness, force=True,
                        buffers=self._buffers, stats=stats)
            if self.keep_last:
                retention_gc(self.checkpoint_dir, self.keep_last)
            self._last_enqueued = step
            return path
        started = time.perf_counter()
        with goodput_events.phase(goodput_events.PROGRAM_CHECKPOINT_SAVE,
                                  step=step, mode="snapshot"), \
                trace_spans.phase(trace_spans.SPAN_CKPT_SNAPSHOT, step=step):
            # Snapshot first (into the other buffer set), so the persist in
            # flight overlaps the copy; then wait out the depth-1 bound.
            snap = snapshot(harness, step, self._buffers)
            stats.update(drain_ms=snap.drain_ms, snapshot_ms=snap.copy_ms)
            self._queue.join()
            self._raise_pending_error()
            self._queue.put((snap, stats))
            self._last_enqueued = step
        stats["blocking_ms"] = (time.perf_counter() - started) * 1e3
        return _step_path(self.checkpoint_dir, step)

    def wait_until_finished(self) -> None:
        """Drain the in-flight persist; re-raises its failure."""
        self._queue.join()
        self._raise_pending_error()

    def restore(self, harness) -> Optional[dict]:
        """Drain, then restore the latest committed step."""
        self.wait_until_finished()
        return restore(self.checkpoint_dir, harness)

    def close(self) -> None:
        """Drain, stop the writer thread, re-raise any failure."""
        if self._closed:
            return
        self._closed = True
        self._queue.join()
        self._queue.put(None)
        self._thread.join(timeout=60.0)
        self._raise_pending_error()

    def __enter__(self) -> "AsyncCheckpointManager":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


# ---------------------- the train loop's checkpointer ----------------------


def add_checkpoint_args(parser) -> None:
    """The checkpoint flags of the train workloads."""
    group = parser.add_argument_group("checkpointing")
    group.add_argument("--checkpoint-dir", default=None,
                       help="checkpoint dir (on pools, the job's shared "
                            "dir, which every rank sees)")
    group.add_argument("--checkpoint-every", type=int, default=0,
                       help="save every N steps (0 = only at the end)")
    group.add_argument("--async-checkpoint", action="store_true",
                       help="block only for the snapshot at the step "
                            "boundary; persist in a background writer "
                            "thread")
    group.add_argument("--keep-last", type=int, default=0,
                       help="retention: keep only the newest N committed "
                            "checkpoints (0 = keep all)")


class TrainCheckpointer:
    """The train loop's checkpointer: restore at the start, saves on
    a cadence, the cooperative preempt drain, a deduplicated final save
    and the drain at exit, over the blocking save or an
    AsyncCheckpointManager. ``saves`` lists each save's stats and
    ``restored`` the restore's."""

    def __init__(self, checkpoint_dir: Optional[str] = None, every: int = 0,
                 use_async: bool = False, keep_last: int = 0) -> None:
        self.checkpoint_dir = checkpoint_dir
        self.every = int(every or 0)
        self.keep_last = int(keep_last or 0)
        self.manager: Optional[AsyncCheckpointManager] = None
        if checkpoint_dir and use_async:
            self.manager = AsyncCheckpointManager(checkpoint_dir,
                                                  keep_last=self.keep_last)
        self._buffers = HostBuffers()
        # $SHIPYARD_PREEMPT_REQUEST_FILE, polled at step boundaries.
        self._preempt = preemption.PreemptWatcher()
        self.saves: list[dict] = []
        self.restored: Optional[dict] = None

    @classmethod
    def from_args(cls, args) -> "TrainCheckpointer":
        return cls(checkpoint_dir=args.checkpoint_dir,
                   every=args.checkpoint_every,
                   use_async=args.async_checkpoint,
                   keep_last=args.keep_last)

    @property
    def enabled(self) -> bool:
        return bool(self.checkpoint_dir)

    def due(self, completed_steps: int) -> bool:
        """True when the loop saves at this step boundary."""
        return bool(self.enabled and self.every
                    and completed_steps % self.every == 0)

    def restore(self, harness) -> int:
        """Load the latest committed step into ``harness``; returns the
        step to start from (0 when disabled or nothing is committed)."""
        if not self.enabled:
            return 0
        if self.manager is not None:
            self.restored = self.manager.restore(harness)
        else:
            self.restored = restore(self.checkpoint_dir, harness)
        return 0 if self.restored is None else self.restored["step"]

    def _save(self, step: int, harness) -> None:
        stats = {"step": step}
        if self.manager is not None:
            path = self.manager.save(step, harness, stats=stats)
        else:
            path = save(self.checkpoint_dir, step, harness,
                        buffers=self._buffers, stats=stats)
            if path is not None and self.keep_last:
                retention_gc(self.checkpoint_dir, self.keep_last)
        if path is not None:
            self.saves.append(stats)
        # What preempting this task would cost: the steps since this one.
        progress.record_sched_hints(ckpt_step=step)

    def step_save(self, completed_steps: int, harness) -> bool:
        """The cadenced save at a step boundary; no-op off cadence."""
        if not self.due(completed_steps):
            return False
        self._save(completed_steps, harness)
        return True

    def _agreed(self, request: Optional[dict]) -> bool:
        """Whether every rank drains at this boundary. The agent drops the
        request into each rank's dir, so ranks see it at different
        boundaries; a rank that drained alone would leave the others
        stuck in the next step's collectives. So when the watcher has a
        path (the agent sets it on every rank), one all-reduce (MAX) of a
        flag over the default group decides for all; unconfigured runs
        pay nothing."""
        if not (self._preempt.configured and _process_count() > 1):
            return request is not None
        flag = torch.tensor([int(request is not None)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

    def maybe_preempt(self, completed_steps: int, harness) -> bool:
        """True when a preempt request is pending (on any rank): a
        committed checkpoint of this boundary has been forced (an async
        persist drained first) and the caller must flush its step window
        and exit ``preemption.EXIT_PREEMPTED``."""
        if not self._agreed(self._preempt.poll()):
            return False
        if self.enabled:
            stats = {"step": completed_steps}
            if self.manager is not None:
                path = self.manager.save(completed_steps, harness,
                                         stats=stats)
                self.manager.close()
            else:
                path = save(self.checkpoint_dir, completed_steps, harness,
                            buffers=self._buffers, stats=stats)
            if path is not None:
                self.saves.append(stats)
        logger.warning("preempt drain complete at step %d%s; exiting with "
                       "the preempted status", completed_steps,
                       "" if self.enabled else
                       " (no checkpoint dir configured)")
        return True

    def finalize(self, final_step: int, harness) -> None:
        """The exit save (skipped by the guard when the cadenced save
        already committed or enqueued this step) and the drain."""
        if not self.enabled:
            return
        try:
            self._save(final_step, harness)
        finally:
            if self.manager is not None:
                self.manager.close()
