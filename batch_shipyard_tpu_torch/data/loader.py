"""Input pipeline: sharded datasets with background host->device
prefetch.

Counterpart of batch_shipyard_tpu/data/loader.py:

- ``ShardedDataset``: the .npy/.npz shards of a directory, assigned
  round-robin to the ranks (``process_index`` / ``process_count``, by
  default the torch.distributed rank and world), shuffled per epoch by
  ``np.random.RandomState(seed)``, rows carried across shard ends into
  full batches: the reference's assignment, order and carry-over, so the
  same shards and seed give the same batches byte for byte. .npz shards
  yield their named arrays (images/labels), bare .npy ones ``data``;
- ``synthetic_batches``: an endless batch stream from a function of the
  step;
- ``place``: one host batch onto the device. On the card each array is
  copied into pinned host memory and from there with a non-blocking copy
  on a side stream; the consumer's current stream waits on an event
  recorded after the copies (no host synchronisation), and each tensor is
  marked as used by that stream, so the caching allocator keeps it until
  the consumer's work is done;
- ``prefetch_to_device``: ``place`` on a background thread, ``depth``
  batches ahead, the tf.data.prefetch analog; the thread stops when the
  consumer closes or abandons the generator;
- ``normalize_images``: ResNet's uint8 -> bf16 ``img / 127.5 - 1`` on the
  device (the reference's ``workloads/train_resnet.py:75-80``: a quarter
  of the bytes over PCIe, and the card does the cast);
- ``write_synthetic_imagenet_shards``: ImageNet-shaped .npz shards.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist


def _rank_and_world() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedDataset:
    """Iterate batches from .npy/.npz shards, partitioned across
    processes."""

    def __init__(self, shard_dir: str, batch_size: int,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 loop: bool = True, seed: int = 0) -> None:
        self.shard_dir = shard_dir
        self.batch_size = batch_size
        self.loop = loop
        self.seed = seed
        rank, world = _rank_and_world()
        pidx = process_index if process_index is not None else rank
        pcnt = process_count if process_count is not None else world
        shards = sorted(
            os.path.join(shard_dir, name)
            for name in os.listdir(shard_dir)
            if name.endswith((".npy", ".npz")))
        if not shards:
            raise ValueError(f"no .npy/.npz shards in {shard_dir}")
        # Round-robin shard assignment across ranks.
        self.shards = shards[pidx::pcnt]
        if not self.shards:
            raise ValueError(
                f"process {pidx}/{pcnt}: no shards assigned "
                f"({len(shards)} total)")

    def _load(self, path: str) -> dict[str, np.ndarray]:
        if path.endswith(".npz"):
            with np.load(path) as data:
                return {k: data[k] for k in data.files}
        return {"data": np.load(path)}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        rng = np.random.RandomState(self.seed)
        while True:
            order = list(self.shards)
            rng.shuffle(order)
            carry: dict[str, list] = collections.defaultdict(list)
            carried = 0
            for path in order:
                arrays = self._load(path)
                n = len(next(iter(arrays.values())))
                start = 0
                while start < n:
                    take = min(self.batch_size - carried, n - start)
                    for key, arr in arrays.items():
                        carry[key].append(arr[start:start + take])
                    carried += take
                    start += take
                    if carried == self.batch_size:
                        yield {k: np.concatenate(v)
                               for k, v in carry.items()}
                        carry = collections.defaultdict(list)
                        carried = 0
            if not self.loop:
                return


def synthetic_batches(make_batch: Callable[[int], dict]) -> Iterator[dict]:
    """Infinite synthetic batches (hermetic benches)."""
    step = 0
    while True:
        yield make_batch(step)
        step += 1


def _stage(batch: dict, device: torch.device, stream) -> tuple:
    """Pinned, non-blocking copies of ``batch`` onto the card on
    ``stream``: (tensors, an event recorded after the copies)."""
    with torch.cuda.stream(stream):
        staged = {key: torch.as_tensor(value).pin_memory().to(
            device, non_blocking=True) for key, value in batch.items()}
        done = torch.cuda.Event()
        done.record(stream)
    return staged, done


def _hand_over(staged: dict, done, consumer) -> dict:
    """Make ``consumer`` wait for the copies (on the card, not the host)
    and keep the tensors alive for its work."""
    consumer.wait_event(done)
    for tensor in staged.values():
        tensor.record_stream(consumer)
    return staged


def place(batch: dict, device) -> dict:
    """One host batch (numpy arrays or CPU tensors) onto ``device``. On
    the card: pinned copies, non-blocking on a side stream, which the
    current stream then waits on."""
    device = torch.device(device)
    if device.type != "cuda":
        return {key: torch.as_tensor(value).to(device)
                for key, value in batch.items()}
    staged, done = _stage(batch, device, torch.cuda.Stream(device))
    return _hand_over(staged, done, torch.cuda.current_stream(device))


def prefetch_to_device(batches: Iterator[dict], device,
                       depth: int = 2) -> Iterator[dict]:
    """Stage upcoming batches onto ``device`` on a background thread,
    ``depth`` ahead. The thread pins and copies on its own side stream;
    the consumer's stream waits on each batch's copies when it takes the
    batch. The producer stops when the consumer abandons or closes the
    generator (no leaked device batches)."""
    if depth < 1:
        raise ValueError("prefetch depth must be >= 1")
    device = torch.device(device)
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    sentinel = object()
    on_card = device.type == "cuda"
    consumer = torch.cuda.current_stream(device) if on_card else None

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            stream = torch.cuda.Stream(device) if on_card else None
            for batch in batches:
                if stop.is_set():
                    return
                item = (_stage(batch, device, stream) if on_card
                        else (place(batch, device), None))
                if not _put(item):
                    return
        except Exception as exc:  # noqa: BLE001
            _put(exc)
            return
        _put(sentinel)

    thread = threading.Thread(target=producer, daemon=True, name="prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                return
            if isinstance(item, Exception):
                raise item
            staged, done = item
            yield staged if done is None else _hand_over(staged, done,
                                                         consumer)
    finally:
        stop.set()


def normalize_images(images: torch.Tensor,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 pixels -> ``img / 127.5 - 1`` in ``dtype``, computed in fp32
    where the tensor lies (the card, for a placed batch)."""
    return (images.float() / 127.5 - 1.0).to(dtype)


def write_synthetic_imagenet_shards(
        out_dir: str, num_shards: int = 4, per_shard: int = 512,
        image_size: int = 64, num_classes: int = 1000,
        seed: int = 0) -> list[str]:
    """Materialize synthetic ImageNet-shaped .npz shards (tooling for
    recipes/tests; real data is staged into the directory)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for idx in range(num_shards):
        path = os.path.join(out_dir, f"shard_{idx:05d}.npz")
        np.savez(
            path,
            images=rng.randint(
                0, 255, (per_shard, image_size, image_size, 3),
                dtype=np.uint8),
            labels=rng.randint(0, num_classes, (per_shard,),
                               dtype=np.int32))
        paths.append(path)
    return paths
