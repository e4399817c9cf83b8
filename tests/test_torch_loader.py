"""The port's input pipeline (data/loader.py) against the reference's
(batch_shipyard_tpu/data/loader.py) on the CPU: the same synthetic
ImageNet shards, and from them the same batches, byte for byte, for one
rank and for each of two ranks (round-robin shards, the seeded shuffle,
rows carried across shard ends and epochs); prefetch keeps the order and
stops with its consumer; the on-device normalisation is the reference's
to the bit."""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.data import loader as jloader
from batch_shipyard_tpu_torch.data import loader as tloader

SHARDS, PER_SHARD, IMAGE = 5, 12, 8


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    port = tmp_path_factory.mktemp("port")
    ref = tmp_path_factory.mktemp("ref")
    tloader.write_synthetic_imagenet_shards(str(port), SHARDS, PER_SHARD,
                                            IMAGE, num_classes=10, seed=3)
    jloader.write_synthetic_imagenet_shards(str(ref), SHARDS, PER_SHARD,
                                            IMAGE, num_classes=10, seed=3)
    return port, ref


def test_synthetic_shards_equal_reference(shards):
    port, ref = shards
    names = sorted(p.name for p in port.iterdir())
    assert names == sorted(p.name for p in ref.iterdir())
    assert len(names) == SHARDS
    for name in names:
        with np.load(port / name) as a, np.load(ref / name) as b:
            assert a.files == b.files
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def _take(dataset, n):
    out = []
    for batch in dataset:
        out.append(batch)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("batch", [5, 12])
def test_sharded_dataset_batches_equal_reference(shards, world, batch):
    """Enough batches to cross shard ends (carry-over) and a second epoch
    (a fresh shuffle of the same RandomState)."""
    port, _ = shards
    for rank in range(world):
        kwargs = dict(process_index=rank, process_count=world, seed=11)
        got_ds = tloader.ShardedDataset(str(port), batch, **kwargs)
        want_ds = jloader.ShardedDataset(str(port), batch, **kwargs)
        assert got_ds.shards == want_ds.shards
        n = 2 * len(got_ds.shards) * PER_SHARD // batch + 1
        got, want = _take(got_ds, n), _take(want_ds, n)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for key in g:
                assert g[key].dtype == w[key].dtype
                assert g[key].tobytes() == w[key].tobytes()


def test_sharded_dataset_without_loop_stops_like_reference(shards):
    port, _ = shards
    got = list(tloader.ShardedDataset(str(port), 7, 0, 1, loop=False))
    want = list(jloader.ShardedDataset(str(port), 7, 0, 1, loop=False))
    assert len(got) == len(want) == SHARDS * PER_SHARD // 7
    for g, w in zip(got, want):
        assert g["images"].tobytes() == w["images"].tobytes()


def test_sharded_dataset_refuses_empty_assignments(tmp_path):
    with pytest.raises(ValueError, match="no .npy/.npz shards"):
        tloader.ShardedDataset(str(tmp_path), 4, 0, 1)
    tloader.write_synthetic_imagenet_shards(str(tmp_path), 1, 4, 4)
    with pytest.raises(ValueError, match="no shards assigned"):
        tloader.ShardedDataset(str(tmp_path), 4, 1, 2)


def test_bare_npy_shards_yield_data(tmp_path):
    for i in range(2):
        np.save(tmp_path / f"part_{i}.npy", np.arange(6) + 10 * i)
    got = _take(tloader.ShardedDataset(str(tmp_path), 4, 0, 1, seed=1), 3)
    want = _take(jloader.ShardedDataset(str(tmp_path), 4, 0, 1, seed=1), 3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["data"], w["data"])


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_keeps_order_and_places_tensors(depth):
    batches = [{"x": np.full((2, 3), i, np.float32),
                "y": np.array([i, -i], np.int32)} for i in range(7)]
    got = list(tloader.prefetch_to_device(iter(batches), "cpu", depth))
    assert len(got) == len(batches)
    for i, batch in enumerate(got):
        assert isinstance(batch["x"], torch.Tensor)
        assert batch["y"].dtype == torch.int32
        assert torch.equal(batch["x"], torch.full((2, 3), float(i)))


def test_prefetch_stops_with_its_consumer_and_raises_producer_errors():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.array([i])}
            i += 1
    gen = tloader.prefetch_to_device(endless(), "cpu", depth=2)
    assert int(next(gen)["x"][0]) == 0
    gen.close()
    before = threading.active_count()
    time.sleep(0.5)
    count = len(produced)
    time.sleep(0.3)
    assert len(produced) == count  # the producer stopped
    assert threading.active_count() <= before

    def broken():
        yield {"x": np.array([1])}
        raise RuntimeError("shard read failed")
    gen = tloader.prefetch_to_device(broken(), "cpu", depth=1)
    assert int(next(gen)["x"][0]) == 1
    with pytest.raises(RuntimeError, match="shard read failed"):
        next(gen)
    with pytest.raises(ValueError):
        next(tloader.prefetch_to_device(iter([]), "cpu", depth=0))


def test_normalize_images_matches_reference_bits():
    images = np.arange(256, dtype=np.uint8).reshape(4, 8, 8, 1)
    want = (jnp.asarray(images).astype(jnp.float32) / 127.5 - 1.0).astype(
        jnp.bfloat16)
    got = tloader.normalize_images(torch.from_numpy(images))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_synthetic_batches_and_place_on_cpu():
    stream = tloader.synthetic_batches(lambda step: {"step": np.array(
        [step])})
    assert [int(next(stream)["step"][0]) for _ in range(3)] == [0, 1, 2]
    placed = tloader.place({"a": np.ones(3, np.float32)}, "cpu")
    assert placed["a"].device.type == "cpu"
