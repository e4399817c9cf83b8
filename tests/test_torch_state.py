"""The port's state store (batch_shipyard_tpu_torch/state) against the
reference's on the CPU: one sequence of calls on the port's and on the
reference's MemoryStateStore gives the same results (generations and
their preconditions, streams, leases and their expiry, entities with
etags, partition and prefix queries, group counts, queue visibility,
claims and receipts), apart from the random tokens and ids, which are
compared by the shape of their use. And the names the port copies are
the reference's."""

import time

import pytest

from batch_shipyard_tpu.state import base as ref_base
from batch_shipyard_tpu.state import names as ref_names
from batch_shipyard_tpu.state.memory import MemoryStateStore as RefStore
from batch_shipyard_tpu_torch.state import base
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore

ERRORS = ("NotFoundError", "PreconditionFailedError", "EntityExistsError",
          "EtagMismatchError", "LeaseLostError")


def _call(log, fn, *args, **kwargs):
    """fn's result, or the name of the store error it raised, appended to
    ``log``."""
    try:
        out = fn(*args, **kwargs)
    except (KeyError, RuntimeError) as err:
        name = type(err).__name__
        assert name in ERRORS, err
        log.append(("raised", name))
        return None
    log.append(out)
    return out


def _strip(row):
    """An entity with its etag (random) reduced to its presence."""
    return {k: (v if k != "_etag" else bool(v)) for k, v in row.items()}


def _objects(store, log):
    call = lambda fn, *a, **k: _call(log, fn, *a, **k)  # noqa: E731
    call(store.put_object, "a/1", b"one")
    call(store.put_object, "a/1", b"two", if_generation_match=0)
    gen = store.get_object_meta("a/1").generation
    call(store.put_object, "a/1", b"three", if_generation_match=gen + 5)
    call(store.put_object, "a/1", b"three", if_generation_match=gen)
    call(store.put_object, "a/2", b"x" * 100, if_generation_match=0)
    call(store.get_object, "a/1")
    meta = store.get_object_meta("a/2")
    log.append((meta.key, meta.size, meta.generation))
    call(store.get_object, "missing")
    call(store.list_objects, "a/")
    call(store.list_objects, "")
    call(store.object_exists, "a/2")
    call(store.object_exists, "b")
    call(store.delete_object, "a/2", if_generation_match=999)
    call(store.delete_object, "a/2")
    call(store.delete_object, "a/2")
    call(store.put_object_stream, "s", iter([b"ab", b"cd", b"e"]))
    log.append(list(store.get_object_stream("s", chunk_size=2)))


def _leases(store, log):
    held = store.acquire_lease("lock", 0.2, "node-a")
    log.append((held.key, held.owner))
    log.append(store.acquire_lease("lock", 0.2, "node-b"))
    renewed = store.renew_lease(held, 0.2)
    log.append(renewed.token == held.token)
    _call(log, store.release_lease, type(held)(
        key="lock", owner="node-b", token="forged", expires_at=0.0))
    time.sleep(0.25)
    stolen = store.acquire_lease("lock", 5.0, "node-b")
    log.append(stolen.owner)
    _call(log, store.renew_lease, held, 1.0)
    _call(log, store.release_lease, stolen)
    _call(log, store.release_lease, stolen)


def _tables(store, log):
    call = lambda fn, *a, **k: _call(log, fn, *a, **k)  # noqa: E731
    etag = store.insert_entity("t", "p1", "r1", {"state": "queued", "n": 1})
    call(store.insert_entity, "t", "p1", "r1", {"state": "x"})
    call(store.merge_entity, "t", "p1", "r1", {"n": 2}, if_match="stale")
    new = store.merge_entity("t", "p1", "r1", {"n": 2}, if_match=etag)
    log.append(new != etag)
    call(store.merge_entity, "t", "p1", "nope", {"n": 3})
    store.upsert_entity("t", "p1", "r2", {"state": "running"})
    store.insert_entities("t", [("p2", "r1", {"state": "queued"}),
                                ("p1", "r3", {})])
    call(store.insert_entities, "t", [("p3", "r1", {}), ("p1", "r1", {})])
    log.append(_strip(store.get_entity("t", "p1", "r1")))
    log.append([_strip(r) for r in store.query_entities("t")])
    log.append([_strip(r) for r in store.query_entities(
        "t", partition_key="p1", row_key_prefix="r")])
    log.append([r["_rk"] for r in store.query_entities(
        "t", row_key_prefix="r1")])
    log.append(store.count_entities_by("t", "p1"))
    call(store.delete_entity, "t", "p1", "r2", if_match="stale")
    store.delete_entity("t", "p1", "r2")
    call(store.delete_entity, "t", "p1", "r2")
    call(store.get_entity, "t", "p1", "r2")


def _queues(store, log):
    call = lambda fn, *a, **k: _call(log, fn, *a, **k)  # noqa: E731
    store.put_message("q", b"first")
    store.put_messages("q", [b"second", b"third"])
    store.put_message("q", b"later", delay_seconds=30.0)
    log.append(store.queue_length("q"))
    got = store.get_messages("q", max_messages=2, visibility_timeout=0.2)
    log.append([(m.payload, m.dequeue_count) for m in got])
    log.append([m.payload for m in store.get_messages("q", 5)])
    time.sleep(0.25)
    again = store.get_messages("q", max_messages=5, visibility_timeout=30)
    log.append([(m.payload, m.dequeue_count) for m in again])
    call(store.delete_message, got[0])  # the receipt was superseded
    store.delete_message(again[0])
    kept = store.update_message(again[1], 0.0)
    log.append(kept.payload)
    log.append([m.payload for m in store.get_messages("q", 5)])
    log.append(store.queue_length("q"))
    call(store.update_message, got[0], 1.0)


@pytest.mark.parametrize("script", [_objects, _leases, _tables, _queues])
def test_port_store_behaves_as_the_references(script):
    got, want = [], []
    script(MemoryStateStore(), got)
    script(RefStore(), want)
    assert got == want


def test_clear_and_errors_are_the_interfaces():
    store = MemoryStateStore()
    store.put_object("k", b"v")
    store.insert_entity("t", "p", "r", {})
    store.put_message("q", b"m")
    store.clear()
    assert store.list_objects() == [] and store.queue_length("q") == 0
    assert list(store.query_entities("t")) == []
    assert isinstance(store, base.StateStore)
    for name in ERRORS:
        assert issubclass(getattr(base, name),
                          getattr(ref_base, name).__mro__[1])


def test_names_are_the_references():
    assert names.TABLE_GOODPUT == ref_names.TABLE_GOODPUT
    assert names.TABLE_TRACE == ref_names.TABLE_TRACE
    for fn in ("compile_cache_key", "compile_cache_lease_key"):
        assert getattr(names, fn)("pool1", "idA") == \
            getattr(ref_names, fn)("pool1", "idA")
    assert names.compile_cache_latest_key("pool1") == \
        ref_names.compile_cache_latest_key("pool1")
