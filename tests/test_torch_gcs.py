"""The port's GCS state store (batch_shipyard_tpu_torch/state/gcs.py) on
the CPU, over the in-memory fake of google.cloud.storage
(tests/fake_gcs.py): the port's store contract scripts give the same
results on the port's GCSStateStore as on the reference's; the
concurrent claim, lease and queue races have one winner; and both
packages' stores on ONE fake bucket read each other's objects, entities,
claimed messages and leases. The factory builds ``gcs`` from a bucket,
and google.cloud is imported only inside the store's constructor."""

import ast
import concurrent.futures
import pathlib
import time

import pytest

from batch_shipyard_tpu.state import gcs as ref_gcs
from batch_shipyard_tpu_torch.config.settings import (
    StorageCredentialsSettings)
from batch_shipyard_tpu_torch.state import factory
from batch_shipyard_tpu_torch.state import gcs
from batch_shipyard_tpu_torch.state.base import (
    EtagMismatchError, LeaseLostError, NotFoundError)
from tests import fake_gcs
from tests.test_torch_state import _leases, _objects, _queues, _tables

REPO = pathlib.Path(__file__).resolve().parent.parent


def _store(module, client=None, prefix="t"):
    return module.GCSStateStore(
        "fake", prefix=prefix, client=client or fake_gcs.FakeClient(),
        exceptions_module=fake_gcs.FakeExceptionsModule)


class _GenerationEtags:
    """A store whose etags are generations (GCS's): the scripts' stale
    etag "stale" becomes generation 0, which no entity has."""

    def __init__(self, store):
        self._store = store

    def __getattr__(self, name):
        attr = getattr(self._store, name)
        if name not in ("merge_entity", "delete_entity"):
            return attr

        def call(*args, if_match=None, **kwargs):
            if if_match == "stale":
                if_match = "0"
            return attr(*args, if_match=if_match, **kwargs)
        return call


@pytest.mark.parametrize("script", [_objects, _leases, _tables, _queues],
                         ids=lambda f: f.__name__.strip("_"))
def test_port_gcs_store_behaves_as_the_references(script):
    got, want = [], []
    script(_GenerationEtags(_store(gcs)), got)
    script(_GenerationEtags(_store(ref_gcs)), want)
    assert got == want


def test_lease_contention_single_winner():
    store = _store(gcs)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        handles = list(pool.map(
            lambda i: store.acquire_lease("gate", 30.0, f"n{i}"),
            range(16)))
    assert sum(h is not None for h in handles) == 1


def test_entity_claim_race_single_winner():
    store = _store(gcs)
    etag = store.insert_entity("tasks", "p", "t", {"state": "queued"})

    def claim(i):
        try:
            store.merge_entity("tasks", "p", "t",
                               {"state": "running", "by": i}, if_match=etag)
            return True
        except EtagMismatchError:
            return False

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        won = list(pool.map(claim, range(16)))
    assert sum(won) == 1
    assert store.get_entity("tasks", "p", "t")["state"] == "running"


def test_queue_consumers_never_double_claim():
    store = _store(gcs)
    store.put_messages("q", [b"m%d" % i for i in range(20)])
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        batches = list(pool.map(
            lambda _: store.get_messages("q", max_messages=20,
                                         visibility_timeout=30.0),
            range(4)))
    payloads = [m.payload for batch in batches for m in batch]
    assert sorted(payloads) == sorted(b"m%d" % i for i in range(20))


def test_lease_ops_on_a_missing_lease_raise_lease_lost():
    store = _store(gcs)
    handle = store.acquire_lease("l", 30.0, "a")
    store.release_lease(handle)
    with pytest.raises(LeaseLostError):
        store.renew_lease(handle, 1.0)
    with pytest.raises(LeaseLostError):
        store.release_lease(handle)


@pytest.fixture()
def shared():
    """Both packages' stores on one fake bucket and prefix."""
    client = fake_gcs.FakeClient()
    return {"ref": _store(ref_gcs, client, "shipyardtpu"),
            "port": _store(gcs, client, "shipyardtpu")}


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_objects_cross_read(shared, writer, reader):
    w, r = shared[writer], shared[reader]
    gen = w.put_object("outputs/a", b"payload")
    w.put_object_stream("outputs/big", iter([b"x" * 5, b"y" * 5]))
    assert r.get_object("outputs/a") == b"payload"
    assert r.get_object_meta("outputs/a").generation == gen
    assert b"".join(r.get_object_stream("outputs/big", chunk_size=3)) == \
        b"xxxxxyyyyy"
    assert r.list_objects("outputs/") == ["outputs/a", "outputs/big"]
    # The reader's conditional write honours the writer's generation.
    r.put_object("outputs/a", b"second", if_generation_match=gen)
    assert w.get_object("outputs/a") == b"second"


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_entities_cross_read(shared, writer, reader):
    w, r = shared[writer], shared[reader]
    w.insert_entity("tasks", "pool$job", "t0", {"state": "queued", "n": 1})
    w.upsert_entity("nodes", "pool", "n0", {"state": "idle"})
    row = r.get_entity("tasks", "pool$job", "t0")
    assert (row["state"], row["n"]) == ("queued", 1)
    etag = r.merge_entity("tasks", "pool$job", "t0", {"state": "running"},
                          if_match=row["_etag"])
    assert w.get_entity("tasks", "pool$job", "t0")["_etag"] == etag
    with pytest.raises(Exception) as stale:
        w.merge_entity("tasks", "pool$job", "t0", {"state": "x"},
                       if_match=row["_etag"])
    assert type(stale.value).__name__ == "EtagMismatchError"
    assert [x["_rk"] for x in r.query_entities("nodes", "pool")] == ["n0"]
    assert r.count_entities_by("tasks", "pool$job", "state") == {
        "running": 1}
    r.delete_entity("tasks", "pool$job", "t0")
    with pytest.raises(KeyError):
        w.get_entity("tasks", "pool$job", "t0")


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_claimed_messages_cross_read(shared, writer, reader):
    w, r = shared[writer], shared[reader]
    w.put_messages("pool-q-0", [b"task-a", b"task-b"])
    assert r.queue_length("pool-q-0") == 2
    claimed, = w.get_messages("pool-q-0", max_messages=1,
                              visibility_timeout=0.3)
    # The writer's claim hides the message from the reader.
    other = r.get_messages("pool-q-0", max_messages=5,
                           visibility_timeout=30.0)
    assert [m.payload for m in other] == [b"task-b"]
    time.sleep(0.35)
    again, = r.get_messages("pool-q-0", max_messages=5,
                            visibility_timeout=30.0)
    assert (again.payload, again.dequeue_count) == (claimed.payload, 2)
    # The writer's receipt is stale now; the reader's deletes.
    with pytest.raises(KeyError):
        w.delete_message(claimed)
    r.delete_message(again)
    r.delete_message(other[0])
    assert w.queue_length("pool-q-0") == 0


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_leases_cross_read(shared, writer, reader):
    w, r = shared[writer], shared[reader]
    held = w.acquire_lease("cascade/pool/img", 0.3, "node-a")
    assert held is not None
    assert r.acquire_lease("cascade/pool/img", 0.3, "node-b") is None
    time.sleep(0.35)
    stolen = r.acquire_lease("cascade/pool/img", 5.0, "node-b")
    assert stolen is not None and stolen.owner == "node-b"
    with pytest.raises(RuntimeError):
        w.renew_lease(held, 1.0)
    w.release_lease(stolen)  # the token is the lease
    assert r.acquire_lease("cascade/pool/img", 5.0, "node-c") is not None


def test_factory_builds_gcs_from_a_bucket(monkeypatch):
    storage = StorageCredentialsSettings(
        backend="gcs", bucket=None, prefix="shipyardtpu", root=None)
    with pytest.raises(ValueError, match="bucket"):
        factory.create_statestore(storage)
    built = []

    class Recorder(gcs.GCSStateStore):
        def __init__(self, bucket, prefix="shipyardtpu", **kw):
            built.append((bucket, prefix))
            super().__init__(bucket, prefix=prefix,
                             client=fake_gcs.FakeClient(),
                             exceptions_module=fake_gcs.FakeExceptionsModule)

    monkeypatch.setattr(gcs, "GCSStateStore", Recorder)
    store = factory.create_statestore(StorageCredentialsSettings(
        backend="gcs", bucket="b", prefix="pfx", root=None))
    assert isinstance(store, Recorder) and built == [("b", "pfx")]
    with pytest.raises(NotFoundError):
        store.get_entity("t", "p", "r")


def test_google_cloud_is_imported_only_in_the_constructor():
    tree = ast.parse((REPO / "batch_shipyard_tpu_torch" / "state" /
                      "gcs.py").read_text())
    sites = []
    for cls in ast.walk(tree):
        if not isinstance(cls, (ast.Module, ast.ClassDef)):
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.ImportFrom) and \
                        (node.module or "").startswith("google"):
                    sites.append((getattr(cls, "name", ""), fn.name))
                elif isinstance(node, ast.Constant) and \
                        str(node.value).startswith("google."):
                    sites.append((getattr(cls, "name", ""), fn.name))
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    assert not any("google" in (getattr(n, "module", "") or "") or any(
        "google" in a.name for a in n.names) for n in top)
    assert set(sites) == {("GCSStateStore", "__init__")}
