"""Local-filesystem state store: cross-process, single-host.

The port's copy of batch_shipyard_tpu/state/localfs.py: its files are
the reference's byte for byte, so one root serves both packages.

Used for the localhost substrate (real task execution on this machine,
the path that drives the host's GPUs) and for
multi-process integration tests. Correctness across processes comes
from an exclusive ``fcntl.flock`` around each mutation of the JSON
metadata databases, with object payloads stored as content files and
atomic ``os.replace`` writes.

This mirrors the role the reference gives Azure Storage (all shared
state; convoy/storage.py) at laptop scale — the reference's GCS store
is the cloud-scale implementation with identical semantics.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import json
import os
import time
import uuid
from typing import Any, Iterator, Optional

from batch_shipyard_tpu_torch.state import base
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, EtagMismatchError, LeaseHandle, LeaseLostError,
    NotFoundError, ObjectMeta, PreconditionFailedError, QueueMessage)
from batch_shipyard_tpu_torch.utils.util import atomic_write as _atomic_write


class LocalFSStateStore(base.StateStore):
    def __init__(self, root: str) -> None:
        self._root = os.path.abspath(root)
        os.makedirs(os.path.join(self._root, "objects"), exist_ok=True)
        self._lockfile = os.path.join(self._root, ".lock")
        # Touch the lock file once.
        with open(self._lockfile, "a", encoding="utf-8"):
            pass

    # ------------------------- locking + dbs ---------------------------

    @contextlib.contextmanager
    def _locked(self):
        with open(self._lockfile, "r+", encoding="utf-8") as fh:
            fcntl.flock(fh.fileno(), fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fh.fileno(), fcntl.LOCK_UN)

    def _db_path(self, name: str) -> str:
        return os.path.join(self._root, f"{name}.json")

    def _load_db(self, name: str) -> dict:
        path = self._db_path(name)
        if not os.path.exists(path):
            return {}
        with open(path, "r", encoding="utf-8") as fh:
            content = fh.read()
        if not content.strip():
            return {}
        return json.loads(content)

    def _save_db(self, name: str, db: dict) -> None:
        _atomic_write(self._db_path(name),
                      json.dumps(db).encode("utf-8"))

    def _object_path(self, key: str) -> str:
        digest = hashlib.sha256(key.encode("utf-8")).hexdigest()
        return os.path.join(self._root, "objects", digest)

    # ------------------------------ objects ----------------------------

    def put_object(self, key: str, data: bytes,
                   if_generation_match: Optional[int] = None) -> int:
        with self._locked():
            db = self._load_db("objects")
            meta = db.get(key)
            if if_generation_match is not None:
                cur_gen = meta["generation"] if meta else 0
                if cur_gen != if_generation_match:
                    raise PreconditionFailedError(
                        f"{key}: generation {cur_gen} != "
                        f"{if_generation_match}")
            counter = db.get("\x00counter", 0) + 1
            db["\x00counter"] = counter
            _atomic_write(self._object_path(key), data)
            db[key] = {"generation": counter, "size": len(data),
                       "updated": time.time()}
            self._save_db("objects", db)
            return counter

    def put_object_stream(self, key, chunks,
                          if_generation_match=None) -> int:
        """True streaming: chunks are written incrementally to a temp
        file next to the target, then renamed under the lock — the
        whole object never sits in memory."""
        path = self._object_path(key)
        tmp = f"{path}.stream.{os.getpid()}"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        size = 0
        try:
            with open(tmp, "wb") as fh:
                for chunk in chunks:
                    fh.write(chunk)
                    size += len(chunk)
                # Mirror _atomic_write: flush+fsync BEFORE the locked
                # os.replace, so a crash between the rename and the
                # page cache landing can never surface a torn object
                # under a committed metadata row.
                fh.flush()
                os.fsync(fh.fileno())
            with self._locked():
                db = self._load_db("objects")
                meta = db.get(key)
                if if_generation_match is not None:
                    cur_gen = meta["generation"] if meta else 0
                    if cur_gen != if_generation_match:
                        raise PreconditionFailedError(
                            f"{key}: generation {cur_gen} != "
                            f"{if_generation_match}")
                counter = db.get("\x00counter", 0) + 1
                db["\x00counter"] = counter
                os.replace(tmp, path)
                db[key] = {"generation": counter, "size": size,
                           "updated": time.time()}
                self._save_db("objects", db)
                return counter
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def get_object_stream(self, key, chunk_size=None):
        chunk_size = chunk_size or self.STREAM_CHUNK_BYTES
        with self._locked():
            db = self._load_db("objects")
            if key not in db or key == "\x00counter":
                raise NotFoundError(key)
            path = self._object_path(key)
        try:
            with open(path, "rb") as fh:
                while True:
                    chunk = fh.read(chunk_size)
                    if not chunk:
                        return
                    yield chunk
        except FileNotFoundError:
            raise NotFoundError(key)

    def get_object(self, key: str) -> bytes:
        with self._locked():
            db = self._load_db("objects")
            if key not in db or key == "\x00counter":
                raise NotFoundError(key)
            try:
                with open(self._object_path(key), "rb") as fh:
                    return fh.read()
            except FileNotFoundError:
                raise NotFoundError(key)

    def get_object_meta(self, key: str) -> ObjectMeta:
        with self._locked():
            db = self._load_db("objects")
            if key not in db or key == "\x00counter":
                raise NotFoundError(key)
            meta = db[key]
        import datetime
        return ObjectMeta(
            key=key, size=meta["size"], generation=meta["generation"],
            updated=datetime.datetime.fromtimestamp(
                meta["updated"], datetime.timezone.utc))

    def delete_object(self, key: str,
                      if_generation_match: Optional[int] = None) -> None:
        with self._locked():
            db = self._load_db("objects")
            if key not in db or key == "\x00counter":
                raise NotFoundError(key)
            if if_generation_match is not None and (
                    db[key]["generation"] != if_generation_match):
                raise PreconditionFailedError(key)
            del db[key]
            with contextlib.suppress(FileNotFoundError):
                os.remove(self._object_path(key))
            self._save_db("objects", db)

    def list_objects(self, prefix: str = "") -> list[str]:
        with self._locked():
            db = self._load_db("objects")
        return sorted(k for k in db
                      if k != "\x00counter" and k.startswith(prefix))

    # ------------------------------ leases -----------------------------

    def acquire_lease(self, key: str, duration_seconds: float,
                      owner: str) -> Optional[LeaseHandle]:
        now = time.time()
        with self._locked():
            db = self._load_db("leases")
            held = db.get(key)
            if held is not None and held["expires_at"] > now:
                return None
            token = uuid.uuid4().hex
            expires = now + duration_seconds
            db[key] = {"owner": owner, "token": token, "expires_at": expires}
            self._save_db("leases", db)
            return LeaseHandle(key=key, owner=owner, token=token,
                               expires_at=expires)

    def renew_lease(self, handle: LeaseHandle,
                    duration_seconds: float) -> LeaseHandle:
        now = time.time()
        with self._locked():
            db = self._load_db("leases")
            held = db.get(handle.key)
            if held is None or held["token"] != handle.token or (
                    held["expires_at"] <= now):
                raise LeaseLostError(handle.key)
            expires = now + duration_seconds
            db[handle.key]["expires_at"] = expires
            self._save_db("leases", db)
            return LeaseHandle(key=handle.key, owner=handle.owner,
                               token=handle.token, expires_at=expires)

    def release_lease(self, handle: LeaseHandle) -> None:
        with self._locked():
            db = self._load_db("leases")
            held = db.get(handle.key)
            if held is None or held["token"] != handle.token:
                raise LeaseLostError(handle.key)
            del db[handle.key]
            self._save_db("leases", db)

    # ------------------------------ tables -----------------------------

    @staticmethod
    def _ekey(pk: str, rk: str) -> str:
        return f"{pk}\x01{rk}"

    def insert_entity(self, table: str, partition_key: str, row_key: str,
                      entity: dict[str, Any]) -> str:
        with self._locked():
            db = self._load_db(f"table_{table}")
            key = self._ekey(partition_key, row_key)
            if key in db:
                raise EntityExistsError(f"{table}:{partition_key}:{row_key}")
            etag = uuid.uuid4().hex
            db[key] = {"entity": entity, "etag": etag}
            self._save_db(f"table_{table}", db)
            return etag

    def upsert_entity(self, table: str, partition_key: str, row_key: str,
                      entity: dict[str, Any]) -> str:
        with self._locked():
            db = self._load_db(f"table_{table}")
            etag = uuid.uuid4().hex
            db[self._ekey(partition_key, row_key)] = {
                "entity": entity, "etag": etag}
            self._save_db(f"table_{table}", db)
            return etag

    def merge_entity(self, table: str, partition_key: str, row_key: str,
                     entity: dict[str, Any],
                     if_match: Optional[str] = None) -> str:
        with self._locked():
            db = self._load_db(f"table_{table}")
            key = self._ekey(partition_key, row_key)
            if key not in db:
                raise NotFoundError(f"{table}:{partition_key}:{row_key}")
            if if_match is not None and db[key]["etag"] != if_match:
                raise EtagMismatchError(f"{table}:{partition_key}:{row_key}")
            merged = dict(db[key]["entity"])
            merged.update(entity)
            etag = uuid.uuid4().hex
            db[key] = {"entity": merged, "etag": etag}
            self._save_db(f"table_{table}", db)
            return etag

    def get_entity(self, table: str, partition_key: str,
                   row_key: str) -> dict[str, Any]:
        with self._locked():
            db = self._load_db(f"table_{table}")
            key = self._ekey(partition_key, row_key)
            if key not in db:
                raise NotFoundError(f"{table}:{partition_key}:{row_key}")
            out = dict(db[key]["entity"])
            out["_etag"] = db[key]["etag"]
            out["_pk"] = partition_key
            out["_rk"] = row_key
            return out

    def query_entities(self, table: str,
                       partition_key: Optional[str] = None,
                       row_key_prefix: str = "",
                       ) -> Iterator[dict[str, Any]]:
        with self._locked():
            db = self._load_db(f"table_{table}")
        for key in sorted(db):
            pk, _, rk = key.partition("\x01")
            if partition_key is not None and pk != partition_key:
                continue
            if row_key_prefix and not rk.startswith(row_key_prefix):
                continue
            out = dict(db[key]["entity"])
            out["_etag"] = db[key]["etag"]
            out["_pk"] = pk
            out["_rk"] = rk
            yield out

    def delete_entity(self, table: str, partition_key: str, row_key: str,
                      if_match: Optional[str] = None) -> None:
        with self._locked():
            db = self._load_db(f"table_{table}")
            key = self._ekey(partition_key, row_key)
            if key not in db:
                raise NotFoundError(f"{table}:{partition_key}:{row_key}")
            if if_match is not None and db[key]["etag"] != if_match:
                raise EtagMismatchError(f"{table}:{partition_key}:{row_key}")
            del db[key]
            self._save_db(f"table_{table}", db)

    # ------------------------------ queues -----------------------------

    def put_message(self, queue: str, payload: bytes,
                    delay_seconds: float = 0.0) -> str:
        with self._locked():
            db = self._load_db(f"queue_{queue}")
            message_id = uuid.uuid4().hex
            msgs = db.setdefault("messages", [])
            msgs.append({
                "id": message_id,
                "payload": payload.hex(),
                "visible_at": time.time() + delay_seconds,
                "dequeue_count": 0,
                "receipt": None,
            })
            self._save_db(f"queue_{queue}", db)
            return message_id

    def put_messages(self, queue: str, payloads: list[bytes],
                     delay_seconds: float = 0.0) -> list[str]:
        """Single lock/load/save for the whole batch (one fsync
        instead of N — the dominant cost of per-message puts)."""
        with self._locked():
            db = self._load_db(f"queue_{queue}")
            msgs = db.setdefault("messages", [])
            ids = []
            visible = time.time() + delay_seconds
            for payload in payloads:
                message_id = uuid.uuid4().hex
                msgs.append({
                    "id": message_id, "payload": payload.hex(),
                    "visible_at": visible, "dequeue_count": 0,
                    "receipt": None})
                ids.append(message_id)
            self._save_db(f"queue_{queue}", db)
            return ids

    def insert_entities(self, table: str,
                        rows: list[tuple[str, str, dict]]) -> list[str]:
        with self._locked():
            db = self._load_db(f"table_{table}")
            etags = []
            for pk, rk, entity in rows:
                key = self._ekey(pk, rk)
                if key in db:
                    raise EntityExistsError(f"{table}:{pk}:{rk}")
                etag = uuid.uuid4().hex
                db[key] = {"entity": entity, "etag": etag}
                etags.append(etag)
            self._save_db(f"table_{table}", db)
            return etags

    def count_entities_by(self, table: str, partition_key: str,
                          column: str = "state") -> dict[str, int]:
        """One db load, no per-row result dicts (the summary-poll
        fast path; see base.count_entities_by)."""
        with self._locked():
            db = self._load_db(f"table_{table}")
        counts: dict[str, int] = {}
        prefix = f"{partition_key}\x01"
        for key, record in db.items():
            if not key.startswith(prefix):
                continue
            value = str(record["entity"].get(column) or "")
            counts[value] = counts.get(value, 0) + 1
        return counts

    def get_messages(self, queue: str, max_messages: int = 1,
                     visibility_timeout: float = 30.0,
                     ) -> list[QueueMessage]:
        now = time.time()
        out: list[QueueMessage] = []
        with self._locked():
            db = self._load_db(f"queue_{queue}")
            for msg in db.get("messages", []):
                if len(out) >= max_messages:
                    break
                if msg["visible_at"] > now:
                    continue
                msg["visible_at"] = now + visibility_timeout
                msg["dequeue_count"] += 1
                msg["receipt"] = uuid.uuid4().hex
                out.append(QueueMessage(
                    queue=queue, message_id=msg["id"],
                    pop_receipt=msg["receipt"],
                    payload=bytes.fromhex(msg["payload"]),
                    dequeue_count=msg["dequeue_count"]))
            if out:
                self._save_db(f"queue_{queue}", db)
        return out

    def delete_message(self, message: QueueMessage) -> None:
        with self._locked():
            db = self._load_db(f"queue_{message.queue}")
            msgs = db.get("messages", [])
            for msg in msgs:
                if msg["id"] == message.message_id:
                    if msg["receipt"] != message.pop_receipt:
                        raise NotFoundError(message.message_id)
                    msgs.remove(msg)
                    self._save_db(f"queue_{message.queue}", db)
                    return
            raise NotFoundError(message.message_id)

    def update_message(self, message: QueueMessage,
                       visibility_timeout: float) -> QueueMessage:
        with self._locked():
            db = self._load_db(f"queue_{message.queue}")
            for msg in db.get("messages", []):
                if msg["id"] == message.message_id:
                    if msg["receipt"] != message.pop_receipt:
                        raise NotFoundError(message.message_id)
                    msg["visible_at"] = time.time() + visibility_timeout
                    self._save_db(f"queue_{message.queue}", db)
                    return message
            raise NotFoundError(message.message_id)

    def queue_length(self, queue: str) -> int:
        with self._locked():
            db = self._load_db(f"queue_{queue}")
            return len(db.get("messages", []))

    def clear(self) -> None:
        import shutil
        with self._locked():
            for name in os.listdir(self._root):
                if name == ".lock":
                    continue
                path = os.path.join(self._root, name)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
            os.makedirs(os.path.join(self._root, "objects"), exist_ok=True)
