"""In-memory state store (thread-safe): the port's copy of
batch_shipyard_tpu/state/memory.py, with the semantics of the
interface (state/base.py), so the pool hooks and the compile-cache
seeding run multi-threaded in one process under test.
"""

from __future__ import annotations

import datetime
import threading
import time
import uuid
from typing import Any, Iterator, Optional

from batch_shipyard_tpu_torch.state import base
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, EtagMismatchError, LeaseHandle, LeaseLostError,
    NotFoundError, ObjectMeta, PreconditionFailedError, QueueMessage)


class MemoryStateStore(base.StateStore):
    def __init__(self) -> None:
        self._lock = threading.RLock()
        # key -> (bytes, generation, updated)
        self._objects: dict[str, tuple[bytes, int, Any]] = {}
        self._generation = 0
        # lease key -> (owner, token, expires_at)
        self._leases: dict[str, tuple[str, str, float]] = {}
        # table -> {(pk, rk) -> (entity, etag)}
        self._tables: dict[str, dict[tuple[str, str], tuple[dict, str]]] = {}
        # queue -> list of [message_id, payload, visible_at, dequeue_count]
        self._queues: dict[str, list[list]] = {}
        # claimed messages: (queue, message_id) -> pop_receipt
        self._claims: dict[tuple[str, str], str] = {}

    # ------------------------------ objects ----------------------------

    def put_object(self, key: str, data: bytes,
                   if_generation_match: Optional[int] = None) -> int:
        with self._lock:
            current = self._objects.get(key)
            if if_generation_match is not None:
                cur_gen = current[1] if current is not None else 0
                if cur_gen != if_generation_match:
                    raise PreconditionFailedError(
                        f"{key}: generation {cur_gen} != "
                        f"{if_generation_match}")
            self._generation += 1
            self._objects[key] = (bytes(data), self._generation,
                                  datetime.datetime.now(datetime.timezone.utc))
            return self._generation

    def get_object(self, key: str) -> bytes:
        with self._lock:
            if key not in self._objects:
                raise NotFoundError(key)
            return self._objects[key][0]

    def get_object_meta(self, key: str) -> ObjectMeta:
        with self._lock:
            if key not in self._objects:
                raise NotFoundError(key)
            data, gen, updated = self._objects[key]
            return ObjectMeta(key=key, size=len(data), generation=gen,
                              updated=updated)

    def delete_object(self, key: str,
                      if_generation_match: Optional[int] = None) -> None:
        with self._lock:
            if key not in self._objects:
                raise NotFoundError(key)
            if if_generation_match is not None and (
                    self._objects[key][1] != if_generation_match):
                raise PreconditionFailedError(key)
            del self._objects[key]

    def list_objects(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    # ------------------------------ leases -----------------------------

    def acquire_lease(self, key: str, duration_seconds: float,
                      owner: str) -> Optional[LeaseHandle]:
        now = time.monotonic()
        with self._lock:
            held = self._leases.get(key)
            if held is not None and held[2] > now:
                return None
            token = uuid.uuid4().hex
            expires = now + duration_seconds
            self._leases[key] = (owner, token, expires)
            return LeaseHandle(key=key, owner=owner, token=token,
                               expires_at=expires)

    def renew_lease(self, handle: LeaseHandle,
                    duration_seconds: float) -> LeaseHandle:
        now = time.monotonic()
        with self._lock:
            held = self._leases.get(handle.key)
            if held is None or held[1] != handle.token or held[2] <= now:
                raise LeaseLostError(handle.key)
            expires = now + duration_seconds
            self._leases[handle.key] = (handle.owner, handle.token, expires)
            return LeaseHandle(key=handle.key, owner=handle.owner,
                               token=handle.token, expires_at=expires)

    def release_lease(self, handle: LeaseHandle) -> None:
        with self._lock:
            held = self._leases.get(handle.key)
            if held is None or held[1] != handle.token:
                raise LeaseLostError(handle.key)
            del self._leases[handle.key]

    # ------------------------------ tables -----------------------------

    def _table(self, table: str) -> dict:
        return self._tables.setdefault(table, {})

    def insert_entity(self, table: str, partition_key: str, row_key: str,
                      entity: dict[str, Any]) -> str:
        with self._lock:
            tbl = self._table(table)
            if (partition_key, row_key) in tbl:
                raise EntityExistsError(f"{table}:{partition_key}:{row_key}")
            etag = uuid.uuid4().hex
            tbl[(partition_key, row_key)] = (dict(entity), etag)
            return etag

    def insert_entities(self, table: str,
                        rows: list[tuple[str, str, dict]]) -> list[str]:
        """One lock for the whole batch, validated before any write
        lands: a batch inserts whole or not at all."""
        with self._lock:
            tbl = self._table(table)
            for pk, rk, _entity in rows:
                if (pk, rk) in tbl:
                    raise EntityExistsError(f"{table}:{pk}:{rk}")
            etags = []
            for pk, rk, entity in rows:
                etag = uuid.uuid4().hex
                tbl[(pk, rk)] = (dict(entity), etag)
                etags.append(etag)
            return etags

    def count_entities_by(self, table: str, partition_key: str,
                          column: str = "state") -> dict[str, int]:
        """Count under the lock without copying the rows."""
        counts: dict[str, int] = {}
        with self._lock:
            for (pk, _rk), (entity, _etag) in \
                    self._table(table).items():
                if pk != partition_key:
                    continue
                value = str(entity.get(column) or "")
                counts[value] = counts.get(value, 0) + 1
        return counts

    def upsert_entity(self, table: str, partition_key: str, row_key: str,
                      entity: dict[str, Any]) -> str:
        with self._lock:
            etag = uuid.uuid4().hex
            self._table(table)[(partition_key, row_key)] = (
                dict(entity), etag)
            return etag

    def merge_entity(self, table: str, partition_key: str, row_key: str,
                     entity: dict[str, Any],
                     if_match: Optional[str] = None) -> str:
        with self._lock:
            tbl = self._table(table)
            if (partition_key, row_key) not in tbl:
                raise NotFoundError(f"{table}:{partition_key}:{row_key}")
            current, etag = tbl[(partition_key, row_key)]
            if if_match is not None and if_match != etag:
                raise EtagMismatchError(
                    f"{table}:{partition_key}:{row_key}")
            merged = dict(current)
            merged.update(entity)
            new_etag = uuid.uuid4().hex
            tbl[(partition_key, row_key)] = (merged, new_etag)
            return new_etag

    def get_entity(self, table: str, partition_key: str,
                   row_key: str) -> dict[str, Any]:
        with self._lock:
            tbl = self._table(table)
            if (partition_key, row_key) not in tbl:
                raise NotFoundError(f"{table}:{partition_key}:{row_key}")
            entity, etag = tbl[(partition_key, row_key)]
            out = dict(entity)
            out["_etag"] = etag
            out["_pk"] = partition_key
            out["_rk"] = row_key
            return out

    def query_entities(self, table: str,
                       partition_key: Optional[str] = None,
                       row_key_prefix: str = "",
                       ) -> Iterator[dict[str, Any]]:
        with self._lock:
            items = sorted(self._table(table).items())
        for (pk, rk), (entity, etag) in items:
            if partition_key is not None and pk != partition_key:
                continue
            if row_key_prefix and not rk.startswith(row_key_prefix):
                continue
            out = dict(entity)
            out["_etag"] = etag
            out["_pk"] = pk
            out["_rk"] = rk
            yield out

    def delete_entity(self, table: str, partition_key: str, row_key: str,
                      if_match: Optional[str] = None) -> None:
        with self._lock:
            tbl = self._table(table)
            if (partition_key, row_key) not in tbl:
                raise NotFoundError(f"{table}:{partition_key}:{row_key}")
            if if_match is not None and tbl[
                    (partition_key, row_key)][1] != if_match:
                raise EtagMismatchError(f"{table}:{partition_key}:{row_key}")
            del tbl[(partition_key, row_key)]

    # ------------------------------ queues -----------------------------

    def put_message(self, queue: str, payload: bytes,
                    delay_seconds: float = 0.0) -> str:
        with self._lock:
            message_id = uuid.uuid4().hex
            self._queues.setdefault(queue, []).append(
                [message_id, bytes(payload),
                 time.monotonic() + delay_seconds, 0])
            return message_id

    def put_messages(self, queue: str, payloads: list[bytes],
                     delay_seconds: float = 0.0) -> list[str]:
        """One lock acquisition per batch."""
        with self._lock:
            q = self._queues.setdefault(queue, [])
            visible = time.monotonic() + delay_seconds
            ids = []
            for payload in payloads:
                message_id = uuid.uuid4().hex
                q.append([message_id, bytes(payload), visible, 0])
                ids.append(message_id)
            return ids

    def get_messages(self, queue: str, max_messages: int = 1,
                     visibility_timeout: float = 30.0,
                     ) -> list[QueueMessage]:
        now = time.monotonic()
        out: list[QueueMessage] = []
        with self._lock:
            for msg in self._queues.get(queue, []):
                if len(out) >= max_messages:
                    break
                if msg[2] > now:
                    continue
                msg[2] = now + visibility_timeout
                msg[3] += 1
                receipt = uuid.uuid4().hex
                self._claims[(queue, msg[0])] = receipt
                out.append(QueueMessage(
                    queue=queue, message_id=msg[0], pop_receipt=receipt,
                    payload=msg[1], dequeue_count=msg[3]))
        return out

    def _find_message(self, message: QueueMessage) -> list:
        for msg in self._queues.get(message.queue, []):
            if msg[0] == message.message_id:
                return msg
        raise NotFoundError(message.message_id)

    def delete_message(self, message: QueueMessage) -> None:
        with self._lock:
            if self._claims.get(
                    (message.queue, message.message_id)
                    ) != message.pop_receipt:
                raise NotFoundError(message.message_id)
            msg = self._find_message(message)
            self._queues[message.queue].remove(msg)
            del self._claims[(message.queue, message.message_id)]

    def update_message(self, message: QueueMessage,
                       visibility_timeout: float) -> QueueMessage:
        with self._lock:
            if self._claims.get(
                    (message.queue, message.message_id)
                    ) != message.pop_receipt:
                raise NotFoundError(message.message_id)
            msg = self._find_message(message)
            msg[2] = time.monotonic() + visibility_timeout
            return message

    def queue_length(self, queue: str) -> int:
        with self._lock:
            return len(self._queues.get(queue, []))

    def clear(self) -> None:
        with self._lock:
            self._objects.clear()
            self._leases.clear()
            self._tables.clear()
            self._queues.clear()
            self._claims.clear()
