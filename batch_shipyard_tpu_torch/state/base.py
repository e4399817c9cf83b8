"""State store interface: objects, tables, queues and leases.

The port's copy of batch_shipyard_tpu/state/base.py. Every piece of
coordination between the pool's CLI, daemons and nodes flows through
these primitives, so one interface lets the cloud store, a local
filesystem and the in-memory store (state/memory.py) stand in for each
other.

Concurrency semantics:
  - objects carry a monotonically increasing ``generation``; writes and
    deletes accept ``if_generation_match`` (0 = only-if-absent), the GCS
    precondition model.
  - table entities carry an ``etag``; ``merge`` and ``delete`` accept
    ``if_match``.
  - leases are (key, owner, expiry) records acquirable only when free or
    expired; renew/release require the owner token.
  - queue messages have a visibility timeout and a pop receipt
    (at-least-once delivery).
"""

from __future__ import annotations

import abc
import dataclasses
import datetime
from typing import Any, Iterable, Iterator, Optional


class NotFoundError(KeyError):
    """Object/entity/message does not exist."""


class PreconditionFailedError(RuntimeError):
    """Generation precondition failed on an object write/delete."""


class EntityExistsError(RuntimeError):
    """Insert of an already-existing table entity."""


class EtagMismatchError(RuntimeError):
    """Entity etag precondition failed."""


class LeaseLostError(RuntimeError):
    """Lease renew/release by a non-owner or after expiry."""


@dataclasses.dataclass(frozen=True)
class ObjectMeta:
    key: str
    size: int
    generation: int
    updated: datetime.datetime


@dataclasses.dataclass(frozen=True)
class LeaseHandle:
    key: str
    owner: str
    token: str
    expires_at: float


@dataclasses.dataclass(frozen=True)
class QueueMessage:
    queue: str
    message_id: str
    pop_receipt: str
    payload: bytes
    dequeue_count: int


class StateStore(abc.ABC):
    """Abstract object/table/queue/lease store."""

    # ------------------------------ objects ----------------------------

    @abc.abstractmethod
    def put_object(self, key: str, data: bytes,
                   if_generation_match: Optional[int] = None) -> int:
        """Write an object; returns its new generation.

        ``if_generation_match=0`` means create-only (fail if exists);
        any other value requires the current generation to match.
        """

    @abc.abstractmethod
    def get_object(self, key: str) -> bytes: ...

    @abc.abstractmethod
    def get_object_meta(self, key: str) -> ObjectMeta: ...

    @abc.abstractmethod
    def delete_object(self, key: str,
                      if_generation_match: Optional[int] = None) -> None: ...

    @abc.abstractmethod
    def list_objects(self, prefix: str = "") -> list[str]: ...

    # Default streaming chunk: large enough to amortize round trips,
    # small enough that a chunk is never a memory concern.
    STREAM_CHUNK_BYTES = 8 * 1024 * 1024

    def put_object_stream(self, key: str, chunks: Iterable[bytes],
                          if_generation_match: Optional[int] = None
                          ) -> int:
        """Write an object from an iterable of byte chunks. Backends with
        a native streaming path override this; the fallback
        concatenates."""
        return self.put_object(key, b"".join(chunks),
                               if_generation_match=if_generation_match)

    def get_object_stream(self, key: str,
                          chunk_size: Optional[int] = None
                          ) -> Iterator[bytes]:
        """Yield an object's bytes in chunks. The fallback reads the
        whole object."""
        chunk_size = chunk_size or self.STREAM_CHUNK_BYTES
        data = self.get_object(key)
        for i in range(0, len(data), chunk_size):
            yield data[i:i + chunk_size]

    def object_exists(self, key: str) -> bool:
        try:
            self.get_object_meta(key)
            return True
        except NotFoundError:
            return False

    def generate_signed_url(self, key: str, method: str = "GET",
                            expires_seconds: float = 3600.0) -> str:
        """Time-limited signed URL for one object (the CLI's `storage
        sas`). Only cloud backends can mint these; the local and memory
        stores raise a clear error instead of minting a URL nobody
        outside this process could dereference."""
        raise NotImplementedError(
            f"{type(self).__name__} cannot mint signed URLs — "
            f"signed access requires the gcs backend")

    # ------------------------------ leases -----------------------------

    @abc.abstractmethod
    def acquire_lease(self, key: str, duration_seconds: float,
                      owner: str) -> Optional[LeaseHandle]:
        """Try to acquire a named lease; None if currently held."""

    @abc.abstractmethod
    def renew_lease(self, handle: LeaseHandle,
                    duration_seconds: float) -> LeaseHandle:
        """Extend a held lease; raises LeaseLostError if lost."""

    @abc.abstractmethod
    def release_lease(self, handle: LeaseHandle) -> None: ...

    # ------------------------------ tables -----------------------------

    @abc.abstractmethod
    def insert_entity(self, table: str, partition_key: str, row_key: str,
                      entity: dict[str, Any]) -> str:
        """Insert; raises EntityExistsError if present. Returns etag."""

    @abc.abstractmethod
    def upsert_entity(self, table: str, partition_key: str, row_key: str,
                      entity: dict[str, Any]) -> str:
        """Insert or replace unconditionally. Returns etag."""

    @abc.abstractmethod
    def merge_entity(self, table: str, partition_key: str, row_key: str,
                     entity: dict[str, Any],
                     if_match: Optional[str] = None) -> str:
        """Merge keys into an existing entity (optimistic via if_match).

        Raises NotFoundError or EtagMismatchError. Returns new etag.
        """

    @abc.abstractmethod
    def get_entity(self, table: str, partition_key: str,
                   row_key: str) -> dict[str, Any]:
        """Fetch entity; includes ``_etag``, ``_pk``, ``_rk`` keys."""

    @abc.abstractmethod
    def query_entities(self, table: str,
                       partition_key: Optional[str] = None,
                       row_key_prefix: str = "",
                       ) -> Iterator[dict[str, Any]]: ...

    @abc.abstractmethod
    def delete_entity(self, table: str, partition_key: str, row_key: str,
                      if_match: Optional[str] = None) -> None: ...

    def count_entities_by(self, table: str, partition_key: str,
                          column: str = "state") -> dict[str, int]:
        """One partition's entities counted by a column's value
        ({value: count}; rows without the column count under "")."""
        counts: dict[str, int] = {}
        for row in self.query_entities(table,
                                       partition_key=partition_key):
            value = str(row.get(column) or "")
            counts[value] = counts.get(value, 0) + 1
        return counts

    # ------------------------------ queues -----------------------------

    @abc.abstractmethod
    def put_message(self, queue: str, payload: bytes,
                    delay_seconds: float = 0.0) -> str: ...

    def put_messages(self, queue: str, payloads: list[bytes],
                     delay_seconds: float = 0.0) -> list[str]:
        """Batch enqueue. The default loops; backends override to
        amortize locking or round trips."""
        return [self.put_message(queue, p, delay_seconds)
                for p in payloads]

    def insert_entities(self, table: str,
                        rows: list[tuple[str, str, dict]]) -> list[str]:
        """Batch insert [(pk, rk, entity)]; EntityExistsError aborts at
        the failing row."""
        return [self.insert_entity(table, pk, rk, entity)
                for pk, rk, entity in rows]

    @abc.abstractmethod
    def get_messages(self, queue: str, max_messages: int = 1,
                     visibility_timeout: float = 30.0,
                     ) -> list[QueueMessage]: ...

    @abc.abstractmethod
    def delete_message(self, message: QueueMessage) -> None: ...

    @abc.abstractmethod
    def update_message(self, message: QueueMessage,
                       visibility_timeout: float) -> QueueMessage:
        """Reset a claimed message's visibility timeout (keeps claim)."""

    @abc.abstractmethod
    def queue_length(self, queue: str) -> int: ...

    # --------------------------- lifecycle -----------------------------

    def clear(self) -> None:
        """Remove all state (test/teardown helper)."""
        raise NotImplementedError
