"""GCS-backed state store: the cloud pool's shared store.

The port's copy of batch_shipyard_tpu/state/gcs.py: the same object
names and bytes, so either package's agents and CLI read what the other
wrote into one bucket. The interface maps onto Google Cloud Storage
primitives:

  - objects  -> GCS objects; ``if_generation_match`` is native.
  - leases   -> lease objects written with generation preconditions
               (create-only for acquire, matched overwrite for renew),
               the GCS analog of blob leases.
  - tables   -> one JSON object per entity under
               ``tables/<table>/<pk>/<rk>``; etag = str(generation).
  - queues   -> one JSON object per message under
               ``queues/<queue>/<id>``; claims via a rewrite with a
               generation precondition (at-least-once semantics).

Requires ``google-cloud-storage`` and network access; the import is
lazy (inside the constructor) so the rest of the package is usable
without either.
"""

from __future__ import annotations

import json
import time
import uuid
from typing import Any, Iterator, Optional

from batch_shipyard_tpu_torch.state import base
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, EtagMismatchError, LeaseHandle, LeaseLostError,
    NotFoundError, ObjectMeta, PreconditionFailedError, QueueMessage)


class GCSStateStore(base.StateStore):
    def __init__(self, bucket: str, prefix: str = "shipyardtpu",
                 project: Optional[str] = None,
                 credentials_file: Optional[str] = None,
                 client=None, exceptions_module=None) -> None:
        """client/exceptions_module: injectable, so a faithful fake of
        the client runs the whole store contract against this class
        without a cloud account."""
        if client is not None:
            self._client = client
            self._exceptions = exceptions_module
        else:
            try:
                from google.cloud import storage as gcs  # noqa: PLC0415
            except ImportError as exc:  # pragma: no cover
                raise RuntimeError(
                    "google-cloud-storage is required for the gcs "
                    "state backend; use backend: localfs or memory "
                    "otherwise") from exc
            if credentials_file:
                self._client = gcs.Client.from_service_account_json(
                    credentials_file, project=project)
            else:
                self._client = gcs.Client(project=project)
            self._exceptions = __import__(
                "google.api_core.exceptions", fromlist=["exceptions"])
        self._bucket = self._client.bucket(bucket)
        self._prefix = prefix.rstrip("/")

    # ------------------------------ helpers ----------------------------

    def _blob(self, key: str):
        return self._bucket.blob(f"{self._prefix}/{key}")

    def _wrap_precondition(self, exc: Exception, key: str) -> Exception:
        if isinstance(exc, self._exceptions.PreconditionFailed):
            return PreconditionFailedError(key)
        if isinstance(exc, self._exceptions.NotFound):
            return NotFoundError(key)
        return exc

    # ------------------------------ objects ----------------------------

    def put_object(self, key: str, data: bytes,
                   if_generation_match: Optional[int] = None) -> int:
        blob = self._blob(f"objects/{key}")
        try:
            blob.upload_from_string(
                data, if_generation_match=if_generation_match)
        except Exception as exc:  # pragma: no cover - network
            raise self._wrap_precondition(exc, key)
        return int(blob.generation)

    def put_object_stream(self, key, chunks,
                          if_generation_match=None) -> int:
        """Native streaming via resumable upload from a file-like
        adapter over the chunk iterator — the object never
        materializes client-side."""
        import io

        class _IterReader(io.RawIOBase):
            def __init__(self, it):
                self._it = iter(it)
                self._buf = b""

            def readable(self):
                return True

            def readinto(self, b):
                while len(self._buf) < len(b):
                    try:
                        self._buf += next(self._it)
                    except StopIteration:
                        break
                n = min(len(b), len(self._buf))
                b[:n] = self._buf[:n]
                self._buf = self._buf[n:]
                return n

        blob = self._blob(f"objects/{key}")
        blob.chunk_size = self.STREAM_CHUNK_BYTES
        try:
            blob.upload_from_file(
                io.BufferedReader(_IterReader(chunks),
                                  self.STREAM_CHUNK_BYTES),
                if_generation_match=if_generation_match)
        except Exception as exc:  # pragma: no cover - network
            raise self._wrap_precondition(exc, key)
        return int(blob.generation)

    def get_object_stream(self, key, chunk_size=None):
        chunk_size = chunk_size or self.STREAM_CHUNK_BYTES
        blob = self._blob(f"objects/{key}")
        try:
            blob.reload()
            size = blob.size or 0
            for start in range(0, size, chunk_size):
                end = min(start + chunk_size, size) - 1
                yield blob.download_as_bytes(start=start, end=end)
        except Exception as exc:  # pragma: no cover - network
            raise self._wrap_precondition(exc, key)

    def generate_signed_url(self, key: str, method: str = "GET",
                            expires_seconds: float = 3600.0) -> str:
        """V4 signed URL for a single object (the `storage sas create`
        analog, reference shipyard.py:1327). Requires service-account
        credentials (ADC user credentials cannot sign); the
        google-auth error in that case is re-raised with the fix."""
        import datetime
        if method not in ("GET", "PUT", "DELETE", "HEAD"):
            raise ValueError(f"unsupported method {method!r}")
        blob = self._blob(f"objects/{key}")
        if method in ("GET", "HEAD") and not self.object_exists(key):
            raise NotFoundError(key)
        try:
            return blob.generate_signed_url(
                version="v4", method=method,
                expiration=datetime.timedelta(
                    seconds=expires_seconds))
        except Exception as exc:  # pragma: no cover - auth-specific
            if "private key" in str(exc).lower() or \
                    "credentials" in str(exc).lower():
                raise RuntimeError(
                    "signing requires service-account credentials "
                    "(credentials.storage.credentials_file or "
                    "service-account impersonation); user ADC "
                    f"cannot sign: {exc}") from exc
            raise

    def get_object(self, key: str) -> bytes:
        blob = self._blob(f"objects/{key}")
        try:
            return blob.download_as_bytes()
        except Exception as exc:  # pragma: no cover - network
            raise self._wrap_precondition(exc, key)

    def get_object_meta(self, key: str) -> ObjectMeta:
        blob = self._blob(f"objects/{key}")
        try:
            blob.reload()
        except Exception as exc:  # pragma: no cover - network
            raise self._wrap_precondition(exc, key)
        return ObjectMeta(key=key, size=blob.size or 0,
                          generation=int(blob.generation),
                          updated=blob.updated)

    def delete_object(self, key: str,
                      if_generation_match: Optional[int] = None) -> None:
        blob = self._blob(f"objects/{key}")
        try:
            blob.delete(if_generation_match=if_generation_match)
        except Exception as exc:  # pragma: no cover - network
            raise self._wrap_precondition(exc, key)

    def list_objects(self, prefix: str = "") -> list[str]:
        full = f"{self._prefix}/objects/{prefix}"
        strip = len(f"{self._prefix}/objects/")
        return sorted(
            b.name[strip:] for b in self._client.list_blobs(
                self._bucket, prefix=full))

    # ------------------------------ leases -----------------------------

    def acquire_lease(self, key: str, duration_seconds: float,
                      owner: str) -> Optional[LeaseHandle]:
        blob = self._blob(f"leases/{key}")
        now = time.time()
        token = uuid.uuid4().hex
        record = json.dumps({
            "owner": owner, "token": token,
            "expires_at": now + duration_seconds}).encode()
        try:
            blob.upload_from_string(record, if_generation_match=0)
            return LeaseHandle(key=key, owner=owner, token=token,
                               expires_at=now + duration_seconds)
        except self._exceptions.PreconditionFailed:
            pass
        # Held: steal only if expired, with a matched-generation swap.
        try:
            blob.reload()
            held = json.loads(blob.download_as_bytes())
        except self._exceptions.NotFound:
            return self.acquire_lease(key, duration_seconds, owner)
        if held["expires_at"] > now:
            return None
        try:
            blob.upload_from_string(
                record, if_generation_match=int(blob.generation))
            return LeaseHandle(key=key, owner=owner, token=token,
                               expires_at=now + duration_seconds)
        except self._exceptions.PreconditionFailed:
            return None

    def renew_lease(self, handle: LeaseHandle,
                    duration_seconds: float) -> LeaseHandle:
        blob = self._blob(f"leases/{handle.key}")
        now = time.time()
        try:
            blob.reload()
            held = json.loads(blob.download_as_bytes())
        except self._exceptions.NotFound:
            raise LeaseLostError(handle.key)
        if held["token"] != handle.token or held["expires_at"] <= now:
            raise LeaseLostError(handle.key)
        record = json.dumps({
            "owner": handle.owner, "token": handle.token,
            "expires_at": now + duration_seconds}).encode()
        try:
            blob.upload_from_string(
                record, if_generation_match=int(blob.generation))
        except self._exceptions.PreconditionFailed:
            raise LeaseLostError(handle.key)
        return LeaseHandle(key=handle.key, owner=handle.owner,
                           token=handle.token,
                           expires_at=now + duration_seconds)

    def release_lease(self, handle: LeaseHandle) -> None:
        blob = self._blob(f"leases/{handle.key}")
        try:
            # Capture the generation BEFORE validating the token, and
            # delete only if it still matches: if the lease expires and
            # is stolen at any point after the snapshot, the delete
            # fails with PreconditionFailed instead of destroying the
            # new owner's lease record.
            blob.reload()
            generation = int(blob.generation)
            held = json.loads(blob.download_as_bytes())
            if held["token"] != handle.token:
                raise LeaseLostError(handle.key)
            blob.delete(if_generation_match=generation)
        except self._exceptions.PreconditionFailed:
            raise LeaseLostError(handle.key)
        except self._exceptions.NotFound:
            raise LeaseLostError(handle.key)

    # ------------------------------ tables -----------------------------

    def _entity_blob(self, table: str, pk: str, rk: str):
        return self._blob(f"tables/{table}/{pk}/{rk}")

    def insert_entity(self, table: str, partition_key: str, row_key: str,
                      entity: dict[str, Any]) -> str:
        blob = self._entity_blob(table, partition_key, row_key)
        try:
            blob.upload_from_string(
                json.dumps(entity).encode(), if_generation_match=0)
        except self._exceptions.PreconditionFailed:
            raise EntityExistsError(f"{table}:{partition_key}:{row_key}")
        return str(blob.generation)

    def upsert_entity(self, table: str, partition_key: str, row_key: str,
                      entity: dict[str, Any]) -> str:
        blob = self._entity_blob(table, partition_key, row_key)
        blob.upload_from_string(json.dumps(entity).encode())
        return str(blob.generation)

    def merge_entity(self, table: str, partition_key: str, row_key: str,
                     entity: dict[str, Any],
                     if_match: Optional[str] = None) -> str:
        blob = self._entity_blob(table, partition_key, row_key)
        try:
            blob.reload()
            current = json.loads(blob.download_as_bytes())
        except self._exceptions.NotFound:
            raise NotFoundError(f"{table}:{partition_key}:{row_key}")
        etag = str(blob.generation)
        if if_match is not None and if_match != etag:
            raise EtagMismatchError(f"{table}:{partition_key}:{row_key}")
        current.update(entity)
        try:
            blob.upload_from_string(
                json.dumps(current).encode(),
                if_generation_match=int(etag))
        except self._exceptions.PreconditionFailed:
            raise EtagMismatchError(f"{table}:{partition_key}:{row_key}")
        return str(blob.generation)

    def get_entity(self, table: str, partition_key: str,
                   row_key: str) -> dict[str, Any]:
        blob = self._entity_blob(table, partition_key, row_key)
        try:
            blob.reload()
            out = json.loads(blob.download_as_bytes())
        except self._exceptions.NotFound:
            raise NotFoundError(f"{table}:{partition_key}:{row_key}")
        out["_etag"] = str(blob.generation)
        out["_pk"] = partition_key
        out["_rk"] = row_key
        return out

    def query_entities(self, table: str,
                       partition_key: Optional[str] = None,
                       row_key_prefix: str = "",
                       ) -> Iterator[dict[str, Any]]:
        prefix = f"{self._prefix}/tables/{table}/"
        if partition_key is not None:
            prefix += f"{partition_key}/{row_key_prefix}"
        for blob in self._client.list_blobs(self._bucket, prefix=prefix):
            parts = blob.name.split("/")
            pk, rk = parts[-2], parts[-1]
            if row_key_prefix and not rk.startswith(row_key_prefix):
                continue
            out = json.loads(blob.download_as_bytes())
            out["_etag"] = str(blob.generation)
            out["_pk"] = pk
            out["_rk"] = rk
            yield out

    def delete_entity(self, table: str, partition_key: str, row_key: str,
                      if_match: Optional[str] = None) -> None:
        blob = self._entity_blob(table, partition_key, row_key)
        try:
            blob.delete(if_generation_match=(
                int(if_match) if if_match is not None else None))
        except Exception as exc:
            exc2 = self._wrap_precondition(
                exc, f"{table}:{partition_key}:{row_key}")
            if isinstance(exc2, PreconditionFailedError):
                raise EtagMismatchError(f"{table}:{partition_key}:{row_key}")
            raise exc2

    # ------------------------------ queues -----------------------------
    # Message blob: queues/<queue>/<id> containing payload + visibility.
    # Claim = matched-generation rewrite bumping visible_at.

    def put_message(self, queue: str, payload: bytes,
                    delay_seconds: float = 0.0) -> str:
        message_id = f"{time.time():017.6f}-{uuid.uuid4().hex[:8]}"
        blob = self._blob(f"queues/{queue}/{message_id}")
        blob.upload_from_string(json.dumps({
            "payload": payload.hex(),
            "visible_at": time.time() + delay_seconds,
            "dequeue_count": 0,
        }).encode())
        return message_id

    def get_messages(self, queue: str, max_messages: int = 1,
                     visibility_timeout: float = 30.0,
                     ) -> list[QueueMessage]:
        now = time.time()
        out: list[QueueMessage] = []
        prefix = f"{self._prefix}/queues/{queue}/"
        for blob in self._client.list_blobs(self._bucket, prefix=prefix):
            if len(out) >= max_messages:
                break
            record = json.loads(blob.download_as_bytes())
            if record["visible_at"] > now:
                continue
            record["visible_at"] = now + visibility_timeout
            record["dequeue_count"] += 1
            receipt = uuid.uuid4().hex
            record["receipt"] = receipt
            try:
                blob.upload_from_string(
                    json.dumps(record).encode(),
                    if_generation_match=int(blob.generation))
            except self._exceptions.PreconditionFailed:
                continue  # another consumer won the claim race
            out.append(QueueMessage(
                queue=queue, message_id=blob.name.split("/")[-1],
                pop_receipt=receipt,
                payload=bytes.fromhex(record["payload"]),
                dequeue_count=record["dequeue_count"]))
        return out

    def _message_blob(self, message: QueueMessage):
        return self._blob(f"queues/{message.queue}/{message.message_id}")

    def delete_message(self, message: QueueMessage) -> None:
        blob = self._message_blob(message)
        try:
            record = json.loads(blob.download_as_bytes())
            if record.get("receipt") != message.pop_receipt:
                raise NotFoundError(message.message_id)
            blob.delete()
        except self._exceptions.NotFound:
            raise NotFoundError(message.message_id)

    def update_message(self, message: QueueMessage,
                       visibility_timeout: float) -> QueueMessage:
        blob = self._message_blob(message)
        try:
            blob.reload()
            record = json.loads(blob.download_as_bytes())
        except self._exceptions.NotFound:
            raise NotFoundError(message.message_id)
        if record.get("receipt") != message.pop_receipt:
            raise NotFoundError(message.message_id)
        record["visible_at"] = time.time() + visibility_timeout
        blob.upload_from_string(
            json.dumps(record).encode(),
            if_generation_match=int(blob.generation))
        return message

    def queue_length(self, queue: str) -> int:
        prefix = f"{self._prefix}/queues/{queue}/"
        return sum(1 for _ in self._client.list_blobs(
            self._bucket, prefix=prefix))

    def clear(self) -> None:  # pragma: no cover - destructive, cloud
        for blob in self._client.list_blobs(
                self._bucket, prefix=f"{self._prefix}/"):
            blob.delete()
