"""Pool-wide compile-cache seeding through the state store.

The port's copy of batch_shipyard_tpu/compilecache/seeding.py, over the
port's store (state/). After a task the node exports each identity
subdir of its cache root (compilecache/manager.py) as a tar artifact,
lease-guarded so exactly one node uploads per identity, and before the
next task every node seeds from them: the first node builds its kernel
libraries cold, the other N-1 nodes and every restart load them warm.

Keys (state/names.py):

  * ``compilecache/{pool}/{identity}.tar``: one identity subdir's tar
    (the entries and the manager's sidecars, so cold build times
    travel).
  * ``compilecache/{pool}/latest.json``: a per-identity map
    ``{"identities": {id: {key, entries, bytes, node_id,
    updated_at}}}``, read first so a node can refuse or skip without
    downloading, and so a mixed pool keeps every seed live.

The tar and latest.json are the reference's byte for byte: a seed that
either package exported seeds the other. A foreign library can only
miss (its file name is a digest of its source and flags), but shipping
one is waste, so seeding refuses (logs, never raises) an identity the
caller pinned that the pool does not hold, artifacts land only in their
own identity subdir, and export never overwrites an artifact with one of
fewer entries.
"""

from __future__ import annotations

import json
import logging
import os
import tarfile
import tempfile
from typing import Iterator, Optional

from batch_shipyard_tpu_torch.agent.preemption import utcnow_iso
from batch_shipyard_tpu_torch.compilecache import manager
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import (
    NotFoundError, PreconditionFailedError, StateStore)

logger = logging.getLogger(__name__)

# Export is a post-task nicety, not a task phase: keep the lease short
# so a crashed uploader never blocks the pool for long.
EXPORT_LEASE_SECONDS = 120.0

# seed_cache outcomes. Distinct so callers can latch on the durable
# outcomes (SEEDED/REFUSED/SKIP/ABSENT won't change until the pool
# artifacts do) but retry after ERROR (a transient store hiccup must
# not leave a node cold forever).
SEEDED = "seeded"
ABSENT = "absent"      # nothing published for the pool (or identity)
REFUSED = "refused"    # pinned identity not published — would miss
SKIP = "skip"          # local dirs already at least as warm
ERROR = "error"        # transient failure; worth retrying


def latest_info(store: StateStore, pool_id: str) -> Optional[dict]:
    """The pool's seed map ``{"identities": {...}}``, or None."""
    try:
        raw = store.get_object(names.compile_cache_latest_key(pool_id))
        info = json.loads(raw.decode("utf-8"))
        if isinstance(info, dict) and \
                isinstance(info.get("identities"), dict):
            return info
        return None
    except (NotFoundError, ValueError):
        return None


def _tar_chunks(cache_dir: str, entries: dict[str, int]
                ) -> Iterator[bytes]:
    """Stream one identity dir as a tar without materializing it: tar
    into a spooled temp file, then yield store-sized chunks."""
    with tempfile.SpooledTemporaryFile(
            max_size=32 * 1024 * 1024) as spool:
        with tarfile.open(fileobj=spool, mode="w") as tar:
            members = list(entries) + [
                name for name in manager._SIDECARS
                if os.path.exists(os.path.join(cache_dir, name))]
            for name in members:
                tar.add(os.path.join(cache_dir, name), arcname=name)
        spool.seek(0)
        while True:
            chunk = spool.read(StateStore.STREAM_CHUNK_BYTES)
            if not chunk:
                return
            yield chunk


def _update_latest(store: StateStore, pool_id: str, identity: str,
                   record: dict, attempts: int = 5) -> Optional[int]:
    """Read-modify-write one identity's record into the pool map
    under a generation precondition (two nodes exporting DIFFERENT
    identities concurrently must not clobber each other's pointer).
    Returns the new latest.json generation, or None."""
    key = names.compile_cache_latest_key(pool_id)
    for _ in range(attempts):
        try:
            meta = store.get_object_meta(key)
            current = latest_info(store, pool_id) or {"identities": {}}
            precondition = meta.generation
        except NotFoundError:
            current = {"identities": {}}
            precondition = 0  # create-only
        current.setdefault("identities", {})[identity] = record
        try:
            return store.put_object(
                key, json.dumps(current).encode("utf-8"),
                if_generation_match=precondition)
        except PreconditionFailedError:
            continue
    logger.warning("compile cache latest.json update lost the "
                   "precondition race %d times for pool %s",
                   attempts, pool_id)
    return None


def export_cache(store: StateStore, pool_id: str, cache_root: str,
                 owner: str) -> Optional[int]:
    """Upload every identity subdir of the node's cache root that is
    newer than the pool's artifact. Returns the generation of the
    latest.json this node wrote (the caller's seed probe can latch on
    it — it covers everything this node just uploaded), or None when
    nothing was exported. Never raises."""
    generation: Optional[int] = None
    try:
        latest = latest_info(store, pool_id) or {"identities": {}}
        for identity, cache_dir in sorted(
                manager.list_identity_dirs(cache_root).items()):
            if manager.read_identity(cache_dir) != identity:
                continue  # unstamped/corrupt subdir: not exportable
            entries = manager.snapshot(cache_dir)
            if not entries:
                continue
            published = latest["identities"].get(identity) or {}
            if int(published.get("entries", 0)) >= len(entries):
                continue
            lease = store.acquire_lease(
                names.compile_cache_lease_key(pool_id, identity),
                EXPORT_LEASE_SECONDS, owner)
            if lease is None:
                continue
            try:
                key = names.compile_cache_key(pool_id, identity)
                store.put_object_stream(
                    key, _tar_chunks(cache_dir, entries))
                written = _update_latest(store, pool_id, identity, {
                    "key": key,
                    "entries": len(entries),
                    "bytes": sum(entries.values()),
                    "node_id": owner,
                    "updated_at": utcnow_iso(),
                })
                if written is not None:
                    generation = written
                logger.info(
                    "exported compile cache seed for pool %s: %d "
                    "entries, %d bytes (identity %s)", pool_id,
                    len(entries), sum(entries.values()), identity)
            finally:
                try:
                    store.release_lease(lease)
                except Exception:  # noqa: BLE001 - expiry races
                    pass
        return generation
    except Exception:  # noqa: BLE001 - seeding must never fail work
        logger.warning("compile cache export failed for pool %s",
                       pool_id, exc_info=True)
        return generation


def _safe_extract(tar: tarfile.TarFile, cache_dir: str) -> int:
    """Extract flat regular members only; reject traversal. Existing
    files are kept (the node's own entries are never clobbered by a
    seed)."""
    count = 0
    for member in tar.getmembers():
        name = member.name
        if (not member.isfile() or name.startswith(("/", "..")) or
                "/" in name or "\\" in name):
            logger.warning("compile cache seed: skipping suspicious "
                           "tar member %r", name)
            continue
        target = os.path.join(cache_dir, name)
        if os.path.exists(target):
            continue
        src = tar.extractfile(member)
        if src is None:
            continue
    
        tmp = target + ".seedtmp"
        with open(tmp, "wb") as dst:
            dst.write(src.read())
        os.replace(tmp, target)
        count += 1
    return count


def _seed_one(store: StateStore, record: dict,
              cache_dir: str) -> bool:
    """Download one identity's artifact (streamed to a spooled temp
    file, never fully in memory) and
    extract the entries the local subdir is missing."""
    os.makedirs(cache_dir, exist_ok=True)
    local = manager.snapshot(cache_dir)
    if len(local) >= int(record.get("entries", 0)):
        return False
    with tempfile.SpooledTemporaryFile(
            max_size=32 * 1024 * 1024) as spool:
        for chunk in store.get_object_stream(record["key"]):
            spool.write(chunk)
        spool.seek(0)
        with tarfile.open(fileobj=spool, mode="r") as tar:
            return _safe_extract(tar, cache_dir) > 0


def seed_cache(store: StateStore, pool_id: str, cache_root: str,
               expected_identity: Optional[str] = None) -> str:
    """Populate ``cache_root``'s identity subdirs from the pool's
    artifacts; returns one of the outcome constants above (never
    raises). ``expected_identity`` pins ONE identity — refused (with
    a log) when the pool doesn't publish it; without a pin every
    published identity seeds its own subdir (a mixed pool's next
    workload type finds its cache warm too)."""
    try:
        latest = latest_info(store, pool_id)
        if latest is None:
            return ABSENT
        identities = latest.get("identities", {})
        if expected_identity is not None:
            if expected_identity not in identities:
                logger.warning(
                    "compile cache seed for pool %s refused: no "
                    "artifact for identity %s (published: %s) — "
                    "torch/CUDA/device/topology/model differ",
                    pool_id, expected_identity,
                    sorted(identities) or "none")
                return REFUSED
            identities = {
                expected_identity: identities[expected_identity]}
        seeded = 0
        for identity, record in sorted(identities.items()):
            if not isinstance(record, dict) or not record.get("key"):
                continue
            if _seed_one(store, record,
                         manager.identity_subdir(cache_root,
                                                 identity)):
                seeded += 1
                logger.info("seeded compile cache for pool %s "
                            "(identity %s)", pool_id, identity)
        if seeded:
            return SEEDED
        return SKIP if identities else ABSENT
    except NotFoundError:
        return ABSENT
    except Exception:  # noqa: BLE001 - seeding must never fail work
        logger.warning("compile cache seed failed for pool %s",
                       pool_id, exc_info=True)
        return ERROR


def prune(store: StateStore, pool_id: str) -> int:
    """Delete the pool's cache artifacts (the stale-cache escape
    hatch: after a torch upgrade or a model change it leaves nothing
    for nodes to mis-seed from). Returns the
    number of objects removed."""
    removed = 0
    for key in store.list_objects(f"compilecache/{pool_id}/"):
        try:
            store.delete_object(key)
            removed += 1
        except NotFoundError:
            pass
    return removed


def stats(store: StateStore, pool_id: str) -> dict:
    """The pool's seed state (``shipyard pool cache stats``)."""
    latest = latest_info(store, pool_id)
    artifacts = store.list_objects(f"compilecache/{pool_id}/")
    return {
        "pool_id": pool_id,
        "identities": (latest or {}).get("identities", {}),
        "artifacts": sorted(a for a in artifacts
                            if a.endswith(".tar")),
    }
