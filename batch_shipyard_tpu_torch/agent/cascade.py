"""Cascade: pool-wide container-image replication with lease gating.

The port's copy of batch_shipyard_tpu/agent/cascade.py.

Reference analog: cascade/cascade.py — the on-node image replicator
whose pool-wide concurrency gate is blob leases over per-resource lock
blobs ``hash.{0..N}`` (_direct_download_resources_async cascade.py:574,
60 s lease + renew at :628). Re-designed:

  - global resources (images) live in TABLE_IMAGES per pool, written by
    ``pool add`` (storage.populate_global_resource_blobs analog,
    storage.py:476);
  - an agent wanting image X acquires one of
    ``grlocks/<pool>/<hash>.{0..K-1}`` leases (K =
    concurrent_source_downloads) before pulling, renewing on a
    background thread while the pull runs — bounding simultaneous
    registry load across the whole pool exactly like the reference;
  - pull happens via docker/singularity CLI with registry fallback;
    perf events record pull start/end per image.

On nodes without docker (tests, bare TPU VMs running runtime:none
tasks) pulls are skipped but the gate/accounting logic still runs, so
the protocol is fully unit-testable (SURVEY.md section 4).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
import time
from typing import Optional

from batch_shipyard_tpu_torch.agent import perf
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.utils import secrets
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, NotFoundError, StateStore)
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

LEASE_SECONDS = 60.0
RENEW_INTERVAL = 15.0


def populate_global_resources(store: StateStore, pool_id: str,
                              docker_images: list[str],
                              singularity_images: list[str] = (),
                              concurrent_downloads: int = 10,
                              registries: list = ()) -> None:
    """Write the pool's image manifest (pool add path). ``registries``
    (config.settings.DockerRegistry) ride the same manifest as
    kind="registry" rows so every node logs in before its first pull
    (reference scripts/registry_login.sh via the nodeprep flag
    contract). Passwords are stored as their secret:// refs, resolved
    on node — never plaintext in the state store."""
    def _upsert_preserving_blob(key: str, row: dict) -> None:
        # A preloaded tarball (preload_image_tarball) may already have
        # attached a source_blob to this image; re-populating the
        # manifest must not sever it.
        try:
            old = store.get_entity(names.TABLE_IMAGES, pool_id, key)
            if old.get("source_blob"):
                row = {**row, "source_blob": old["source_blob"]}
        except NotFoundError:
            pass
        store.upsert_entity(names.TABLE_IMAGES, pool_id, key, row)

    for image in docker_images:
        key = util.hash_string(f"docker:{image}")[:24]
        _upsert_preserving_blob(key, {
            "kind": "docker", "image": image,
            "concurrent_downloads": concurrent_downloads})
    for image in singularity_images:
        key = util.hash_string(f"singularity:{image}")[:24]
        _upsert_preserving_blob(key, {
            "kind": "singularity", "image": image,
            "concurrent_downloads": concurrent_downloads})
    for reg in registries or ():
        if reg.password and not secrets.is_secret_id(reg.password):
            # The documented contract is that plaintext never lands in
            # the state store; a raw password here would persist in
            # the images table readable by every node.
            logger.warning(
                "docker registry %s password is NOT a secret:// ref; "
                "it will be stored in the shared state store in "
                "PLAINTEXT — use secret://env/... or "
                "secret://gcp-sm/... instead", reg.server)
        key = util.hash_string(f"registry:{reg.server}")[:24]
        store.upsert_entity(names.TABLE_IMAGES, pool_id, key, {
            "kind": "registry", "server": reg.server,
            "username": reg.username, "password": reg.password,
            "auth": reg.auth})


def preload_image_tarball(store: StateStore, pool_id: str, image: str,
                          chunks, kind: str = "docker") -> str:
    """Upload an image tarball (e.g. `docker save` output chunks) to
    the object store and bind it to the pool's image manifest row —
    the reference cascade's DIRECT DOWNLOAD mode
    (cascade/cascade.py:574 _direct_download_resources_async: images
    ride Azure Storage instead of a registry). Nodes then stream the
    tarball from the state store (lease-gated like registry pulls) and
    `docker load` it, which also serves air-gapped pools with no
    registry egress. Returns the object key."""
    key = util.hash_string(f"{kind}:{image}")[:24]
    blob_key = f"cascade/{pool_id}/{key}.tar"
    store.put_object_stream(blob_key, chunks)
    try:
        store.merge_entity(names.TABLE_IMAGES, pool_id, key,
                           {"source_blob": blob_key})
    except NotFoundError:
        store.upsert_entity(names.TABLE_IMAGES, pool_id, key, {
            "kind": kind, "image": image,
            "concurrent_downloads": 10, "source_blob": blob_key})
    return blob_key


def registry_manifest(store: StateStore, pool_id: str) -> list[dict]:
    """The pool's registry-credential rows."""
    return [row for row in store.query_entities(
        names.TABLE_IMAGES, partition_key=pool_id)
        if row.get("kind") == "registry"]


def global_resources_loaded(store: StateStore, pool_id: str,
                            node_id: str) -> bool:
    """Has this node recorded completion of all its image pulls?"""
    wanted = {row["_rk"] for row in store.query_entities(
        names.TABLE_IMAGES, partition_key=pool_id)
        if row.get("kind") != "registry"}
    if not wanted:
        return True
    try:
        row = store.get_entity(names.TABLE_IMAGES + "done", pool_id,
                               node_id)
    except NotFoundError:
        return False
    return wanted <= set(row.get("loaded", []))


class CascadeImageProvisioner:
    """Per-node image puller with the pool-wide lease gate."""

    def __init__(self, store: StateStore, fallback_registry:
                 Optional[str] = None, pull_timeout: float = 1800.0,
                 puller: Optional[object] = None,
                 login_runner: Optional[object] = None,
                 secrets_file: Optional[str] = None) -> None:
        self.store = store
        self.fallback_registry = fallback_registry
        self.pull_timeout = pull_timeout
        self._puller = puller  # test hook: callable(kind, image) -> int
        # test hook: callable(argv: list[str], stdin: str|None) -> int
        self._login_runner = login_runner
        self._secrets_file = secrets_file or os.environ.get(
            "SHIPYARD_SECRETS_FILE")
        self._loaded: set[str] = set()
        self._logged_in: set[str] = set()
        self._lock = threading.Lock()

    # -- registry auth --------------------------------------------------

    def login_registries(self, pool_id: str) -> None:
        """Authenticate to every registry in the pool manifest before
        pulls (reference scripts/registry_login.sh:1-99 — docker login
        per configured registry; Artifact Registry rows instead run
        ``gcloud auth configure-docker``). secret:// passwords resolve
        HERE, on node, via utils/secrets. Idempotent per server."""
        from batch_shipyard_tpu_torch.utils import secrets as secrets_mod
        for row in registry_manifest(self.store, pool_id):
            server = row.get("server") or ""
            with self._lock:
                if server in self._logged_in:
                    continue
            if row.get("auth") == "gcloud":
                argv = ["gcloud", "auth", "configure-docker", server,
                        "--quiet"]
                rc = self._run_login(argv, None)
            else:
                password = row.get("password") or ""
                if secrets_mod.is_secret_id(password):
                    password = secrets_mod.resolve_secret(
                        password, secrets_file=self._secrets_file)
                argv = ["docker", "login", server,
                        "--username", row.get("username") or "",
                        "--password-stdin"]
                rc = self._run_login(argv, password)
            if rc != 0:
                raise RuntimeError(
                    f"registry login to {server!r} failed rc={rc}")
            with self._lock:
                self._logged_in.add(server)

    def _run_login(self, argv: list, stdin_data) -> int:
        if self._login_runner is not None:
            return self._login_runner(argv, stdin_data)
        if shutil.which(argv[0]) is None:
            logger.info("%s unavailable; skipping registry login",
                        argv[0])
            return 0
        proc = subprocess.run(
            argv, input=(stdin_data.encode() if stdin_data else None),
            timeout=120, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE)
        if proc.returncode != 0:
            logger.error("registry login failed: %s",
                         proc.stderr.decode(errors="replace").strip())
        return proc.returncode

    # -- entry points ---------------------------------------------------

    def distribute_global_resources(self, agent) -> None:
        """Pull every image in the pool manifest (nodeprep path;
        reference cascade.py:724 distribute_global_resources)."""
        pool_id = agent.identity.pool_id
        self.login_registries(pool_id)
        rows = [row for row in self.store.query_entities(
            names.TABLE_IMAGES, partition_key=pool_id)
            if row.get("kind") != "registry"]
        for row in rows:
            self._fetch(agent, row["_rk"], row["kind"], row["image"],
                        int(row.get("concurrent_downloads", 10)),
                        source_blob=row.get("source_blob"))
        perf.emit(self.store, pool_id, agent.identity.node_id, "cascade",
                  "global_resources_loaded")

    def __call__(self, agent, images: list[str],
                 kind: str = "docker") -> None:
        """Agent hook: ensure specific images before running a task.
        The key must match populate_global_resources' kind-qualified
        hash so the pool-wide lease gate is actually shared."""
        pool_id = agent.identity.pool_id
        self.login_registries(pool_id)
        for image in images:
            key = util.hash_string(f"{kind}:{image}")[:24]
            try:
                row = self.store.get_entity(
                    names.TABLE_IMAGES, pool_id, key)
            except NotFoundError:
                row = {"kind": kind, "image": image,
                       "concurrent_downloads": 10}
            self._fetch(agent, key, row["kind"], row.get("image", image),
                        int(row.get("concurrent_downloads", 10)),
                        source_blob=row.get("source_blob"))

    # -- internals ------------------------------------------------------

    def _fetch(self, agent, resource_hash: str, kind: str, image: str,
               concurrent: int, source_blob: Optional[str] = None,
               ) -> None:
        with self._lock:
            if resource_hash in self._loaded:
                return
        pool_id = agent.identity.pool_id
        node_id = agent.identity.node_id
        handle = None
        # Acquire one of the K lock slots (reference hash.{0..N} blobs).
        while handle is None:
            for slot in range(max(1, concurrent)):
                lease_key = names.global_resource_lock_key(
                    pool_id, resource_hash, slot)
                handle = self.store.acquire_lease(
                    lease_key, LEASE_SECONDS, node_id)
                if handle is not None:
                    break
            if handle is None:
                if getattr(agent, "stop_event", None) is not None and \
                        agent.stop_event.is_set():
                    return
                time.sleep(0.1)
        stop_renew = threading.Event()

        def _renew():
            nonlocal handle
            while not stop_renew.wait(RENEW_INTERVAL):
                try:
                    handle = self.store.renew_lease(handle, LEASE_SECONDS)
                except Exception:
                    logger.warning("cascade lease renew lost for %s",
                                   image)
                    return

        renewer = threading.Thread(target=_renew, daemon=True)
        renewer.start()
        try:
            perf.emit(self.store, pool_id, node_id, "cascade",
                      f"pull.start:{image}")
            rc = self._pull(kind, image, source_blob=source_blob)
            perf.emit(self.store, pool_id, node_id, "cascade",
                      f"pull.end:{image}", message=str(rc))
            if rc == 0:
                with self._lock:
                    self._loaded.add(resource_hash)
                self._record_loaded(pool_id, node_id)
        finally:
            stop_renew.set()
            renewer.join(timeout=1.0)
            try:
                self.store.release_lease(handle)
            except Exception:
                pass

    def _pull(self, kind: str, image: str,
              source_blob: Optional[str] = None) -> int:
        if self._puller is not None:
            return self._puller(kind, image)
        if source_blob:
            return self._direct_download(kind, image, source_blob)
        if kind == "docker":
            if shutil.which("docker") is None:
                logger.info("docker unavailable; skipping pull of %s",
                            image)
                return 0
            rc = subprocess.call(["docker", "pull", image],
                                 timeout=self.pull_timeout)
            if rc != 0 and self.fallback_registry:
                fallback = f"{self.fallback_registry}/{image}"
                rc = subprocess.call(["docker", "pull", fallback],
                                     timeout=self.pull_timeout)
                if rc == 0:
                    rc = subprocess.call(
                        ["docker", "tag", fallback, image])
            return rc
        if kind == "singularity":
            if shutil.which("singularity") is None:
                logger.info("singularity unavailable; skipping %s", image)
                return 0
            return subprocess.call(
                ["singularity", "pull", "--force", f"docker://{image}"],
                timeout=self.pull_timeout)
        raise ValueError(f"unknown image kind {kind!r}")

    def _direct_download(self, kind: str, image: str,
                         source_blob: str) -> int:
        """Stream a preloaded image tarball from the object store to
        the node's cache (the reference's direct-download mode), then
        `docker load` it when docker is present. Without docker the
        tarball still lands on disk — real bytes over the real store
        path, which is also what the bench measures."""
        import tempfile
        if not getattr(self, "_cache_dir", None):
            self._cache_dir = tempfile.mkdtemp(
                prefix="shipyard-image-cache-")
        path = os.path.join(self._cache_dir,
                            os.path.basename(source_blob))
        tmp = path + ".part"
        total = 0
        with open(tmp, "wb") as fh:
            for chunk in self.store.get_object_stream(source_blob):
                fh.write(chunk)
                total += len(chunk)
        os.replace(tmp, path)
        logger.info("direct-downloaded %s (%d bytes) from %s",
                    image, total, source_blob)
        if kind == "docker" and shutil.which("docker"):
            return subprocess.call(["docker", "load", "-i", path],
                                   timeout=self.pull_timeout)
        if kind == "singularity" and shutil.which("singularity"):
            # A saved OCI tarball loads as a sif build source.
            return subprocess.call(
                ["singularity", "build", "--force",
                 path + ".sif", f"docker-archive://{path}"],
                timeout=self.pull_timeout)
        return 0

    def _record_loaded(self, pool_id: str, node_id: str) -> None:
        with self._lock:
            loaded = sorted(self._loaded)
        table = names.TABLE_IMAGES + "done"
        try:
            self.store.insert_entity(table, pool_id, node_id,
                                     {"loaded": loaded})
        except EntityExistsError:
            self.store.merge_entity(table, pool_id, node_id,
                                    {"loaded": loaded})
