"""State store factory: resolve credentials settings -> a StateStore.

The port's copy of batch_shipyard_tpu/state/factory.py: ``memory`` (one
store per prefix and process), ``localfs`` (a root directory) and
``gcs`` (a bucket, state/gcs.py)."""

from __future__ import annotations

from batch_shipyard_tpu_torch.config.settings import StorageCredentialsSettings
from batch_shipyard_tpu_torch.state.base import StateStore

_SHARED_MEMORY_STORES: dict[str, StateStore] = {}


def create_statestore(storage: StorageCredentialsSettings) -> StateStore:
    if storage.backend == "memory":
        # Shared per-prefix within the process so CLI actions in one
        # process (and tests) observe each other's state.
        if storage.prefix not in _SHARED_MEMORY_STORES:
            from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
            _SHARED_MEMORY_STORES[storage.prefix] = MemoryStateStore()
        return _SHARED_MEMORY_STORES[storage.prefix]
    if storage.backend == "localfs":
        if not storage.root:
            raise ValueError("storage.root is required for localfs backend")
        from batch_shipyard_tpu_torch.state.localfs import LocalFSStateStore
        return LocalFSStateStore(storage.root)
    if storage.backend == "gcs":
        if not storage.bucket:
            raise ValueError("storage.bucket is required for gcs backend")
        from batch_shipyard_tpu_torch.state.gcs import GCSStateStore
        return GCSStateStore(storage.bucket, prefix=storage.prefix)
    raise ValueError(f"unknown storage backend {storage.backend!r}")
