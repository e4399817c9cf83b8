"""The compile cache of the port's kernel libraries: identity key, hit
statistics and the workloads' flags.

The port's copy of batch_shipyard_tpu/compilecache/manager.py. What
the port compiles before its first step is its kernel libraries:
``ops/_build.py`` builds each ``ops/csrc/*.cu`` with ``nvcc`` into a
shared library named by a digest of the source, the headers and the
flags, so a library that does not match the tree can never load; it
can only miss. The manager adds the operational layer:

  * ``enable`` points ``ops/_build.py`` at a directory (``<root>/ident-
    <identity>/``), stamped with a sidecar ``identity.json``: libraries
    are built into it and loaded from it. It configures no JIT.
  * ``identity_key`` is the transport key for pool-wide seeding
    (compilecache/seeding.py): the torch and CUDA versions, the backend,
    the device name and compute capability, the device and process
    counts, the mesh axes and a model-config digest. nvcc's version is
    left out: a warm node needs no toolkit to compute its identity and
    load its libraries.
  * ``track`` measures one region by diffing the directory's entries
    around it: new entries are a cold build (its wall time is kept per
    label in the ``cache_meta.json`` sidecar, which travels with the
    seed tar); no new entry over a non-empty cache is a warm hit, and
    ``saved_seconds`` is the remembered cold time less the measured warm
    time. These land in the goodput compile events' attrs
    (``cache_hit`` / ``saved_seconds``).

The layout is the reference's, so the reference's agent seeds and
exports the port's caches unchanged: entries are the top-level files of
an identity dir (the libraries); the sidecars and the build logs (a
subdirectory) are not entries.

No module-level torch import: the node side imports this for the env
name and seeding without a device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import logging
import os
import re
import threading
import time
from typing import Any, Iterator, Optional

from batch_shipyard_tpu_torch.agent.preemption import utcnow_iso

logger = logging.getLogger(__name__)

# Env var the pool's agent exports into every task: the node-local
# cache root (seeded from and exported to the pool's state store around
# tasks).
CACHE_DIR_ENV = "SHIPYARD_COMPILE_CACHE_DIR"

# Sidecar files the manager owns inside an identity dir. They are not
# entries (snapshot() leaves them out) but they travel with the seed
# tar: identity gates transport, meta carries cold times so a seeded
# node can price its warm hits.
IDENTITY_FILE = "identity.json"
META_FILE = "cache_meta.json"
_SIDECARS = (IDENTITY_FILE, META_FILE)

# Object repr memory addresses never enter a digest: they vary per
# process.
_ADDR_RE = re.compile(r"0x[0-9a-fA-F]+")


def _stable(obj: Any) -> Any:
    """A config value reduced to a deterministic, process-independent
    structure for digesting."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _stable(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): _stable(v) for k, v in sorted(obj.items())}
    if isinstance(obj, (list, tuple)):
        return [_stable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if callable(obj):
        return getattr(obj, "__qualname__", type(obj).__name__)
    return _ADDR_RE.sub("0x", str(obj))


def config_digest(obj: Any) -> str:
    """Stable short digest of a model config (dataclass, dict, anything):
    identical configs digest identically across processes; any field
    change changes it."""
    payload = json.dumps(_stable(obj), sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def identity_key(*, torch_version: Optional[str] = None,
                 cuda_version: Optional[str] = None,
                 backend: Optional[str] = None,
                 device_kind: Optional[str] = None,
                 capability: Optional[str] = None,
                 device_count: Optional[int] = None,
                 process_count: Optional[int] = None,
                 mesh_shape: Optional[dict] = None,
                 model_digest: Optional[str] = None) -> str:
    """The cache transport identity: pure over its inputs (tests pass
    them); the fields left out resolve from the live torch runtime
    (``backend``: "cuda" where a card is visible, else "cpu"). Two
    nodes share cache artifacts iff their keys match."""
    if None in (torch_version, cuda_version, backend, device_kind,
                capability, device_count, process_count):
        import torch
        import torch.distributed as dist
        if torch_version is None:
            torch_version = torch.__version__
        if cuda_version is None:
            cuda_version = torch.version.cuda or ""
        if backend is None:
            backend = "cuda" if torch.cuda.is_available() else "cpu"
        on_card = backend == "cuda"
        if device_kind is None:
            device_kind = (torch.cuda.get_device_name(0) if on_card
                           else "cpu")
        if capability is None:
            capability = ("sm_%d%d" % torch.cuda.get_device_capability(0)
                          if on_card else "")
        if device_count is None:
            device_count = torch.cuda.device_count() if on_card else 1
        if process_count is None:
            process_count = (dist.get_world_size()
                             if dist.is_initialized() else 1)
    payload = json.dumps({
        "torch": torch_version, "cuda": cuda_version,
        "backend": backend, "device_kind": device_kind,
        "capability": capability,
        "device_count": int(device_count),
        "process_count": int(process_count),
        "mesh_shape": _stable(mesh_shape or {}),
        "model_digest": model_digest or "",
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def snapshot(cache_dir: str) -> dict[str, int]:
    """Cache ENTRIES (name -> size): the dir's top-level files, less
    the manager's sidecars, access markers (``-atime``) and in-flight
    temporaries (``.tmp``, ``.seedtmp``)."""
    entries: dict[str, int] = {}
    try:
        for name in os.listdir(cache_dir):
            if name in _SIDECARS or name.endswith(
                    ("-atime", ".tmp", ".seedtmp")):
                continue
            path = os.path.join(cache_dir, name)
            if os.path.isfile(path):
                entries[name] = os.path.getsize(path)
    except OSError:
        pass
    return entries


class CompileCacheManager:
    """One process's handle on an enabled cache dir."""

    def __init__(self, cache_dir: str, identity: str) -> None:
        self.cache_dir = os.path.abspath(cache_dir)
        self.identity = identity
        self.hits = 0
        self.misses = 0
        self.saved_seconds = 0.0
        # Labels already measured IN THIS PROCESS: a repeat (replica
        # engines 2..N over libraries replica 1 loaded) reuses what the
        # process holds, not the cache; crediting it as a warm hit would
        # multiply saved_seconds by the replica count.
        self._seen_labels: set = set()

    # ------------------------------ stats ------------------------------

    def entries(self) -> dict[str, int]:
        return snapshot(self.cache_dir)

    def stats(self) -> dict:
        entries = self.entries()
        return {
            "cache_dir": self.cache_dir, "identity": self.identity,
            "entries": len(entries),
            "bytes": sum(entries.values()),
            "hits": self.hits, "misses": self.misses,
            "saved_seconds": round(self.saved_seconds, 6),
        }

    def _load_meta(self) -> dict:
        try:
            with open(os.path.join(self.cache_dir, META_FILE),
                      encoding="utf-8") as fh:
                meta = json.load(fh)
            return meta if isinstance(meta, dict) else {}
        except (OSError, ValueError):
            return {}

    def _save_meta(self, meta: dict) -> None:
        """Write the meta sidecar through a temporary of this process and
        thread, so ranks of one node that start cold together never
        write one temporary file."""
        path = os.path.join(self.cache_dir, META_FILE)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(meta, fh)
            os.replace(tmp, path)
        except OSError:
            logger.debug("cache meta write failed", exc_info=True)

    @contextlib.contextmanager
    def track(self, label: str) -> Iterator[dict]:
        """Measure one build region against the cache dir. Yields a
        result dict filled in on exit: ``cache_hit``, ``new_entries``,
        ``elapsed_seconds``, ``saved_seconds``, ``in_process_reuse``. A
        cold build records its wall time per label in the meta sidecar
        (the first cold measurement wins: a partly warm rerun must not
        overwrite it); a later warm run of the label in a FRESH process
        (this node or a seeded one) prices its saving against that. A
        repeat of a label within one process is reported
        (``in_process_reuse``) but neither counted nor priced."""
        first_of_label = label not in self._seen_labels
        self._seen_labels.add(label)
        before = snapshot(self.cache_dir)
        start = time.perf_counter()
        result: dict = {"label": label}
        try:
            yield result
        finally:
            elapsed = time.perf_counter() - start
            after = snapshot(self.cache_dir)
            new = [name for name in after if name not in before]
            hit = not new and bool(before) and first_of_label
            result["elapsed_seconds"] = elapsed
            result["new_entries"] = len(new)
            result["cache_hit"] = bool(hit)
            result["in_process_reuse"] = not first_of_label and not new
            saved = 0.0
            if not result["in_process_reuse"]:
                meta = self._load_meta()
                if new:
                    meta.setdefault("cold_seconds",
                                    {}).setdefault(label, elapsed)
                    self._save_meta(meta)
                    self.misses += 1
                elif hit:
                    cold = meta.get("cold_seconds", {}).get(label)
                    try:
                        saved = max(0.0, float(cold) - elapsed)
                    except (TypeError, ValueError):
                        saved = 0.0
                    self.hits += 1
                else:
                    self.misses += 1
            result["saved_seconds"] = saved
            self.saved_seconds += saved


_current: Optional[CompileCacheManager] = None


def current() -> Optional[CompileCacheManager]:
    """The process's enabled manager, or None (cache disabled)."""
    return _current


def identity_subdir(cache_root: str, identity: str) -> str:
    """The identity-namespaced cache dir under a shared root."""
    return os.path.join(os.path.abspath(cache_root), f"ident-{identity}")


def list_identity_dirs(cache_root: str) -> dict[str, str]:
    """identity -> subdir for every namespaced cache under a root."""
    out: dict[str, str] = {}
    try:
        for name in os.listdir(cache_root):
            if not name.startswith("ident-"):
                continue
            path = os.path.join(cache_root, name)
            if os.path.isdir(path):
                out[name[len("ident-"):]] = path
    except OSError:
        pass
    return out


def enable(cache_root: str, *, identity: Optional[str] = None,
           mesh_shape: Optional[dict] = None,
           model_digest: Optional[str] = None,
           backend: Optional[str] = None) -> CompileCacheManager:
    """Install the process-global manager over ``cache_root``'s
    identity subdir, which ``ops/_build.py`` then builds libraries into
    and loads them from. Call it before the first kernel launch: a
    library the process already loaded stays loaded from where it was.
    Namespacing lets a mixed pool share one node dir: a transformer task
    and a ResNet task (two identities) each warm their own subdir.
    Raises OSError when the subdir cannot be made or written."""
    global _current
    if identity is None:
        identity = identity_key(mesh_shape=mesh_shape,
                                model_digest=model_digest,
                                backend=backend)
    cache_dir = identity_subdir(cache_root, identity)
    os.makedirs(cache_dir, exist_ok=True)
    if not os.access(cache_dir, os.W_OK | os.X_OK):
        raise OSError(f"compile cache dir {cache_dir} is not writable")
    if read_identity(cache_dir) != identity:
        try:
            with open(os.path.join(cache_dir, IDENTITY_FILE), "w",
                      encoding="utf-8") as fh:
                json.dump({"identity": identity,
                           "written_at": utcnow_iso()}, fh)
        except OSError:
            logger.debug("identity write failed", exc_info=True)
    _current = CompileCacheManager(cache_dir, identity)
    return _current


def read_identity(cache_dir: str) -> Optional[str]:
    """The identity a cache dir was stamped with, or None."""
    try:
        with open(os.path.join(cache_dir, IDENTITY_FILE),
                  encoding="utf-8") as fh:
            value = json.load(fh).get("identity")
        return value if isinstance(value, str) else None
    except (OSError, ValueError, AttributeError):
        return None


@contextlib.contextmanager
def tracked(attrs: dict, label: str) -> Iterator[None]:
    """Nest inside a goodput compile or warm-up phase to stamp the
    event's attrs with ``cache_hit`` / ``saved_seconds``::

        with goodput_events.phase(PROGRAM_COMPILE, what="x") as attrs,\\
                manager.tracked(attrs, "x"):
            ...  # the builds

    No-op when no manager is enabled."""
    mgr = current()
    if mgr is None:
        yield
        return
    with mgr.track(label) as result:
        yield
    if result.get("in_process_reuse"):
        # Neither a persistent-cache hit nor a miss.
        return
    attrs["cache_hit"] = result["cache_hit"]
    attrs["saved_seconds"] = round(result["saved_seconds"], 6)


def add_compile_cache_args(parser) -> None:
    """The warm-start flags of every train and serve workload."""
    group = parser.add_argument_group("compile cache")
    group.add_argument(
        "--compile-cache-dir",
        default=os.environ.get(CACHE_DIR_ENV) or None,
        help="persistent kernel-library cache root (default: "
             f"${CACHE_DIR_ENV}, which the pool's agent exports; unset: "
             "libraries build under build/torch_kernels/)")
    group.add_argument(
        "--no-compile-cache", action="store_true",
        help="opt out of the cache even when "
             f"${CACHE_DIR_ENV} is set")
    group.add_argument(
        "--aot-precompile", action="store_true",
        help="build and load the step's kernel libraries (and, serving, "
             "capture its CUDA graphs) before the first step, overlapping "
             "the data and restore set-up")


def enable_from_args(args, *, mesh_shape: Optional[dict] = None,
                     model_digest: Optional[str] = None
                     ) -> Optional[CompileCacheManager]:
    """The workload-side enable hook: enables the cache when a dir is
    configured (the identity's backend is "cpu" under ``--device
    cpu``), returns None when disabled. Never raises: a broken cache
    dir disables the cache, and the libraries then build in the default
    dir."""
    cache_dir = getattr(args, "compile_cache_dir", None)
    if not cache_dir or getattr(args, "no_compile_cache", False):
        return None
    device = getattr(args, "device", None)
    backend = "cpu" if device is not None and \
        str(device).startswith("cpu") else None
    try:
        return enable(cache_dir, mesh_shape=mesh_shape,
                      model_digest=model_digest, backend=backend)
    except Exception:  # noqa: BLE001 - warm start is best-effort
        logger.warning("compile cache enable failed for %s", cache_dir,
                       exc_info=True)
        return None
