"""Data movement: ingress/egress between local paths, the object store,
and pool nodes.

The port's copy of batch_shipyard_tpu/data/movement.py.

Reference analog: convoy/data.py — ingress_data(:981) dispatching to
blobxfer (azure_storage) or scp/rsync (_singlenode_transfer :492 /
_multinode_transfer :567 with round-robin size-balanced file sharding
and optional byte-offset splits), plus task-level process_input_data
(:219) and process_output_data (:447).

TPU-native mapping:
  - azure_storage/blobxfer  -> the state store's object space (GCS in
    production) via put/get_object_stream — every transfer is chunked
    (STREAM_CHUNK_BYTES), so a multi-GB ingress never materializes a
    file in memory (the blobxfer streaming role, data.py:62);
  - shared-fs scp/rsync     -> same ssh-based sharded transfer,
    synthesized as command lines (testable dry-run; executed via
    subprocess when live), including byte-offset splits of large
    single files across nodes (reference _multinode_transfer
    data.py:567-739 + piece reassembly :850-875);
  - task input_data/output_data -> handled by the node agent around
    task execution using statestore keys (kind: statestore) or local
    paths.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import math
import os
import subprocess
import threading
from typing import Iterator, Optional

from batch_shipyard_tpu_torch.config.settings import GlobalSettings
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import NotFoundError, StateStore
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)


# --------------------------- object ingress ----------------------------

def _iter_files(source: str, include: Optional[list[str]] = None,
                exclude: Optional[list[str]] = None):
    if os.path.isfile(source):
        yield source, os.path.basename(source)
        return
    for root, _dirs, files in os.walk(source):
        for name in files:
            path = os.path.join(root, name)
            rel = os.path.relpath(path, source)
            if include and not any(
                    fnmatch.fnmatch(rel, pat) for pat in include):
                continue
            if exclude and any(
                    fnmatch.fnmatch(rel, pat) for pat in exclude):
                continue
            yield path, rel


def _file_chunks(path: str, begin: int = 0,
                 end: Optional[int] = None,
                 chunk_size: int = StateStore.STREAM_CHUNK_BYTES,
                 ) -> Iterator[bytes]:
    """Yield a file's bytes (optionally a [begin, end) range) in
    bounded chunks, so callers never hold a whole file in memory."""
    with open(path, "rb") as fh:
        if begin:
            fh.seek(begin)
        left = None if end is None else end - begin
        while left is None or left > 0:
            want = chunk_size if left is None else min(chunk_size, left)
            buf = fh.read(want)
            if not buf:
                return
            if left is not None:
                left -= len(buf)
            yield buf


def ingress_to_storage(store: StateStore, source: str, dest_prefix: str,
                       include: Optional[list[str]] = None,
                       exclude: Optional[list[str]] = None) -> int:
    """Upload local file(s) into the object space, streamed in
    STREAM_CHUNK_BYTES chunks. Returns file count."""
    count = 0
    for path, rel in _iter_files(source, include, exclude):
        key = f"{dest_prefix.rstrip('/')}/{rel}".lstrip("/")
        store.put_object_stream(key, _file_chunks(path))
        count += 1
    logger.info("ingressed %d files from %s to %s", count, source,
                dest_prefix)
    return count


def _prefix_children(store: StateStore, prefix: str) -> list[str]:
    """Keys strictly under prefix treated as a directory (never keys
    that merely share a string prefix, e.g. 'v10' under 'v1')."""
    base = prefix.rstrip("/")
    return [k for k in store.list_objects(base)
            if k == base or k.startswith(base + "/")]


def egress_from_storage(store: StateStore, prefix: str,
                        dest_dir: str) -> int:
    """Download an object-prefix tree into a local directory."""
    count = 0
    base = prefix.rstrip("/")
    for key in _prefix_children(store, base):
        rel = key[len(base):].lstrip("/")
        if not rel:
            rel = os.path.basename(base)
        path = os.path.join(dest_dir, rel)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fh:
            for chunk in store.get_object_stream(key):
                fh.write(chunk)
        count += 1
    return count


def ingress_to_shared(spec: dict,
                      node_logins: list[tuple[str, str, int]],
                      ssh_username: str = "shipyard",
                      ssh_private_key: Optional[str] = None,
                      run: bool = True):
    """Direct-to-node ingress of one files spec onto a pool's shared
    filesystem (reference ingress_data dest=shared, data.py:981 →
    _multinode_transfer). destination.data_transfer options:
    method (scp|rsync), split_files_megabytes, destination.path (the
    mount point on the nodes), relative_destination_path.

    Returns the transfer plan when run=False, else the rc list."""
    source = spec.get("source", {})
    dest = spec.get("destination", {})
    dt = dest.get("data_transfer", {}) or {}
    dest_path = (dest.get("path") or
                 dest.get("shared_data_volume") or "/mnt/shared")
    rel = dest.get("relative_destination_path")
    if rel:
        dest_path = f"{dest_path.rstrip('/')}/{rel}"
    files = [(path, os.path.getsize(path)) for path, _rel in
             _iter_files(source.get("path", "."),
                         include=source.get("include"),
                         exclude=source.get("exclude"))]
    split_mb = dt.get("split_files_megabytes")
    plan = plan_multinode_transfer(
        files, node_logins, dest_path,
        method=dt.get("method", "scp"),
        ssh_username=ssh_username,
        ssh_private_key=ssh_private_key,
        split_bytes=(int(split_mb) * 1024 * 1024
                     if split_mb else None))
    if not run:
        return plan
    rcs = run_transfers(plan,
                        max_parallel=int(dt.get(
                            "max_parallel_transfers_per_node", 4)))
    return {"files": len(files), "rcs": rcs}


def ingress_data(store: StateStore, global_conf: GlobalSettings,
                 pool_id: Optional[str] = None,
                 node_logins: Optional[list[tuple[str, str, int]]] = None,
                 ssh_username: str = "shipyard",
                 ssh_private_key: Optional[str] = None) -> int:
    """Process global_resources.files ingress specs (data ingress verb,
    fleet.py:4496 analog). Storage-destined specs stream into the
    object space; shared-fs specs shard over the pool's nodes (pass
    ``node_logins`` = [(node_id, ip, port)] from the live pool)."""
    total = 0
    for spec in global_conf.files:
        source = spec.get("source", {})
        dest = spec.get("destination", {})
        if "storage" in dest or "prefix" in dest:
            prefix = (dest.get("storage", {}).get("prefix")
                      or dest.get("prefix", "ingress"))
            total += ingress_to_storage(
                store, source.get("path", "."), prefix,
                include=source.get("include"),
                exclude=source.get("exclude"))
        elif "shared_data_volume" in dest or "relative_destination_path" \
                in dest or "path" in dest:
            if not node_logins:
                raise ValueError(
                    "direct-to-node ingress requires a live pool's "
                    "node logins (data ingress with a pool config)")
            result = ingress_to_shared(
                spec, node_logins, ssh_username=ssh_username,
                ssh_private_key=ssh_private_key)
            if any(result["rcs"]):
                raise RuntimeError(
                    f"shared-fs ingress failed (rcs={result['rcs']})")
            total += result["files"]
    return total


# ------------------------ node (ssh) transfers -------------------------

# Suffix for byte-range pieces of a split file (reference
# _FILE_SPLIT_PREFIX '_shipyard-', data.py:65). Piece 0 keeps the
# final name; pieces 1..N-1 get '.{prefix}{n}' zero-padded so a shell
# glob reassembles them in order.
_SPLIT_PREFIX = "_shipyard-"


@dataclasses.dataclass(frozen=True)
class TransferPiece:
    """One byte range of a split file bound for one node. ``dst`` is
    the remote piece path; ``final_dst`` the file all sibling pieces
    reassemble into (on a SHARED destination filesystem — split
    ingress targets shared volumes, like the reference)."""
    src: str
    dst: str
    begin: int
    end: int
    final_dst: str


@dataclasses.dataclass(frozen=True)
class TransferCommand:
    node_id: str
    argv: tuple[str, ...]
    files: tuple[str, ...]
    total_bytes: int
    # Split-file byte ranges for this node; sent via `ssh 'cat > dst'`
    # with stdin fed from the local range (reference data.py:760-799).
    pieces: tuple[TransferPiece, ...] = ()
    # ssh invocation prefix for piece + reassembly commands.
    ssh_argv: tuple[str, ...] = ()


def plan_multinode_transfer(
        files: list[tuple[str, int]], nodes: list[tuple[str, str, int]],
        dest_path: str, method: str = "scp",
        ssh_username: str = "shipyard",
        ssh_private_key: Optional[str] = None,
        host_key_checking: str = "accept-new",
        split_bytes: Optional[int] = None,
        ) -> list[TransferCommand]:
    """Shard files across nodes round-robin balanced by size and emit
    per-node transfer command lines (reference _multinode_transfer
    data.py:567: largest-first onto least-loaded node).

    files: [(local_path, size)]; nodes: [(node_id, ip, port)].
    host_key_checking: OpenSSH StrictHostKeyChecking value. The
    'accept-new' default is trust-on-first-use; pass 'no' for
    throwaway/re-provisioned nodes whose IPs get recycled with fresh
    host keys (the reference's unconditional behavior).
    split_bytes: files larger than this are split into byte-range
    pieces distributed across nodes like independent files, so one
    huge file uses every node's NIC (reference split_files_megabytes,
    data.py:635-661). Requires method='scp' (the reference forces
    multinode_scp, :590) and a shared destination filesystem (pieces
    reassemble in place).
    """
    if method not in ("scp", "rsync"):
        raise ValueError(f"unknown transfer method {method!r}")
    if not nodes:
        raise ValueError("no nodes to transfer to")
    if split_bytes is not None and method != "scp":
        logger.warning("forcing transfer method to scp with split "
                       "(reference data.py:590)")
        method = "scp"
    loads: list[int] = [0] * len(nodes)
    shards: list[list[str]] = [[] for _ in nodes]
    piece_shards: list[list[TransferPiece]] = [[] for _ in nodes]

    def _least_loaded() -> int:
        return loads.index(min(loads))

    for path, size in sorted(files, key=lambda fs: -fs[1]):
        if split_bytes is not None and size > split_bytes:
            nsplits = int(math.ceil(size / split_bytes))
            lpad = int(math.log10(nsplits)) + 1
            final_dst = (f"{dest_path.rstrip('/')}/"
                         f"{os.path.basename(path)}")
            begin = 0
            n = 0
            while begin < size:
                end = min(begin + split_bytes, size)
                dst = (final_dst if n == 0 else
                       f"{final_dst}.{_SPLIT_PREFIX}{str(n).zfill(lpad)}")
                idx = _least_loaded()
                piece_shards[idx].append(TransferPiece(
                    src=path, dst=dst, begin=begin, end=end,
                    final_dst=final_dst))
                loads[idx] += end - begin
                begin = end
                n += 1
        else:
            idx = _least_loaded()
            shards[idx].append(path)
            loads[idx] += size
    out: list[TransferCommand] = []
    for (node_id, ip, port), shard, pieces, load in zip(
            nodes, shards, piece_shards, loads):
        if not shard and not pieces:
            continue
        key_args = (("-i", ssh_private_key) if ssh_private_key else ())
        hk = (("-o", f"StrictHostKeyChecking={host_key_checking}") +
              (("-o", "UserKnownHostsFile=/dev/null")
               if host_key_checking == "no" else ()))
        ssh_argv = ("ssh", "-T", "-x", *hk, *key_args,
                    "-p", str(port), f"{ssh_username}@{ip}")
        argv: tuple[str, ...] = ()
        if shard:
            if method == "scp":
                argv = ("scp", *hk,
                        "-P", str(port), *key_args, "-p", *shard,
                        f"{ssh_username}@{ip}:{dest_path}")
            else:
                ssh_cmd = " ".join((
                    "ssh", *hk,
                    *key_args, "-p", str(port)))
                argv = ("rsync", "-az", "-e", ssh_cmd, *shard,
                        f"{ssh_username}@{ip}:{dest_path}")
        out.append(TransferCommand(
            node_id=node_id, argv=argv, files=tuple(shard),
            total_bytes=load, pieces=tuple(pieces),
            ssh_argv=ssh_argv))
    return out


def _send_piece(ssh_argv: tuple[str, ...],
                piece: TransferPiece) -> int:
    """Stream one byte range to the node over `ssh 'cat > dst'`
    (reference _spawn_next_transfer stdin feed, data.py:787-798)."""
    proc = subprocess.Popen(
        [*ssh_argv, f'cat > "{piece.dst}"'], stdin=subprocess.PIPE)
    try:
        try:
            for buf in _file_chunks(piece.src, piece.begin, piece.end,
                                    chunk_size=1 << 20):
                proc.stdin.write(buf)
        finally:
            try:
                proc.stdin.close()
            except OSError:
                pass
    except BrokenPipeError:
        pass
    except OSError:
        # Local read failed (source truncated/removed mid-transfer):
        # the piece did NOT land whole — report failure and reap the
        # remote cat rather than leaving it half-fed.
        proc.kill()
        proc.wait()
        return 1
    return proc.wait()


def _join_pieces(ssh_argv: tuple[str, ...], final_dst: str) -> int:
    """Reassemble a split file on the (shared) destination filesystem
    (reference join, data.py:858-869): suffixed pieces glob-sort in
    order and append onto piece 0."""
    cmd = (f'cat "{final_dst}".{_SPLIT_PREFIX}* >> "{final_dst}" && '
           f'rm -f "{final_dst}".{_SPLIT_PREFIX}*')
    return subprocess.call([*ssh_argv, cmd])


def run_transfers(commands: list[TransferCommand],
                  max_parallel: int = 4) -> list[int]:
    """Execute planned transfers with bounded parallelism: whole-file
    scp/rsync batches first, then split pieces (each an ssh-cat with a
    ranged stdin feed), then one reassembly join per split file."""
    results: list[int] = []
    whole = [c for c in commands if c.argv]
    for batch in util.chunked(whole, max_parallel):
        procs = [util.subprocess_nowait(list(c.argv)) for c in batch]
        results.extend(util.subprocess_wait_all(procs))
    work = [(c, p) for c in commands for p in c.pieces]
    if not work:
        return results
    # Per-NODE parallelism (max_parallel is per node, matching the
    # reference's max_parallel_transfers_per_node): each node gets up
    # to max_parallel worker threads draining ITS piece list, so an
    # 8-node split drives all 8 NICs concurrently while total thread
    # count stays bounded by nodes x max_parallel.
    piece_rcs: list[int] = [1] * len(work)  # failure until proven sent
    by_node: dict[str, list[int]] = {}
    for k, (c, _p) in enumerate(work):
        by_node.setdefault(c.node_id, []).append(k)
    threads = []
    for node_id, indices in by_node.items():
        cursor = iter(indices)
        lock = threading.Lock()

        def _worker(cursor=cursor, lock=lock) -> None:
            while True:
                with lock:
                    k = next(cursor, None)
                if k is None:
                    return
                cmd, piece = work[k]
                try:
                    piece_rcs[k] = _send_piece(cmd.ssh_argv, piece)
                except Exception:
                    logger.exception("piece transfer failed: %s",
                                     piece.dst)
                    piece_rcs[k] = 1
        for _ in range(min(max_parallel, len(indices))):
            thread = threading.Thread(target=_worker, daemon=True)
            thread.start()
            threads.append(thread)
    for t in threads:
        t.join()
    results.extend(piece_rcs)
    # Reassemble each split file once, only if every piece landed.
    by_final: dict[str, list[int]] = {}
    joiner: dict[str, tuple[str, ...]] = {}
    for k, (c, p) in enumerate(work):
        by_final.setdefault(p.final_dst, []).append(piece_rcs[k])
        joiner[p.final_dst] = c.ssh_argv
    for final_dst, rcs in by_final.items():
        if any(rcs):
            logger.error("split pieces failed for %s; skipping join",
                         final_dst)
            results.append(1)
            continue
        results.append(_join_pieces(joiner[final_dst], final_dst))
    return results


# ---------------------- task-level input/output ------------------------

def stage_task_inputs(store: StateStore, input_data: list[dict],
                      task_dir: str) -> None:
    """Materialize input_data specs into the task dir before execution
    (process_input_data analog, data.py:219)."""
    for spec in input_data:
        kind = spec.get("kind", "statestore")
        if kind == "task_output":
            # Pull another task's uploaded outputs (the reference's
            # cargo/task_file_mover.py input_data:azure_batch path,
            # trivially storage-mediated here).
            key = names.task_output_key(
                spec["pool_id"], spec["job_id"], spec["task_id"],
                spec.get("filename", "outputs"))
            spec = {"kind": "statestore", "key": key,
                    "file_path": spec.get("file_path",
                                          spec["task_id"])}
            kind = "statestore"
        if kind == "statestore":
            key = spec["key"]
            rel = spec.get("file_path") or key.rsplit("/", 1)[-1]
            dest = os.path.join(task_dir, rel)
            os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
            try:
                meta_exists = store.object_exists(key)
                if not meta_exists:
                    raise NotFoundError(key)
            except NotFoundError:
                # Prefix fetch: key may name a directory-like prefix.
                base = key.rstrip("/")
                sub = _prefix_children(store, base)
                if not sub:
                    raise
                for skey in sub:
                    srel = skey[len(base):].lstrip("/")
                    spath = os.path.join(dest, srel)
                    os.makedirs(os.path.dirname(spath) or ".",
                                exist_ok=True)
                    with open(spath, "wb") as fh:
                        for chunk in store.get_object_stream(skey):
                            fh.write(chunk)
                continue
            with open(dest, "wb") as fh:
                for chunk in store.get_object_stream(key):
                    fh.write(chunk)
        elif kind == "local":
            continue  # already on the node filesystem
        else:
            raise ValueError(f"unknown input_data kind {kind!r}")


def collect_task_outputs(store: StateStore, output_data: list[dict],
                         task_dir: str, pool_id: str, job_id: str,
                         task_id: str,
                         exclude_rels: Optional[set[str]] = None) -> int:
    """Upload output_data globs after execution (process_output_data
    analog, data.py:447). exclude_rels: relative paths staged as
    inputs, which must not be re-uploaded as outputs. Returns count."""
    count = 0
    exclude_rels = exclude_rels or set()
    for spec in output_data:
        pattern = spec.get("include")
        prefix = spec.get("prefix") or names.task_output_key(
            pool_id, job_id, task_id, "outputs")
        for root, _dirs, files in os.walk(task_dir):
            for name in files:
                path = os.path.join(root, name)
                rel = os.path.relpath(path, task_dir)
                if rel in ("stdout.txt", "stderr.txt"):
                    continue
                if rel in exclude_rels:
                    continue
                # fnmatch has no '**' semantics: treat missing/match-all
                # patterns explicitly, else match rel then basename.
                if pattern not in (None, "*", "**/*") and not (
                        fnmatch.fnmatch(rel, pattern) or
                        fnmatch.fnmatch(name, pattern)):
                    continue
                store.put_object_stream(f"{prefix}/{rel}",
                                        _file_chunks(path))
                count += 1
    return count


def staged_input_rels(store: StateStore,
                      input_data: list[dict]) -> set[str]:
    """Relative paths that stage_task_inputs materializes, for output
    exclusion."""
    rels: set[str] = set()
    for spec in input_data:
        kind = spec.get("kind", "statestore")
        if kind == "task_output":
            key = names.task_output_key(
                spec["pool_id"], spec["job_id"], spec["task_id"],
                spec.get("filename", "outputs"))
            rel = spec.get("file_path", spec["task_id"])
        elif kind == "statestore":
            key = spec["key"]
            rel = spec.get("file_path") or key.rsplit("/", 1)[-1]
        else:
            continue
        if store.object_exists(key):
            rels.add(rel)
        else:
            base = key.rstrip("/")
            for skey in _prefix_children(store, base):
                srel = skey[len(base):].lstrip("/")
                rels.add(os.path.join(rel, srel) if srel else rel)
    return rels
