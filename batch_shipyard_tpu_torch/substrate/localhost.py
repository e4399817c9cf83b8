"""Localhost substrate: node agents as real subprocesses on this host.

The port's copy of batch_shipyard_tpu/substrate/localhost.py. This is
how the port drives the GPUs attached to the current machine through
the whole pool/jobs pipeline: each node is a ``python -m
batch_shipyard_tpu_torch.agent`` process, with the repo on PYTHONPATH
so tasks can run the port's workloads. A pool is 1 x N nodes
(``vm_configuration.vm_count``); every node sees every card of the host,
as the ranks of one host share it. It is also the multi-process
integration substrate for the localfs state store.
"""

from __future__ import annotations


import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

from batch_shipyard_tpu_torch.config.settings import (
    CredentialsSettings, PoolSettings)
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import StateStore
from batch_shipyard_tpu_torch.substrate import base
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)


class LocalhostSubstrate(base.ComputeSubstrate):
    def __init__(self, store: StateStore,
                 credentials: CredentialsSettings,
                 work_root: Optional[str] = None,
                 pool_config: Optional[dict] = None,
                 run_nodeprep: bool = False) -> None:
        if credentials.storage.backend == "memory":
            raise ValueError(
                "localhost substrate needs a cross-process state store "
                "(localfs or gcs), not memory")
        self.store = store
        self.credentials = credentials
        self.work_root = work_root or tempfile.mkdtemp(prefix="localnode-")
        self.pool_config = pool_config or {}
        self.run_nodeprep = run_nodeprep
        self._procs: dict[str, dict[str, subprocess.Popen]] = {}

    def _spawn_node(self, pool: PoolSettings, slice_index: int,
                    worker_index: int, node_index: int) -> None:
        node_id = f"{pool.id}-local-{node_index}"
        work_dir = os.path.join(self.work_root, pool.id, node_id)
        os.makedirs(work_dir, exist_ok=True)
        boot = {
            "storage": {
                "backend": self.credentials.storage.backend,
                "bucket": self.credentials.storage.bucket,
                "prefix": self.credentials.storage.prefix,
                "root": self.credentials.storage.root,
            },
            "pool_config": self.pool_config,
            "identity": {
                "pool_id": pool.id, "node_id": node_id,
                "node_index": node_index,
                "hostname": socket.gethostname(),
                "internal_ip": "127.0.0.1",
                "slice_index": slice_index,
                "worker_index": worker_index,
            },
            "work_dir": work_dir,
            "heartbeat_interval": 2.0,
            "poll_interval": 0.2,
            "node_stale_seconds": 10.0,
            "run_nodeprep": self.run_nodeprep,
            "output_upload_cap_bytes": (
                pool.output_upload_cap_mb * 1024 * 1024
                if pool.output_upload_cap_mb else None),
        }
        boot_path = os.path.join(work_dir, "bootstrap.json")
        with open(boot_path, "w", encoding="utf-8") as fh:
            json.dump(boot, fh)
        self.store.upsert_entity(
            names.TABLE_NODES, pool.id, node_id, {
                "state": "creating", "hostname": boot["identity"][
                    "hostname"],
                "internal_ip": "127.0.0.1", "node_index": node_index,
                "slice_index": slice_index, "worker_index": worker_index,
                "registered_at": time.time()})
        log = open(os.path.join(work_dir, "agent.log"), "ab")
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ)
        # Tasks run with cwd=task_dir; make the framework importable
        # there even when not pip-installed (dev/offline hosts).
        env["PYTHONPATH"] = repo_root + (
            os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "batch_shipyard_tpu_torch.agent",
             boot_path],
            stdout=log, stderr=log, cwd=repo_root, env=env)
        self._procs.setdefault(pool.id, {})[node_id] = proc
        logger.info("spawned local node agent %s (pid %d)", node_id,
                    proc.pid)

    def _pool_shape(self, pool: PoolSettings) -> tuple[int, int]:
        return 1, max(1, pool.vm_count_dedicated +
                      pool.vm_count_low_priority)

    def allocate_pool(self, pool: PoolSettings) -> None:
        num_slices, workers = self._pool_shape(pool)
        node_index = 0
        for s in range(num_slices):
            for w in range(workers):
                self._spawn_node(pool, s, w, node_index)
                node_index += 1

    def deallocate_pool(self, pool_id: str) -> None:
        procs = self._procs.pop(pool_id, {})
        for proc in procs.values():
            proc.terminate()
        for proc in procs.values():
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
        for row in list(self.store.query_entities(
                names.TABLE_NODES, partition_key=pool_id)):
            self.store.delete_entity(names.TABLE_NODES, pool_id, row["_rk"])

    def resize_pool(self, pool: PoolSettings, num_slices: int) -> None:
        raise NotImplementedError(
            "localhost pools are fixed-size; delete and re-add")

    def _stop_slice_nodes(self, pool_id: str,
                          slice_index: int) -> list[dict]:
        """Stop every agent of a slice and return its node rows.
        Agents spawned by THIS process are terminated directly; rows
        without a live in-process handle (fresh CLI attaching to an
        existing pool) get a shutdown control message instead — the
        agent subprocess exits on its next control poll."""
        procs = self._procs.get(pool_id, {})
        rows = [row for row in self.store.query_entities(
            names.TABLE_NODES, partition_key=pool_id)
            if int(row.get("slice_index", -1)) == slice_index]
        for row in rows:
            node_id = row["_rk"]
            proc = procs.pop(node_id, None)
            if proc is not None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
            else:
                # Distinct per-node control queue each iteration —
                # nothing to batch.
                self.store.put_message(  # shipyard-lint: disable=store-write-in-loop
                    names.control_queue(pool_id, node_id),
                    json.dumps({"type": "shutdown"}).encode())
                # Wait for the agent's final offline heartbeat so a
                # replacement spawned onto the same node_id cannot
                # race it for the shared control queue (it would eat
                # the shutdown meant for its predecessor).
                deadline = time.monotonic() + 15.0
                while time.monotonic() < deadline:
                    try:
                        cur = self.store.get_entity(
                            names.TABLE_NODES, pool_id, node_id)
                    except KeyError:
                        break
                    if cur.get("state") == "offline":
                        break
                    time.sleep(0.2)
        return rows

    def recreate_slice(self, pool: PoolSettings, slice_index: int) -> None:
        for row in self._stop_slice_nodes(pool.id, slice_index):
            self._spawn_node(pool, slice_index,
                             int(row.get("worker_index", 0)),
                             int(row.get("node_index", 0)))

    def deallocate_slice(self, pool: PoolSettings,
                         slice_index: int) -> None:
        for row in self._stop_slice_nodes(pool.id, slice_index):
            try:
                self.store.delete_entity(names.TABLE_NODES, pool.id,
                                         row["_rk"])
            except KeyError:
                pass

    def get_remote_login(self, pool_id: str,
                         node_id: str) -> Optional[tuple[str, int]]:
        return "127.0.0.1", 22
