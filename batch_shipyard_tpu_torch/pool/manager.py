"""Pool lifecycle: create, wait-ready with recovery, resize, delete.

Reference analog: convoy/batch.py pool ops — create_pool(:921),
wait_for_pool_ready(:861) and the _block_for_nodes_ready hot loop
(:625) that classifies resize errors, reboots start-task-failed nodes
(reboot_on_start_task_failed) and deletes+recreates unusable nodes
(attempt_recovery_on_unusable). The port's copy of
batch_shipyard_tpu/pool/manager.py: a GPU pool is one slice of nodes,
so node recovery goes through the substrate's slice operations on it.
"""

from __future__ import annotations

import json
import time
from typing import Optional

from batch_shipyard_tpu_torch.agent import cascade, perf
from batch_shipyard_tpu_torch.config.settings import (
    GlobalSettings, PoolSettings)
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import (
    NotFoundError, StateStore)
from batch_shipyard_tpu_torch.substrate.base import ComputeSubstrate, NodeInfo
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

READY_STATES = ("idle", "running")
FAILED_STATES = ("start_task_failed", "unusable")


class PoolExistsError(RuntimeError):
    pass


class PoolNotFoundError(RuntimeError):
    pass


class PoolAllocationError(RuntimeError):
    pass


def pool_exists(store: StateStore, pool_id: str) -> bool:
    try:
        store.get_entity(names.TABLE_POOLS, "pools", pool_id)
        return True
    except NotFoundError:
        return False


def get_pool(store: StateStore, pool_id: str) -> dict:
    try:
        return store.get_entity(names.TABLE_POOLS, "pools", pool_id)
    except NotFoundError:
        raise PoolNotFoundError(pool_id)


def list_pools(store: StateStore) -> list[dict]:
    return list(store.query_entities(names.TABLE_POOLS,
                                     partition_key="pools"))


def list_nodes(store: StateStore, pool_id: str) -> list[NodeInfo]:
    out = []
    for row in store.query_entities(names.TABLE_NODES,
                                    partition_key=pool_id):
        out.append(NodeInfo(
            node_id=row["_rk"], state=row.get("state", "unknown"),
            hostname=row.get("hostname", ""),
            internal_ip=row.get("internal_ip", ""),
            node_index=int(row.get("node_index", 0)),
            slice_index=int(row.get("slice_index", 0)),
            worker_index=int(row.get("worker_index", 0)),
            health=float(row.get(names.NODE_COL_HEALTH, 1.0) or 0.0),
            quarantined=bool(row.get(names.NODE_COL_QUARANTINED,
                                     False))))
    return sorted(out, key=lambda n: n.node_index)


def create_pool(store: StateStore, substrate: ComputeSubstrate,
                pool: PoolSettings, global_conf: GlobalSettings,
                pool_config_raw: Optional[dict] = None,
                wait: bool = True) -> list[NodeInfo]:
    """Provision a pool end-to-end (action_pool_add path,
    fleet.py:3390)."""
    if pool_exists(store, pool.id):
        raise PoolExistsError(f"pool {pool.id} exists")
    store.insert_entity(names.TABLE_POOLS, "pools", pool.id, {
        "state": "creating",
        "substrate": pool.substrate,
        "spec": pool_config_raw or {},
        "created_at": util.datetime_utcnow_iso(),
    })
    perf.emit(store, pool.id, "-", "pool", "create.start")
    # Image manifest for cascade before nodes boot.
    cascade.populate_global_resources(
        store, pool.id, list(global_conf.docker_images),
        list(global_conf.singularity_images),
        global_conf.concurrent_source_downloads,
        registries=list(
            getattr(global_conf, "docker_registries", ()) or ()))
    try:
        substrate.allocate_pool(pool)
    except Exception as exc:
        store.merge_entity(names.TABLE_POOLS, "pools", pool.id,
                           {"state": "allocation_failed",
                            "error": str(exc)})
        raise PoolAllocationError(str(exc)) from exc
    if not wait:
        return []
    nodes = wait_for_pool_ready(store, substrate, pool)
    store.merge_entity(names.TABLE_POOLS, "pools", pool.id,
                       {"state": "ready"})
    perf.emit(store, pool.id, "-", "pool", "create.end")
    return nodes


def wait_for_pool_ready(store: StateStore, substrate: ComputeSubstrate,
                        pool: PoolSettings,
                        poll_interval: float = 0.25) -> list[NodeInfo]:
    """_block_for_nodes_ready analog (batch.py:625): poll node states,
    apply recovery knobs, raise on timeout with diagnostics."""
    deadline = time.monotonic() + pool.max_wait_time_seconds
    expected = pool.current_node_count
    rebooted_slices: set[int] = set()
    recovered_slices: set[int] = set()
    while True:
        nodes = list_nodes(store, pool.id)
        ready = [n for n in nodes if n.state in READY_STATES]
        if len(ready) >= expected:
            return nodes
        for node in nodes:
            if node.state == "start_task_failed":
                if (pool.reboot_on_start_task_failed and
                        node.slice_index not in rebooted_slices):
                    logger.warning(
                        "node %s start task failed; recreating slice %d",
                        node.node_id, node.slice_index)
                    rebooted_slices.add(node.slice_index)
                    substrate.recreate_slice(pool, node.slice_index)
                elif not pool.reboot_on_start_task_failed:
                    raise PoolAllocationError(
                        f"node {node.node_id} start task failed "
                        f"(reboot_on_start_task_failed disabled); "
                        f"stdout/stderr under "
                        f"{names.node_log_key(pool.id, node.node_id, '')}")
            elif node.state == "unusable":
                if (pool.attempt_recovery_on_unusable and
                        node.slice_index not in recovered_slices):
                    logger.warning(
                        "node %s unusable; recreating slice %d",
                        node.node_id, node.slice_index)
                    recovered_slices.add(node.slice_index)
                    substrate.recreate_slice(pool, node.slice_index)
                elif not pool.attempt_recovery_on_unusable:
                    raise PoolAllocationError(
                        f"node {node.node_id} unusable "
                        f"(attempt_recovery_on_unusable disabled)")
        # Allocation errors recorded by the substrate: fatal ones
        # (quota/permission/config) can never succeed; 'other_zone'
        # retries (stockout) also fail fast because the zone is fixed
        # by credentials — waiting out the pool timeout cannot help,
        # the operator must pick another zone. Only 'backoff' errors
        # (transient service trouble) keep polling.
        entity = get_pool(store, pool.id)
        if entity.get("allocation_error_fatal") or \
                entity.get("allocation_error_retry") == "other_zone":
            raise PoolAllocationError(
                f"{entity['allocation_error']} "
                f"[kind={entity.get('allocation_error_kind')}, "
                f"retry={entity.get('allocation_error_retry')}]")
        if time.monotonic() > deadline:
            states = {n.node_id: n.state for n in nodes}
            raise PoolAllocationError(
                f"pool {pool.id} not ready after "
                f"{pool.max_wait_time_seconds}s: {states}")
        time.sleep(poll_interval)


def resize_pool(store: StateStore, substrate: ComputeSubstrate,
                pool: PoolSettings, num_slices: int,
                wait: bool = True) -> None:
    store.merge_entity(names.TABLE_POOLS, "pools", pool.id,
                       {"state": "resizing"})
    # A resize may rewrite the pool spec (shard autoscale rides the
    # same entity): drop this process's cached task-queue shard count
    # so submitters re-read it instead of routing on a stale fan-out
    # for a full TTL.
    from batch_shipyard_tpu_torch.jobs import manager as jobs_mgr
    jobs_mgr.invalidate_pool_queue_shards(store, pool.id)
    substrate.resize_pool(pool, num_slices)
    if wait:
        expected = num_slices
        deadline = time.monotonic() + pool.max_wait_time_seconds
        while True:
            ready = [n for n in list_nodes(store, pool.id)
                     if n.state in READY_STATES]
            if len(ready) >= expected:
                break
            if time.monotonic() > deadline:
                raise PoolAllocationError(
                    f"resize of {pool.id} timed out")
            time.sleep(0.25)
    store.merge_entity(names.TABLE_POOLS, "pools", pool.id,
                       {"state": "ready"})


def delete_pool(store: StateStore, substrate: ComputeSubstrate,
                pool_id: str) -> None:
    get_pool(store, pool_id)  # raises if missing
    substrate.deallocate_pool(pool_id)
    # Clear jobs/tasks state for the pool.
    for job in list(store.query_entities(names.TABLE_JOBS,
                                         partition_key=pool_id)):
        _purge_job(store, pool_id, job["_rk"])
    store.delete_entity(names.TABLE_POOLS, "pools", pool_id)


def _purge_job(store: StateStore, pool_id: str, job_id: str) -> None:
    pk = names.task_pk(pool_id, job_id)
    for task in list(store.query_entities(names.TABLE_TASKS,
                                          partition_key=pk)):
        store.delete_entity(names.TABLE_TASKS, pk, task["_rk"])
    for row in list(store.query_entities(names.TABLE_JOBPREP,
                                         partition_key=pk)):
        store.delete_entity(names.TABLE_JOBPREP, pk, row["_rk"])
    try:
        store.delete_entity(names.TABLE_JOBS, pool_id, job_id)
    except NotFoundError:
        pass


def pool_stats(store: StateStore, pool_id: str) -> dict:
    """pool stats analog (batch.py:1460)."""
    nodes = list_nodes(store, pool_id)
    by_state: dict[str, int] = {}
    for node in nodes:
        by_state[node.state] = by_state.get(node.state, 0) + 1
    jobs = list(store.query_entities(names.TABLE_JOBS,
                                     partition_key=pool_id))
    task_counts = {"pending": 0, "running": 0, "completed": 0,
                   "failed": 0, "blocked": 0, "assigned": 0,
                   names.TASK_STATE_QUARANTINED: 0}
    for job in jobs:
        pk = names.task_pk(pool_id, job["_rk"])
        for task in store.query_entities(names.TABLE_TASKS,
                                         partition_key=pk):
            state = task.get("state", "pending")
            task_counts[state] = task_counts.get(state, 0) + 1
    return {
        "pool_id": pool_id,
        "nodes": {"total": len(nodes), "by_state": by_state},
        "jobs": len(jobs),
        "tasks": task_counts,
    }


def send_control(store: StateStore, pool_id: str, node_id: str,
                 message: dict) -> None:
    store.put_message(names.control_queue(pool_id, node_id),
                      json.dumps(message).encode())


def _send_control_request(store: StateStore, pool_id: str,
                          node_id: str, message: dict,
                          timeout: float) -> str:
    """Enqueue a request/reply control verb and return its reply key.
    The message carries expires_at so a verb that outlives its caller
    is DROPPED by the agent instead of executing minutes later — a
    timed-out zap must not kill tasks after the operator moved on."""
    import uuid as uuid_mod
    reply_key = names.control_reply_key(pool_id, node_id,
                                        uuid_mod.uuid4().hex[:12])
    send_control(store, pool_id, node_id,
                 dict(message, reply_key=reply_key,
                      expires_at=time.time() + timeout))
    return reply_key


def _poll_reply(store: StateStore, reply_key: str) -> Optional[dict]:
    try:
        payload = store.get_object(reply_key)
    except NotFoundError:
        return None
    try:
        store.delete_object(reply_key)
    except NotFoundError:
        pass
    return json.loads(payload.decode())


def send_control_and_wait(store: StateStore, pool_id: str,
                          node_id: str, message: dict,
                          timeout: float = 30.0,
                          poll_interval: float = 0.1) -> dict:
    """Request/reply control verb: attach a reply key, enqueue, poll
    the object store for the agent's answer (nodes ps/zap/prune ride
    this — the agent answers over the state store, no ssh needed;
    reference equivalent is docker-ps-over-ssh, convoy/fleet.py:2468).
    Raises TimeoutError if the node never answers (offline node); the
    queued verb then expires unexecuted (see _send_control_request)."""
    reply_key = _send_control_request(store, pool_id, node_id,
                                      message, timeout)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        reply = _poll_reply(store, reply_key)
        if reply is not None:
            return reply
        time.sleep(poll_interval)
    raise TimeoutError(
        f"node {node_id} did not answer {message.get('type')} "
        f"within {timeout:.0f}s (offline?)")


def get_node(store: StateStore, pool_id: str, node_id: str) -> NodeInfo:
    for node in list_nodes(store, pool_id):
        if node.node_id == node_id:
            return node
    raise PoolNotFoundError(f"node {node_id} not found in {pool_id}")


def node_counts(store: StateStore, pool_id: str) -> dict:
    """Node-state histogram (pool nodes count analog, reference
    shipyard.py:1868 / convoy/fleet.py node state counts)."""
    counts: dict = {}
    nodes = list_nodes(store, pool_id)
    for node in nodes:
        counts[node.state] = counts.get(node.state, 0) + 1
    return {"pool_id": pool_id, "total": len(nodes),
            "by_state": dict(sorted(counts.items()))}


def remote_login_settings(store: StateStore,
                          substrate: ComputeSubstrate,
                          pool_id: str,
                          node_id: Optional[str] = None) -> list[dict]:
    """(node, ip, port) for every node — or one — in the pool
    (pool nodes grls analog, reference convoy/batch.py:3074
    get_remote_login_settings)."""
    nodes = list_nodes(store, pool_id)
    if node_id is not None:
        nodes = [n for n in nodes if n.node_id == node_id]
        if not nodes:
            raise PoolNotFoundError(
                f"node {node_id} not found in {pool_id}")
    out = []
    for node in nodes:
        login = substrate.get_remote_login(pool_id, node.node_id)
        out.append({
            "node_id": node.node_id, "state": node.state,
            "ip": login[0] if login else None,
            "port": login[1] if login else None,
        })
    return out


def reboot_node(store: StateStore, substrate: ComputeSubstrate,
                pool: PoolSettings, node_id: str) -> int:
    """Reboot a node (pool nodes reboot analog, reference
    shipyard.py:1882). TPU recovery granularity is the pod slice —
    all workers of the node's slice are recreated together (a lone
    worker VM cannot rejoin an ICI mesh). Returns the slice index."""
    node = get_node(store, pool.id, node_id)
    logger.info("rebooting node %s => recreating slice %d",
                node_id, node.slice_index)
    substrate.recreate_slice(pool, node.slice_index)
    return node.slice_index


def delete_node(store: StateStore, substrate: ComputeSubstrate,
                pool: PoolSettings, node_id: str) -> int:
    """Remove a node from the pool (pool nodes del analog, reference
    shipyard.py:1795). Slice-granular like reboot: the node's whole
    slice is deallocated and NOT replaced — the pool shrinks by one
    slice (use pool resize to grow back). Returns the slice index."""
    node = get_node(store, pool.id, node_id)
    logger.info("deleting node %s => deallocating slice %d",
                node_id, node.slice_index)
    substrate.deallocate_slice(pool, node.slice_index)
    return node.slice_index


def _control_fanout(store: StateStore, pool_id: str, message: dict,
                    node_id: Optional[str] = None,
                    timeout: float = 30.0,
                    poll_interval: float = 0.1) -> list[dict]:
    """Fan a request/reply verb to node(s): non-ready nodes are
    reported immediately instead of waited on, all requests are
    enqueued up front, and the replies poll under ONE shared deadline
    — wall clock is O(timeout), not O(nodes x timeout)."""
    nodes = list_nodes(store, pool_id)
    if node_id is not None:
        nodes = [n for n in nodes if n.node_id == node_id]
        if not nodes:
            raise PoolNotFoundError(
                f"node {node_id} not found in {pool_id}")
    replies: dict[str, dict] = {}
    pending: dict[str, str] = {}
    for node in nodes:
        if node.state not in READY_STATES:
            replies[node.node_id] = {
                "node_id": node.node_id,
                "error": f"node not ready (state={node.state})"}
            continue
        pending[node.node_id] = _send_control_request(
            store, pool_id, node.node_id, dict(message), timeout)
    deadline = time.monotonic() + timeout
    while pending and time.monotonic() < deadline:
        for nid, reply_key in list(pending.items()):
            reply = _poll_reply(store, reply_key)
            if reply is not None:
                replies[nid] = reply
                del pending[nid]
        if pending:
            time.sleep(poll_interval)
    for nid in pending:
        replies[nid] = {
            "node_id": nid,
            "error": (f"node {nid} did not answer "
                      f"{message.get('type')} within {timeout:.0f}s "
                      f"(offline?)")}
    return [replies[n.node_id] for n in nodes]


def nodes_ps(store: StateStore, pool_id: str,
             node_id: Optional[str] = None,
             timeout: float = 30.0) -> list[dict]:
    """Running tasks/containers per node (pool nodes ps analog)."""
    return _control_fanout(store, pool_id, {"type": "ps"},
                           node_id, timeout)


def nodes_zap(store: StateStore, pool_id: str,
              node_id: Optional[str] = None,
              timeout: float = 30.0) -> list[dict]:
    """Kill all live task processes/containers per node (pool nodes
    zap analog, reference shipyard.py:1906)."""
    return _control_fanout(store, pool_id, {"type": "zap"},
                           node_id, timeout)


def nodes_prune(store: StateStore, pool_id: str,
                node_id: Optional[str] = None,
                timeout: float = 30.0) -> list[dict]:
    """Prune unreferenced image cache entries per node (pool nodes
    prune analog, reference shipyard.py:1919)."""
    return _control_fanout(store, pool_id, {"type": "prune"},
                           node_id, timeout)
