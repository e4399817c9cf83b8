"""FakePod substrate: in-process pool simulator for tests.

The port's copy of batch_shipyard_tpu/substrate/fakepod.py. A GPU pool
is one flat set of nodes (slice 0, workers 0..N-1), the reference's
shape of a pool without a ``tpu:`` block.

Every node of every slice is a thread running the REAL NodeAgent against
the shared state store; 'runtime: none' tasks execute as real
subprocesses, so pool/job/task lifecycle, gang rendezvous, retries, and
recovery paths are exercised end-to-end in unit tests — the test
substrate SURVEY.md section 4 says the reference lacks and we must add.

Failure injection (for the recovery tests the reference does with live
Azure): FakePodSubstrate.inject maps node ids to failure modes:
  'nodeprep_fail_once'  -> start task fails on first boot, succeeds on
                           reboot (tests reboot_on_start_task_failed)
  'nodeprep_fail'       -> start task always fails
  'unusable'            -> node comes up unusable (tests
                           attempt_recovery_on_unusable)
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Optional

from batch_shipyard_tpu_torch.agent.node_agent import NodeAgent, NodeIdentity
from batch_shipyard_tpu_torch.config.settings import PoolSettings
from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import StateStore
from batch_shipyard_tpu_torch.substrate import base
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)


class FakePodSubstrate(base.ComputeSubstrate):
    def __init__(self, store: StateStore, work_root: Optional[str] = None,
                 nodeprep_delay: float = 0.0,
                 heartbeat_interval: float = 0.5,
                 node_stale_seconds: float = 30.0) -> None:
        self.store = store
        self.work_root = work_root or tempfile.mkdtemp(prefix="fakepod-")
        self.nodeprep_delay = nodeprep_delay
        self.heartbeat_interval = heartbeat_interval
        self.node_stale_seconds = node_stale_seconds
        # node_id -> failure mode
        self.inject: dict[str, str] = {}
        # Extra NodeAgent kwargs (scratch mount/export runners,
        # force_remote_scratch, ...) for fault-injection tests.
        self.agent_kwargs: dict = {}
        self._agents: dict[str, dict[str, NodeAgent]] = {}
        self._boot_threads: dict[str, threading.Thread] = {}
        self._boot_counts: dict[str, int] = {}
        self._lock = threading.Lock()

    # --------------------------- internals -----------------------------

    @staticmethod
    def node_id(pool_id: str, slice_index: int, worker_index: int) -> str:
        return f"{pool_id}-s{slice_index}-w{worker_index}"

    def _nodeprep(self, agent: NodeAgent) -> None:
        node_id = agent.identity.node_id
        with self._lock:
            self._boot_counts[node_id] = self._boot_counts.get(
                node_id, 0) + 1
            boots = self._boot_counts[node_id]
        if self.nodeprep_delay:
            import time
            time.sleep(self.nodeprep_delay)
        mode = self.inject.get(node_id)
        if mode == "nodeprep_fail":
            raise RuntimeError("injected nodeprep failure")
        if mode == "nodeprep_fail_once" and boots == 1:
            raise RuntimeError("injected one-shot nodeprep failure")
        if mode == "unusable":
            # Mimic a node that finishes start task but is broken.
            from batch_shipyard_tpu_torch.agent.node_agent import (
                NodeUnusableError)
            raise NodeUnusableError("injected unusable")

    def _spawn_agent(self, pool: PoolSettings, slice_index: int,
                     worker_index: int, node_index: int) -> None:
        node_id = self.node_id(pool.id, slice_index, worker_index)
        identity = NodeIdentity(
            pool_id=pool.id, node_id=node_id, node_index=node_index,
            hostname=node_id,
            internal_ip=f"10.{slice_index}.{worker_index // 256}."
                        f"{worker_index % 256 + 1}",
            slice_index=slice_index, worker_index=worker_index)
        kwargs = {
            "heartbeat_interval": self.heartbeat_interval,
            "poll_interval": 0.05, "gang_timeout": 60.0,
            "job_state_ttl": 0.2,
            "node_stale_seconds": self.node_stale_seconds,
            "nodeprep": self._nodeprep, "substrate": self,
        }
        # agent_kwargs may override ANY default (tests shrink
        # gang_timeout/claim_visibility; drills tighten backoff).
        kwargs.update(self.agent_kwargs)
        agent = NodeAgent(
            self.store, identity, pool,
            work_dir=os.path.join(self.work_root, pool.id, node_id),
            **kwargs)
        import time as time_mod
        self.store.upsert_entity(
            names.TABLE_NODES, pool.id, node_id, {
                "state": "creating", "hostname": identity.hostname,
                "internal_ip": identity.internal_ip,
                "node_index": node_index, "slice_index": slice_index,
                "worker_index": worker_index,
                # Registration grace anchor: _node_alive treats a
                # never-heartbeated node as alive while this is fresh
                # (the gang-observer startup race fix).
                "registered_at": time_mod.time()})
        thread = threading.Thread(
            target=self._boot_agent, args=(agent,),
            name=f"fakepod-boot-{node_id}", daemon=True)
        # Agent + boot thread register atomically so teardown always
        # sees (and joins) the boot thread of any agent it stops.
        with self._lock:
            self._agents.setdefault(pool.id, {})[node_id] = agent
            self._boot_threads[node_id] = thread
        thread.start()

    def _boot_agent(self, agent: NodeAgent) -> None:
        try:
            agent.start()
        except Exception:
            logger.exception("fake node crashed during boot")

    def _pool_shape(self, pool: PoolSettings) -> tuple[int, int]:
        """(num_slices, workers_per_slice): one slice of every node."""
        return 1, pool.vm_count_dedicated + pool.vm_count_low_priority

    # --------------------------- interface -----------------------------

    def allocate_pool(self, pool: PoolSettings) -> None:
        num_slices, workers = self._pool_shape(pool)
        node_index = 0
        for s in range(num_slices):
            for w in range(workers):
                self._spawn_agent(pool, s, w, node_index)
                node_index += 1

    def deallocate_pool(self, pool_id: str) -> None:
        with self._lock:
            agents = self._agents.pop(pool_id, {})
        for agent in agents.values():
            agent.stop()
        for agent in agents.values():
            with self._lock:
                boot = self._boot_threads.pop(
                    agent.identity.node_id, None)
            if boot is not None:
                boot.join(timeout=10.0)
            agent.join(timeout=5.0)
        for row in list(self.store.query_entities(
                names.TABLE_NODES, partition_key=pool_id)):
            self.store.delete_entity(names.TABLE_NODES, pool_id, row["_rk"])

    def resize_pool(self, pool: PoolSettings, num_slices: int) -> None:
        """``num_slices`` is a node count: a GPU pool's nodes are its
        slices' workers (the reference's non-TPU pools)."""
        self._resize_nodes(pool, num_slices)

    def _resize_nodes(self, pool: PoolSettings, num_nodes: int) -> None:
        rows = sorted(self.store.query_entities(
            names.TABLE_NODES, partition_key=pool.id),
            key=lambda r: int(r.get("node_index", 0)))
        have = len(rows)
        if num_nodes > have:
            for idx in range(have, num_nodes):
                self._spawn_agent(pool, 0, idx, idx)
        elif num_nodes < have:
            for row in rows[num_nodes:]:
                node_id = row["_rk"]
                with self._lock:
                    agent = self._agents.get(pool.id, {}).pop(
                        node_id, None)
                    boot = self._boot_threads.pop(node_id, None)
                if agent is not None:
                    agent.stop()
                    if boot is not None:
                        boot.join(timeout=10.0)
                    agent.join(timeout=5.0)
                self.store.delete_entity(
                    names.TABLE_NODES, pool.id, node_id)

    def _teardown_slice(self, pool_id: str, slice_index: int) -> None:
        with self._lock:
            agents = self._agents.get(pool_id, {})
            victims = [a for a in agents.values()
                       if a.identity.slice_index == slice_index]
        for agent in victims:
            agent.stop()
        for agent in victims:
            node_id = agent.identity.node_id
            # Join the boot thread first: an agent still inside
            # start() has not registered its worker/heartbeat threads
            # yet, and a late state write from it would clobber the
            # replacement agent's row.
            with self._lock:
                boot = self._boot_threads.pop(node_id, None)
            if boot is not None:
                boot.join(timeout=10.0)
            agent.join(timeout=5.0)
            with self._lock:
                agents.pop(node_id, None)
            self.store.delete_entity(names.TABLE_NODES, pool_id,
                                     node_id)
        # Rows may exist without an in-process agent (fresh CLI
        # process attaching to an existing fake pool): the slice's
        # node entities must go regardless, like a real substrate's
        # teardown would take the machines' registrations with it.
        for row in list(self.store.query_entities(
                names.TABLE_NODES, partition_key=pool_id)):
            if int(row.get("slice_index", -1)) == slice_index:
                try:
                    self.store.delete_entity(names.TABLE_NODES,
                                             pool_id, row["_rk"])
                except Exception:  # noqa: BLE001 - already gone
                    pass

    def recreate_slice(self, pool: PoolSettings, slice_index: int) -> None:
        self._teardown_slice(pool.id, slice_index)
        _, workers = self._pool_shape(pool)
        for w in range(workers):
            self._spawn_agent(pool, slice_index, w,
                              slice_index * workers + w)

    def deallocate_slice(self, pool: PoolSettings,
                         slice_index: int) -> None:
        self._teardown_slice(pool.id, slice_index)

    def suspend_pool(self, pool: PoolSettings) -> None:
        """Stop agents but keep node entities (marked suspended)."""
        with self._lock:
            agents = list(self._agents.get(pool.id, {}).values())
        for agent in agents:
            agent.stop()
        for agent in agents:
            node_id = agent.identity.node_id
            with self._lock:
                boot = self._boot_threads.pop(node_id, None)
            if boot is not None:
                boot.join(timeout=10.0)
            agent.join(timeout=5.0)
            with self._lock:
                self._agents.get(pool.id, {}).pop(node_id, None)
            try:
                self.store.merge_entity(names.TABLE_NODES, pool.id,
                                        node_id, {"state": "suspended"})
            except Exception:
                pass

    def start_pool(self, pool: PoolSettings) -> None:
        """Respawn agents for suspended node entities."""
        for row in list(self.store.query_entities(
                names.TABLE_NODES, partition_key=pool.id)):
            self._spawn_agent(pool, int(row.get("slice_index", 0)),
                              int(row.get("worker_index", 0)),
                              int(row.get("node_index", 0)))

    def ensure_attached(self, pool: PoolSettings) -> None:
        """Revive simulated agents for node entities that have no live
        in-process agent (fresh CLI process attaching to a fake pool)."""
        rows = list(self.store.query_entities(
            names.TABLE_NODES, partition_key=pool.id))
        with self._lock:
            live = set(self._agents.get(pool.id, {}))
        for row in rows:
            if row["_rk"] in live:
                continue
            self._spawn_agent(pool, int(row.get("slice_index", 0)),
                              int(row.get("worker_index", 0)),
                              int(row.get("node_index", 0)))

    def get_remote_login(self, pool_id: str,
                         node_id: str) -> Optional[tuple[str, int]]:
        try:
            row = self.store.get_entity(names.TABLE_NODES, pool_id, node_id)
        except KeyError:
            return None
        return row["internal_ip"], 22

    # ------------------------- test helpers ----------------------------

    def agent(self, pool_id: str, node_id: str) -> Optional[NodeAgent]:
        with self._lock:
            return self._agents.get(pool_id, {}).get(node_id)

    def crash_node(self, pool_id: str, node_id: str) -> Optional[dict]:
        """Hard-kill one node's agent (stop without cleanup — a real
        crash writes no 'offline' state). Returns the revival context
        for revive_node, or None when the node has no live agent."""
        with self._lock:
            agent = self._agents.get(pool_id, {}).get(node_id)
        if agent is None:
            return None
        context = {"identity": agent.identity, "pool": agent.pool,
                   "work_dir": agent.work_dir}
        agent.stop_event.set()
        agent.join(timeout=5.0)
        with self._lock:
            self._agents.get(pool_id, {}).pop(node_id, None)
            self._boot_threads.pop(node_id, None)
        return context

    def crash_agent_hard(self, pool_id: str,
                         node_id: str) -> Optional[dict]:
        """Simulate the agent PROCESS dying while its tasks live on
        (the crash-restart adoption shape): threads cannot be killed
        in-process, so the agent is marked abandoned — every
        in-flight completion path cuts off before its first
        post-exit store write, heartbeats stop (no offline write, no
        graceful lease release), and the task subprocesses — their
        own sessions, exactly like a real agent crash — keep
        running. Revive with revive_node on the SAME work_dir; the
        restarted agent re-adopts from the slot ledgers."""
        with self._lock:
            agent = self._agents.get(pool_id, {}).get(node_id)
        if agent is None:
            return None
        context = {"identity": agent.identity, "pool": agent.pool,
                   "work_dir": agent.work_dir}
        agent._abandoned = True
        agent.heartbeat_blackout_until = float("inf")
        agent.lease_blackout_until = float("inf")
        agent.stop_event.set()
        with self._lock:
            self._agents.get(pool_id, {}).pop(node_id, None)
            self._boot_threads.pop(node_id, None)
        return context

    def revive_node(self, pool_id: str, context: dict) -> None:
        """Reboot a crashed node with the same identity."""
        kwargs = {
            "heartbeat_interval": self.heartbeat_interval,
            "poll_interval": 0.05, "gang_timeout": 60.0,
            "job_state_ttl": 0.2, "node_stale_seconds": 3.0,
            "nodeprep": None, "substrate": self,
        }
        kwargs.update(self.agent_kwargs)
        revived = NodeAgent(
            self.store, context["identity"], context["pool"],
            work_dir=context["work_dir"], **kwargs)
        thread = threading.Thread(
            target=self._boot_agent, args=(revived,), daemon=True)
        with self._lock:
            self._agents.setdefault(pool_id, {})[
                context["identity"].node_id] = revived
            self._boot_threads[context["identity"].node_id] = thread
        thread.start()

    def start_chaos(self, pool_id: str, kill_interval: float = 1.0,
                    revive_after: float = 0.5,
                    seed: int = 0) -> threading.Event:
        """Fault injection: periodically hard-kill a random node's
        agent (stop without cleanup — simulating a crash) and revive
        it shortly after. Returns a stop event. Exercises orphan
        reclaim, message redelivery, and heartbeat staleness under
        continuous failure (the fault-injection capability SURVEY.md
        5.3 notes the reference lacks entirely). For a DETERMINISTIC
        schedule of these (plus wedges, mid-run kills, store faults,
        heartbeat blackouts) use chaos.ChaosPlan + chaos.drill."""
        import random
        stop = threading.Event()
        rng = random.Random(seed)

        def _chaos_loop():
            while not stop.wait(kill_interval):
                with self._lock:
                    agents = list(self._agents.get(pool_id, {}))
                if not agents:
                    continue
                context = self.crash_node(pool_id, rng.choice(agents))
                if context is None:
                    continue
                if stop.wait(revive_after):
                    return
                self.revive_node(pool_id, context)

        thread = threading.Thread(target=_chaos_loop, daemon=True,
                                  name=f"chaos-{pool_id}")
        thread.start()
        return stop

    def stop_all(self) -> None:
        with self._lock:
            pools = list(self._agents)
        for pool_id in pools:
            with self._lock:
                agents = list(self._agents.get(pool_id, {}).values())
            for agent in agents:
                agent.stop()
            for agent in agents:
                agent.join(timeout=5.0)
