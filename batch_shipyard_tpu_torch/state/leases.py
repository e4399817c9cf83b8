"""Lease-based leadership with monotonic fencing epochs.

The port's copy of batch_shipyard_tpu/state/leases.py.

Every leader-gated loop in the fleet (the gang janitor, the preempt
sweep, the federation's elastic evaluator) used to elect itself by
heartbeat freshness — "lowest-indexed node with a fresh heartbeat" —
which has an unavoidable double-leader window: a leader whose
heartbeats stall (partitioned from the nodes table, or just slow)
keeps sweeping while its successor elects itself, and both fire the
same cross-node decisions until the old leader's next table read.
An earlier version shipped that window with an "idempotent, so harmless" comment
on the janitor; the preempt sweep's stamps are NOT idempotent across
two leaders (two victims can be elected for one starved task), so the
window was a real badput source under exactly the partition shapes
the chaos drills inject.

This module replaces the election with the store primitives that were
already in ``state/base.py`` and implemented by all three backends
but never used: a named lease per leader role, plus a **fencing
epoch**. The epoch is the generation of a per-lease epoch object,
bumped once per leadership *term* (a fresh acquisition). Because
object generations are monotonic in every backend, epochs order
terms totally: a deposed leader's in-flight write stamped with epoch
E can always be distinguished from (and lose to) the successor's
writes stamped E' > E.

Authority rule (the part that closes the window): a holder only acts
while its lease is locally unexpired — renewal happens through the
store, so a leader partitioned from the store CANNOT extend its term;
when ``expires_at`` (minus a safety margin) passes, it abdicates on
its own clock, strictly before the store would grant the lease to a
successor. No overlap, no double leader.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional

from batch_shipyard_tpu_torch.state.base import (
    LeaseHandle, LeaseLostError, StateStore)
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

# Leader roles of the node agent's leader-gated sweeps (the epoch
# objects heimdall exports as shipyard_leader_epoch{lease=...}).
ROLE_GANG_JANITOR = "gang-janitor"
ROLE_PREEMPT_SWEEP = "preempt-sweep"
ROLE_FED_ELASTIC = "fed-elastic"
# Server-side task-factory expander (jobs/expansion.py): exactly one
# agent per pool materializes submitted generator specs into task
# rows + queue messages, fenced per chunk like any other sweep.
ROLE_EXPANDER = "task-expander"
AGENT_LEADER_ROLES = (ROLE_GANG_JANITOR, ROLE_PREEMPT_SWEEP,
                      ROLE_EXPANDER)


class LeaderLease:
    """One named leadership lease + its fencing epoch.

    ``epoch()`` is the single gate: it returns the current term's
    epoch while this owner holds the lease (acquiring a free lease,
    renewing a held one when it nears half-life), or None. Callers
    re-check ``fenced(epoch)`` — a pure local-clock check, no store
    round trip — immediately before every write they fence, so a
    verdict cached at the top of a long scan can never authorize a
    stamp after the term ended.

    ``blocked`` is the partition seam (chaos ``leader_partition``):
    while it returns True no lease traffic reaches the store, exactly
    as if the leader were partitioned from it — authority then decays
    on the local clock alone.
    """

    def __init__(self, store: StateStore, key: str, epoch_key: str,
                 owner: str, duration_seconds: float = 20.0,
                 blocked: Optional[Callable[[], bool]] = None,
                 safety_margin: Optional[float] = None) -> None:
        self._store = store
        self.key = key
        self.epoch_key = epoch_key
        self.owner = owner
        self.duration_seconds = duration_seconds
        self._blocked = blocked or (lambda: False)
        # Abdicate this far BEFORE the store-side expiry: covers the
        # TYPICAL write latency of an in-flight fenced stamp plus
        # modest clock skew, so local authority always ends strictly
        # first. It cannot bound a write whose own retries outlive it
        # — non-idempotent sweep writes therefore re-check fenced()
        # AFTER landing and retract their own late stamps (the
        # agent's preempt sweep).
        self._margin = (safety_margin if safety_margin is not None
                        else min(1.0, duration_seconds * 0.2))
        self._handle: Optional[LeaseHandle] = None
        self._epoch: Optional[int] = None
        # Local authority horizon, OUR monotonic clock: stamped at
        # each successful acquire/renew as issue_time + duration -
        # margin. Deliberately independent of the handle's
        # expires_at: backends disagree on its clock (epoch vs
        # monotonic), and deriving authority from when WE issued the
        # call is strictly conservative — the store granted at least
        # that long.
        self._authority_until = 0.0

    # ----------------------------- authority ---------------------------

    def _locally_valid(self, now: Optional[float] = None) -> bool:
        now = time.monotonic() if now is None else now
        return self._handle is not None and self._authority_until > now

    def held_locally(self) -> bool:
        """Current authority by the local clock alone (no store op)."""
        return self._locally_valid()

    def fenced(self, epoch: Optional[int]) -> bool:
        """True iff this owner still holds the SAME term ``epoch``
        right now — the pre-write fencing check. Pure local: a
        partitioned leader fails it as soon as its lease half-life
        margin lapses, never later than the store-side expiry."""
        return (epoch is not None and self._epoch == epoch
                and self._locally_valid())

    def epoch(self, acquire: bool = True) -> Optional[int]:
        """Acquire-or-renew; returns the term's fencing epoch while
        held, None while another owner leads (or the store is
        unreachable and local authority lapsed). ``acquire=False``
        restricts the call to renewal: a lost lease stays lost until
        a caller that is ALLOWED to start a new term asks."""
        now = time.monotonic()
        if self._blocked():
            # Partitioned from the store: renewal is impossible, so
            # authority ends at the local expiry margin — the window
            # in which the old election double-fired.
            if self._locally_valid(now):
                return self._epoch
            self._handle = None
            return None
        if self._handle is not None:
            remaining = self._authority_until - now
            if remaining < self.duration_seconds * 0.5:
                issued = time.monotonic()
                try:
                    self._handle = self._store.renew_lease(
                        self._handle, self.duration_seconds)
                    self._authority_until = (
                        issued + self.duration_seconds
                        - self._margin)
                except LeaseLostError:
                    self._handle = None
                    self._epoch = None
                except Exception:  # noqa: BLE001 - store hiccup
                    # Could not renew; keep the handle — authority
                    # still decays on the local clock, never extends.
                    logger.debug("lease renew failed for %s",
                                 self.key, exc_info=True)
            if self._locally_valid():
                return self._epoch
            self._handle = None
        if self._handle is None:
            if not acquire:
                return None
            issued = time.monotonic()
            try:
                handle = self._store.acquire_lease(
                    self.key, self.duration_seconds, self.owner)
            except Exception:  # noqa: BLE001 - store hiccup = not us
                logger.debug("lease acquire failed for %s", self.key,
                             exc_info=True)
                return None
            if handle is None:
                return None
            # Fresh term: bump the fencing epoch. The epoch object's
            # generation is the epoch — monotonic in every backend —
            # and its body names the owner for observers (heimdall's
            # shipyard_leader_epoch export, the partition drill).
            try:
                epoch = self._store.put_object(
                    self.epoch_key,
                    json.dumps({
                        "owner": self.owner,
                        "lease": self.key,
                        "acquired_at": util.datetime_utcnow_iso(),
                    }).encode("utf-8"))
            except Exception:  # noqa: BLE001 - no epoch, no term
                # A leader that cannot record its fencing epoch must
                # not act: release and retry next tick.
                logger.warning("epoch bump failed for %s; abdicating",
                               self.key, exc_info=True)
                try:
                    self._store.release_lease(handle)
                except Exception:  # noqa: BLE001 - best effort
                    pass
                return None
            self._handle = handle
            self._epoch = epoch
            self._authority_until = (issued + self.duration_seconds
                                     - self._margin)
            logger.info("lease %s acquired by %s (epoch %d)",
                        self.key, self.owner, epoch)
        return self._epoch if self._locally_valid() else None

    def maintain(self) -> None:
        """Renew-only heartbeat tick: keeps a HELD lease alive between
        sweep intervals without ever acquiring (acquisition belongs to
        the gated loop itself, so a node that never sweeps never
        leads). ``acquire=False`` matters: a renew that comes back
        LeaseLostError must NOT roll straight into a fresh term here —
        at heartbeat cadence the incumbent would beat every
        competitor's sweep-cadence acquisition forever."""
        if self._handle is None or self._blocked():
            return
        self.epoch(acquire=False)

    def release(self) -> None:
        """Graceful abdication (agent shutdown): the successor can
        acquire immediately instead of waiting out the expiry."""
        handle, self._handle, self._epoch = self._handle, None, None
        if handle is None:
            return
        try:
            self._store.release_lease(handle)
        except Exception:  # noqa: BLE001 - expiry reclaims anyway
            logger.debug("lease release failed for %s", self.key,
                         exc_info=True)


def read_leader(store: StateStore, epoch_key: str) -> Optional[dict]:
    """Observer-side view of a lease's current term: the epoch
    object's body plus its generation (the epoch). None when no term
    was ever recorded."""
    try:
        meta = store.get_object_meta(epoch_key)
        body = json.loads(store.get_object(epoch_key).decode("utf-8"))
    except Exception:  # noqa: BLE001 - includes NotFoundError
        return None
    body["epoch"] = meta.generation
    return body
