"""Store-outage ride-through: bounded retry and a local write-ahead
journal.

The port's copy of batch_shipyard_tpu/state/resilient.py: the same lanes,
journal format and replay, so a journal one package's agent left behind
replays under the other's. Every agent process wraps its store in it
(agent/__main__.py); in-process agents opt in through
``NodeAgent(resilience=...)``. Every store op falls in one of two lanes:

  * **critical** — claims, state transitions, queue traffic, object
    IO: correctness depends on them, so they block and retry with
    jittered exponential backoff until the store answers (or a
    configured outage ceiling passes). A running task never dies
    because the control plane blinked.

  * **advisory** — goodput events, trace spans, node heartbeat /
    health publishes: observers, not participants. During an outage
    they append to a per-node local write-ahead journal (JSONL,
    fsynced appends, atomic rewrites) and are replayed IN ORDER on
    recovery — so a multi-minute outage loses no accounting interval,
    and the goodput partition stays exact across it.

The first transport failure latches an **outage**; while latched,
advisory ops go straight to the journal (no per-op timeout tax) and
one advisory op per ``probe_interval`` probes the store live. The
first success — probe or critical retry — replays the journal,
closes the latch, and prices the outage window as one
``store_outage`` goodput event with the exact [first-failure,
first-success] interval.

Replay is idempotent: entries carry the caller-minted row keys, so a
crash mid-replay re-inserts into ``EntityExistsError`` (treated as
success) instead of double-counting. The journal file survives agent
restarts; a restarted agent drains its predecessor's backlog before
anything else is lost. A drained journal's file is removed.

Transport vs semantic failures: the store's own contract errors
(NotFoundError, EtagMismatchError, EntityExistsError,
PreconditionFailedError, LeaseLostError) are SUCCESSFUL round trips
and propagate untouched — retrying them would corrupt optimistic-
concurrency protocols. Lease ops are deliberately NOT wrapped at
all: a leader partitioned from the store must fail its renewal and
abdicate honestly (state/leases.py), not have this wrapper pretend
the lease extended.

**Group commit**: inside a ``group_commit()`` block — or always, when
constructed with ``group_commit_rows > 0`` — the two batch write ops
(``insert_entities`` / ``put_messages``) buffer into an ordered
in-memory journal instead of hitting the backend per call. Adjacent
calls against the same (op, target) coalesce into ONE backend round
trip; the buffer flushes when it reaches the row cap, when the oldest
buffered write exceeds the flush interval, when ANY other managed op
runs (flush-on-read: a reader can never observe the store ahead of
writes this wrapper already accepted), and on block exit. Semantic
errors (EntityExistsError et al) surface from the flushing call;
per-key ordering holds because entries never reorder and only
coalesce into the journal tail. A transport fault mid-batch switches
that entry to per-row idempotent repair — re-insert every row,
treating EntityExistsError as an already-applied success — so a
faulted batch is always driven to fully-applied, never left torn.
Queue batches retry whole (duplicates are the queue contract's
at-least-once, which agents already tolerate).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import zlib
from typing import Any, Optional

from batch_shipyard_tpu_torch.state import names
from batch_shipyard_tpu_torch.state.base import (
    EntityExistsError, EtagMismatchError, LeaseLostError,
    NotFoundError, PreconditionFailedError)
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

# Ops the wrapper manages. Lease ops are intentionally absent (see
# module docstring); everything else delegates raw.
_MANAGED_OPS = frozenset({
    "put_object", "get_object", "get_object_meta", "delete_object",
    "list_objects", "insert_entity", "upsert_entity", "merge_entity",
    "get_entity", "query_entities", "delete_entity",
    "insert_entities", "put_message", "put_messages", "get_messages",
    "delete_message", "update_message", "queue_length",
    "count_entities_by",
    "put_object_stream", "get_object_stream",
})

# Batch write ops the group-commit layer may buffer (everything else
# flushes the buffer first, so ordering across op kinds is preserved).
_GROUP_COMMIT_OPS = frozenset({"insert_entities", "put_messages"})

# Successful round trips wearing exception suits: never retried,
# never journaled, always propagated.
_SEMANTIC_ERRORS = (NotFoundError, PreconditionFailedError,
                    EntityExistsError, EtagMismatchError,
                    LeaseLostError)

_JOURNALED_ETAG = "journaled"


class StoreOutageError(RuntimeError):
    """A critical op exhausted the outage ceiling."""


class ResilientStore:
    """StateStore wrapper: critical ops retry through outages,
    advisory ops ride a local WAL. Transparent pass-through while the
    store is healthy."""

    def __init__(self, inner, journal_path: str,
                 pool_id: Optional[str] = None,
                 node_id: Optional[str] = None,
                 retry_base: float = 0.25, retry_cap: float = 5.0,
                 max_outage_seconds: float = 900.0,
                 probe_interval: float = 1.0,
                 group_commit_rows: int = 0,
                 group_commit_interval: float = 0.05,
                 stop_check=None) -> None:
        self._inner = inner
        self._journal_path = journal_path
        self._pool_id = pool_id
        self._node_id = node_id
        self._retry_base = retry_base
        self._retry_cap = retry_cap
        self._max_outage_seconds = max_outage_seconds
        self._probe_interval = probe_interval
        self._stop_check = stop_check or (lambda: False)
        self._lock = threading.RLock()
        self._journal: list[dict] = []
        self._outage_since: Optional[float] = None
        self._last_probe = 0.0
        self._emitting = False
        # Replay is single-flight: one thread drains the backlog,
        # concurrent triggers return immediately (their entries are
        # picked up by the in-progress drain's tail scan).
        self._replay_lock = threading.Lock()
        # The entry being applied RIGHT NOW — coalescing must never
        # merge into it (the payload could be half-serialized into
        # the in-flight store call, and the pop would drop the
        # merged-in newer values without ever applying them).
        self._replay_inflight: Optional[dict] = None
        # Per-thread retry ceilings (``bounded``): lets latency-
        # sensitive callers (the agent heartbeat thread) cap how long
        # a critical op may block in the outage-retry loop.
        self._tls = threading.local()
        self.outage_seconds_total = 0.0
        self.outages_total = 0
        # Group-commit state. ``_gc_ambient_rows > 0`` turns the lane
        # on for the wrapper's whole lifetime; ``group_commit()``
        # blocks turn it on lexically. The flush lock is re-entrant
        # because a flush can recover an outage, which emits a goodput
        # event through SELF (see _emit_outage_event) — that advisory
        # write must not deadlock on its own flush-on-write.
        self._gc_ambient_rows = max(0, int(group_commit_rows))
        self._gc_interval = group_commit_interval
        self._gc_depth = 0
        self._gc_ctx_rows = 0
        self._gc_ctx_interval: Optional[float] = None
        self._gc_buffer: list[dict] = []
        self._gc_rows = 0
        self._gc_opened = 0.0
        self._gc_flush_lock = threading.RLock()
        self.group_commits_total = 0
        self.group_commit_rows_total = 0
        self.group_commit_coalesced_total = 0
        self._load_journal()

    # ---------------------------- delegation ---------------------------

    def __getattr__(self, name: str):
        attr = getattr(self._inner, name)
        if name in _MANAGED_OPS and callable(attr):
            def managed(*args, **kwargs):
                return self._call(name, attr, args, kwargs)
            return managed
        return attr

    # --------------------------- classification ------------------------

    @staticmethod
    def _is_advisory(op: str, args: tuple) -> bool:
        """Goodput / trace appends and node heartbeat-ish publishes:
        observers whose loss would be an accounting hole but whose
        latency must never block (or fail) the work being measured."""
        if op not in ("insert_entity", "upsert_entity",
                      "merge_entity") or not args:
            return False
        table = args[0]
        if table in (names.TABLE_GOODPUT, names.TABLE_TRACE):
            return True
        # Node-entity publishes (heartbeat_at, health, state): stale
        # values self-repair on the next periodic beat, and the
        # in-order replay leaves the newest journaled beat last.
        return table == names.TABLE_NODES and op in ("merge_entity",
                                                     "upsert_entity")

    # ------------------------------- calls -----------------------------

    def _call(self, op: str, attr, args: tuple, kwargs: dict) -> Any:
        self._maybe_replay_backlog()
        if op in _GROUP_COMMIT_OPS and self._group_commit_active():
            return self._group_commit_buffer(op, args, kwargs)
        if self._gc_buffer:
            # Flush-on-read (and on any unbuffered write): no managed
            # op may observe — or order itself against — the backend
            # while accepted batch writes are still pending.
            self.flush_group_commit()
        if op == "put_object_stream":
            return self._critical_put_stream(attr, args, kwargs)
        if op == "get_object_stream":
            return self._critical_get_stream(attr, args, kwargs)
        if self._is_advisory(op, args):
            return self._advisory_call(op, attr, args, kwargs)
        return self._critical_call(op, attr, args, kwargs)

    def _critical_put_stream(self, attr, args: tuple,
                             kwargs: dict) -> Any:
        """put_object_stream with the critical ride-through (output
        uploads are what the completion path's classification hangs
        on — they must survive an outage exactly like the scalar
        puts). The chunk iterator is single-shot, and retrying a
        half-consumed iterator would commit a TORN object as whole —
        so the stream is spooled to an anonymous local temp file
        once, and every retry attempt re-streams from the spool."""
        import tempfile
        if len(args) >= 2:
            key, chunks, tail = args[0], args[1], args[2:]
        else:
            key = args[0] if args else kwargs.pop("key")
            chunks = kwargs.pop("chunks")
            tail = ()
        with tempfile.TemporaryFile() as spool:
            for block in chunks:
                spool.write(block)

            def attempt():
                spool.seek(0)

                def replay():
                    while True:
                        block = spool.read(1 << 20)
                        if not block:
                            return
                        yield block

                return attr(key, replay(), *tail, **kwargs)

            return self._critical_call("put_object_stream", attempt,
                                       (), {})

    def _critical_get_stream(self, attr, args: tuple,
                             kwargs: dict) -> Any:
        """get_object_stream with the critical ride-through on open +
        first chunk (backends implement it as a generator, so the
        bare call never fails — the first ``next`` is where missing
        keys and transport faults surface). Later chunks stream to
        the caller lazily and a mid-consumption transport failure
        still propagates: a half-yielded stream cannot be resumed
        without handing the consumer a torn prefix, and eagerly
        spooling would double the disk traffic of multi-GB
        transfers. Callers that need retried-to-completion reads use
        get_object."""
        import itertools

        def attempt():
            it = iter(attr(*args, **kwargs))
            try:
                first = next(it)
            except StopIteration:
                return iter(())
            return itertools.chain([first], it)

        return self._critical_call("get_object_stream", attempt,
                                   (), {})

    def _advisory_call(self, op: str, attr, args: tuple,
                       kwargs: dict) -> Any:
        with self._lock:
            latched = self._outage_since is not None
            backlog = bool(self._journal)
            probe = (latched and time.monotonic() - self._last_probe
                     >= self._probe_interval)
            if probe:
                self._last_probe = time.monotonic()
        if latched or backlog:
            # Journal FIRST, then (at most once per probe_interval)
            # probe the store with a cheap no-op read — recovery
            # replays the journal in order, this op included, so the
            # probe can never apply a newer event ahead of the
            # backlog it rode out the outage behind. The latch alone
            # is NOT enough: between latch-close and replay-drain a
            # direct write would race the replay of its own entity's
            # stale journaled value (heartbeat_at moving backwards),
            # so while ANY backlog exists the journal stays the
            # ordering authority and fresh advisories queue behind it.
            self._journal_append(op, args, kwargs)
            if probe:
                self._probe_recover()
            return _JOURNALED_ETAG
        try:
            return attr(*args, **kwargs)
        except _SEMANTIC_ERRORS:
            raise
        except Exception:  # noqa: BLE001 - transport failure
            self._latch_outage(op)
            self._journal_append(op, args, kwargs)
            return _JOURNALED_ETAG

    def _probe_recover(self) -> None:
        """One cheap metadata read against the raw store; any full
        round trip (a semantic miss included) proves recovery."""
        try:
            self._inner.get_object_meta("__outage-probe__")
        except _SEMANTIC_ERRORS:
            pass  # the store answered
        except Exception:  # noqa: BLE001 - still down
            return
        self._recovered()

    def outage_active(self) -> bool:
        """Observer view of the latch — lets loops with LOCAL duties
        (eviction kills, retention) decide to skip store-coordination
        work for a beat instead of discovering the outage by blocking
        inside it."""
        with self._lock:
            return self._outage_since is not None

    @contextlib.contextmanager
    def bounded(self, seconds: float):
        """Cap this thread's critical-op retries: inside the block a
        critical op that cannot complete before the deadline raises
        StoreOutageError instead of sleeping toward the global
        ``max_outage_seconds`` ceiling. For callers that multiplex
        unrelated duties on one thread (the agent heartbeat loop:
        heartbeats, lease renewal, eviction enforcement, retention) —
        a 900s blocking retry there would starve every other duty."""
        prior = getattr(self._tls, "deadline", None)
        self._tls.deadline = time.monotonic() + max(0.0, seconds)
        try:
            yield self
        finally:
            self._tls.deadline = prior

    # --------------------------- group commit --------------------------

    @contextlib.contextmanager
    def group_commit(self, max_rows: int = 4096,
                     flush_interval: Optional[float] = None):
        """Write-combining region: buffer ``insert_entities`` /
        ``put_messages`` and coalesce adjacent same-target calls into
        one backend round trip each. Flushes on the row cap, the
        flush interval, any other managed op, and block exit (errors
        from the final flush propagate out of the ``with``). Nested
        blocks inherit the outermost block's limits."""
        with self._lock:
            self._gc_depth += 1
            outermost = self._gc_depth == 1
            if outermost:
                self._gc_ctx_rows = max(1, int(max_rows))
                self._gc_ctx_interval = (
                    self._gc_interval if flush_interval is None
                    else flush_interval)
        try:
            yield self
        finally:
            with self._lock:
                self._gc_depth -= 1
                closing = self._gc_depth == 0
                if closing:
                    self._gc_ctx_rows = 0
                    self._gc_ctx_interval = None
            if closing:
                self.flush_group_commit()

    def _group_commit_active(self) -> bool:
        with self._lock:
            return self._gc_depth > 0 or self._gc_ambient_rows > 0

    def _gc_limits(self) -> tuple[int, float]:
        if self._gc_depth > 0:
            return (self._gc_ctx_rows,
                    self._gc_interval if self._gc_ctx_interval is None
                    else self._gc_ctx_interval)
        return self._gc_ambient_rows, self._gc_interval

    def group_commit_pending(self) -> int:
        """Buffered-but-unflushed row count (test observer)."""
        with self._lock:
            return self._gc_rows

    def _group_commit_buffer(self, op: str, args: tuple,
                             kwargs: dict) -> list:
        if op == "put_messages":
            target = args[0] if args else kwargs["queue"]
            items = list(args[1] if len(args) > 1
                         else kwargs["payloads"])
            delay = args[2] if len(args) > 2 \
                else kwargs.get("delay_seconds", 0.0)
            key = (op, target, delay)
        else:
            target = args[0] if args else kwargs["table"]
            items = list(args[1] if len(args) > 1 else kwargs["rows"])
            key = (op, target)
        if not items:
            return []
        do_flush = False
        with self._lock:
            now = time.monotonic()
            if self._gc_buffer and self._gc_buffer[-1]["key"] == key:
                # Adjacent same-(op, target[, delay]) calls combine.
                # Only the TAIL is a legal merge target — reaching
                # past a different-target entry would reorder writes
                # the caller sequenced deliberately (e.g. task rows
                # before their queue messages).
                self._gc_buffer[-1]["items"].extend(items)
                self.group_commit_coalesced_total += 1
            else:
                self._gc_buffer.append(
                    {"op": op, "key": key, "items": items})
            self._gc_rows += len(items)
            self.group_commit_rows_total += len(items)
            if not self._gc_opened:
                self._gc_opened = now
            rows_cap, interval = self._gc_limits()
            if self._gc_rows >= rows_cap or \
                    now - self._gc_opened >= interval:
                do_flush = True
        if do_flush:
            self.flush_group_commit()
        # Buffered writes cannot return backend etags / message ids;
        # placeholders keep the shape. (Submission ignores them — a
        # caller that needs real etags reads after the flush.)
        return [_JOURNALED_ETAG] * len(items)

    def flush_group_commit(self) -> None:
        """Apply the buffered entries IN ORDER. Transport faults on
        an entity batch demote that entry to per-row idempotent
        repair (EntityExistsError == already applied — the WAL replay
        discipline), so a faulted batch always ends fully applied,
        never torn. If even the repair path exhausts the outage
        ceiling, every unapplied entry is re-queued at the FRONT of
        the buffer before the error propagates — accepted writes are
        never silently dropped. Semantic errors apply the remaining
        entries first, then the first one raises (deferred-error
        surfacing at the flush boundary)."""
        with self._gc_flush_lock:
            with self._lock:
                entries = self._gc_buffer
                self._gc_buffer = []
                self._gc_rows = 0
                self._gc_opened = 0.0
            if not entries:
                return
            first_semantic: Optional[BaseException] = None
            for idx, entry in enumerate(entries):
                try:
                    self._gc_apply(entry)
                except _SEMANTIC_ERRORS as exc:
                    if first_semantic is None:
                        first_semantic = exc
                except Exception:
                    with self._lock:
                        remaining = entries[idx:]
                        self._gc_buffer[:0] = remaining
                        self._gc_rows += sum(len(e["items"])
                                             for e in remaining)
                        if not self._gc_opened:
                            self._gc_opened = time.monotonic()
                    raise
            self.group_commits_total += 1
            if first_semantic is not None:
                raise first_semantic

    def _gc_apply(self, entry: dict) -> None:
        op, key, items = entry["op"], entry["key"], entry["items"]
        if op == "put_messages":
            # Whole-batch critical retry: a replayed batch can
            # double-enqueue rows the faulted attempt already landed,
            # which is the queue contract's at-least-once — agents
            # already dedupe via the task-state claim transition.
            self._critical_call(
                "put_messages", self._inner.put_messages,
                (key[1], items), {"delay_seconds": key[2]})
            return
        table = key[1]
        if not entry.get("tolerant"):
            try:
                self._inner.insert_entities(table, items)
                return
            except _SEMANTIC_ERRORS:
                raise
            except Exception:  # noqa: BLE001 - transport: maybe torn
                self._latch_outage("insert_entities")
                entry["tolerant"] = True
        # Per-row repair. items shrinks as rows land so a re-queued
        # entry resumes exactly where the outage cut it off.
        while items:
            pk, rk, entity = items[0]
            try:
                self._critical_call(
                    "insert_entity", self._inner.insert_entity,
                    (table, pk, rk, entity), {})
            except EntityExistsError:
                pass  # applied before the fault — repair made whole
            items.pop(0)

    def _critical_call(self, op: str, attr, args: tuple,
                       kwargs: dict) -> Any:
        attempt = 0
        first_failed: Optional[float] = None
        while True:
            try:
                if op == "query_entities":
                    # Materialize so transport failures surface HERE,
                    # not at some later iteration site outside the
                    # retry loop.
                    result = list(attr(*args, **kwargs))
                else:
                    result = attr(*args, **kwargs)
            except _SEMANTIC_ERRORS:
                raise
            except Exception as exc:  # noqa: BLE001 - transport
                self._latch_outage(op)
                attempt += 1
                now = time.monotonic()
                if first_failed is None:
                    first_failed = now
                # The ceiling is THIS call's own failure window, not
                # the global latch clock: a concurrent advisory
                # probe's success clears the latch, and a flapping
                # store — or a deterministic CALLER error failing
                # against a perfectly healthy store — would re-latch
                # with a fresh start time every attempt, resetting a
                # latch-based clock forever and turning the bounded
                # ceiling into an infinite spin.
                elapsed = now - first_failed
                if elapsed > self._max_outage_seconds or \
                        self._stop_check():
                    raise StoreOutageError(
                        f"store op {op} failed through a "
                        f"{elapsed:.0f}s outage") from exc
                delay = self._backoff(op, attempt)
                deadline = getattr(self._tls, "deadline", None)
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0.0:
                        raise StoreOutageError(
                            f"store op {op} exceeded its caller's "
                            f"bounded retry window during a "
                            f"{elapsed:.0f}s outage") from exc
                    delay = min(delay, remaining)
                time.sleep(delay)
                continue
            with self._lock:
                latched = self._outage_since is not None
            if latched:
                self._recovered()
            return result

    def _backoff(self, op: str, attempt: int) -> float:
        delay = min(self._retry_cap,
                    self._retry_base * (2.0 ** min(attempt - 1, 16)))
        # Deterministic per-(op, attempt) jitter (the retry
        # supervisor's idiom): desynchronize a fleet's retry thunder
        # without breaking seeded-drill replays.
        jitter = (zlib.crc32(f"{op}#{attempt}".encode()) % 1000) \
            / 1000.0
        return delay * (0.75 + 0.5 * jitter)

    # ------------------------------ outage -----------------------------

    def _latch_outage(self, op: str) -> None:
        with self._lock:
            if self._outage_since is None:
                self._outage_since = time.time()
                self._last_probe = time.monotonic()
                logger.warning(
                    "store outage latched (first failed op: %s); "
                    "critical ops retrying, advisory ops journaling "
                    "to %s", op, self._journal_path)

    def _recovered(self) -> None:
        with self._lock:
            since = self._outage_since
            self._outage_since = None
            if since is None:
                return
            now = time.time()
            self.outage_seconds_total += max(0.0, now - since)
            self.outages_total += 1
        replayed = self._replay()
        logger.warning(
            "store outage over after %.1fs; %d journaled event(s) "
            "replayed, %d still backlogged", now - since, replayed,
            self.journal_backlog())
        self._emit_outage_event(since, now, replayed)

    def _emit_outage_event(self, start: float, end: float,
                           replayed: int) -> None:
        """Price the outage as its own badput leg, with the exact
        [first-failure, first-success] partition. Emitted through
        SELF so a double-dip outage journals it like any other
        advisory event."""
        if not self._pool_id:
            return
        with self._lock:
            if self._emitting:
                return
            self._emitting = True
        try:
            from batch_shipyard_tpu_torch.goodput import events as gp_events
            gp_events.emit(
                self, self._pool_id, gp_events.STORE_OUTAGE,
                node_id=self._node_id, start=start, end=end,
                attrs={"replayed": replayed,
                       "backlog": self.journal_backlog()})
        finally:
            with self._lock:
                self._emitting = False

    # ------------------------------ journal ----------------------------

    def journal_backlog(self) -> int:
        with self._lock:
            return len(self._journal)

    def _entry_key(self, op: str, args: tuple) -> Optional[tuple]:
        # Op is part of the key: folding an upsert into an earlier
        # merge entry would replay it with merge semantics and keep
        # columns the upsert meant to drop.
        if op in ("merge_entity", "upsert_entity") and len(args) >= 3:
            return (op, args[0], args[1], args[2])
        return None

    def _journal_append(self, op: str, args: tuple,
                        kwargs: dict) -> None:
        entry = {"op": op, "args": list(args),
                 "kwargs": dict(kwargs),
                 "recorded_at": time.time()}
        entry["kwargs"].pop("if_match", None)  # stale by replay time
        with self._lock:
            key = self._entry_key(op, args)
            if key is not None:
                # Coalesce repeated publishes of the same entity
                # (heartbeats every few seconds for minutes) into the
                # MOST RECENT journaled write for that entity — the
                # backlog stays O(entities), not O(outage duration).
                # Only the newest entry is a legal target: reaching
                # past an intervening different-op write (merge vs
                # upsert) or the entry being replayed right now would
                # reorder the chain on replay.
                for prior in reversed(self._journal):
                    pkey = self._entry_key(prior["op"],
                                           tuple(prior["args"]))
                    if pkey is None or pkey[1:] != key[1:]:
                        continue
                    if prior is self._replay_inflight or \
                            pkey[0] != key[0]:
                        break  # op boundary / in-flight: append
                    if op == "upsert_entity":
                        # Upsert semantics: the newest full-row
                        # replace wins outright.
                        prior["args"][3] = dict(entry["args"][3])
                    else:
                        merged = dict(prior["args"][3])
                        merged.update(entry["args"][3])
                        prior["args"][3] = merged
                    prior["recorded_at"] = entry["recorded_at"]
                    # O(1) on disk: append the RAW entry instead of
                    # rewriting the whole file per heartbeat. A crash
                    # replays the un-coalesced file in order —
                    # newest-last yields the same final store state;
                    # drains/stall-trims compact it.
                    self._append_journal_file(entry)
                    return
            self._journal.append(entry)
            self._append_journal_file(entry)

    def _append_journal_file(self, entry: dict) -> None:
        try:
            os.makedirs(os.path.dirname(self._journal_path) or ".",
                        exist_ok=True)
            with open(self._journal_path, "a",
                      encoding="utf-8") as fh:
                fh.write(json.dumps(entry, default=str) + "\n")
                fh.flush()
                os.fsync(fh.fileno())
        except OSError:
            logger.exception("WAL append failed for %s",
                             self._journal_path)

    def _rewrite_journal_file(self) -> None:
        """Atomic whole-file compaction — used by partial-replay
        trims (coalescing appends raw entries instead; see
        _journal_append)."""
        try:
            os.makedirs(os.path.dirname(self._journal_path) or ".",
                        exist_ok=True)
            payload = "".join(json.dumps(entry, default=str) + "\n"
                              for entry in self._journal)
            util.atomic_write(self._journal_path,
                              payload.encode("utf-8"))
        except OSError:
            logger.exception("WAL rewrite failed for %s",
                             self._journal_path)

    def _load_journal(self) -> None:
        """Crash-restart path: a predecessor agent's backlog is this
        agent's debt — loaded now, replayed before recovery declares
        itself done."""
        if not os.path.exists(self._journal_path):
            return
        entries: list[dict] = []
        try:
            with open(self._journal_path, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entry = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(entry, dict) and entry.get("op") \
                            in _MANAGED_OPS:
                        entries.append(entry)
        except OSError:
            logger.exception("WAL load failed for %s",
                             self._journal_path)
            return
        with self._lock:
            self._journal = entries
        if entries:
            logger.warning(
                "loaded %d journaled store op(s) from a previous "
                "agent process; replaying on first healthy op",
                len(entries))

    def _maybe_replay_backlog(self) -> None:
        """Restart-backlog drain: replay a loaded journal once the
        store answers, outside any outage latch."""
        with self._lock:
            pending = bool(self._journal) and \
                self._outage_since is None
        if pending:
            self._replay()

    def _replay(self) -> int:
        """Apply the journal IN ORDER. An entry that hits a transport
        error stops the replay (latch re-opens via the failing op's
        own path next time); semantic errors mean the world moved on
        — EntityExistsError is a crash-mid-replay duplicate (success),
        NotFoundError a deleted target (drop). Returns entries
        applied."""
        if not self._replay_lock.acquire(blocking=False):
            return 0  # a concurrent drain owns the backlog
        applied = 0
        try:
            while True:
                with self._lock:
                    if not self._journal:
                        break
                    entry = self._journal[0]
                    self._replay_inflight = entry
                    # Snapshot the payload under the lock: coalescing
                    # mutates args[3] in place and the store may
                    # serialize lazily.
                    args = list(entry["args"])
                    if len(args) >= 4 and isinstance(args[3], dict):
                        args[3] = dict(args[3])
                    args = tuple(args)
                op = entry["op"]
                kwargs = dict(entry.get("kwargs") or {})
                try:
                    if op == "upsert_entity" and len(args) >= 3 and \
                            args[0] == names.TABLE_NODES:
                        # A journaled node publish must never
                        # resurrect a row the substrate deleted
                        # during the outage (upsert re-creates
                        # unconditionally — ghost capacity for
                        # federation/heimdall observers); probe
                        # existence and let the NotFoundError drop
                        # the entry like any other retired target.
                        self._inner.get_entity(args[0], args[1],
                                               args[2])
                    getattr(self._inner, op)(*args, **kwargs)
                except (EntityExistsError, NotFoundError,
                        EtagMismatchError, PreconditionFailedError):
                    pass  # replayed before a crash, or target retired
                except Exception:  # noqa: BLE001 - transport: stop
                    logger.debug("WAL replay stalled at %s", op,
                                 exc_info=True)
                    with self._lock:
                        self._rewrite_journal_file()
                    return applied
                applied += 1
                with self._lock:
                    if self._journal and self._journal[0] is entry:
                        self._journal.pop(0)
            with self._lock:
                if not self._journal:
                    try:
                        os.remove(self._journal_path)
                    except OSError:
                        pass
                else:
                    self._rewrite_journal_file()
            return applied
        finally:
            with self._lock:
                self._replay_inflight = None
            self._replay_lock.release()
