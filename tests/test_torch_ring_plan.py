"""K12's, K13's and K14's stream plans (ops/ring_collectives.py
``permute_plan``, ``all_gather_plan`` and ``reduce_scatter_plan``, the
sequences of waits, copies and writes the wrappers enqueue) over a model
of four ranks' pads and slots, on the CPU.

Each rank runs its calls' plans in order on one stream, or on two (K12 on
one, K13 and K14 on the other: the buffers are separate, so no order
between K12 and the others is needed), and a seed drawn by hypothesis
picks which enabled stream moves next. The model follows the kernels'
rules: a wait blocks until the word reaches its value; a copy does
nothing once the rank's error word is set, and sets it (unfilled) instead
of reading a peer slot that does not hold the write the plan waited for;
a copy into the own slot marks it with its write number; K14's copies add
this rank's part of a chunk, and the model carries a partial as the
ordered tuple of the ranks whose parts it holds. Checked:

- no deadlock over five or six consecutive calls, with a +1 then -1 shift
  pair, reduce-scatters and all-gathers;
- no slot is written before its previous write was consumed;
- every rank's outputs equal what ``ring_permute_reference`` /
  ``ring_all_gather_reference`` / ``ring_reduce_scatter_reference``
  compute (rank r - shift's pair; every rank's chunk in rank order; chunk
  r's parts added in ring order, rank r + 1's first);
- with a rank that skips one call, the watchdog's rule (an expired wait,
  or any wait once the error word is set, gets the poison epoch) releases
  every pending wait: every rank drains, and in chip_smoke.py's
  missing-rank step every rank's error word is set, so every rank raises.

The ring group's watchdog (parallel/mesh.py ``RingGroup._sweep``) is
checked on stand-in events and a stand-in clock: a wait is timed by its
event pair, expires ``timeout_s`` after it was seen reached, and then
(or once a copy set the error word) the words its stream stands at get
the poison epoch, after the error into the device-side abort word.
"""

import ctypes
import random
import threading

import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from batch_shipyard_tpu_torch.ops import ring_collectives as rc
from batch_shipyard_tpu_torch.parallel import mesh

RING = 4
# Sequences of consecutive ring calls: ("permute", shift) of K12,
# ("gather",) of K13, ("reduce",) of K14.
SEQUENCES = {
    "permute pair then gather": [("permute", 1), ("permute", -1),
                                 ("gather",), ("permute", 1), ("gather",)],
    "permutes": [("permute", 1), ("permute", 1), ("permute", -1),
                 ("permute", -1), ("permute", 1)],
    "gathers": [("gather",), ("gather",), ("permute", 1), ("permute", -1),
                ("gather",)],
    # Two train steps' ring calls: rotations, then the gradient all-reduce.
    "train steps": [("permute", 1), ("permute", -1), ("reduce",),
                    ("gather",), ("permute", 1), ("reduce",), ("gather",)],
    "reduces": [("reduce",), ("reduce",), ("permute", 1), ("reduce",),
                ("gather",)],
}


def _programs(sequence, streams: int, skip=None):
    """Per rank, per stream: [(call index, op)] of the plans, the epochs
    counted per buffer as the wrappers count them. ``skip``: (rank, call
    index) a rank leaves out."""
    programs = []
    for rank in range(RING):
        calls = 0
        writes = {"gather": 0, "reduce": 0}
        plans = {"gather": rc.all_gather_plan,
                 "reduce": rc.reduce_scatter_plan}
        lanes = [[] for _ in range(streams)]
        for i, call in enumerate(sequence):
            if (rank, i) == skip:
                continue
            if call[0] == "permute":
                calls += 1
                plan = rc.permute_plan(rank, RING, call[1], calls)
                lane = 0
            else:
                plan = plans[call[0]](rank, RING, writes[call[0]])
                writes[call[0]] += RING - 1
                lane = streams - 1
            lanes[lane] += [(i, op) for op in plan]
        programs.append(lanes)
    return programs


class Model:
    """Four ranks' pads (one per buffer kind) and slots, and the outputs
    of their calls."""

    def __init__(self, sequence, streams: int, skip=None) -> None:
        self.sequence = sequence
        self.programs = _programs(sequence, streams, skip)
        self.pc = [[0] * streams for _ in range(RING)]
        self.words = {}   # (kind, rank, word) -> value
        self.slots = {}   # (kind, rank, s) -> (data, write)
        self.error = [0] * RING
        self.out = {}     # (rank, call) -> {chunk: data}

    def kind(self, call: int) -> str:
        return self.sequence[call][0]

    def word(self, call, rank, word) -> int:
        return self.words.get((self.kind(call), rank, word), 0)

    def runnable(self) -> list:
        """The (rank, stream) pairs whose next op can run."""
        ready = []
        for rank, lanes in enumerate(self.programs):
            for lane, program in enumerate(lanes):
                pc = self.pc[rank][lane]
                if pc == len(program):
                    continue
                call, op = program[pc]
                if (not isinstance(op, rc.Wait) or
                        self.word(call, op.rank, op.word) >= op.value):
                    ready.append((rank, lane))
        return ready

    def pending(self) -> list:
        """The (rank, stream) pairs that stand at a wait."""
        return [(rank, lane) for rank, lanes in enumerate(self.programs)
                for lane, program in enumerate(lanes)
                if self.pc[rank][lane] < len(program)]

    def poison(self, rank: int, lane: int) -> None:
        """The watchdog: set the error word, poison the awaited word."""
        call, op = self.programs[rank][lane][self.pc[rank][lane]]
        self.error[rank] = self.error[rank] or mesh.TIMED_OUT
        self.words[(self.kind(call), op.rank, op.word)] = mesh.POISON

    def step(self, rank: int, lane: int) -> None:
        call, op = self.programs[rank][lane][self.pc[rank][lane]]
        self.pc[rank][lane] += 1
        kind = self.kind(call)
        if isinstance(op, rc.Write):
            key = (kind, op.rank, op.word)
            if not self.error[rank] and self.words.get(key) != mesh.POISON:
                assert op.value >= self.words.get(key, 0), (op, self.words)
            self.words[key] = op.value
        elif isinstance(op, rc.Copy) and not self.error[rank]:
            self.copy(rank, call, kind, op)

    def copy(self, rank, call, kind, op) -> None:
        """Data: (kind, rank, call) of an input; K14's partials (kind,
        call, chunk, ranks added in order), chunk None once a part of
        another chunk was added."""
        if op.src == ("in",):
            data = (kind, rank, call)
        elif op.src[0] == "in":
            data = (kind, call, op.src[1], (rank,))
        else:
            # A slot never filled holds the pad's initial mark, 0.
            data, write = self.slots.get((kind,) + op.src[1:], (None, 0))
            if write != op.read:  # the kernel's unfilled check
                self.error[rank] = mesh.UNFILLED
                return
        if op.local is not None:
            _, partial_call, chunk, ranks = data
            data = (kind, partial_call,
                    chunk if chunk == op.local[1] else None, ranks + (rank,))
        for dst in op.dsts:
            if dst[0] == "out":
                self.out.setdefault((rank, call), {})[dst[1]] = data
                continue
            assert dst[1] == rank, op
            _, prev = self.slots.get((kind,) + dst[1:], (None, 0))
            consumed = self.words.get((kind, rank, f"consumed{dst[2]}"), 0)
            assert consumed >= prev, ("slot overwritten before it was "
                                      "consumed", rank, op, prev, consumed)
            self.slots[(kind,) + dst[1:]] = (data, op.write)

    def run(self, rng: random.Random, watchdog: bool = False) -> None:
        while self.pending():
            ready = self.runnable()
            if ready:
                self.step(*rng.choice(ready))
                continue
            assert watchdog, ("deadlock", self.pc)
            for rank, lane in self.pending():
                self.poison(rank, lane)


def _expected(sequence, rank: int, call: int) -> dict:
    """What the plain versions return on ``rank`` for call ``call``."""
    kind = sequence[call][0]
    if kind == "permute":
        return {0: (kind, (rank - sequence[call][1]) % RING, call)}
    if kind == "reduce":
        return {0: (kind, call, rank,
                    tuple((rank + 1 + j) % RING for j in range(RING)))}
    return {j: (kind, j, call) for j in range(RING)}


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_plans_deliver_without_deadlock_or_overwrite(name, streams, seed):
    sequence = SEQUENCES[name]
    model = Model(sequence, streams)
    model.run(random.Random(seed))
    assert model.error == [0] * RING
    for rank in range(RING):
        for call in range(len(sequence)):
            assert model.out[(rank, call)] == _expected(sequence, rank,
                                                        call), (rank, call)


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("skip", [(3, 1), (0, 2), (2, 0)])
@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_poison_releases_every_wait_after_a_skipped_call(skip, streams,
                                                         seed):
    """Every pending wait is released (the run drains) and the rank whose
    wait expired has its error word set. The epochs pair each rank's i-th
    call of a buffer, so ranks whose calls still pair finish these five
    calls; they fail at a later call the stopped rank never makes."""
    sequence = SEQUENCES["permute pair then gather"]
    model = Model(sequence, streams, skip=skip)
    model.run(random.Random(seed), watchdog=True)
    assert any(model.error), model.error


@pytest.mark.parametrize("streams", [1, 2])
@pytest.mark.parametrize("skip", [(3, 2), (0, 3), (1, 5), (2, 0)])
@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_poison_releases_every_wait_after_a_skipped_call_of_a_train_step(
        skip, streams, seed):
    """The same with K14 in the sequence: a skipped reduce-scatter, an
    all-gather after it, or a rotation before it."""
    model = Model(SEQUENCES["train steps"], streams, skip=skip)
    model.run(random.Random(seed), watchdog=True)
    assert any(model.error), model.error


# chip_smoke.py rank_missing_peer's first step, shaped like a train step's
# ring calls: four +1 rotations, then a reduce-scatter and an all-gather,
# on one stream; rank 3 skips the second rotation.
MISSING_PEER_STEP = [("permute", 1)] * 4 + [("reduce",), ("gather",)]
# The same step without the reduce-scatter.
MISSING_PEER_STEP_NO_K14 = [("permute", 1)] * 4 + [("gather",)]


@settings(max_examples=100, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_missing_peer_step_fails_every_rank(seed):
    """There every rank stands at a wait the skip starves, or reads a slot
    whose copy a failed rank skipped: after the poison every rank's error
    word is set, so each raises at its check after the step."""
    model = Model(MISSING_PEER_STEP, 1, skip=(RING - 1, 1))
    model.run(random.Random(seed), watchdog=True)
    assert all(model.error), model.error


@settings(max_examples=100, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1))
def test_missing_peer_step_without_k14_fails_every_rank(seed):
    model = Model(MISSING_PEER_STEP_NO_K14, 1, skip=(RING - 1, 1))
    model.run(random.Random(seed), watchdog=True)
    assert all(model.error), model.error


def test_plans_keep_the_kernels_epoch_rule():
    """Write W goes to slot W % 2 after consumed >= W - 2; K13's ring - 1
    writes a call are base + 1 .. base + ring - 1; its chunk order is
    ag_source_shard's."""
    for epoch in range(1, 6):
        plan = rc.permute_plan(1, RING, -1, epoch)
        s = epoch % 2
        assert plan[-5:] == [
            rc.Copy(("in",), (("slot", 1, s),), write=epoch),
            rc.Write(1, f"ready{s}", epoch),
            rc.Wait(2, f"ready{s}", epoch),
            rc.Copy(("slot", 2, s), (("out", 0),), read=epoch),
            rc.Write(2, f"consumed{s}", epoch)]
        assert (plan[0] == rc.Wait(1, f"consumed{s}", epoch - 2)) == \
            (epoch > 2)
    plan = rc.all_gather_plan(2, RING, 6)
    copies = [op for op in plan if isinstance(op, rc.Copy)]
    assert [op.write for op in copies] == [7, 8, 9, 0]
    assert [op.read for op in copies] == [0, 7, 8, 9]
    assert [op.dsts[0] for op in copies] == [("out", 2)] + [
        ("out", rc.ag_source_shard(2, t, RING)) for t in range(RING - 1)]
    waits = [op for op in plan if isinstance(op, rc.Wait)]
    assert waits == [rc.Wait(2, "consumed1", 5), rc.Wait(1, "ready1", 7),
                     rc.Wait(2, "consumed0", 6), rc.Wait(1, "ready0", 8),
                     rc.Wait(2, "consumed1", 7), rc.Wait(1, "ready1", 9)]


def test_reduce_scatter_plan_keeps_the_kernels_epoch_rule():
    """K14's plan has K13's epochs and waits; its first copy takes this
    rank's part of chunk rs_chunk_index(rank, -1), and step t's adds its
    part of chunk rs_chunk_index(rank, t) to the left neighbour's partial,
    into the own next slot or, at the last step, the output."""
    plan = rc.reduce_scatter_plan(2, RING, 6)
    copies = [op for op in plan if isinstance(op, rc.Copy)]
    assert [op.write for op in copies] == [7, 8, 9, 0]
    assert [op.read for op in copies] == [0, 7, 8, 9]
    assert [op.src for op in copies] == [
        ("in", rc.rs_chunk_index(2, -1, RING)), ("slot", 1, 1),
        ("slot", 1, 0), ("slot", 1, 1)]
    assert [op.local for op in copies] == [None] + [
        ("in", rc.rs_chunk_index(2, t, RING)) for t in range(RING - 1)]
    assert [op.dsts for op in copies] == [
        (("slot", 2, 1),), (("slot", 2, 0),), (("slot", 2, 1),),
        (("out", 0),)]
    assert rc.rs_chunk_index(2, RING - 2, RING) == 2  # its own chunk last
    waits = [op for op in plan if isinstance(op, rc.Wait)]
    assert waits == [op for op in rc.all_gather_plan(2, RING, 6)
                     if isinstance(op, rc.Wait)]
    writes = [op for op in plan if isinstance(op, rc.Write)]
    assert writes == [op for op in rc.all_gather_plan(2, RING, 6)
                      if isinstance(op, rc.Write)]
    assert rc.reduce_scatter_plan(0, RING, 0)[0] == rc.Copy(
        ("in", rc.rs_chunk_index(0, -1, RING)), (("slot", 0, 1),), write=1)


# ------------------- the ring group's watchdog (mesh.py) -------------------


class FakeEvent:
    """A timing event: complete or not, and its time from the start."""

    def __init__(self, done: bool, ms: float = 0.0) -> None:
        self.done, self.ms = done, ms

    def query(self) -> bool:
        return self.done

    def elapsed_time(self, other) -> float:
        return other.ms - self.ms


class FakeLibrary:
    def __init__(self) -> None:
        self.writes = []

    def bs_stream_write(self, device, word, value, stream):
        self.writes.append((word, value))
        return 0


def _watched_group(monkeypatch, timeout_s=2.0):
    """A CUDA ring group's watchdog state without a card: its waits are
    [before, after, word, seen] entries of FakeEvents; the clock is a
    list the test moves."""
    clock = [100.0]
    monkeypatch.setattr(mesh.time, "monotonic", lambda: clock[0])
    group = mesh.RingGroup.__new__(mesh.RingGroup)
    group.rank, group.size = 1, RING
    group.device = torch.device("cuda", 0)
    group.timeout_s = timeout_s
    group.error = (ctypes.c_int * 1)(0)
    group._library = FakeLibrary()
    group._waits, group._spare, group._waited_ns = [], [], 0
    group._lock = threading.Lock()
    group._poison_stream = None
    group.abort = 0x99
    return group, clock


def test_watchdog_times_waits_and_poisons_an_expired_one(monkeypatch):
    group, clock = _watched_group(monkeypatch)
    ended = [FakeEvent(True, 1.0), FakeEvent(True, 3.5), 0x10, None]
    reached = [FakeEvent(True), FakeEvent(False), 0x20, None]
    queued = [FakeEvent(False), FakeEvent(False), 0x30, None]
    group._waits = [ended, reached, queued]
    group._sweep()
    assert group._waited_ns == 2_500_000
    assert group._waits == [reached, queued]
    assert reached[3] == 100.0 and queued[3] is None
    assert group.error[0] == 0 and group._library.writes == []
    group.check()
    clock[0] += 1.9  # not yet past the timeout
    group._sweep()
    assert group.error[0] == 0
    clock[0] += 0.2
    group._sweep()
    assert group.error[0] == mesh.TIMED_OUT
    assert group._library.writes == [(0x99, mesh.TIMED_OUT),
                                     (0x20, mesh.POISON)]
    with pytest.raises(RuntimeError, match="waited longer than 2.0 s"):
        group.check()
    # Once the word is set, a wait the stream reaches is poisoned at once.
    queued[0].done = True
    group._sweep()
    assert (0x30, mesh.POISON) in group._library.writes


def test_watchdog_poisons_at_once_when_a_copy_found_a_slot_unfilled(
        monkeypatch):
    group, _ = _watched_group(monkeypatch, timeout_s=120.0)
    reached = [FakeEvent(True), FakeEvent(False), 0x40, None]
    group._waits = [reached]
    group.error[0] = mesh.UNFILLED  # what a copy kernel writes
    group._sweep()
    assert group._library.writes == [(0x99, mesh.UNFILLED),
                                     (0x40, mesh.POISON)]
    with pytest.raises(RuntimeError, match="slot unfilled"):
        group.check()
