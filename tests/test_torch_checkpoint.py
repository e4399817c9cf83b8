"""The port's checkpoint layer (workloads/checkpoint.py, the restore side
of parallel/sharding.py, parallel/restore_plan.py, the harness's state
export and import) and the pool hooks of its training loop (agent/,
goodput/, trace/spans.py, trace/profiling.py) on the CPU, held to the
reference's contracts:

- the reference's own checkpoint tests (tests/test_checkpoint_async.py,
  tests/test_reshard_restore.py) on the port's module, with the state of
  a tiny CPU harness in place of the reference's pytrees;
- the reference's ``latest_step`` and ``_committed_steps`` read the
  port's directories;
- resizes, with ranks simulated as ``RankMesh(sizes, rank)`` (no process
  group): the state written by every rank of mesh A, restored on every
  rank of mesh B, equals the saved global state bit for bit, and each
  rank reads exactly what the plan says;
- the goodput and span JSONL of the workload go through the reference's
  ingest functions;
- ``serve --checkpoint-dir`` streams the greedy tokens of the same
  parameters held in memory.

Multi-process runs are in tests/test_torch_resume.py.
"""

import dataclasses
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from batch_shipyard_tpu.goodput import events as ref_events
from batch_shipyard_tpu.state.memory import MemoryStateStore
from batch_shipyard_tpu.trace import spans as ref_spans
from batch_shipyard_tpu.workloads import checkpoint as ref_checkpoint
from batch_shipyard_tpu_torch.agent import preemption, progress
from batch_shipyard_tpu_torch.goodput import events as gp
from batch_shipyard_tpu_torch.models import convert, serving
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.parallel import mesh as tmesh
from batch_shipyard_tpu_torch.parallel import restore_plan
from batch_shipyard_tpu_torch.parallel import sharding
from batch_shipyard_tpu_torch.parallel import train as ttrain
from batch_shipyard_tpu_torch.trace import context as trace_ctx
from batch_shipyard_tpu_torch.trace import profiling
from batch_shipyard_tpu_torch.trace import spans
from batch_shipyard_tpu_torch.workloads import checkpoint
from batch_shipyard_tpu_torch.workloads import serve
from batch_shipyard_tpu_torch.workloads import train_transformer

TINY = dict(vocab_size=32, d_model=16, n_layers=1, n_heads=2, d_head=8,
            d_ff=32)
SEQ, BATCH = 16, 4
# The resize model: tp 2 splits its heads and MLP units.
RESIZE = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=4, d_head=8,
              d_ff=64)
CLI = ["--device", "cpu", "--d-model", "16", "--n-layers", "1", "--n-heads",
       "2", "--d-ff", "32", "--vocab", "32", "--seq-len", "16", "--batch",
       "2", "--warmup", "0"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_pool_env(monkeypatch):
    for name in (preemption.PREEMPT_REQUEST_FILE_ENV, gp.GOODPUT_FILE_ENV,
                 trace_ctx.TRACE_FILE_ENV, trace_ctx.TRACE_ID_ENV,
                 trace_ctx.TRACE_SPAN_ENV, progress.PROGRESS_FILE_ENV,
                 progress.SCHED_HINTS_FILE_ENV,
                 profiling.PROFILE_REQUEST_FILE_ENV,
                 profiling.PROFILE_DIR_ENV):
        monkeypatch.delenv(name, raising=False)


def _harness(seed=0, model=TINY, **cfg):
    config = ttrain.make_transformer_config(dtype=torch.float32,
                                            max_seq_len=SEQ, **model, **cfg)
    return ttrain.build_transformer_train(config, batch_size=BATCH,
                                          seq_len=SEQ, seed=seed,
                                          device="cpu")


def _batch(seed=0, vocab=TINY["vocab_size"]):
    return train_transformer.random_batch(vocab, BATCH, SEQ, seed, "cpu")


def _trained(seed=0, steps=1):
    harness = _harness(seed)
    for _ in range(steps):
        harness.step(_batch(seed))
    return harness


def _state(harness):
    """The harness's whole state, copied: params and both moments by
    name, and AdamW's step count."""
    out = {"step": harness.optimizer_step}
    for piece, tensor in harness.state_pieces()["pieces"].items():
        out[piece.kind, piece.key, piece.lo] = tensor.clone()
    return out


def _assert_state_equal(a, b):
    assert a.keys() == b.keys()
    for key in a:
        if key == "step":
            assert a[key] == b[key]
        else:
            assert torch.equal(a[key], b[key]), key


def _cut_pieces(state, pieces):
    """Each piece cut from a global state held in memory (``state``: kind
    -> full state dict of that kind): the tensor's tp shard, flattened,
    elements [lo, hi)."""
    out = {}
    for piece in pieces:
        tensor = state[piece.kind][piece.key]
        if piece.tp_count > 1:
            tensor = tensor.chunk(piece.tp_count,
                                  sharding.tp_dim(piece.key))[piece.tp_index]
        out[piece] = tensor.reshape(-1)[piece.lo:piece.hi]
    return out


def _commit_fake(ckpt_dir, step):
    """A committed step's dir and marker, without a write."""
    os.makedirs(os.path.join(str(ckpt_dir), f"step_{step:08d}"),
                exist_ok=True)
    with open(os.path.join(str(ckpt_dir), f"step_{step:08d}."
                           + checkpoint.COMMIT_MARKER), "w") as fh:
        fh.write("ts")


# ----------------------- the reference's contracts -----------------------


def test_async_save_restores_identical_state(tmp_path):
    harness = _trained(1)
    assert checkpoint.save(str(tmp_path / "sync"), 1, harness) is not None
    with checkpoint.AsyncCheckpointManager(str(tmp_path / "async")) as mgr:
        assert mgr.save(1, harness) is not None
        mgr.wait_until_finished()
        assert checkpoint.latest_step(str(tmp_path / "async")) == 1
        assert checkpoint.is_committed(str(tmp_path / "async"), 1)
        restored = {}
        for name in ("sync", "async"):
            fresh = _harness(seed=5)
            info = (mgr.restore(fresh) if name == "async" else
                    checkpoint.restore(str(tmp_path / name), fresh))
            assert info["step"] == 1 and info["read_fraction"] == 1.0
            restored[name] = _state(fresh)
    _assert_state_equal(restored["sync"], _state(harness))
    _assert_state_equal(restored["async"], _state(harness))


def test_torn_staging_dir_is_ignored(tmp_path):
    harness = _trained(2)
    assert checkpoint.save(str(tmp_path), 3, harness) is not None
    torn = tmp_path / ".tmp_step_00000004"
    torn.mkdir()
    (torn / "rank00000.pt").write_bytes(b"torn")
    (tmp_path / "step_00000005").mkdir()  # a dir whose commit never came
    assert checkpoint.latest_step(str(tmp_path)) == 3
    fresh = _harness(seed=6)
    assert checkpoint.restore(str(tmp_path), fresh)["step"] == 3
    _assert_state_equal(_state(fresh), _state(harness))


@pytest.mark.parametrize("layout", ["strict", "legacy"])
def test_latest_step_strict_and_legacy(tmp_path, layout):
    (tmp_path / "step_00000005").mkdir()
    (tmp_path / "step_00000009").mkdir()
    if layout == "strict":
        _commit_fake(tmp_path, 5)
        assert checkpoint.latest_step(str(tmp_path)) == 5
    else:  # no marker anywhere: every step dir counts
        assert checkpoint.latest_step(str(tmp_path)) == 9
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("layout", ["marked", "legacy"])
def test_retention_gc_keeps_newest_inflight_and_unmarked(tmp_path, layout):
    if layout == "legacy":
        (tmp_path / "step_00000005").mkdir()
        (tmp_path / "step_00000009").mkdir()
        assert checkpoint.retention_gc(str(tmp_path), keep_last=1) == []
        assert checkpoint.latest_step(str(tmp_path)) == 9
        return
    for step in (1, 2, 3, 4):
        _commit_fake(tmp_path, step)
    staging = tmp_path / ".tmp_step_00000005"
    staging.mkdir()
    (tmp_path / "step_00000000").mkdir()  # unmarked: never proven
    assert checkpoint.retention_gc(str(tmp_path), keep_last=2) == [1, 2]
    assert checkpoint.latest_step(str(tmp_path)) == 4
    assert checkpoint.is_committed(str(tmp_path), 3)
    assert not checkpoint.is_committed(str(tmp_path), 1)
    assert not (tmp_path / "step_00000001").exists()
    assert staging.is_dir() and (tmp_path / "step_00000000").is_dir()
    assert checkpoint.retention_gc(str(tmp_path), keep_last=10) == []


def test_async_manager_runs_retention_in_writer(tmp_path):
    harness = _trained(3)
    with checkpoint.AsyncCheckpointManager(str(tmp_path),
                                           keep_last=2) as mgr:
        for step in (1, 2, 3):
            mgr.save(step, harness)
        mgr.wait_until_finished()
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert checkpoint.is_committed(str(tmp_path), 2)
    assert not checkpoint.is_committed(str(tmp_path), 1)
    assert not (tmp_path / "step_00000001").exists()


def test_retention_gc_removes_mesh_sidecar(tmp_path):
    harness = _trained(4)
    checkpoint.save(str(tmp_path), 1, harness)
    checkpoint.save(str(tmp_path), 2, harness)
    assert checkpoint.saved_mesh_meta(str(tmp_path), 1)["mesh_devices"] == 1
    assert checkpoint.retention_gc(str(tmp_path), keep_last=1) == [1]
    assert not os.path.exists(checkpoint._mesh_meta_path(str(tmp_path), 1))
    assert checkpoint.saved_mesh_meta(str(tmp_path), 2)["mesh_shape"] == \
        tmesh.auto_axis_sizes(1)


@pytest.mark.parametrize("path", ["sync", "async"])
def test_save_guard(tmp_path, path):
    """Sync: re-saving the restore point (or older) is skipped unless
    forced. Async: an enqueued step counts as saved before it commits."""
    harness = _trained(5)
    if path == "sync":
        assert checkpoint.save(str(tmp_path), 5, harness) is not None
        assert checkpoint.save(str(tmp_path), 5, harness) is None
        assert checkpoint.save(str(tmp_path), 3, harness) is None
        assert checkpoint.save(str(tmp_path), 5, harness,
                               force=True) is not None
        assert checkpoint.save(str(tmp_path), 6, harness) is not None
        assert checkpoint.latest_step(str(tmp_path)) == 6
        return
    with checkpoint.AsyncCheckpointManager(str(tmp_path)) as mgr:
        assert mgr.save(7, harness) is not None
        assert mgr.save(7, harness) is None
        assert mgr.save(6, harness) is None
        mgr.wait_until_finished()
        assert mgr.save(7, harness) is None
    assert checkpoint.latest_step(str(tmp_path)) == 7


def test_failed_background_save_reraises_and_keeps_latest(tmp_path,
                                                          monkeypatch):
    harness = _trained(6)
    ckpt_dir = str(tmp_path)
    assert checkpoint.save(ckpt_dir, 1, harness) is not None
    real_write = checkpoint.write_snapshot

    def torn_write(directory, snap):
        with open(os.path.join(directory, "rank00000.pt"), "wb") as fh:
            fh.write(b"torn")
        raise OSError("disk gone")

    with checkpoint.AsyncCheckpointManager(ckpt_dir) as mgr:
        monkeypatch.setattr(checkpoint, "write_snapshot", torn_write)
        assert mgr.save(2, harness) is not None  # enqueued
        with pytest.raises(OSError, match="disk gone"):
            mgr.wait_until_finished()
        assert checkpoint.latest_step(ckpt_dir) == 1
        assert not checkpoint.is_committed(ckpt_dir, 2)
        assert mgr.save(3, harness) is not None
        with pytest.raises(OSError, match="disk gone"):
            mgr.save(4, harness)
        monkeypatch.setattr(checkpoint, "write_snapshot", real_write)
        fresh = _harness(seed=7)
        assert checkpoint.restore(ckpt_dir, fresh)["step"] == 1
        assert mgr.save(2, harness) is not None  # the failed step, retried
        mgr.wait_until_finished()
    assert checkpoint.latest_step(ckpt_dir) == 2


def test_train_checkpointer_finalize_dedups(tmp_path, monkeypatch):
    persists = []
    real = checkpoint._persist

    def counting(ckpt_dir, snap):
        persists.append(snap.step)
        return real(ckpt_dir, snap)

    monkeypatch.setattr(checkpoint, "_persist", counting)
    harness = _trained(7)
    for name, use_async, steps, want in (("sync", False, 4, [2, 4]),
                                         ("async", True, 4, [2, 4]),
                                         ("odd", True, 5, [2, 4, 5])):
        persists.clear()
        tc = checkpoint.TrainCheckpointer(str(tmp_path / name), every=2,
                                          use_async=use_async)
        for step in range(steps):
            tc.step_save(step + 1, harness)
        tc.finalize(steps, harness)
        assert persists == want, name
        assert [s["step"] for s in tc.saves] == want
        assert all(s["bytes"] > 0 and s["persist_ms"] > 0 for s in tc.saves)
        assert checkpoint.latest_step(str(tmp_path / name)) == steps


def test_train_checkpointer_restore_roundtrip(tmp_path):
    harness = _trained(8)
    tc = checkpoint.TrainCheckpointer(str(tmp_path), use_async=True)
    assert tc.restore(harness) == 0 and tc.restored is None
    tc.finalize(9, harness)
    fresh = _harness(seed=9)
    tc2 = checkpoint.TrainCheckpointer(str(tmp_path), use_async=True)
    assert tc2.restore(fresh) == 9
    _assert_state_equal(_state(fresh), _state(harness))
    tc2.finalize(9, fresh)
    assert tc2.saves == []  # the guard: no duplicate write
    disabled = checkpoint.TrainCheckpointer(None)
    assert disabled.restore(harness) == 0 and not disabled.due(10)
    disabled.finalize(10, harness)


def test_async_save_records_snapshot_and_persist_phases(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv(gp.GOODPUT_FILE_ENV, str(tmp_path / "gp.jsonl"))
    monkeypatch.setenv(trace_ctx.TRACE_FILE_ENV, str(tmp_path / "tr.jsonl"))
    monkeypatch.setenv(trace_ctx.TRACE_ID_ENV, "a" * 16)
    monkeypatch.setenv(trace_ctx.TRACE_SPAN_ENV, "b" * 8)
    harness = _trained(9)
    with checkpoint.AsyncCheckpointManager(str(tmp_path / "ckpt")) as mgr:
        mgr.save(1, harness)
        mgr.wait_until_finished()
    events = {e["kind"]: e for e in map(
        json.loads, (tmp_path / "gp.jsonl").read_text().splitlines())}
    snap = events[gp.PROGRAM_CHECKPOINT_SAVE]
    persist = events[gp.PROGRAM_CHECKPOINT_ASYNC]
    assert snap["attrs"]["mode"] == "snapshot"
    assert persist["end"] >= snap["start"]
    assert snap["trace_id"] == "a" * 16 and snap["span_id"] == "b" * 8
    kinds = {(s["kind"], s["attrs"].get("overlapped")) for s in map(
        json.loads, (tmp_path / "tr.jsonl").read_text().splitlines())}
    assert kinds == {(spans.SPAN_CKPT_SNAPSHOT, None),
                     (spans.SPAN_CKPT_PERSIST, True)}


def test_reference_reads_the_ports_directory(tmp_path):
    """The control plane that reads these names is the JAX package's: after
    saves and a GC, the port's directory has the reference's names and no
    staging left, and the reference's functions see the port's steps."""
    harness = _trained(10)
    tc = checkpoint.TrainCheckpointer(str(tmp_path), every=1,
                                      use_async=True, keep_last=2)
    for step in range(1, 5):
        tc.step_save(step, harness)
    tc.finalize(4, harness)
    names = sorted(os.listdir(tmp_path))
    assert names == ["step_00000003", "step_00000003.COMMITTED",
                     "step_00000003.MESH", "step_00000004",
                     "step_00000004.COMMITTED", "step_00000004.MESH"]
    assert ref_checkpoint.latest_step(str(tmp_path)) == 4
    assert ref_checkpoint._committed_steps(str(tmp_path)) == [3, 4]
    assert ref_checkpoint.saved_mesh_meta(str(tmp_path), 4) == \
        checkpoint.saved_mesh_meta(str(tmp_path), 4)


def test_restore_plan_math_matches_the_reference():
    from batch_shipyard_tpu.parallel import restore_plan as ref_plan
    for dim, n, m in ((16, 2, 4), (16, 4, 2), (12, 3, 2), (8, 1, 8)):
        assert restore_plan.plan(dim, n, m) == {
            k: [restore_plan.ShardRead(r.shard, r.lo, r.hi, r.dst_lo)
                for r in reads]
            for k, reads in ref_plan.plan(dim, n, m).items()}
        for k in range(m):
            assert restore_plan.read_fraction(dim, n, m, k) == \
                ref_plan.read_fraction(dim, n, m, k)
    # Ragged sources (a shorter last chunk) fill the target exactly once.
    reads = restore_plan.range_reads([(0, 8), (8, 16), (16, 19)], 5, 18)
    assert [(r.shard, r.lo, r.hi, r.dst_lo) for r in reads] == [
        (0, 5, 8, 0), (1, 0, 8, 3), (2, 0, 2, 11)]


# ------------------------- resizes, ranks simulated -------------------------


class _RingSize:
    """Stands in for a ring group in a mesh made without a process group:
    building a tp shard's model needs only the ring's size."""

    def __init__(self, size):
        self.size = size


def _rank_harness(axes, world, rank, params, model=RESIZE):
    sizes = tmesh.auto_axis_sizes(world, **axes)
    groups = dict.fromkeys(tmesh.GROUP_AXES)
    if sizes["tp"] > 1:
        groups["tp"] = _RingSize(sizes["tp"])
    config = ttrain.make_transformer_config(
        dtype=torch.float32, max_seq_len=SEQ, tp_group=groups["tp"], **model)
    return ttrain.build_transformer_train(
        config, batch_size=BATCH, seq_len=SEQ, device="cpu", params=params,
        mesh=tmesh.RankMesh(sizes, rank, groups))


def _global_state(seed, model=RESIZE):
    """A random global state: the parameters and both moments."""
    config = tfm.TransformerConfig(**model)
    params = convert.init_params(config, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    return {"param": params,
            "exp_avg": {n: torch.randn(t.shape, generator=gen)
                        for n, t in params.items()},
            "exp_avg_sq": {n: torch.rand(t.shape, generator=gen)
                           for n, t in params.items()}}


def _save_simulated(ckpt_dir, axes, world, state, step, opt_step):
    """Every rank of the mesh loads its pieces of ``state`` and writes its
    file; then the commit, as one save of ``world`` ranks would."""
    staging = checkpoint._staging_path(str(ckpt_dir), step)
    os.makedirs(staging)
    for rank in range(world):
        h = _rank_harness(axes, world, rank, state["param"])
        h.load_state_pieces(_cut_pieces(state, h.held_pieces()), opt_step)
        checkpoint.write_snapshot(staging, checkpoint.snapshot(h, step))
    sizes = tmesh.auto_axis_sizes(world, **axes)
    checkpoint.commit(str(ckpt_dir), step, {"mesh_shape": sizes,
                                            "mesh_devices": world})


RESIZES = {
    "1_to_fsdp2": (({}, 1), ({"fsdp": 2}, 2)),
    "fsdp2_to_fsdp4": (({"fsdp": 2}, 2), ({"fsdp": 4}, 4)),
    "sp2fsdp2_to_tp2sp2": (({"sp": 2, "fsdp": 2}, 4), ({"tp": 2, "sp": 2},
                                                       4)),
    "tp2_to_1": (({"tp": 2}, 2), ({}, 1)),
}


@pytest.mark.parametrize("name", list(RESIZES))
def test_resize_restores_the_global_state_bit_for_bit(tmp_path, monkeypatch,
                                                      name):
    (axes_a, world_a), (axes_b, world_b) = RESIZES[name]
    state = _global_state(11)
    _save_simulated(tmp_path / "a", axes_a, world_a, state, step=5,
                    opt_step=7)
    layout = checkpoint._read_layout(checkpoint._step_path(
        str(tmp_path / "a"), 5))
    calls = []
    real_assemble = sharding.assemble

    def recording(plan, lay, fetch):
        def fetch_and_record(index, lo, hi):
            calls.append((index, lo, hi))
            return fetch(index, lo, hi)
        return real_assemble(plan, lay, fetch_and_record)

    monkeypatch.setattr(sharding, "assemble", recording)
    fsdp_only = "tp" not in axes_a and "tp" not in axes_b
    for rank in range(world_b):
        h = _rank_harness(axes_b, world_b, rank,
                          _global_state(99)["param"])  # other weights
        calls.clear()
        info = checkpoint.restore(str(tmp_path / "a"), h)
        assert info["step"] == 5 and h.optimizer_step == 7
        assert info["resharded"]
        sizes, coords = h.layout
        plan = sharding.restore_plan_for(
            types.SimpleNamespace(sizes=sizes, coords=coords), layout)
        assert calls == [(r.shard, r.lo, r.hi) for need in plan["needs"]
                         for r in need.reads]
        assert info["elements_read"] == plan["elements_read"] == sum(
            hi - lo for _, lo, hi in calls)
        fractions = info["read_fraction_by_kind"]
        if fsdp_only:  # 1/M of the params and the moments: its chunks
            n = sum(t.numel() for t in state["param"].values())
            mine = sum(p.size for p in h.held_pieces() if p.kind == "param")
            assert fractions["param"] == fractions["exp_avg"] == \
                fractions["exp_avg_sq"] == mine / n
            assert abs(fractions["param"] - 1 / sizes["fsdp"]) < 1e-3
        else:  # another tp: the split tensors read whole
            assert fractions["param"] == 1.0
        want = _cut_pieces(state, h.held_pieces())
        got = h.state_pieces()["pieces"]
        assert set(got) == set(want)
        for piece, tensor in got.items():
            assert torch.equal(tensor, want[piece]), piece
    # Mesh B's save, read back whole by one rank: the saved global state.
    _save_simulated(tmp_path / "b", axes_b, world_b, state, step=6,
                    opt_step=7)
    params, step = checkpoint.restore_params(str(tmp_path / "b"))
    assert step == 6 and set(params) == set(state["param"])
    for key, tensor in params.items():
        assert torch.equal(tensor, state["param"][key]), key
    one = _rank_harness({}, 1, 0, _global_state(98)["param"])
    checkpoint.restore(str(tmp_path / "b"), one)
    for piece, tensor in one.state_pieces()["pieces"].items():
        assert torch.equal(tensor, state[piece.kind][piece.key].reshape(-1))


def _old_layout_pieces(shapes, sizes, coords):
    """The pieces a rank held in the earlier layout: its tp shard of
    every parameter whole, and of the moments the ranges of its fsdp
    chunk of one flat bucket of every parameter (chunks of whole 16-byte
    lanes, the last one ending with the bucket)."""
    flat, offset = [], 0
    for name, shape in shapes.items():
        count = sharding.split_count(name, sizes["tp"])
        n = math.prod(sharding.shard_shape(name, shape, count))
        flat.append((name, count, coords["tp"] if count > 1 else 0, offset,
                     n))
        offset += n
    chunk = -(-offset // (4 * sizes["fsdp"])) * 4
    start = coords["fsdp"] * chunk
    pieces = [sharding.Piece(name, "param", index, count, 0, n)
              for name, count, index, _, n in flat]
    for kind in sharding.STATE_KINDS[1:]:
        for name, count, index, at, n in flat:
            lo, hi = max(at, start), min(at + n, start + chunk)
            if hi > lo:
                pieces.append(sharding.Piece(name, kind, index, count,
                                             lo - at, hi - at))
    return pieces


def _save_old_layout(ckpt_dir, axes, world, state, step, opt_step):
    """A save of ``state`` as a mesh of ``axes`` wrote it in the earlier
    layout: the parameters from fsdp index 0 only, the moments from
    every fsdp index as ranges of the flat bucket."""
    sizes = tmesh.auto_axis_sizes(world, **axes)
    shapes = {name: shape for name, (shape, _) in _rank_harness(
        {}, 1, 0, state["param"]).state_tensors().items()}
    records, flats = [], {}
    for rank in range(world):
        coords = tmesh.RankMesh(sizes, rank).coords
        if coords["dp"] or coords["ep"] or coords["sp"]:
            continue
        parts = []
        for piece in _old_layout_pieces(shapes, sizes, coords):
            if piece.kind == "param" and coords["fsdp"] or \
                    piece.tp_count == 1 and coords["tp"]:
                continue
            parts.append(_cut_pieces(state, [piece])[piece])
            records.append({**dataclasses.asdict(piece),
                            "file": checkpoint._shard_file(rank),
                            "dtype": "float32",
                            "offset": sum(t.numel() for t in parts[:-1])})
        flats[rank] = torch.cat(parts)
    staging = checkpoint._staging_path(str(ckpt_dir), step)
    os.makedirs(staging)
    for rank, flat in flats.items():
        torch.save({"float32": flat},
                   os.path.join(staging, checkpoint._shard_file(rank)))
    with open(os.path.join(staging, checkpoint.LAYOUT_FILE), "w") as fh:
        json.dump({"format": checkpoint.FORMAT, "step": step,
                   "optimizer_step": opt_step, "mesh": sizes,
                   "tensors": [{"name": name, "shape": list(shape),
                                "dtype": "float32"}
                               for name, shape in shapes.items()],
                   "records": records}, fh)
    checkpoint.commit(str(ckpt_dir), step, {"mesh_shape": sizes,
                                            "mesh_devices": world})


@pytest.mark.parametrize("axes,world", [({"sp": 2, "fsdp": 2}, 4),
                                        ({"fsdp": 4}, 4),
                                        ({"tp": 2, "fsdp": 2}, 4), ({}, 1)],
                         ids=["same_mesh", "fsdp4", "tp2_fsdp2", "one"])
def test_flat_bucket_layout_checkpoint_restores_per_unit(tmp_path, axes,
                                                         world):
    """A --sp 2 --fsdp 2 checkpoint in the earlier layout (whole
    parameters from fsdp index 0, the moments as ranges of one flat
    bucket) restores onto the per-unit layout of the same and other
    meshes: every rank's pieces are the saved global state's, bit for
    bit, and restore_params assembles it whole."""
    state = _global_state(31)
    _save_old_layout(tmp_path, {"sp": 2, "fsdp": 2}, 4, state, step=4,
                     opt_step=4)
    for rank in range(world):
        h = _rank_harness(axes, world, rank, _global_state(97)["param"])
        info = checkpoint.restore(str(tmp_path), h)
        assert info["step"] == 4 and h.optimizer_step == 4
        want = _cut_pieces(state, h.held_pieces())
        got = h.state_pieces()["pieces"]
        assert set(got) == set(want)
        for piece, tensor in got.items():
            assert torch.equal(tensor, want[piece]), (rank, piece)
    params, step = checkpoint.restore_params(str(tmp_path))
    assert step == 4
    for key, tensor in params.items():
        assert torch.equal(tensor, state["param"][key]), key


def test_every_fsdp_rank_writes_its_parameters_and_serving_reads_them(
        tmp_path):
    """An fsdp 2 save: both fsdp ranks write parameter ranges (each its
    chunks of every unit, together each element once), and
    restore_params assembles the parameters whole for serving."""
    state = _global_state(33)
    _save_simulated(tmp_path, {"fsdp": 2}, 2, state, step=2, opt_step=2)
    layout = checkpoint._read_layout(checkpoint._step_path(str(tmp_path),
                                                           2))
    params = [r for r in layout["records"] if r["kind"] == "param"]
    assert {r["file"] for r in params} == {"rank00000.pt", "rank00001.pt"}
    for name, tensor in state["param"].items():
        ranges = sorted((r["lo"], r["hi"]) for r in params
                        if r["key"] == name)
        assert ranges[0][0] == 0 and ranges[-1][1] == tensor.numel()
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    restored, step = checkpoint.restore_params(str(tmp_path))
    assert step == 2 and set(restored) == set(state["param"])
    for key, tensor in restored.items():
        assert torch.equal(tensor, state["param"][key]), key


def test_restore_refuses_another_model_shape(tmp_path):
    harness = _trained(12)
    checkpoint.save(str(tmp_path), 1, harness)
    other = _harness(model=dict(TINY, d_ff=48))
    with pytest.raises(ValueError, match="shape mismatch"):
        checkpoint.restore(str(tmp_path), other)
    fused = _harness(model=dict(TINY, d_model=16), fused_norm=True)
    with pytest.raises(ValueError, match="different model config"):
        checkpoint.restore(str(tmp_path), fused)


def test_state_pieces_roundtrip_through_load():
    """load_state_pieces writes into the live tensors (the parameters stay
    the model's), creating AdamW's state before any step as torch does,
    and the next step continues from it exactly."""
    a, b = _trained(13, steps=2), _harness(seed=14)
    params_before = [p.data_ptr() for p in b.model.parameters()]
    exported = a.state_pieces()
    b.load_state_pieces({k: v.clone() for k, v in
                         exported["pieces"].items()}, exported["step"])
    assert [p.data_ptr() for p in b.model.parameters()] == params_before
    _assert_state_equal(_state(a), _state(b))
    batch = _batch(13)
    assert float(a.step(batch)["loss"]) == float(b.step(batch)["loss"])
    _assert_state_equal(_state(a), _state(b))
    with pytest.raises(ValueError, match="do not match"):
        b.load_state_pieces({}, 0)


# --------------------------- the loop's hooks ---------------------------


def _run_main(capsys, argv):
    rc = train_transformer.main(CLI + argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_workload_records_goodput_spans_progress_and_hints(
        tmp_path, monkeypatch, capsys):
    files = {name: tmp_path / f"{name}" for name in
             ("gp.jsonl", "tr.jsonl", "progress", "hints.json")}
    monkeypatch.setenv(gp.GOODPUT_FILE_ENV, str(files["gp.jsonl"]))
    monkeypatch.setenv(trace_ctx.TRACE_FILE_ENV, str(files["tr.jsonl"]))
    monkeypatch.setenv(trace_ctx.TRACE_ID_ENV, "c" * 16)
    monkeypatch.setenv(trace_ctx.TRACE_SPAN_ENV, "d" * 8)
    monkeypatch.setenv(progress.PROGRESS_FILE_ENV, str(files["progress"]))
    monkeypatch.setenv(progress.PROGRESS_DEADLINE_ENV, "0.04")
    monkeypatch.setenv(progress.SCHED_HINTS_FILE_ENV,
                       str(files["hints.json"]))
    monkeypatch.setattr(progress, "_last_beat_at", 0.0)
    progress.seed(str(files["progress"]))
    os.utime(files["progress"], (1.0, 1.0))
    rc, report = _run_main(capsys, [
        "--steps", "5", "--warmup", "1", "--checkpoint-dir",
        str(tmp_path / "ckpt"), "--checkpoint-every", "2",
        "--async-checkpoint"])
    assert rc == 0
    assert [s["step"] for s in report["checkpoint"]["saves"]] == [2, 4, 5]
    assert os.stat(files["progress"]).st_mtime > 1.0
    assert progress.read_sched_hints(str(files["hints.json"])) == {
        "ckpt_step": 5}
    events = [json.loads(line) for line in
              files["gp.jsonl"].read_text().splitlines()]
    kinds = {e["kind"] for e in events}
    assert kinds == {gp.PROGRAM_COMPILE, gp.PROGRAM_STEP_WINDOW,
                     gp.PROGRAM_CHECKPOINT_SAVE, gp.PROGRAM_CHECKPOINT_ASYNC}
    windows = sorted((e for e in events
                      if e["kind"] == gp.PROGRAM_STEP_WINDOW),
                     key=lambda e: e["start"])
    assert [(w["attrs"]["step_start"], w["attrs"]["step_end"])
            for w in windows] == [(0, 2), (2, 4), (4, 5)]
    assert [w["attrs"]["tokens"] for w in windows] == [64, 64, 32]
    saves = [e for e in events if e["kind"] == gp.PROGRAM_CHECKPOINT_SAVE]
    for save in saves:  # a save's blocking time lies outside every window
        assert all(save["end"] <= w["start"] or save["start"] >= w["end"]
                   for w in windows)
    compile_event = next(e for e in events
                         if e["kind"] == gp.PROGRAM_COMPILE)
    assert compile_event["attrs"] == {"what": "warmup", "steps": 1}
    span_kinds = {json.loads(line)["kind"] for line in
                  files["tr.jsonl"].read_text().splitlines()}
    assert span_kinds == {spans.SPAN_CKPT_SNAPSHOT, spans.SPAN_CKPT_PERSIST}
    store = MemoryStateStore()
    assert ref_events.ingest_local_events(
        store, "pool1", str(files["gp.jsonl"]), job_id="j",
        task_id="t") == len(events)
    assert {e["kind"] for e in ref_events.query(store, "pool1")} == kinds
    assert all(e.get("trace_id") == "c" * 16
               for e in ref_events.query(store, "pool1"))
    assert ref_spans.ingest_local_spans(
        store, "pool1", str(files["tr.jsonl"]), job_id="j",
        task_id="t") == 6
    assert {s["kind"] for s in ref_spans.query(store, "pool1")} == span_kinds


@pytest.mark.parametrize("requested,steps,want", [(2, 4, (0, 2)),
                                                   (5, 2, (0, 2))])
def test_profiler_captures_the_requested_steps(tmp_path, monkeypatch, capsys,
                                               requested, steps, want):
    """A request for N steps covers [start, start + N); a loop that ends
    first is closed at the steps that ran."""
    monkeypatch.setenv(profiling.PROFILE_REQUEST_FILE_ENV,
                       str(tmp_path / "req.json"))
    monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path / "prof"))
    monkeypatch.setenv(trace_ctx.TRACE_FILE_ENV, str(tmp_path / "tr.jsonl"))
    monkeypatch.setenv(trace_ctx.TRACE_ID_ENV, "e" * 16)
    monkeypatch.setenv(trace_ctx.TRACE_SPAN_ENV, "f" * 8)
    profiling.write_request(str(tmp_path / "req.json"), requested)
    rc, _ = _run_main(capsys, ["--steps", str(steps)])
    assert rc == 0 and not (tmp_path / "req.json").exists()
    profile_spans = [json.loads(line) for line in
                     (tmp_path / "tr.jsonl").read_text().splitlines()]
    span, = profile_spans
    assert span["kind"] == spans.SPAN_PROFILE
    assert (span["attrs"]["step_start"], span["attrs"]["step_end"]) == want
    trace = json.loads(open(span["attrs"]["trace_file"]).read())
    assert os.path.dirname(span["attrs"]["trace_file"]) == \
        str(tmp_path / "prof")
    assert trace["traceEvents"]


def test_preempt_watcher_latches_once(tmp_path):
    path = str(tmp_path / "preempt.json")
    watcher = preemption.PreemptWatcher(path)
    assert watcher.configured and watcher.armed and watcher.poll() is None
    preemption.write_request(path, reason="higher priority")
    assert watcher.poll()["reason"] == "higher priority"
    assert watcher.poll() is None and not watcher.armed
    assert preemption.read_request(path)["requested_at"].endswith("Z")
    assert not preemption.PreemptWatcher().configured


# ------------------------------- serving -------------------------------


SERVE_ARGS = ["--device", "cpu", "--d-model", "32", "--n-layers", "2",
              "--n-heads", "4", "--d-ff", "64", "--vocab", "64",
              "--num-slots", "2", "--max-decode-len", "32"]


def _greedy(engine):
    rng = np.random.RandomState(3)
    out = {}
    for i in range(3):
        engine.submit(serving.Request(f"r{i}", rng.randint(
            0, 64, 5 + i).tolist(), 6))
    while engine.pending():
        for rid, tokens in engine.step():
            out[rid] = [int(t) for t in tokens]
    return out


@pytest.mark.parametrize("saved", ["tp2", "fused"])
def test_serve_checkpoint_streams_the_same_tokens(tmp_path, capsys, saved):
    """serve --checkpoint-dir of a tp 2 save (and of a fused_norm save,
    re-laid out per projection) streams the greedy tokens of an engine on
    the same parameters held in memory."""
    if saved == "tp2":
        state = _global_state(21)
        _save_simulated(tmp_path, {"tp": 2}, 2, state, step=3, opt_step=3)
        params = state["param"]
    else:
        harness = _harness(model=dict(RESIZE), fused_norm=True)
        checkpoint.save(str(tmp_path), 3, harness)
        params = convert.unfused_params(harness.model.state_dict())
    args = serve.parse_args(SERVE_ARGS + ["--checkpoint-dir", str(tmp_path)])
    engine = serve.build_engine(args)
    assert capsys.readouterr().out.strip() == \
        f"serving checkpoint step 3 from {tmp_path}"
    config = serve.build_config(args)
    memory = serving.ContinuousBatcher(
        config, {k: v.clone() for k, v in params.items()}, num_slots=2,
        max_decode_len=32, device="cpu")
    assert _greedy(engine) == _greedy(memory)


def test_serve_checkpoint_refuses_other_flags(tmp_path):
    _save_simulated(tmp_path, {}, 1, _global_state(22), step=1, opt_step=1)
    args = serve.parse_args(SERVE_ARGS + ["--d-ff", "96", "--checkpoint-dir",
                                          str(tmp_path)])
    with pytest.raises(SystemExit, match="shape mismatch"):
        serve.build_engine(args)
    args = serve.parse_args(SERVE_ARGS + ["--checkpoint-dir",
                                          str(tmp_path / "none")])
    with pytest.raises(SystemExit, match="no checkpoint found"):
        serve.build_engine(args)


def test_unfused_params_give_the_fused_models_logits():
    config = tfm.TransformerConfig(dtype=torch.float32, max_seq_len=SEQ,
                                   fused_norm=True, **RESIZE)
    fused = tfm.TransformerLM(config)
    fused.load_state_dict(convert.init_params(config,
                                              torch.Generator().manual_seed(4)))
    plain = tfm.TransformerLM(tfm.TransformerConfig(
        dtype=torch.float32, max_seq_len=SEQ, **RESIZE))
    plain.load_state_dict(convert.unfused_params(fused.state_dict()))
    tokens = _batch(4, RESIZE["vocab_size"])["tokens"]
    with torch.no_grad():
        np.testing.assert_allclose(plain(tokens).numpy(),
                                   fused(tokens).numpy(), atol=1e-5,
                                   rtol=1e-5)


# ------------------------- resume, one process -------------------------


def test_resume_through_the_harness_is_bit_for_bit(tmp_path):
    """2 steps, save, a fresh harness restores, 2 more steps: the losses
    and state bytes of 4 uninterrupted steps."""
    batch = _batch(15)
    whole = _harness(seed=15)
    want = [float(whole.step(batch)["loss"]) for _ in range(4)]
    first = _harness(seed=15)
    got = [float(first.step(batch)["loss"]) for _ in range(2)]
    checkpoint.save(str(tmp_path), 2, first)
    second = _harness(seed=16)
    assert checkpoint.restore(str(tmp_path), second)["step"] == 2
    got += [float(second.step(batch)["loss"]) for _ in range(2)]
    assert got == want
    _assert_state_equal(_state(second), _state(whole))


def test_preempted_main_exits_75_and_resumes_bit_for_bit(tmp_path,
                                                         monkeypatch, capsys):
    """chip_smoke's checkpoint phase (a) at a tiny size: the workload in
    the fused configuration with $SHIPYARD_PREEMPT_REQUEST_FILE present
    returns 75 after step 1 with step 1 committed; the rerun with --steps
    3 gives the losses of steps 2-4 of an uninterrupted run."""
    fused = ["--fused-norm", "--no-remat"]
    rc, whole = _run_main(capsys, ["--steps", "4"] + fused)
    assert rc == 0
    request = tmp_path / "preempt.json"
    preemption.write_request(str(request), reason="a higher priority job")
    monkeypatch.setenv(preemption.PREEMPT_REQUEST_FILE_ENV, str(request))
    ckpt = fused + ["--checkpoint-dir", str(tmp_path / "ckpt"),
                    "--checkpoint-every", "3"]
    rc, cut = _run_main(capsys, ["--steps", "4"] + ckpt)
    assert rc == preemption.EXIT_PREEMPTED and cut["exit"] == "preempted"
    assert cut["end_step"] == 1 and cut["losses"] == whole["losses"][:1]
    assert checkpoint._committed_steps(str(tmp_path / "ckpt")) == [1]
    assert [s["step"] for s in cut["checkpoint"]["saves"]] == [1]
    monkeypatch.delenv(preemption.PREEMPT_REQUEST_FILE_ENV)
    rc = train_transformer.main(CLI + ["--steps", "3"] + ckpt)
    lines = capsys.readouterr().out.strip().splitlines()
    resumed = json.loads(lines[-1])
    assert rc == 0 and "[proc 0/1] resumed from step 1" in lines
    assert resumed["start_step"] == 1 and resumed["end_step"] == 4
    assert resumed["checkpoint"]["restored_step"] == 1
    assert resumed["losses"] == whole["losses"][1:]
    assert resumed["per_rank"][0]["params_sha256"] == \
        whole["per_rank"][0]["params_sha256"]


def test_reference_state_carried_across_mid_run():
    """The reference's build_transformer_train (8-device CPU mesh) takes 2
    steps; its params and optax state come over (params_from_flax,
    opt_state_from_optax) and both continue 2 steps: losses within 1e-5
    relative, params within 1e-5 (test_torch_train.py's tolerances). With
    the count reset to 0 the port's params miss by far more: the bias
    correction is carried."""
    import jax
    import jax.numpy as jnp
    from batch_shipyard_tpu.parallel import mesh as jmesh
    from batch_shipyard_tpu.parallel import train as jtrain
    model = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                 d_head=16, d_ff=128)
    seq, batch = 64, 8
    rng = np.random.RandomState(1)
    tokens, targets = (rng.randint(0, 256, (batch, seq)).astype(np.int32)
                       for _ in range(2))
    mesh = jmesh.make_mesh(jmesh.auto_axis_sizes(len(jax.devices())))
    jcfg = jtrain.make_transformer_config(mesh, dtype=jnp.float32,
                                          max_seq_len=seq, **model)
    ref = jtrain.build_transformer_train(mesh, jcfg, batch_size=batch,
                                         seq_len=seq)
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    p, opt = ref.params, ref.opt_state
    for _ in range(2):
        p, opt, _ = ref.step(p, opt, jbatch)
    mid_params, mid_opt = jax.tree_util.tree_map(np.asarray, (p, opt))
    want = []
    for _ in range(2):
        p, opt, metrics = ref.step(p, opt, jbatch)
        want.append(float(metrics["loss"]))
    want_params = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, p))
    adam = mid_opt[0]
    config = ttrain.make_transformer_config(dtype=torch.float32,
                                            max_seq_len=seq, **model)
    misses = {}
    for count in (adam.count, 0):
        harness = ttrain.build_transformer_train(
            config, batch_size=batch, seq_len=seq, device="cpu",
            params=convert.params_from_flax(mid_params))
        state = convert.opt_state_from_optax(adam.mu, adam.nu, count)
        assert state["step"] == count
        state["param"] = convert.params_from_flax(mid_params)
        harness.load_state_pieces(
            _cut_pieces(state, harness.held_pieces()), state["step"])
        got = [float(harness.step({"tokens": tokens,
                                   "targets": targets})["loss"])
               for _ in range(2)]
        have = harness.model.state_dict()
        misses[int(count)] = max(float((have[n] - w).abs().max())
                                 for n, w in want_params.items())
        if int(count):
            np.testing.assert_allclose(got, want, rtol=1e-5)
    assert int(adam.count) == 2
    assert misses[2] <= 1e-5 < misses[0]


@pytest.mark.parametrize("extra,match", [({"tp": 2}, "with --tp"),
                                         ({"int8": True}, "not --int8")])
def test_fused_norm_flag_refuses_what_the_model_refuses(extra, match):
    """--fused-norm with --int8 is refused by the workload as by the
    model; --fused-norm with --tp is taken by both (the head-wise
    regrouped fused kernels), as in the reference."""
    args = types.SimpleNamespace(**dict(
        dict(tp=1, sp=1, fsdp=1, seq_len=16, batch=2, n_heads=2, d_ff=32,
             vocab=64, int8=False, fused_norm=True), **extra))

    class Ring:
        size = args.tp
    config = tfm.TransformerConfig(
        vocab_size=args.vocab, d_model=32, n_heads=args.n_heads, d_head=16,
        d_ff=args.d_ff, fused_norm=True, quantize_matmuls=args.int8,
        tp_group=Ring() if args.tp > 1 else None)
    if args.int8:
        with pytest.raises(SystemExit, match=match):
            train_transformer.check_mesh_sizes(args, args.tp)
        with pytest.raises(NotImplementedError, match="fused_norm"):
            tfm.TransformerLM(config, device="meta")
    else:
        train_transformer.check_mesh_sizes(args, args.tp)
        tfm.TransformerLM(config, device="meta")
