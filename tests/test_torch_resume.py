"""Checkpoints across processes on the CPU (gloo ranks through
workloads/distributed.launch_local, both launches in one module fixture):

- four ranks on the mesh ``--sp 2 --fsdp 2``: 4 uninterrupted steps; 2
  steps and a save; a fresh harness on the same mesh restores and takes
  2 more steps, which must give the uninterrupted run's losses and state
  bytes; one on ``--sp 2 --tp 2`` restores the same step (resharded:
  the q/k/v/gate/up rows, o/down columns and the embedding's vocabulary
  rows split), must hold the saved parameters' tp shards bit for bit and
  stay within the 2e-3 relative that tests/test_torch_mesh.py allows
  between meshes;
- four ranks of the fused_norm model on ``--tp 2`` (dp 2): 2 steps, a
  save, 2 more; then restored on one rank's whole model (dp 4, tp 1) and
  on ``--sp 2 --tp 2``: the saved parameters bit for bit (the fused
  kernels regrouped head-wise and back), then 2 steps within 2^-8
  relative of the uninterrupted run's;
- two ranks of the workload (``--sp 2``) where only rank 1's preempt
  request file exists: both must exit 75 at the same step boundary, with
  that one step committed.
"""

import json
import os
import sys
import threading

import numpy as np
import pytest
import torch

from batch_shipyard_tpu_torch.agent import preemption
from batch_shipyard_tpu_torch.parallel import sharding
from batch_shipyard_tpu_torch.workloads import checkpoint
from batch_shipyard_tpu_torch.workloads import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_TIMEOUT_S = 240
MODEL = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4, d_head=32,
             d_ff=256)
SEQ, BATCH = 64, 4
MESH_A, MESH_B = {"sp": 2, "fsdp": 2}, {"sp": 2, "tp": 2}
MESH_RTOL = 2e-3
# The fused_norm checkpoint's meshes: saved on tp 2, restored on each.
FUSED_MESHES = {"save": {"tp": 2}, "tp1": {}, "sp2_tp2": {"sp": 2, "tp": 2}}
RESIZED_RTOL = 2.0 ** -8

# A rank of the four-rank runs; its results are saved for the parent.
MESH_WORKER = r"""
import os, sys
import torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod, train
from batch_shipyard_tpu_torch.workloads import (checkpoint, distributed,
                                                train_transformer)
out, model, seq, batch_size = (sys.argv[1], eval(sys.argv[2]),
                               int(sys.argv[3]), int(sys.argv[4]))
mesh_a, mesh_b = eval(sys.argv[5]), eval(sys.argv[6])
me = distributed.setup("cpu")["process_index"]
batch = train_transformer.random_batch(model["vocab_size"], batch_size, seq,
                                       0, "cpu")
ckpt = os.path.join(out, "ckpt")


def harness(axes, seed):
    mesh = mesh_mod.RankMesh.build("cpu", **axes)
    config = train.make_transformer_config(
        mesh=mesh, dtype=torch.float32, max_seq_len=seq, **model)
    return mesh, train.build_transformer_train(
        config, batch_size=batch_size, seq_len=seq, seed=seed, device="cpu",
        mesh=mesh)


def steps(h, n):
    return [float(h.step(batch)["loss"]) for _ in range(n)]


def state(h):
    pieces = h.state_pieces()
    return pieces["step"], {p: t.clone() for p, t in pieces["pieces"].items()}


def params(mesh, h):
    return mesh.coords, {n: t.clone() for n, t in
                         h.model.state_dict().items()}


res = {}
mesh, h = harness(mesh_a, 0)
res["whole"], res["whole_state"] = steps(h, 4), state(h)
mesh.close()
mesh, h = harness(mesh_a, 0)
res["first"] = steps(h, 2)
checkpoint.save(ckpt, 2, h)
res["saved_params"] = params(mesh, h)
mesh.close()
for name, axes in (("same", mesh_a), ("resized", mesh_b)):
    mesh, h = harness(axes, 1)
    res[name + "_info"] = checkpoint.restore(ckpt, h)
    res[name + "_params"] = params(mesh, h)
    res[name] = steps(h, 2)
    res[name + "_state"] = state(h)
    mesh.close()
torch.save(res, os.path.join(out, f"rank{me}.pt"))
"""

# A rank of the four-rank fused_norm runs: saved on tp 2, restored on
# tp 1 and on sp 2 x tp 2.
FUSED_WORKER = MESH_WORKER.split("res = {}")[0].replace(
    "**model)", "fused_norm=True, **model)") + r"""
meshes = mesh_a
ckpt = os.path.join(out, "fused_ckpt")
res = {}
mesh, h = harness(meshes["save"], 0)
res["first"] = steps(h, 2)
checkpoint.save(ckpt, 2, h)
res["saved_params"] = params(mesh, h)
res["whole"] = steps(h, 2)
mesh.close()
for name in ("tp1", "sp2_tp2"):
    mesh, h = harness(meshes[name], 1)
    res[name + "_info"] = checkpoint.restore(ckpt, h)
    res[name + "_params"] = params(mesh, h)
    res[name] = steps(h, 2)
    mesh.close()
torch.save(res, os.path.join(out, f"fused_rank{me}.pt"))
"""

# A rank of the workload whose preempt request file is its own.
PREEMPT_WORKER = r"""
import os, sys
os.environ["SHIPYARD_PREEMPT_REQUEST_FILE"] = os.path.join(
    sys.argv[1], "preempt%s.json" % os.environ["RANK"])
from batch_shipyard_tpu_torch.workloads import train_transformer
sys.exit(train_transformer.main(sys.argv[2:]))
"""


def _launch(argv, nprocs, into, key):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    into[key] = distributed.launch_local(argv, nprocs, RANKS_TIMEOUT_S,
                                         env=env, cwd=REPO)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three launches, side by side: the four mesh ranks' results, the
    four fused ranks' and the two preempted workload ranks' outputs."""
    out = tmp_path_factory.mktemp("resume")
    preempt = out / "preempt"
    preempt.mkdir()
    preemption.write_request(str(preempt / "preempt1.json"),
                             reason="only rank 1 is asked")
    launched = {}
    threads = [
        threading.Thread(target=_launch, args=(
            [sys.executable, "-c", MESH_WORKER, str(out), repr(MODEL),
             str(SEQ), str(BATCH), repr(MESH_A), repr(MESH_B)], 4,
            launched, "mesh")),
        threading.Thread(target=_launch, args=(
            [sys.executable, "-c", FUSED_WORKER, str(out), repr(MODEL),
             str(SEQ), str(BATCH), repr(FUSED_MESHES), "None"], 4,
            launched, "fused")),
        threading.Thread(target=_launch, args=(
            [sys.executable, "-c", PREEMPT_WORKER, str(preempt), "--sp", "2",
             "--device", "cpu", "--d-model", "32", "--n-layers", "1",
             "--n-heads", "2", "--d-ff", "64", "--vocab", "64", "--seq-len",
             "32", "--batch", "2", "--warmup", "0", "--steps", "4",
             "--checkpoint-dir", str(preempt / "ckpt"),
             "--checkpoint-every", "3"], 2, launched, "preempt")),
    ]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    bad = [(r["rank"], r["returncode"], r["stderr"][-3000:])
           for key in ("mesh", "fused") for r in launched[key]
           if r["returncode"] or r["timed_out"]]
    assert not bad, bad
    return {"mesh": [torch.load(out / f"rank{r}.pt", weights_only=False)
                     for r in range(4)],
            "fused": [torch.load(out / f"fused_rank{r}.pt",
                                 weights_only=False) for r in range(4)],
            "preempt": launched["preempt"], "preempt_dir": preempt}


def test_same_mesh_resume_is_bit_for_bit(runs):
    for rank, res in enumerate(runs["mesh"]):
        assert res["first"] == res["whole"][:2], rank
        assert res["same"] == res["whole"][2:], rank
        assert not res["same_info"]["resharded"]
        assert res["same_info"]["read_fraction"] == pytest.approx(
            1 / 3 + 2 / 3 / 2, rel=1e-3)  # params whole, 1/2 the moments
        step, pieces = res["same_state"]
        want_step, want = res["whole_state"]
        assert step == want_step == 4
        assert pieces.keys() == want.keys()
        for piece, tensor in pieces.items():
            assert torch.equal(tensor, want[piece]), (rank, piece)


def test_resized_resume_is_within_the_mesh_tolerance(runs):
    for rank, res in enumerate(runs["mesh"]):
        info = res["resized_info"]
        assert info["resharded"] and info["step"] == 2
        assert info["saved_mesh"]["fsdp"] == 2 and info["read_fraction"] == 1
        np.testing.assert_allclose(res["resized"], res["whole"][2:],
                                   rtol=MESH_RTOL)
        step, pieces = res["resized_state"]
        assert step == 4
        assert all(p.tp_count == 2 for p in pieces
                   if sharding.tp_dim(p.key) is not None)


def _saved_params(ranks):
    """The saved parameters, whole: the tp shards of the ranks at dp, fsdp
    and sp index 0 joined in tp order."""
    shards = sorted((r["saved_params"] for r in ranks
                     if not any(r["saved_params"][0][a]
                                for a in ("dp", "fsdp", "sp"))),
                    key=lambda s: s[0]["tp"])
    return sharding.gather_state_dict([state for _, state in shards])


def _assert_restored_bit_for_bit(ranks, name):
    """Every rank's parameters right after the restore: the saved ones'
    tp shard of its tp index (parallel/sharding.take_shard: the fused
    kernels regrouped head-wise), bit for bit."""
    saved = _saved_params(ranks)
    for rank, res in enumerate(ranks):
        coords, state = res[name + "_params"]
        assert state.keys() == saved.keys()
        for pname, tensor in state.items():
            want = saved[pname]
            if sharding.tp_dim(pname) is not None and \
                    tensor.shape != want.shape:
                want = sharding.take_shard(pname, want, 2, coords["tp"])
            assert torch.equal(tensor, want), (rank, name, pname)


def test_tp1_checkpoint_restores_onto_the_vocab_split_embedding(runs):
    """The --sp 2 --fsdp 2 save restored on --sp 2 --tp 2: each rank holds
    its tp shard of the saved parameters bit for bit, the embedding's
    vocabulary rows among them."""
    _assert_restored_bit_for_bit(runs["mesh"], "resized")
    for res in runs["mesh"]:
        coords, state = res["resized_params"]
        assert state["embed.embedding"].shape[0] == MODEL["vocab_size"] // 2


@pytest.mark.parametrize("name", ["tp1", "sp2_tp2"])
def test_fused_tp2_checkpoint_restores_on_other_meshes(runs, name):
    """The fused_norm model saved on --tp 2 (dp 2), restored on tp 1 (dp
    4) and on --sp 2 --tp 2: the saved parameters bit for bit, resharded,
    and the next two losses within 2^-8 relative of the uninterrupted
    run's."""
    ranks = runs["fused"]
    _assert_restored_bit_for_bit(ranks, name)
    for res in ranks:
        info = res[name + "_info"]
        assert info["resharded"] and info["step"] == 2
        assert info["saved_mesh"]["tp"] == 2
        np.testing.assert_allclose(res[name], res["whole"],
                                   rtol=RESIZED_RTOL)
        coords, state = res[name + "_params"]
        assert "layer_0.attn.qkv_kernel" in state


def test_ranks_agree_on_preemption(runs):
    """Only rank 1 sees a request; both drain at step 1 and exit 75, and
    step 1 is the one committed step."""
    results = runs["preempt"]
    assert [r["returncode"] for r in results] == \
        [preemption.EXIT_PREEMPTED] * 2, [r["stderr"][-2000:]
                                          for r in results]
    report = json.loads(results[0]["stdout"].strip().splitlines()[-1])
    assert report["exit"] == "preempted" and report["end_step"] == 1
    assert report["mesh"]["sp"] == 2 and len(report["losses"]) == 1
    ckpt = str(runs["preempt_dir"] / "ckpt")
    assert checkpoint._committed_steps(ckpt) == [1]
    assert checkpoint.saved_mesh_meta(ckpt, 1)["mesh_devices"] == 2
    assert not (runs["preempt_dir"] / "preempt0.json").exists()
