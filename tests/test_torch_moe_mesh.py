"""The MoE layer on the mesh (ep and the global routing over the token
ranks) on the CPU, over gloo ranks, against one rank's run on the global
batch and against the reference.

One launch of two ranks runs ``ep 2``; one launch of four runs ``dp 2 x
ep 2``, ``tp 2 x ep 2``, ``sp 2 x ep 2``, ``fsdp 2 x ep 2`` (the
workload's top-1 routing), ``dp 2 x ep 2`` with top-2 routing, ``sp 2 x
ep 2`` with expert choice, and ``dp 2 x ep 2`` with the aux weight raised
to 20 (the aux drives the router's gradient: a gradient counted once per
ep or data rank would move it by more than the tolerance, which the test
shows by the one-rank run at twice the weight). Each rank records its
first step's routing, loss and summed gradients (this rank's shard),
then two AdamW steps' losses and its state. The parent runs the port on one rank with the same weights
and batch (and the reference's build_transformer_train on one CPU device
for the first loss).

Tolerances (fp32), set before the first run: losses within 1e-5
relative; gradients within 1e-6 absolute + 1e-4 relative (the sums over
ranks run in another order than one rank's); parameters after two AdamW
steps within 1e-5 absolute; each rank's routing equal to one rank's at
its tokens, index for index.

Checkpoints: a save at ``ep 2`` restores at ``ep 1``, ``ep 4`` and ``dp
2`` with every piece equal to the saved global state, each expert
written once (ranks simulated as RankMesh(sizes, rank), no process
group, as tests/test_torch_checkpoint.py does).
"""

import concurrent.futures
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import moe as jmoe
from batch_shipyard_tpu.parallel import mesh as jmesh
from batch_shipyard_tpu.parallel import train as jtrain
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import moe as tmoe
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.parallel import mesh as tmesh
from batch_shipyard_tpu_torch.parallel import sharding
from batch_shipyard_tpu_torch.parallel import train as ttrain
from batch_shipyard_tpu_torch.workloads import checkpoint
from batch_shipyard_tpu_torch.workloads import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_TIMEOUT_S = 150
MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_head=16,
             d_ff=64)
EXPERTS, SEQ, BATCH, STEPS = 4, 16, 4, 2
HARD_AUX = 20.0
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
MESHES = {
    2: {"ep2": dict(ep=2)},
    4: {"dp2_ep2": dict(ep=2), "tp2_ep2": dict(tp=2, ep=2),
        "sp2_ep2": dict(sp=2, ep=2), "fsdp2_ep2": dict(fsdp=2, ep=2),
        "dp2_ep2_top2": dict(ep=2, moe={"num_selected": 2}),
        "sp2_ep2_expert_choice": dict(sp=2, ep=2,
                                      moe={"routing": "expert_choice"}),
        "dp2_ep2_aux": dict(ep=2, aux=HARD_AUX)},
}
# Each rank: its first step's routing, loss and summed gradients, then
# STEPS AdamW steps' losses and its state (its tp and ep shard, gathered
# over fsdp).
WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.models import moe
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import sharding, train
from batch_shipyard_tpu_torch.workloads import distributed
out, model, meshes, steps, experts = (sys.argv[1], eval(sys.argv[2]),
                                      eval(sys.argv[3]), int(sys.argv[4]),
                                      int(sys.argv[5]))
me = distributed.setup("cpu")["process_index"]
data = np.load(os.path.join(out, "batch.npz"))
tokens, targets = (torch.from_numpy(data[k]) for k in ("tokens", "targets"))
params = torch.load(os.path.join(out, "params.pt"))
results = {}
for name, axes in meshes.items():
    axes = dict(axes)
    aux, routing = axes.pop("aux", 0.01), axes.pop("moe", {})
    mesh = mesh_mod.RankMesh.build("cpu", roles=mesh_mod.MOE_ROLES, **axes)
    config = train.make_transformer_config(
        mesh=mesh, dtype=torch.float32, max_seq_len=tokens.shape[1],
        moe=moe.MoEConfig(num_experts=experts, d_model=model["d_model"],
                          d_ff=model["d_ff"], dtype=torch.float32,
                          **routing),
        moe_aux_weight=aux, **model)
    harness = train.build_transformer_train(
        config, batch_size=tokens.shape[0], seq_len=tokens.shape[1],
        device="cpu", params=params, mesh=mesh)
    local = harness.shard(tokens, targets)
    loss = harness.loss_fn(*local)
    loss.backward()
    grads, total = harness.sum_grads(loss)
    routing = harness.model.layer_1.moe.last_routing
    res = {"coords": mesh.coords, "loss0": float(total),
           "grads": grads.clone(),
           "units": [(u.name, u.params, u.length, u.fsdp)
                     for u in harness.units],
           "routing": (routing.expert, routing.position, routing.gate),
           "labels": {k: g.axis for k, g in mesh.groups.items()
                      if g is not None}}
    harness.row.zero_()
    losses = [float(harness.step({"tokens": tokens, "targets": targets})
                    ["loss"]) for _ in range(steps)]
    res["losses"], res["state"] = losses, harness.state_dict()
    mesh.close()
    results[name] = res
torch.save(results, os.path.join(out, f"rank{me}.pt"))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _moe(**routing):
    return tmoe.MoEConfig(num_experts=EXPERTS, d_model=MODEL["d_model"],
                          d_ff=MODEL["d_ff"], dtype=torch.float32, **routing)


def _batch():
    rng = np.random.RandomState(4)
    return tuple(rng.randint(0, MODEL["vocab_size"], (BATCH, SEQ)).astype(
        np.int32) for _ in range(2))


def _reference():
    """The reference's build_transformer_train with MoE on one CPU device
    (fp32): its weights and its first step's loss."""
    moe = jmoe.MoEConfig(num_experts=EXPERTS, d_model=MODEL["d_model"],
                         d_ff=MODEL["d_ff"], dtype=jnp.float32)
    mesh = jmesh.make_mesh(jmesh.auto_axis_sizes(1), jax.devices()[:1])
    jcfg = jtrain.make_transformer_config(mesh, dtype=jnp.float32,
                                          max_seq_len=SEQ, moe=moe, **MODEL)
    ref = jtrain.build_transformer_train(mesh, jcfg, batch_size=BATCH,
                                         seq_len=SEQ)
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    tokens, targets = _batch()
    _, _, metrics = ref.step(ref.params, ref.opt_state,
                             {"tokens": jnp.asarray(tokens),
                              "targets": jnp.asarray(targets)})
    return convert.params_from_flax(params), float(metrics["loss"])


def _one_rank(params, aux, routing):
    """The port on one rank, the global batch: first step's loss,
    gradients and layer 1's routing, then STEPS steps' losses and the
    state (``routing``: MoEConfig overrides as (field, value) pairs)."""
    config = ttrain.make_transformer_config(
        dtype=torch.float32, max_seq_len=SEQ, moe=_moe(**dict(routing)),
        moe_aux_weight=aux, **MODEL)
    harness = ttrain.build_transformer_train(
        config, batch_size=BATCH, seq_len=SEQ, device="cpu", params=params)
    tokens, targets = (torch.from_numpy(t) for t in _batch())
    loss = harness.loss_fn(tokens, targets)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in harness.model.named_parameters()}
    routing = harness.model.layer_1.moe.last_routing
    harness.optimizer.zero_grad(set_to_none=True)
    losses = [float(harness.step({"tokens": tokens, "targets": targets})
                    ["loss"]) for _ in range(STEPS)]
    return {"loss0": float(loss.detach()), "grads": grads,
            "routing": routing, "losses": losses,
            "state": harness.state_dict()}


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_mesh")
    params, ref_loss = _reference()
    torch.save(params, out / "params.pt")
    tokens, targets = _batch()
    np.savez(out / "batch.npz", tokens=tokens, targets=targets)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")

    def launch(world):
        where = out / f"world{world}"
        where.mkdir()
        (where / "params.pt").write_bytes((out / "params.pt").read_bytes())
        np.savez(where / "batch.npz", tokens=tokens, targets=targets)
        runs = distributed.launch_local(
            [sys.executable, "-c", WORKER, str(where), repr(MODEL),
             repr(MESHES[world]), str(STEPS), str(EXPERTS)], world,
            RANKS_TIMEOUT_S, env=env, cwd=REPO)
        bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
        assert not bad, [(r["rank"], r["returncode"], r["stderr"][-3000:])
                         for r in bad]
        return [torch.load(where / f"rank{r}.pt") for r in range(world)]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        launched = {world: pool.submit(launch, world) for world in MESHES}
        variants = {_variant(world, name) for world, name in CASES}
        one = {v: _one_rank(params, *v)
               for v in variants | {(2 * HARD_AUX, ())}}
        ranks = {world: f.result() for world, f in launched.items()}
    return {"ranks": ranks, "one": one, "ref_loss": ref_loss}


CASES = [(world, name) for world, meshes in MESHES.items()
         for name in meshes]


def _mesh(world, name):
    axes = {k: v for k, v in MESHES[world][name].items()
            if k not in ("aux", "moe")}
    return tmesh.auto_axis_sizes(world, **axes)


def _variant(world, name):
    """The one-rank run a case is held against: (aux weight, MoEConfig
    overrides as sorted pairs)."""
    case = MESHES[world][name]
    return case.get("aux", 0.01), tuple(sorted(case.get("moe", {}).items()))


def _block(sizes, coords):
    """The rows and columns of the global batch a rank at ``coords``
    trains."""
    rows = BATCH // (sizes["dp"] * sizes["fsdp"])
    width = SEQ // sizes["sp"]
    data = coords["dp"] * sizes["fsdp"] + coords["fsdp"]
    return (slice(data * rows, (data + 1) * rows),
            slice(coords["sp"] * width, (coords["sp"] + 1) * width))


def _shard(name, tensor, sizes, coords):
    """This rank's shard of a global tensor (ep, then tp)."""
    return sharding.shard_state_dict(
        {name: tensor}, types.SimpleNamespace(sizes=sizes, coords=coords)
    )[name]


def _rank_grads(ranks, world, name, res):
    """A rank's summed gradients by name (its shard), joined over the
    fsdp ranks that share its other coordinates."""
    coords = res["coords"]
    peers = sorted((r[name] for r in ranks if all(
        r[name]["coords"][a] == coords[a] for a in coords if a != "fsdp")),
        key=lambda r: r["coords"]["fsdp"])
    units = [sharding.Unit(n, p, length, fsdp)
             for n, p, length, fsdp in res["units"]]
    return sharding.join_owned(units, [r["grads"] for r in peers])


@pytest.mark.parametrize("world,name", CASES, ids=[c[1] for c in CASES])
def test_mesh_matches_one_rank(moe_runs, world, name):
    """Every rank's first loss, summed gradients, two steps' losses and
    updated parameters equal one rank's on the global batch; the first
    loss is the reference's."""
    sizes = _mesh(world, name)
    one = moe_runs["one"][_variant(world, name)]
    ranks = moe_runs["ranks"][world]
    for r in ranks:
        res = r[name]
        np.testing.assert_allclose(res["loss0"], one["loss0"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        grads = _rank_grads(ranks, world, name, res)
        for pname, g in grads.items():
            want = _shard(pname, one["grads"][pname], sizes, res["coords"])
            np.testing.assert_allclose(g.numpy(), want.numpy(),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"{name} {pname}")
        for pname, p in res["state"].items():
            want = _shard(pname, one["state"][pname], sizes, res["coords"])
            np.testing.assert_allclose(p.numpy(), want.numpy(),
                                       atol=PARAM_ATOL, rtol=0,
                                       err_msg=f"{name} {pname}")
    if _variant(world, name) == (0.01, ()):
        np.testing.assert_allclose(one["loss0"], moe_runs["ref_loss"],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("world,name", CASES, ids=[c[1] for c in CASES])
def test_routing_is_one_ranks_at_every_ranks_tokens(moe_runs, world, name):
    """Layer 1's routing (the first MoE layer) on each rank is one rank's
    routing of the global batch at that rank's tokens: experts and slots
    index for index, gates within fp32 rounding of the router's input."""
    sizes = _mesh(world, name)
    whole = moe_runs["one"][_variant(world, name)]["routing"]
    for r in moe_runs["ranks"][world]:
        rows, cols = _block(sizes, r[name]["coords"])
        expert, position, gate = r[name]["routing"]

        def at(t):
            return t.view(BATCH, SEQ, -1)[rows, cols].reshape(
                -1, t.shape[-1])
        assert torch.equal(expert, at(whole.expert))
        assert torch.equal(position, at(whole.position))
        np.testing.assert_allclose(gate.numpy(), at(whole.gate).numpy(),
                                   atol=1e-6, rtol=1e-5)
    assert (whole.position < 0).any()  # tokens dropped: the prefix matters


def test_the_hard_aux_case_tells_a_miscounted_aux_apart(moe_runs):
    """At aux weight 20 the router's gradient at twice the weight (what
    an aux counted once per ep or data rank of two would give) sits far
    outside the gradient tolerance, so test_mesh_matches_one_rank's
    dp2_ep2_aux case fails if the aux is counted n_ep or n_data times."""
    one, two = (moe_runs["one"][HARD_AUX, ()],
                moe_runs["one"][2 * HARD_AUX, ()])
    name = "layer_1.moe.router.weight"
    diff = (one["grads"][name] - two["grads"][name]).abs()
    bound = GRAD_ATOL + GRAD_RTOL * one["grads"][name].abs()
    assert (diff > 100 * bound).any()


def test_ranks_hold_the_ep_and_tokens_rings(moe_runs):
    """dp 2 x ep 2: the ep ring is labelled "ep"; the token ranks are the
    data ring's, and that one ring serves both ("data+tokens"). sp 2 x ep
    2: the sp ring is the data and the tokens ring too."""
    for r in moe_runs["ranks"][4]:
        labels = r["dp2_ep2"]["labels"]
        assert labels["ep"] == "ep"
        assert labels["data"] == labels["tokens"] == "data+tokens"
        assert r["sp2_ep2"]["labels"]["tokens"] == "sp+data+tokens"
        assert r["sp2_ep2"]["labels"]["sp"] == "sp+data+tokens"
        assert r["fsdp2_ep2"]["labels"]["tokens"] == "fsdp+tokens"


def test_train_cli_moe_ep_on_cpu():
    """`--moe-experts 4 --ep 2 --sp 2` as four local ranks of the
    workload: the loss falls, every rank's experts digest is its ep
    index's, and the replicated digest is every rank's."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local([
        sys.executable, "-m",
        "batch_shipyard_tpu_torch.workloads.train_transformer", "--ep", "2",
        "--sp", "2", "--moe-experts", "4", "--device", "cpu", "--d-model",
        "32", "--n-layers", "2", "--n-heads", "2", "--d-ff", "64", "--vocab",
        "64", "--seq-len", "32", "--batch", "2", "--steps", "3", "--warmup",
        "0"], 4, RANKS_TIMEOUT_S, env=env, cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["stderr"][-2000:]) for r in bad]
    report = json.loads(runs[0]["stdout"].strip().splitlines()[-1])
    sizes = {"dp": 1, "fsdp": 1, "ep": 2, "sp": 2, "tp": 1}
    assert report["mesh"] == sizes
    assert report["losses"][-1] < report["losses"][0]
    ranks = report["per_rank"]
    for rank, r in enumerate(ranks):
        coords = tmesh.RankMesh(sizes, rank).coords
        assert r["coords"] == coords
        assert r["params_sha256"]["replicated"] == \
            ranks[0]["params_sha256"]["replicated"]
        same_ep = [q for q in ranks if q["coords"]["ep"] == coords["ep"]]
        assert all(q["params_sha256"]["ep_shard"] ==
                   r["params_sha256"]["ep_shard"] for q in same_ep)
        assert list(r["moe_dropped_share"]) == ["layer_1"]
    assert ranks[0]["params_sha256"]["ep_shard"] != \
        ranks[2]["params_sha256"]["ep_shard"]


# ------------------------------ checkpoints ------------------------------


class _Ring:
    """A stand-in ring of ``size`` ranks (the harness reads only the size
    and rank before a forward)."""

    def __init__(self, size, rank=0):
        self.size, self.rank = size, rank


def _rank_harness(axes, world, rank, params):
    sizes = tmesh.auto_axis_sizes(world, **axes)
    coords = tmesh.RankMesh(sizes, rank).coords
    groups = dict.fromkeys(tmesh.GROUP_AXES)
    if sizes["ep"] > 1:
        groups["ep"] = _Ring(sizes["ep"], coords["ep"])
    config = ttrain.make_transformer_config(
        dtype=torch.float32, max_seq_len=SEQ, moe=_moe(),
        ep_group=groups["ep"], **MODEL)
    return ttrain.build_transformer_train(
        config, batch_size=BATCH, seq_len=SEQ, device="cpu", params=params,
        mesh=tmesh.RankMesh(sizes, rank, groups))


def _global_state(seed):
    config = tfm.TransformerConfig(moe=_moe(), **MODEL)
    params = convert.init_params(config, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    return {"param": params,
            "exp_avg": {n: torch.randn(t.shape, generator=gen)
                        for n, t in params.items()},
            "exp_avg_sq": {n: torch.rand(t.shape, generator=gen)
                           for n, t in params.items()}}


def _cut(state, pieces):
    """Each piece from the global state: the tensor's ep shard, its tp
    shard, flattened, [lo, hi)."""
    out = {}
    for piece in pieces:
        tensor = state[piece.kind][piece.key]
        if piece.ep_count > 1:
            tensor = sharding.take_ep_shard(piece.key, tensor,
                                            piece.ep_count, piece.ep_index)
        if piece.tp_count > 1:
            tensor = sharding.take_shard(piece.key, tensor, piece.tp_count,
                                         piece.tp_index)
        out[piece] = tensor.reshape(-1)[piece.lo:piece.hi]
    return out


@pytest.mark.parametrize("target", [({}, 1), ({"ep": 4}, 4), ({}, 2)],
                         ids=["ep1", "ep4", "dp2"])
def test_checkpoint_saved_at_ep2_resumes_at_another_ep(tmp_path, target):
    """A save of two ep ranks (each writing its own two experts) restores
    on one rank, on four ep ranks (one expert each) and on two dp ranks
    (every expert on each), every piece equal to the saved global state;
    every element of every tensor is written exactly once."""
    state = _global_state(21)
    step, staging = 3, checkpoint._staging_path(str(tmp_path), 3)
    os.makedirs(staging)
    for rank in range(2):
        h = _rank_harness({"ep": 2}, 2, rank, state["param"])
        h.load_state_pieces(_cut(state, h.held_pieces()), 5)
        checkpoint.write_snapshot(staging, checkpoint.snapshot(h, step))
    checkpoint.commit(str(tmp_path), step,
                      {"mesh_shape": tmesh.auto_axis_sizes(2, ep=2),
                       "mesh_devices": 2})
    layout = checkpoint._read_layout(checkpoint._step_path(str(tmp_path),
                                                           step))
    written = {}
    for rec in layout["records"]:
        written.setdefault((rec["key"], rec["kind"]), []).append(rec)
    for (key, kind), recs in written.items():
        n = int(np.prod(next(t["shape"] for t in layout["tensors"]
                             if t["name"] == key)))
        assert sum(r["hi"] - r["lo"] for r in recs) == n, (key, kind)
        shards = {(r["ep_index"], r["tp_index"]) for r in recs}
        assert len(shards) == recs[0]["ep_count"] * recs[0]["tp_count"]
        writers = {0, 1} if recs[0]["ep_count"] == 2 else {0}
        assert {r["file"] for r in recs} == {
            checkpoint._shard_file(w) for w in writers}, key
    axes, world = target
    for rank in range(world):
        h = _rank_harness(axes, world, rank, _global_state(77)["param"])
        info = checkpoint.restore(str(tmp_path), h)
        assert info["step"] == step and h.optimizer_step == 5
        want = _cut(state, h.held_pieces())
        got = h.state_pieces()["pieces"]
        assert set(got) == set(want)
        for piece, tensor in got.items():
            assert torch.equal(tensor, want[piece]), piece
    params, _ = checkpoint.restore_params(str(tmp_path))
    for key, tensor in params.items():
        assert torch.equal(tensor, state["param"][key]), key
