"""The port's training mesh (parallel/mesh.RankMesh, parallel/sharding,
the Megatron operators of models/transformer, the mesh step of
parallel/train and ops/ring_collectives.ring_all_reduce) against the JAX
reference on the CPU.

Eight gloo ranks run every mesh in turn in one launch (``mesh_runs``, a
module fixture): the reference's own configurations of
tests/test_models_train.py ({"dp": 2, "tp": 4}, {"dp": 2, "sp": 2, "tp":
2}, {"fsdp": 4, "tp": 2}), dp = 8, and dp x fsdp x sp = 2 x 2 x 2. On the
same flax weights and batch as the reference's build_transformer_train
on the matching 8-device CPU mesh, two AdamW steps must agree in the
loss within 1e-5 relative and in every gathered weight within 1e-5
absolute (tests/test_torch_train.py's tolerances: fp32 on both sides,
only the order of the sums differs). Port dp = 8 and tp 2 x sp 2 must
agree over three steps within the reference's own 2e-3
(tests/test_models_train.py test_parallelism_configs_agree). The batch
is that test's (seed 1), whose smallest gradient element stays clear of
Adam's eps.
"""

import argparse
import json
import math
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu.parallel import mesh as jmesh
from batch_shipyard_tpu.parallel import sharding as jsharding
from batch_shipyard_tpu.parallel import train as jtrain
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.ops import ring_collectives as rc
from batch_shipyard_tpu_torch.parallel import mesh as tmesh
from batch_shipyard_tpu_torch.parallel import sharding as tsharding
from batch_shipyard_tpu_torch.parallel import train as ttrain
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 8
RANKS_TIMEOUT_S = 300
MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_head=16,
             d_ff=128)
SEQ, BATCH, STEPS = 64, 8, 3
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
# name -> the reference's axis sizes (dp fills the rest of 8).
MESHES = {
    "dp2_tp4": {"tp": 4},
    "dp2_sp2_tp2": {"sp": 2, "tp": 2},
    "fsdp4_tp2": {"fsdp": 4, "tp": 2},
    "dp8": {},
    "dp2_fsdp2_sp2": {"sp": 2, "fsdp": 2},
}
REFERENCE_MESHES = ("dp2_tp4", "dp2_sp2_tp2", "fsdp4_tp2", "dp2_fsdp2_sp2")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sizes(axes):
    return tmesh.auto_axis_sizes(WORLD, **axes)


def _batch():
    rng = np.random.RandomState(1)
    return (rng.randint(0, MODEL["vocab_size"], (BATCH, SEQ)).astype(np.int32),
            rng.randint(0, MODEL["vocab_size"], (BATCH, SEQ)).astype(np.int32))


# ------------------------------ the layout --------------------------------


def _factorisations():
    for tp in (1, 2, 4, 8):
        for sp in (1, 2, 4, 8):
            for fsdp in (1, 2, 4, 8):
                if WORLD % (tp * sp * fsdp) == 0:
                    yield {"tp": tp, "sp": sp, "fsdp": fsdp}


@pytest.mark.parametrize("axes", list(_factorisations()),
                         ids=lambda a: "tp{tp}_sp{sp}_fsdp{fsdp}".format(**a))
def test_mesh_coordinates_and_groups_match_reference_mesh(axes):
    """Every factorisation of 8: a rank's coordinates are its device's
    place in the reference's make_mesh grid (tp innermost), and each
    group holds exactly the ranks that differ from it only on the
    group's axes, ascending."""
    sizes = _sizes(axes)
    devices = jax.devices()
    grid = jmesh.make_mesh(jmesh.auto_axis_sizes(8, **axes), devices).devices
    for rank in range(WORLD):
        layout = tmesh.RankMesh(sizes, rank)
        where = tuple(int(i) for i in np.argwhere(grid == devices[rank])[0])
        assert tuple(layout.coords[a] for a in tmesh.AXES) == where
        assert layout.data_index == (layout.coords["dp"] * sizes["fsdp"] +
                                     layout.coords["fsdp"])
    for name, group_axes in tmesh.GROUP_AXES.items():
        groups = tmesh.axis_groups(sizes, group_axes)
        assert sorted(r for g in groups for r in g) == list(range(WORLD))
        assert all(len(g) == math.prod(sizes[a] for a in group_axes)
                   for g in groups)
        for g in groups:
            assert g == sorted(g)
            coords = [tmesh.RankMesh(sizes, r).coords for r in g]
            for axis in tmesh.AXES:
                if axis not in group_axes:
                    assert len({c[axis] for c in coords}) == 1, (name, g)


def test_mesh_layout_refuses_a_rank_outside_the_world():
    with pytest.raises(ValueError, match="outside a world of 8"):
        tmesh.RankMesh(_sizes({"tp": 2}), 8)
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.auto_axis_sizes(8, tp=3)


# --------------------------- sharding rules -------------------------------


class _Ring:
    """A stand-in tp group for building a model's local shapes."""

    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_shard_and_gather_state_dict_round_trip(tp):
    """shard_state_dict gives each tp rank the shapes its model builds
    (rows of q/k/v/gate/up, columns of o/down, the rest whole), and
    gather_state_dict puts the shards back together bit for bit."""
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **MODEL)
    state = convert.init_params(cfg, torch.Generator().manual_seed(3))
    sizes = _sizes({"tp": tp})
    shards = [tsharding.shard_state_dict(state, tmesh.RankMesh(sizes, r))
              for r in range(tp)]
    local = ttfm.TransformerLM(
        ttfm.TransformerConfig(dtype=torch.float32,
                               tp_group=_Ring(tp) if tp > 1 else None,
                               **MODEL), device="meta").state_dict()
    for shard in shards:
        assert {n: tuple(t.shape) for n, t in shard.items()} == \
            {n: tuple(t.shape) for n, t in local.items()}
    full = tsharding.gather_state_dict(shards)
    assert set(full) == set(state)
    for name, tensor in state.items():
        assert torch.equal(full[name], tensor), name
    if tp > 1:
        q = state["layer_0.attn.q_proj.weight"]
        assert torch.equal(shards[1]["layer_0.attn.q_proj.weight"],
                           q[q.shape[0] // tp:2 * q.shape[0] // tp])
        o = state["layer_1.attn.o_proj.weight"]
        assert torch.equal(shards[1]["layer_1.attn.o_proj.weight"],
                           o[:, o.shape[1] // tp:2 * o.shape[1] // tp])


def test_sharding_rules_are_the_references():
    """The port's rules give every parameter the reference's
    PartitionSpec (flax path <-> state-dict name), and tp splits the
    torch dim that holds the flax dim the spec puts tp on."""
    cfg = jtfm.TransformerConfig(max_seq_len=16, **MODEL)
    params = jax.eval_shape(lambda: jtfm.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    specs = jsharding.transformer_param_specs(params)
    flat = {jsharding._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(specs)[0]}
    for path, spec in flat.items():
        name = path.replace("/kernel", "/weight").replace("/", ".")
        rule = next(r for r in tsharding.TRANSFORMER_RULES
                    if re.match(r[0], name))
        assert rule[1] == spec, (path, rule, spec)
        dim = tsharding.tp_dim(name)
        assert (dim is None) == ("tp" not in spec), path
        if dim is not None:
            # flax [in, out] -> torch [out, in]: the transpose's dim; the
            # embedding's [vocab, d] is not transposed.
            assert dim == (spec.index("tp") if name.endswith("embedding")
                           else 1 - spec.index("tp")), path
    assert tsharding.tp_dim("embed.embedding") == 0  # vocab-parallel
    # The fused kernels keep flax's [in, out] layout: tp splits dim 1.
    assert tsharding.tp_dim("layer_0.attn.qkv_kernel") == 1


# ----------------------------- clear errors --------------------------------


@pytest.mark.parametrize("field,value,match", [
    ("n_heads", 6, "n_heads=6 is not divisible by tp=4"),
    ("d_ff", 130, "d_ff=130 is not divisible by tp=4"),
])
def test_tp_refuses_indivisible_model(field, value, match):
    model = dict(MODEL, **{field: value})
    with pytest.raises(ValueError, match=match):
        ttfm.TransformerLM(ttfm.TransformerConfig(tp_group=_Ring(4),
                                                  **model), device="meta")


@pytest.mark.parametrize("flag", ["fused_norm", "quantize_matmuls", "decode"])
def test_tp_refuses_fused_int8_and_decode(flag):
    """Under tp the decode path is refused; fused_norm and
    quantize_matmuls build, each rank with its local heads, ff units and
    vocabulary rows (a QuantDense told which side tp splits)."""
    cfg = ttfm.TransformerConfig(tp_group=_Ring(2), **{flag: True}, **MODEL)
    if flag == "decode":
        with pytest.raises(NotImplementedError,
                           match="tp_group is a training-path"):
            ttfm.TransformerLM(cfg, device="meta")
        return
    model = ttfm.TransformerLM(cfg, device="meta")
    assert model.embed.embedding.shape == (MODEL["vocab_size"] // 2,
                                           MODEL["d_model"])
    block = model.layer_0
    if flag == "fused_norm":
        features = MODEL["n_heads"] * MODEL["d_head"] // 2
        assert block.attn.qkv_kernel.shape == (MODEL["d_model"],
                                               3 * features)
        assert block.mlp.gate_up_kernel.shape == (MODEL["d_model"],
                                                  MODEL["d_ff"])
    else:
        assert isinstance(block.attn.q_proj, ttfm.QuantDense)
        assert (block.attn.q_proj.split, block.attn.o_proj.split,
                block.mlp.down_proj.split) == ("column", "row", "row")


def test_shard_state_dict_refuses_fused_kernels():
    """A fused state dict shards over tp (the head-wise regroup) and
    gathers back bit for bit; a fused width tp cannot split per part is
    refused."""
    cfg = ttfm.TransformerConfig(fused_norm=True, d_model=128, **{
        k: v for k, v in MODEL.items() if k != "d_model"})
    state = convert.init_params(cfg, torch.Generator().manual_seed(0))
    shards = [tsharding.shard_state_dict(
        state, tmesh.RankMesh(_sizes({"tp": 2}), r)) for r in range(2)]
    full = tsharding.gather_state_dict(shards)
    assert all(torch.equal(full[n], t) for n, t in state.items())
    odd = dict(state, **{"layer_0.mlp.gate_up_kernel":
                         torch.zeros(128, 2 * 65)})
    with pytest.raises(ValueError, match="not divisible by tp=2"):
        tsharding.shard_state_dict(odd, tmesh.RankMesh(_sizes({"tp": 2}), 0))


@pytest.mark.parametrize("flags,world,match", [
    (["--tp", "3"], 8, "8 ranks are not divisible by tp \\* sp \\* fsdp = 3"),
    (["--sp", "2", "--seq-len", "15"], 2, "--seq-len 15 is not divisible by "
                                          "--sp = 2"),
    (["--fsdp", "2", "--batch", "6"], 8, "--batch 6 is not divisible by "
                                         "dp \\* fsdp = 8"),
    (["--tp", "2", "--n-heads", "3", "--d-model", "24"], 2,
     "--n-heads 3 is not divisible by --tp = 2"),
    (["--tp", "4", "--d-ff", "66"], 4, "--d-ff 66 is not divisible by "
                                       "--tp = 4"),
    (["--tp", "2", "--vocab", "33"], 2, "--vocab 33 is not divisible by "
                                        "--tp = 2"),
])
def test_workload_refuses_sizes_it_cannot_split(flags, world, match):
    args = argparse.Namespace(tp=1, sp=1, fsdp=1, ep=1, moe_experts=0,
                              seq_len=16, batch=8, n_heads=4, d_ff=64,
                              vocab=64, int8=False, fused_norm=False)
    it = iter(flags)
    for flag in it:
        setattr(args, flag[2:].replace("-", "_"),
                True if flag == "--int8" else int(next(it)))
    with pytest.raises(SystemExit, match=match):
        train_transformer.check_mesh_sizes(args, world)


def test_all_reduce_pads_to_whole_lanes_of_every_member():
    assert rc.all_reduce_lanes(37, torch.float32, 2) == 40
    assert rc.all_reduce_lanes(40, torch.float32, 2) == 40
    assert rc.all_reduce_lanes(50, torch.bfloat16, 4) == 64
    # The gradient row: the owned gradients and the loss slot, padded to
    # whole lanes of every data rank; a unit: whole lanes of every fsdp
    # rank, each tensor from a lane boundary.
    assert ttrain.row_length(8, data=2) == 16
    assert ttrain.row_length(16, data=4) == 32
    unit, = tsharding.fsdp_units({"embed.embedding": (3, 3),
                                  "final_norm.scale": (5,)}, 2)
    assert (unit.name, unit.length, unit.chunk) == ("embed", 24, 12)
    assert unit.params == (("embed.embedding", (3, 3), 0),
                           ("final_norm.scale", (5,), 12))
    assert unit.split_sizes() == [0, 9, 3, 5, 7]
    assert unit.span(1) == (12, 24)


class _OnCard(torch.Tensor):
    """A CPU tensor that the ring dispatchers take for a CUDA one."""

    @property
    def is_cuda(self):
        return True


class _Buffer:
    calls = writes = 0


class _StandInGroup:
    """A tp ring of two, as far as the kernel wrappers read it before
    they enqueue; ``failed``: its check raises, as after a timeout."""
    rank, size, axis, library = 0, 2, "tp", None

    def __init__(self, failed):
        self.failed = failed

    def check(self):
        if self.failed:
            raise RuntimeError("ring timed out")

    def buffer(self, name, nbytes):
        return _Buffer()


def test_axis_counts_are_added_where_the_kernels_launch(monkeypatch):
    """A ring call counts under its group's label only once its kernels
    are enqueued: one that raises first counts nothing; an all-reduce
    counts its K14 and K13, then itself; a plain call counts nothing."""
    enqueued = []
    monkeypatch.setattr(rc, "_check_cuda", lambda name, t, group: None)
    monkeypatch.setattr(rc, "_enqueue", lambda plan, group, buf, ends, *a:
                        enqueued.append(a[2]))
    monkeypatch.setattr(rc, "axis_launches", {})
    monkeypatch.setattr(rc, "launches", dict.fromkeys(rc.launches, 0))
    x = torch.zeros(37).as_subclass(_OnCard)
    for call in (lambda g: rc.ring_all_reduce(x, g),
                 lambda g: rc.ring_all_gather(x, g),
                 lambda g: rc.ring_reduce_scatter(x[:36], g),
                 lambda g: rc.ring_permute(x, x, g, impl="kernel")):
        with pytest.raises(RuntimeError, match="timed out"):
            call(_StandInGroup(failed=True))
    assert not enqueued and not rc.axis_launches
    assert not any(rc.launches.values())
    rc.ring_all_reduce(x, _StandInGroup(failed=False))
    assert enqueued == ["ring_reduce_scatter", "ring_all_gather"]
    assert rc.axis_launches == {"ring_reduce_scatter.tp": 1,
                                "ring_all_gather.tp": 1,
                                "ring_all_reduce.tp": 1}
    rc.ring_permute(x, x, _StandInGroup(failed=False), impl="kernel")
    assert rc.axis_launches["ring_permute.tp"] == rc.launches[
        "ring_permute"] == 1


# --------------------------- eight gloo ranks ------------------------------


# A rank of the mesh runs: for each mesh, its groups, ring_all_reduce over
# each of them, Megatron's f and g, one forward and backward with its
# gradient sums, then STEPS AdamW steps; results saved for the parent.
MESH_WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.ops import ring_collectives as rc
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import train
from batch_shipyard_tpu_torch.workloads import distributed
out, model, meshes, steps = (sys.argv[1], eval(sys.argv[2]),
                             eval(sys.argv[3]), int(sys.argv[4]))
me = distributed.setup("cpu")["process_index"]
data = np.load(os.path.join(out, "batch.npz"))
tokens, targets = (torch.from_numpy(data[k]) for k in ("tokens", "targets"))
params = torch.load(os.path.join(out, "params.pt"))
results = {}
for name, axes in meshes.items():
    mesh = mesh_mod.RankMesh.build("cpu", **axes)
    res = {"coords": mesh.coords,
           "groups": {k: g.ranks if g is not None else None
                      for k, g in mesh.groups.items()},
           "labels": {k: g.axis for k, g in mesh.groups.items()
                      if g is not None},
           "all_reduce": {}}
    gen = torch.Generator().manual_seed(1000 + me)
    for axis, group in mesh.groups.items():
        if group is None:
            continue
        x32 = torch.randn(37, generator=gen)
        x16 = torch.randn(5, 10, generator=gen).to(torch.bfloat16)
        res["all_reduce"][axis] = (x32, rc.ring_all_reduce(x32, group),
                                   x16, rc.ring_all_reduce(x16, group))
    tp = mesh.groups["tp"]
    if tp is not None:
        x = torch.randn(3, 4, generator=gen, requires_grad=True)
        w = torch.randn(3, 4, generator=gen)
        y = tfm.tp_region_output(x, tp)
        (y * w).sum().backward()
        res["g"] = (x.detach().clone(), y.detach(), x.grad.clone(), w)
        x.grad = None
        z = tfm.tp_region_input(x, tp)
        (z * w).sum().backward()
        res["f"] = (z.detach(), x.grad.clone())
    config = train.make_transformer_config(
        mesh=mesh, dtype=torch.float32, max_seq_len=tokens.shape[1], **model)
    harness = train.build_transformer_train(
        config, batch_size=tokens.shape[0], seq_len=tokens.shape[1],
        device="cpu", params=params, mesh=mesh)
    local = harness.shard(tokens, targets)
    loss = harness.loss_fn(*local[:3]) * local[3]
    loss.backward()
    grads, total = harness.sum_grads(loss)
    res["grads"] = (grads.clone(), float(total),
                    [(n, tuple(p.shape)) for n, p in
                     harness.model.named_parameters()])
    losses, calls = [], []
    for step in range(steps):
        before = dict(rc.plain_calls)
        losses.append(float(harness.step({"tokens": tokens,
                                          "targets": targets})["loss"]))
        calls.append({k: rc.plain_calls[k] - before[k] for k in before})
        if step == 1:
            res["state"] = harness.state_dict()
    res["losses"], res["calls"] = losses, calls
    owned, = harness.optimizer.param_groups[0]["params"]
    res["resident"] = {
        "bytes": harness.resident_param_bytes,
        "owned": owned.numel(), "chunks": [u.chunk for u in harness.units],
        "moments": [t.numel() for t in harness.optimizer.state[owned].values()
                    if t.dim()],
        "model_devices": sorted({p.device.type for p in
                                 harness.model.parameters()}),
        "optimized": len(harness.optimizer.param_groups[0]["params"])}
    res["launches"] = sum(rc.launches.values())
    mesh.close()
    results[name] = res
torch.save(results, os.path.join(out, f"rank{me}.pt"))
"""


def _reference_params():
    """The reference's weights (every mesh draws the same ones: its init
    is sharding-invariant), as the flax tree of numpy arrays."""
    mesh = jmesh.make_mesh(jmesh.auto_axis_sizes(WORLD))
    jcfg = jtrain.make_transformer_config(mesh, dtype=jnp.float32,
                                          max_seq_len=SEQ, **MODEL)
    ref = jtrain.build_transformer_train(mesh, jcfg, batch_size=BATCH,
                                         seq_len=SEQ)
    return jax.tree_util.tree_map(np.asarray, ref.params)


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every mesh of MESHES in one launch of eight gloo ranks: each
    rank's results by mesh, and the flax weights they started from."""
    out = tmp_path_factory.mktemp("mesh")
    flax_params = _reference_params()
    torch.save(convert.params_from_flax(flax_params), out / "params.pt")
    tokens, targets = _batch()
    np.savez(out / "batch.npz", tokens=tokens, targets=targets)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local(
        [sys.executable, "-c", MESH_WORKER, str(out), repr(MODEL),
         repr(MESHES), str(STEPS)], WORLD, RANKS_TIMEOUT_S, env=env,
        cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["returncode"], r["stderr"][-3000:])
                     for r in bad]
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]
    return {"ranks": ranks, "params": flax_params}


def _ranks_where(ranks, name, **coords):
    return [r for r in ranks if all(r[name]["coords"][a] == i
                                    for a, i in coords.items())]


def _gathered_state(ranks, name):
    """The full state dict after two steps: tp shards (dp = fsdp = sp = 0
    ranks) gathered in tp order."""
    shards = _ranks_where(ranks, name, dp=0, fsdp=0, sp=0)
    shards.sort(key=lambda r: r[name]["coords"]["tp"])
    return tsharding.gather_state_dict([r[name]["state"] for r in shards])


def _assert_params_close(state, flax_tree):
    want = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, flax_tree))
    assert set(state) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(state[name].numpy(), w.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("name", REFERENCE_MESHES)
def test_two_adamw_steps_match_reference_on_its_mesh(mesh_runs, name):
    """The reference's build_transformer_train on the 8-device CPU mesh
    of the same axes against the port's eight ranks: two AdamW steps'
    losses (every rank reports the global mean) and the gathered
    weights."""
    axes = MESHES[name]
    mesh = jmesh.make_mesh(jmesh.auto_axis_sizes(WORLD, **axes))
    jcfg = jtrain.make_transformer_config(mesh, dtype=jnp.float32,
                                          max_seq_len=SEQ, **MODEL)
    ref = jtrain.build_transformer_train(mesh, jcfg, batch_size=BATCH,
                                         seq_len=SEQ)
    for got, want in zip(jax.tree_util.tree_leaves(mesh_runs["params"]),
                         jax.tree_util.tree_leaves(ref.params)):
        assert np.array_equal(got, np.asarray(want))  # the same weights
    tokens, targets = _batch()
    p, state = ref.params, ref.opt_state
    want = []
    for _ in range(2):
        p, state, metrics = ref.step(p, state, {
            "tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)})
        want.append(float(metrics["loss"]))
    for rank in mesh_runs["ranks"]:
        np.testing.assert_allclose(rank[name]["losses"][:2], want,
                                   rtol=LOSS_RTOL)
    _assert_params_close(_gathered_state(mesh_runs["ranks"], name), p)


def test_parallelism_configs_agree(mesh_runs):
    """The reference's own agreement check on the port: dp = 8 and
    tp 2 x sp 2 (dp 2), three steps from the same weights and batch."""
    ranks = mesh_runs["ranks"]
    np.testing.assert_allclose(ranks[0]["dp8"]["losses"],
                               ranks[0]["dp2_sp2_tp2"]["losses"], rtol=2e-3)
    assert len(ranks[0]["dp8"]["losses"]) == 3


@pytest.mark.parametrize("name", list(MESHES))
def test_ranks_know_their_place_and_groups(mesh_runs, name):
    sizes = _sizes(MESHES[name])
    for rank, res in enumerate(r[name] for r in mesh_runs["ranks"]):
        assert res["coords"] == tmesh.RankMesh(sizes, rank).coords
        for group, axes in tmesh.GROUP_AXES.items():
            members = next(g for g in tmesh.axis_groups(sizes, axes)
                           if rank in g)
            assert res["groups"][group] == (members if len(members) > 1
                                            else None), (group, rank)
            if len(members) > 1:
                shared = sizes["dp"] == 1 and group in ("sp", "data")
                assert res["labels"][group] == ("sp+data" if shared
                                                else group)


def _ring_sum(parts):
    """What ring_all_reduce gives: chunk c of the sum starts at member
    c + 1 and every later member adds its part, T(float + float)."""
    ring = len(parts)
    n = parts[0].numel()
    padded = rc.all_reduce_lanes(n, parts[0].dtype, ring)
    flat = [torch.cat([p.reshape(-1), p.new_zeros(padded - n)])
            for p in parts]
    chunk = padded // ring
    out = []
    for c in range(ring):
        cols = slice(c * chunk, (c + 1) * chunk)
        acc = flat[(c + 1) % ring][cols]
        for k in range(2, ring + 1):
            acc = (acc.float() + flat[(c + k) % ring][cols].float()).to(
                acc.dtype)
        out.append(acc)
    return torch.cat(out)[:n].view(parts[0].shape)


@pytest.mark.parametrize("name", list(MESHES))
def test_ring_all_reduce_over_subgroups_is_bit_identical(mesh_runs, name):
    """ring_all_reduce over each group of the mesh (fp32 of a ragged 37
    elements, bf16 [5, 10]): every member gets the same bits, the sum in
    ring order, and it is the sum within the dtype's rounding."""
    ranks = mesh_runs["ranks"]
    checked = 0
    for group in tmesh.GROUP_AXES:
        for members in {tuple(r[name]["groups"][group]) for r in ranks
                        if r[name]["groups"][group]}:
            runs = [ranks[m][name]["all_reduce"][group] for m in members]
            for i, tol in ((0, 1e-5), (2, 0.1)):
                want = _ring_sum([run[i] for run in runs])
                for run in runs:
                    assert run[i + 1].dtype == run[i].dtype
                    assert torch.equal(run[i + 1], want), (group, members)
                exact = sum(run[i].double() for run in runs)
                np.testing.assert_allclose(want.double().numpy(),
                                           exact.numpy(), rtol=tol,
                                           atol=tol)
            checked += 1
    sizes = _sizes(MESHES[name])
    assert checked == sum(len(tmesh.axis_groups(sizes, axes))
                          for axes in tmesh.GROUP_AXES.values()
                          if math.prod(sizes[a] for a in axes) > 1)


@pytest.mark.parametrize("name", ["dp2_tp4", "dp2_sp2_tp2", "fsdp4_tp2"])
def test_megatron_f_and_g(mesh_runs, name):
    """g: forward the sum over the tp ring, backward the identity; f:
    forward the identity, backward the sum over the tp ring."""
    ranks = mesh_runs["ranks"]
    for res in (r[name] for r in ranks):
        tp = [ranks[m][name] for m in res["groups"]["tp"]]
        x, y, gx, w = res["g"]
        assert torch.equal(y, _ring_sum([t["g"][0] for t in tp]))
        assert torch.equal(gx, w)
        z, fx = res["f"]
        assert torch.equal(z, x)
        assert torch.equal(fx, _ring_sum([t["g"][3] for t in tp]))


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_gradients_match_the_single_rank_model(mesh_runs, name):
    """One forward and backward of every rank's block, its gradients
    summed as the step sums them (fsdp reduce-scatter, data all-reduce),
    then gathered over fsdp and tp: the single-rank model's gradients and
    loss on the whole batch (f and g make the tp shards' sums exact)."""
    ranks = mesh_runs["ranks"]
    sizes = _sizes(MESHES[name])
    cfg = ttfm.TransformerConfig(dtype=torch.float32, max_seq_len=SEQ,
                                 **MODEL)
    harness = ttrain.build_transformer_train(
        cfg, batch_size=BATCH, seq_len=SEQ, device="cpu",
        params=convert.params_from_flax(mesh_runs["params"]))
    tokens, targets = (torch.from_numpy(t) for t in _batch())
    loss = harness.loss_fn(tokens, targets)
    loss.backward()
    want = {n: p.grad for n, p in harness.model.named_parameters()}
    shards = []
    for t in range(sizes["tp"]):
        owners = sorted(_ranks_where(ranks, name, tp=t, dp=0, sp=0),
                        key=lambda r: r[name]["coords"]["fsdp"])
        units = tsharding.fsdp_units(dict(owners[0][name]["grads"][2]),
                                     sizes["fsdp"])
        shards.append(tsharding.join_owned(
            units, [r[name]["grads"][0] for r in owners]))
    got = tsharding.gather_state_dict(shards)
    assert set(got) == set(want)
    for pname, g in want.items():
        np.testing.assert_allclose(got[pname].numpy(), g.numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=pname)
    for rank in ranks:
        assert rank[name]["grads"][1] == pytest.approx(float(loss.detach()),
                                                       rel=LOSS_RTOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_replicated_weights_stay_bit_identical(mesh_runs, name):
    """After two steps every replicated parameter has the same bits on
    all eight ranks, and every tp shard on the ranks of its tp index."""
    ranks = mesh_runs["ranks"]
    for res in (r[name] for r in ranks):
        twin = ranks[0][name] if res["coords"]["tp"] == 0 else \
            _ranks_where(ranks, name, tp=res["coords"]["tp"])[0][name]
        for pname, tensor in res["state"].items():
            like = ranks[0][name] if tsharding.tp_dim(pname) is None \
                else twin
            assert torch.equal(tensor, like["state"][pname]), pname


@pytest.mark.parametrize("name", list(MESHES))
def test_ring_calls_per_step(mesh_runs, name):
    """Each step's ring calls on every rank (CPU tensors: the plain
    versions; no kernel launches; no remat): per layer, two tp
    all-reduces forward (g) and two backward (f), sp - 1 rotations
    forward and backward; with tp, the embedding's all-reduce (g), the
    vocab-parallel loss's gather of (lse, gold) and its all-reduce of
    grad_h; with fsdp, each unit's gather (embed once, each layer once)
    and gradient reduce-scatter, and the loss's all-reduce; the data
    all-reduce where that ring has more than one rank."""
    sizes = _sizes(MESHES[name])
    layers = MODEL["n_layers"]
    tp = 4 * layers + 2 if sizes["tp"] > 1 else 0
    loss_gather = int(sizes["tp"] > 1)
    data = int(sizes["dp"] * sizes["sp"] > 1)
    fsdp = 1 + layers + 1 if sizes["fsdp"] > 1 else 0
    want = {"ring_permute": 2 * (sizes["sp"] - 1) * layers,
            "ring_reduce_scatter": tp + data + fsdp,
            "ring_all_gather": tp + loss_gather + data + fsdp,
            "virtual_all_gather": 0, "virtual_reduce_scatter": 0}
    for rank in mesh_runs["ranks"]:
        assert rank[name]["calls"] == [want] * STEPS
        assert rank[name]["launches"] == 0


@pytest.mark.parametrize("name", list(MESHES))
def test_resident_parameters_are_the_ranks_unit_chunks(mesh_runs, name):
    """A rank keeps no parameter storage but its chunks of the units: the
    model's parameters are on meta, AdamW updates one flat tensor of the
    chunks and keeps moments of its size, and the chunks add up to at
    most the rank's tp shard over fsdp plus one lane per unit."""
    sizes = _sizes(MESHES[name])
    for res in (r[name] for r in mesh_runs["ranks"]):
        resident = res["resident"]
        n = sum(math.prod(shape) for _, shape in res["grads"][2])
        units = len(resident["chunks"])
        assert resident["model_devices"] == ["meta"]
        assert resident["optimized"] == 1
        assert resident["owned"] == sum(resident["chunks"])
        assert resident["moments"] == [resident["owned"]] * 2
        assert resident["bytes"] == 4 * resident["owned"]
        assert resident["owned"] <= n / sizes["fsdp"] + tsharding.LANE * units
        assert resident["owned"] >= n / sizes["fsdp"]


# Four gloo ranks for the fsdp forward and step: fsdp 2 with and without
# remat (gathers a step, gathered units alive), fsdp 2 x tp 2 with
# fused_norm and fsdp 2 with quantize_matmuls against the same rows at
# fsdp 1, and the gather Function on a ring of four at lane-sized chunks.
FSDP_RANKS = 4
FSDP_RUNS = {
    "fsdp2_remat": ({"fsdp": 2}, dict(remat=True)),
    "fsdp2": ({"fsdp": 2}, {}),
    "fused_fsdp2_tp2": ({"fsdp": 2, "tp": 2},
                        dict(remat=True, fused_norm=True)),
    "fused_tp2": ({"tp": 2}, dict(remat=True, fused_norm=True)),
    "int8_fsdp2": ({"fsdp": 2}, dict(remat=True, quantize_matmuls=True)),
    "int8_dp4": ({}, dict(remat=True, quantize_matmuls=True)),
}
# (the fsdp run, its fsdp 1 comparison on the same rows)
FSDP_PAIRS = (("fused_fsdp2_tp2", "fused_tp2"), ("int8_fsdp2", "int8_dp4"))
# Chunk lengths of the gather Function check: one lane a rank (a unit
# smaller than that pads up to it) and three lanes.
GATHER_CHUNKS = (4, 12)

FSDP_WORKER = r"""
import os, sys, weakref
import numpy as np, torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.ops import ring_collectives as rc
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import train
from batch_shipyard_tpu_torch.workloads import distributed
out, model, runs, chunks = (sys.argv[1], eval(sys.argv[2]),
                            eval(sys.argv[3]), eval(sys.argv[4]))
me = distributed.setup("cpu")["process_index"]
data = np.load(os.path.join(out, "batch.npz"))
tokens, targets = (torch.from_numpy(data[k]) for k in ("tokens", "targets"))
results = {}
# Every gathered unit's flat (a weakref), sampled at every ring call: how
# many gathered layers are alive.
gathered, samples, at_gather = [], [], []

def alive_layers():
    return sum(1 for unit, ref in gathered
               if unit != "embed" and ref() is not None)

def sampled(call):
    def run(*args, **kwargs):
        samples.append(alive_layers())
        return call(*args, **kwargs)
    return run
for call in ("ring_permute", "ring_all_gather", "ring_reduce_scatter"):
    setattr(rc, call, sampled(getattr(rc, call)))
for name, (axes, flags) in runs.items():
    mesh = mesh_mod.RankMesh.build("cpu", **axes)
    config = train.make_transformer_config(
        mesh=mesh, dtype=torch.float32, max_seq_len=tokens.shape[1],
        **flags, **model)
    harness = train.build_transformer_train(
        config, batch_size=tokens.shape[0], seq_len=tokens.shape[1],
        device="cpu", seed=0, mesh=mesh)
    gather = harness.gather

    def recorded(unit, gather=gather):
        views = gather(unit)
        gathered.append((unit, weakref.ref(next(iter(views.values()))._base)))
        samples.append(alive_layers())
        at_gather.append(samples[-1])
        return views
    harness.gather = recorded
    res = {"coords": mesh.coords, "losses": [], "steps": []}
    for _ in range(2):
        gathered.clear()
        samples.clear()
        at_gather.clear()
        res["losses"].append(float(harness.step(
            {"tokens": tokens, "targets": targets})["loss"]))
        res["steps"].append({"units": [u for u, _ in gathered],
                             "samples": list(samples),
                             "at_gather": list(at_gather),
                             "after": alive_layers()})
    res["state"] = harness.state_dict()
    mesh.close()
    results[name] = res
# The gather Function against the plain all-gather and reduce-scatter.
mesh = mesh_mod.RankMesh.build("cpu", fsdp=4)
group = mesh.groups["fsdp"]
gen = torch.Generator().manual_seed(50 + me)
checks = []
for n in chunks:
    owned = torch.randn(n, generator=gen)
    chunk = owned.detach().requires_grad_()
    sink = torch.full((n,), float("nan"))
    flat = rc.fsdp_gather(chunk, group, sink)
    grad = torch.randn(4 * n, generator=gen)
    (flat * grad).sum().backward()
    checks.append({"flat": flat.detach(), "want_flat":
                   rc.ring_all_gather(owned.clone(), group),
                   "sink": sink, "want_sink":
                   rc.ring_reduce_scatter(grad, group),
                   "grad": grad, "chunk_grad": chunk.grad})
mesh.close()
results["gather_function"] = checks
torch.save(results, os.path.join(out, f"rank{me}.pt"))
"""


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """FSDP_RUNS and the gather Function check in one launch of four gloo
    ranks, the weights drawn from seed 0 (every mesh the same model),
    the batch the other tests': each rank's results."""
    out = tmp_path_factory.mktemp("fsdp")
    tokens, targets = _batch()
    np.savez(out / "batch.npz", tokens=tokens, targets=targets)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local(
        [sys.executable, "-c", FSDP_WORKER, str(out), repr(MODEL),
         repr(FSDP_RUNS), repr(GATHER_CHUNKS)], FSDP_RANKS, RANKS_TIMEOUT_S,
        env=env, cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["returncode"], r["stderr"][-3000:])
                     for r in bad]
    return [torch.load(out / f"rank{r}.pt") for r in range(FSDP_RANKS)]


@pytest.mark.parametrize("name,remat", [("fsdp2_remat", True),
                                        ("fsdp2", False)])
def test_fsdp_gathers_a_step_and_gathered_layers_alive(fsdp_runs, name,
                                                       remat):
    """Each step gathers ``embed`` once, then each layer as it runs and,
    with remat, again in its recompute (the reverse order). With remat,
    at most one gathered layer is alive at every ring call of the
    forward and the backward (besides ``embed``, which holds the final
    norm); without remat, the module doc's design: each layer's stays
    alive until its backward, so all are alive as the forward ends. None
    is alive after the step."""
    layers = MODEL["n_layers"]
    order = ["embed"] + [f"layer_{i}" for i in range(layers)]
    if remat:
        order += [f"layer_{i}" for i in reversed(range(layers))]
    for rank in fsdp_runs:
        for step in rank[name]["steps"]:
            assert step["units"] == order
            assert step["after"] == 0
            if remat:
                assert max(step["samples"]) == 1
                assert step["at_gather"] == [0] + [1] * (2 * layers)
            else:
                assert max(step["samples"]) == layers
                assert step["at_gather"] == list(range(layers + 1))


@pytest.mark.parametrize("fsdp,base", FSDP_PAIRS)
def test_fsdp_fused_and_int8_match_fsdp1_on_the_same_rows(fsdp_runs, fsdp,
                                                          base):
    """fsdp 2 x tp 2 with fused_norm and fsdp 2 with quantize_matmuls
    against fsdp 1 on the same rows a rank (dp takes fsdp's place): two
    AdamW steps' losses within LOSS_RTOL, the gathered parameters within
    PARAM_ATOL."""
    for rank in fsdp_runs:
        np.testing.assert_allclose(rank[fsdp]["losses"], rank[base]["losses"],
                                   rtol=LOSS_RTOL)
    for rank in fsdp_runs:
        twin = next(r for r in fsdp_runs
                    if r[base]["coords"]["tp"] == rank[fsdp]["coords"]["tp"])
        assert set(rank[fsdp]["state"]) == set(twin[base]["state"])
        for pname, tensor in rank[fsdp]["state"].items():
            np.testing.assert_allclose(tensor.numpy(),
                                       twin[base]["state"][pname].numpy(),
                                       atol=PARAM_ATOL, rtol=0, err_msg=pname)


def test_fsdp_gather_function_is_the_plain_gather_and_reduce_scatter(
        fsdp_runs):
    """The gather Function on a ring of four: forward the plain
    all-gather of the chunks, bit for bit; backward the plain
    reduce-scatter of the flat's gradient into the sink, bit for bit,
    and no .grad on the chunk; at one lane a rank too."""
    for rank in fsdp_runs:
        for n, check in zip(GATHER_CHUNKS, rank["gather_function"]):
            assert check["flat"].shape == (4 * n,)
            assert torch.equal(check["flat"], check["want_flat"])
            assert torch.equal(check["sink"], check["want_sink"])
            assert check["chunk_grad"] is None
    for c in range(len(GATHER_CHUNKS)):
        total = sum(r["gather_function"][c]["grad"].double()
                    for r in fsdp_runs)
        for me, rank in enumerate(fsdp_runs):
            n = GATHER_CHUNKS[c]
            np.testing.assert_allclose(
                rank["gather_function"][c]["sink"].double().numpy(),
                total[me * n:(me + 1) * n].numpy(), rtol=1e-5, atol=1e-5)


def test_train_cli_mesh_on_cpu():
    """`torch.distributed.run --nproc-per-node 8 ... --tp 2 --sp 2 --fsdp
    2 --device cpu` as eight local ranks: rank 0 prints the mesh and every
    rank's coordinates; every rank made the mesh step's ring calls (CPU
    tensors: plain versions, no launches); the replicated parameters have
    one digest on all ranks, each tp shard one on the ranks of its tp
    index."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local([
        sys.executable, "-m",
        "batch_shipyard_tpu_torch.workloads.train_transformer", "--tp", "2",
        "--sp", "2", "--fsdp", "2", "--device", "cpu", "--d-model", "32",
        "--n-layers", "2", "--n-heads", "2", "--d-ff", "64", "--vocab", "64",
        "--seq-len", "32", "--batch", "4", "--steps", "2", "--warmup", "1"],
        WORLD, RANKS_TIMEOUT_S, env=env, cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["stderr"][-2000:]) for r in bad]
    lines = runs[0]["stdout"].strip().splitlines()
    sizes = {"dp": 1, "fsdp": 2, "ep": 1, "sp": 2, "tp": 2}
    assert lines[-2].startswith(f"[proc 0/8] transformer: mesh={sizes}")
    report = json.loads(lines[-1])
    assert report["mesh"] == sizes and np.isfinite(report["loss"])
    # 3 steps: tp (remat; the embedding, the loss's grad_h and gather),
    # data, fsdp (embed, each layer forward and in the recompute, the
    # loss's all-reduce).
    per_step = 3 * (6 * 2 + 3 + 1 + 1 + 2 * 2 + 1)
    for rank, r in enumerate(report["per_rank"]):
        assert r["coords"] == tmesh.RankMesh(sizes, rank).coords
        assert not r["launches"] and not r["launches_per_step"]
        assert r["plain_calls"]["ring_collectives.ring_all_gather"] == \
            per_step
        assert r["plain_calls"]["ring_collectives.ring_permute"] == 3 * 3 * 2
        assert r["params_sha256"]["replicated"] == \
            report["per_rank"][0]["params_sha256"]["replicated"]
        assert r["params_sha256"]["tp_shard"] == \
            report["per_rank"][rank % 2]["params_sha256"]["tp_shard"]
    assert report["per_rank"][0]["params_sha256"]["tp_shard"] != \
        report["per_rank"][1]["params_sha256"]["tp_shard"]
    assert all(not run["stdout"].strip() for run in runs[1:])


@pytest.mark.parametrize("flags,world", [
    (["--fsdp", "2"], 2), (["--sp", "2", "--fsdp", "2"], 4),
    (["--tp", "2", "--fsdp", "2", "--fused-norm"], 4)],
    ids=["fsdp2", "sp2_fsdp2", "tp2_fsdp2_fused"])
def test_chip_smoke_launch_formula_counts_the_workloads_ring_calls(flags,
                                                                   world):
    """chip_smoke.mesh_launches_per_step, which the card's runs are held
    to, against the workload's ring calls on CPU ranks (plain versions:
    one call where the card launches one kernel): the all-gathers,
    reduce-scatters and permutes a step on every rank, remat on."""
    import chip_smoke
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local([
        sys.executable, "-m",
        "batch_shipyard_tpu_torch.workloads.train_transformer", *flags,
        "--device", "cpu", "--d-model", "32", "--n-layers", "2",
        "--n-heads", "2", "--d-ff", "64", "--vocab", "64", "--seq-len", "32",
        "--batch", "4", "--steps", "1", "--warmup", "1"],
        world, RANKS_TIMEOUT_S, env=env, cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["stderr"][-2000:]) for r in bad]
    report = json.loads(runs[0]["stdout"].strip().splitlines()[-1])
    for r in report["per_rank"]:
        want = chip_smoke.mesh_launches_per_step(
            r["rank"], report["mesh"], 2,
            [f for f in flags if f in ("--fused-norm", "--int8")])
        for call in ("ring_all_gather", "ring_reduce_scatter",
                     "ring_permute"):
            assert r["plain_calls"].get(f"ring_collectives.{call}", 0) == \
                2 * want.get(call, 0), (r["rank"], call)


# ------------------------- a failure across groups -------------------------


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return 0.0


class _Library:
    def __init__(self):
        self.writes = []

    def bs_stream_write(self, device, word, value, stream):
        self.writes.append((word, value))
        return 0


class _Store:
    def __init__(self, keys=(), gone=False):
        self.keys, self.gone = dict.fromkeys(keys, "x"), gone

    def check(self, keys):
        if self.gone:
            raise RuntimeError("connection reset")
        return all(k in self.keys for k in keys)

    def set(self, key, value):
        self.keys[key] = value


def _group(store, timeout_s=2.0):
    """A CUDA ring group's watchdog state without a card (as
    tests/test_torch_ring_plan.py builds one), in a mesh's store."""
    import ctypes
    import threading
    group = tmesh.RingGroup.__new__(tmesh.RingGroup)
    group.rank, group.size, group.ranks, group.axis = 0, 2, [3, 5], "tp"
    group.device = torch.device("cuda", 0)
    group.timeout_s = timeout_s
    group.error = (ctypes.c_int * 1)(0)
    group._library = _Library()
    group._waits, group._spare, group._waited_ns = [], [], 0
    group._lock = threading.Lock()
    group._poison_stream = None
    group.abort = 0x99
    group._abort = (store, "ring_abort/mesh0")
    return group


def test_a_failed_group_stops_every_group_of_the_mesh(monkeypatch):
    """A group whose wait expires publishes the failure in the mesh's
    store; another group's watchdog that reads it sets ABORTED, poisons
    the waits its stream stands at and raises; a store that is gone
    stops a group too."""
    clock = [100.0]
    monkeypatch.setattr(tmesh.time, "monotonic", lambda: clock[0])
    store = _Store()
    failing, other = _group(store), _group(store)
    failing._waits = [[_Event(True), _Event(False), 0x20, None]]
    other._waits = [[_Event(True), _Event(False), 0x40, None]]
    for group in (failing, other):
        group._sweep()
    assert failing.error[0] == other.error[0] == 0
    clock[0] += 1.0
    other._sweep()  # its wait has not expired, and nothing is published
    assert other.error[0] == 0 and not store.keys
    clock[0] += 1.5
    failing._sweep()
    assert failing.error[0] == tmesh.TIMED_OUT
    assert "ring_abort/mesh0" in store.keys
    assert "rank 3 (tp ring)" in store.keys["ring_abort/mesh0"]
    other._sweep()
    assert other.error[0] == tmesh.ABORTED
    assert other._library.writes == [(0x99, tmesh.ABORTED),
                                     (0x40, tmesh.POISON)]
    with pytest.raises(RuntimeError, match="another ring group of the mesh"):
        other.check()
    gone = _group(_Store(gone=True))
    gone._sweep()
    assert gone.error[0] == tmesh.ABORTED


def test_ring_time_by_axis_follows_the_launch_order():
    """train_profile attributes each ring copy kernel to the axis of the
    call that launched it, in launch order on the one stream; a count or
    kernel that does not line up raises."""
    from batch_shipyard_tpu_torch.trace import train_profile

    class Range:
        def __init__(self, start, end):
            self.start, self.end = start, end

    class Kernel:
        def __init__(self, name, start, end):
            self.name, self.time_range = name, Range(start, end)
    kernels = [Kernel("void ring_all_gather_kernel<16>()", 30, 34),
               Kernel("flash_fwd_wgmma_kernel", 0, 9),
               Kernel("ring_permute_kernel", 10, 12),
               Kernel("ring_reduce_scatter_kernel", 20, 25)]
    log = [("ring_permute", "sp"), ("ring_reduce_scatter", "tp"),
           ("ring_all_gather", "tp")]
    assert train_profile.ring_us_by_axis(kernels, log) == {"sp": 2, "tp": 9}
    with pytest.raises(RuntimeError, match="saw 3 ring kernels"):
        train_profile.ring_us_by_axis(kernels, log[:2])
    with pytest.raises(RuntimeError, match="ran where the wrappers"):
        train_profile.ring_us_by_axis(kernels, log[::-1])


def test_host_holds_in_python_while_far_ahead_of_its_waits(monkeypatch):
    """A host RUN_AHEAD_WAITS waits ahead of the stream waits in Python
    (not inside the CUDA driver, where it would hold up the watchdog's
    poison writes) until the stream reaches the oldest of them, and
    raises there once the group fails."""
    group = _group(_Store())
    waits = [[_Event(False), _Event(False), 0x10 + i, None]
             for i in range(tmesh.RUN_AHEAD_WAITS)]
    group._waits = waits[1:]
    group._run_ahead()  # fewer than RUN_AHEAD_WAITS: no hold
    group._waits = waits
    polls = []

    def sleep(seconds):
        polls.append(seconds)
        if len(polls) == 3:
            waits[0][0].done = True
    monkeypatch.setattr(tmesh.time, "sleep", sleep)
    group._run_ahead()
    assert polls == [tmesh.RUN_AHEAD_POLL_S] * 3
    waits[0][0].done = False
    group.error[0] = tmesh.ABORTED
    with pytest.raises(RuntimeError, match="another ring group"):
        group._run_ahead()
