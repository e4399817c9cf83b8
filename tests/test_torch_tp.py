"""The port's tensor-parallel axis, whole (parallel/sharding's head-wise
regroup of the fused kernels, fused_norm and int8 under tp, the
vocab-parallel embedding and loss) against the JAX reference on the CPU.

Two gloo ranks form one tp ring of two (``tp_runs``, a module fixture:
one launch runs every case and saves each rank's results). The reference
lays its mesh out by GSPMD, so its Pallas calls see the global arrays,
and its mesh step cannot run them in interpret mode on the 8-device CPU
mesh (ROADMAP queue 3); the port's tp 2 ranks are held against the
reference's one-device functions, which compute the same global
function. Tolerances:

- the vocab-parallel lookup and the int8 operands and scales: bit for
  bit (one rank supplies each row; the absmax is a max);
- the vocab-parallel loss and its gradients: 1e-5 relative and absolute
  (fp32, the logsumexp over the ranks and the grad_h sum in another
  order);
- loss and gradients of the fused model, the norm scales' included
  (summed over the ring once a step): 1e-5 relative, 1e-5 absolute on
  the gradients (tests/test_torch_train.py's);
- two AdamW steps: losses within 1e-5 relative, every gathered
  parameter within 1e-5 absolute (the same). The int8 run uses the batch
  seed of tests/test_torch_train.py's int8 test, where no int8 value
  rounds the other way between the frameworks (ROADMAP queue 3); the
  port's random_bits returns the reference's jax.random.bits for each
  (seed, shape), drawn at the one-card shape and sliced as the ranks
  slice it.
"""

import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu.ops import attention as jattn
from batch_shipyard_tpu.ops import chunked_loss as jcl
from batch_shipyard_tpu.ops import quantization as jq
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.parallel import mesh as tmesh
from batch_shipyard_tpu_torch.parallel import sharding as tsharding
from batch_shipyard_tpu_torch.workloads import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP = 2
RANKS_TIMEOUT_S = 300
# d_model 128: the fused loss takes its kernel path (d % 128 == 0).
FUSED_MODEL = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                   d_head=32, d_ff=128)
INT8_MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4,
                  d_head=16, d_ff=128)
SEQ, BATCH = 64, 2
FUSED_BATCH_SEED, INT8_BATCH_SEED = 7, 6
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_ATOL, LOSS_RTOL = 1e-5, 1e-5
GRAD_TOL = dict(rtol=1e-5, atol=1e-5)
# The vocab-parallel loss case: rows, vocab, depth.
LOSS_ROWS, LOSS_VOCAB, LOSS_DEPTH = 96, 512, 128
# The int8 operands case: x [M, K], the weight [N, K], split over tp.
QUANT_M, QUANT_K, QUANT_N, QUANT_SEED = 48, 64, 40, 3
# Every (seed, shape) the ranks draw bits for: the operands case and the
# int8 model's projections at tp 2, each at its one-card shape.
_ROWS = BATCH * SEQ
_F = INT8_MODEL["n_heads"] * INT8_MODEL["d_head"]
BIT_SHAPES = [
    (QUANT_SEED, (QUANT_M, QUANT_K)), (QUANT_SEED + 1, (QUANT_N, QUANT_K)),
    (0, (_ROWS, INT8_MODEL["d_model"])), (0, (_ROWS, _F)),
    (0, (_ROWS, INT8_MODEL["d_ff"])),
    (1, (_F, INT8_MODEL["d_model"])), (1, (INT8_MODEL["d_model"], _F)),
    (1, (INT8_MODEL["d_ff"], INT8_MODEL["d_model"])),
    (1, (INT8_MODEL["d_model"], INT8_MODEL["d_ff"])),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_bits(seed, shape) -> np.ndarray:
    """The bits the reference's quantize_int8 draws for (seed, shape)."""
    return np.array(jax.lax.bitcast_convert_type(
        jax.random.bits(jax.random.PRNGKey(seed), tuple(shape), jnp.uint32),
        jnp.int32))


def _bits_key(seed, shape) -> str:
    return f"{seed}_" + "x".join(str(n) for n in shape)


def _batch(seed, vocab):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32),
            rng.randint(0, vocab, (BATCH, SEQ)).astype(np.int32))


def _flax_params(model, **flags):
    cfg = jtfm.TransformerConfig(dtype=jnp.float32, max_seq_len=SEQ,
                                 **flags, **model)
    with pltpu.force_tpu_interpret_mode():
        params = jtfm.TransformerLM(cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _loss_inputs():
    rng = np.random.RandomState(11)
    hidden = rng.randn(LOSS_ROWS, LOSS_DEPTH).astype(np.float32)
    embedding = (rng.randn(LOSS_VOCAB, LOSS_DEPTH) * 0.2).astype(np.float32)
    targets = rng.randint(0, LOSS_VOCAB, LOSS_ROWS).astype(np.int32)
    targets[rng.rand(LOSS_ROWS) < 0.25] = -1
    # Live targets in each shard, and ignored ones.
    half = LOSS_VOCAB // TP
    assert ((targets >= 0) & (targets < half)).any()
    assert (targets >= half).any() and (targets == -1).any()
    return hidden, embedding, targets


def _quant_inputs():
    rng = np.random.RandomState(QUANT_SEED)
    x = (rng.randn(QUANT_M, QUANT_K) * rng.rand(QUANT_M, 1) * 4).astype(
        np.float32)
    w = (rng.randn(QUANT_N, QUANT_K) / 8).astype(np.float32)
    x[5, :QUANT_K // 2] = 0.0  # a row whose absmax lies on rank 1 alone
    w[2, QUANT_K // 2:] = 0.0  # and one whose absmax lies on rank 0
    x[7] = 0.0  # a zero row takes the 1e-8 floor of the scale
    return x, w


# One rank of the tp ring: every case, results saved for the parent.
TP_WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.ops import attention
from batch_shipyard_tpu_torch.ops import chunked_loss as cl
from batch_shipyard_tpu_torch.ops import quantization as tq
from batch_shipyard_tpu_torch.ops import ring_collectives as rc
from batch_shipyard_tpu_torch.parallel import mesh as mesh_mod
from batch_shipyard_tpu_torch.parallel import sharding
from batch_shipyard_tpu_torch.parallel import train
from batch_shipyard_tpu_torch.workloads import distributed
out = sys.argv[1]
fused_model, int8_model = eval(sys.argv[2]), eval(sys.argv[3])
me = distributed.setup("cpu")["process_index"]
data = {k: torch.from_numpy(v) for k, v in
        np.load(os.path.join(out, "inputs.npz")).items()}
bits = np.load(os.path.join(out, "bits.npz"))
drawn = []

def reference_bits(seed, shape, device):
    drawn.append((seed, tuple(shape)))
    key = f"{seed}_" + "x".join(str(n) for n in shape)
    return torch.from_numpy(bits[key]).to(device)
tq.random_bits = reference_bits
mesh = mesh_mod.RankMesh.build("cpu", tp=2)
tp = mesh.groups["tp"]
res = {"tp_rank": tp.rank}

# The vocab-parallel lookup, fp32 and bf16.
table = data["table"]
rows = table.shape[0] // tp.size
for dtype in (torch.float32, torch.bfloat16):
    embed = tfm.Embed(tfm.TransformerConfig(
        vocab_size=table.shape[0], d_model=table.shape[1], dtype=dtype,
        tp_group=tp), device="meta")
    embed.embedding = torch.nn.Parameter(
        table[tp.rank * rows:(tp.rank + 1) * rows].clone())
    res[f"lookup_{dtype}"] = embed(data["lookup_tokens"]).detach()

# The vocab-parallel loss, on both paths.
e_full = data["loss_e"]
rows = e_full.shape[0] // tp.size
for impl in ("kernel", "plain"):
    h = data["loss_h"].clone().requires_grad_()
    e = e_full[tp.rank * rows:(tp.rank + 1) * rows].clone().requires_grad_()
    before = dict(rc.plain_calls)
    loss = cl.chunked_softmax_xent(h, e, data["loss_t"], impl=impl,
                                   chunk_size=32, tp_group=tp)
    loss.backward()
    res[f"loss_{impl}"] = (float(loss), h.grad.clone(), e.grad.clone(),
                           {k: rc.plain_calls[k] - before[k] for k in before})

# The int8 operands: column-parallel (the weight's rows split) and
# row-parallel (K split), against the reference on the whole tensors.
x, w = data["quant_x"], data["quant_w"]
k = x.shape[1] // tp.size
cols = slice(tp.rank * k, (tp.rank + 1) * k)
seed = int(data["quant_seed"])
xr, wr = x[:, cols].contiguous(), w[:, cols].contiguous()
res["row"] = tq.quantize_split_rows(
    xr, tq.shard_bits(seed, xr.shape, "cpu", tp, 1), wr,
    tq.shard_bits(seed + 1, wr.shape, "cpu", tp, 1), tp)
n = w.shape[0] // tp.size
wc = w[tp.rank * n:(tp.rank + 1) * n].contiguous()
res["column"] = tq.quantize_int8(
    wc, tq.shard_bits(seed + 1, wc.shape, "cpu", tp, 0))
res["row_out"] = tq.quantized_linear(xr, wr, seed, tp_group=tp,
                                     split="row").detach()
res["column_out"] = tq.quantized_linear(x, wc, seed, tp_group=tp,
                                        split="column").detach()

# Two AdamW steps of each model at tp 2: the first step's gradients
# (summed as the step sums them), then the losses and the state.
for name, model, flags, impl, (tokens, targets) in (
        ("fused", fused_model, dict(fused_norm=True), "kernel",
         (data["fused_tokens"], data["fused_targets"])),
        ("int8", int8_model, dict(quantize_matmuls=True,
                                  attention_fn=attention.flash_attention),
         "auto",
         (data["int8_tokens"], data["int8_targets"]))):
    params = torch.load(os.path.join(out, f"params_{name}.pt"))
    config = train.make_transformer_config(
        mesh=mesh, dtype=torch.float32, max_seq_len=tokens.shape[1],
        **flags, **model)
    harness = train.build_transformer_train(
        config, batch_size=tokens.shape[0], seq_len=tokens.shape[1],
        device="cpu", params=params, mesh=mesh, loss_impl=impl)
    local = harness.shard(tokens, targets)
    loss = harness.loss_fn(*local[:3]) * local[3]
    loss.backward()
    grads, total = harness.sum_grads(loss)
    shapes = [(n, tuple(p.shape)) for n, p in
              harness.model.named_parameters()]
    grad_dict, at = {}, 0
    for pname, shape in shapes:
        size = int(np.prod(shape))
        grad_dict[pname] = grads[at:at + size].view(shape).clone()
        at += size
    before = dict(rc.plain_calls), dict(tq.plain_calls)
    losses = [float(harness.step({"tokens": tokens, "targets": targets})
                    ["loss"]) for _ in range(2)]
    res[name] = {"loss": float(total), "grads": grad_dict,
                 "losses": losses,
                 "state": {n: t.clone() for n, t in
                           harness.model.state_dict().items()},
                 "ring_calls": {k: rc.plain_calls[k] - before[0][k]
                                for k in before[0]},
                 "quant_calls": {k: tq.plain_calls[k] - before[1][k]
                                 for k in before[1]}}
res["drawn"] = sorted(set(drawn))
mesh.close()
torch.save(res, os.path.join(out, f"rank{me}.pt"))
"""


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """Every case on a tp ring of two gloo ranks in one launch: each
    rank's results (in tp order) and the inputs they started from."""
    out = tmp_path_factory.mktemp("tp")
    flax = {"fused": _flax_params(FUSED_MODEL, fused_norm=True),
            "int8": _flax_params(INT8_MODEL, quantize_matmuls=True)}
    for name, tree in flax.items():
        torch.save(convert.params_from_flax(tree), out / f"params_{name}.pt")
    rng = np.random.RandomState(5)
    table = rng.randn(64, 16).astype(np.float32)
    loss_h, loss_e, loss_t = _loss_inputs()
    quant_x, quant_w = _quant_inputs()
    fused_tokens, fused_targets = _batch(FUSED_BATCH_SEED,
                                         FUSED_MODEL["vocab_size"])
    int8_tokens, int8_targets = _batch(INT8_BATCH_SEED,
                                       INT8_MODEL["vocab_size"])
    inputs = dict(
        table=table, lookup_tokens=rng.randint(0, 64, (3, 20)),
        loss_h=loss_h, loss_e=loss_e, loss_t=loss_t, quant_x=quant_x,
        quant_w=quant_w, quant_seed=np.int64(QUANT_SEED),
        fused_tokens=fused_tokens, fused_targets=fused_targets,
        int8_tokens=int8_tokens, int8_targets=int8_targets)
    np.savez(out / "inputs.npz", **inputs)
    np.savez(out / "bits.npz", **{_bits_key(seed, shape): jax_bits(seed, shape)
                                  for seed, shape in BIT_SHAPES})
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local(
        [sys.executable, "-c", TP_WORKER, str(out), repr(FUSED_MODEL),
         repr(INT8_MODEL)], TP, RANKS_TIMEOUT_S, env=env, cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["returncode"], r["stderr"][-3000:])
                     for r in bad]
    ranks = sorted((torch.load(out / f"rank{r}.pt") for r in range(TP)),
                   key=lambda r: r["tp_rank"])
    return {"ranks": ranks, "inputs": inputs, "flax": flax}


# ------------------------------- the regroup -------------------------------


@pytest.mark.parametrize("tp", [2, 4])
def test_fused_regroup_round_trip(tp):
    """A fused state dict's tp shards: each rank's qkv_kernel is
    [q_r|k_r|v_r] and gate_up_kernel [gate_r|up_r] (the model's chunk(3)
    / chunk(2) give it its own heads and ff units), the shapes its
    model builds; gather_state_dict and join_shards invert it bit for
    bit; the embedding's rows split too."""
    cfg = ttfm.TransformerConfig(dtype=torch.float32, fused_norm=True,
                                 **FUSED_MODEL)
    state = convert.init_params(cfg, torch.Generator().manual_seed(4))
    sizes = tmesh.auto_axis_sizes(tp, tp=tp)
    shards = [tsharding.shard_state_dict(state, tmesh.RankMesh(sizes, r))
              for r in range(tp)]

    class Ring:
        size = tp
    local = ttfm.TransformerLM(ttfm.TransformerConfig(
        dtype=torch.float32, fused_norm=True, tp_group=Ring(),
        **FUSED_MODEL), device="meta").state_dict()
    features = FUSED_MODEL["n_heads"] * FUSED_MODEL["d_head"]
    d_ff = FUSED_MODEL["d_ff"]
    for r, shard in enumerate(shards):
        assert {n: tuple(t.shape) for n, t in shard.items()} == \
            {n: tuple(t.shape) for n, t in local.items()}
        for name, width in (("layer_1.attn.qkv_kernel", features),
                            ("layer_0.mlp.gate_up_kernel", d_ff)):
            full, part = state[name], shard[name]
            cut = width // tp
            for i, got in enumerate(part.chunk(part.shape[1] // cut, dim=1)):
                want = full[:, i * width + r * cut:i * width + (r + 1) * cut]
                assert torch.equal(got, want), (name, r, i)
        rows = FUSED_MODEL["vocab_size"] // tp
        assert torch.equal(shard["embed.embedding"],
                           state["embed.embedding"][r * rows:(r + 1) * rows])
        assert torch.equal(shard["layer_0.attn.norm_scale"],
                           state["layer_0.attn.norm_scale"])
    full = tsharding.gather_state_dict(shards)
    assert set(full) == set(state)
    for name, tensor in state.items():
        assert torch.equal(full[name], tensor), name
        if tsharding.tp_dim(name) is not None:
            assert torch.equal(tsharding.join_shards(
                name, [tsharding.take_shard(name, tensor, tp, r)
                       for r in range(tp)]), tensor), name


# ------------------------------ on two ranks -------------------------------


def test_vocab_parallel_lookup_is_bit_for_bit(tp_runs):
    """Each rank looks up its rows and zeros the rest, g sums them: the
    one-card lookup (the reference's table[tokens]) bit for bit, on both
    ranks, in fp32 and bf16."""
    inputs = tp_runs["inputs"]
    want = torch.from_numpy(inputs["table"][inputs["lookup_tokens"]])
    for rank in tp_runs["ranks"]:
        for dtype in (torch.float32, torch.bfloat16):
            got = rank[f"lookup_{dtype}"]
            assert got.dtype == dtype
            assert torch.equal(got, want.to(dtype)), dtype


@pytest.mark.parametrize("impl,reference", [("kernel", "interpret"),
                                            ("plain", "xla")])
def test_vocab_parallel_loss_and_grads_match_reference(tp_runs, impl,
                                                       reference):
    """The vocab-parallel loss on each rank's half of the embedding, some
    targets ignored and live ones in both halves: the loss on both ranks,
    grad_h (summed over the ring) and each rank's grad_E rows against the
    reference's chunked loss on the whole table (K3-K5 in interpret mode,
    or its XLA slabs). One gather of (lse, gold) and one all-reduce of
    grad_h a call."""
    inputs = tp_runs["inputs"]
    loss, grads = jax.value_and_grad(
        lambda h, e: jcl.chunked_softmax_xent(
            h, e, jnp.asarray(inputs["loss_t"]), impl=reference),
        argnums=(0, 1))(jnp.asarray(inputs["loss_h"]),
                        jnp.asarray(inputs["loss_e"]))
    rows = LOSS_VOCAB // TP
    for r, rank in enumerate(tp_runs["ranks"]):
        got_loss, gh, ge, calls = rank[f"loss_{impl}"]
        np.testing.assert_allclose(got_loss, float(loss), **LOSS_TOL)
        np.testing.assert_allclose(gh.numpy(), np.asarray(grads[0]),
                                   **LOSS_TOL)
        np.testing.assert_allclose(
            ge.numpy(), np.asarray(grads[1])[r * rows:(r + 1) * rows],
            **LOSS_TOL)
        assert calls["ring_all_gather"] == 2  # (lse, gold); grad_h's K13
        assert calls["ring_reduce_scatter"] == 1
    assert torch.equal(tp_runs["ranks"][0][f"loss_{impl}"][1],
                       tp_runs["ranks"][1][f"loss_{impl}"][1])


def test_int8_operands_match_reference_bit_for_bit(tp_runs):
    """The int8 operands each rank makes, joined over the ranks: the
    row-parallel x_q and w_q (K split, the absmax taken over the ring)
    and their scales, and the column-parallel weight's rows, against the
    reference's _quantize_kernel in interpret mode on the whole tensors;
    the row-parallel partial outputs sum to the reference's product and
    the column-parallel ones join into it."""
    inputs = tp_runs["inputs"]
    x, w = inputs["quant_x"], inputs["quant_w"]
    with pltpu.force_tpu_interpret_mode():
        want_x = jq.quantize_int8(jnp.asarray(x), QUANT_SEED)
        want_w = jq.quantize_int8(jnp.asarray(w), QUANT_SEED + 1)
        want_out = np.asarray(jq.quantized_linear(
            jnp.asarray(x), jnp.asarray(w.T), QUANT_SEED))
    ranks = tp_runs["ranks"]
    x_q, x_s, w_q, w_s = zip(*(r["row"] for r in ranks))
    np.testing.assert_array_equal(torch.cat(x_q, 1).numpy(),
                                  np.asarray(want_x[0]))
    np.testing.assert_array_equal(torch.cat(w_q, 1).numpy(),
                                  np.asarray(want_w[0]))
    for got_x, got_w in zip(x_s, w_s):
        np.testing.assert_array_equal(got_x.numpy().view(np.int32),
                                      np.asarray(want_x[1]).view(np.int32))
        np.testing.assert_array_equal(got_w.numpy().view(np.int32),
                                      np.asarray(want_w[1]).view(np.int32))
    c_q, c_s = zip(*(r["column"] for r in ranks))
    np.testing.assert_array_equal(torch.cat(c_q).numpy(),
                                  np.asarray(want_w[0]))
    np.testing.assert_array_equal(torch.cat(c_s).numpy().view(np.int32),
                                  np.asarray(want_w[1]).view(np.int32))
    np.testing.assert_allclose(sum(r["row_out"] for r in ranks).numpy(),
                               want_out, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        torch.cat([r["column_out"] for r in ranks], 1).numpy(), want_out)


def _reference_step(name):
    """The reference's one-device two-step run of the named model, built
    by hand as tests/test_torch_train.py builds it: (the first step's
    loss and gradients as a state dict, each step's loss, the params
    after two steps)."""
    if name == "fused":
        model_args, flags = FUSED_MODEL, dict(fused_norm=True)
        loss_impl, seed = "interpret", FUSED_BATCH_SEED
    else:
        model_args = INT8_MODEL
        flags = dict(quantize_matmuls=True,
                     attention_fn=lambda q, k, v, causal:
                     jattn.flash_attention(q, k, v, causal))
        loss_impl, seed = "xla", INT8_BATCH_SEED
    tokens, targets = _batch(seed, model_args["vocab_size"])
    model = jtfm.TransformerLM(jtfm.TransformerConfig(
        dtype=jnp.float32, max_seq_len=SEQ, **flags, **model_args))
    optimizer = optax.adamw(3e-4, weight_decay=0.01)

    def loss_fn(p, tok, tgt):
        hidden = model.apply({"params": p}, tok, return_hidden=True)
        return jtfm.lm_loss_chunked(hidden, p["embed"]["embedding"], tgt,
                                    impl=loss_impl)

    @jax.jit
    def step(p, state, tok, tgt):
        loss, grads = jax.value_and_grad(loss_fn)(p, tok, tgt)
        updates, state = optimizer.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss, grads

    p = _flax_params(model_args, **{k: v for k, v in flags.items()
                                    if k != "attention_fn"})
    state = optimizer.init(p)
    losses, first = [], None
    with pltpu.force_tpu_interpret_mode():
        for _ in range(2):
            p, state, loss, grads = step(p, state, jnp.asarray(tokens),
                                         jnp.asarray(targets))
            losses.append(float(loss))
            if first is None:
                first = convert.params_from_flax(
                    jax.tree_util.tree_map(np.asarray, grads))
    return first, losses, p


def _gathered(ranks, name, key):
    return tsharding.gather_state_dict([r[name][key] for r in ranks])


@pytest.mark.parametrize("name", ["fused", "int8"])
def test_tp2_model_matches_reference(tp_runs, name):
    """--tp 2 --fused-norm (the loss on K3-K5's plain versions) and --tp
    2 --int8 (the plain slabs) against the reference's one-device model
    on the same weights, batch and bits: the first step's loss and
    gradients gathered over the ranks (the fused norm scales' summed
    over the ring), then two AdamW steps' losses and parameters; the
    replicated parameters equal on both ranks."""
    grads, losses, params = _reference_step(name)
    ranks = tp_runs["ranks"]
    for rank in ranks:
        np.testing.assert_allclose(rank[name]["loss"], losses[0],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(rank[name]["losses"], losses,
                                   rtol=LOSS_RTOL)
    got = _gathered(ranks, name, "grads")
    assert set(got) == set(grads)
    for pname, g in grads.items():
        np.testing.assert_allclose(got[pname].numpy(), g.numpy(),
                                   err_msg=pname, **GRAD_TOL)
    if name == "fused":
        assert any("norm_scale" in n for n in got)
    state = _gathered(ranks, name, "state")
    want = convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           params))
    for pname, w in want.items():
        np.testing.assert_allclose(state[pname].numpy(), w.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=pname)
        if tsharding.tp_dim(pname) is None:
            assert torch.equal(ranks[0][name]["state"][pname],
                               ranks[1][name]["state"][pname]), pname


def test_tp2_ring_calls_per_step(tp_runs):
    """Each of two steps' tp ring calls on a rank (CPU: the plain
    versions; no remat): per layer 4 all-reduces (g twice, f twice), the
    embedding's g and grad_h's all-reduce, and the loss's one gather;
    with fused_norm one more all-reduce, of the norm scales' gradients;
    with int8 one absmax gather per row-parallel product (o and down).
    The int8 ranks' row-parallel products: two absmax and two scaled
    quantizes each, in place of K10's two."""
    layers = FUSED_MODEL["n_layers"]
    for rank in tp_runs["ranks"]:
        for name, extra_ar, extra_ag in (("fused", 1, 0),
                                         ("int8", 0, 2 * layers)):
            calls = rank[name]["ring_calls"]
            all_reduces = 4 * layers + 2 + extra_ar
            assert calls["ring_reduce_scatter"] == 2 * all_reduces, name
            assert calls["ring_all_gather"] == 2 * (all_reduces + 1 +
                                                    extra_ag), name
        quant = rank["int8"]["quant_calls"]
        products = 2 * 7 * layers  # two steps
        assert quant["int8_matmul"] == products
        assert quant["row_absmax"] == quant["quantize_scaled"] == \
            2 * 2 * 2 * layers
        assert quant["quantize_int8"] == 2 * products - \
            quant["quantize_scaled"]


@pytest.mark.parametrize("flag", ["--fused-norm", "--int8"])
def test_train_cli_tp_with_flag_on_cpu(flag):
    """`torch.distributed.run --nproc-per-node 4 ... --tp 2 --sp 2
    --fused-norm` (and `--int8`) as four local gloo ranks: finite losses,
    the replicated parameters one digest on all ranks and each tp shard
    one on the ranks of its tp index, no kernel launch."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local([
        sys.executable, "-m",
        "batch_shipyard_tpu_torch.workloads.train_transformer", "--tp", "2",
        "--sp", "2", "--device", "cpu", "--d-model", "32", "--n-layers", "2",
        "--n-heads", "2", "--d-ff", "64", "--vocab", "64", "--seq-len", "32",
        "--batch", "2", "--steps", "2", "--warmup", "1", flag],
        4, RANKS_TIMEOUT_S, env=env, cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["stderr"][-2000:]) for r in bad]
    report = json.loads(runs[0]["stdout"].strip().splitlines()[-1])
    assert report["mesh"]["tp"] == 2 and report["mesh"]["sp"] == 2
    assert all(math.isfinite(x) for x in report["losses"])
    ranks = report["per_rank"]
    for rank, r in enumerate(ranks):
        assert not r["launches"]
        assert r["params_sha256"]["replicated"] == \
            ranks[0]["params_sha256"]["replicated"]
        assert r["params_sha256"]["tp_shard"] == \
            ranks[rank % 2]["params_sha256"]["tp_shard"]
    assert ranks[0]["params_sha256"]["tp_shard"] != \
        ranks[1]["params_sha256"]["tp_shard"]
