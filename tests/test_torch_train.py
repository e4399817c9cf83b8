"""The port's training slice (models/transformer training forward,
lm_loss_chunked, parallel/train.py, parallel/mfu.py and
workloads/train_transformer.py) against the JAX reference on the CPU.

The same flax params (params_from_flax) and numpy-seeded batches go
through both packages in fp32. Tolerances: losses within 1e-5 relative,
parameters after two AdamW steps within 1e-5 absolute, logits within
1e-4 (fp32) or 2e-2 of the largest logit (bf16, which rounds at other
places in the two frameworks). No parameter element is excluded: the
smallest gradient element in these batches is ~1e-8, Adam's eps, and
the two frameworks' gradients differ by < 2e-7, so no update flips
sign.
"""

import dataclasses
import json
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
from batch_shipyard_tpu.parallel import mesh as jmesh
from batch_shipyard_tpu.parallel import mfu as jmfu
from batch_shipyard_tpu.parallel import train as jtrain
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.ops import attention as tattn
from batch_shipyard_tpu_torch.ops import chunked_loss as tcl
from batch_shipyard_tpu_torch.ops import fused_norm as tfn
from batch_shipyard_tpu_torch.parallel import mesh as tmesh
from batch_shipyard_tpu_torch.parallel import mfu as tmfu
from batch_shipyard_tpu_torch.parallel import train as ttrain
from batch_shipyard_tpu_torch.workloads import distributed
from batch_shipyard_tpu_torch.workloads import train_transformer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_TIMEOUT_S = 120
MODEL = dict(vocab_size=256, d_model=64, n_layers=2, n_heads=4, d_head=16,
             d_ff=128)
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this module's small torch ops on one thread: the suite runs
    in several worker processes beside timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed, batch, seq):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, MODEL["vocab_size"], (batch, seq)).astype(np.int32),
            rng.randint(0, MODEL["vocab_size"], (batch, seq)).astype(np.int32))


def _flax_init(seq, dtype=jnp.float32):
    cfg = jtfm.TransformerConfig(dtype=dtype, max_seq_len=seq, **MODEL)
    params = jtfm.TransformerLM(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _port_harness(seq, batch, params, **cfg):
    config = ttrain.make_transformer_config(
        dtype=torch.float32, max_seq_len=seq, **MODEL, **cfg)
    return ttrain.build_transformer_train(
        config, batch_size=batch, seq_len=seq, device="cpu",
        params=convert.params_from_flax(params))


def _assert_params_close(model, flax_tree):
    want = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, flax_tree))
    got = model.state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=name)


def test_two_adamw_steps_match_reference_flash_step():
    """The reference step built by hand from its own pieces, as
    build_transformer_train's loss_fn and step are: TransformerLM on
    flash_attention (K1/K2 in interpret mode), lm_loss_chunked,
    optax.adamw(3e-4, weight_decay=0.01), one jax.jit. The port runs
    its flash_attention (on CPU tensors, the kernels' plain
    versions)."""
    seq, batch = 128, 2
    tokens, targets = _batch(0, batch, seq)
    params = _flax_init(seq)
    jcfg = jtfm.TransformerConfig(
        dtype=jnp.float32, max_seq_len=seq, **MODEL,
        attention_fn=lambda q, k, v, causal: jattn.flash_attention(
            q, k, v, causal))
    model = jtfm.TransformerLM(jcfg)
    optimizer = optax.adamw(3e-4, weight_decay=0.01)

    def loss_fn(p, tok, tgt):
        hidden = model.apply({"params": p}, tok, return_hidden=True)
        return jtfm.lm_loss_chunked(hidden, p["embed"]["embedding"], tgt,
                                    impl="xla")

    @jax.jit
    def step(p, state, tok, tgt):
        loss, grads = jax.value_and_grad(loss_fn)(p, tok, tgt)
        updates, state = optimizer.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    harness = _port_harness(seq, batch, params,
                            attention_fn=tattn.flash_attention)
    p, state = params, optimizer.init(params)
    launches = dict(tattn.launches)
    plain_fwd = tattn.plain_calls["flash_fwd"]
    with pltpu.force_tpu_interpret_mode():
        for _ in range(2):
            p, state, want = step(p, state, jnp.asarray(tokens),
                                  jnp.asarray(targets))
            got = harness.step({"tokens": tokens, "targets": targets})
            np.testing.assert_allclose(float(got["loss"]), float(want),
                                       rtol=LOSS_RTOL)
    _assert_params_close(harness.model, p)
    assert tattn.plain_calls["flash_fwd"] == plain_fwd + 2 * MODEL["n_layers"]
    assert tattn.launches == launches  # CPU tensors never reach a kernel


FUSED_MODEL = dict(vocab_size=256, d_model=128, n_layers=2, n_heads=4,
                   d_head=32, d_ff=128)


def test_two_adamw_steps_fused_norm_and_fused_loss_match_reference():
    """bench_transformer's fused configuration at a small width (d_model
    128, so the fused loss is not sent to the slab path by the d % 128
    rule): the reference step built by hand from flax fused_norm,
    lm_loss_chunked(impl="interpret") (K3-K5 in interpret mode) and
    optax.adamw, against the port's harness with lm_loss_chunked(
    impl="kernel") (its Function on the kernels' plain versions) and
    rmsnorm_matmul (K9's plain version). The same flax weights go into
    both."""
    seq, batch = 64, 2
    # Seeds whose smallest gradient element (7.8e-8) sits above Adam's
    # eps, so the two frameworks' ~1e-8 gradient differences cannot flip
    # an update (see the module doc).
    rng = np.random.RandomState(7)
    tokens, targets = (rng.randint(0, FUSED_MODEL["vocab_size"],
                                   (batch, seq)).astype(np.int32)
                       for _ in range(2))
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, max_seq_len=seq,
                                  fused_norm=True, **FUSED_MODEL)
    model = jtfm.TransformerLM(jcfg)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, seq), jnp.int32))["params"])
    optimizer = optax.adamw(3e-4, weight_decay=0.01)

    def loss_fn(p, tok, tgt):
        hidden = model.apply({"params": p}, tok, return_hidden=True)
        return jtfm.lm_loss_chunked(hidden, p["embed"]["embedding"], tgt,
                                    impl="interpret")

    @jax.jit
    def step(p, state, tok, tgt):
        loss, grads = jax.value_and_grad(loss_fn)(p, tok, tgt)
        updates, state = optimizer.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    config = ttrain.make_transformer_config(
        dtype=torch.float32, max_seq_len=seq, fused_norm=True, **FUSED_MODEL)
    harness = ttrain.build_transformer_train(
        config, batch_size=batch, seq_len=seq, device="cpu",
        params=convert.params_from_flax(params), loss_impl="kernel")
    p, state = params, optimizer.init(params)
    calls = dict(tcl.plain_calls)
    norm_calls = tfn.plain_calls["rmsnorm_matmul"]
    for _ in range(2):
        p, state, want = step(p, state, jnp.asarray(tokens),
                              jnp.asarray(targets))
        got = harness.step({"tokens": tokens, "targets": targets})
        np.testing.assert_allclose(float(got["loss"]), float(want),
                                   rtol=LOSS_RTOL)
    _assert_params_close(harness.model, p)
    assert "layer_0.attn.qkv_kernel" in harness.model.state_dict()
    for key in ("xent_fwd", "xent_bwd_h", "xent_bwd_e"):
        assert tcl.plain_calls[key] == calls[key] + 2
    assert tcl.plain_calls["chunked"] == calls["chunked"]
    assert tfn.plain_calls["rmsnorm_matmul"] == \
        norm_calls + 2 * 2 * FUSED_MODEL["n_layers"]


def test_two_adamw_steps_quantize_matmuls_match_reference(monkeypatch):
    """bench_transformer(quantize=True)'s lever at a small width: the
    reference step built by hand (flax quantize_matmuls on its interpret-
    mode K10/K11 and K1/K2, lm_loss_chunked, optax.adamw) against the
    port's harness (the kernels' plain versions), on the same weights,
    batch and rounding bits: the port's random_bits returns the
    reference's jax.random.bits for each (seed, shape)."""
    from batch_shipyard_tpu_torch.ops import quantization as tq

    def reference_bits(seed, shape, device):
        return torch.from_numpy(np.array(jax.lax.bitcast_convert_type(
            jax.random.bits(jax.random.PRNGKey(seed), tuple(shape),
                            jnp.uint32), jnp.int32))).to(device)
    monkeypatch.setattr(tq, "random_bits", reference_bits)
    seq, batch = 64, 2
    # A batch seed where no int8 value rounds the other way between the
    # frameworks: their fp32 activations differ in the last bits, and on
    # batch seeds 0-5 at least one element flips, which moves the loss by
    # up to 3e-4 relative (ROADMAP queue 3).
    tokens, targets = _batch(6, batch, seq)
    params = _flax_init(seq)
    jcfg = jtfm.TransformerConfig(
        dtype=jnp.float32, max_seq_len=seq, quantize_matmuls=True, **MODEL,
        attention_fn=lambda q, k, v, causal: jattn.flash_attention(
            q, k, v, causal))
    model = jtfm.TransformerLM(jcfg)
    optimizer = optax.adamw(3e-4, weight_decay=0.01)

    def loss_fn(p, tok, tgt):
        hidden = model.apply({"params": p}, tok, return_hidden=True)
        return jtfm.lm_loss_chunked(hidden, p["embed"]["embedding"], tgt,
                                    impl="xla")

    @jax.jit
    def step(p, state, tok, tgt):
        loss, grads = jax.value_and_grad(loss_fn)(p, tok, tgt)
        updates, state = optimizer.update(grads, state, p)
        return optax.apply_updates(p, updates), state, loss

    harness = _port_harness(seq, batch, params, quantize_matmuls=True,
                            attention_fn=tattn.flash_attention)
    p, state = params, optimizer.init(params)
    calls = dict(tq.plain_calls)
    with pltpu.force_tpu_interpret_mode():
        for _ in range(2):
            p, state, want = step(p, state, jnp.asarray(tokens),
                                  jnp.asarray(targets))
            got = harness.step({"tokens": tokens, "targets": targets})
            np.testing.assert_allclose(float(got["loss"]), float(want),
                                       rtol=LOSS_RTOL)
    _assert_params_close(harness.model, p)
    projections = 2 * 7 * MODEL["n_layers"]  # two steps
    assert tq.plain_calls["int8_matmul"] == \
        calls["int8_matmul"] + projections
    assert tq.plain_calls["quantize_int8"] == \
        calls["quantize_int8"] + 2 * projections


def test_matches_reference_build_transformer_train_on_cpu_mesh():
    """The reference's own build_transformer_train on the 8-device CPU
    mesh (dp = 8, its default CPU attention: blockwise) against the
    port's harness with its CPU default (blockwise), batch 8."""
    seq, batch = 64, 8
    tokens, targets = _batch(1, batch, seq)
    mesh = jmesh.make_mesh(jmesh.auto_axis_sizes(len(jax.devices())))
    jcfg = jtrain.make_transformer_config(mesh, dtype=jnp.float32,
                                          max_seq_len=seq, **MODEL)
    ref = jtrain.build_transformer_train(mesh, jcfg, batch_size=batch,
                                         seq_len=seq)
    # Copied out before stepping: the reference's step donates them.
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    harness = _port_harness(seq, batch, params)
    p, state = ref.params, ref.opt_state
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    for _ in range(2):
        p, state, metrics = ref.step(p, state, jbatch)
        got = harness.step({"tokens": tokens, "targets": targets})
        np.testing.assert_allclose(float(got["loss"]),
                                   float(metrics["loss"]), rtol=LOSS_RTOL)
    _assert_params_close(harness.model, p)


def test_remat_matches_no_remat():
    """remat=True recomputes each block in the backward: the same loss
    and gradients as remat=False (the same ops in the same order)."""
    seq, batch = 32, 2
    tokens, targets = _batch(2, batch, seq)
    params = _flax_init(seq)
    results = []
    for remat in (False, True):
        harness = _port_harness(seq, batch, params, remat=remat)
        loss = harness.loss_fn(torch.from_numpy(tokens),
                               torch.from_numpy(targets))
        loss.backward()
        results.append((float(loss.detach()),
                        {n: q.grad for n, q in
                         harness.model.named_parameters()}))
    (loss_a, grads_a), (loss_b, grads_b) = results
    assert loss_a == pytest.approx(loss_b, rel=1e-6)
    for name, g in grads_a.items():
        np.testing.assert_allclose(grads_b[name].numpy(), g.numpy(),
                                   atol=1e-7, rtol=1e-6, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_logits_match_reference(dtype):
    """The non-decode forward (no cache): logits and hidden states
    against the reference's, on the same weights and tokens."""
    seq = 48
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tokens, _ = _batch(3, 2, seq)
    params = _flax_init(seq)
    jmodel = jtfm.TransformerLM(jtfm.TransformerConfig(
        dtype=jdt, max_seq_len=seq, **MODEL))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(tokens)),
                      np.float32)
    tmodel = ttfm.TransformerLM(ttfm.TransformerConfig(
        dtype=tdt, max_seq_len=seq, **MODEL))
    tmodel.load_state_dict(convert.params_from_flax(params))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(tokens)).float().numpy()
    assert got.shape == (2, seq, MODEL["vocab_size"])
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=2e-2)


def test_mfu_accounting_matches_reference_and_model():
    cfg = ttfm.TransformerConfig(**MODEL)
    jcfg = jtfm.TransformerConfig(**MODEL)
    model = ttfm.TransformerLM(cfg, device="meta")
    assert tmfu.transformer_param_count(cfg) == sum(
        p.numel() for p in model.parameters())
    assert tmfu.transformer_param_count(cfg) == \
        jmfu.transformer_param_count(jcfg)
    for causal in (True, False):
        assert tmfu.transformer_train_flops_per_token(cfg, 128, causal) == \
            jmfu.transformer_train_flops_per_token(jcfg, 128, causal)
    assert tmfu.peak_bf16_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert tmfu.peak_bf16_tflops("cpu") is None
    assert tmfu.mfu_pct(1000.0, 1e9, None) is None
    assert tmfu.mfu_pct(1000.0, 1e9, 1.0) == pytest.approx(100.0)


def test_harness_contract():
    params = _flax_init(16)
    harness = _port_harness(16, 2, params)
    assert isinstance(harness.optimizer, torch.optim.AdamW)
    group, = harness.optimizer.param_groups
    assert group["weight_decay"] == 0.01 and group["lr"] == 3e-4
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert len(group["params"]) == len(list(harness.model.parameters()))
    tokens, targets = _batch(4, 1, 16)
    with pytest.raises(ValueError, match="built for"):
        harness.step({"tokens": tokens, "targets": targets})
    with pytest.raises(ValueError, match="decode=False"):
        ttrain.build_transformer_train(
            dataclasses.replace(harness.model.config, decode=True), 2, 16,
            device="cpu")


def test_train_cli_on_cpu(capsys):
    rc = train_transformer.main([
        "--device", "cpu", "--d-model", "32", "--n-layers", "1",
        "--n-heads", "2", "--d-ff", "64", "--vocab", "64", "--seq-len",
        "16", "--batch", "2", "--steps", "2", "--warmup", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("[proc 0/1] transformer: mesh=")
    assert " device=cpu " in lines[-2]
    assert "tok/s, loss=" in lines[-2] and lines[-2].endswith("ms/step")
    report = json.loads(lines[-1])
    assert report["device"] == "cpu" and report["mfu_pct"] is None
    assert report["tokens_per_sec"] > 0 and np.isfinite(report["loss"])
    assert report["mesh"]["sp"] == 1 and len(report["per_rank"]) == 1


def _run_ranks(argv, nprocs=4):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local(argv, nprocs, RANKS_TIMEOUT_S, env=env,
                                    cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["returncode"], r["stderr"][-2000:])
                     for r in bad]
    return runs


def test_train_cli_sp4_on_cpu():
    """`torch.distributed.run --nproc-per-node 4 ... --sp 4 --device cpu`
    as four local ranks: rank 0 prints the summary line with the mesh,
    then the JSON line with the global batch's tokens/s and every rank's
    launches (none: CPU tensors take the plain versions)."""
    runs = _run_ranks([
        sys.executable, "-m",
        "batch_shipyard_tpu_torch.workloads.train_transformer", "--sp", "4",
        "--device", "cpu", "--d-model", "32", "--n-layers", "1",
        "--n-heads", "2", "--d-ff", "64", "--vocab", "64", "--seq-len",
        "32", "--batch", "2", "--steps", "2", "--warmup", "1"])
    lines = runs[0]["stdout"].strip().splitlines()
    assert lines[-2].startswith("[proc 0/4] transformer: mesh={'dp': 1, "
                                "'fsdp': 1, 'ep': 1, 'sp': 4, 'tp': 1}")
    report = json.loads(lines[-1])
    assert report["mesh"]["sp"] == 4 and np.isfinite(report["loss"])
    assert [r["rank"] for r in report["per_rank"]] == [0, 1, 2, 3]
    assert all(not r["launches_per_step"] for r in report["per_rank"])
    assert all(not run["stdout"].strip() for run in runs[1:])


# A rank of a world of 4 at sp = 2: its ring.
DP_SP_WORKER = r"""
import json
from batch_shipyard_tpu_torch.parallel import mesh, train
from batch_shipyard_tpu_torch.workloads import distributed
distributed.setup("cpu")
group = train.sequence_parallel_group(2, "cpu", world=4)
try:
    mesh.RankMesh.of_sp_group(group)
    refused = None
except ValueError as err:
    refused = str(err)
print(json.dumps({"ranks": group.ranks, "rank": group.rank,
                  "axis": group.axis, "refused": refused}))
group.close()
"""


def test_sequence_parallel_group_over_dp():
    """A world of 4 at sp = 2 is dp = 2 sp rings: each rank gets the ring
    of its dp index, at its sp index (no longer NotImplementedError)."""
    assert ttrain.sequence_parallel_group(1, "cpu", world=1) is None
    with pytest.raises(ValueError, match="RingGroup of 4"):
        ttrain.make_transformer_config(sp=4)
    runs = _run_ranks([sys.executable, "-c", DP_SP_WORKER])
    got = [json.loads(run["stdout"].strip().splitlines()[-1])
           for run in runs]
    sizes = tmesh.auto_axis_sizes(4, sp=2)
    assert sizes == {"dp": 2, "fsdp": 1, "ep": 1, "sp": 2, "tp": 1}
    for rank, ring in enumerate(got):
        coords = tmesh.RankMesh(sizes, rank).coords
        assert ring["ranks"] == ([0, 1] if rank < 2 else [2, 3])
        assert ring["rank"] == rank % 2 == coords["sp"]
        assert coords["dp"] == rank // 2
        assert ring["axis"] == "sp"
        # Half the world is no sp-only mesh: a step needs RankMesh.build.
        assert "pass the mesh (RankMesh.build)" in ring["refused"]


# A rank of the sp = 4 two-step check: the same flax weights and global
# batch on every rank, two AdamW steps, the losses and weights saved.
SP_WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.ops import ring_collectives
from batch_shipyard_tpu_torch.parallel import train
from batch_shipyard_tpu_torch.workloads import distributed
out = sys.argv[1]
model = eval(sys.argv[2])
distributed.setup("cpu")
group = train.sequence_parallel_group(4, "cpu")
data = np.load(os.path.join(out, "batch.npz"))
seq, batch = data["tokens"].shape[1], data["tokens"].shape[0]
config = train.make_transformer_config(
    sp=4, group=group, dtype=torch.float32, max_seq_len=seq, **model)
harness = train.build_transformer_train(
    config, batch_size=batch, seq_len=seq, device="cpu",
    params=torch.load(os.path.join(out, "params.pt")), group=group)
losses = [float(harness.step({"tokens": data["tokens"],
                              "targets": data["targets"]})["loss"])
          for _ in range(2)]
torch.save({"losses": losses, "state": harness.model.state_dict(),
            "plain_calls": dict(ring_collectives.plain_calls)},
           os.path.join(out, f"rank{group.rank}.pt"))
"""


def test_two_adamw_steps_sp4_match_reference_build_transformer_train(
        tmp_path):
    """The reference's build_transformer_train on a mesh with sp=4 over
    jax.devices()[:4] (its CPU ring attention: impl "xla") against four
    gloo ranks of the port's sp harness (ring attention's plain tier;
    the gradient all-reduce K14 + K13's plain versions) on the same flax
    weights and batch."""
    seq, batch = 64, 2
    # A batch seed whose smallest gradient element stays clear of Adam's
    # eps (ROADMAP queue 3).
    tokens, targets = _batch(8, batch, seq)
    mesh = jmesh.make_mesh(jmesh.auto_axis_sizes(4, sp=4),
                           devices=jax.devices()[:4])
    jcfg = jtrain.make_transformer_config(mesh, dtype=jnp.float32,
                                          max_seq_len=seq, **MODEL)
    ref = jtrain.build_transformer_train(mesh, jcfg, batch_size=batch,
                                         seq_len=seq)
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    torch.save(convert.params_from_flax(params), tmp_path / "params.pt")
    np.savez(tmp_path / "batch.npz", tokens=tokens, targets=targets)
    _run_ranks([sys.executable, "-c", SP_WORKER, str(tmp_path),
                repr(MODEL)])
    p, state = ref.params, ref.opt_state
    jbatch = {"tokens": jnp.asarray(tokens), "targets": jnp.asarray(targets)}
    want = []
    for _ in range(2):
        p, state, metrics = ref.step(p, state, jbatch)
        want.append(float(metrics["loss"]))
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(4)]
    for got in ranks:
        np.testing.assert_allclose(got["losses"], want, rtol=LOSS_RTOL)
        # Forward 3 rotations a layer, backward 3, over 2 steps; one
        # reduce-scatter and one all-gather a step.
        assert got["plain_calls"]["ring_permute"] == 2 * 6 * MODEL["n_layers"]
        assert got["plain_calls"]["ring_reduce_scatter"] == 2
        assert got["plain_calls"]["ring_all_gather"] == 2
        for name, value in got["state"].items():  # one step on every rank
            assert torch.equal(value, ranks[0]["state"][name]), name
    harness = _port_harness(seq, batch, params)
    harness.model.load_state_dict(ranks[0]["state"])
    _assert_params_close(harness.model, p)
