"""The port's mixture of experts (models/moe.py and its place in
models/transformer.py, parallel/train.py, parallel/sharding.py,
parallel/mfu.py and the train workload) against the JAX reference on the
CPU, on the same weights (params_from_flax) and numpy-seeded inputs.

Tolerances, set before the first run:
- routing: the dense dispatch rebuilt from the port's indices equals the
  reference's exactly; the combine is nonzero exactly where the dispatch
  is, equals the dispatch times the port's own gates bit for bit, and
  the reference's within 1e-6 (the two frameworks' fp32 softmaxes differ
  in the last bits); the aux loss within 1e-6 relative;
- MoEMLP and the MoE transformer in fp32: outputs, losses and gradients
  within 1e-5 of the largest element of the tensor (relative);
- MoEMLP in bf16: outputs and gradients within 3e-2 of the largest
  element (bf16 rounds at other places in the two frameworks, as the
  dense bf16 tests find), the loss within 2e-2 relative.
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from batch_shipyard_tpu.models import moe as jmoe
from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu.parallel import mesh as jmesh
from batch_shipyard_tpu.parallel import mfu as jmfu
from batch_shipyard_tpu.parallel import sharding as jsharding
from batch_shipyard_tpu.parallel import train as jtrain
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import moe as tmoe
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.parallel import mfu as tmfu
from batch_shipyard_tpu_torch.parallel import sharding as tsharding
from batch_shipyard_tpu_torch.parallel import train as ttrain
from batch_shipyard_tpu_torch.workloads import train_transformer

MODEL = dict(vocab_size=128, d_model=32, n_layers=2, n_heads=2, d_head=16,
             d_ff=64)
ROUTINGS = {"top1": dict(), "top2": dict(num_selected=2),
            "expert_choice": dict(routing="expert_choice")}
FP32_RTOL, BF16_RTOL = 1e-5, 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_routing(name, logits, capacity):
    logits = jnp.asarray(logits)
    if name == "top1":
        return jmoe.top1_routing(logits, capacity)
    if name == "top2":
        return jmoe.topk_routing(logits, capacity, num_selected=2)
    return jmoe.expert_choice_routing(logits, capacity)


def _port_routing(name, logits, capacity):
    logits = torch.from_numpy(logits)
    if name == "top1":
        return tmoe.top1_routing(logits, capacity)
    if name == "top2":
        return tmoe.topk_routing(logits, capacity, num_selected=2)
    return tmoe.expert_choice_routing(logits, capacity)


def _logits(seed, groups=96, experts=8):
    """Random logits with a crowded expert 0 and 3, so the tight
    capacities drop tokens."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(groups, experts).astype(np.float32) * 2.0
    logits[: groups // 3, 0] += 4.0
    logits[groups // 3: groups // 2, 3] += 4.0
    return logits


@pytest.mark.parametrize("capacity", [5, 15, 96])
@pytest.mark.parametrize("name", list(ROUTINGS))
def test_routing_rebuilds_the_references_dispatch_and_combine(name,
                                                              capacity):
    logits = _logits(capacity)
    dispatch, combine, aux = _reference_routing(name, logits, capacity)
    routing = _port_routing(name, logits, capacity)
    got_d, got_c = tmoe.dense_dispatch_combine(routing, 8, capacity)
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(dispatch))
    assert torch.equal(got_c != 0, got_d != 0)
    kept = routing.position >= 0
    tokens = torch.arange(len(logits))[:, None].expand_as(kept)
    assert torch.equal(got_c[tokens[kept], routing.expert[kept],
                             routing.position[kept]], routing.gate[kept])
    np.testing.assert_allclose(got_c.numpy(), np.asarray(combine), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(float(routing.aux), float(aux), rtol=1e-6)
    if name != "expert_choice" and capacity < 96:
        assert (~kept).any()  # the crowded experts overflow


def test_capacity_drops_overflow_and_top2_priority():
    """The reference's own capacity tests on the port: every token
    prefers expert 0 and capacity 4 keeps four; top-2 fills the first
    choices to capacity before the second ones."""
    logits = np.tile(np.asarray([[10.0] + [0.0] * 7], np.float32), (32, 1))
    routing = tmoe.top1_routing(torch.from_numpy(logits), capacity=4)
    assert int((routing.position >= 0).sum()) == 4
    assert routing.position[:4, 0].tolist() == [0, 1, 2, 3]
    logits = np.tile(np.asarray([[5.0, 3.0] + [-5.0] * 6], np.float32),
                     (16, 1))
    routing = tmoe.topk_routing(torch.from_numpy(logits), capacity=4,
                                num_selected=2)
    dispatch, _ = tmoe.dense_dispatch_combine(routing, 8, 4)
    assert dispatch.sum((0, 2)).tolist() == [4.0, 4.0] + [0.0] * 6


def _simulated_routing(name, logits, capacity, blocks, sp, monkeypatch):
    """Each rank of a (blocks x sp) layout of a [B, T, E] logits tensor
    routes its block through route() with a stand-in tokens ring whose
    all-gather returns every rank's input in member order: a first pass
    records each rank's input, a second routes. Returns per rank (the
    Routing, its row and column slices)."""
    batch, seq, experts = logits.shape
    rows, width = batch // blocks, seq // sp
    inputs = {}

    class Ring:
        def __init__(self, rank):
            self.rank, self.size = rank, blocks * sp

    def gather(x, group):
        inputs[group.rank] = x.clone()
        if len(inputs) < group.size:
            return x.repeat(group.size, *([1] * (x.dim() - 1)))
        return torch.cat([inputs[m] for m in range(group.size)])

    monkeypatch.setattr(tmoe, "ring_all_gather", gather)
    cfg = tmoe.MoEConfig(num_experts=experts, **ROUTINGS[name])
    out = {}
    for _ in range(2):
        for member in range(blocks * sp):
            block, piece = divmod(member, sp)
            r = slice(block * rows, (block + 1) * rows)
            c = slice(piece * width, (piece + 1) * width)
            tokens = tmoe.TokenRanks(Ring(member), sp)
            out[member] = (tmoe.route(torch.from_numpy(logits[r, c]),
                                      capacity, cfg, tokens), r, c)
    return out


@pytest.mark.parametrize("blocks,sp", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("name", list(ROUTINGS))
def test_global_routing_over_token_ranks_is_one_ranks(name, blocks, sp,
                                                      monkeypatch):
    """The global routing: every rank's experts, slots and gates for its
    tokens are one rank's routing of the whole batch at those tokens, and
    the aux shares add up to its aux."""
    batch, seq, experts = 4, 24, 8
    logits = _logits(blocks * 10 + sp, batch * seq, experts).reshape(
        batch, seq, experts)
    capacity = tmoe.capacity_for(1.25, batch * seq, experts)
    whole = tmoe.route(torch.from_numpy(logits), capacity,
                       tmoe.MoEConfig(num_experts=experts, **ROUTINGS[name]))
    choices = whole.expert.shape[1]

    def at(t, r, c):
        return t.view(batch, seq, choices)[r, c].reshape(-1, choices)
    aux = 0.0
    for routing, r, c in _simulated_routing(
            name, logits, capacity, blocks, sp, monkeypatch).values():
        assert torch.equal(routing.expert, at(whole.expert, r, c))
        assert torch.equal(routing.position, at(whole.position, r, c))
        assert torch.equal(routing.gate, at(whole.gate, r, c))
        aux += float(routing.aux)
    np.testing.assert_allclose(aux, float(whole.aux), rtol=1e-6, atol=1e-7)


def _moe_pair(name, dtype, seed=3):
    cfg = jmoe.MoEConfig(num_experts=4, d_model=16, d_ff=32,
                         dtype=jnp.float32 if dtype == torch.float32
                         else jnp.bfloat16, **ROUTINGS[name])
    layer = jmoe.MoEMLP(cfg)
    x = np.random.RandomState(seed).randn(2, 12, 16).astype(np.float32)
    params = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    port = tmoe.MoEMLP(tmoe.MoEConfig(num_experts=4, d_model=16, d_ff=32,
                                      dtype=dtype, **ROUTINGS[name]))
    port.load_state_dict(convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return layer, params, port, x


def _rel_close(got, want, rtol, what):
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - want).max()) / scale
    assert err <= rtol, (what, err)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", list(ROUTINGS))
def test_moe_mlp_forward_and_grads_match_reference(name, dtype):
    layer, params, port, x = _moe_pair(name, dtype)
    weights = jnp.arange(16.0) / 16.0

    def loss_fn(p, xs):
        out, aux = layer.apply({"params": p}, xs)
        return jnp.sum(out.astype(jnp.float32) * weights) + 5.0 * aux, out

    (want_loss, want_out), (g_params, g_x) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = port(xt)
    loss = (out.float() * torch.tensor(np.asarray(weights))).sum() + \
        5.0 * aux
    loss.backward()
    rtol = FP32_RTOL if dtype == torch.float32 else BF16_RTOL
    assert out.dtype == dtype
    _rel_close(out.detach().float().numpy(), want_out, rtol, "out")
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=rtol if dtype == torch.float32 else 2e-2)
    want = convert.params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                           g_params))
    for pname, p in port.named_parameters():
        _rel_close(p.grad.numpy(), want[pname].numpy(), rtol, pname)
    _rel_close(xt.grad.numpy(), g_x, rtol, "x")


def test_gather_rows_backward_equals_autograds():
    """gather_rows' gather-only backward is index_select's
    (scatter-add) backward: the same gradient."""
    gen = torch.Generator().manual_seed(0)
    src = torch.randn(6, 5, generator=gen, requires_grad=True)
    index = torch.tensor([3, 6, 0, 3, 5, 6, 1])  # 6: the zero row
    inverse = torch.tensor([[2, 7], [6, 7], [7, 7], [0, 3], [7, 7],
                            [4, 7]])
    grad = torch.randn(7, 5, generator=gen)
    (tmoe.gather_rows(src, index, inverse) * grad).sum().backward()
    got = src.grad.clone()
    src.grad = None
    padded = torch.cat([src, torch.zeros(1, 5)])
    (padded.index_select(0, index) * grad).sum().backward()
    torch.testing.assert_close(got, src.grad, rtol=0, atol=1e-6)


class _Shapes(TorchDispatchMode):
    """Every shape an op returns while active."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("name", list(ROUTINGS))
def test_no_step_materializes_a_tokens_experts_capacity_tensor(name):
    """At G 256, E 8, C 40 a dense dispatch would hold 81920 elements;
    the forward and backward make nothing of that size, and no shape
    holds G, E and C together."""
    cfg = tmoe.MoEConfig(num_experts=8, d_model=8, d_ff=16,
                         dtype=torch.float32, **ROUTINGS[name])
    layer = tmoe.MoEMLP(cfg)
    torch.manual_seed(0)
    for w in (layer.w_gate, layer.w_up, layer.w_down):
        torch.nn.init.normal_(w, std=0.3)
    x = torch.randn(2, 128, 8, requires_grad=True)
    groups, capacity = 256, layer.capacity(256)
    assert capacity == 40
    with _Shapes() as seen:
        out, aux = layer(x)
        (out.sum() + aux).backward()
    assert max(int(np.prod(s)) for s in seen.shapes) < \
        groups * 8 * capacity // 2
    assert not [s for s in seen.shapes
                if {groups, 8, capacity} <= set(s)]


def _reference_moe_harness(seq, batch, seed=0):
    """The reference's build_transformer_train with MoE (top-1, 4
    experts, moe_every 2) on one CPU device, fp32."""
    moe = jmoe.MoEConfig(num_experts=4, d_model=MODEL["d_model"],
                         d_ff=MODEL["d_ff"], dtype=jnp.float32)
    mesh = jmesh.make_mesh(jmesh.auto_axis_sizes(1), jax.devices()[:1])
    jcfg = jtrain.make_transformer_config(mesh, dtype=jnp.float32,
                                          max_seq_len=seq, moe=moe, **MODEL)
    return jtrain.build_transformer_train(mesh, jcfg, batch_size=batch,
                                          seq_len=seq, seed=seed), jcfg


def _port_moe_harness(seq, batch, params, **cfg):
    moe = tmoe.MoEConfig(num_experts=4, d_model=MODEL["d_model"],
                         d_ff=MODEL["d_ff"], dtype=torch.float32)
    config = ttrain.make_transformer_config(
        dtype=torch.float32, max_seq_len=seq, moe=moe, **MODEL, **cfg)
    return ttrain.build_transformer_train(
        config, batch_size=batch, seq_len=seq, device="cpu",
        params=convert.params_from_flax(params))


def _batch(seed, batch, seq):
    rng = np.random.RandomState(seed)
    return tuple(rng.randint(0, MODEL["vocab_size"], (batch, seq)).astype(
        np.int32) for _ in range(2))


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_transformer_moe_loss_and_grads_match_reference(remat):
    """A TransformerLM with moe_every 2 (layer 1 routed): the loss with
    the aux term and every gradient against the reference's
    build_transformer_train on one CPU device (its step's loss; its
    loss_fn's gradients through jax.grad), under remat as without (the
    aux comes out of the recomputed block once)."""
    seq, batch = 32, 4
    ref, jcfg = _reference_moe_harness(seq, batch)
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    tokens, targets = _batch(5, batch, seq)
    model = jtfm.TransformerLM(jcfg)

    def loss_fn(p):
        hidden, variables = model.apply(
            {"params": p}, jnp.asarray(tokens), return_hidden=True,
            mutable=["losses"])
        loss = jtfm.lm_loss_chunked(hidden, p["embed"]["embedding"],
                                    jnp.asarray(targets))
        aux = jax.tree_util.tree_leaves(variables["losses"])
        return loss + jcfg.moe_aux_weight * sum(jnp.mean(a) for a in aux)

    want_grads = convert.params_from_flax(jax.tree_util.tree_map(
        np.asarray, jax.grad(loss_fn)(params)))
    _, _, metrics = ref.step(ref.params, ref.opt_state,
                             {"tokens": jnp.asarray(tokens),
                              "targets": jnp.asarray(targets)})
    harness = _port_moe_harness(seq, batch, params, remat=remat)
    assert "layer_1.moe.w_gate" in harness.model.state_dict()
    assert "layer_0.mlp.gate_proj.weight" in harness.model.state_dict()
    loss = harness.loss_fn(torch.from_numpy(tokens),
                           torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(metrics["loss"]),
                               rtol=FP32_RTOL)
    for name, p in harness.model.named_parameters():
        _rel_close(p.grad.numpy(), want_grads[name].numpy(), FP32_RTOL, name)


def test_aux_weight_reaches_the_router():
    """The aux term is in the loss: with moe_aux_weight raised the
    router's gradient changes by exactly the aux's own gradient."""
    seq, batch = 16, 2
    ref, _ = _reference_moe_harness(seq, batch, seed=1)
    params = jax.tree_util.tree_map(np.asarray, ref.params)
    tokens, targets = (torch.from_numpy(t) for t in _batch(2, batch, seq))
    grads = []
    for weight in (0.0, 10.0):
        harness = _port_moe_harness(seq, batch, params,
                                    moe_aux_weight=weight)
        harness.loss_fn(tokens, targets).backward()
        grads.append(harness.model.layer_1.moe.router.weight.grad)
    assert not torch.allclose(grads[0], grads[1], atol=1e-4)


def test_fused_norm_and_decode_refuse_moe():
    moe = tmoe.MoEConfig(num_experts=4, d_model=32, d_ff=64)
    with pytest.raises(NotImplementedError, match="moe"):
        ttfm.TransformerLM(ttfm.TransformerConfig(
            fused_norm=True, moe=moe, **MODEL), device="meta")
    with pytest.raises(NotImplementedError, match="moe"):
        ttfm.TransformerLM(ttfm.TransformerConfig(
            decode=True, moe=moe, **MODEL), device="meta")
    with pytest.raises(SystemExit, match="--fused-norm"):
        train_transformer.check_mesh_sizes(_args(fused_norm=True,
                                                 moe_experts=4), 1)


def test_quantize_matmuls_leaves_the_moe_layers_unquantized():
    """As in the reference (MoEMLP has no QuantDense): attention and the
    dense MLPs are QuantDense, the MoE layer's experts and router not."""
    moe = tmoe.MoEConfig(num_experts=4, d_model=32, d_ff=64)
    model = ttfm.TransformerLM(ttfm.TransformerConfig(
        quantize_matmuls=True, moe=moe, **MODEL), device="meta")
    assert isinstance(model.layer_0.mlp.down_proj, ttfm.QuantDense)
    assert isinstance(model.layer_1.attn.q_proj, ttfm.QuantDense)
    assert not any(isinstance(m, ttfm.QuantDense)
                   for m in model.layer_1.moe.modules())


def test_moe_layers_follow_the_references_rule_and_names():
    """moe_every 3 over 6 layers routes layers 2 and 5; the state dict's
    names are the reference's flax paths through params_from_flax, with
    the same shapes, and init_params draws every one of them."""
    cfg = dict(MODEL, n_layers=6)
    jcfg = jtfm.TransformerConfig(moe=jmoe.MoEConfig(
        num_experts=4, d_model=32, d_ff=64), moe_every=3, **cfg)
    flax = jax.eval_shape(lambda: jtfm.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    want = {name: tuple(t.shape) for name, t in convert.params_from_flax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               flax)).items()}
    tcfg = ttfm.TransformerConfig(moe=tmoe.MoEConfig(
        num_experts=4, d_model=32, d_ff=64), moe_every=3, **cfg)
    model = ttfm.TransformerLM(tcfg, device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert [i for i in range(6) if ttfm.uses_moe(tcfg, i)] == [2, 5]
    drawn = convert.init_params(tcfg, torch.Generator().manual_seed(0))
    assert {n: tuple(t.shape) for n, t in drawn.items()} == want
    # flax's lecun_normal fan-in of a 3-D kernel: E times the in dim.
    std = float(drawn["layer_2.moe.w_down"].std())
    assert abs(std - (1 / (4 * 64)) ** 0.5) < 0.1 * std


def test_moe_sharding_rules_are_the_references():
    """The reference's MoE PartitionSpecs on the port's names: experts
    over ep on dim 0, F over tp (w_gate/w_up dim 2, w_down dim 1), the
    router replicated."""
    jcfg = jtfm.TransformerConfig(moe=jmoe.MoEConfig(
        num_experts=4, d_model=32, d_ff=64), max_seq_len=16, **MODEL)
    params = jax.eval_shape(lambda: jtfm.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    specs = jsharding.transformer_param_specs(params)
    flat = {jsharding._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(specs)[0]}
    moe = {p: s for p, s in flat.items() if "/moe/" in p}
    assert len(moe) == 4
    for path, spec in moe.items():
        name = path.replace("/kernel", "/weight").replace("/", ".")
        rule = next(r for r in tsharding.TRANSFORMER_RULES
                    if __import__("re").match(r[0], name))
        assert rule[1] == spec, (path, rule, spec)
    assert tsharding.ep_dim("layer_1.moe.w_gate") == 0
    assert tsharding.tp_dim("layer_1.moe.w_up") == 2
    assert tsharding.tp_dim("layer_1.moe.w_down") == 1
    assert tsharding.ep_dim("layer_1.moe.router.weight") is None
    assert tsharding.tp_dim("layer_1.moe.router.weight") is None


def test_shard_state_dict_cuts_experts_over_ep_then_f_over_tp():
    moe = tmoe.MoEConfig(num_experts=4, d_model=32, d_ff=64)
    state = convert.init_params(ttfm.TransformerConfig(moe=moe, **MODEL),
                                torch.Generator().manual_seed(0))
    w = state["layer_1.moe.w_down"]
    mesh = argparse.Namespace(sizes={"dp": 1, "fsdp": 1, "ep": 2, "sp": 1,
                                     "tp": 2}, coords={"tp": 1, "ep": 1})
    shard = tsharding.shard_state_dict(state, mesh)
    assert torch.equal(shard["layer_1.moe.w_down"], w[2:, 32:])
    assert torch.equal(shard["layer_1.moe.w_gate"],
                       state["layer_1.moe.w_gate"][2:, :, 32:])
    assert torch.equal(shard["layer_1.moe.router.weight"],
                       state["layer_1.moe.router.weight"])
    assert tsharding.global_shape("layer_1.moe.w_down", (2, 32, 32), 2,
                                  2) == (4, 64, 32)


def test_mfu_counts_the_router_and_the_expert_buffers():
    """Dense configs count as the reference's. A MoE layer's parameters
    are its router's d*E and its experts' 3*d*F*E, the model's own count;
    its work a token is d*E for the router and 3*d*F*E*C/(B*T) for its
    experts' buffer rows in place of its MLP's 3*d*F, and needs the
    batch."""
    jcfg = jtfm.TransformerConfig(**MODEL)
    tcfg = ttfm.TransformerConfig(**MODEL)
    assert tmfu.transformer_param_count(tcfg) == \
        jmfu.transformer_param_count(jcfg)
    moe = tmoe.MoEConfig(num_experts=8, d_model=32, d_ff=64)
    mcfg = ttfm.TransformerConfig(moe=moe, **MODEL)
    assert tmfu.transformer_param_count(mcfg) == sum(
        p.numel() for p in ttfm.TransformerLM(mcfg).parameters())
    d, f, groups = 32, 64, 4 * 64
    capacity = int(1.25 * groups / 8)
    work = tmfu.transformer_param_count(tcfg) - 3 * d * f + d * 8 + \
        3 * d * f * 8 * capacity / groups
    assert tmfu.transformer_train_flops_per_token(
        mcfg, 64, batch_size=4) == pytest.approx(
            tmfu.transformer_train_flops_per_token(tcfg, 64) +
            6 * (work - tmfu.transformer_param_count(tcfg)))
    with pytest.raises(ValueError, match="batch_size"):
        tmfu.transformer_train_flops_per_token(mcfg, 64)


def _args(**over):
    args = dict(tp=1, sp=1, fsdp=1, ep=1, moe_experts=0, seq_len=16,
                batch=8, n_heads=4, d_ff=64, vocab=64, int8=False,
                fused_norm=False)
    args.update(over)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("over,world,match", [
    (dict(moe_experts=6, ep=4), 4, "--moe-experts 6 is not divisible by "
                                   "--ep 4"),
    (dict(ep=2), 2, "--ep splits the experts"),
    (dict(moe_experts=8, ep=4), 6, "6 ranks are not divisible by tp \\* sp "
                                   "\\* fsdp \\* ep = 4"),
])
def test_workload_refuses_what_the_reference_refuses(over, world, match):
    with pytest.raises(SystemExit, match=match):
        train_transformer.check_mesh_sizes(_args(**over), world)


def test_train_cli_moe_on_cpu(capsys):
    """The workload with --moe-experts on one CPU rank: the loss falls,
    the JSON line carries each MoE layer's dropped share, and MFU is
    None off the card."""
    import json
    code = train_transformer.main([
        "--device", "cpu", "--d-model", "32", "--n-layers", "2",
        "--n-heads", "2", "--d-ff", "64", "--vocab", "64", "--seq-len",
        "16", "--batch", "2", "--steps", "3", "--warmup", "0",
        "--moe-experts", "4", "--moe-every", "2"])
    assert code == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["losses"][-1] < report["losses"][0]
    shares = report["per_rank"][0]["moe_dropped_share"]
    assert list(shares) == ["layer_1"] and 0.0 <= shares["layer_1"] < 1.0
    assert report["mfu_pct"] is None
    assert set(report["per_rank"][0]["params_sha256"]) == {
        "replicated", "tp_shard", "ep_shard"}
