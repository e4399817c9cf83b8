"""The port's decode-mode transformer against the JAX reference on the
CPU: the same flax params (carried over with params_from_flax) and the
same numpy-seeded tokens through both, for the dense, paged, dense-int8
and paged-int8 caches. Tolerances: fp32 logits within 1e-4; bf16 within
2e-2 of the reference's largest logit (bf16 rounds at different places
in the two frameworks)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import inference as jinf
from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import inference as tinf
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.parallel import train as ttrain

VOCAB, D_MODEL, LAYERS, HEADS, D_HEAD, D_FF = 128, 64, 2, 2, 32, 128
MAX_LEN, PAGE, BATCH = 32, 8, 3


def _configs(dtype: str, **extra):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    common = dict(vocab_size=VOCAB, d_model=D_MODEL, n_layers=LAYERS,
                  n_heads=HEADS, d_head=D_HEAD, d_ff=D_FF,
                  max_seq_len=MAX_LEN, decode=True,
                  max_decode_len=MAX_LEN, **extra)
    return (jtfm.TransformerConfig(dtype=jdt, **common),
            ttfm.TransformerConfig(dtype=tdt, **common))


@pytest.fixture(scope="module")
def flax_params():
    jcfg, _ = _configs("float32")
    variables = jtfm.TransformerLM(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((BATCH, 1), jnp.int32),
        positions=jnp.zeros((1,), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, variables["params"])


def _torch_model(tcfg, flax_params):
    model = ttfm.TransformerLM(tcfg)
    model.load_state_dict(convert.params_from_flax(flax_params))
    return model.requires_grad_(False)


def _check(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got, want, atol=2e-2 * scale,
                                   rtol=2e-2)


def test_rotary_matches_reference():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 3, 16).astype(np.float32)
    pos_1d = np.arange(7, 12, dtype=np.int32)
    pos_2d = rng.randint(0, 50, size=(2, 5)).astype(np.int32)
    for pos in (pos_1d, pos_2d):
        want = jtfm.rotary_embedding(jnp.asarray(x), jnp.asarray(pos),
                                     10000.0)
        got = ttfm.rotary_embedding(torch.from_numpy(x),
                                    torch.from_numpy(pos), 10000.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(dtype):
    rng = np.random.RandomState(1)
    x = rng.randn(4, 24).astype(np.float32)
    scale = rng.rand(24).astype(np.float32) + 0.5
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jtfm.RMSNorm(dtype=jdt).apply(
        {"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x, jdt))
    norm = ttfm.RMSNorm(24, getattr(torch, dtype))
    norm.scale.data = torch.from_numpy(scale)
    with torch.no_grad():
        got = norm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _check(got.float().numpy(), np.asarray(want, np.float32), dtype)


def test_converter_round_trip(flax_params):
    """Every flax leaf lands on a port parameter of the transposed (Dense)
    or same shape, and loads strictly."""
    _, tcfg = _configs("float32")
    state = convert.params_from_flax(flax_params)
    model = ttfm.TransformerLM(tcfg)
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    kernel = flax_params["layer_1"]["mlp"]["down_proj"]["kernel"]
    np.testing.assert_array_equal(
        model.layer_1.mlp.down_proj.weight.detach().numpy(), kernel.T)
    np.testing.assert_array_equal(
        model.embed.embedding.detach().numpy(),
        flax_params["embed"]["embedding"])


def test_init_params_matches_flax_distribution(flax_params):
    """init_params draws each leaf with the spread of flax's
    initializer (not the same numbers: the generators differ)."""
    _, tcfg = _configs("float32")
    gen = torch.Generator().manual_seed(0)
    state = convert.init_params(tcfg, gen)
    mine = convert.params_from_flax(flax_params)
    assert set(state) == set(mine)
    for name in ("embed.embedding", "layer_0.attn.q_proj.weight",
                 "layer_1.mlp.down_proj.weight"):
        ratio = float(state[name].std() / mine[name].std())
        assert 0.85 < ratio < 1.15, (name, ratio)
        assert state[name].shape == mine[name].shape
    assert float(state["final_norm.scale"].min()) == 1.0


def test_training_forward_not_ported():
    """Sequence parallelism in the training forward:
    make_transformer_config(sp=2, group=...) wires attention_fn to ring
    attention over the group, and sp > 1 without a ring of that size
    raises rather than running something else."""
    from batch_shipyard_tpu_torch.ops import ring_attention

    class Ring:
        rank, size = 1, 2
    cfg = ttrain.make_transformer_config(sp=2, group=Ring(), n_layers=1)
    assert cfg.attention_fn.func is ring_attention.ring_attention
    assert isinstance(cfg.attention_fn.keywords["group"], Ring)
    assert ttrain.make_transformer_config(n_layers=1).attention_fn is None
    with pytest.raises(ValueError, match="RingGroup of 2"):
        ttrain.make_transformer_config(sp=2)


def test_training_forward_and_cache_contract():
    """The training forward (decode=False, no cache) runs the flash
    path and returns logits; a cache still needs decode=True and
    decode mode still needs a cache. tests/test_torch_train.py holds
    the training forward against the reference."""
    _, tcfg = _configs("float32")
    tcfg = dataclasses.replace(tcfg, decode=False)
    model = ttfm.TransformerLM(tcfg, device="meta").to_empty(device="cpu")
    model.load_state_dict(
        convert.init_params(tcfg, torch.Generator().manual_seed(0)))
    logits = model(torch.zeros((1, 4), dtype=torch.int32))
    assert logits.shape == (1, 4, VOCAB)
    assert bool(torch.isfinite(logits).all())
    with pytest.raises(ValueError, match="decode=True"):
        model(torch.zeros((1, 4), dtype=torch.int32), cache=[{}] * LAYERS)
    with pytest.raises(ValueError, match="needs a cache"):
        ttfm.TransformerLM(dataclasses.replace(tcfg, decode=True))(
            torch.zeros((1, 1), dtype=torch.int32))


@pytest.mark.parametrize("fused_norm", [False, True])
def test_fresh_model_draws_every_weight(fused_norm):
    """A model built on the CPU right after NaN blocks of its weights'
    sizes were freed holds finite weights and logits: nothing it keeps
    was left as torch.empty. Two builds from generators of one seed
    agree; the embedding and fused kernels have flax's spread. On the
    meta device nothing is drawn."""
    _, tcfg = _configs("float32")
    tcfg = dataclasses.replace(tcfg, decode=False, fused_norm=fused_norm)
    sizes = [p.numel() for p in
             ttfm.TransformerLM(tcfg, device="meta").parameters()]
    models = []
    for _ in range(2):
        for numel in sorted(set(sizes), reverse=True):
            poison = torch.full((numel,), float("nan"))
            del poison
        models.append(ttfm.TransformerLM(
            tcfg, generator=torch.Generator().manual_seed(3)))
    model = models[0]
    for name, param in model.named_parameters():
        assert bool(torch.isfinite(param).all()), name
    logits = model(torch.zeros((2, 4), dtype=torch.int32))
    assert bool(torch.isfinite(logits).all())
    drawn = ["embed.embedding"] + [
        f"layer_{i}.{leaf}" for i in range(LAYERS) if fused_norm
        for leaf in ("attn.qkv_kernel", "mlp.gate_up_kernel")]
    state, twin = model.state_dict(), models[1].state_dict()
    for name in drawn:
        assert torch.equal(state[name], twin[name]), name
        ratio = float(state[name].std()) * D_MODEL ** 0.5
        assert 0.85 < ratio < 1.15, (name, ratio)
    meta = ttfm.TransformerLM(tcfg, device="meta")
    assert all(p.is_meta for p in meta.parameters())


def _assign_tables(cache, table):
    def fix(node):
        if isinstance(node, dict) and "block_table" in node:
            return {**node, "block_table": jnp.asarray(table)}
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node
    return fix(cache)


CASES = [(dtype, kv, paged) for dtype in ("float32", "bfloat16")
         for kv in (None, "int8") for paged in (False, True)]


@pytest.mark.parametrize("dtype,kv,paged", CASES)
def test_decode_logits_match_reference(flax_params, dtype, kv, paged):
    """Prefill (dense: one multi-token insert; paged: token by token,
    since the paged cache takes one token per call) then 4 decode steps
    at ragged per-slot positions; logits compared at every step."""
    extra = {"kv_cache_dtype": kv}
    if paged:
        extra.update(kv_page_size=PAGE, kv_num_pages=16)
    jcfg, tcfg = _configs(dtype, **extra)
    jmodel = jtfm.TransformerLM(jcfg)
    tmodel = _torch_model(tcfg, flax_params)
    jcache = jinf.init_cache(jmodel, flax_params, BATCH)
    tcache = tinf.init_cache(tmodel, BATCH)
    rng = np.random.RandomState(7)
    prompt = rng.randint(0, VOCAB, size=(BATCH, 6)).astype(np.int32)
    if paged:
        table = rng.permutation(16)[:BATCH * 4].reshape(BATCH, 4)
        table = table.astype(np.int32)
        jcache = _assign_tables(jcache, table)
        tcache[0]["block_table"].copy_(torch.from_numpy(table))
    jparams = {"params": flax_params}
    steps = []
    if paged:
        steps += [(prompt[:, t:t + 1], np.full((BATCH, 1), t, np.int32))
                  for t in range(prompt.shape[1])]
    else:
        hidden_j, mut = jmodel.apply(
            {**jparams, "cache": jcache}, jnp.asarray(prompt),
            return_hidden=True, mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            hidden_t = tmodel(torch.from_numpy(prompt), cache=tcache,
                              return_hidden=True)
        emb = flax_params["embed"]["embedding"]
        want = np.asarray(hidden_j[:, -1], np.float32) @ emb.T
        got = tinf.last_token_logits(tmodel, hidden_t[:, -1])
        _check(got.numpy(), want, dtype)
    pos = np.full((BATCH, 1), prompt.shape[1], np.int32)
    for step in range(4):
        tok = rng.randint(0, VOCAB, size=(BATCH, 1)).astype(np.int32)
        steps.append((tok, pos + step))
    for tok, p in steps:
        want, mut = jmodel.apply(
            {**jparams, "cache": jcache}, jnp.asarray(tok),
            positions=jnp.asarray(p), mutable=["cache"])
        jcache = mut["cache"]
        with torch.no_grad():
            got = tmodel(torch.from_numpy(tok),
                         positions=torch.from_numpy(p), cache=tcache)
        assert got.dtype == tcfg.dtype
        _check(got.float().numpy(), np.asarray(want, np.float32), dtype)


@pytest.mark.parametrize("kv", [None, "int8"])
def test_prefix_rows_from_pages_matches_reference(kv):
    rng = np.random.RandomState(3)
    layer = {"k_pages": rng.randn(6, 4, 2, 8).astype(np.float32),
             "v_pages": rng.randn(6, 4, 2, 8).astype(np.float32)}
    if kv:
        layer = {"k_pages": rng.randint(-127, 128, (6, 4, 2, 8)).astype(
                     np.int8),
                 "v_pages": rng.randint(-127, 128, (6, 4, 2, 8)).astype(
                     np.int8),
                 "k_page_scales": rng.rand(6, 4, 2).astype(np.float32),
                 "v_page_scales": rng.rand(6, 4, 2).astype(np.float32)}
    ids = np.asarray([4, 1, 5], np.int32)
    want = jtfm.prefix_rows_from_pages(
        {k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(ids), 4)
    got = ttfm.prefix_rows_from_pages(
        {k: torch.from_numpy(v) for k, v in layer.items()}, ids, 4)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


def test_generate_matches_reference_greedy(flax_params):
    """inference.generate: prefill + decode loop, greedy tokens equal
    to the reference's generate on the same prompt (fp32)."""
    jcfg, tcfg = _configs("float32")
    jmodel = jtfm.TransformerLM(jcfg)
    tmodel = _torch_model(tcfg, flax_params)
    prompt = np.random.RandomState(5).randint(
        0, VOCAB, size=(2, 5)).astype(np.int32)
    want, _ = jinf.generate(
        jmodel, flax_params, jinf.init_cache(jmodel, flax_params, 2),
        jnp.asarray(prompt), 8, jax.random.PRNGKey(0))
    got, _ = tinf.generate(tmodel, tinf.init_cache(tmodel, 2),
                           torch.from_numpy(prompt), 8,
                           torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
