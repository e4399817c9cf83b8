"""The port's fused RMSNorm + matmul (ops/fused_norm.py) and the
fused_norm TransformerLM against the JAX reference on the CPU.

``rmsnorm_matmul`` on CPU tensors runs K9's plain version forward and
the reference's chain rule backward; the reference runs its Pallas
kernel in interpret mode. The same numpy-seeded inputs go through both.
Tolerances: fp32 forward within 2e-5 (summation order), gradients
within 1e-4 (the reference's own test's bound for its custom_vjp), bf16
outputs within two bf16 ulps of the output scale (the two frameworks
round the normalized rows and the output at the same points, but sum in
other orders). The fused model carries the reference's weights across
with params_from_flax: loss within 1e-5 relative, qkv and norm_scale
gradients within 1e-4.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu.ops import fused_norm as jfn
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.ops import fused_norm as tfn

MODEL = dict(vocab_size=128, d_model=128, n_layers=2, n_heads=4, d_head=32,
             d_ff=256, max_seq_len=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this module's small torch ops on one thread: the suite runs
    in several worker processes beside timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, m, k, n):
    rng = np.random.RandomState(seed)
    return (rng.randn(m, k).astype(np.float32),
            (1.0 + 0.1 * rng.randn(k)).astype(np.float32),
            (rng.randn(k, n) / np.sqrt(k)).astype(np.float32))


@pytest.mark.parametrize("m,k,n", [(64, 256, 384), (40, 128, 128),
                                   (256, 512, 1152)])
def test_forward_matches_reference_kernel(m, k, n):
    x, scale, w = _inputs(0, m, k, n)
    want = jfn.rmsnorm_matmul(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(w), impl="interpret")
    calls = tfn.plain_calls["rmsnorm_matmul"]
    got = tfn.rmsnorm_matmul(torch.from_numpy(x), torch.from_numpy(scale),
                             torch.from_numpy(w))
    assert tfn.plain_calls["rmsnorm_matmul"] == calls + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_forward_bf16():
    x, scale, w = _inputs(1, 64, 256, 128)
    want = np.asarray(jfn.rmsnorm_matmul(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
        jnp.asarray(w, jnp.bfloat16), impl="interpret"), np.float32)
    got = tfn.rmsnorm_matmul(torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(scale),
                             torch.from_numpy(w).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    scale_out = float(np.abs(want).max())
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * 2.0 ** -8 * scale_out)


def test_gradients_match_reference_custom_vjp():
    x, scale, w = _inputs(2, 48, 128, 256)
    tgt = np.random.RandomState(3).randn(48, 256).astype(np.float32)

    def jloss(x_, s_, w_):
        y = jfn.rmsnorm_matmul(x_, s_, w_, 1e-6, 256, 512, "interpret")
        return jnp.sum((y - tgt) ** 2)
    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(w))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, w)]
    y = tfn.rmsnorm_matmul(*leaves)
    ((y - torch.from_numpy(tgt)) ** 2).sum().backward()
    for leaf, ref, name in zip(leaves, want, ("dx", "dscale", "dw")):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_impl_dispatch_and_kernel_refuses_cpu():
    x, scale, w = (torch.from_numpy(a) for a in _inputs(4, 16, 64, 32))
    plain = tfn.rmsnorm_matmul(x, scale, w, impl="plain")
    torch.testing.assert_close(tfn.rmsnorm_matmul(x, scale, w,
                                                  impl="kernel"), plain)
    with pytest.raises(ValueError, match="unknown"):
        tfn.rmsnorm_matmul(x, scale, w, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfn.rmsnorm_matmul_kernel(x, scale, w)
    launches = dict(tfn.launches)
    tfn.rmsnorm_matmul(x, scale, w)
    assert tfn.launches == launches


def _fused_flax_params(tokens):
    """The reference's unfused init, transplanted into its fused layout
    as tests/test_fused_norm.py builds it."""
    base = jtfm.TransformerConfig(dtype=jnp.float32, **MODEL)
    params = jtfm.TransformerLM(base).init(
        jax.random.PRNGKey(0), tokens)["params"]
    fused = {}
    for name, sub in params.items():
        if not name.startswith("layer_"):
            fused[name] = sub
            continue
        attn = sub["attn"]
        fused[name] = {
            "attn": {
                "norm_scale": sub["attn_norm"]["scale"],
                "qkv_kernel": jnp.concatenate(
                    [attn["q_proj"]["kernel"], attn["k_proj"]["kernel"],
                     attn["v_proj"]["kernel"]], axis=1),
                "o_proj": attn["o_proj"],
            },
            "mlp": {
                "norm_scale": sub["mlp_norm"]["scale"],
                "gate_up_kernel": jnp.concatenate(
                    [sub["mlp"]["gate_proj"]["kernel"],
                     sub["mlp"]["up_proj"]["kernel"]], axis=1),
                "down_proj": sub["mlp"]["down_proj"],
            },
        }
    return jax.tree_util.tree_map(np.asarray, fused)


def test_fused_model_matches_reference():
    rng = np.random.RandomState(3)
    tokens = rng.randint(0, MODEL["vocab_size"], (2, 64)).astype(np.int32)
    targets = rng.randint(0, MODEL["vocab_size"], (2, 64)).astype(np.int32)
    params = _fused_flax_params(jnp.asarray(tokens))
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, fused_norm=True, **MODEL)

    def jloss(p):
        logits = jtfm.TransformerLM(jcfg).apply({"params": p},
                                                jnp.asarray(tokens))
        return jtfm.lm_loss(logits, jnp.asarray(targets))
    want, grads = jax.value_and_grad(jloss)(params)

    model = ttfm.TransformerLM(ttfm.TransformerConfig(
        dtype=torch.float32, fused_norm=True, **MODEL))
    model.load_state_dict(convert.params_from_flax(params))
    assert not hasattr(model.layer_0, "attn_norm")
    loss = ttfm.lm_loss(model(torch.from_numpy(tokens)),
                        torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    got = dict(model.named_parameters())
    for layer in ("layer_0", "layer_1"):
        for path in (("attn", "qkv_kernel"), ("attn", "norm_scale"),
                     ("mlp", "gate_up_kernel"), ("mlp", "norm_scale")):
            np.testing.assert_allclose(
                got[".".join((layer,) + path)].grad.numpy(),
                np.asarray(grads[layer][path[0]][path[1]]), rtol=1e-4,
                atol=1e-4, err_msg=f"{layer}.{'.'.join(path)}")


def test_fused_norm_with_decode_raises():
    cfg = ttfm.TransformerConfig(dtype=torch.float32, fused_norm=True,
                                 decode=True, **MODEL)
    with pytest.raises(NotImplementedError, match="fused_norm"):
        ttfm.TransformerLM(cfg, device="meta")


def test_init_params_fused_layout():
    cfg = ttfm.TransformerConfig(dtype=torch.float32, fused_norm=True,
                                 **dict(MODEL, d_model=256, d_ff=512))
    state = convert.init_params(cfg, torch.Generator().manual_seed(0))
    model = ttfm.TransformerLM(cfg, device="meta")
    assert set(state) == set(model.state_dict())
    features = cfg.n_heads * cfg.d_head
    for i in range(cfg.n_layers):
        qkv = state[f"layer_{i}.attn.qkv_kernel"]
        gate_up = state[f"layer_{i}.mlp.gate_up_kernel"]
        assert qkv.shape == (cfg.d_model, 3 * features)
        assert gate_up.shape == (cfg.d_model, 2 * cfg.d_ff)
        for w in (qkv, gate_up):  # lecun-normal over fan-in d_model
            assert float(w.std()) == pytest.approx(
                math.sqrt(1.0 / cfg.d_model), rel=0.05)
        for part in ("attn", "mlp"):
            assert torch.equal(state[f"layer_{i}.{part}.norm_scale"],
                               torch.ones(cfg.d_model))
    # The unfused layout is unchanged by the flag's existence.
    plain = convert.init_params(dataclasses.replace(cfg, fused_norm=False),
                                torch.Generator().manual_seed(0))
    assert "layer_0.attn.q_proj.weight" in plain
    assert "layer_0.attn.qkv_kernel" not in plain
