"""The port's int8 quantization (ops/quantization.py: K10's and K11's
plain versions, quantized_linear) and the quantize_matmuls
TransformerLM against the JAX reference on the CPU.

The reference runs its Pallas kernels in interpret mode, as
tests/test_quantization.py does. It draws its rounding bits inside
``quantize_int8`` from ``jax.random.bits(PRNGKey(seed), shape)``; the
port takes them as an input, so the tests hand it the same bits (bitcast
to int32), and patch ``random_bits`` to return them where the port draws
its own. Tolerances: quantize_int8's int8 values and scales bit-identical;
int8_matmul exactly equal (both sum exactly); quantized_linear's forward
within 1e-6 and its gradients within 1e-5 (fp32 products summed in other
orders); the small fp32 model's logits, loss and gradients within 1e-5.
A single int8 value that rounds the other way between the frameworks
would move an output by a whole quantization step; the model tests use
seeds where none does (ROADMAP queue 3).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu.ops import quantization as jq
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.ops import quantization as tq
from batch_shipyard_tpu_torch.workloads import train_transformer

MODEL = dict(vocab_size=64, d_model=32, n_layers=2, n_heads=2, d_head=16,
             d_ff=64, max_seq_len=16)


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this module's small torch ops on one thread: the suite runs
    in several worker processes beside timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_bits(seed, shape) -> np.ndarray:
    """The bits the reference's quantize_int8 draws for (seed, shape)."""
    return np.array(jax.lax.bitcast_convert_type(
        jax.random.bits(jax.random.PRNGKey(seed), tuple(shape), jnp.uint32),
        jnp.int32))


@pytest.fixture
def reference_bits(monkeypatch):
    """The port's random_bits, patched to return the reference's bits."""
    drawn = []

    def bits(seed, shape, device):
        drawn.append((seed, tuple(shape)))
        return torch.from_numpy(jax_bits(seed, shape)).to(device)
    monkeypatch.setattr(tq, "random_bits", bits)
    return drawn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k", [(64, 128), (300, 128), (256, 2816)])
def test_quantize_int8_matches_reference_bit_for_bit(m, k, dtype):
    rng = np.random.RandomState(m + k)
    x = (rng.randn(m, k) * rng.rand(m, 1) * 4).astype(np.float32)
    x[3] = 0.0  # a zero row takes the 1e-8 floor of the scale
    seed = 5
    want_v, want_s = jq.quantize_int8(jnp.asarray(x, getattr(jnp, dtype)),
                                      seed)
    calls = tq.plain_calls["quantize_int8"]
    got_v, got_s = tq.quantize_int8(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(jax_bits(seed, (m, k))))
    assert tq.plain_calls["quantize_int8"] == calls + 1
    assert got_v.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == (m, 1)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))
    assert not got_v[3].any()


@pytest.mark.parametrize("m,k,n", [(32, 64, 48), (300, 2816, 384),
                                   (256, 1024, 512)])
def test_int8_matmul_matches_reference_exactly(m, k, n):
    rng = np.random.RandomState(m + n)
    x_q = rng.randint(-127, 128, (m, k)).astype(np.int8)
    w_q = rng.randint(-127, 128, (k, n)).astype(np.int8)
    x_s = (rng.rand(m, 1) + 1e-2).astype(np.float32)
    w_s = (rng.rand(n, 1) + 1e-2).astype(np.float32)
    want = np.asarray(jq.int8_matmul(jnp.asarray(x_q), jnp.asarray(x_s),
                                     jnp.asarray(w_q), jnp.asarray(w_s)))
    # The port takes the weight's own [N, K] rows (the reference's w_q.T).
    got = tq.int8_matmul(torch.from_numpy(x_q), torch.from_numpy(x_s),
                         torch.from_numpy(np.ascontiguousarray(w_q.T)),
                         torch.from_numpy(w_s))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def test_quantized_linear_matches_reference_custom_vjp(reference_bits):
    rng = np.random.RandomState(2)
    x = rng.randn(48, 64).astype(np.float32)
    w = (rng.randn(64, 40) / 8).astype(np.float32)  # reference [K, N]
    tgt = rng.randn(48, 40).astype(np.float32)
    seed = 3

    def jloss(x_, w_):
        return jnp.sum((jq.quantized_linear(x_, w_, seed) - tgt) ** 2)
    want_y = np.asarray(jq.quantized_linear(jnp.asarray(x), jnp.asarray(w),
                                            seed))
    want_dx, want_dw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                       jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).requires_grad_()
    y = tq.quantized_linear(xt, wt, seed)
    ((y - torch.from_numpy(tgt)) ** 2).sum().backward()
    assert reference_bits == [(seed, (48, 64)), (seed + 1, (40, 64))]
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy().T, np.asarray(want_dw),
                               rtol=1e-5, atol=1e-5)


def test_quantized_linear_backward_dtypes():
    """dx in x's dtype, dW in the (cast) weight's dtype, as the
    reference's _ql_bwd rounds them."""
    x = torch.randn(16, 32, generator=torch.Generator().manual_seed(0))
    w = torch.randn(24, 32, generator=torch.Generator().manual_seed(1))
    xb = x.to(torch.bfloat16).requires_grad_()
    wb = w.to(torch.bfloat16).requires_grad_()
    y = tq.quantized_linear(xb, wb)
    assert y.dtype == torch.float32 and tuple(y.shape) == (16, 24)
    y.sum().backward()
    assert xb.grad.dtype == torch.bfloat16 and wb.grad.dtype == torch.bfloat16


def test_impl_dispatch_and_kernels_refuse_cpu():
    x = torch.randn(16, 32, generator=torch.Generator().manual_seed(2))
    bits = tq.random_bits(0, x.shape, "cpu")
    plain = tq.quantize_int8(x, bits, impl="plain")
    for got, want in zip(tq.quantize_int8(x, bits, impl="kernel"), plain):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown"):
        tq.quantize_int8(x, bits, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.quantize_int8_kernel(x, bits)
    values, scales = plain
    with pytest.raises(ValueError, match="CUDA tensors"):
        tq.int8_matmul_kernel(values, scales, values, scales)
    with pytest.raises(ValueError, match="unknown"):
        tq.int8_matmul(values, scales, values, scales, impl="triton")
    launches = dict(tq.launches)
    tq.quantized_linear(x, x[:8].clone())
    assert tq.launches == launches  # CPU tensors never reach a kernel


def test_random_bits_depend_only_on_seed_and_shape():
    a = tq.random_bits(7, (5, 6), "cpu")
    torch.manual_seed(123)  # the global generator plays no part
    b = tq.random_bits(7, (5, 6), "cpu")
    assert a.dtype == torch.int32 and torch.equal(a, b)
    assert not torch.equal(a, tq.random_bits(8, (5, 6), "cpu"))
    draws = tq.bit_draws["random_bits"]
    tq.random_bits(7, (5, 6), "cpu")
    assert tq.bit_draws["random_bits"] == draws + 1


def _flax_quantized(seq):
    cfg = jtfm.TransformerConfig(
        dtype=jnp.float32, param_dtype=jnp.float32, quantize_matmuls=True,
        **MODEL, attention_fn=lambda q_, k_, v_, causal:
        jtfm.attn_ops.attention(q_, k_, v_, causal=causal,
                                impl="blockwise", block_size=seq))
    model = jtfm.TransformerLM(cfg)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, seq), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def test_quantized_model_matches_reference(reference_bits):
    """A small fp32 quantize_matmuls TransformerLM, built as
    tests/test_quantization.py builds it, on the same weights: logits,
    loss and every gradient."""
    seq = MODEL["max_seq_len"]
    rng = np.random.RandomState(5)
    tokens = rng.randint(0, MODEL["vocab_size"], (2, seq)).astype(np.int32)
    targets = rng.randint(0, MODEL["vocab_size"], (2, seq)).astype(np.int32)
    jmodel, params = _flax_quantized(seq)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(tokens))
        return jtfm.lm_loss(logits, jnp.asarray(targets)), logits
    (want, want_logits), grads = jax.value_and_grad(jloss, has_aux=True)(
        params)

    model = ttfm.TransformerLM(ttfm.TransformerConfig(
        dtype=torch.float32, quantize_matmuls=True, **MODEL))
    assert isinstance(model.layer_0.attn.q_proj, ttfm.QuantDense)
    assert isinstance(model.layer_1.mlp.down_proj, ttfm.QuantDense)
    model.load_state_dict(convert.params_from_flax(params))
    calls = dict(tq.plain_calls)
    logits = model(torch.from_numpy(tokens))
    loss = ttfm.lm_loss(logits, torch.from_numpy(targets))
    loss.backward()
    projections = 7 * MODEL["n_layers"]
    assert tq.plain_calls["quantize_int8"] == \
        calls["quantize_int8"] + 2 * projections
    assert tq.plain_calls["int8_matmul"] == \
        calls["int8_matmul"] + projections
    assert len(reference_bits) == 2 * projections
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    want_grads = convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, grads))
    got = dict(model.named_parameters())
    assert set(got) == set(want_grads)
    for name, g in want_grads.items():
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_params_from_flax_and_init_params_quantized_layout():
    """flax QuantDense keeps nn.Dense's ``kernel [in, out]``, so the
    reference's quantized tree maps onto the port's QuantDense weights
    with no change, and init_params draws the same names."""
    _, params = _flax_quantized(MODEL["max_seq_len"])
    cfg = ttfm.TransformerConfig(dtype=torch.float32, quantize_matmuls=True,
                                 **MODEL)
    model = ttfm.TransformerLM(cfg, device="meta")
    state = convert.params_from_flax(params)
    assert set(state) == set(model.state_dict())
    for name, t in model.state_dict().items():
        assert tuple(state[name].shape) == tuple(t.shape), name
    drawn = convert.init_params(cfg, torch.Generator().manual_seed(0))
    assert set(drawn) == set(state)


def test_fused_norm_with_quantize_matmuls_raises():
    cfg = ttfm.TransformerConfig(dtype=torch.float32, fused_norm=True,
                                 quantize_matmuls=True, **MODEL)
    with pytest.raises(NotImplementedError, match="quantize_matmuls"):
        ttfm.TransformerLM(cfg, device="meta")


def test_train_cli_int8_on_cpu(capsys):
    launches = dict(tq.launches)
    calls = tq.plain_calls["int8_matmul"]
    rc = train_transformer.main([
        "--device", "cpu", "--int8", "--d-model", "32", "--n-layers", "1",
        "--n-heads", "2", "--d-ff", "64", "--vocab", "64", "--seq-len",
        "16", "--batch", "2", "--steps", "2", "--warmup", "1"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2].startswith("[proc 0/1] transformer: mesh=")
    assert " device=cpu " in lines[-2]
    report = json.loads(lines[-1])
    assert report["device"] == "cpu" and np.isfinite(report["loss"])
    # 3 steps of 7 projections, each run twice: the CLI's default remat
    # recomputes every block in the backward.
    assert tq.plain_calls["int8_matmul"] == calls + 3 * 7 * 2
    assert tq.launches == launches
