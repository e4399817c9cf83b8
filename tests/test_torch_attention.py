"""The port's attention (ops/attention.py) against the JAX reference on
the CPU, in fp32. The reference's flash kernels K1/K2 run in Pallas
interpret mode with 128-row blocks at T = 256, as tests/test_attention.py
runs them; the same numpy-seeded q, k, v and cotangents go through the
port's flash_attention / flash_attention_with_lse (on CPU tensors, the
kernels' plain versions) and its attention() dispatcher (blockwise on
CPU tensors). Tolerance 1e-5 absolute and relative on out, lse, dq, dk
and dv: both sides compute in fp32 and differ only in summation
order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from batch_shipyard_tpu.ops import attention as jattn
from batch_shipyard_tpu_torch.ops import attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)
BLOCK = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this module's small torch ops on one thread: the suite runs
    in several worker processes beside timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, batch=1, seq=256, heads=2, depth=32):
    rng = np.random.RandomState(seed)
    shape = (batch, seq, heads, depth)
    q, k, v, g = (rng.randn(*shape).astype(np.float32) for _ in range(4))
    g_lse = rng.randn(batch * heads, seq, 1).astype(np.float32)
    return q, k, v, g, g_lse


def _jax_flash(q, k, v, g, g_lse, causal, with_lse):
    """(out, lse or None, (dq, dk, dv)) of the reference's flash path."""
    def loss(q_, k_, v_):
        if with_lse:
            out, lse = jattn.flash_attention_with_lse(
                q_, k_, v_, causal, BLOCK, BLOCK)
            return jnp.sum(out * g) + jnp.sum(lse * g_lse), (out, lse)
        out = jattn.flash_attention(q_, k_, v_, causal, BLOCK, BLOCK)
        return jnp.sum(out * g), (out, None)

    with pltpu.force_tpu_interpret_mode():
        grads, (out, lse) = jax.grad(loss, argnums=(0, 1, 2),
                                     has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return out, lse, grads


def _torch_grads(fn, q, k, v):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    loss, outputs = fn(qt, kt, vt)
    loss.backward()
    return outputs, (qt.grad, kt.grad, vt.grad)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()),
                               np.asarray(want), **TOL)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_matches_interpret_mode_reference(causal, with_lse):
    q, k, v, g, g_lse = _inputs(seed=1 + 2 * causal + with_lse)
    want_out, want_lse, want_grads = _jax_flash(q, k, v, g, g_lse, causal,
                                                with_lse)
    g_t, g_lse_t = torch.from_numpy(g), torch.from_numpy(g_lse)

    def port(q_, k_, v_):
        if with_lse:
            out, lse = tattn.flash_attention_with_lse(q_, k_, v_, causal)
            return (out * g_t).sum() + (lse * g_lse_t).sum(), (out, lse)
        out = tattn.flash_attention(q_, k_, v_, causal)
        return (out * g_t).sum(), (out, None)

    (out, lse), grads = _torch_grads(port, q, k, v)
    _close(out, want_out)
    if with_lse:
        assert lse.shape == (q.shape[0] * q.shape[2], q.shape[1], 1)
        assert lse.dtype == torch.float32
        _close(lse, want_lse)
    for got, want in zip(grads, want_grads):
        _close(got, want)
    if not with_lse:
        # The dispatcher's CPU choice (blockwise) agrees too.
        _, grads_bw = _torch_grads(
            lambda a, b, c: ((tattn.attention(a, b, c, causal) * g_t).sum(),
                             None), q, k, v)
        for got, want in zip(grads_bw, want_grads):
            _close(got, want)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_versions_at_ragged_length(causal):
    """T = 200 (not a multiple of any block): the flash plain versions,
    blockwise with a ragged last block, and the port's mha_reference,
    against the JAX mha_reference's output and gradients."""
    q, k, v, g, _ = _inputs(seed=7, batch=2, seq=200, heads=2, depth=16)

    def jloss(q_, k_, v_):
        return jnp.sum(jattn.mha_reference(q_, k_, v_, causal) * g)

    want_out = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal)
    want_grads = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    g_t = torch.from_numpy(g)
    impls = {
        "flash": lambda a, b, c: tattn.flash_attention(a, b, c, causal),
        "blockwise": lambda a, b, c: tattn.blockwise_mha(
            a, b, c, causal, block_size=64),
        "reference": lambda a, b, c: tattn.mha_reference(a, b, c, causal),
    }
    def loss(fn):
        def run(a, b, c):
            out = fn(a, b, c)
            return (out * g_t).sum(), out
        return run

    for fn in impls.values():
        out, grads = _torch_grads(loss(fn), q, k, v)
        _close(out, want_out)
        for got, want in zip(grads, want_grads):
            _close(got, want)


def test_dispatch_takes_plain_versions_on_cpu_and_kernels_refuse_cpu():
    q, k, v, _, _ = _inputs(seed=3, seq=64, depth=64)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    before = dict(tattn.launches)
    plain = tattn.plain_calls["blockwise"]
    out = tattn.attention(qt, kt, vt)
    assert out.shape == qt.shape
    assert tattn.plain_calls["blockwise"] == plain + 1
    assert tattn.launches == before
    ref = tattn.attention(qt, kt, vt, impl="reference")
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(qt, kt, vt, impl="bogus")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.flash_forward_kernel(qt, kt, vt, True)
    lse = torch.zeros(q.shape[0] * q.shape[2], q.shape[1], 1)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tattn.flash_backward_kernel(qt, kt, vt, lse, qt, lse, True)
    assert tattn.launches == before


def test_strided_views_pass_their_strides():
    """The kernels read q/k/v through their (batch, time, head) strides:
    a head-sliced view of a fused [B, T, 3H, D] projection is taken
    without a copy, while a non-contiguous last dim is refused."""
    fused = torch.zeros(2, 8, 6, 64)
    q, k = fused[:, :, :2], fused[:, :, 2:4]
    assert tattn._rows_aligned(q) and not q.is_contiguous()
    strides = list(tattn._strides(q, k))
    assert strides == [8 * 6 * 64, 6 * 64, 64] * 2
    assert not tattn._rows_aligned(fused.transpose(2, 3)[:, :, :2])
