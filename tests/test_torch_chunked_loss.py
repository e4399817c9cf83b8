"""The port's chunked tied-embedding cross-entropy (ops/chunked_loss.py
and models/transformer.lm_loss_chunked / lm_loss) against the JAX
reference's scan-chunked XLA path (impl="xla") on the CPU: the same
numpy-seeded hidden states, embedding and targets through both, loss
and both gradients in fp32 within 1e-5 (summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu.ops import chunked_loss as jcl
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.ops import chunked_loss as tcl

TOL = dict(atol=1e-5, rtol=1e-5)
VOCAB, D = 96, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Keep this module's small torch ops on one thread: the suite runs
    in several worker processes beside timing-sensitive tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, lead, ignore_frac=0.0):
    rng = np.random.RandomState(seed)
    hidden = rng.randn(*lead, D).astype(np.float32)
    embedding = (rng.randn(VOCAB, D) * 0.2).astype(np.float32)
    targets = rng.randint(0, VOCAB, lead).astype(np.int32)
    targets[rng.rand(*lead) < ignore_frac] = -1
    return hidden, embedding, targets


def _jax(fn, hidden, embedding, targets):
    loss, grads = jax.value_and_grad(fn, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(embedding), jnp.asarray(targets))
    return float(loss), grads


def _torch(fn, hidden, embedding, targets):
    h = torch.from_numpy(hidden).requires_grad_()
    e = torch.from_numpy(embedding).requires_grad_()
    loss = fn(h, e, torch.from_numpy(targets))
    loss.backward()
    return float(loss.detach()), (h.grad, e.grad)


def _check(got, want):
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# (rows, chunk, fraction of targets ignored): even chunks; a ragged
# last chunk (the reference shrinks every chunk to gcd(N, chunk)); an
# ignore_id mask; every token ignored (loss and gradients zero).
CASES = [(64, 16, 0.0), (50, 16, 0.0), (64, 16, 0.3), (40, 16, 1.0)]


@pytest.mark.parametrize("rows,chunk,ignore_frac", CASES)
def test_chunked_softmax_xent_matches_xla(rows, chunk, ignore_frac):
    hidden, embedding, targets = _inputs(rows, (rows,), ignore_frac)
    want = _jax(lambda h, e, t: jcl.chunked_softmax_xent(
        h, e, t, impl="xla", chunk_size=chunk), hidden, embedding, targets)
    got = _torch(lambda h, e, t: tcl.chunked_softmax_xent(
        h, e, t, chunk_size=chunk), hidden, embedding, targets)
    _check(got, want)
    if ignore_frac == 1.0:
        assert got[0] == 0.0
        assert not got[1][0].any() and not got[1][1].any()


@pytest.mark.parametrize("ignore_frac", [0.0, 0.25])
def test_lm_loss_chunked_matches_reference(ignore_frac):
    """[B, T, D] hidden: chunk_size counts time steps per batch row
    (T = 24 with chunk 8 -> 3 slabs of 8*B rows), and lm_loss over the
    full fp32 logits gives the same number."""
    hidden, embedding, targets = _inputs(5, (3, 24), ignore_frac)
    want = _jax(lambda h, e, t: jtfm.lm_loss_chunked(
        h, e, t, chunk_size=8, impl="xla"), hidden, embedding, targets)
    got = _torch(lambda h, e, t: ttfm.lm_loss_chunked(
        h, e, t, chunk_size=8), hidden, embedding, targets)
    _check(got, want)
    full = _torch(lambda h, e, t: ttfm.lm_loss(h @ e.t(), t),
                  hidden, embedding, targets)
    want_full = _jax(lambda h, e, t: jtfm.lm_loss(h @ e.T, t),
                     hidden, embedding, targets)
    _check(full, want_full)
    _check(full, want)


def test_pallas_impl_is_not_ported():
    hidden, embedding, targets = _inputs(0, (8,))
    args = (torch.from_numpy(hidden), torch.from_numpy(embedding),
            torch.from_numpy(targets))
    with pytest.raises(NotImplementedError, match="K3-K5"):
        tcl.chunked_softmax_xent(*args, impl="pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        tcl.chunked_softmax_xent(*args, impl="bogus")
