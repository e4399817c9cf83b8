"""The port's chunked tied-embedding cross-entropy (ops/chunked_loss.py
and models/transformer.lm_loss_chunked / lm_loss) against the JAX
reference on the CPU: the plain slab path against the reference's
scan-chunked XLA path (impl="xla"), and the kernel path (its autograd
Function on the plain versions of K3-K5) against the reference's fused
Pallas kernels in interpret mode (impl="interpret"). The same
numpy-seeded hidden states, embedding and targets go through both; loss
and both gradients in fp32 within 1e-5 (summation order only). Then
impl dispatch: 'auto' takes the kernel only for a CUDA device with a
'cuda' validation marker."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu.ops import chunked_loss as jcl
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.ops import chunked_loss as tcl
from batch_shipyard_tpu_torch.ops import kernel_select

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


def _inputs(seed, lead, ignore_frac=0.0, vocab=VOCAB, depth=D):
    rng = np.random.RandomState(seed)
    hidden = rng.randn(*lead, depth).astype(np.float32)
    embedding = (rng.randn(vocab, depth) * 0.2).astype(np.float32)
    targets = rng.randint(0, vocab, lead).astype(np.int32)
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


# (rows, vocab, depth, fraction of targets ignored): D 128 and 256;
# ragged rows (2 x 96: not a multiple of the reference's 128-row tile);
# ragged vocab (700: not a multiple of its 512-wide vocab tile); an
# ignore_id mask; every target ignored (loss and gradients zero).
KERNEL_CASES = [(128, 512, 128, 0.0), (128, 512, 256, 0.0),
                ((2, 96), 512, 128, 0.0), (128, 700, 128, 0.0),
                (256, 700, 256, 0.2), (128, 512, 128, 1.0)]


@pytest.mark.parametrize("rows,vocab,depth,ignore_frac", KERNEL_CASES)
def test_kernel_impl_matches_reference_pallas_interpret(rows, vocab, depth,
                                                        ignore_frac):
    lead = rows if isinstance(rows, tuple) else (rows,)
    hidden, embedding, targets = _inputs(depth + vocab, lead, ignore_frac,
                                         vocab=vocab, depth=depth)
    want = _jax(lambda h, e, t: jcl.chunked_softmax_xent(
        h, e, t, impl="interpret"), hidden, embedding, targets)
    calls = dict(tcl.plain_calls)
    got = _torch(lambda h, e, t: tcl.chunked_softmax_xent(
        h, e, t, impl="kernel"), hidden, embedding, targets)
    _check(got, want)
    # CPU tensors run the kernels' plain versions, once each.
    for key in ("xent_fwd", "xent_bwd_h", "xent_bwd_e"):
        assert tcl.plain_calls[key] == calls[key] + 1
    assert tcl.plain_calls["chunked"] == calls["chunked"]
    if ignore_frac == 1.0:
        assert got[0] == 0.0
        assert not got[1][0].any() and not got[1][1].any()


def test_plain_versions_match_the_slab_path():
    """K3's (lse, gold) and K4/K5's gradients against autograd through
    the plain slab path, on bf16 hidden rows (the training input)."""
    hidden, embedding, targets = _inputs(7, (160,), 0.1, vocab=300,
                                         depth=128)
    h = torch.from_numpy(hidden).to(torch.bfloat16)
    e = torch.from_numpy(embedding)
    t = torch.from_numpy(targets)
    lse, gold = tcl.xent_forward_reference(h, e, t)
    logits = h.float() @ e.t()
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(logits, -1).numpy(), **TOL)
    live = t != -1
    np.testing.assert_allclose(
        gold[live].numpy(),
        logits[live].gather(1, t[live].long()[:, None])[:, 0].numpy(),
        **TOL)
    assert not gold[~live].any()
    hp = h.float().requires_grad_()
    ep = e.clone().requires_grad_()
    loss = tcl.chunked_softmax_xent(hp, ep, t, impl="plain", chunk_size=64)
    loss.backward()
    mask = live.float()
    ds = mask / mask.sum()
    np.testing.assert_allclose(
        tcl.xent_backward_h_reference(h, e, t, lse, ds).numpy(),
        hp.grad.numpy(), **TOL)
    np.testing.assert_allclose(
        tcl.xent_backward_e_reference(h, e, t, lse, ds).numpy(),
        ep.grad.numpy(), **TOL)



def _backward_inputs(rows, vocab, depth, ignore_frac):
    """h (bf16 rows, as training feeds them), e, targets, lse and ds =
    mask / count for the backward's plain versions."""
    lead = rows if isinstance(rows, tuple) else (rows,)
    hidden, embedding, targets = _inputs(depth + vocab, lead, ignore_frac,
                                         vocab=vocab, depth=depth)
    h = torch.from_numpy(hidden.reshape(-1, depth)).to(torch.bfloat16)
    e = torch.from_numpy(embedding)
    t = torch.from_numpy(targets.reshape(-1))
    lse, _ = tcl.xent_forward_reference(h, e, t)
    mask = (t != -1).float()
    return h, e, t, lse, mask / mask.sum().clamp(min=1.0)


@pytest.mark.parametrize("chunk", [tcl.BWD_CHUNK, 256])
@pytest.mark.parametrize("rows,vocab,depth,ignore_frac", KERNEL_CASES)
def test_joint_backward_reference_matches_separate(rows, vocab, depth,
                                                   ignore_frac, chunk):
    """The joint plain version (one dlogits chunk feeding both products,
    chunk 256 not dividing V 700) against K4's and K5's plain versions;
    every target ignored gives exact zeros; need_h / need_e alone give
    the same gradient and count one plain call of their kernel."""
    args = _backward_inputs(rows, vocab, depth, ignore_frac)
    gh, ge = tcl.xent_backward_reference(*args, chunk=chunk)
    np.testing.assert_allclose(
        gh.numpy(), tcl.xent_backward_h_reference(*args).numpy(), **TOL)
    np.testing.assert_allclose(
        ge.numpy(), tcl.xent_backward_e_reference(*args).numpy(), **TOL)
    if ignore_frac == 1.0:
        assert not gh.any() and not ge.any()
    calls = dict(tcl.plain_calls)
    only_h = tcl.xent_backward_reference(*args, need_e=False, chunk=chunk)
    assert only_h[1] is None and torch.equal(only_h[0], gh)
    only_e = tcl.xent_backward_reference(*args, need_h=False, chunk=chunk)
    assert only_e[0] is None and torch.equal(only_e[1], ge)
    assert tcl.plain_calls["xent_bwd_h"] == calls["xent_bwd_h"] + 1
    assert tcl.plain_calls["xent_bwd_e"] == calls["xent_bwd_e"] + 1


def test_joint_backward_chunk_schedule():
    """Chunks of 256 over V 700 (two whole, one ragged of 188): grad_h is
    the in-order sum of the chunks' dl @ E_chunk, bit for bit, and each
    chunk writes its own rows of grad_E."""
    h, e, t, lse, ds = _backward_inputs(96, 700, 128, 0.2)
    gh, ge = tcl.xent_backward_reference(h, e, t, lse, ds, chunk=256)
    hf = h.float()
    want_h = torch.zeros_like(hf)
    for v0 in (0, 256, 512):
        ec = e[v0:v0 + 256]
        dl = torch.exp(hf @ ec.t() - lse[:, None])
        for r in range(len(t)):
            if t[r] != -1 and v0 <= t[r] < v0 + len(ec):
                dl[r, t[r] - v0] -= 1.0
        dl *= ds[:, None]
        want_h += dl @ ec
        assert torch.equal(ge[v0:v0 + len(ec)], dl.t() @ hf)
    assert torch.equal(gh, want_h)


@pytest.mark.parametrize("rows,vocab,depth", [
    (32768, 32000, 1024), (16384, 32000, 1024), (1000, 700, 128)])
def test_backward_scratch_is_bounded(rows, vocab, depth):
    """The kernels' scratch: the dlogits chunk and its transpose are
    2 * 4 * N * BWD_CHUNK bytes at most (1.07 GB at bench_transformer's
    32768 rows), each padded to whole tiles; K4 or K5 alone holds one of
    the two."""
    shapes, chunk = tcl.backward_scratch(rows, vocab, depth)
    np_ = -(-rows // 128) * 128
    assert chunk % 256 == 0 and chunk <= max(tcl.BWD_CHUNK, 256)
    # K-panels [K / 32, rows, 32] of dl [np, chunk], dl^T [chunk, np],
    # E^T [dp, vp] and h^T [dp, np].
    assert shapes["dl"] == (chunk // 32, np_, 32)
    assert shapes["dlt"] == (np_ // 32, chunk, 32)
    assert shapes["h32"] == (rows, depth) and shapes["e32"] == (vocab, depth)
    dp = max(depth, 256)
    assert shapes["et"] == (-(-vocab // 256) * 8, dp, 32)
    assert shapes["ht"] == (np_ // 32, dp, 32)
    dl_bytes = 4 * (np.prod(shapes["dl"]) + np.prod(shapes["dlt"]))
    assert dl_bytes <= 2 * 4 * np_ * tcl.BWD_CHUNK
    if rows == 32768:
        assert dl_bytes == 1073741824
    only_h, _ = tcl.backward_scratch(rows, vocab, depth, need_e=False)
    only_e, _ = tcl.backward_scratch(rows, vocab, depth, need_h=False)
    assert set(only_h) == {"h32", "e32", "et", "dl"}
    assert set(only_e) == {"h32", "e32", "ht", "dlt"}


@pytest.mark.parametrize("wanted", ["hidden", "embedding"])
def test_fused_backward_computes_only_what_is_wanted(wanted):
    """The autograd Function asks the backward for the gradients autograd
    needs: one plain call of that kernel's version, none of the other."""
    h, e, t = (torch.from_numpy(x) for x in _inputs(3, (40,), 0.1,
                                                    depth=128))
    leaf = h if wanted == "hidden" else e
    leaf.requires_grad_()
    calls = dict(tcl.plain_calls)
    tcl.chunked_softmax_xent(h, e, t, impl="kernel").backward()
    key, other = (("xent_bwd_h", "xent_bwd_e") if wanted == "hidden"
                  else ("xent_bwd_e", "xent_bwd_h"))
    assert tcl.plain_calls[key] == calls[key] + 1
    assert tcl.plain_calls[other] == calls[other]
    assert leaf.grad is not None and bool(leaf.grad.any())


def _args(depth=128):
    hidden, embedding, targets = _inputs(0, (8,), depth=depth)
    return (torch.from_numpy(hidden), torch.from_numpy(embedding),
            torch.from_numpy(targets))


def _dispatched(monkeypatch, impl, depth=128, device="cpu"):
    """The path chunked_softmax_xent takes ('kernel' or 'plain'), read
    from the plain-version counters; ``device`` is what kernel_select
    is told the hidden rows live on."""
    real = kernel_select.resolve_auto
    monkeypatch.setattr(kernel_select, "resolve_auto",
                        lambda name, _dev, *a, **k: real(name, device, *a,
                                                         **k))
    before = dict(tcl.plain_calls)
    tcl.chunked_softmax_xent(*_args(depth), impl=impl)
    if tcl.plain_calls["xent_fwd"] > before["xent_fwd"]:
        return "kernel"
    assert tcl.plain_calls["chunked"] == before["chunked"] + 1
    return "plain"


@pytest.mark.parametrize("marker", [None, "tpu", "cuda"])
def test_auto_is_plain_on_cpu_tensors(monkeypatch, tmp_path, marker):
    """With no marker, a 'tpu' marker or a 'cuda' marker, CPU tensors
    take the plain slab path under 'auto'."""
    path = tmp_path / "KERNEL_VALIDATION.json"
    if marker:
        path.write_text(json.dumps({tcl.VALIDATION_NAME: {
            "ok": True, "backend": marker}}))
    monkeypatch.setenv(kernel_select.MARKER_ENV, str(path))
    assert _dispatched(monkeypatch, "auto") == "plain"


@pytest.mark.parametrize("marker,ok,want", [
    (None, True, "plain"), ("tpu", True, "plain"), ("cuda", False, "plain"),
    ("cuda", True, "kernel")])
def test_auto_on_a_cuda_device_follows_the_marker(monkeypatch, tmp_path,
                                                  marker, ok, want):
    """kernel_select is told the rows live on a CUDA device: only an ok
    'cuda' record picks the kernel (the tensors stay on the CPU, so the
    kernel path runs its plain versions and is seen by their counters)."""
    path = tmp_path / "KERNEL_VALIDATION.json"
    if marker:
        path.write_text(json.dumps({tcl.VALIDATION_NAME: {
            "ok": ok, "backend": marker}}))
    monkeypatch.setenv(kernel_select.MARKER_ENV, str(path))
    assert _dispatched(monkeypatch, "auto", device="cuda") == want


def test_misaligned_width_and_unknown_impl(monkeypatch, tmp_path):
    """d % 128 != 0 resolves to plain before any launch, for 'kernel' and
    for a validated 'auto'; an unknown impl raises; a corrupt marker
    reads as no marker."""
    path = tmp_path / "KERNEL_VALIDATION.json"
    path.write_text(json.dumps({tcl.VALIDATION_NAME: {
        "ok": True, "backend": "cuda"}}))
    monkeypatch.setenv(kernel_select.MARKER_ENV, str(path))
    assert _dispatched(monkeypatch, "kernel", depth=96) == "plain"
    assert _dispatched(monkeypatch, "auto", depth=96,
                       device="cuda") == "plain"
    assert _dispatched(monkeypatch, "kernel", depth=128) == "kernel"
    with pytest.raises(ValueError, match="unknown impl"):
        tcl.chunked_softmax_xent(*_args(), impl="pallas")
    path.write_text("{not json")
    assert kernel_select.kernel_validation() == {}
    assert not kernel_select.kernel_validated(tcl.VALIDATION_NAME)


def test_kernel_wrappers_refuse_cpu_tensors():
    h, e, t = _args()
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcl.xent_forward_kernel(h, e, t)
    lse = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcl.xent_backward_h_kernel(h, e, t, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcl.xent_backward_e_kernel(h, e, t, lse, lse)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tcl.xent_backward_kernel(h, e, t, lse, lse)
