"""The port's ring attention (ops/ring_attention.py) and its merge of
partials (ops/attention.py) against the JAX reference on the CPU, fp32.

- merge_attention_blocks / masked_attention_block equal the reference's,
  rows that see no key included (1e-6).
- ring_attention_virtual_shards equals the reference's with its flash
  kernels in Pallas interpret mode, forward and gradients, causal and
  full, within 1e-5 (sp 2 at seq 256: the smallest shards the
  reference's flash tiles take, attention.py:43-51).
- ring_attention over four gloo ranks (the flash and plain tiers, plain
  rotations) equals the reference's ring_attention(impl="xla") on the
  four-device CPU mesh, forward and gradients, within 1e-5, and every
  rank issues the same number of rotations.
- Under the model's remat every rank issues the same rotations forward
  and backward; without the masked rotations' zero cotangents rank 0
  would skip backward rotations that rank 3 issues (a deadlock on the
  card).
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from batch_shipyard_tpu.ops import attention as jattn
from batch_shipyard_tpu.ops import ring_attention as jring
from batch_shipyard_tpu.parallel import mesh as jmesh
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.ops import attention as tattn
from batch_shipyard_tpu_torch.ops import ring_attention as tring
from batch_shipyard_tpu_torch.ops import ring_collectives as trc
from batch_shipyard_tpu_torch.workloads import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS_TIMEOUT_S = 120
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(batch, seq, heads, depth, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(batch, seq, heads, depth) * 0.5).astype(np.float32)
            for _ in range(4)]  # q, k, v and a cotangent


def test_merge_and_masked_block_match_reference():
    rng = np.random.RandomState(1)
    batch, seq, heads, depth = 2, 6, 3, 8
    o1, o2 = (rng.randn(batch, seq, heads, depth).astype(np.float32)
              for _ in range(2))
    lse1, lse2 = (rng.randn(batch * heads, seq, 1).astype(np.float32)
                  for _ in range(2))
    lse1[0, :2] = -1e30          # rows the first partial has no key for
    lse2[1, 3:] = -1e30          # and the second
    lse1[2, 4], lse2[2, 4] = -1e30, -1e30   # a row with no key at all
    want_o, want_lse = jattn.merge_attention_blocks(*map(
        jnp.asarray, (o1, lse1, o2, lse2)))
    got_o, got_lse = tattn.merge_attention_blocks(*map(
        torch.from_numpy, (o1, lse1, o2, lse2)))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               atol=1e-6, rtol=1e-6)
    assert float(got_lse[2, 4, 0]) == np.float32(-1e30)
    q = torch.from_numpy(o1)
    want_o, want_lse = jattn.masked_attention_block(jnp.asarray(o1))
    got_o, got_lse = tattn.masked_attention_block(q)
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(want_o))
    np.testing.assert_array_equal(got_lse.numpy(), np.asarray(want_lse))
    assert got_lse.dtype == torch.float32


def test_flash_shapes_ok_follows_the_kernels():
    assert tattn.flash_shapes_ok(2048, 2048, 64)
    assert tattn.flash_shapes_ok(1000, 1000, 128)   # ragged tails masked
    assert not tattn.flash_shapes_ok(1000, 2000, 64)
    assert not tattn.flash_shapes_ok(128, 128, 32)


@pytest.mark.parametrize("causal", [True, False])
def test_virtual_shards_match_reference_interpret(causal):
    """The reference's flash kernels (K1/K2) in interpret mode against the
    port's on CPU tensors (their plain versions), at sp 2."""
    q, k, v, g = _qkv(1, 256, 2, 64)

    def ref(q, k, v, g):
        out, vjp = jax.vjp(lambda *x: jring.ring_attention_virtual_shards(
            *x, 2, causal), q, k, v)
        return out, vjp(g)
    with pltpu.force_tpu_interpret_mode():
        want_out, want_grads = jax.jit(ref)(*map(jnp.asarray, (q, k, v, g)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tring.ring_attention_virtual_shards(tq, tk, tv, 2, causal)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)
    for got, want in zip(grads, want_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


def test_resolve_ring_impl(monkeypatch):
    monkeypatch.delenv(tring.IMPL_ENV, raising=False)
    assert tring.resolve_ring_impl("auto", "cpu") == "plain"
    assert tring.resolve_ring_impl("auto", torch.device("cuda")) == "kernel"
    assert tring.resolve_ring_impl("flash") == "flash"
    assert tring.resolve_ring_impl("pallas_dma") == "kernel"
    monkeypatch.setenv(tring.IMPL_ENV, "xla")
    assert tring.resolve_ring_impl("auto", "cuda") == "plain"
    assert tring.resolve_ring_impl("kernel") == "kernel"
    monkeypatch.setenv(tring.IMPL_ENV, "bogus")
    with pytest.raises(ValueError, match="SHIPYARD_RING_IMPL"):
        tring.resolve_ring_impl("auto", "cpu")


class _Ring:
    """A ring position without peers, for single-process tests."""

    def __init__(self, rank: int, size: int) -> None:
        self.rank, self.size = rank, size


def _rotations_by_rank(monkeypatch, masked_in_graph: bool) -> dict:
    """(forward, backward) rotations each of four ranks issues in one
    training step of a two-layer model with remat, causal ring attention
    on the flash tier; the permute is replaced by a counting identity."""
    calls = []

    def permute(k, v, group, shift=1, impl=None):
        calls.append(shift)
        return k.clone(), v.clone()
    monkeypatch.setattr(trc, "ring_permute", permute)
    if not masked_in_graph:
        monkeypatch.setattr(tring._MaskedRotation, "apply",
                            lambda q, k, v: tattn.masked_attention_block(q))
    seq, sp = 32, 4
    counts = {}
    for rank in range(sp):
        cfg = ttfm.TransformerConfig(
            vocab_size=64, d_model=128, n_layers=2, n_heads=2, d_head=64,
            d_ff=64, dtype=torch.float32, remat=True,
            attention_fn=functools.partial(tring.ring_attention,
                                           group=_Ring(rank, sp),
                                           impl="flash"))
        model = ttfm.TransformerLM(cfg)
        model.load_state_dict(convert.init_params(
            cfg, torch.Generator().manual_seed(0)))
        width = seq // sp
        tokens = torch.arange(width)[None] % 64
        positions = torch.arange(rank * width, (rank + 1) * width)
        calls.clear()
        model(tokens, positions=positions, return_hidden=True).sum().backward()
        counts[rank] = (calls.count(1), calls.count(-1))
    return counts


def test_every_rank_issues_the_same_rotations_under_remat(monkeypatch):
    counts = _rotations_by_rank(monkeypatch, masked_in_graph=True)
    layers, sp = 2, 4
    # Forward and remat's recompute rotate +1; the backward -1.
    assert set(counts.values()) == {(2 * (sp - 1) * layers,
                                     (sp - 1) * layers)}, counts


def test_masked_rotations_without_cotangents_would_part_the_ranks(
        monkeypatch):
    counts = _rotations_by_rank(monkeypatch, masked_in_graph=False)
    assert counts[3] == (12, 6)
    assert counts[0][1] < counts[3][1], counts  # rank 0 would hang rank 3


def test_fused_norm_rotates_contiguous_pairs(monkeypatch):
    """With fused_norm, v is a strided view of the [q | k | v]
    projection; K12 takes contiguous buffers only (its wrapper raises on
    a strided one), so every pair ring attention rotates, forward and
    backward, must be contiguous."""
    seen = []

    def permute(k, v, group, shift=1, impl=None):
        seen.append(k.is_contiguous() and v.is_contiguous())
        return k.clone(), v.clone()
    monkeypatch.setattr(trc, "ring_permute", permute)
    sp, width = 2, 16
    cfg = ttfm.TransformerConfig(
        vocab_size=64, d_model=128, n_layers=1, n_heads=2, d_head=64,
        d_ff=64, dtype=torch.float32, fused_norm=True,
        attention_fn=functools.partial(tring.ring_attention,
                                       group=_Ring(1, sp), impl="flash"))
    model = ttfm.TransformerLM(cfg)
    model.load_state_dict(convert.init_params(
        cfg, torch.Generator().manual_seed(0)))
    model(torch.arange(width)[None] % 64,
          positions=torch.arange(width, 2 * width),
          return_hidden=True).sum().backward()
    assert seen and all(seen), seen


# A rank of the four-process check: ring_attention on this rank's
# shards, for each (tier, causal); outputs and gradients saved.
WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
from batch_shipyard_tpu_torch.ops import ring_attention, ring_collectives
from batch_shipyard_tpu_torch.parallel import mesh
from batch_shipyard_tpu_torch.workloads import distributed
distributed.setup("cpu")
group = mesh.RingGroup()
r, sp = group.rank, group.size
data = np.load(os.path.join(sys.argv[1], "inputs.npz"))
width = data["q"].shape[1] // sp
local = {n: torch.from_numpy(data[n][:, r * width:(r + 1) * width].copy())
         for n in ("q", "k", "v", "g")}
out = {}
for impl in ("plain", "flash"):
    for causal in (True, False):
        q, k, v = (local[n].clone().requires_grad_() for n in "qkv")
        before = ring_collectives.plain_calls["ring_permute"]
        o = ring_attention.ring_attention(q, k, v, group, causal=causal,
                                          impl=impl)
        grads = torch.autograd.grad(o, (q, k, v), local["g"])
        tag = f"{impl}_{int(causal)}"
        out[tag] = o.detach().numpy()
        for name, grad in zip("qkv", grads):
            out[f"{tag}_d{name}"] = grad.numpy()
        out[f"{tag}_rotations"] = np.array(
            ring_collectives.plain_calls["ring_permute"] - before)
np.savez(os.path.join(sys.argv[1], f"rank{r}.npz"), **out)
"""


def test_four_ranks_match_reference_ring_attention(tmp_path):
    sp = 4
    q, k, v, g = _qkv(1, 64, 2, 64, seed=2)
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, g=g)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    runs = distributed.launch_local([sys.executable, "-c", WORKER,
                                     str(tmp_path)], sp, RANKS_TIMEOUT_S,
                                    env=env, cwd=REPO)
    bad = [r for r in runs if r["returncode"] != 0 or r["timed_out"]]
    assert not bad, [(r["rank"], r["stderr"][-2000:]) for r in bad]
    got = [np.load(tmp_path / f"rank{r}.npz") for r in range(sp)]
    mesh = jmesh.make_mesh(jmesh.auto_axis_sizes(4, sp=4),
                           devices=jax.devices()[:4])
    for causal in (True, False):
        def ref(q, k, v, g):
            out, vjp = jax.vjp(lambda *x: jring.ring_attention(
                *x, mesh, causal=causal, impl="xla"), q, k, v)
            return out, vjp(g)
        want, want_grads = jax.jit(ref)(*map(jnp.asarray, (q, k, v, g)))
        for impl in ("plain", "flash"):
            tag = f"{impl}_{int(causal)}"
            np.testing.assert_allclose(
                np.concatenate([x[tag] for x in got], axis=1),
                np.asarray(want), atol=TOL, rtol=TOL, err_msg=tag)
            for name, w in zip("qkv", want_grads):
                np.testing.assert_allclose(
                    np.concatenate([x[f"{tag}_d{name}"] for x in got],
                                   axis=1),
                    np.asarray(w), atol=TOL, rtol=TOL,
                    err_msg=f"{tag} d{name}")
            # sp - 1 forward rotations and as many backward, every rank.
            assert {int(x[f"{tag}_rotations"]) for x in got} == \
                {2 * (sp - 1)}, tag
