"""Ring attention: exact causal attention over sequence shards held by the
ranks of a sequence-parallel ring.

Counterpart of batch_shipyard_tpu/ops/ring_attention.py. Each rank keeps
its Q shard and passes K/V shards around the ring; after sp - 1
rotations every query has seen the whole sequence, with memory O(T/sp)
per rank. The reference is global-view SPMD under shard_map; the port's
``ring_attention`` takes this rank's local shards [B, T/sp, H, D] and a
``parallel.mesh.RingGroup``, and returns this rank's output shard.

Three tiers, the reference's three meanings (``impl``):

- ``"kernel"`` (the reference's ``"pallas_dma"``): the flash kernels K1/K2
  on each rotation and the ring permute K12 (ops/ring_collectives.py) to
  rotate K/V. CUDA tensors only.
- ``"flash"`` (the reference's ``"flash"``): the same rotation cases on
  flash_attention_with_lse (its plain versions on CPU tensors), K/V
  rotated by the plain permute over gloo (CPU tensors only).
- ``"plain"`` (the reference's ``"xla"``): the online-softmax update with
  absolute offsets (ops/attention.attention_block_update), plain permute.

``"auto"`` is ``SHIPYARD_RING_IMPL`` if set (the port's names or the
reference's), else ``"kernel"`` for CUDA tensors and ``"plain"`` for CPU
tensors. Nothing falls back: on a CUDA tensor the permute launches K12
or raises.

The rotation stays on the current stream, after the rotation's flash.
The reference lets XLA overlap each rotation with the block's attention;
with four ranks sharing one card, issuing each K12 on a side stream
beside the flash made the step slower than rotating in order (PERF.md
§6), so the port rotates in order.

Every rank issues the same sequence of rotations, forward and backward,
or the ring deadlocks. The reference's scan rotates sp times and drops
the last K/V; the port rotates sp - 1 times. A causal rank r computes 1
diagonal and r full rotations and masks the rest, so a masked rotation's
K/V would reach no loss on rank 0 and autograd would skip its backward
permute that rank sp - 1 still issues: ``_MaskedRotation`` keeps masked
K/V in the graph with zero cotangents, as the reference's lax.switch does.
The model's remat (models/transformer.py) recomputes whole blocks with
checkpoint early stop off, so the recomputed forward rotates sp - 1 times
on every rank too.
"""

from __future__ import annotations

import functools
import math
import os

import torch
from torch.utils.checkpoint import checkpoint

from batch_shipyard_tpu_torch.ops import attention as attn_ops
from batch_shipyard_tpu_torch.ops import ring_collectives

RING_IMPLS = ("kernel", "flash", "plain")
# The reference's tier names (ring_attention.py:38) -> the port's.
REFERENCE_IMPLS = {"pallas_dma": "kernel", "flash": "flash", "xla": "plain"}
IMPL_ENV = "SHIPYARD_RING_IMPL"


def _tier(name: str, where: str) -> str:
    tier = REFERENCE_IMPLS.get(name, name)
    if tier not in RING_IMPLS:
        raise ValueError(f"{where}={name!r}: must be one of "
                         f"{', '.join(RING_IMPLS)} (or the reference's "
                         f"{', '.join(REFERENCE_IMPLS)})")
    return tier


def resolve_ring_impl(impl: str = "auto", device=None) -> str:
    """Explicit impl > SHIPYARD_RING_IMPL > "kernel" on a CUDA device,
    "plain" elsewhere."""
    if impl != "auto":
        return _tier(impl, "impl")
    env = os.environ.get(IMPL_ENV)
    if env:
        return _tier(env, IMPL_ENV)
    cuda = device is not None and torch.device(device).type == "cuda"
    return "kernel" if cuda else "plain"


class _MaskedRotation(torch.autograd.Function):
    """A rotation whose keys all lie after this shard's queries: the
    empty partial (masked_attention_block), with k and v kept in the
    graph (zero cotangents) so the permutes that brought them run their
    backward on every rank."""

    @staticmethod
    def forward(ctx, q, k, v):
        ctx.like = [(t.shape, t.dtype, t.device) for t in (k, v)]
        ctx.set_materialize_grads(False)
        return attn_ops.masked_attention_block(q)

    @staticmethod
    def backward(ctx, g_o, g_lse):
        (k_shape, dtype, device), (v_shape, _, _) = ctx.like
        return (None, torch.zeros(k_shape, dtype=dtype, device=device),
                torch.zeros(v_shape, dtype=dtype, device=device))


def _flash_ring_rotation(q, k_cur, v_cur, my_idx: int, src: int,
                         causal: bool):
    """One rotation's partial (o, lse) on flash_attention_with_lse: K/V
    from a later shard are masked, the own shard is the causal diagonal,
    an earlier shard is fully visible. my_idx and src are this rank's and
    the K/V's shard indices (plain ints: the case is known on the host,
    where the reference selects it with lax.switch)."""
    if not causal:
        return attn_ops.flash_attention_with_lse(q, k_cur, v_cur, False)
    if src > my_idx:
        return _MaskedRotation.apply(q, k_cur, v_cur)
    return attn_ops.flash_attention_with_lse(q, k_cur, v_cur, src == my_idx)


def _ring_attention_local_flash(q, k, v, group, causal: bool, rotate):
    """Per-shard ring body on the flash kernels (tiers kernel, flash):
    one case of _flash_ring_rotation per rotation, partials merged in
    logsumexp space."""
    sp, me = group.size, group.rank
    o_acc, lse_acc = attn_ops.masked_attention_block(q)
    for t in range(sp):
        src = (me - t) % sp
        o_s, lse_s = _flash_ring_rotation(q, k, v, me, src, causal)
        o_acc, lse_acc = attn_ops.merge_attention_blocks(o_acc, lse_acc,
                                                         o_s, lse_s)
        if t < sp - 1:
            k, v = rotate(k, v)
    return o_acc


def _ring_attention_local(q, k, v, group, causal: bool, rotate):
    """Per-shard ring body of the plain tier: the online-softmax update
    at absolute offsets, each update recomputed in the backward
    (torch.utils.checkpoint, the reference's jax.checkpoint) so no
    rotation's [B, H, T/sp, T/sp] scores are kept."""
    sp, me = group.size, group.rank
    t_local = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, m, l = attn_ops.attention_init(q)
    for t in range(sp):
        src = (me - t) % sp
        update = functools.partial(
            attn_ops.attention_block_update, causal=causal,
            q_offset=me * t_local, kv_offset=src * t_local, scale=scale)
        if torch.is_grad_enabled():
            o, m, l = checkpoint(update, q, k, v, o, m, l,
                                 use_reentrant=False)
        else:
            o, m, l = update(q, k, v, o, m, l)
        if t < sp - 1:
            k, v = rotate(k, v)
    return attn_ops.attention_finalize(q, o, m, l)


def ring_attention_virtual_shards(q, k, v, sp: int, causal: bool = True):
    """The flash ring's rotation cases and merge over ``sp`` virtual
    sequence shards of global q, k, v [B, T, H, D] on one device: the
    one-device stand-in for the ring (K1/K2 on CUDA tensors, their plain
    versions on CPU tensors)."""
    if q.shape[1] % sp or k.shape[1] != q.shape[1]:
        raise ValueError(
            f"sequence length {q.shape[1]} (kv {k.shape[1]}) must be "
            f"equal and divisible by sp={sp}")
    t_local = q.shape[1] // sp
    outs = []
    for my_idx in range(sp):
        q_s = q[:, my_idx * t_local:(my_idx + 1) * t_local]
        o_acc, lse_acc = attn_ops.masked_attention_block(q_s)
        for t in range(sp):
            src = (my_idx - t) % sp
            rows = slice(src * t_local, (src + 1) * t_local)
            o_s, lse_s = _flash_ring_rotation(q_s, k[:, rows], v[:, rows],
                                              my_idx, src, causal)
            o_acc, lse_acc = attn_ops.merge_attention_blocks(
                o_acc, lse_acc, o_s, lse_s)
        outs.append(o_acc)
    return torch.cat(outs, dim=1)


def ring_attention(q, k, v, group, causal: bool = True,
                   impl: str = "auto"):
    """This rank's attention output [B, T/sp, H, D] over the whole
    sequence: q, k, v are this rank's shards (shard ``group.rank`` of the
    sequence), ``group`` a parallel.mesh.RingGroup."""
    impl = resolve_ring_impl(impl, q.device)
    if impl in ("kernel", "flash") and not attn_ops.flash_shapes_ok(
            q.shape[1], k.shape[1], q.shape[-1]):
        raise ValueError(
            f"shards of {q.shape[1]} queries, {k.shape[1]} keys, depth "
            f"{q.shape[-1]} do not fit the flash kernels; use impl='plain'")
    rotate = functools.partial(
        ring_collectives.ring_permute_pair, group=group,
        impl="kernel" if impl == "kernel" else "plain")
    body = (_ring_attention_local if impl == "plain"
            else _ring_attention_local_flash)
    # K12 rotates contiguous buffers; with fused_norm, v is a strided view
    # of the [q | k | v] projection (a copy here, nothing otherwise).
    return body(q, k.contiguous(), v.contiguous(), group, causal, rotate)
