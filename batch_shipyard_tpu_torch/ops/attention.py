"""Attention for the training path: the plain versions and the CUDA flash
kernels (K1 forward, K2 backward).

Counterpart of batch_shipyard_tpu/ops/attention.py, in its layout: q, k,
v are [B, T, H, D]; the logsumexp rows are fp32 [B*H, T, 1].

- ``mha_reference``: materialized scores, the numerics oracle.
- ``attention_block_update`` / ``attention_init`` / ``attention_finalize``
  and ``blockwise_mha``: online softmax over kv blocks, each block
  rematerialized in the backward by ``torch.utils.checkpoint`` (where
  the reference uses ``jax.checkpoint``). Unlike the reference, the last
  block may be shorter, so any T works.
- ``flash_attention`` / ``flash_attention_with_lse``: one
  ``torch.autograd.Function`` whose forward is K1 and whose backward is
  K2 (``csrc/flash_attention.cu``) for CUDA tensors. For CPU tensors it
  runs the kernels' plain versions, ``flash_forward_reference`` and
  ``flash_backward_reference``, which repeat the kernels' arithmetic and
  rounding points on materialized scores. delta = rowsum(dO * O), less
  the lse cotangent, is plain torch on both, as in the reference.
- ``attention``: the kernel for CUDA tensors, ``blockwise_mha`` for CPU
  tensors (the reference's choice off the TPU).

- ``merge_attention_blocks`` / ``masked_attention_block``: ring
  attention's merge of partials in logsumexp space (ops/ring_attention.py),
  and ``flash_shapes_ok``, which shard lengths K1/K2 take.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops.paged_attention import stream_handle

_NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
SUPPORTED_DEPTHS = (64, 128)

# Kernel launches: each wrapper adds one where it launches (K2's wrapper
# launches its two kernels in one call and counts one). chip_smoke.py
# zeroes and reads these, and ``plain_calls`` for the plain versions.
launches = {"flash_fwd": 0, "flash_bwd": 0}
plain_calls = {"flash_fwd": 0, "flash_bwd": 0, "blockwise": 0,
               "reference": 0}


def _causal_mask(t_q: int, t_kv: int, q_offset, kv_offset, device):
    """[Tq, Tk] True where attention is allowed (key <= query)."""
    q_pos = q_offset + torch.arange(t_q, device=device)
    k_pos = kv_offset + torch.arange(t_kv, device=device)
    return q_pos[:, None] >= k_pos[None, :]


def mha_reference(q, k, v, causal: bool = True, q_offset: int = 0,
                  kv_offset: int = 0):
    """Plain attention; the numerics oracle for the fast paths."""
    plain_calls["reference"] += 1
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(q.shape[-1])
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, kv_offset,
                            q.device)
        scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


# ----------------------- online-softmax accumulation -------------------


def attention_block_update(q, k_blk, v_blk, o, m, l, *, causal: bool,
                           q_offset, kv_offset, scale: float):
    """One online-softmax step against a KV block. q [B, Tq, H, D];
    k_blk/v_blk [B, Tk, H, D]; o [B, Tq, H, D] fp32 numerator; m, l
    [B, H, Tq] running max and denominator."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k_blk.float()) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k_blk.shape[1], q_offset,
                            kv_offset, q.device)
        scores = torch.where(mask, scores, _NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    correction = torch.exp(m - m_new)
    p = torch.exp(scores - m_new[..., None])
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(v_blk.dtype).float(),
                      v_blk.float())
    return o * correction.transpose(1, 2)[..., None] + pv, m_new, l_new


def attention_init(q):
    batch, t_q, heads, depth = q.shape
    o = torch.zeros((batch, t_q, heads, depth), dtype=torch.float32,
                    device=q.device)
    m = torch.full((batch, heads, t_q), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((batch, heads, t_q), dtype=torch.float32,
                    device=q.device)
    return o, m, l


def attention_finalize(q, o, m, l):
    denom = torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)


def blockwise_mha(q, k, v, causal: bool = True, block_size: int = 512,
                  q_offset: int = 0, kv_offset: int = 0):
    """Memory-efficient attention: online softmax over KV blocks, each
    block recomputed in the backward instead of saving its
    [B, H, Tq, block] scores. Blocks wholly above the causal diagonal
    are skipped: they add exp(-1e30 - m) = 0 to every row."""
    plain_calls["blockwise"] += 1
    t_kv = k.shape[1]
    block = min(block_size, t_kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, m, l = attention_init(q)
    last_query = q_offset + q.shape[1] - 1
    for start in range(0, t_kv, block):
        if causal and kv_offset + start > last_query:
            break
        stop = min(start + block, t_kv)
        step = functools.partial(
            attention_block_update, causal=causal, q_offset=q_offset,
            kv_offset=kv_offset + start, scale=scale)
        args = (q, k[:, start:stop], v[:, start:stop], o, m, l)
        if torch.is_grad_enabled():
            o, m, l = checkpoint(step, *args, use_reentrant=False)
        else:
            o, m, l = step(*args)
    return attention_finalize(q, o, m, l)


# ------------------------ flash: plain versions ------------------------


def flash_forward_reference(q, k, v, causal: bool):
    """Plain version of K1: out [B, T, H, D] in q.dtype and lse
    [B*H, T, 1] fp32, with the kernel's rounding (fp32 scores times
    1/sqrt(D); p rounded to v.dtype before P.V; division by l at the
    end, l == 0 -> 1)."""
    plain_calls["flash_fwd"] += 1
    batch, t_len, heads, depth = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * (1.0 / math.sqrt(depth))
    if causal:
        scores = torch.where(
            _causal_mask(t_len, t_len, 0, 0, q.device), scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    denom = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(),
                       v.float())
    out = out / denom.transpose(1, 2)
    lse = (m + torch.log(denom)).reshape(batch * heads, t_len, 1)
    return out.to(q.dtype), lse


def flash_backward_reference(q, k, v, lse, dout, delta, causal: bool):
    """Plain version of K2: p = exp(s - lse); dV = p^T dO with p in
    dO's type; dS = p (dO V^T - delta); dK = dS^T Q and dQ = dS K with
    dS in the operand's type, both times 1/sqrt(D)."""
    plain_calls["flash_bwd"] += 1
    batch, t_len, heads, depth = q.shape
    scale = 1.0 / math.sqrt(depth)
    rows = (batch, heads, t_len, 1)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        scores = torch.where(
            _causal_mask(t_len, t_len, 0, 0, q.device), scores, _NEG_INF)
    p = torch.exp(scores - lse.reshape(rows))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(),
                      dout.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), v.float())
    ds = p * (dp - delta.reshape(rows))
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------- flash: CUDA kernels -------------------------


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor) -> None:
    """Raise unless ``t`` matches ``like``'s device, dtype and shape and
    its rows can be read with 16-byte loads: last dim contiguous, other
    strides and the base 16-byte aligned."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected "
                         f"{like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} dtype {t.dtype} != {like.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} shape {tuple(t.shape)} != "
                         f"{tuple(like.shape)}")
    if not _rows_aligned(t):
        raise ValueError(f"{name} needs a contiguous last dim and "
                         f"16-byte aligned rows (strides {t.stride()})")


def _rows_aligned(t: torch.Tensor) -> bool:
    align = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and
            all(s % align == 0 for s in t.stride()[:-1]))


def _check_inputs(q, k, v) -> tuple[int, int, int, int]:
    if not q.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors; CPU tensors "
                         "go to the plain version")
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got {tuple(q.shape)}")
    batch, t_len, heads, depth = q.shape
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} not in {tuple(DTYPE_CODES)}")
    if depth not in SUPPORTED_DEPTHS:
        raise ValueError(f"head depth {depth} not in {SUPPORTED_DEPTHS}")
    if batch * heads > 65535:
        raise ValueError(f"B*H = {batch * heads} exceeds the grid limit")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, t, q)
    return batch, t_len, heads, depth


def _row_vector(name: str, t: torch.Tensor, q: torch.Tensor,
                rows: int, t_len: int) -> None:
    if (t.device != q.device or t.dtype != torch.float32 or
            tuple(t.shape) != (rows, t_len, 1) or not t.is_contiguous()):
        raise ValueError(f"{name} must be contiguous fp32 "
                         f"[{rows}, {t_len}, 1] on {q.device}")


def _strides(*tensors) -> ctypes.Array:
    values = [s for t in tensors for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(values))(*values)


def flash_forward_kernel(q, k, v, causal: bool, library=None):
    """K1 on the card: (out [B, T, H, D] contiguous, lse [B*H, T, 1]).
    ``library``: the loaded build of csrc/flash_attention.cu to launch
    from (default: the one ``_build`` makes from the checkout)."""
    batch, t_len, heads, depth = _check_inputs(q, k, v)
    dev = q.device
    lib = library or _build.library("flash_attention")
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = torch.empty((batch * heads, t_len, 1), dtype=torch.float32,
                      device=dev)
    rc = lib.bs_flash_attention_fwd(
        dev.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _strides(q, k, v), batch, heads,
        t_len, depth, DTYPE_CODES[q.dtype], int(causal),
        1.0 / math.sqrt(depth), stream_handle(dev))
    _build.check(rc, "flash attention forward", lib)
    launches["flash_fwd"] += 1
    return out, lse


def flash_backward_kernel(q, k, v, lse, dout, delta, causal: bool,
                          library=None):
    """K2 on the card: (dq, dk, dv), contiguous [B, T, H, D].
    ``library`` as for flash_forward_kernel."""
    batch, t_len, heads, depth = _check_inputs(q, k, v)
    _check_rows("dout", dout, q)
    _row_vector("lse", lse, q, batch * heads, t_len)
    _row_vector("delta", delta, q, batch * heads, t_len)
    dev = q.device
    lib = library or _build.library("flash_attention")
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dv = torch.empty(q.shape, dtype=q.dtype, device=dev)
    rc = lib.bs_flash_attention_bwd(
        dev.index or 0, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _strides(q, k, v, dout), batch,
        heads, t_len, depth, DTYPE_CODES[q.dtype], int(causal),
        1.0 / math.sqrt(depth), stream_handle(dev))
    _build.check(rc, "flash attention backward", lib)
    launches["flash_bwd"] += 1
    return dq, dk, dv


def flash_forward(q, k, v, causal: bool):
    if q.is_cuda:
        return flash_forward_kernel(q, k, v, causal)
    return flash_forward_reference(q, k, v, causal)


def flash_backward(q, k, v, lse, dout, delta, causal: bool):
    if q.is_cuda:
        return flash_backward_kernel(q, k, v, lse, dout, delta, causal)
    return flash_backward_reference(q, k, v, lse, dout, delta, causal)


def flash_delta(out, dout, g_lse=None):
    """delta = rowsum(dO * O) in fp32 as [B*H, T, 1], less the lse
    cotangent: d lse / d s_j = p_j, so g_lse enters dS exactly as a
    correction to delta."""
    batch, t_len, heads, _ = out.shape
    delta = (dout.float() * out.float()).sum(dim=-1)       # [B, T, H]
    delta = delta.transpose(1, 2).reshape(batch * heads, t_len, 1)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, with_lse: bool):
        if q.shape != k.shape or q.shape != v.shape:
            raise ValueError("flash attention takes q, k, v of one shape")
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.with_lse = with_lse
        if not with_lse:
            ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if not _rows_aligned(g):
            g = g.contiguous()
        delta = flash_delta(out, g, g_lse if ctx.with_lse else None)
        dq, dk, dv = flash_backward(q, k, v, lse, g, delta, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True):
    """Flash attention: K1 forward, K2 backward (plain versions on the
    CPU)."""
    return _FlashAttention.apply(q, k, v, causal, False)[0]


def flash_attention_with_lse(q, k, v, causal: bool = True):
    """flash_attention that also returns the logsumexp rows ([B*H, T, 1]
    fp32), differentiable: the ring-attention building block."""
    return _FlashAttention.apply(q, k, v, causal, True)


def flash_shapes_ok(t_q: int, t_kv: int, depth: int) -> bool:
    """Does K1/K2 take these shapes? Its tiles mask the ragged tail, so
    any length works; it needs q and kv of one length and a head depth in
    SUPPORTED_DEPTHS. (The reference's check, attention.py:43-51, encodes
    TPU blocks of 512/1024 that do not apply here.)"""
    return t_q == t_kv and t_q >= 1 and depth in SUPPORTED_DEPTHS


# ------------------ ring attention's merge of partials ------------------


def merge_attention_blocks(o1, lse1, o2, lse2):
    """Merge two normalized attention partials in logsumexp space.

    o_i: [B, T, H, D]; lse_i: [B*H, T, 1] fp32 with _NEG_INF marking rows
    that see no key. Returns (o, lse) of the attention over the union of
    the two key sets, o in o1's dtype."""
    batch, t_len, heads, _ = o1.shape
    l1 = lse1.reshape(batch, heads, t_len).transpose(1, 2)
    l2 = lse2.reshape(batch, heads, t_len).transpose(1, 2)
    m = torch.maximum(l1, l2)
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    w1 = torch.where(l1 > _NEG_INF / 2, torch.exp(l1 - m_safe), 0.0)
    w2 = torch.where(l2 > _NEG_INF / 2, torch.exp(l2 - m_safe), 0.0)
    denom = w1 + w2
    denom_safe = torch.where(denom == 0.0, 1.0, denom)
    o = (o1.float() * (w1 / denom_safe)[..., None] +
         o2.float() * (w2 / denom_safe)[..., None])
    lse = torch.where(denom > 0.0, m_safe + torch.log(denom_safe), _NEG_INF)
    lse = lse.transpose(1, 2).reshape(batch * heads, t_len, 1)
    return o.to(o1.dtype), lse


def masked_attention_block(q):
    """The identity of merge_attention_blocks: zero output, _NEG_INF
    logsumexp (no key visible)."""
    batch, t_len, heads, _ = q.shape
    return (torch.zeros_like(q),
            torch.full((batch * heads, t_len, 1), _NEG_INF,
                       dtype=torch.float32, device=q.device))


def attention(q, k, v, causal: bool = True, impl: Optional[str] = None,
              block_size: int = 512):
    """Dispatch: 'flash' (K1/K2), 'blockwise' or 'reference'. Default:
    flash for CUDA tensors, blockwise for CPU tensors. There is no
    fallback on CUDA: a shape the kernel does not take raises."""
    if impl is None:
        impl = "flash" if q.is_cuda else "blockwise"
    if impl == "flash":
        return flash_attention(q, k, v, causal)
    if impl == "blockwise":
        return blockwise_mha(q, k, v, causal, block_size=block_size)
    if impl == "reference":
        return mha_reference(q, k, v, causal)
    raise ValueError(f"unknown attention impl {impl!r}")
