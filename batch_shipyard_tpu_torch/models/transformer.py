"""Decoder-only transformer LM (PyTorch): the training forward and the
decode mode.

Counterpart of batch_shipyard_tpu/models/transformer.py: the same
``TransformerConfig`` field names, RoPE, RMSNorm with fp32 statistics,
SwiGLU MLP and tied logits.

Training (``decode=False``, no cache): attention goes through
``cfg.attention_fn`` or ``ops.attention.attention``, which launches the
flash kernels (K1 forward, K2 backward) for CUDA tensors and runs the
plain blockwise softmax for CPU tensors. ``remat`` recomputes each block
in the backward (``torch.utils.checkpoint``, the reference's
``nn.remat(Block)``); with sequence parallelism ``attention_fn`` is
ring attention over the ranks' shards, and ``positions`` carry each
shard's global offsets. With ``fused_norm`` each block feeds its raw
residual stream into ``ops.fused_norm.rmsnorm_matmul`` twice: one
[d, 3F] qkv projection and one [d, 2*d_ff] gate/up projection, whose
forward is the K9 kernel for CUDA tensors. ``lm_loss`` and
``lm_loss_chunked`` are the reference's losses; the latter's ``auto``
picks the fused cross-entropy kernels (K3-K5) on a card whose validation
marker records them. With ``quantize_matmuls`` every q/k/v/o and
gate/up/down projection is a ``QuantDense`` (training and decode), whose
int8 forward is the K10 quantize and K11 int8 matmul for CUDA tensors.

Decode: where flax keeps the cache in a mutable ``cache`` collection,
the port passes an explicit cache: a list with one dict of tensors per
layer (``inference.init_cache``), under the reference's leaf names. The
model updates those tensors IN PLACE on every call. In the paged cache,
every layer's dict holds the same ``block_table`` tensor, so the serving
engine writes one table for all layers. Single-token decode steps reach
the CUDA kernels: paged caches through ``ops.paged_attention`` (K6, K7
for int8 pages), the dense int8 cache through ``ops.decode_attention``
(K8). Multi-token inserts (prefill, and the speculative verify block,
dense or paged) are a plain masked softmax, as in the reference.

Tensor parallelism (``tp_group``, the reference's ``tp_axis``): a
RingGroup of tp ranks. Each rank builds its local n_heads / tp heads and
d_ff / tp ff units (the q/k/v/gate/up weights' rows and the o/down
weights' columns of parallel/sharding.py), and the block places
Megatron's operators where the reference does: ``tp_region_input``
("f": identity forward, all-reduce backward) where the replicated
activation enters the attention and the MLP, ``tp_region_output`` ("g":
all-reduce forward, identity backward) on their row-split outputs. The
all-reduce is ops/ring_collectives.ring_all_reduce (K14 then K13 on CUDA
tensors), bit-identical on every tp rank, so the replicated activations
and parameters stay identical across tp. Remat's recompute runs g's
forward again, so every tp rank makes the same ring calls. Under tp:

- the embedding is vocab-parallel (``Embed``): rank r holds rows [r V/tp,
  (r + 1) V/tp), looks up the tokens in its range, zeros the rest and
  sums over the ring (g), so the lookup is the one-card one bit for bit;
  the loss over those rows is ``lm_loss_chunked(tp_group=...)``;
- with ``fused_norm`` each rank's qkv_kernel / gate_up_kernel is its
  head-wise regrouped shard [q_r|k_r|v_r] / [gate_r|up_r]
  (parallel/sharding.take_shard); f sums the residual stream's gradient,
  and the norm scales' gradients are partial sums over the rank's
  columns, which parallel/train.py sums over the tp ring once a step;
- with ``quantize_matmuls`` the column-parallel projections
  (q/k/v/gate/up) quantize as on one card, and the row-parallel ones
  (o/down), whose rows of x and w span the ranks, take their absmax over
  the ring first (ops/quantization.quantized_linear's ``tp_group``).

Mixture of experts (``moe``, a models/moe.MoEConfig): every
``moe_every``-th block (``idx % moe_every == moe_every - 1``, the
reference's rule) holds a ``moe`` MoEMLP in place of its ``mlp``, over the
config's ``ep_group`` and ``token_ranks`` (the expert and token rings of
the mesh; models/moe.py). A training block returns ``(x, aux)``, aux being
its MoE layer's aux-loss share or None, so the aux comes out of the
function remat recomputes (a list appended inside the block would be
appended again by the recompute); ``forward(return_aux=True)`` returns
the sum over the layers beside the output. MoE layers stay unquantized
under ``quantize_matmuls`` (the reference's MoEMLP has no QuantDense) and
refuse ``fused_norm`` and decode.

Parameters live in ``param_dtype`` and are cast to ``dtype`` at use, as
flax's Dense/Embed do; ``TransformerLM.cast_dense_weights_`` makes that
cast once for serving.

Parameters held elsewhere (``forward(params=...)``): under fsdp the
module's own parameters carry only names and shapes (on ``meta``), and
parallel/train.py passes a function that gives a unit's parameters
(``embed``: the embedding and the final norm; ``layer_{i}``) by
state-dict name, gathered over the fsdp ring. The model runs each part
on them through ``torch.func.functional_call``; a layer's are asked for
inside the function that remat recomputes, so the recompute gathers them
again and no gathered layer is saved for the backward.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from batch_shipyard_tpu_torch.models import moe as moe_mod
from batch_shipyard_tpu_torch.ops import attention as attn_ops
from batch_shipyard_tpu_torch.ops import chunked_loss
from batch_shipyard_tpu_torch.ops import decode_attention as dense_ops
from batch_shipyard_tpu_torch.ops import fused_norm as fn_ops
from batch_shipyard_tpu_torch.ops import paged_attention as paged_ops
# Megatron's f and g (the reference's tp_region_input / tp_region_output).
from batch_shipyard_tpu_torch.ops.ring_collectives import (tp_region_input,
                                                           tp_region_output)
from batch_shipyard_tpu_torch.ops.quantization import (dequantize_int8,
                                                        quantize_int8_rows,
                                                        quantized_linear)


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's field names for what the training forward and the
    decode path read (``tp_group`` in place of ``tp_axis``; ``ep_group``
    and ``token_ranks`` for the mesh axes the reference's GSPMD
    implies)."""
    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    d_head: int = 64
    d_ff: int = 1408
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    # Recompute each block in the backward instead of saving its
    # activations (the reference's nn.remat(Block)).
    remat: bool = False
    # (q, k, v, causal) -> out over [B, T, H, D]; None =
    # ops.attention.attention (flash kernels on CUDA tensors).
    attention_fn: Optional[Callable] = None
    rope_theta: float = 10000.0
    # Fuse each block's two RMSNorms into its first projections
    # (ops/fused_norm.rmsnorm_matmul); training only.
    fused_norm: bool = False
    # rmsnorm_matmul's impl: None (K9 for CUDA tensors), "kernel" or
    # "plain".
    fused_norm_impl: Optional[str] = None
    # Every q/k/v/o and gate/up/down projection through QuantDense: int8
    # operands quantized on the fly (ops/quantization.quantized_linear,
    # K10 and K11 on CUDA tensors), full-precision backward. Not with
    # fused_norm, as in the reference.
    quantize_matmuls: bool = False
    # quantized_linear's impl: None (K10/K11 for CUDA tensors), "kernel"
    # or "plain".
    quantize_impl: Optional[str] = None
    decode: bool = False
    max_decode_len: int = 2048
    # None (dtype rows) or "int8" (absmax rows + fp32 scales per
    # (position, head)), for the dense cache and the page pool alike.
    kv_cache_dtype: Optional[str] = None
    # Paged KV cache: page size and pool pages; None = dense cache.
    kv_page_size: Optional[int] = None
    kv_num_pages: int = 0
    # Speculative-decode write margin (the serving engine sets it to
    # gamma): a multi-token insert of up to spec_window + 1 tokens may
    # start at max_decode_len - 2. The paged block table gets
    # ceil((max_decode_len + spec_window) / page) entries, so the tail
    # writes of a verify block reach table entries that point at the
    # scratch page instead of clamping onto a real page; the dense cache
    # gets spec_window extra rows, masked to every query inside
    # max_decode_len, which take those writes where the reference drops
    # them, so the insert keeps one shape (a captured graph holds it).
    spec_window: int = 0
    # "kernel" | "reference" | None (kernel for CUDA tensors, plain
    # version for CPU tensors): ops/paged_attention, ops/decode_attention.
    paged_attention_impl: Optional[str] = None
    decode_attention_impl: Optional[str] = None
    # Megatron tensor parallelism over this RingGroup (parallel/mesh):
    # local heads and ff units, f and g around attention and the MLP.
    # None: the whole model on this rank. Training only.
    tp_group: Optional[object] = None
    # Mixture of experts: a models/moe.MoEConfig in place of the MLP of
    # every moe_every-th block; the loss adds moe_aux_weight * the aux.
    moe: Optional[moe_mod.MoEConfig] = None
    moe_every: int = 2
    moe_aux_weight: float = 0.01
    # The experts split over this RingGroup (Megatron's pair around the
    # expert region), and the ranks of the global batch's other tokens
    # (models/moe.TokenRanks: one routing over the global batch). None:
    # all experts here, these tokens the whole batch.
    ep_group: Optional[object] = None
    token_ranks: Optional[moe_mod.TokenRanks] = None

    @property
    def tp(self) -> int:
        return 1 if self.tp_group is None else self.tp_group.size


def _tp_local(cfg: TransformerConfig, what: str, count: int) -> int:
    """``count`` (heads, ff units or vocabulary rows) over the tp
    ranks."""
    if count % cfg.tp:
        raise ValueError(f"{what}={count} is not divisible by tp={cfg.tp}")
    return count // cfg.tp


def rotary_embedding(x, positions, theta: float):
    """Apply RoPE in fp32, then cast back. x: [B, T, H, D]; positions:
    [T] shared across the batch, or [B, T] per sequence."""
    depth = x.shape[-1]
    # log(theta) in fp32 on the host, then a scalar: no host-to-device
    # copy, which a captured decode graph could not hold.
    log_theta = float(torch.log(torch.tensor(theta, dtype=torch.float32)))
    freqs = torch.exp(
        -log_theta *
        torch.arange(0, depth, 2, dtype=torch.float32,
                     device=x.device) / depth)
    angles = positions[..., None].float() * freqs
    if positions.dim() == 1:
        cos = torch.cos(angles)[None, :, None, :]   # [1, T, 1, D/2]
        sin = torch.sin(angles)[None, :, None, :]
    else:
        cos = torch.cos(angles)[:, :, None, :]      # [B, T, 1, D/2]
        sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                        dim=-1)
    return rotated.to(x.dtype)


class RMSNorm(nn.Module):
    """fp32 statistics, eps 1e-6; the scale multiplies in fp32 before
    the cast to ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 eps: float = 1e-6, device=None) -> None:
        super().__init__()
        self.scale = nn.Parameter(
            torch.ones(features, dtype=torch.float32, device=device))
        self.dtype = dtype
        self.eps = eps

    def forward(self, x):
        norm = x.float()
        norm = norm * torch.rsqrt(
            (norm * norm).mean(dim=-1, keepdim=True) + self.eps)
        return (norm * self.scale).to(self.dtype)


class Dense(nn.Linear):
    """Bias-free linear layer computing in ``dtype`` (flax nn.Dense
    with dtype/param_dtype): input and weight cast, then one matmul."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: TransformerConfig, device=None) -> None:
        super().__init__(in_features, out_features, bias=False,
                         device=device, dtype=cfg.param_dtype)
        self.compute_dtype = cfg.dtype

    def forward(self, x):
        return F.linear(x.to(self.compute_dtype),
                        self.weight.to(self.compute_dtype))


class QuantDense(Dense):
    """The reference's QuantDense: the same ``weight [out, in]`` as
    Dense, the product through ``ops.quantization.quantized_linear``.
    x is not cast (the reference quantizes it as it comes); the weight is
    cast to ``dtype`` before it is quantized, and the fp32 output is cast
    to ``dtype``. ``split``: which side tp splits, "column" (the output
    features) or "row" (the input features); it matters under tp only."""

    def __init__(self, in_features: int, out_features: int,
                 cfg: TransformerConfig, device=None,
                 split: Optional[str] = None) -> None:
        super().__init__(in_features, out_features, cfg, device)
        self.impl = cfg.quantize_impl
        self.tp_group = cfg.tp_group if cfg.tp > 1 else None
        self.split = split

    def forward(self, x):
        out = quantized_linear(
            x.reshape(-1, x.shape[-1]), self.weight.to(self.compute_dtype),
            impl=self.impl, tp_group=self.tp_group, split=self.split)
        return out.reshape(*x.shape[:-1], -1).to(self.compute_dtype)


def _dense(cfg: TransformerConfig, split: str):
    """The projection class (the reference's functools_partial_dense); a
    QuantDense is told which side tp splits (QuantDense's ``split``)."""
    if cfg.quantize_matmuls:
        return functools.partial(QuantDense, split=split)
    return Dense


class Embed(nn.Module):
    """Token embedding shared with the tied output projection. Under tp
    it is vocab-parallel: this rank holds rows [r V/tp, (r + 1) V/tp) of
    the table (the module doc)."""

    def __init__(self, cfg: TransformerConfig, device=None) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(
            _tp_local(cfg, "vocab_size", cfg.vocab_size), cfg.d_model,
            dtype=cfg.param_dtype, device=device))
        self.dtype = cfg.dtype
        self.tp_group = cfg.tp_group if cfg.tp > 1 else None

    def forward(self, tokens):
        tokens = tokens.long()
        if self.tp_group is None:
            return F.embedding(tokens, self.embedding).to(self.dtype)
        rows = self.embedding.shape[0]
        local = tokens - self.tp_group.rank * rows
        mine = (local >= 0) & (local < rows)
        x = F.embedding(local.clamp(0, rows - 1), self.embedding)
        x = torch.where(mine[..., None], x, 0.0).to(self.dtype)
        return tp_region_output(x, self.tp_group)

    def attend(self, query):
        """Logits in ``dtype`` (flax Embed.attend promotes both
        operands to the module dtype). One rank's whole vocabulary only:
        under tp the loss takes the hidden states (lm_loss_chunked)."""
        if self.tp_group is not None:
            raise NotImplementedError(
                "logits of a vocab-parallel embedding: train through "
                "lm_loss_chunked(tp_group=...) on the hidden states")
        return F.linear(query.to(self.dtype),
                        self.embedding.to(self.dtype))


# Standard deviation of a unit normal truncated to [-2, 2]: flax's
# truncated lecun_normal divides by it so the drawn variance is 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight, fan_in: int, generator: torch.Generator):
    """flax's lecun_normal in place: a normal truncated to two standard
    deviations, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return nn.init.trunc_normal_(weight, std=std, a=-2.0 * std,
                                 b=2.0 * std, generator=generator)


def expert_fan_in(shape) -> int:
    """flax's lecun_normal fan-in of an expert weight [E, in, out]: the
    in dim times the leading (receptive-field) dims, E."""
    return shape[0] * shape[1]


def embedding_normal_(weight, generator: torch.Generator):
    """flax's Embed init in place: normal, variance 1/d_model."""
    return weight.normal_(0.0, math.sqrt(1.0 / weight.shape[1]),
                          generator=generator)


def _norm_scale(cfg: TransformerConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.ones(cfg.d_model, dtype=torch.float32,
                                   device=device))


def _fused_kernel(cfg: TransformerConfig, width: int,
                  device) -> nn.Parameter:
    """A fused projection's weight in the reference's [in, out] layout."""
    return nn.Parameter(torch.empty(cfg.d_model, width,
                                    dtype=cfg.param_dtype, device=device))


def _fused_projection(cfg: TransformerConfig, x, scale, kernel):
    """rmsnorm(x) * scale @ kernel over [B, T, d] -> [B, T, width], the
    weight cast to ``dtype`` at each call."""
    batch, seq = x.shape[0], x.shape[1]
    out = fn_ops.rmsnorm_matmul(x.reshape(batch * seq, -1), scale,
                                kernel.to(cfg.dtype),
                                impl=cfg.fused_norm_impl)
    return out.reshape(batch, seq, -1)


class Attention(nn.Module):
    """With ``fused_norm``: ``norm_scale [d]`` and ``qkv_kernel [d, 3F]``
    take the place of the block's attn_norm and q/k/v projections."""

    def __init__(self, cfg: TransformerConfig, device=None) -> None:
        super().__init__()
        self.config = cfg
        self.n_heads = _tp_local(cfg, "n_heads", cfg.n_heads)
        features = self.n_heads * cfg.d_head
        dense = _dense(cfg, "column")
        if cfg.fused_norm:
            self.norm_scale = _norm_scale(cfg, device)
            self.qkv_kernel = _fused_kernel(cfg, 3 * features, device)
        else:
            self.q_proj = dense(cfg.d_model, features, cfg, device)
            self.k_proj = dense(cfg.d_model, features, cfg, device)
            self.v_proj = dense(cfg.d_model, features, cfg, device)
        self.o_proj = _dense(cfg, "row")(features, cfg.d_model, cfg, device)

    def forward(self, x, positions, cache: Optional[dict] = None):
        """cache None: the training forward (causal attention over the
        whole sequence); else a decode step against the cache."""
        cfg = self.config
        batch, seq = x.shape[0], x.shape[1]
        shape = (batch, seq, self.n_heads, cfg.d_head)
        x = tp_region_input(x, cfg.tp_group)
        if cfg.fused_norm:
            # x is the raw residual stream; v stays a strided view of
            # the [q | k | v] output, which K1 reads through its strides.
            q, k, v = _fused_projection(cfg, x, self.norm_scale,
                                        self.qkv_kernel).chunk(3, dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = rotary_embedding(q.reshape(shape), positions, cfg.rope_theta)
        k = rotary_embedding(k.reshape(shape), positions, cfg.rope_theta)
        v = v.reshape(shape)
        if cache is None:
            attention_fn = cfg.attention_fn or attn_ops.attention
            out = attention_fn(q, k, v, causal=True)
        else:
            attend = (self._decode_attend_paged if cfg.kv_page_size
                      else self._decode_attend)
            out = attend(q, k, v, cache)
        return tp_region_output(self.o_proj(out.reshape(batch, seq, -1)),
                                cfg.tp_group)

    def _decode_attend(self, q, k, v, cache: dict):
        """Dense cache [B, L, H, D] with a per-slot write index [B]
        (L = max_decode_len + spec_window rows). seq == 1 is the decode
        step; seq > 1 is the batched prefill / chunked insert, or the
        speculative verify block, which attends causally over absolute
        cache positions (query s at idx+s sees keys <= idx+s)."""
        cfg = self.config
        int8_kv = cfg.kv_cache_dtype == "int8"
        batch, seq = q.shape[0], q.shape[1]
        length = cache["k"].shape[1]
        idx = cache["index"].clone()
        rows = torch.arange(batch, device=q.device)
        key_pos = torch.arange(length, device=q.device)
        k_in, v_in = k, v
        if int8_kv:
            k_in, ks = quantize_int8_rows(k)
            v_in, vs = quantize_int8_rows(v)
        if seq == 1:
            # Freed slots keep stepping past the cache end; their
            # writes clamp onto their own last row, which the next
            # admission's prefill rewrites (the reference drops them).
            dst = (rows, idx.clamp(max=length - 1).long())

            def take(t):
                return t[:, 0]
            mask = (key_pos[None, :] <= idx[:, None])[:, None, None, :]
        else:
            cols = idx[:, None].long() + torch.arange(
                seq, device=q.device)[None, :]             # [B, S]
            mask = (key_pos[None, None, :] <=
                    cols[:, :, None])[:, None, :, :]       # [B,1,S,T]
            if cfg.spec_window:
                # One shape, no host read: a live slot's verify block
                # (from at most max_decode_len - 2) ends inside the
                # spec_window rows, so only freed slots, whose rows are
                # all garbage, run past the end; they clamp onto their
                # own last row.
                dst = (rows[:, None].expand_as(cols),
                       cols.clamp(max=length - 1))

                def take(t):
                    return t
            else:
                dst = None
        if dst is not None:
            cache["k"][dst] = take(k_in).to(cache["k"].dtype)
            cache["v"][dst] = take(v_in).to(cache["v"].dtype)
            if int8_kv:
                cache["k_scale"][dst] = take(ks)
                cache["v_scale"][dst] = take(vs)
        else:
            # Inserts running past the cache end drop those rows (the
            # reference's out-of-bounds scatter), in one shape and with
            # no host read (a captured prefill replays this): cache row
            # j takes block token j - idx where that is a token of the
            # block and keeps its value elsewhere, so a token past the
            # end has no row to land in.
            src = key_pos[None, :] - idx[:, None].long()       # [B, T]
            inside = (src >= 0) & (src < seq)
            src = src.clamp(0, seq - 1)
            pairs = [("k", k_in), ("v", v_in)]
            if int8_kv:
                pairs += [("k_scale", ks), ("v_scale", vs)]
            for name, new in pairs:
                tail = (1,) * (new.dim() - 2)
                picked = new.gather(1, src.view(batch, length, *tail).expand(
                    batch, length, *new.shape[2:]))
                cache[name].copy_(torch.where(
                    inside.view(batch, length, *tail),
                    picked.to(cache[name].dtype), cache[name]))
        cache["index"].add_(seq)
        if int8_kv and seq == 1:
            lengths = (idx + 1).clamp(max=length)
            return dense_ops.dense_decode_attention(
                q, cache["k"], cache["v"], cache["k_scale"],
                cache["v_scale"], lengths,
                impl=cfg.decode_attention_impl).to(cfg.dtype)
        if int8_kv:
            k_all = dequantize_int8(
                cache["k"], cache["k_scale"][..., None]).to(cfg.dtype)
            v_all = dequantize_int8(
                cache["v"], cache["v_scale"][..., None]).to(cfg.dtype)
        else:
            k_all, v_all = cache["k"], cache["v"]
        return paged_ops.masked_attention(q, k_all, v_all, mask)

    def _decode_attend_paged(self, q, k, v, cache: dict):
        """Paged cache: K/V in a shared pool [P, page, H, D]; each slot
        writes its tokens at length + s through its block-table row.
        seq == 1 attends over the slot's live pages (K6/K7). seq > 1 is
        the speculative verify block ([y, d_1..d_gamma] at consecutive
        positions): table entries past the slot's allocation point at
        the engine's scratch page, which takes the never-committed tail
        writes (spec_window guarantees a live slot's block stays inside
        the table), then the slot's whole logical view is gathered (int8
        pages dequantized with their scales) and attended causally over
        absolute positions, the reference's XLA path."""
        cfg = self.config
        int8_kv = cfg.kv_cache_dtype == "int8"
        batch, seq, heads, depth = q.shape
        if seq > cfg.spec_window + 1:
            raise ValueError(
                f"paged decode insert of {seq} tokens needs "
                f"spec_window >= {seq - 1} (got {cfg.spec_window}) "
                f"so tail writes spill onto scratch-backed table "
                f"entries instead of live pages")
        page = cfg.kv_page_size
        table = cache["block_table"]
        max_blocks = table.shape[1]
        idx = cache["length"].clone()
        cols = idx[:, None].long() + torch.arange(
            seq, device=q.device)[None, :]                 # [B, S]
        # Freed slots step past their table; clamping keeps their
        # writes on the scratch page their rows point at.
        block = (cols // page).clamp(max=max_blocks - 1)
        page_idx = table.gather(1, block).long()
        offset = cols % page
        k_in, v_in = k, v
        if int8_kv:
            k_in, ks = quantize_int8_rows(k_in)
            v_in, vs = quantize_int8_rows(v_in)
            cache["k_page_scales"][page_idx, offset] = ks
            cache["v_page_scales"][page_idx, offset] = vs
        cache["k_pages"][page_idx, offset] = k_in.to(
            cache["k_pages"].dtype)
        cache["v_pages"][page_idx, offset] = v_in.to(
            cache["v_pages"].dtype)
        cache["length"].add_(seq)
        if seq == 1:
            return paged_ops.paged_decode_attention(
                q, cache["k_pages"], cache["v_pages"], table,
                cache["length"], impl=cfg.paged_attention_impl,
                k_scales=cache["k_page_scales"] if int8_kv else None,
                v_scales=cache["v_page_scales"] if int8_kv else None).to(
                    cfg.dtype)
        # Every key a COMMITTED query sees is prior committed state or
        # written by this block; scratch-page garbage only reaches draft
        # positions whose logits are discarded.
        ids = table.long()
        rows = max_blocks * page
        k_all = cache["k_pages"][ids].reshape(batch, rows, heads, depth)
        v_all = cache["v_pages"][ids].reshape(batch, rows, heads, depth)
        if int8_kv:
            ks_all = cache["k_page_scales"][ids].reshape(batch, rows, heads)
            vs_all = cache["v_page_scales"][ids].reshape(batch, rows, heads)
            k_all = (k_all.float() * ks_all[..., None]).to(cfg.dtype)
            v_all = (v_all.float() * vs_all[..., None]).to(cfg.dtype)
        key_pos = torch.arange(rows, device=q.device)
        mask = (key_pos[None, None, :] <=
                cols[:, :, None])[:, None, :, :]           # [B,1,S,T]
        return paged_ops.masked_attention(q, k_all, v_all, mask)


def prefix_rows_from_pages(layer_cache: dict, page_ids,
                           page: int) -> dict:
    """Gather a shared-prefix page chain out of ONE layer's paged pool
    into dense-cache row layout (the engine's shared-prefix prefill).
    page_ids: [n] page indices (entries past the true prefix may point
    at the scratch page; their rows are masked-on-read). Returns
    {"k": [n*page, H, D], "v": ..., ("k_scale": [n*page, H],
    "v_scale": ...)} in the pool's storage dtype."""
    ids = torch.as_tensor(page_ids, device=layer_cache["k_pages"].device
                          ).long()
    k = layer_cache["k_pages"][ids]                  # [n, page, H, D]
    rows = k.shape[0] * page
    out = {"k": k.reshape(rows, *k.shape[2:]),
           "v": layer_cache["v_pages"][ids].reshape(rows, *k.shape[2:])}
    if "k_page_scales" in layer_cache:
        ks = layer_cache["k_page_scales"][ids]
        out["k_scale"] = ks.reshape(rows, ks.shape[-1])
        out["v_scale"] = layer_cache["v_page_scales"][ids].reshape(
            rows, ks.shape[-1])
    return out


class MLP(nn.Module):
    """SwiGLU: down(silu(gate(x)) * up(x)). With ``fused_norm``:
    ``norm_scale [d]`` and ``gate_up_kernel [d, 2*d_ff]`` take the place
    of the block's mlp_norm and gate/up projections."""

    def __init__(self, cfg: TransformerConfig, device=None) -> None:
        super().__init__()
        self.config = cfg
        dense = _dense(cfg, "column")
        d_ff = _tp_local(cfg, "d_ff", cfg.d_ff)
        if cfg.fused_norm:
            self.norm_scale = _norm_scale(cfg, device)
            self.gate_up_kernel = _fused_kernel(cfg, 2 * d_ff, device)
        else:
            self.gate_proj = dense(cfg.d_model, d_ff, cfg, device)
            self.up_proj = dense(cfg.d_model, d_ff, cfg, device)
        self.down_proj = _dense(cfg, "row")(d_ff, cfg.d_model, cfg, device)

    def forward(self, x):
        cfg = self.config
        x = tp_region_input(x, cfg.tp_group)
        if cfg.fused_norm:
            gate, up = _fused_projection(cfg, x, self.norm_scale,
                                         self.gate_up_kernel).chunk(2, dim=-1)
        else:
            gate, up = self.gate_proj(x), self.up_proj(x)
        return tp_region_output(self.down_proj(F.silu(gate) * up),
                                cfg.tp_group)


def uses_moe(cfg: TransformerConfig, idx: int) -> bool:
    """Whether block ``idx`` holds a MoE layer (the reference's rule)."""
    every = max(cfg.moe_every, 1)
    return cfg.moe is not None and idx % every == every - 1


class Block(nn.Module):
    def __init__(self, cfg: TransformerConfig, device=None,
                 use_moe: bool = False) -> None:
        super().__init__()
        if cfg.fused_norm and (cfg.decode or cfg.quantize_matmuls or
                               use_moe):
            raise NotImplementedError(
                "fused_norm composes only with the dense training path "
                "(no decode / quantize_matmuls / moe), as in the reference")
        if use_moe and cfg.decode:
            raise NotImplementedError(
                "moe is a training-path feature: the decode path has no "
                "routing over a cache")
        if cfg.tp > 1 and cfg.decode:
            raise NotImplementedError(
                "tp_group is a training-path feature; the decode path "
                "would return un-reduced o_proj partial sums")
        self.fused_norm = cfg.fused_norm
        if not cfg.fused_norm:
            self.attn_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
            self.mlp_norm = RMSNorm(cfg.d_model, cfg.dtype, device=device)
        self.attn = Attention(cfg, device)
        if use_moe:
            self.moe = moe_mod.MoEMLP(cfg.moe, cfg.ep_group, cfg.tp_group,
                                      cfg.token_ranks, device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x, positions, cache: Optional[dict] = None):
        """-> (x, the MoE layer's aux share, or None for a dense block)."""
        if self.fused_norm:
            # The norms live inside Attention and MLP: pass the raw
            # residual stream.
            x = x + self.attn(x, positions, cache)
            return x + self.mlp(x), None
        x = x + self.attn(self.attn_norm(x), positions, cache)
        normed = self.mlp_norm(x)
        if hasattr(self, "moe"):
            out, aux = self.moe(normed)
            return x + out, aux
        return x + self.mlp(normed), None


class TransformerLM(nn.Module):
    """State-dict names follow the flax tree: ``embed.embedding``,
    ``layer_{i}.attn.{q,k,v,o}_proj.weight``,
    ``layer_{i}.mlp.{gate,up,down}_proj.weight``,
    ``layer_{i}.{attn,mlp}_norm.scale``, ``final_norm.scale``; with
    ``fused_norm``, ``layer_{i}.attn.{norm_scale,qkv_kernel}`` and
    ``layer_{i}.mlp.{norm_scale,gate_up_kernel}`` in place of the norms
    and the q/k/v and gate/up projections (models/convert.py maps the
    flax tree onto them); a MoE block holds ``layer_{i}.moe.router.weight``
    and ``layer_{i}.moe.{w_gate,w_up,w_down}`` in place of its ``mlp``."""

    def __init__(self, config: TransformerConfig, device=None,
                 generator: Optional[torch.Generator] = None) -> None:
        """``generator`` draws the embedding and the fused kernels (flax's
        spread, as convert.init_params); without one, a generator on the
        model's device seeded from the global one. On ``device="meta"``
        nothing is drawn or allocated."""
        super().__init__()
        if config.kv_cache_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_cache_dtype={config.kv_cache_dtype!r}: only "
                f"'int8' (or None) is supported")
        self.config = config
        self.embed = Embed(config, device)
        for i in range(config.n_layers):
            self.add_module(f"layer_{i}", Block(config, device,
                                                uses_moe(config, i)))
        self.final_norm = RMSNorm(config.d_model, config.dtype,
                                  device=device)
        if self.embed.embedding.device.type != "meta":
            self._draw_empty_weights(generator)

    @torch.no_grad()
    def _draw_empty_weights(self, generator) -> None:
        """Fill the weights made with torch.empty (Dense layers draw
        their own in nn.Linear's constructor)."""
        device = self.embed.embedding.device
        if generator is None:
            seed = int(torch.randint(0, 2 ** 62, ()))
            generator = torch.Generator(device=device).manual_seed(seed)
        embedding_normal_(self.embed.embedding, generator)
        if self.config.fused_norm:
            for block in self.blocks():
                for kernel in (block.attn.qkv_kernel,
                               block.mlp.gate_up_kernel):
                    lecun_normal_(kernel, self.config.d_model, generator)
        for block in self.blocks():
            if hasattr(block, "moe"):
                for weight in (block.moe.w_gate, block.moe.w_up,
                               block.moe.w_down):
                    lecun_normal_(weight, expert_fan_in(weight.shape),
                                  generator)

    def blocks(self) -> list[Block]:
        return [getattr(self, f"layer_{i}")
                for i in range(self.config.n_layers)]

    def cast_dense_weights_(self) -> "TransformerLM":
        """Cast every Dense weight to the compute dtype in place, once.
        Dense.forward casts to that dtype on every call, so outputs are
        unchanged; the embedding stays in param_dtype because prefill
        reads it in fp32."""
        for module in self.modules():
            if isinstance(module, Dense):
                module.weight.data = module.weight.data.to(
                    module.compute_dtype)
        return self

    def forward(self, tokens, positions=None, cache=None,
                return_hidden: bool = False, params=None,
                return_aux: bool = False):
        """tokens [B, T] int -> logits [B, T, vocab] in ``dtype`` (or the
        final hidden states [B, T, d_model] with return_hidden).
        positions: [T] or [B, T] absolute positions (default 0..T-1).
        Without a cache (and ``decode=False``) this is the training
        forward: causal attention over the whole sequence. In decode
        mode, cache is inference.init_cache's per-layer list, updated
        in place. ``params``: a unit name (``embed``, ``layer_{i}``) ->
        that unit's parameters by state-dict name, in place of the
        module's own (the training forward; the module doc).
        ``return_aux``: return (output, the sum of the MoE layers' aux
        shares, None without MoE layers)."""
        cfg = self.config
        if cfg.decode and cache is None:
            raise ValueError("decode mode needs a cache "
                             "(inference.init_cache)")
        if cache is not None and not cfg.decode:
            raise ValueError("a cache needs decode=True "
                             "(inference.decode_config)")
        if params is not None:
            if cache is not None:
                raise ValueError("params= is for the training forward")
            head = params("embed")
            x = _call(self.embed, "embed.", head, tokens)
        else:
            x = self.embed(tokens)
        if positions is None:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        aux_total = None
        if cache is None:
            remat = cfg.remat and torch.is_grad_enabled()
            for i, block in enumerate(self.blocks()):
                run = block if params is None else functools.partial(
                    _gathered_block, block, f"layer_{i}", params)
                if remat:
                    # Early stop off: the recompute runs the whole block,
                    # so a ring attention_fn rotates as often on every
                    # rank (ops/ring_attention.py), whichever saved
                    # tensors that rank needs, and the block's parameters
                    # are gathered again.
                    with set_checkpoint_early_stop(False):
                        x, aux = checkpoint(run, x, positions,
                                            use_reentrant=False)
                else:
                    x, aux = run(x, positions)
                if aux is not None:
                    aux_total = aux if aux_total is None else aux_total + aux
        else:
            for block, layer_cache in zip(self.blocks(), cache):
                x, _ = block(x, positions, layer_cache)
        x = (self.final_norm(x) if params is None else
             _call(self.final_norm, "final_norm.", head, x))
        out = x if return_hidden else self.embed.attend(x.float())
        return (out, aux_total) if return_aux else out


def _call(module: nn.Module, prefix: str, params, *args):
    """``module(*args)`` on ``params`` (tensors by state-dict name) where
    the names under ``prefix`` replace the module's parameters."""
    own = {name[len(prefix):]: t for name, t in params.items()
           if name.startswith(prefix)}
    return torch.func.functional_call(module, own, args, strict=True)


def _gathered_block(block: Block, unit: str, params, x, positions):
    """One block on its unit's parameters, asked of ``params`` here (so
    inside remat's recompute as well)."""
    return _call(block, unit + ".", params(unit), x, positions)


def lm_loss(logits, targets, ignore_id: int = -1):
    """Causal LM cross-entropy in logits' dtype, averaged over targets
    that are not ``ignore_id`` (shifting targets is the caller's job)."""
    mask = targets != ignore_id
    logprobs = torch.log_softmax(logits, dim=-1)
    safe = torch.where(mask, targets, 0).long()
    nll = -logprobs.gather(-1, safe[..., None])[..., 0]
    return (nll * mask).sum() / mask.sum().clamp(min=1)


def lm_loss_chunked(hidden, embedding, targets, ignore_id: int = -1,
                    chunk_size: int = 128, impl: str = "auto",
                    tp_group=None):
    """Tied-embedding cross-entropy without the full [B, T, vocab] fp32
    logits (ops.chunked_loss; impl 'auto' | 'kernel' | 'plain'). As in
    the reference, ``chunk_size`` counts time steps per batch row, so one
    plain slab holds chunk_size * B rows. ``tp_group``: the vocab-parallel
    loss over this rank's rows of the embedding (a tp RingGroup)."""
    rows = chunk_size * (hidden.shape[0] if hidden.dim() == 3 else 1)
    return chunked_loss.chunked_softmax_xent(
        hidden, embedding, targets, ignore_id=ignore_id, impl=impl,
        chunk_size=rows, tp_group=tp_group)
