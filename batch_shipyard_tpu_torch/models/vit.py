"""Vision Transformer (ViT) image classification in PyTorch.

Counterpart of batch_shipyard_tpu/models/vit.py, with its names
(``patch_embed``, ``layer_{i}.attn_norm`` / ``q_proj`` ... ``down_proj``,
``final_norm``, ``head``) so that models/convert.py carries flax trees
across:

- patch embedding as one reshape + Dense; fixed 2D sin-cos positions;
- pre-LN encoder blocks: ``LayerNorm`` with fp32 statistics and eps 1e-6,
  q/k/v/o projections with bias, a GELU MLP (flax's ``nn.gelu`` is the
  tanh approximation, so ``approximate="tanh"``);
- no CLS token: the head is a mean pool over the patches, in fp32;
- bf16 activations (``dtype``) over fp32 parameters.

Attention is ops/attention.attention(q, k, v, causal=False): on CUDA
tensors the flash kernels K1 (forward) and K2 (backward) in full mode at
every patch count (196 at 224/16 and 256 at 256/16 alike; the kernels
mask the ragged kv tile), on CPU tensors the plain blockwise softmax,
whose one block at these lengths is the reference's choice for 196.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from batch_shipyard_tpu_torch.models.resnet import (  # noqa: F401
    cross_entropy_loss)
from batch_shipyard_tpu_torch.models.transformer import (
    embedding_normal_, lecun_normal_)
from batch_shipyard_tpu_torch.ops import attention as attn_ops

LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def num_patches(self) -> int:
        side = self.image_size // self.patch_size
        return side * side


def sincos_2d_positions(side: int, dim: int) -> np.ndarray:
    """Fixed 2D sin-cos position table [side*side, dim] (half the
    channels encode the row coordinate, half the column)."""
    assert dim % 4 == 0, "sincos embedding needs dim % 4 == 0"
    quarter = dim // 4
    omega = 1.0 / (10000.0 ** (np.arange(quarter) / quarter))
    coords = np.arange(side, dtype=np.float64)
    args = np.outer(coords, omega)                     # [side, dim/4]
    table_1d = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    rows = np.repeat(table_1d, side, axis=0)           # row-major grid
    cols = np.tile(table_1d, (side, 1))
    return np.concatenate([rows, cols], axis=1)        # [N, dim]


def patchify(images: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C], row-major patches."""
    batch, height, width, chans = images.shape
    side = height // patch
    return images.reshape(batch, side, patch, side, patch, chans).permute(
        0, 1, 3, 2, 4, 5).reshape(batch, side * side, patch * patch * chans)


def unpatchify(patches: torch.Tensor, patch: int, chans: int
               ) -> torch.Tensor:
    """The inverse of patchify for a square image."""
    batch, n = patches.shape[:2]
    side = math.isqrt(n)
    return patches.reshape(batch, side, side, patch, patch, chans).permute(
        0, 1, 3, 2, 4, 5).reshape(batch, side * patch, side * patch, chans)


class Dense(nn.Module):
    """flax Dense: ``weight [out, in]`` (flax's kernel transposed) and
    ``bias`` in ``param_dtype``, lecun-normal / zero (``zero_init``: both
    zero, adaLN-Zero's), computed in ``dtype`` (inputs and weights cast
    to it)."""

    def __init__(self, features_in: int, features: int, dtype: torch.dtype,
                 param_dtype: torch.dtype = torch.float32,
                 zero_init: bool = False, device=None) -> None:
        super().__init__()
        self.dtype, self.zero_init = dtype, zero_init
        self.weight = nn.Parameter(torch.empty(features, features_in,
                                               dtype=param_dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(features, dtype=param_dtype,
                                             device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            if self.zero_init:
                self.weight.zero_()
            else:
                lecun_normal_(self.weight, self.weight.shape[1], generator)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


class Embed(nn.Module):
    """flax Embed: ``embedding [num, features]``, normal with variance
    1/features."""

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 device=None) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num, features, dtype=dtype,
                                                  device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            embedding_normal_(self.embedding, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()]


class LayerNorm(nn.Module):
    """LayerNorm with fp32 statistics regardless of activation dtype, eps
    1e-6; fp32 ``scale`` and ``bias``; the output in ``dtype``."""

    def __init__(self, dim: int, dtype: torch.dtype, device=None) -> None:
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        normed = (x32 - mean) * torch.rsqrt(var + LN_EPS)
        return (normed * self.scale + self.bias).to(self.dtype)


def self_attention(block: nn.Module, h: torch.Tensor,
                   n_heads: int) -> torch.Tensor:
    """The block's q/k/v projections of h [B, T, d], non-causal attention
    (K1/K2 on the card) and its o projection."""
    batch, seq, width = h.shape
    q, k, v = (proj(h).reshape(batch, seq, n_heads, width // n_heads)
               for proj in (block.q_proj, block.k_proj, block.v_proj))
    out = attn_ops.attention(q, k, v, causal=False)
    return block.o_proj(out.reshape(batch, seq, width))


class EncoderBlock(nn.Module):

    def __init__(self, cfg: ViTConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        self.attn_norm = LayerNorm(d, cfg.dtype, device)
        for name, (fin, fout) in (("q_proj", (d, d)), ("k_proj", (d, d)),
                                  ("v_proj", (d, d)), ("o_proj", (d, d)),
                                  ("up_proj", (d, ff)),
                                  ("down_proj", (ff, d))):
            setattr(self, name, Dense(fin, fout, cfg.dtype,
                                      cfg.param_dtype, device=device))
        self.mlp_norm = LayerNorm(d, cfg.dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = x + self_attention(self, self.attn_norm(x), cfg.n_heads)
        h = self.up_proj(self.mlp_norm(x))
        h = self.down_proj(F.gelu(h, approximate="tanh"))
        return x + h


class ViT(nn.Module):

    def __init__(self, config: ViTConfig, device=None) -> None:
        super().__init__()
        cfg = self.config = config
        p = cfg.patch_size
        self.patch_embed = Dense(p * p * 3, cfg.d_model, cfg.dtype,
                                 cfg.param_dtype, device=device)
        side = cfg.image_size // p
        self.register_buffer("pos", torch.from_numpy(
            sincos_2d_positions(side, cfg.d_model)).to(device=device,
                                                      dtype=cfg.dtype),
            persistent=False)
        for idx in range(cfg.n_layers):
            self.add_module(f"layer_{idx}", EncoderBlock(cfg, device))
        self.final_norm = LayerNorm(cfg.d_model, cfg.dtype, device)
        self.head = Dense(cfg.d_model, cfg.num_classes, torch.float32,
                          cfg.param_dtype, device=device)

    def kernel_libraries(self) -> tuple[str, ...]:
        """The kernel libraries a step launches: its attention's."""
        return attn_ops.libraries(self.pos.device)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] -> fp32 logits [B, num_classes]."""
        cfg = self.config
        patches = patchify(images, cfg.patch_size)
        x = self.patch_embed(patches.to(cfg.dtype)) + self.pos[None]
        for idx in range(cfg.n_layers):
            x = getattr(self, f"layer_{idx}")(x)
        pooled = self.final_norm(x).float().mean(dim=1)
        return self.head(pooled)


def init_params(model: nn.Module, generator: torch.Generator) -> None:
    """flax's initializers in place: every Dense lecun-normal with a zero
    bias (adaLN-Zero's zero Denses zero), an Embed normal with variance
    1/features; LayerNorm scales one and biases zero, as built."""
    for module in model.modules():
        if isinstance(module, (Dense, Embed)):
            module.reset_parameters(generator)
