"""Diffusion transformer (DiT) in PyTorch: denoising-diffusion image
generation.

Counterpart of batch_shipyard_tpu/models/diffusion.py, with its names
(``patch_embed``, ``t_embed_1``/``t_embed_2``, ``label_embed``,
``block_{i}.adaln`` / ``attn_norm`` / ``q_proj`` ..., ``final_norm``,
``final_adaln``, ``head``): patchify -> N transformer blocks with
adaLN-Zero timestep conditioning (``adaln``, ``final_adaln`` and ``head``
zero-initialised, so every block starts as the identity) -> a linear
head predicting per-patch noise. The adaLN modulation is fp32, the
activations ``dtype``; attention is ops/attention.attention(...,
causal=False) (K1/K2 on the card, as models/vit.py).

Randomness. The reference draws the loss's timesteps and noise from a
JAX key inside the step (diffusion.py:165-178). Here ``diffusion_loss``
takes an explicit ``torch.Generator`` for them, or the draws themselves
(``t``, ``noise``), which is how the CPU tests feed the reference's own
draws across; ``ddim_sample`` takes its starting noise the same way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from batch_shipyard_tpu_torch.ops import attention as attn_ops
from batch_shipyard_tpu_torch.models.vit import (  # noqa: F401
    Dense, Embed, LayerNorm, init_params, patchify, self_attention,
    sincos_2d_positions, unpatchify)


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    image_size: int = 32
    channels: int = 3
    patch_size: int = 4
    d_model: int = 512
    n_layers: int = 8
    n_heads: int = 8
    d_ff: int = 2048
    num_classes: Optional[int] = None   # class-conditional when set
    timesteps: int = 1000
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding [B] -> [B, dim] (fp32)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _modulate(x, shift, scale):
    return x * (1.0 + scale[:, None]) + shift[:, None]


class DiTBlock(nn.Module):
    """Pre-LN block with adaLN-Zero conditioning: the conditioning vector
    gives shift/scale/gate for the attention and MLP branches; the gates
    start at zero."""

    def __init__(self, cfg: DiTConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        d, ff = cfg.d_model, cfg.d_ff
        self.adaln = Dense(d, 6 * d, torch.float32, cfg.param_dtype,
                           zero_init=True, device=device)
        self.attn_norm = LayerNorm(d, torch.float32, device)
        for name, (fin, fout) in (("q_proj", (d, d)), ("k_proj", (d, d)),
                                  ("v_proj", (d, d)), ("o_proj", (d, d)),
                                  ("up_proj", (d, ff)),
                                  ("down_proj", (ff, d))):
            setattr(self, name, Dense(fin, fout, cfg.dtype,
                                      cfg.param_dtype, device=device))
        self.mlp_norm = LayerNorm(d, torch.float32, device)

    def forward(self, x: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        (shift_a, scale_a, gate_a, shift_m, scale_m,
         gate_m) = self.adaln(F.silu(cond)).chunk(6, dim=-1)
        h = _modulate(self.attn_norm(x), shift_a, scale_a).to(cfg.dtype)
        out = self_attention(self, h, cfg.n_heads)
        x = x + (gate_a[:, None] * out.float()).to(x.dtype)
        h = _modulate(self.mlp_norm(x), shift_m, scale_m).to(cfg.dtype)
        h = self.down_proj(F.gelu(self.up_proj(h), approximate="tanh"))
        return x + (gate_m[:, None] * h.float()).to(x.dtype)


class DiT(nn.Module):

    def __init__(self, config: DiTConfig, device=None) -> None:
        super().__init__()
        cfg = self.config = config
        p, d = cfg.patch_size, cfg.d_model
        self.patch_embed = Dense(p * p * cfg.channels, d, cfg.dtype,
                                 cfg.param_dtype, device=device)
        side = cfg.image_size // p
        self.register_buffer("pos", torch.from_numpy(
            sincos_2d_positions(side, d)).to(device=device, dtype=cfg.dtype),
            persistent=False)
        self.t_embed_1 = Dense(d, d, torch.float32, cfg.param_dtype,
                               device=device)
        self.t_embed_2 = Dense(d, d, torch.float32, cfg.param_dtype,
                               device=device)
        if cfg.num_classes is not None:
            self.label_embed = Embed(cfg.num_classes, d, cfg.param_dtype,
                                     device)
        for idx in range(cfg.n_layers):
            self.add_module(f"block_{idx}", DiTBlock(cfg, device))
        self.final_norm = LayerNorm(d, torch.float32, device)
        self.final_adaln = Dense(d, 2 * d, torch.float32, cfg.param_dtype,
                                 zero_init=True, device=device)
        self.head = Dense(d, p * p * cfg.channels, torch.float32,
                          cfg.param_dtype, zero_init=True, device=device)

    def kernel_libraries(self) -> tuple[str, ...]:
        """The kernel libraries a step launches: its attention's."""
        return attn_ops.libraries(self.pos.device)

    def forward(self, x_noisy: torch.Tensor, t: torch.Tensor,
                labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x_noisy [B, H, W, C]; t [B] int; labels [B] int when
        class-conditional. Returns the predicted noise [B, H, W, C]
        (fp32)."""
        cfg = self.config
        patches = patchify(x_noisy, cfg.patch_size)
        x = self.patch_embed(patches.to(cfg.dtype)) + self.pos[None]
        cond = self.t_embed_1(timestep_embedding(t, cfg.d_model))
        cond = self.t_embed_2(F.silu(cond))
        if cfg.num_classes is not None:
            if labels is None:
                raise ValueError("class-conditional DiT needs labels")
            cond = cond + self.label_embed(labels)
        for idx in range(cfg.n_layers):
            x = getattr(self, f"block_{idx}")(x, cond)
        shift, scale = self.final_adaln(F.silu(cond)).chunk(2, dim=-1)
        h = _modulate(self.final_norm(x), shift, scale)
        return unpatchify(self.head(h), cfg.patch_size, cfg.channels)


def cosine_alpha_bar(timesteps: int, device=None) -> torch.Tensor:
    """Cumulative noise schedule alpha_bar[t] (cosine, fp32)."""
    steps = torch.arange(timesteps + 1, dtype=torch.float32,
                         device=device) / timesteps
    f = torch.cos((steps + 0.008) / 1.008 * math.pi / 2) ** 2
    return torch.clamp(f[1:] / f[0], 1e-5, 1.0)


def draw_loss_noise(cfg: DiTConfig, shape, generator: torch.Generator
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(t [B] uniform over the timesteps, noise of ``shape`` standard
    normal, fp32), both from ``generator`` on its device."""
    device = generator.device
    t = torch.randint(0, cfg.timesteps, (shape[0],), generator=generator,
                      device=device)
    noise = torch.randn(shape, generator=generator, device=device)
    return t, noise


def diffusion_loss(model: DiT, x0: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   labels: Optional[torch.Tensor] = None,
                   t: Optional[torch.Tensor] = None,
                   noise: Optional[torch.Tensor] = None,
                   denominator: Optional[int] = None) -> torch.Tensor:
    """Epsilon-prediction MSE at the timesteps ``t`` with ``noise`` (drawn
    from ``generator`` when not given). ``denominator``: the mean's
    divisor in images (a rank's share of the global batch's mean)."""
    cfg = model.config
    if t is None or noise is None:
        t, noise = draw_loss_noise(cfg, x0.shape, generator)
    alpha_bar = cosine_alpha_bar(cfg.timesteps, x0.device)[t.long()]
    sqrt_ab = torch.sqrt(alpha_bar)[:, None, None, None]
    sqrt_1mab = torch.sqrt(1.0 - alpha_bar)[:, None, None, None]
    x_noisy = sqrt_ab * x0.float() + sqrt_1mab * noise
    pred = model(x_noisy.to(cfg.dtype), t, labels)
    sq = (pred.float() - noise).square()
    if denominator is None:
        return sq.mean()
    return sq.sum() / (denominator * sq[0].numel())


@torch.no_grad()
def ddim_sample(model: DiT, num_images: int, num_steps: int = 50,
                generator: Optional[torch.Generator] = None,
                labels: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Deterministic DDIM: ``num_steps`` uniform strides through the
    schedule from ``noise`` (drawn from ``generator`` when not given)."""
    cfg = model.config
    shape = (num_images, cfg.image_size, cfg.image_size, cfg.channels)
    device = next(model.parameters()).device
    alpha_bar = cosine_alpha_bar(cfg.timesteps, device)
    ts = np.linspace(cfg.timesteps - 1, 0, num_steps).astype(np.int32)
    x = noise if noise is not None else torch.randn(
        shape, generator=generator, device=device)
    x = x.float()
    for i in range(num_steps):
        ab_t = alpha_bar[int(ts[i])]
        ab_prev = (alpha_bar[int(ts[i + 1])] if i + 1 < num_steps
                   else torch.ones((), device=device))
        t_vec = torch.full((num_images,), int(ts[i]), dtype=torch.int32,
                           device=device)
        eps = model(x.to(cfg.dtype), t_vec, labels).float()
        x0_hat = (x - torch.sqrt(1.0 - ab_t) * eps) / torch.sqrt(ab_t)
        x0_hat = torch.clamp(x0_hat, -1.0, 1.0)
        x = torch.sqrt(ab_prev) * x0_hat + torch.sqrt(1.0 - ab_prev) * eps
    return x
