"""Parameters for the port's TransformerLM: from a flax tree, or drawn
fresh on the card.

``params_from_flax`` carries the reference's trained or initialized
weights across (the parity tests load the SAME weights into both
packages; the two frameworks' random generators differ). It takes the
flax param tree as nested dicts of numpy arrays, so it needs no JAX.
``init_params`` draws a state dict from an explicit torch.Generator
with flax's initializers' distributions, for runs without JAX.
``opt_state_from_optax`` carries optax.adamw's moments and count across
under the same names and transposes, so a run can continue the
reference's training mid-run, optimizer included. ``unfused_params``
re-lays a fused_norm state dict out as the per-projection one the
decode model takes (the same weights).

The vision models (models/resnet.py, vit.py, diffusion.py) keep flax's
paths too, so ``params_from_flax`` loads them: a Conv ``kernel [kh, kw,
in, out]`` becomes ``weight [out, in, kh, kw]``, a Dense ``kernel [in,
out]`` ``weight [out, in]``, an Embed ``embedding`` stays as it is.
Trees shaped like the params convert the same way: ResNet's
``batch_stats`` into its running ``mean`` / ``var`` buffers, and
optax.sgd's momentum ``trace`` into torch SGD's ``momentum_buffer`` (the
same recursion with dampening 0, the first step included: torch's first
buffer is the gradient, optax's 0.9 * 0 + g).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from batch_shipyard_tpu_torch.models.transformer import (
    TransformerConfig, embedding_normal_, lecun_normal_)


def params_from_flax(tree: Mapping) -> dict[str, torch.Tensor]:
    """flax params (``model.init(...)["params"]`` mapped to numpy) ->
    the port's state dict. Dense (and QuantDense) ``kernel [in, out]``
    becomes ``weight [out, in]``, Conv ``kernel [kh, kw, in, out]``
    ``weight [out, in, kh, kw]``; ``embed/embedding`` (shared with the
    tied logits), norm ``scale`` / ``bias`` and Dense ``bias`` carry
    across under the same path."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: tuple) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            array = np.asarray(value)
            if key == "kernel":
                order = (3, 2, 0, 1) if array.ndim == 4 else None
                out[".".join(path + ("weight",))] = torch.from_numpy(
                    np.ascontiguousarray(np.transpose(array, order)))
            else:
                out[".".join(path + (key,))] = torch.from_numpy(
                    array.copy())

    walk(tree, ())
    return out


def opt_state_from_optax(mu: Mapping, nu: Mapping, count) -> dict:
    """optax.adamw's state (``ScaleByAdamState``: ``mu`` and ``nu``, trees
    shaped like the params, and ``count``) -> the port's AdamW state:
    {"step": count, "exp_avg": state dict of mu, "exp_avg_sq": state dict
    of nu}, under params_from_flax's names and transposes."""
    return {"step": int(np.asarray(count)),
            "exp_avg": params_from_flax(mu),
            "exp_avg_sq": params_from_flax(nu)}


def unfused_params(state: Mapping[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
    """A fused_norm state dict -> the unfused one of the same model:
    ``attn.norm_scale`` / ``mlp.norm_scale`` become ``attn_norm.scale`` /
    ``mlp_norm.scale``; ``qkv_kernel [d, 3F]`` (columns [q | k | v]) the
    q/k/v ``weight [F, d]``s and ``gate_up_kernel [d, 2 d_ff]`` ([gate |
    up]) the gate/up ones. Other tensors pass through."""
    out: dict[str, torch.Tensor] = {}
    for name, tensor in state.items():
        layer, _, leaf = name.rpartition(".")
        block, _, sub = layer.rpartition(".")
        if leaf == "norm_scale":
            out[f"{block}.{sub}_norm.scale"] = tensor
        elif leaf == "qkv_kernel":
            for proj, part in zip(("q_proj", "k_proj", "v_proj"),
                                  tensor.chunk(3, dim=1)):
                out[f"{layer}.{proj}.weight"] = part.t().contiguous()
        elif leaf == "gate_up_kernel":
            for proj, part in zip(("gate_proj", "up_proj"),
                                  tensor.chunk(2, dim=1)):
                out[f"{layer}.{proj}.weight"] = part.t().contiguous()
        else:
            out[name] = tensor
    return out


def init_params(config: TransformerConfig,
                generator: torch.Generator) -> dict[str, torch.Tensor]:
    """A fresh state dict on ``generator.device``: Dense weights
    (QuantDense ones alike, under the same names) lecun-normal
    (truncated normal, variance 1/fan_in), the embedding normal with
    variance 1/d_model (flax's default Embed init,
    variance_scaling(1, fan_in, normal) over [vocab, d_model]), RMSNorm
    scales one. With ``fused_norm``, ``qkv_kernel [d, 3F]`` and
    ``gate_up_kernel [d, 2*d_ff]`` are lecun-normal over fan-in d in the
    reference's [in, out] layout, and their ``norm_scale`` one."""
    device = generator.device
    dtype = config.param_dtype
    state: dict[str, torch.Tensor] = {}

    def lecun(shape: tuple, fan_in: int) -> torch.Tensor:
        weight = torch.empty(shape, dtype=dtype, device=device)
        return lecun_normal_(weight, fan_in, generator)

    def dense(name: str, fan_in: int, fan_out: int) -> None:
        state[name + ".weight"] = lecun((fan_out, fan_in), fan_in)

    def ones() -> torch.Tensor:
        return torch.ones(config.d_model, dtype=torch.float32, device=device)

    state["embed.embedding"] = embedding_normal_(
        torch.empty(config.vocab_size, config.d_model, dtype=dtype,
                    device=device), generator)
    features = config.n_heads * config.d_head
    for i in range(config.n_layers):
        layer = f"layer_{i}"
        if config.fused_norm:
            state[f"{layer}.attn.norm_scale"] = ones()
            state[f"{layer}.attn.qkv_kernel"] = lecun(
                (config.d_model, 3 * features), config.d_model)
        else:
            for proj in ("q_proj", "k_proj", "v_proj"):
                dense(f"{layer}.attn.{proj}", config.d_model, features)
        dense(f"{layer}.attn.o_proj", features, config.d_model)
        if config.fused_norm:
            state[f"{layer}.mlp.norm_scale"] = ones()
            state[f"{layer}.mlp.gate_up_kernel"] = lecun(
                (config.d_model, 2 * config.d_ff), config.d_model)
        else:
            dense(f"{layer}.mlp.gate_proj", config.d_model, config.d_ff)
            dense(f"{layer}.mlp.up_proj", config.d_model, config.d_ff)
            for norm in ("attn_norm", "mlp_norm"):
                state[f"{layer}.{norm}.scale"] = ones()
        dense(f"{layer}.mlp.down_proj", config.d_ff, config.d_model)
    state["final_norm.scale"] = ones()
    return state
