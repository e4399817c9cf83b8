"""Parameters for the port's TransformerLM: from a flax tree, or drawn
fresh on the card.

``params_from_flax`` carries the reference's trained or initialized
weights across (the parity tests load the SAME weights into both
packages; the two frameworks' random generators differ). It takes the
flax param tree as nested dicts of numpy arrays, so it needs no JAX.
``init_params`` draws a state dict from an explicit torch.Generator
with flax's initializers' distributions, for runs without JAX.
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
    becomes ``weight [out, in]``; ``embed/embedding`` (shared with the
    tied logits) and RMSNorm ``scale`` carry across under the same
    path."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, path: tuple) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
                continue
            array = np.asarray(value)
            if key == "kernel":
                out[".".join(path + ("weight",))] = torch.from_numpy(
                    np.ascontiguousarray(array.T))
            else:
                out[".".join(path + (key,))] = torch.from_numpy(
                    array.copy())

    walk(tree, ())
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
