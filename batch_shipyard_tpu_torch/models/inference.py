"""Autoregressive inference: KV-cache decode + sampling (PyTorch).

Counterpart of batch_shipyard_tpu/models/inference.py: prefill is ONE
multi-token forward over the prompt (the cache-insert path of the
decode-mode transformer), then one token per step. PyTorch runs
eagerly, so the decode loop is a Python loop rather than a jitted scan.
Sampling is greedy (exact), or temperature/top-k through an explicit
``torch.Generator`` — a different random stream than JAX's PRNG key.
Speculative decoding comes with a later slice.
"""

from __future__ import annotations

import dataclasses

import torch

from batch_shipyard_tpu_torch.models import transformer as tfm


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0   # 0 => greedy
    top_k: int = 0             # 0 => full distribution


def decode_config(config: tfm.TransformerConfig,
                  max_decode_len: int) -> tfm.TransformerConfig:
    return dataclasses.replace(config, decode=True,
                               max_decode_len=max_decode_len)


def init_cache(model: tfm.TransformerLM, batch_size: int) -> list[dict]:
    """An empty KV cache for the decode model, on the model's device:
    one dict of tensors per layer under the reference's leaf names.
    Dense: k/v [B, L, H, D], index [B] (+ k_scale/v_scale [B, L, H]
    for int8). Paged: k_pages/v_pages [P, page, H, D], block_table
    [B, max_blocks] (ONE tensor shared by every layer), length [B]
    (+ k_page_scales/v_page_scales [P, page, H] for int8)."""
    cfg = model.config
    device = model.embed.embedding.device
    store = torch.int8 if cfg.kv_cache_dtype == "int8" else cfg.dtype
    int8_kv = cfg.kv_cache_dtype == "int8"
    heads, depth = cfg.n_heads, cfg.d_head

    def zeros(*shape, dtype=store):
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = []
    if cfg.kv_page_size:
        page, pages = cfg.kv_page_size, cfg.kv_num_pages
        max_blocks = -(-cfg.max_decode_len // page)
        table = zeros(batch_size, max_blocks, dtype=torch.int32)
        for _ in range(cfg.n_layers):
            layer = {"k_pages": zeros(pages, page, heads, depth),
                     "v_pages": zeros(pages, page, heads, depth),
                     "block_table": table,
                     "length": zeros(batch_size, dtype=torch.int32)}
            if int8_kv:
                layer["k_page_scales"] = zeros(pages, page, heads,
                                               dtype=torch.float32)
                layer["v_page_scales"] = zeros(pages, page, heads,
                                               dtype=torch.float32)
            layers.append(layer)
        return layers
    length = cfg.max_decode_len
    for _ in range(cfg.n_layers):
        layer = {"k": zeros(batch_size, length, heads, depth),
                 "v": zeros(batch_size, length, heads, depth),
                 "index": zeros(batch_size, dtype=torch.int32)}
        if int8_kv:
            layer["k_scale"] = zeros(batch_size, length, heads,
                                     dtype=torch.float32)
            layer["v_scale"] = zeros(batch_size, length, heads,
                                     dtype=torch.float32)
        layers.append(layer)
    return layers


def _sample(logits: torch.Tensor, generator: torch.Generator,
            sampling: SamplingConfig) -> torch.Tensor:
    """logits [B, vocab] fp32 -> token ids [B] int32."""
    if sampling.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / sampling.temperature
    if sampling.top_k > 0:
        cutoff = torch.topk(logits, sampling.top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    # torch.multinomial's one-sample draw, argmax(p / q) with q ~ Exp(1)
    # (the same numbers from the same generator), written out because
    # multinomial checks its input on the host, which a captured CUDA
    # graph cannot do.
    noise = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / noise, dim=-1).to(torch.int32)


def last_token_logits(model: tfm.TransformerLM,
                      hidden: torch.Tensor) -> torch.Tensor:
    """[..., d_model] hidden -> [..., vocab] fp32 logits against the
    fp32 embedding (the reference's prefill matvec)."""
    return hidden.float() @ model.embed.embedding.float().T


@torch.no_grad()
def generate(model: tfm.TransformerLM, cache: list[dict],
             prompt: torch.Tensor, num_tokens: int,
             generator: torch.Generator,
             sampling: SamplingConfig = SamplingConfig()):
    """Generate num_tokens continuations of prompt [B, T_prompt].
    Returns (tokens [B, T_prompt + num_tokens], cache); the cache is
    updated in place."""
    prompt_len = prompt.shape[1]
    hidden = model(prompt, cache=cache, return_hidden=True)
    token = _sample(last_token_logits(model, hidden[:, -1]), generator,
                    sampling)[:, None]
    out = [prompt, token]
    for pos in range(prompt_len, prompt_len + num_tokens - 1):
        logits = model(token, positions=torch.tensor(
            [pos], dtype=torch.int32, device=prompt.device), cache=cache)
        token = _sample(logits[:, 0].float(), generator,
                        sampling)[:, None]
        out.append(token)
    return torch.cat(out, dim=1), cache
