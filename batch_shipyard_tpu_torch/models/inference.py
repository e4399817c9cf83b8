"""Autoregressive inference: KV-cache decode + sampling (PyTorch).

Counterpart of batch_shipyard_tpu/models/inference.py: prefill is ONE
multi-token forward over the prompt (the cache-insert path of the
decode-mode transformer), then one token per step. PyTorch runs
eagerly, so the decode loop is a Python loop rather than a jitted scan.
Sampling is greedy (exact), or temperature/top-k through an explicit
``torch.Generator`` — a different random stream than JAX's PRNG key.
Speculative decoding (``speculative_generate``): a draft model proposes
gamma tokens, the target scores them in one multi-token forward, and
both caches rewind to the accepted prefix in place (``_rewind_cache``).
"""

from __future__ import annotations

import dataclasses

import torch

from batch_shipyard_tpu_torch.device import resolve_device
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
    for int8), L = max_decode_len + spec_window. Paged: k_pages/v_pages
    [P, page, H, D], block_table [B, max_blocks] with max_blocks =
    ceil((max_decode_len + spec_window) / page) (ONE tensor shared by
    every layer), length [B] (+ k_page_scales/v_page_scales [P, page, H]
    for int8)."""
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
        max_blocks = -(-(cfg.max_decode_len + cfg.spec_window) // page)
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
    length = cfg.max_decode_len + cfg.spec_window
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


def _rewind_cache(cache: list[dict], steps) -> None:
    """Roll every layer's write cursor (dense ``index``, paged
    ``length``) back by ``steps`` (an int or [B]), in place. Rows past
    the cursor are masked on read and overwritten by the next insert, so
    the cursor IS the cache state: rewinding un-commits speculated
    tokens in O(1) (paged pages stay allocated)."""
    for layer in cache:
        layer["length" if "length" in layer else "index"].sub_(steps)


def _greedy_next(model: tfm.TransformerLM, hidden: torch.Tensor):
    """Greedy token ids of hidden states [..., d_model] against the fp32
    embedding (the reference's fp32 logits matvec)."""
    return torch.argmax(last_token_logits(model, hidden),
                        dim=-1).to(torch.int32)


@torch.no_grad()
def speculative_generate(target_model: tfm.TransformerLM,
                         draft_model: tfm.TransformerLM, prompt,
                         num_tokens: int, gamma: int = 4):
    """Speculative decoding (Leviathan et al.), greedy: the DRAFT model
    proposes ``gamma`` tokens autoregressively, the TARGET scores the
    block [y, d_1..d_gamma] in ONE multi-token forward and commits the
    longest validated prefix plus one target token (the correction, or
    the bonus when all match). Outputs equal target-only greedy decoding
    (bit for bit where the verify block rounds as single steps do).

    Batched: acceptance is synchronised to the batch MINIMUM each round
    (still exact per slot; it only costs throughput). prompt: [B, P]
    int32 (P >= 1). Returns (tokens [B, P + num_tokens], stats: rounds,
    proposed, accepted as ints; acceptance rate = accepted / proposed).

    Cache invariant: each model's cache holds every committed token
    EXCEPT the newest (``y``); a round feeds [y, d_1..d_gamma], both
    caches advance gamma + 1 and rewind by gamma - accepted. The
    accepted count is read on the host once a round (the reference's
    while_loop carries it on the device)."""
    batch, prompt_len = prompt.shape
    device = prompt.device
    t_cache = init_cache(target_model, batch)
    d_cache = init_cache(draft_model, batch)
    if prompt_len > 1:
        # Prefill both caches with prompt[:-1]; the last prompt token is
        # the first pending y.
        target_model(prompt[:, :-1], cache=t_cache, return_hidden=True)
        draft_model(prompt[:, :-1], cache=d_cache, return_hidden=True)
    y = prompt[:, -1].to(torch.int32)
    out = []
    n_done = rounds = proposed = accepted = 0
    steps = torch.arange(gamma + 1, dtype=torch.int32, device=device)
    while n_done < num_tokens:
        pos_y = prompt_len + n_done - 1
        token, drafts = y, []
        for step in range(gamma + 1):
            # The final extra step only inserts d_gamma's K/V, so the
            # draft cache keeps pace when everything is accepted.
            hidden = draft_model(
                token[:, None], positions=torch.full(
                    (1,), pos_y + step, dtype=torch.int32, device=device),
                cache=d_cache, return_hidden=True)
            token = _greedy_next(draft_model, hidden[:, 0])
            drafts.append(token)
        d_tok = torch.stack(drafts[:gamma], dim=1)             # [B, g]
        hidden = target_model(torch.cat([y[:, None], d_tok], dim=1),
                              positions=pos_y + steps, cache=t_cache,
                              return_hidden=True)
        t_tok = _greedy_next(target_model, hidden)             # [B, g+1]
        match = (d_tok == t_tok[:, :gamma]).to(torch.int32)
        a = int(torch.cumprod(match, dim=1).sum(dim=1).min())
        block = torch.cat([d_tok[:, :a], t_tok[:, a:a + 1]], dim=1)
        out.append(block)
        _rewind_cache(t_cache, gamma - a)
        _rewind_cache(d_cache, gamma - a)
        y = t_tok[:, a]
        n_done += a + 1
        rounds += 1
        proposed += gamma
        accepted += a
    tokens = torch.cat([prompt.to(torch.int32), *out], dim=1)
    stats = {"rounds": rounds, "proposed": proposed, "accepted": accepted}
    return tokens[:, :prompt_len + num_tokens], stats


def make_speculative_decoder(target_config: tfm.TransformerConfig,
                             target_params: dict,
                             draft_config: tfm.TransformerConfig,
                             draft_params: dict, max_decode_len: int,
                             gamma: int = 4, device=None):
    """(run, target_model, draft_model) bound to decode-mode models on
    ``device`` holding the two state dicts. run(prompt, num_tokens) ->
    (tokens, stats). Both configs must use the dense cache."""
    for name, cfg in (("target", target_config),
                      ("draft", draft_config)):
        if cfg.kv_page_size:
            raise ValueError(
                f"speculative decoding needs the dense KV cache "
                f"(multi-token verify + O(1) index rewind); {name} "
                f"config sets kv_page_size={cfg.kv_page_size} — "
                f"clear it for the speculative path")
    device = resolve_device(device)

    def load(cfg, params):
        model = tfm.TransformerLM(decode_config(cfg, max_decode_len),
                                  device="meta")
        model.load_state_dict({k: v.to(device) for k, v in params.items()},
                              assign=True)
        return model.requires_grad_(False).eval()
    t_model = load(target_config, target_params)
    d_model = load(draft_config, draft_params)

    def run(prompt, num_tokens: int):
        return speculative_generate(t_model, d_model,
                                    torch.as_tensor(prompt, device=device),
                                    num_tokens, gamma=gamma)

    return run, t_model, d_model
