"""Chunked tied-embedding cross-entropy: the mean softmax cross-entropy
of hidden @ embedding.T against targets without the full [N, V] logits.

Counterpart of batch_shipyard_tpu/ops/chunked_loss.py. ``impl="plain"``
ports the reference's ``_xent_xla``: one [chunk, V] fp32 logits slab at
a time, each chunk recomputed in the backward (``torch.utils.checkpoint``
where the reference uses ``jax.checkpoint``); the slab's product is a
plain matmul, as the reference leaves it to XLA. A ragged last chunk is
simply shorter (the reference shrinks every chunk to gcd(N, chunk); the
sum is the same). The fused Pallas kernels K3-K5 (``impl="pallas"``)
are opt-in in the reference and not ported yet.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_nll(h_chunk, e, t_chunk, ignore_id: int):
    logits = h_chunk.float() @ e.float().t()
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.where(t_chunk == ignore_id, 0, t_chunk).long()
    gold = logits.gather(1, safe[:, None])[:, 0]
    mask = (t_chunk != ignore_id).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def chunked_softmax_xent(hidden, embedding, targets, ignore_id: int = -1,
                         impl: str = "plain", chunk_size: int = 128):
    """Mean cross-entropy of hidden @ embedding.T against targets, in
    fp32, over rows whose target is not ``ignore_id`` (0 when every row
    is ignored). hidden: [B, T, D] or [N, D]; embedding: [V, D]; targets
    matches hidden's leading shape; chunk_size counts rows."""
    if impl == "pallas":
        raise NotImplementedError(
            "the fused cross-entropy kernels K3-K5 (reference "
            "ops/chunked_loss.py _fwd_kernel, _bwd_h_kernel, "
            "_bwd_e_kernel) are not ported yet: ROADMAP queue 2 lists "
            "them for the next training slice; use impl='plain'")
    if impl != "plain":
        raise ValueError(f"unknown impl {impl!r}")
    if hidden.dim() == 3:
        hidden = hidden.reshape(-1, hidden.shape[-1])
        targets = targets.reshape(-1)
    total = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for start in range(0, hidden.shape[0], chunk_size):
        args = (hidden[start:start + chunk_size], embedding,
                targets[start:start + chunk_size], ignore_id)
        if torch.is_grad_enabled():
            nll, n = checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            nll, n = _chunk_nll(*args)
        total = total + nll
        count = count + n
    return total / torch.clamp(count, min=1.0)
