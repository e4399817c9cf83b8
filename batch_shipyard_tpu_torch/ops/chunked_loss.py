"""Chunked tied-embedding cross-entropy: the mean softmax cross-entropy
of hidden @ embedding.T against targets without the full [N, V] logits.

Counterpart of batch_shipyard_tpu/ops/chunked_loss.py. Two paths:

- ``impl="plain"`` ports the reference's ``_xent_xla``: one [chunk, V]
  fp32 logits slab at a time, each chunk recomputed in the backward
  (``torch.utils.checkpoint`` where the reference uses
  ``jax.checkpoint``); the slab's product is a plain matmul, as the
  reference leaves it to XLA. A ragged last chunk is simply shorter (the
  reference shrinks every chunk to gcd(N, chunk); the sum is the same).
- ``impl="kernel"`` ports the fused Pallas path: one
  ``torch.autograd.Function`` whose forward is K3 (per-row lse and gold
  logit) and whose backward is K4 (grad_hidden) and K5 (grad_embedding),
  in ``csrc/chunked_loss.cu``, for CUDA tensors. The logits never leave
  the kernels. For CPU tensors it runs the kernels' plain versions
  (``xent_forward_reference``, ``xent_backward_h_reference``,
  ``xent_backward_e_reference``: tile-free fp32). The kernels compute
  their products in TF32 with fp32 accumulation (the TPU kernel casts to
  f32 and runs its dots at DEFAULT precision).

``impl="auto"`` (the default, as in the reference) takes the kernel only
on a CUDA device whose validation marker records a pass for
``chunked_cross_entropy`` (ops/kernel_select), and the plain path
otherwise. A model width that is not a multiple of 128 resolves to the
plain path before any launch, as the reference does
(``chunked_loss.py:309-312``). On a CUDA tensor the kernel path launches
its kernels or raises: there is no fallback after that decision.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from batch_shipyard_tpu_torch.ops import _build, kernel_select
from batch_shipyard_tpu_torch.ops.paged_attention import stream_handle

VALIDATION_NAME = "chunked_cross_entropy"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_DEPTHS = (128, 256, 512, 1024)
# fp32 hidden rows and the fp32 embedding tile do not both fit in shared
# memory past this depth; bf16 rows do up to 1024.
FP32_MAX_DEPTH = 512

# Kernel launches, and calls of the plain versions (``chunked`` counts
# calls of the plain slab path). chip_smoke.py zeroes and reads these.
launches = {"xent_fwd": 0, "xent_bwd_h": 0, "xent_bwd_e": 0}
plain_calls = {"xent_fwd": 0, "xent_bwd_h": 0, "xent_bwd_e": 0,
               "chunked": 0}


# ------------------------------ plain slabs -----------------------------


def _chunk_nll(h_chunk, e, t_chunk, ignore_id: int):
    logits = h_chunk.float() @ e.float().t()
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.where(t_chunk == ignore_id, 0, t_chunk).long()
    gold = logits.gather(1, safe[:, None])[:, 0]
    mask = (t_chunk != ignore_id).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def _xent_plain(hidden, embedding, targets, ignore_id: int, chunk_size: int):
    plain_calls["chunked"] += 1
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


# ------------------------ K3-K5: plain versions -------------------------


def _logits_and_targets(h, e, tgt, ignore_id: int):
    """fp32 [N, V] logits, the live-target mask and the targets with
    ignored ones replaced by 0."""
    logits = h.float() @ e.float().t()
    live = tgt != ignore_id
    return logits, live, torch.where(live, tgt, 0).long()


def xent_forward_reference(h, e, tgt, ignore_id: int = -1):
    """Plain version of K3: (lse, gold) fp32 [N] of the fp32 logits
    h @ e.T; rows whose target is ignore_id get gold 0."""
    plain_calls["xent_fwd"] += 1
    logits, live, safe = _logits_and_targets(h, e, tgt, ignore_id)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.where(live, logits.gather(1, safe[:, None])[:, 0], 0.0)
    return lse, gold


def _dlogits(h, e, tgt, lse, ds, ignore_id: int):
    """(softmax - onehot) * ds, fp32 [N, V], softmax from the saved lse."""
    logits, live, safe = _logits_and_targets(h, e, tgt, ignore_id)
    dl = torch.exp(logits - lse[:, None])
    onehot = torch.zeros_like(dl).scatter_(1, safe[:, None], 1.0)
    dl = dl - onehot * live[:, None].float()
    return dl * ds[:, None]


def xent_backward_h_reference(h, e, tgt, lse, ds, ignore_id: int = -1):
    """Plain version of K4: grad_hidden = dlogits @ e, fp32 [N, D]."""
    plain_calls["xent_bwd_h"] += 1
    return _dlogits(h, e, tgt, lse, ds, ignore_id) @ e.float()


def xent_backward_e_reference(h, e, tgt, lse, ds, ignore_id: int = -1):
    """Plain version of K5: grad_embedding = dlogits.T @ h, fp32 [V, D]."""
    plain_calls["xent_bwd_e"] += 1
    return _dlogits(h, e, tgt, lse, ds, ignore_id).t() @ h.float()


# --------------------------- K3-K5: kernels -----------------------------


def _check_inputs(h, e, tgt) -> tuple[int, int, int]:
    """Raise unless the kernels take these: CUDA, contiguous 16-byte
    aligned rows, h [N, D] fp32/bf16, e fp32 [V, D], tgt int32 [N]."""
    if not h.is_cuda:
        raise ValueError("the CUDA kernels take CUDA tensors; CPU tensors "
                         "go to the plain versions")
    if h.dim() != 2 or e.dim() != 2 or h.shape[1] != e.shape[1]:
        raise ValueError(f"h [N, D] and e [V, D], got {tuple(h.shape)} and "
                         f"{tuple(e.shape)}")
    n, d = h.shape
    if h.dtype not in DTYPE_CODES:
        raise ValueError(f"h dtype {h.dtype} not in {tuple(DTYPE_CODES)}")
    if d not in KERNEL_DEPTHS:
        raise ValueError(f"depth {d} not in {KERNEL_DEPTHS}")
    if h.dtype == torch.float32 and d > FP32_MAX_DEPTH:
        raise ValueError(f"fp32 hidden rows of depth {d} do not fit the "
                         f"kernel's shared memory (at most "
                         f"{FP32_MAX_DEPTH}); bf16 rows do")
    if e.dtype != torch.float32:
        raise ValueError(f"e must be fp32, got {e.dtype}")
    if tgt.dtype != torch.int32 or tuple(tgt.shape) != (n,):
        raise ValueError(f"tgt must be int32 [{n}], got {tgt.dtype} "
                         f"{tuple(tgt.shape)}")
    for name, t in (("h", h), ("e", e), ("tgt", tgt)):
        _check_buffer(name, t, h.device)
    return n, d, e.shape[0]


def _check_buffer(name: str, t: torch.Tensor, device) -> None:
    if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous, 16-byte aligned and "
                         f"on {device}")


def _row_vector(name: str, t: torch.Tensor, n: int, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != (n,):
        raise ValueError(f"{name} must be fp32 [{n}]")
    _check_buffer(name, t, device)


def xent_forward_kernel(h, e, tgt, ignore_id: int = -1, library=None):
    """K3 on the card: (lse, gold) fp32 [N]. ``library``: the loaded
    build of csrc/chunked_loss.cu to launch from (default: the one
    ``_build`` makes from the checkout)."""
    n, d, v = _check_inputs(h, e, tgt)
    dev = h.device
    lib = library or _build.library("chunked_loss")
    lse = torch.empty(n, dtype=torch.float32, device=dev)
    gold = torch.empty(n, dtype=torch.float32, device=dev)
    # The kernel's operands: h and e rounded to TF32 in fp32 (its pre-pass).
    h32 = torch.empty((n, d), dtype=torch.float32, device=dev)
    e32 = torch.empty((v, d), dtype=torch.float32, device=dev)
    rc = lib.bs_xent_fwd(dev.index or 0, h.data_ptr(), e.data_ptr(),
                         tgt.data_ptr(), lse.data_ptr(), gold.data_ptr(),
                         h32.data_ptr(), e32.data_ptr(), n, v, d,
                         DTYPE_CODES[h.dtype], ignore_id, stream_handle(dev))
    _build.check(rc, "cross-entropy forward (K3)", lib)
    launches["xent_fwd"] += 1
    return lse, gold


def _backward_kernel(which: int, key: str, h, e, tgt, lse, ds,
                     ignore_id: int, library):
    n, d, v = _check_inputs(h, e, tgt)
    dev = h.device
    _row_vector("lse", lse, n, dev)
    _row_vector("ds", ds, n, dev)
    lib = library or _build.library("chunked_loss")
    out = torch.empty((n if which == 1 else v, d), dtype=torch.float32,
                      device=dev)
    rc = lib.bs_xent_bwd(which, dev.index or 0, h.data_ptr(), e.data_ptr(),
                         tgt.data_ptr(), lse.data_ptr(), ds.data_ptr(),
                         out.data_ptr(), n, v, d, DTYPE_CODES[h.dtype],
                         ignore_id, stream_handle(dev))
    _build.check(rc, f"cross-entropy backward ({key})", lib)
    launches[key] += 1
    return out


def xent_backward_h_kernel(h, e, tgt, lse, ds, ignore_id: int = -1,
                           library=None):
    """K4 on the card: grad_hidden fp32 [N, D]."""
    return _backward_kernel(1, "xent_bwd_h", h, e, tgt, lse, ds, ignore_id,
                            library)


def xent_backward_e_kernel(h, e, tgt, lse, ds, ignore_id: int = -1,
                           library=None):
    """K5 on the card: grad_embedding fp32 [V, D]."""
    return _backward_kernel(2, "xent_bwd_e", h, e, tgt, lse, ds, ignore_id,
                            library)


def xent_forward(h, e, tgt, ignore_id: int = -1):
    if h.is_cuda:
        return xent_forward_kernel(h, e, tgt, ignore_id)
    return xent_forward_reference(h, e, tgt, ignore_id)


def xent_backward_h(h, e, tgt, lse, ds, ignore_id: int = -1):
    if h.is_cuda:
        return xent_backward_h_kernel(h, e, tgt, lse, ds, ignore_id)
    return xent_backward_h_reference(h, e, tgt, lse, ds, ignore_id)


def xent_backward_e(h, e, tgt, lse, ds, ignore_id: int = -1):
    if h.is_cuda:
        return xent_backward_e_kernel(h, e, tgt, lse, ds, ignore_id)
    return xent_backward_e_reference(h, e, tgt, lse, ds, ignore_id)


class _FusedXent(torch.autograd.Function):
    """Mean masked cross-entropy over [N, D] rows: K3 forward, K4 and K5
    backward (the reference's ``_xent_pallas`` custom_vjp)."""

    @staticmethod
    def forward(ctx, h, e, tgt, ignore_id: int):
        if h.is_cuda:
            tgt = tgt.to(torch.int32).contiguous()
        lse, gold = xent_forward(h, e, tgt, ignore_id)
        mask = (tgt != ignore_id).float()
        count = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(h, e, tgt, lse, mask, count)
        ctx.ignore_id = ignore_id
        return ((lse - gold) * mask).sum() / count

    @staticmethod
    def backward(ctx, g):
        h, e, tgt, lse, mask, count = ctx.saved_tensors
        ds = (g * mask / count).float().contiguous()
        gh = ge = None
        if ctx.needs_input_grad[0]:
            gh = xent_backward_h(h, e, tgt, lse, ds, ctx.ignore_id).to(h.dtype)
        if ctx.needs_input_grad[1]:
            ge = xent_backward_e(h, e, tgt, lse, ds, ctx.ignore_id).to(e.dtype)
        return gh, ge, None, None


def chunked_softmax_xent(hidden, embedding, targets, ignore_id: int = -1,
                         impl: str = "auto", chunk_size: int = 128):
    """Mean cross-entropy of hidden @ embedding.T against targets, in
    fp32, over rows whose target is not ``ignore_id`` (0 when every row
    is ignored). hidden: [B, T, D] or [N, D]; embedding: [V, D]; targets
    matches hidden's leading shape; chunk_size counts rows of a plain
    slab. impl: 'auto' | 'kernel' | 'plain' (module doc)."""
    if hidden.dim() == 3:
        hidden = hidden.reshape(-1, hidden.shape[-1])
        targets = targets.reshape(-1)
    if impl == "auto":
        impl = kernel_select.resolve_auto(VALIDATION_NAME, hidden.device)
    if impl == "kernel":
        if hidden.shape[1] % 128 == 0:
            return _FusedXent.apply(hidden, embedding, targets, ignore_id)
        impl = "plain"  # lane-misaligned width: the reference's own rule
    if impl != "plain":
        raise ValueError(f"unknown impl {impl!r}")
    return _xent_plain(hidden, embedding, targets, ignore_id, chunk_size)
