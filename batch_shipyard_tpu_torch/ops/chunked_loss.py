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
  in ``csrc/chunked_loss.cu``, for CUDA tensors. With both gradients
  wanted (every training step with tied embeddings) the backward is one
  joint call: one dl pass a vocab chunk feeding both products. The full
  [N, V] logits never exist; one [N, BWD_CHUNK] chunk of dlogits (and
  its transpose) does, in scratch the wrapper allocates. For CPU
  tensors it runs the kernels' plain versions (``xent_forward_reference``
  and ``xent_backward_reference``, the joint backward's chunk schedule in
  fp32; ``xent_backward_h_reference`` and ``xent_backward_e_reference``
  are K4's and K5's alone). The kernels compute their products in TF32
  with fp32 accumulation (the TPU kernel casts to f32 and runs its dots
  at DEFAULT precision).

``impl="auto"`` (the default, as in the reference) takes the kernel only
on a CUDA device whose validation marker records a pass for
``chunked_cross_entropy`` (ops/kernel_select), and the plain path
otherwise. A model width that is not a multiple of 128 resolves to the
plain path before any launch, as the reference does
(``chunked_loss.py:309-312``). On a CUDA tensor the kernel path launches
its kernels or raises: there is no fallback after that decision.

The vocab-parallel loss (``tp_group``: a tp RingGroup, and ``embedding``
this rank's rows [r V/tp, (r + 1) V/tp) of the table, the reference's
``P("tp", "fsdp")``), on both paths:

- each rank computes its rows' (lse_r, gold_r) for every hidden row,
  the targets mapped to ``target - r V/tp`` inside its rows and to
  ``ignore_id`` outside them (K3 on the shard, or the plain slabs);
- one K13 all-gathers the stacked [2, N] (lse_r, gold_r) over the ring;
  lse = logsumexp over the ranks and gold = their sum (exactly one rank
  holds each live target), the same bits on every rank;
- the mask and the count of live rows come from the global targets: an
  out-of-shard row is live, only its one-hot lies elsewhere;
- the backward is K4/K5 on the shard with the global lse and ds: grad_E
  is this rank's rows' gradient, grad_h this rank's partial sum over its
  vocab, summed over the ring (ring_all_reduce, in fp32) before it is
  cast to h's dtype.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from batch_shipyard_tpu_torch.ops import _build, kernel_select
from batch_shipyard_tpu_torch.ops import ring_collectives
from batch_shipyard_tpu_torch.ops.paged_attention import stream_handle

VALIDATION_NAME = "chunked_cross_entropy"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
KERNEL_DEPTHS = (128, 256, 512, 1024)
# Vocab columns of dlogits the backward holds at once (a multiple of
# 256): its scratch is 2 * 4 * N * BWD_CHUNK bytes for the joint call,
# 1.07 GB at bench_transformer's 32768 rows.
BWD_CHUNK = 4096

# Kernel launches, and calls of the plain versions (``chunked`` counts
# calls of the plain slab path). chip_smoke.py zeroes and reads these.
launches = {"xent_fwd": 0, "xent_bwd_h": 0, "xent_bwd_e": 0}
plain_calls = {"xent_fwd": 0, "xent_bwd_h": 0, "xent_bwd_e": 0,
               "chunked": 0}


# ------------------- the vocab-parallel pieces, plain slabs -------------------


def shard_targets(targets, rows: int, group, ignore_id: int):
    """The targets as this tp rank's shard of ``rows`` embedding rows
    sees them: ``target - rank * rows`` inside the shard, ``ignore_id``
    elsewhere (and where the target is ignore_id)."""
    if 0 <= ignore_id < rows:
        raise ValueError(f"ignore_id {ignore_id} is a row of the shard: "
                         f"the vocab-parallel loss needs one outside "
                         f"[0, {rows})")
    local = targets - group.rank * rows
    mine = (targets != ignore_id) & (local >= 0) & (local < rows)
    return torch.where(mine, local, ignore_id).to(targets.dtype)


class _GatherShards(torch.autograd.Function):
    """merge_shards' all-gather, differentiable: every tp rank computes
    the same loss from the gathered values, so the gradient of this
    rank's part is its slice of the (replicated) cotangent."""

    @staticmethod
    def forward(ctx, parts, group):
        ctx.group = group
        with ring_collectives.call_site("loss"):
            return ring_collectives.ring_all_gather(parts.contiguous(),
                                                    group)

    @staticmethod
    def backward(ctx, g):
        rows = g.shape[0] // ctx.group.size
        return g[ctx.group.rank * rows:(ctx.group.rank + 1) * rows], None


def merge_shards(lse, gold, group):
    """(lse, gold) [N] over the whole vocabulary from this rank's shard's:
    one all-gather of the stacked [2, N] over the tp ring, then
    logsumexp and sum over the ranks."""
    both = _GatherShards.apply(torch.stack([lse, gold]), group).view(
        group.size, 2, -1)
    return torch.logsumexp(both[:, 0], dim=0), both[:, 1].sum(dim=0)


def _chunk_stats(h_chunk, e, t_chunk, ignore_id: int):
    """(lse, gold) of one slab's fp32 logits (gold 0 where the target is
    ignore_id: ignored, or under tp outside this rank's rows)."""
    logits = h_chunk.float() @ e.float().t()
    live = t_chunk != ignore_id
    safe = torch.where(live, t_chunk, 0).long()
    gold = torch.where(live, logits.gather(1, safe[:, None])[:, 0], 0.0)
    return torch.logsumexp(logits, dim=-1), gold


def _xent_plain(hidden, embedding, targets, ignore_id: int, chunk_size: int,
                tp_group=None):
    """The plain slabs: per slab (lse, gold), recomputed in the backward;
    with a tp group on this rank's rows, merged by one gather, f on
    hidden summing its gradient over the ring in fp32 (module doc)."""
    plain_calls["chunked"] += 1
    local = targets
    if tp_group is not None:
        local = shard_targets(targets, embedding.shape[0], tp_group,
                              ignore_id)
        hidden = ring_collectives.tp_region_input(hidden.float(), tp_group)
    lse, gold = [], []
    for start in range(0, hidden.shape[0], chunk_size):
        args = (hidden[start:start + chunk_size], embedding,
                local[start:start + chunk_size], ignore_id)
        if torch.is_grad_enabled():
            stats = checkpoint(_chunk_stats, *args, use_reentrant=False)
        else:
            stats = _chunk_stats(*args)
        lse.append(stats[0])
        gold.append(stats[1])
    lse, gold = torch.cat(lse), torch.cat(gold)
    if tp_group is not None:
        lse, gold = merge_shards(lse, gold, tp_group)
    mask = (targets != ignore_id).float()
    return ((lse - gold) * mask).sum() / torch.clamp(mask.sum(), min=1.0)


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


def xent_backward_reference(h, e, tgt, lse, ds, ignore_id: int = -1,
                            need_h: bool = True, need_e: bool = True,
                            chunk: int = BWD_CHUNK):
    """Plain version of the joint backward: (grad_hidden fp32 [N, D] or
    None, grad_embedding fp32 [V, D] or None), on the kernels' schedule:
    per ``chunk`` vocab columns, dlogits once, then grad_hidden += dl @
    e_chunk (chunks added in order) and grad_embedding[chunk] = dl.T @ h."""
    hf, ef = h.float(), e.float()
    live = tgt != ignore_id
    safe = torch.where(live, tgt, 0).long()
    gh = torch.zeros_like(hf) if need_h else None
    ge = torch.empty_like(ef) if need_e else None
    for v0 in range(0, ef.shape[0], chunk):
        ec = ef[v0:v0 + chunk]
        dl = torch.exp(hf @ ec.t() - lse[:, None])
        # - onehot: -1 at each live target in this chunk, -0 elsewhere
        # (no host sync, unlike indexing by the hits).
        hit = live & (safe >= v0) & (safe < v0 + ec.shape[0])
        col = (safe - v0).clamp(0, ec.shape[0] - 1)
        dl.scatter_add_(1, col[:, None], -hit[:, None].float())
        dl *= ds[:, None]
        if need_h:
            gh += dl @ ec
        if need_e:
            ge[v0:v0 + chunk] = dl.t() @ hf
    if need_h:
        plain_calls["xent_bwd_h"] += 1
    if need_e:
        plain_calls["xent_bwd_e"] += 1
    return gh, ge


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


def _round_up(x: int, to: int) -> int:
    return -(-x // to) * to


def backward_scratch(n: int, v: int, d: int, need_h: bool = True,
                     need_e: bool = True) -> tuple[dict, int]:
    """The backward kernels' fp32 scratch: ({name: shape}, chunk). h and
    E rounded to TF32 (h32, e32); for grad_hidden E^T [dp, vp] (et) and
    one chunk of dlogits [np, chunk] (dl); for grad_embedding h^T [dp,
    np] (ht) and the chunk transposed [chunk, np] (dlt). Rows pad to 128
    (np), vocab and depth to 256 (vp, dp). The last four lie in K-panels,
    [K / 32, rows, 32] for a [rows, K] operand contracted over K, so a
    kernel's 32-deep tile of rows is contiguous."""
    np_, vp, dp = _round_up(n, 128), _round_up(v, 256), _round_up(d, 256)
    chunk = min(BWD_CHUNK, vp)
    shapes = {"h32": (n, d), "e32": (v, d)}
    if need_h:
        shapes.update(et=(vp // 32, dp, 32), dl=(chunk // 32, np_, 32))
    if need_e:
        shapes.update(ht=(np_ // 32, dp, 32), dlt=(np_ // 32, chunk, 32))
    return shapes, chunk


def xent_backward_kernel(h, e, tgt, lse, ds, ignore_id: int = -1,
                         need_h: bool = True, need_e: bool = True,
                         library=None):
    """K4 and/or K5 on the card: (grad_hidden fp32 [N, D] or None,
    grad_embedding fp32 [V, D] or None). With both, one dl pass a chunk
    feeds both products; each wanted gradient counts one launch of its
    kernel."""
    if not (need_h or need_e):
        raise ValueError("the backward needs grad_hidden or grad_embedding")
    n, d, v = _check_inputs(h, e, tgt)
    dev = h.device
    _row_vector("lse", lse, n, dev)
    _row_vector("ds", ds, n, dev)
    lib = library or _build.library("chunked_loss")

    def empty(shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    gh = empty((n, d)) if need_h else None
    ge = empty((v, d)) if need_e else None
    shapes, chunk = backward_scratch(n, v, d, need_h, need_e)
    scratch = {name: empty(shape) for name, shape in shapes.items()}

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = lib.bs_xent_bwd(
        dev.index or 0, h.data_ptr(), e.data_ptr(), tgt.data_ptr(),
        lse.data_ptr(), ds.data_ptr(), ptr(gh), ptr(ge),
        *(ptr(scratch.get(name)) for name in
          ("h32", "e32", "et", "ht", "dl", "dlt")),
        n, v, d, DTYPE_CODES[h.dtype], ignore_id, chunk, stream_handle(dev))
    _build.check(rc, "cross-entropy backward (K4/K5)", lib)
    if need_h:
        launches["xent_bwd_h"] += 1
    if need_e:
        launches["xent_bwd_e"] += 1
    return gh, ge


def xent_backward_h_kernel(h, e, tgt, lse, ds, ignore_id: int = -1,
                           library=None):
    """K4 on the card: grad_hidden fp32 [N, D]."""
    return xent_backward_kernel(h, e, tgt, lse, ds, ignore_id,
                                need_e=False, library=library)[0]


def xent_backward_e_kernel(h, e, tgt, lse, ds, ignore_id: int = -1,
                           library=None):
    """K5 on the card: grad_embedding fp32 [V, D]."""
    return xent_backward_kernel(h, e, tgt, lse, ds, ignore_id,
                                need_h=False, library=library)[1]


def xent_forward(h, e, tgt, ignore_id: int = -1):
    if h.is_cuda:
        return xent_forward_kernel(h, e, tgt, ignore_id)
    return xent_forward_reference(h, e, tgt, ignore_id)


def xent_backward(h, e, tgt, lse, ds, ignore_id: int = -1,
                  need_h: bool = True, need_e: bool = True):
    if h.is_cuda:
        return xent_backward_kernel(h, e, tgt, lse, ds, ignore_id, need_h,
                                    need_e)
    return xent_backward_reference(h, e, tgt, lse, ds, ignore_id, need_h,
                                   need_e)


class _FusedXent(torch.autograd.Function):
    """Mean masked cross-entropy over [N, D] rows: K3 forward, K4 and K5
    backward (the reference's ``_xent_pallas`` custom_vjp); with a tp
    ``group``, vocab-parallel over this rank's rows of ``e`` (module
    doc)."""

    @staticmethod
    def forward(ctx, h, e, tgt, ignore_id: int, group):
        if h.is_cuda:
            tgt = tgt.to(torch.int32).contiguous()
        mask = (tgt != ignore_id).float()
        if group is not None:
            tgt = shard_targets(tgt, e.shape[0], group, ignore_id)
        lse, gold = xent_forward(h, e, tgt, ignore_id)
        if group is not None:
            lse, gold = merge_shards(lse, gold, group)
        count = torch.clamp(mask.sum(), min=1.0)
        ctx.save_for_backward(h, e, tgt, lse, mask, count)
        ctx.ignore_id, ctx.group = ignore_id, group
        return ((lse - gold) * mask).sum() / count

    @staticmethod
    def backward(ctx, g):
        h, e, tgt, lse, mask, count = ctx.saved_tensors
        ds = (g * mask / count).float().contiguous()
        need_h, need_e = ctx.needs_input_grad[:2]
        gh = ge = None
        if need_h or need_e:
            gh, ge = xent_backward(h, e, tgt, lse, ds, ctx.ignore_id, need_h,
                                   need_e)
        if gh is not None:
            if ctx.group is not None:
                with ring_collectives.call_site("loss"):
                    gh = ring_collectives.ring_all_reduce(gh, ctx.group)
            gh = gh.to(h.dtype)
        if ge is not None:
            ge = ge.to(e.dtype)
        return gh, ge, None, None, None


def chunked_softmax_xent(hidden, embedding, targets, ignore_id: int = -1,
                         impl: str = "auto", chunk_size: int = 128,
                         tp_group=None):
    """Mean cross-entropy of hidden @ embedding.T against targets, in
    fp32, over rows whose target is not ``ignore_id`` (0 when every row
    is ignored). hidden: [B, T, D] or [N, D]; embedding: [V, D]; targets
    matches hidden's leading shape; chunk_size counts rows of a plain
    slab. impl: 'auto' | 'kernel' | 'plain' (module doc). ``tp_group``: a
    tp RingGroup over which the loss is vocab-parallel, ``embedding``
    being this rank's rows (module doc); None or a ring of one: the whole
    vocabulary here."""
    if tp_group is not None and tp_group.size == 1:
        tp_group = None
    if hidden.dim() == 3:
        hidden = hidden.reshape(-1, hidden.shape[-1])
        targets = targets.reshape(-1)
    if impl == "auto":
        impl = kernel_select.resolve_auto(VALIDATION_NAME, hidden.device)
    if impl == "kernel":
        if hidden.shape[1] % 128 == 0:
            return _FusedXent.apply(hidden, embedding, targets, ignore_id,
                                    tp_group)
        impl = "plain"  # lane-misaligned width: the reference's own rule
    if impl != "plain":
        raise ValueError(f"unknown impl {impl!r}")
    return _xent_plain(hidden, embedding, targets, ignore_id, chunk_size,
                       tp_group)
