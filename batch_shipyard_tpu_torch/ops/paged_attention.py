"""Paged decode attention (vLLM-style block tables): the CUDA kernel
and its plain PyTorch version.

Counterpart of batch_shipyard_tpu/ops/paged_attention.py. The Pallas
kernels there (``_paged_decode_kernel``, K6, and
``_paged_decode_kernel_int8``, K7) become one hand-written CUDA kernel
for Hopper (``paged_decode_cluster_kernel`` in
``csrc/decode_attention.cu``): each (slot, head) is split over a
cluster of ``paged_splits(max_blocks)`` blocks, each block reads one
contiguous run of the slot's live pages through TMA, and the blocks
merge their (max, denominator, numerator) through distributed shared
memory. ``paged_decode_attention_reference`` ports the XLA gather
formulation (``paged_decode_attention_xla``): it materializes each
slot's full logical view, then one masked softmax.
``paged_decode_attention_split`` is the cluster's math in plain
PyTorch (per-split softmax over contiguous page runs, merged in rank
order), held against the JAX package by the CPU tests.

Contract (both versions): q [B, 1, H, D]; k_pages/v_pages
[P, page, H, D]; block_table [B, max_blocks] int32; lengths [B] int32
valid-key counts including the token written this step. A length-0
slot yields zeros (the kernel contract; the reference XLA path returns
softmax-of-all-masked garbage there). With int8 pages, k_scales and
v_scales are [P, page, H] fp32. Returns [B, 1, H, D] in q.dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from batch_shipyard_tpu_torch.ops import _build

_NEG_INF = -1e30
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
SUPPORTED_DEPTHS = (16, 32, 64, 128, 256)

# Kernel launches by kernel name: each wrapper adds one where it
# launches, and nowhere else (chip_smoke.py zeroes and reads these).
launches = {"paged_decode": 0, "paged_decode_int8": 0}
# Blocks a (slot, head) at most: the portable thread-block cluster size.
MAX_SPLITS = 8


def paged_splits(max_blocks: int) -> int:
    """Blocks the cluster kernel splits each (slot, head) over: the
    smallest power of two that leaves at most two of the table's
    ``max_blocks`` pages to a block, capped at MAX_SPLITS (4 at the
    served 512 keys over pages of 64)."""
    splits = 1
    while splits < MAX_SPLITS and 2 * splits < max_blocks:
        splits *= 2
    return splits


def check_operand(name: str, t: torch.Tensor, device: torch.device,
                  dtypes: tuple, shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on ``device`` of
    one of ``dtypes`` and ``shape`` (None entries match any size),
    16-byte aligned for the kernel's vector loads."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def check_query(q: torch.Tensor) -> tuple[int, int, int]:
    if not q.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors; CPU "
                         "tensors go to the plain reference version")
    batch, seq, heads, depth = q.shape
    if seq != 1:
        raise ValueError("decode consumes one token per call")
    if depth not in SUPPORTED_DEPTHS:
        raise ValueError(f"head depth {depth} not in "
                         f"{SUPPORTED_DEPTHS}")
    check_operand("q", q, q.device, (torch.float32, torch.bfloat16),
                  (batch, 1, heads, depth))
    return batch, heads, depth


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def paged_decode_plan(depth: int, page: int, max_blocks: int,
                      kv_dtype: torch.dtype) -> dict:
    """The cluster kernel's launch plan for these shapes (from the
    library): splits a (slot, head), ring stages, bytes a stage, dynamic
    shared memory a block and rows of a TMA box."""
    lib = _build.library()
    splits = paged_splits(max_blocks)
    plan = (ctypes.c_int * 4)()
    _build.check(lib.bs_paged_decode_plan(depth, page, max_blocks, splits,
                                          DTYPE_CODES[kv_dtype], plan),
                 "paged decode plan", lib)
    return {"splits": splits, "stages": plan[0], "stage_bytes": plan[1],
            "dynamic_smem_bytes": plan[2], "tile_rows": plan[3]}


def paged_decode_attention_kernel(q, k_pages, v_pages, block_table,
                                  lengths, k_scales=None,
                                  v_scales=None, library=None):
    """CUDA path (K6, or K7 when the pages are int8 with scales).
    ``library`` swaps in another build of csrc/decode_attention.cu
    (chip_smoke's planted faults)."""
    batch, heads, depth = check_query(q)
    int8_pages = k_scales is not None
    num_pages, page = k_pages.shape[0], k_pages.shape[1]
    max_blocks = block_table.shape[1]
    kv_dtypes = (torch.int8,) if int8_pages else (q.dtype,)
    dev = q.device
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        check_operand(name, t, dev, kv_dtypes,
                      (num_pages, page, heads, depth))
    if int8_pages:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            check_operand(name, t, dev, (torch.float32,),
                          (num_pages, page, heads))
    check_operand("block_table", block_table, dev, (torch.int32,),
                  (batch, max_blocks))
    check_operand("lengths", lengths, dev, (torch.int32,), (batch,))
    lib = library or _build.library()
    out = torch.empty_like(q)
    rc = lib.bs_paged_decode_attention(
        dev.index or 0, q.data_ptr(), k_pages.data_ptr(),
        v_pages.data_ptr(),
        k_scales.data_ptr() if int8_pages else None,
        v_scales.data_ptr() if int8_pages else None,
        block_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        batch, heads, depth, page, max_blocks, num_pages,
        paged_splits(max_blocks), DTYPE_CODES[q.dtype],
        DTYPE_CODES[k_pages.dtype], 1.0 / depth ** 0.5,
        stream_handle(dev))
    _build.check(rc, "paged decode attention", lib)
    launches["paged_decode_int8" if int8_pages else "paged_decode"] += 1
    return out


def paged_decode_attention_reference(q, k_pages, v_pages, block_table,
                                     lengths, k_scales=None,
                                     v_scales=None):
    """Plain torch port of ``paged_decode_attention_xla``: gather every
    slot's full [max_blocks*page, H, D] view, then one masked softmax
    (with int8 pages only the gathered slices dequantize, to q.dtype).
    Length-0 slots are zeroed to match the kernel contract."""
    batch, seq, heads, depth = q.shape
    if seq != 1:
        raise ValueError("decode consumes one token per call")
    page = k_pages.shape[1]
    max_blocks = block_table.shape[1]
    table = block_table.long()
    k_all = k_pages[table].reshape(batch, max_blocks * page, heads, depth)
    v_all = v_pages[table].reshape(batch, max_blocks * page, heads, depth)
    if k_scales is not None:
        ks = k_scales[table].reshape(batch, max_blocks * page, heads)
        vs = v_scales[table].reshape(batch, max_blocks * page, heads)
        k_all = (k_all.float() * ks[..., None]).to(q.dtype)
        v_all = (v_all.float() * vs[..., None]).to(q.dtype)
    return masked_decode_softmax(q, k_all, v_all, lengths)


def paged_decode_attention_split(q, k_pages, v_pages, block_table,
                                 lengths, splits: int, k_scales=None,
                                 v_scales=None):
    """The cluster kernel's math in plain PyTorch: each slot's live
    pages cut into ``splits`` contiguous runs of ceil(pages / splits),
    one softmax per run giving (m, l, acc) (fp32 scores and sums; p
    rounded to bf16 before P.V for bf16 pages; int8 pages dequantized to
    fp32, the scales applied to the score and to p), the runs merged in
    rank order. Empty runs contribute nothing; a length-0 slot yields
    zeros. Reads lengths on the host: a plain version, not a path."""
    batch, seq, heads, depth = q.shape
    if seq != 1:
        raise ValueError("decode consumes one token per call")
    page = k_pages.shape[1]
    cap = block_table.shape[1] * page
    scale = 1.0 / depth ** 0.5
    round_p = k_pages.dtype == torch.bfloat16
    out = torch.zeros((batch, 1, heads, depth), dtype=torch.float32,
                      device=q.device)
    for b in range(batch):
        n = min(max(int(lengths[b]), 0), cap)
        pages = -(-n // page)
        per = -(-pages // splits)
        parts = []
        for rank in range(splits):
            p0 = min(pages, rank * per)
            p1 = min(pages, p0 + per)
            rows = max(0, min(n, p1 * page) - p0 * page)
            if rows == 0:
                continue
            ids = block_table[b, p0:p1].long()
            k = k_pages[ids].reshape(-1, heads, depth)[:rows].float()
            v = v_pages[ids].reshape(-1, heads, depth)[:rows].float()
            s = torch.einsum("hd,thd->ht", q[b, 0].float(), k) * scale
            if k_scales is not None:
                s = s * k_scales[ids].reshape(-1, heads)[:rows].T
            m = s.amax(dim=-1)
            p = torch.exp(s - m[:, None])
            l = p.sum(dim=-1)
            if k_scales is not None:
                p = p * v_scales[ids].reshape(-1, heads)[:rows].T
            elif round_p:
                p = p.to(torch.bfloat16).float()
            parts.append((m, l, torch.einsum("ht,thd->hd", p, v)))
        if not parts:
            continue
        big = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        num = torch.zeros((heads, depth), device=q.device)
        den = torch.zeros((heads,), device=q.device)
        for m, l, acc in parts:
            w = torch.exp(m - big)
            den = den + w * l
            num = num + w[:, None] * acc
        out[b, 0] = num / den[:, None]
    return out.to(q.dtype)


def masked_attention(q, k_all, v_all, mask):
    """softmax(q k^T / sqrt(D)) v of q [B, S, H, D] over keys
    [B, T, H, D] where ``mask`` (broadcast to [B, 1, S, T]) holds, the
    XLA formulation's precision: fp32 scores, masked with -1e30,
    probabilities cast to q.dtype before the fp32-accumulated P.V,
    output in q.dtype."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k_all.float())
    scores = scores / math.sqrt(q.shape[-1])
    scores = torch.where(mask, scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(q.dtype).float(),
                       v_all.float())
    return out.to(q.dtype)


def masked_decode_softmax(q, k_all, v_all, lengths):
    """One-query ``masked_attention`` with keys at positions >= length
    masked. Length-0 slots return zeros (the kernel contract)."""
    key_pos = torch.arange(k_all.shape[1], device=q.device)
    mask = (key_pos[None, :] < lengths[:, None])[:, None, None, :]
    out = masked_attention(q, k_all, v_all, mask)
    return torch.where((lengths > 0)[:, None, None, None], out, 0.0)


def paged_decode_attention(q, k_pages, v_pages, block_table, lengths,
                           impl: Optional[str] = None,
                           k_scales=None, v_scales=None):
    """Dispatch: ``impl=None`` launches the CUDA kernel for CUDA tensors
    and takes the plain version for CPU tensors; ``"kernel"`` or
    ``"reference"`` forces one (the kernel raises on CPU tensors).
    k_scales/v_scales switch both to int8 pages."""
    if impl is None:
        impl = "kernel" if q.is_cuda else "reference"
    if impl == "kernel":
        return paged_decode_attention_kernel(
            q, k_pages, v_pages, block_table, lengths,
            k_scales=k_scales, v_scales=v_scales)
    if impl == "reference":
        return paged_decode_attention_reference(
            q, k_pages, v_pages, block_table, lengths,
            k_scales=k_scales, v_scales=v_scales)
    raise ValueError(f"unknown paged attention impl {impl!r}")
