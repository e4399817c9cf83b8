"""Dense int8 decode attention: the CUDA kernel and its plain PyTorch
version.

Counterpart of batch_shipyard_tpu/ops/decode_attention.py. The Pallas
kernel there (``_dense_decode_kernel_int8``, K8) becomes the dense
entry of the split-sequence cluster kernel in
``csrc/decode_attention.cu`` (``dense_decode_cluster_kernel``): each
(slot, head) is split over a cluster of ``dense_splits(L)`` blocks, each
block reads one contiguous run of boxes of ``DENSE_TILE_ROWS`` rows of
the slot's live rows through TMA, dequantizes the int8 K/V rows with
their per-(position, head) fp32 scales right at the dots, and the blocks
merge through distributed shared memory. Rows past each slot's length
are never used, and device memory holds int8 + scales only.
``dense_decode_attention_reference`` ports ``dense_decode_attention_xla``
(dequantize the whole cache to q.dtype, then one masked softmax);
``dense_decode_attention_split`` is the cluster's math in plain PyTorch.

Contract: q [B, 1, H, D]; cache_k/cache_v [B, L, H, D] int8;
k_scales/v_scales [B, L, H] fp32; lengths [B] int32 valid-key counts
including the token written this step. A length-0 slot yields zeros.
Returns [B, 1, H, D] in q.dtype.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops.paged_attention import (
    DTYPE_CODES, check_operand, check_query, masked_decode_softmax,
    paged_splits, stream_handle)

# Kernel launches (see paged_attention.launches).
launches = {"dense_decode_int8": 0}
# Rows of a unit of the dense cache: one TMA box, and the granule in
# which a slot's live rows are cut into the cluster's runs. 128 (2 splits
# at 512 keys) against 64 (4 splits): 0.3-1.1 µs faster at uniform lengths
# of 32-128 keys (a slot of one unit is rank 0's alone), 0.5 µs slower at
# 160, within 0.15 µs at 200-512 keys and at the served mix
# (trace/decode_sweep.py --dense-variant 4x64 on one H100).
DENSE_TILE_ROWS = 128


def dense_tile_rows(rows: int) -> int:
    """Rows of a unit for a cache of ``rows`` positions (a box never
    reaches past the cache)."""
    return min(DENSE_TILE_ROWS, rows)


def dense_splits(rows: int) -> int:
    """Blocks the cluster kernel splits each (slot, head) over for a
    cache of ``rows`` positions: paged_splits' rule over units of
    dense_tile_rows rows (at most two units a block, a power of two at
    most MAX_SPLITS; 2 at the served 512 keys)."""
    return paged_splits(-(-rows // dense_tile_rows(rows)))


def dense_decode_plan(depth: int, rows: int) -> dict:
    """The cluster kernel's launch plan for a dense cache of ``rows``
    positions (from the library): splits a (slot, head), ring stages,
    bytes a stage, dynamic shared memory a block and rows of a TMA
    box."""
    lib = _build.library()
    splits = dense_splits(rows)
    plan = (ctypes.c_int * 4)()
    _build.check(lib.bs_dense_decode_plan(depth, rows, dense_tile_rows(rows),
                                          splits, plan),
                 "dense decode plan", lib)
    return {"splits": splits, "stages": plan[0], "stage_bytes": plan[1],
            "dynamic_smem_bytes": plan[2], "tile_rows": plan[3]}


def dense_decode_attention_kernel(q, cache_k, cache_v, k_scales,
                                  v_scales, lengths, library=None,
                                  splits: Optional[int] = None,
                                  tile_rows: Optional[int] = None):
    """CUDA path (K8). ``library`` swaps in another build of
    csrc/decode_attention.cu (chip_smoke's planted faults); ``splits``
    and ``tile_rows`` override dense_splits and dense_tile_rows
    (trace/decode_sweep.py's variants)."""
    batch, heads, depth = check_query(q)
    rows = cache_k.shape[1]
    dev = q.device
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        check_operand(name, t, dev, (torch.int8,),
                      (batch, rows, heads, depth))
    for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
        check_operand(name, t, dev, (torch.float32,),
                      (batch, rows, heads))
    check_operand("lengths", lengths, dev, (torch.int32,), (batch,))
    lib = library or _build.library()
    out = torch.empty_like(q)
    rc = lib.bs_dense_decode_attention_int8(
        dev.index or 0, q.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), batch, rows, heads, depth,
        splits or dense_splits(rows), tile_rows or dense_tile_rows(rows),
        DTYPE_CODES[q.dtype], 1.0 / depth ** 0.5, stream_handle(dev))
    _build.check(rc, "dense int8 decode attention", lib)
    launches["dense_decode_int8"] += 1
    return out


def dense_decode_attention_reference(q, cache_k, cache_v, k_scales,
                                     v_scales, lengths):
    """Plain torch port of ``dense_decode_attention_xla``: dequantize
    the whole cache to q.dtype, then one masked softmax. Length-0 slots
    are zeroed to match the kernel contract."""
    if q.shape[1] != 1:
        raise ValueError("decode consumes one token per call")
    k_all = (cache_k.float() * k_scales[..., None]).to(q.dtype)
    v_all = (cache_v.float() * v_scales[..., None]).to(q.dtype)
    return masked_decode_softmax(q, k_all, v_all, lengths)


def dense_decode_attention_split(q, cache_k, cache_v, k_scales,
                                 v_scales, lengths, splits: int,
                                 tile_rows: int = DENSE_TILE_ROWS):
    """The cluster kernel's math in plain PyTorch: each slot's live rows
    cut into units of ``tile_rows`` and the units into ``splits``
    contiguous runs of ceil(units / splits), one softmax per run giving
    (m, l, acc) (int8 rows dequantized to fp32: the K scale applied to
    the score, the V scale to p; fp32 scores and sums), the runs merged
    in rank order. Empty runs contribute nothing; a length-0 slot yields
    zeros. Reads lengths on the host: a plain version, not a path."""
    batch, seq, heads, depth = q.shape
    if seq != 1:
        raise ValueError("decode consumes one token per call")
    cap = cache_k.shape[1]
    scale = 1.0 / depth ** 0.5
    out = torch.zeros((batch, 1, heads, depth), dtype=torch.float32,
                      device=q.device)
    for b in range(batch):
        n = min(max(int(lengths[b]), 0), cap)
        units = -(-n // tile_rows)
        per = -(-units // splits)
        parts = []
        for rank in range(splits):
            u0 = min(units, rank * per)
            r0, r1 = u0 * tile_rows, min(n, min(units, u0 + per) * tile_rows)
            if r1 <= r0:
                continue
            k = cache_k[b, r0:r1].float()
            v = cache_v[b, r0:r1].float()
            s = torch.einsum("hd,thd->ht", q[b, 0].float(), k) * scale
            s = s * k_scales[b, r0:r1].T
            m = s.amax(dim=-1)
            p = torch.exp(s - m[:, None])
            l = p.sum(dim=-1)
            p = p * v_scales[b, r0:r1].T
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


def dense_decode_attention(q, cache_k, cache_v, k_scales, v_scales,
                           lengths, impl: Optional[str] = None):
    """Dispatch as in paged_attention.paged_decode_attention: the kernel
    for CUDA tensors, the plain version for CPU tensors, unless
    ``impl`` ("kernel" | "reference") says otherwise."""
    if impl is None:
        impl = "kernel" if q.is_cuda else "reference"
    if impl == "kernel":
        return dense_decode_attention_kernel(
            q, cache_k, cache_v, k_scales, v_scales, lengths)
    if impl == "reference":
        return dense_decode_attention_reference(
            q, cache_k, cache_v, k_scales, v_scales, lengths)
    raise ValueError(f"unknown dense decode attention impl {impl!r}")
