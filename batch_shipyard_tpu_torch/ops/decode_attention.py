"""Dense int8 decode attention: the CUDA kernel and its plain PyTorch
version.

Counterpart of batch_shipyard_tpu/ops/decode_attention.py. The Pallas
kernel there (``_dense_decode_kernel_int8``, K8) becomes the dense
instantiation of the CUDA kernel in ``csrc/decode_attention.cu``: int8
K/V rows and their per-(position, head) fp32 scales are dequantized in
registers right before the dots, rows past each slot's length are never
read, and device memory holds int8 + scales only.
``dense_decode_attention_reference`` ports
``dense_decode_attention_xla`` (dequantize the whole cache to q.dtype,
then one masked softmax).

Contract: q [B, 1, H, D]; cache_k/cache_v [B, L, H, D] int8;
k_scales/v_scales [B, L, H] fp32; lengths [B] int32 valid-key counts
including the token written this step. A length-0 slot yields zeros.
Returns [B, 1, H, D] in q.dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops.paged_attention import (
    DTYPE_CODES, check_operand, check_query, masked_decode_softmax,
    stream_handle)

# Kernel launches (see paged_attention.launches).
launches = {"dense_decode_int8": 0}


def dense_decode_attention_kernel(q, cache_k, cache_v, k_scales,
                                  v_scales, lengths):
    """CUDA path (K8)."""
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
    lib = _build.library()
    out = torch.empty_like(q)
    rc = lib.bs_dense_decode_attention_int8(
        dev.index or 0, q.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), batch, rows, heads, depth,
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
