"""Per-row absmax int8 quantization of the KV cache (plain torch).

Counterpart of ``quantize_int8_rows`` / ``dequantize_int8`` in
batch_shipyard_tpu/ops/quantization.py, which are plain jnp there too
(not kernels). ``torch.round`` and ``jnp.round`` both round half to
even, so the int8 values match the reference exactly.
"""

from __future__ import annotations

import torch


def quantize_int8_rows(x: torch.Tensor, eps: float = 1e-8
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., D] -> (int8 rows [..., D], fp32 scales [...]) over the
    last axis."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1)
    scale = torch.clamp(absmax, min=eps) / 127.0
    rows = torch.round(xf / scale[..., None])
    return rows.to(torch.int8), scale


def dequantize_int8(values: torch.Tensor,
                    scales: torch.Tensor) -> torch.Tensor:
    return values.float() * scales
