"""Fused RMSNorm + matmul: y = (rmsnorm(x) * scale) @ w, with the
normalized rows never stored.

Counterpart of batch_shipyard_tpu/ops/fused_norm.py. ``rmsnorm_matmul``
is one ``torch.autograd.Function``:

- forward: K9 (``csrc/fused_norm.cu``) for CUDA tensors; for CPU tensors
  its plain version ``rmsnorm_matmul_reference``, the composition of
  ``rmsnorm_ref`` (fp32 statistics, normalized rows cast to w's dtype)
  and one matmul with fp32 accumulation, output in x's dtype.
- backward: the reference's plain chain rule (its ``_rmsnorm_matmul_bwd``)
  on both devices, with ``torch.matmul`` for its two products dW = n^T g
  and dn = g W^T, which the reference also leaves outside the kernel.
  The products run in x's dtype (bf16 on the card, fp32 in the CPU
  tests) with fp32 accumulation, and the chain rule in fp32. In bf16, g
  and the cast W already hold bf16 values, so dn = g W^T is the fp32
  product up to summation order and the rounding of its output to bf16;
  in dW = n^T g only n rounds, as in the reference's f32 dots on its TPU
  at DEFAULT precision. A literal fp32 reading of the reference would
  cost ~14 TFLOP per training step on the card's 67 TFLOP/s fp32 path.

``impl``: None (K9 for CUDA tensors, the plain version for CPU tensors),
"kernel" (the same dispatch, named) or "plain" (the plain composition on
any device). On a CUDA tensor the kernel launches or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from batch_shipyard_tpu_torch.ops import _build
from batch_shipyard_tpu_torch.ops.paged_attention import stream_handle

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Kernel launches and calls of the plain forward; chip_smoke.py zeroes
# and reads these.
launches = {"rmsnorm_matmul": 0}
plain_calls = {"rmsnorm_matmul": 0}


def rmsnorm_ref(x, scale, eps: float = 1e-6):
    """RMSNorm with fp32 statistics, cast back to x.dtype."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * r * scale.float()).to(x.dtype)


def rmsnorm_matmul_reference(x, scale, w, eps: float = 1e-6):
    """Plain version of K9: normalized rows in w's dtype, the product
    accumulated in fp32, the output in x's dtype."""
    plain_calls["rmsnorm_matmul"] += 1
    n = rmsnorm_ref(x, scale, eps).to(w.dtype)
    return (n.float() @ w.float()).to(x.dtype)


def rmsnorm_matmul_kernel(x, scale, w, eps: float = 1e-6, library=None):
    """K9 on the card: x [M, K] and w [K, N] of one dtype (fp32 or bf16),
    scale fp32 [K] -> [M, N] in x's dtype. ``library``: the loaded build
    of csrc/fused_norm.cu to launch from (default: the checkout's)."""
    if not x.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors; CPU tensors "
                         "go to the plain version")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x [M, K] and w [K, N], got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if x.dtype not in DTYPE_CODES or w.dtype != x.dtype:
        raise ValueError(f"x and w must share a dtype in "
                         f"{tuple(DTYPE_CODES)}, got {x.dtype}, {w.dtype}")
    if k % 32 or n % 8:
        raise ValueError(f"K % 32 == 0 and N % 8 == 0, got K {k}, N {n}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (k,):
        raise ValueError(f"scale must be fp32 [{k}]")
    for name, t in (("x", x), ("scale", scale), ("w", w)):
        if t.device != x.device or not t.is_contiguous() or \
                t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous, 16-byte aligned "
                             f"and on {x.device}")
    dev = x.device
    lib = library or _build.library("fused_norm")
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    rstd = torch.empty(m, dtype=torch.float32, device=dev)  # per-row 1/rms
    rc = lib.bs_rmsnorm_matmul(dev.index or 0, x.data_ptr(),
                               scale.data_ptr(), w.data_ptr(),
                               out.data_ptr(), rstd.data_ptr(), m, n, k,
                               DTYPE_CODES[x.dtype], eps, stream_handle(dev))
    _build.check(rc, "rmsnorm matmul (K9)", lib)
    launches["rmsnorm_matmul"] += 1
    return out


def _forward(x, scale, w, eps: float, impl: Optional[str]):
    if impl not in (None, "kernel", "plain"):
        raise ValueError(f"unknown rmsnorm_matmul impl {impl!r}")
    if impl != "plain" and x.is_cuda:
        return rmsnorm_matmul_kernel(x, scale, w, eps)
    return rmsnorm_matmul_reference(x, scale, w, eps)


def _backward(x, scale, w, g, eps: float):
    """The reference's chain rule: products in x's dtype, the rest in
    fp32."""
    x32 = x.float()
    r = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    n = xhat * scale.float()
    g_c = g.to(x.dtype)
    dw = n.to(x.dtype).t() @ g_c
    dn = (g_c @ w.to(x.dtype).t()).float()
    dscale = (xhat * dn).sum(dim=0)
    dxhat = dn * scale.float()
    dx = r * (dxhat - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale.to(scale.dtype), dw.to(w.dtype)


class _RMSNormMatmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, w, eps: float, impl: Optional[str]):
        ctx.save_for_backward(x, scale, w)
        ctx.eps = eps
        return _forward(x, scale, w, eps, impl)

    @staticmethod
    def backward(ctx, g):
        x, scale, w = ctx.saved_tensors
        dx, dscale, dw = _backward(x, scale, w, g, ctx.eps)
        return dx, dscale, dw, None, None


def rmsnorm_matmul(x, scale, w, eps: float = 1e-6,
                   impl: Optional[str] = None):
    """y = (rmsnorm(x) * scale) @ w. x: [M, K] (callers flatten [B, T, K]
    to [B*T, K]); scale: fp32 [K]; w: [K, N]. Returns [M, N] in x.dtype
    with fp32 statistics and accumulation."""
    return _RMSNormMatmul.apply(x, scale, w, eps, impl)
