"""Int8 quantization: the KV cache's absmax rows, and the int8 training
lever's stochastic-rounding quantize (K10) and int8 matmul (K11).

Counterpart of batch_shipyard_tpu/ops/quantization.py.

- ``quantize_int8_rows`` / ``dequantize_int8``: plain torch, as they are
  plain jnp in the reference. ``torch.round`` and ``jnp.round`` both
  round half to even, so the int8 values match the reference exactly.
- ``quantize_int8(x, bits)``: per-row absmax int8 with unbiased
  stochastic rounding floor(x / scale + u), u from the low 24 bits of
  ``bits``. K10 (``csrc/quantization.cu``) for CUDA tensors, the plain
  version ``quantize_int8_reference`` for CPU tensors. The reference
  draws the bits inside its ``quantize_int8`` from
  ``jax.random.bits(PRNGKey(seed), (m, k))``; the port cannot draw
  JAX's threefry bits, so the bits are an explicit input, drawn by
  ``random_bits`` (a pure function of (seed, shape) on one device, as
  the reference's are). The scale is ``max(absmax, 1e-8) * (1/127)``, a
  multiply by the fp32 reciprocal: that is what XLA compiles the
  reference's ``/ 127.0`` into, bit for bit; x / scale stays an IEEE
  division.
- ``int8_matmul(x_q, x_scales, w_q, w_scales)``: [M, K] int8 times the
  weight's own [N, K] int8 rows (the reference's w_q.T) with exact int32
  accumulation, then (acc * x_scale[row]) * w_scale[col] in fp32. K11
  for CUDA tensors; the plain version ``int8_matmul_reference`` takes
  the product in float64, which is exact for these sums (|acc| <
  127^2 * K is far below 2^53), on either device: PyTorch has no int32
  matmul on CUDA, and an fp32 one is not exact past 2^24.
- ``quantized_linear(x, weight, seed)``: x [M, K] @ weight[N, K]^T with
  both sides quantized on the fly (x with ``seed``, the weight's rows
  with ``seed + 1``, as the reference quantizes w^T) and a
  full-precision backward, the reference's custom_vjp: dx = g W in fp32,
  cast to x's dtype; dW = g^T x in fp32, cast to W's dtype.

Under tensor parallelism (``quantized_linear``'s ``tp_group`` and
``split``) a rank holds a shard of the global product, and its int8
operands are the one-card run's bit for bit:

- the rounding bits are drawn at the shape the one-card product draws
  (the global weight, or x with K whole) and this rank's rows or columns
  taken from them (``shard_bits``);
- a column-parallel product (q/k/v/gate/up: x whole, the weight's rows
  split) quantizes with K10 as on one card: each row it scales is whole;
- a row-parallel product (o/down: x [M, K/tp], w [N, K/tp]) splits every
  row's absmax over the ranks. ``row_absmax`` (``bs_row_absmax``) takes
  this rank's part of each row's absmax for x and w, K13 all-gathers the
  [M + N] vector over the tp ring, the max over the ranks (exact) gives
  the one-card absmax, the scale is max(absmax, 1e-8) * (1/127) as K10
  writes it, and ``quantize_scaled`` (``bs_quantize_scaled``) rounds the
  shard with those scales. K11's fp32 output is then this rank's partial
  sum, which the model's g sums over the ring.

``impl``: None (the kernels for CUDA tensors, the plain versions for CPU
tensors), "kernel" (the same dispatch, named) or "plain" (the plain
versions on any device). On a CUDA tensor a kernel launches or raises.

The bits are drawn anew on every call (``bit_draws`` counts the draws):
they are a pure function of (seed, shape), so a cache keyed on (seed,
shape, device) would return the same tensors, but the port keeps no such
module-level state.
"""

from __future__ import annotations

from typing import Optional

import torch

from batch_shipyard_tpu_torch.ops import _build, ring_collectives
from batch_shipyard_tpu_torch.ops.paged_attention import stream_handle

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K10 holds a row in registers: 128 threads x 8 vectors of 16 bytes.
QUANTIZE_MAX_K = {torch.float32: 4096, torch.bfloat16: 8192}

# Kernel launches and calls of the plain versions; draws of random bits.
# chip_smoke.py zeroes and reads these.
launches = {"quantize_int8": 0, "int8_matmul": 0, "row_absmax": 0,
            "quantize_scaled": 0}
plain_calls = dict.fromkeys(launches, 0)
bit_draws = {"random_bits": 0}


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


def random_bits(seed: int, shape, device) -> torch.Tensor:
    """int32 random bits of ``shape`` on ``device`` from a
    torch.Generator seeded with ``seed``: the same tensor for the same
    (seed, shape, device)."""
    generator = torch.Generator(device=device).manual_seed(seed)
    bit_draws["random_bits"] += 1
    return torch.randint(-2 ** 31, 2 ** 31, tuple(shape), dtype=torch.int32,
                         generator=generator, device=device)


def shard_bits(seed: int, shape, device, group, dim: int) -> torch.Tensor:
    """This tp rank's part of the bits a one-card run draws: random_bits
    at ``shape`` with dim ``dim`` times the ring's size, then the rank's
    contiguous 1/size along it (a contiguous copy)."""
    full = list(shape)
    full[dim] *= group.size
    return random_bits(seed, full, device).chunk(
        group.size, dim)[group.rank].contiguous()


# ------------------------------ K10 ------------------------------------


def quantize_int8_reference(x, bits):
    """Plain version of K10: x [M, K] fp32 or bf16, bits int32 [M, K] ->
    (int8 [M, K], fp32 scales [M, 1])."""
    plain_calls["quantize_int8"] += 1
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) * (1.0 / 127.0)
    u = (bits & ((1 << 24) - 1)).float() * (1.0 / (1 << 24))
    rounded = torch.floor(xf / scale + u)
    return torch.clamp(rounded, -127.0, 127.0).to(torch.int8), scale


def _check_cuda(name: str, t, device, dtypes, shape) -> None:
    if t.device != device or t.dtype not in dtypes or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous() or \
            t.data_ptr() % 16:
        raise ValueError(
            f"{name}: want a contiguous, 16-byte aligned {tuple(shape)} "
            f"tensor of {dtypes} on {device}, got {tuple(t.shape)} "
            f"{t.dtype} on {t.device}")


def _check_rows(x) -> tuple[int, int]:
    """(M, K) of a kernel's x, or raise: a contiguous, 16-byte aligned
    CUDA [M, K] fp32 or bf16 tensor with K % 16 == 0."""
    if not x.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors; CPU tensors "
                         "go to the plain version")
    if x.dim() != 2 or x.dtype not in DTYPE_CODES:
        raise ValueError(f"x must be [M, K] fp32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    m, k = x.shape
    if k % 16:
        raise ValueError(f"K % 16 == 0, got K {k}")
    _check_cuda("x", x, x.device, (x.dtype,), (m, k))
    return m, k


def quantize_int8_kernel(x, bits, library=None):
    """K10 on the card: x [M, K] fp32 or bf16 with K % 16 == 0, bits int32
    [M, K] -> (int8 [M, K], fp32 scales [M, 1]). ``library``: the loaded
    build of csrc/quantization.cu to launch from (default: the
    checkout's)."""
    m, k = _check_rows(x)
    if k > QUANTIZE_MAX_K[x.dtype]:
        raise ValueError(f"K <= {QUANTIZE_MAX_K[x.dtype]} for {x.dtype}, "
                         f"got K {k}")
    dev = x.device
    _check_cuda("bits", bits, dev, (torch.int32,), (m, k))
    lib = library or _build.library("quantization")
    values = torch.empty((m, k), dtype=torch.int8, device=dev)
    scales = torch.empty((m, 1), dtype=torch.float32, device=dev)
    rc = lib.bs_quantize_int8(dev.index or 0, x.data_ptr(), bits.data_ptr(),
                              values.data_ptr(), scales.data_ptr(), m, k,
                              DTYPE_CODES[x.dtype], stream_handle(dev))
    _build.check(rc, "quantize_int8 (K10)", lib)
    launches["quantize_int8"] += 1
    return values, scales


def _dispatch(impl: Optional[str], t) -> bool:
    """True when the kernel takes this call."""
    if impl not in (None, "kernel", "plain"):
        raise ValueError(f"unknown quantization impl {impl!r}")
    return impl != "plain" and t.is_cuda


def quantize_int8(x, bits, impl: Optional[str] = None):
    """Per-row absmax int8 with stochastic rounding: x [M, K] -> (values
    int8 [M, K], scales fp32 [M, 1])."""
    if _dispatch(impl, x):
        return quantize_int8_kernel(x, bits)
    return quantize_int8_reference(x, bits)


# ------------- K10's two halves, for rows split over tp ranks -------------


def row_absmax_reference(x):
    """Plain version of bs_row_absmax: x [M, K] -> fp32 [M], each row's
    largest |x|."""
    plain_calls["row_absmax"] += 1
    return x.float().abs().amax(dim=-1)


def quantize_scaled_reference(x, bits, scales):
    """Plain version of bs_quantize_scaled: K10's rounding with given
    scales, x [M, K], bits int32 [M, K], scales fp32 [M] -> int8 [M, K]."""
    plain_calls["quantize_scaled"] += 1
    u = (bits & ((1 << 24) - 1)).float() * (1.0 / (1 << 24))
    rounded = torch.floor(x.float() / scales[:, None] + u)
    return torch.clamp(rounded, -127.0, 127.0).to(torch.int8)


def row_absmax_kernel(x, library=None):
    """bs_row_absmax on the card: x [M, K] fp32 or bf16, K % 16 == 0 ->
    fp32 [M]."""
    m, k = _check_rows(x)
    dev = x.device
    lib = library or _build.library("quantization")
    out = torch.empty(m, dtype=torch.float32, device=dev)
    rc = lib.bs_row_absmax(dev.index or 0, x.data_ptr(), out.data_ptr(), m,
                           k, DTYPE_CODES[x.dtype], stream_handle(dev))
    _build.check(rc, "row absmax", lib)
    launches["row_absmax"] += 1
    return out


def quantize_scaled_kernel(x, bits, scales, library=None):
    """bs_quantize_scaled on the card: x [M, K] fp32 or bf16, K % 16 ==
    0, bits int32 [M, K], scales fp32 [M] (contiguous) -> int8 [M, K]."""
    m, k = _check_rows(x)
    dev = x.device
    _check_cuda("bits", bits, dev, (torch.int32,), (m, k))
    if scales.device != dev or scales.dtype != torch.float32 or \
            tuple(scales.shape) != (m,) or not scales.is_contiguous():
        raise ValueError(f"scales: want a contiguous fp32 [{m}] on {dev}, "
                         f"got {tuple(scales.shape)} {scales.dtype} on "
                         f"{scales.device}")
    lib = library or _build.library("quantization")
    values = torch.empty((m, k), dtype=torch.int8, device=dev)
    rc = lib.bs_quantize_scaled(dev.index or 0, x.data_ptr(),
                                bits.data_ptr(), scales.data_ptr(),
                                values.data_ptr(), m, k,
                                DTYPE_CODES[x.dtype], stream_handle(dev))
    _build.check(rc, "quantize with scales", lib)
    launches["quantize_scaled"] += 1
    return values


def row_absmax(x, impl: Optional[str] = None):
    """Each row's largest |x|: x [M, K] -> fp32 [M]."""
    if _dispatch(impl, x):
        return row_absmax_kernel(x)
    return row_absmax_reference(x)


def quantize_scaled(x, bits, scales, impl: Optional[str] = None):
    """K10's stochastic rounding against given per-row scales: x [M, K]
    -> int8 [M, K]."""
    if _dispatch(impl, x):
        return quantize_scaled_kernel(x, bits, scales)
    return quantize_scaled_reference(x, bits, scales)


def quantize_split_rows(x, x_bits, w, w_bits, group,
                        impl: Optional[str] = None):
    """A row-parallel product's int8 operands (the module doc): x [M,
    K/tp] and w [N, K/tp] with their bits -> (x_q, x_scales [M, 1], w_q,
    w_scales [N, 1]), the scales of the whole rows, found by one K13
    all-gather of this rank's [M + N] absmax parts over ``group``."""
    m = x.shape[0]
    part = torch.cat([row_absmax(x, impl), row_absmax(w, impl)])
    with ring_collectives.call_site("absmax"):
        gathered = ring_collectives.ring_all_gather(part, group)
    absmax = gathered.view(group.size, -1).amax(dim=0)
    scales = torch.clamp(absmax, min=1e-8) * (1.0 / 127.0)
    x_s, w_s = scales[:m].clone(), scales[m:].clone()
    return (quantize_scaled(x, x_bits, x_s, impl), x_s[:, None],
            quantize_scaled(w, w_bits, w_s, impl), w_s[:, None])


# ------------------------------ K11 ------------------------------------


def int8_matmul_reference(x_q, x_scales, w_q, w_scales):
    """Plain version of K11: x_q [M, K] int8, w_q [N, K] int8, scales fp32
    [M, 1] and [N, 1] -> fp32 [M, N], the sums exact in float64."""
    plain_calls["int8_matmul"] += 1
    acc = (x_q.double() @ w_q.double().t()).float()
    return acc * x_scales * w_scales.t()


def int8_matmul_kernel(x_q, x_scales, w_q, w_scales, library=None):
    """K11 on the card: x_q [M, K] and w_q [N, K] int8 with K % 16 == 0,
    x_scales [M, 1], w_scales [N, 1] fp32 -> fp32 [M, N]."""
    if not x_q.is_cuda:
        raise ValueError("the CUDA kernel takes CUDA tensors; CPU tensors "
                         "go to the plain version")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[1]:
        raise ValueError(f"x_q [M, K] and w_q [N, K], got "
                         f"{tuple(x_q.shape)} and {tuple(w_q.shape)}")
    (m, k), n = x_q.shape, w_q.shape[0]
    if k % 16:
        raise ValueError(f"K % 16 == 0, got K {k}")
    dev = x_q.device
    _check_cuda("x_q", x_q, dev, (torch.int8,), (m, k))
    _check_cuda("w_q", w_q, dev, (torch.int8,), (n, k))
    _check_cuda("x_scales", x_scales, dev, (torch.float32,), (m, 1))
    _check_cuda("w_scales", w_scales, dev, (torch.float32,), (n, 1))
    lib = library or _build.library("quantization")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    rc = lib.bs_int8_matmul(dev.index or 0, x_q.data_ptr(),
                            x_scales.data_ptr(), w_q.data_ptr(),
                            w_scales.data_ptr(), out.data_ptr(), m, n, k,
                            stream_handle(dev))
    _build.check(rc, "int8_matmul (K11)", lib)
    launches["int8_matmul"] += 1
    return out


def int8_matmul(x_q, x_scales, w_q, w_scales, impl: Optional[str] = None):
    """x_q [M, K] int8 @ w_q[N, K]^T int8 -> fp32 [M, N] with int32
    accumulation and per-row / per-column scales."""
    if _dispatch(impl, x_q):
        return int8_matmul_kernel(x_q, x_scales, w_q, w_scales)
    return int8_matmul_reference(x_q, x_scales, w_q, w_scales)


# --------------------------- quantized_linear --------------------------


class _QuantizedLinear(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, weight, seed: int, impl: Optional[str], group,
                split: Optional[str]):
        ctx.save_for_backward(x, weight)
        if split == "row":
            x_q, x_s, w_q, w_s = quantize_split_rows(
                x, shard_bits(seed, x.shape, x.device, group, 1), weight,
                shard_bits(seed + 1, weight.shape, weight.device, group, 1),
                group, impl)
            return int8_matmul(x_q, x_s, w_q, w_s, impl)
        x_q, x_s = quantize_int8(x, random_bits(seed, x.shape, x.device),
                                 impl)
        w_bits = (random_bits(seed + 1, weight.shape, weight.device)
                  if split is None else
                  shard_bits(seed + 1, weight.shape, weight.device, group, 0))
        w_q, w_s = quantize_int8(weight, w_bits, impl)
        return int8_matmul(x_q, x_s, w_q, w_s, impl)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = g.float()
        dx = (g @ weight.float()).to(x.dtype)
        dw = (g.t() @ x.float()).to(weight.dtype)
        return dx, dw, None, None, None, None


def quantized_linear(x, weight, seed: int = 0, impl: Optional[str] = None,
                     tp_group=None, split: Optional[str] = None):
    """x [M, K] @ weight[N, K]^T -> fp32 [M, N], both operands int8
    quantized on the fly; full-precision straight-through backward. Under
    tp (a ``tp_group`` of more than one rank) ``split`` says which side
    the rank holds a shard of: "column" (weight rows: N is N/tp) or "row"
    (K is K/tp; the output is this rank's partial sum)."""
    if tp_group is None or tp_group.size == 1:
        split = None
    elif split not in ("column", "row"):
        raise ValueError(f"a tp product is split 'column' or 'row', got "
                         f"{split!r}")
    return _QuantizedLinear.apply(x, weight, seed, impl, tp_group, split)
