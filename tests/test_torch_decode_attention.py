"""The port's plain K6/K7/K8 versions (the CPU path of its decode
attention; the CUDA kernels replace them on the card) against the JAX
package: its XLA formulations and its Pallas kernels in interpret mode,
run as tests/test_paged_attention.py runs them. Inputs come from numpy
seeds. Tolerances: fp32 1e-5; bf16 2e-2; int8 pages against the XLA
int8 path 2e-5 (same dequantization) and against the Pallas kernel
2e-2 for bf16 queries (the kernel dequantizes to fp32, the XLA form to
q.dtype). Length-0 slots are held to the kernel contract (zeros),
never to the XLA path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from batch_shipyard_tpu.ops import decode_attention as jdd
from batch_shipyard_tpu.ops import paged_attention as jpa
from batch_shipyard_tpu.ops import quantization as jqz
from batch_shipyard_tpu_torch.ops import decode_attention as tdd
from batch_shipyard_tpu_torch.ops import paged_attention as tpa
from batch_shipyard_tpu_torch.ops import quantization as tqz

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LENGTHS = [1, 8, 9, 48, 0]          # 1, a page boundary, full, empty


@pytest.fixture()
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _paged_case(seed, dtype, heads=4, depth=64, page=8, max_blocks=6,
                num_pages=40):
    rng = np.random.RandomState(seed)
    batch = len(LENGTHS)
    q = rng.randn(batch, 1, heads, depth).astype(np.float32)
    k = rng.randn(num_pages, page, heads, depth).astype(np.float32)
    v = rng.randn(num_pages, page, heads, depth).astype(np.float32)
    table = rng.permutation(num_pages)[:batch * max_blocks].reshape(
        batch, max_blocks).astype(np.int32)
    lengths = np.asarray(LENGTHS, np.int32)
    if dtype == "bfloat16":
        # Round once through bf16 so both frameworks see equal values.
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    return q, k, v, table, lengths


def _jax(a, dtype):
    return jnp.asarray(a, getattr(jnp, dtype))


def _torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        getattr(torch, dtype))


def _as_np(t):
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor)
                      else np.asarray(t, np.float32))


def _close(got, want, tol, live):
    np.testing.assert_allclose(_as_np(got)[live], _as_np(want)[live],
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_reference_matches_xla_and_kernel(interpret_mode, dtype):
    q, k, v, table, lengths = _paged_case(0, dtype)
    live = lengths > 0
    got = tpa.paged_decode_attention(
        _torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
        torch.from_numpy(table), torch.from_numpy(lengths))
    assert got.dtype == getattr(torch, dtype)
    args = (_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
            jnp.asarray(table), jnp.asarray(lengths))
    _close(got, jpa.paged_decode_attention_xla(*args), TOL[dtype], live)
    kernel = jpa.paged_decode_attention_kernel(*args)
    _close(got, kernel, TOL[dtype], slice(None))
    assert not _as_np(got)[~live].any()       # length 0 -> zeros


def test_paged_reference_ignores_dead_table_tail():
    """Stale ids past a slot's live pages must not change the output."""
    q, k, v, table, lengths = _paged_case(2, "float32")
    want = tpa.paged_decode_attention_reference(
        *map(torch.from_numpy, (q, k, v, table, lengths)))
    poisoned = table.copy()
    for b, n in enumerate(lengths):
        poisoned[b, -(-int(n) // 8):] = 0
    got = tpa.paged_decode_attention_reference(
        *map(torch.from_numpy, (q, k, v, poisoned, lengths)))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _int8(k, v):
    kq, ks = tqz.quantize_int8_rows(torch.from_numpy(k))
    vq, vs = tqz.quantize_int8_rows(torch.from_numpy(v))
    return kq, vq, ks, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_int8_reference_matches_xla_and_kernel(interpret_mode,
                                                     dtype):
    q, k, v, table, lengths = _paged_case(4, dtype)
    live = lengths > 0
    kq, vq, ks, vs = _int8(k, v)
    got = tpa.paged_decode_attention(
        _torch(q, dtype), kq, vq, torch.from_numpy(table),
        torch.from_numpy(lengths), k_scales=ks, v_scales=vs)
    jargs = (_jax(q, dtype), jnp.asarray(kq.numpy()),
             jnp.asarray(vq.numpy()), jnp.asarray(table),
             jnp.asarray(lengths))
    scales = dict(k_scales=jnp.asarray(ks.numpy()),
                  v_scales=jnp.asarray(vs.numpy()))
    same_math = 2e-5 if dtype == "float32" else 2e-2
    _close(got, jpa.paged_decode_attention_xla(*jargs, **scales),
           same_math, live)
    kernel = jpa.paged_decode_attention_kernel(*jargs, **scales)
    _close(got, kernel, same_math, slice(None))
    assert not _as_np(got)[~live].any()


def _dense_case(seed, dtype, heads=4, depth=64, length=48):
    rng = np.random.RandomState(seed)
    batch = len(LENGTHS)
    q = rng.randn(batch, 1, heads, depth).astype(np.float32)
    if dtype == "bfloat16":
        q = np.asarray(jnp.asarray(q, jnp.bfloat16), np.float32)
    k = rng.randn(batch, length, heads, depth).astype(np.float32)
    v = rng.randn(batch, length, heads, depth).astype(np.float32)
    return q, k, v, np.asarray(LENGTHS, np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_int8_reference_matches_xla_and_kernel(dtype):
    q, k, v, lengths = _dense_case(6, dtype)
    live = lengths > 0
    kq, vq, ks, vs = _int8(k, v)
    got = tdd.dense_decode_attention(
        _torch(q, dtype), kq, vq, ks, vs, torch.from_numpy(lengths))
    assert got.dtype == getattr(torch, dtype)
    jargs = (_jax(q, dtype), jnp.asarray(kq.numpy()),
             jnp.asarray(vq.numpy()), jnp.asarray(ks.numpy()),
             jnp.asarray(vs.numpy()), jnp.asarray(lengths))
    same_math = 2e-5 if dtype == "float32" else 2e-2
    _close(got, jdd.dense_decode_attention_xla(*jargs), same_math, live)
    kernel = jdd.dense_decode_attention_kernel(*jargs, interpret=True)
    _close(got, kernel, same_math, slice(None))
    assert not _as_np(got)[~live].any()


@pytest.mark.parametrize("shape", [(3, 64), (2, 5, 4, 32), (7, 1)])
def test_quantize_int8_rows_exact(shape):
    """int8 rows and scales equal the reference's bit for bit (both
    round half to even); dequantize likewise."""
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 3).astype(np.float32)
    x.flat[0] = 0.5 * x.flat[1]          # exercise ties near .5 steps
    jq, js = jqz.quantize_int8_rows(jnp.asarray(x))
    tq, ts = tqz.quantize_int8_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tqz.dequantize_int8(tq, ts[..., None]).numpy(),
        np.asarray(jqz.dequantize_int8(jq, js[..., None])))


def test_dispatch_uses_reference_on_cpu_and_kernel_refuses_cpu():
    q, k, v, table, lengths = map(torch.from_numpy,
                                  _paged_case(8, "float32"))
    before = dict(tpa.launches)
    auto = tpa.paged_decode_attention(q, k, v, table, lengths)
    ref = tpa.paged_decode_attention_reference(q, k, v, table, lengths)
    torch.testing.assert_close(auto, ref, rtol=0, atol=0)
    assert tpa.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tpa.paged_decode_attention(q, k, v, table, lengths, impl="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tdd.dense_decode_attention_kernel(
            q, k.to(torch.int8), v.to(torch.int8), k[..., 0], v[..., 0],
            lengths)
    with pytest.raises(ValueError, match="impl"):
        tpa.paged_decode_attention(q, k, v, table, lengths, impl="xla")
