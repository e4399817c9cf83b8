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


# The cluster kernel's split schedule (paged_decode_attention_split): the
# slot's live pages cut into `splits` contiguous runs, one softmax each,
# merged in rank order. Lengths: empty, 1, a page, a page + 1, full (6
# pages of 8), and two ragged ones; splits 1-8 leave some runs empty.
SPLIT_LENGTHS = [0, 1, 8, 9, 48, 30, 17]


def _split_case(dtype, int8):
    rng = np.random.RandomState(11)
    batch, heads, depth, page, max_blocks = len(SPLIT_LENGTHS), 4, 32, 8, 6
    num_pages = batch * max_blocks + 3
    q = rng.randn(batch, 1, heads, depth).astype(np.float32)
    k = rng.randn(num_pages, page, heads, depth).astype(np.float32)
    v = rng.randn(num_pages, page, heads, depth).astype(np.float32)
    table = rng.permutation(num_pages)[:batch * max_blocks].reshape(
        batch, max_blocks).astype(np.int32)
    if dtype == "bfloat16":
        q, k, v = (np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
                   for a in (q, k, v))
    lengths = np.asarray(SPLIT_LENGTHS, np.int32)
    targs = [_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
             torch.from_numpy(table), torch.from_numpy(lengths)]
    jargs = [_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
             jnp.asarray(table), jnp.asarray(lengths)]
    tkw, jkw = {}, {}
    if int8:
        kq, vq, ks, vs = _int8(k, v)
        targs[1:3] = kq, vq
        jargs[1:3] = jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy())
        tkw = dict(k_scales=ks, v_scales=vs)
        jkw = dict(k_scales=jnp.asarray(ks.numpy()),
                   v_scales=jnp.asarray(vs.numpy()))
    return targs, tkw, jargs, jkw, lengths > 0


_JAX_SPLIT_WANT = {}


def _jax_split_want(dtype, int8):
    """The JAX package's XLA path and Pallas kernel (interpret mode) on
    the split case, computed once per (dtype, int8)."""
    key = (dtype, int8)
    if key not in _JAX_SPLIT_WANT:
        _, _, jargs, jkw, _ = _split_case(dtype, int8)
        with pltpu.force_tpu_interpret_mode():
            kernel = jpa.paged_decode_attention_kernel(*jargs, **jkw)
        _JAX_SPLIT_WANT[key] = (
            _as_np(jpa.paged_decode_attention_xla(*jargs, **jkw)),
            _as_np(kernel))
    return _JAX_SPLIT_WANT[key]


@pytest.mark.parametrize("pages", ["fp", "int8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_split_schedule_matches_xla_and_kernel(splits, dtype, pages):
    """fp32 pages 1e-5, bf16 pages 2e-2; int8 pages with fp32 queries
    2e-5 (the XLA path dequantizes to fp32 too), bf16 queries 2e-2."""
    int8 = pages == "int8"
    targs, tkw, _, _, live = _split_case(dtype, int8)
    got = tpa.paged_decode_attention_split(*targs, splits, **tkw)
    assert got.dtype == getattr(torch, dtype)
    xla, kernel = _jax_split_want(dtype, int8)
    tol = (2e-5 if dtype == "float32" else 2e-2) if int8 else TOL[dtype]
    _close(got, xla, tol, live)
    _close(got, kernel, tol, slice(None))
    assert not _as_np(got)[~live].any()


@pytest.mark.parametrize("splits", [2, 4, 8])
def test_split_schedule_matches_one_split_and_reference(splits):
    """In fp32 the split merge is exact up to summation order: every
    split count agrees with one split and with the gather reference,
    and stale table entries past the live pages change nothing."""
    targs, _, _, _, live = _split_case("float32", False)
    one = tpa.paged_decode_attention_split(*targs, 1)
    got = tpa.paged_decode_attention_split(*targs, splits)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-6,
                               rtol=1e-6)
    ref = tpa.paged_decode_attention_reference(*targs)
    _close(got, ref, 1e-6, live)
    poisoned = targs[3].clone()
    for b, n in enumerate(SPLIT_LENGTHS):
        poisoned[b, -(-n // 8):] = -1
    again = tpa.paged_decode_attention_split(
        *targs[:3], poisoned, targs[4], splits)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("max_blocks,splits", [
    (1, 1), (2, 1), (3, 2), (4, 2), (6, 4), (8, 4), (9, 8), (64, 8)])
def test_paged_splits_leaves_two_pages_a_block(max_blocks, splits):
    """The kernel's cluster size: a power of two at most 8, two pages a
    block where that fits (4 at the served 512 keys over pages of 64)."""
    assert tpa.paged_splits(max_blocks) == splits
    assert -(-max_blocks // splits) <= 2 or splits == tpa.MAX_SPLITS


# The dense cluster kernel's split schedule (dense_decode_attention_split):
# each slot's live rows cut into units of DENSE_TILE rows, the units into
# `splits` contiguous runs, one softmax each, merged in rank order. The
# lengths of SPLIT_LENGTHS over a 48-row cache: empty, 1, one unit, one
# unit + 1, full (6 units of 8), and two ragged ones.
DENSE_TILE = 8


def _dense_split_case(dtype):
    q, k, v, _ = _dense_case(12, dtype)
    q, k, v = (np.concatenate([a, a[:2]]) for a in (q, k, v))
    kq, vq, ks, vs = _int8(k, v)
    lengths = np.asarray(SPLIT_LENGTHS, np.int32)
    return [_torch(q, dtype), kq, vq, ks, vs, torch.from_numpy(lengths)]


_JAX_DENSE_WANT = {}


def _jax_dense_want(dtype):
    """The JAX package's XLA path and Pallas kernel (interpret mode) on
    the dense split case, computed once per dtype."""
    if dtype not in _JAX_DENSE_WANT:
        targs = _dense_split_case(dtype)
        jargs = [_jax(targs[0].float().numpy(), dtype)] + [
            jnp.asarray(t.numpy()) for t in targs[1:]]
        _JAX_DENSE_WANT[dtype] = (
            _as_np(jdd.dense_decode_attention_xla(*jargs)),
            _as_np(jdd.dense_decode_attention_kernel(*jargs,
                                                     interpret=True)))
    return _JAX_DENSE_WANT[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_dense_split_schedule_matches_xla_and_kernel(splits, dtype):
    """fp32 queries 2e-5 (the XLA path dequantizes to fp32 too), bf16
    queries 2e-2 (it dequantizes to bf16, the split to fp32)."""
    targs = _dense_split_case(dtype)
    live = targs[5].numpy() > 0
    got = tdd.dense_decode_attention_split(*targs, splits,
                                           tile_rows=DENSE_TILE)
    assert got.dtype == getattr(torch, dtype)
    xla, kernel = _jax_dense_want(dtype)
    tol = 2e-5 if dtype == "float32" else 2e-2
    _close(got, xla, tol, live)
    _close(got, kernel, tol, slice(None))
    assert not _as_np(got)[~live].any()


@pytest.mark.parametrize("splits", [2, 4, 8])
def test_dense_split_schedule_matches_one_split(splits):
    """In fp32 the split merge is exact up to summation order: every
    split count agrees with one split, and NaN scales at or past each
    slot's length change nothing."""
    targs = _dense_split_case("float32")
    one = tdd.dense_decode_attention_split(*targs, 1, tile_rows=DENSE_TILE)
    got = tdd.dense_decode_attention_split(*targs, splits,
                                           tile_rows=DENSE_TILE)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=1e-6,
                               rtol=1e-6)
    ks, vs = targs[3].clone(), targs[4].clone()
    for b, n in enumerate(SPLIT_LENGTHS):
        ks[b, n:] = float("nan")
        vs[b, n:] = float("nan")
    again = tdd.dense_decode_attention_split(
        *targs[:3], ks, vs, targs[5], splits, tile_rows=DENSE_TILE)
    np.testing.assert_array_equal(again.numpy(), got.numpy())


@pytest.mark.parametrize("rows,splits,tile", [
    (1, 1, 1), (48, 1, 48), (128, 1, 128), (256, 1, 128), (257, 2, 128),
    (512, 2, 128), (513, 4, 128), (1024, 4, 128), (1025, 8, 128),
    (8192, 8, 128)])
def test_dense_splits_leaves_two_units_a_block(rows, splits, tile):
    """The dense kernel's cluster size: paged_splits' rule over units of
    DENSE_TILE_ROWS rows (a box never longer than the cache), so 2 at the
    served 512 keys."""
    assert tdd.dense_tile_rows(rows) == tile
    assert tdd.dense_splits(rows) == splits
    units = -(-rows // tile)
    assert -(-units // splits) <= 2 or splits == tpa.MAX_SPLITS
