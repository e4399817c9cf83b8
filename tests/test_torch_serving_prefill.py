"""The prefill a CUDA graph captures, against the JAX package's on the
CPU (same flax params through params_from_flax, fp32): run eagerly from
the engine's static argument buffer (no host read), it must give the JAX
batch-1 prefill's logits within 1e-5, the same token and the same slot
rows and index, whole and chunked; a multi-token insert past the cache
end (its fixed-shape form) must drop those rows as the JAX insert does,
every row and the index equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import serving as jserving
from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import inference as tinf
from batch_shipyard_tpu_torch.models import serving as tserving
from batch_shipyard_tpu_torch.models import transformer as ttfm

COMMON = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=2,
              d_head=16, d_ff=64, max_seq_len=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **COMMON)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **COMMON)
MAX_LEN = 32


@pytest.fixture(scope="module")
def params():
    flax = jtfm.TransformerLM(JCFG).init(
        jax.random.PRNGKey(11), jnp.zeros((1, 8), jnp.int32))["params"]
    return flax, convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, flax))


@pytest.mark.parametrize("chunk", [None, 8])
def test_static_buffer_prefill_matches_jax(params, chunk):
    """The prefill body a graph captures, run eagerly from the argument
    buffer, against the JAX batch-1 prefill: logits within 1e-5, the
    same token, the slot's rows and index as the JAX cache's."""
    flax, state = params
    jeng = jserving.ContinuousBatcher(JCFG, flax, num_slots=2,
                                      max_decode_len=MAX_LEN,
                                      prefill_chunk=chunk)
    teng = tserving.ContinuousBatcher(TCFG, state, num_slots=2,
                                      max_decode_len=MAX_LEN,
                                      prefill_chunk=chunk, device="cpu")
    rng = np.random.RandomState(5)
    for n, slot in ((5, 1), (16, 0), (27, 1)):
        tokens = rng.randint(0, 97, (n,)).tolist()
        bucket = teng._bucket_length(n)
        padded = tokens + [0] * (bucket - n)
        teng._set_prefill_args(tokens=padded, len=n, slot=slot)
        teng._push_prefill_args()
        got = teng._prefill_body("dense", bucket).numpy()
        dense_model = jeng._prefill.args[0]
        jcache, want = jserving._prefill_dense(
            dense_model, chunk, flax, jeng.cache, slot,
            jnp.asarray([padded], jnp.int32), n)
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert int(got.argmax()) == int(want.argmax())
        for layer, tlayer in zip(range(COMMON["n_layers"]), teng.cache):
            jlayer = jcache[f"layer_{layer}"]["attn"]
            assert int(tlayer["index"][slot]) == n == int(
                jlayer["index"][slot])
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    tlayer[key][slot, :n].numpy(),
                    np.asarray(jlayer[key])[slot, :n],
                    rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_insert_past_cache_end_drops_rows(params, kv_dtype):
    """A multi-token insert of 8 tokens at index 12 of a 16-row batch-1
    cache: rows 12-15 take the first four tokens, the last four have no
    row; every row and the index equal the JAX insert's."""
    flax, state = params
    jcfg = dataclasses.replace(JCFG, kv_cache_dtype=kv_dtype)
    tcfg = dataclasses.replace(TCFG, kv_cache_dtype=kv_dtype)
    jmodel = jtfm.TransformerLM(jserving.inf.decode_config(jcfg, 16))
    tmodel = tserving.ContinuousBatcher(
        tcfg, state, num_slots=1, max_decode_len=16,
        device="cpu")._dense_model
    rng = np.random.RandomState(9)
    head = rng.randint(0, 97, (1, 12)).astype(np.int32)
    tail = rng.randint(0, 97, (1, 8)).astype(np.int32)
    jcache = jserving.inf.init_cache(jmodel, flax, 1)

    @jax.jit
    def insert(cache):
        _, mut = jmodel.apply({"params": flax, "cache": cache},
                              jnp.asarray(head), return_hidden=True,
                              mutable=["cache"])
        _, mut = jmodel.apply(
            {"params": flax, "cache": mut["cache"]}, jnp.asarray(tail),
            return_hidden=True,
            positions=jnp.arange(12, 20, dtype=jnp.int32),
            mutable=["cache"])
        return mut
    mut = insert(jcache)
    tcache = tinf.init_cache(tmodel, 1)
    with torch.no_grad():
        tmodel(torch.from_numpy(head), cache=tcache, return_hidden=True)
        tmodel(torch.from_numpy(tail),
               positions=torch.arange(12, 20, dtype=torch.int32),
               cache=tcache, return_hidden=True)
    keys = ["k", "v"] + (["k_scale", "v_scale"] if kv_dtype else [])
    for i, tlayer in enumerate(tcache):
        jlayer = mut["cache"][f"layer_{i}"]["attn"]
        assert int(tlayer["index"][0]) == 20 == int(jlayer["index"][0])
        for key in keys:
            got, want = tlayer[key][0].numpy(), np.asarray(jlayer[key])[0]
            assert got.shape[0] == 16
            if kv_dtype and key in ("k", "v"):
                assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=1e-5)
