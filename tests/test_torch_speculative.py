"""The port's speculative decoding pieces against the JAX package on the
CPU, fp32, the same flax params through both (params_from_flax):

- ``inference.speculative_generate``: tokens and {rounds, proposed,
  accepted} equal to the reference's, for hostile, identical and
  perturbed drafts, gamma 1-5 and a prompt of one token;
- one attention layer's paged multi-token insert (the verify block) from
  ragged slot lengths, fp32 and int8 pages, a block across page
  boundaries and one from max_decode_len - 2 whose tail writes land on
  the scratch page: outputs within 1e-5, and the same page contents at
  every position the block commits;
- the dense multi-token insert from max_decode_len - 2: without
  spec_window it drops the writes past max_decode_len as the reference
  does; with it (the speculative target's cache) the committed queries
  and the rows inside max_decode_len are the reference's;
- ``_rewind_cache`` moves every layer's cursor in place."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import inference as jinf
from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import inference as tinf
from batch_shipyard_tpu_torch.models import transformer as ttfm

VOCAB = 97
TARGET = dict(vocab_size=VOCAB, d_model=32, n_layers=2, n_heads=2,
              d_head=16, d_ff=64, max_seq_len=96)
DRAFT = dict(vocab_size=VOCAB, d_model=16, n_layers=1, n_heads=2,
             d_head=8, d_ff=32, max_seq_len=96)
MAX_LEN = 96
PROMPT = np.asarray([[5, 17, 31, 2], [9, 9, 1, 42]], np.int32)
N = 24


def _cfgs(common):
    return (jtfm.TransformerConfig(dtype=jnp.float32, **common),
            ttfm.TransformerConfig(dtype=torch.float32, **common))


def _flax(common, seed):
    jcfg, _ = _cfgs(common)
    params = jtfm.TransformerLM(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def target():
    return _flax(TARGET, 0)


@pytest.fixture(scope="module")
def drafts(target):
    """Draft (config dict, flax params) by name: a hostile random draft,
    the target itself, and the target plus noise (some proposals
    validate, some do not)."""
    rng = np.random.RandomState(7)
    noisy = jax.tree_util.tree_map(
        lambda p: (p + 0.02 * rng.randn(*p.shape)).astype(p.dtype), target)
    return {"hostile": (DRAFT, _flax(DRAFT, 1)),
            "identical": (TARGET, target),
            "perturbed": (TARGET, noisy)}


def _both(target, draft, prompt, num_tokens, gamma):
    dcommon, dparams = draft
    jt, tt = _cfgs(TARGET)
    jd, td = _cfgs(dcommon)
    jrun, _, _ = jinf.make_speculative_decoder(
        jt, target, jd, dparams, max_decode_len=MAX_LEN, gamma=gamma)
    want, wstats = jrun(jnp.asarray(prompt), num_tokens)
    trun, _, _ = tinf.make_speculative_decoder(
        tt, convert.params_from_flax(target), td,
        convert.params_from_flax(dparams), max_decode_len=MAX_LEN,
        gamma=gamma, device="cpu")
    got, stats = trun(torch.from_numpy(prompt), num_tokens)
    return (np.asarray(want), {k: int(v) for k, v in wstats.items()},
            got.numpy(), stats)


def _greedy(target, prompt, num_tokens):
    jt, _ = _cfgs(TARGET)
    run, _ = jinf.make_decoder(jt, target, max_decode_len=MAX_LEN)
    tokens, _ = run(jnp.asarray(prompt), num_tokens, jax.random.PRNGKey(0))
    return np.asarray(tokens)


@pytest.mark.parametrize("draft", ["hostile", "identical", "perturbed"])
def test_speculative_generate_matches_reference(target, drafts, draft):
    want, wstats, got, stats = _both(target, drafts[draft], PROMPT, N, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy(target, PROMPT, N))
    assert stats == wstats
    if draft == "identical":
        assert stats["accepted"] == stats["proposed"]
        assert stats["rounds"] == -(-N // 5)
    if draft == "perturbed":
        assert 0 < stats["accepted"] < stats["proposed"], stats


@pytest.mark.parametrize("gamma", [1, 2, 3, 4, 5])
def test_speculative_generate_gamma_sweep(target, drafts, gamma):
    want, wstats, got, stats = _both(target, drafts["perturbed"], PROMPT,
                                     N, gamma)
    np.testing.assert_array_equal(got, want)
    assert stats == wstats
    assert stats["proposed"] == stats["rounds"] * gamma


def test_speculative_generate_prompt_length_one(target, drafts):
    prompt = np.asarray([[3], [77]], np.int32)
    want, wstats, got, stats = _both(target, drafts["hostile"], prompt,
                                     12, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy(target, prompt, 12))
    assert stats == wstats


def test_speculative_decoder_rejects_a_paged_config(target, drafts):
    _, tt = _cfgs(TARGET)
    _, td = _cfgs(DRAFT)
    state = convert.params_from_flax(target)
    draft = convert.params_from_flax(drafts["hostile"][1])
    paged = dataclasses.replace(tt, kv_page_size=16)
    with pytest.raises(ValueError, match="kv_page_size"):
        tinf.make_speculative_decoder(paged, state, td, draft,
                                      max_decode_len=MAX_LEN, device="cpu")
    with pytest.raises(ValueError, match="draft config sets kv_page_size"):
        tinf.make_speculative_decoder(
            tt, state, dataclasses.replace(td, kv_page_size=16), draft,
            max_decode_len=MAX_LEN, device="cpu")


# ------------------------- one attention layer -------------------------

LAYER = dict(vocab_size=VOCAB, d_model=32, n_layers=1, n_heads=2,
             d_head=16, d_ff=64, max_seq_len=32, decode=True,
             max_decode_len=32)
PAGE, GAMMA, POOL = 8, 4, 12
SCRATCH = POOL            # the pool's last page
LENGTHS = [5, 30, 13]     # a block across a page boundary; one from L - 2


def _layer_pair(**extra):
    """The reference's Attention and the port's, on one set of weights,
    with the reference's freshly initialised cache variables."""
    jcfg = jtfm.TransformerConfig(dtype=jnp.float32, **LAYER, **extra)
    tcfg = ttfm.TransformerConfig(dtype=torch.float32, **LAYER, **extra)
    jattn = jtfm.Attention(jcfg)
    batch = len(LENGTHS)
    variables = jattn.init(jax.random.PRNGKey(3),
                           jnp.zeros((batch, 1, LAYER["d_model"])),
                           jnp.zeros((batch, 1), jnp.int32))
    tattn = ttfm.Attention(tcfg)
    state = convert.params_from_flax({"attn": jax.tree_util.tree_map(
        np.asarray, variables["params"])})
    tattn.load_state_dict({k[len("attn."):]: v for k, v in state.items()})
    return jattn, variables["params"], variables["cache"], tattn.eval()


def _random_pool(rng, int8):
    shape = (POOL + 1, PAGE, LAYER["n_heads"], LAYER["d_head"])
    if int8:
        pool = {"k_pages": rng.randint(-127, 128, shape).astype(np.int8),
                "v_pages": rng.randint(-127, 128, shape).astype(np.int8),
                "k_page_scales": rng.rand(*shape[:3]).astype(np.float32),
                "v_page_scales": rng.rand(*shape[:3]).astype(np.float32)}
    else:
        pool = {"k_pages": rng.randn(*shape).astype(np.float32),
                "v_pages": rng.randn(*shape).astype(np.float32)}
    # Each slot's table: its live pages drawn without replacement, the
    # entries past them (the spec_window margin included) on scratch.
    max_blocks = -(-(LAYER["max_decode_len"] + GAMMA) // PAGE)
    table = np.full((len(LENGTHS), max_blocks), SCRATCH, np.int32)
    order = rng.permutation(POOL)
    taken = 0
    for b, n in enumerate(LENGTHS):
        live = min(-(-(n + GAMMA + 1) // PAGE), LAYER["max_decode_len"]
                   // PAGE)
        table[b, :live] = order[taken:taken + live]
        taken += live
    return {**pool, "block_table": table,
            "length": np.asarray(LENGTHS, np.int32)}


def _insert(jattn, params, jcache, tattn, cache, seq, rng):
    x = rng.randn(len(LENGTHS), seq, LAYER["d_model"]).astype(np.float32)
    pos = (np.asarray(LENGTHS)[:, None] + np.arange(seq)).astype(np.int32)
    want, mut = jattn.apply({"params": params, "cache": jcache},
                            jnp.asarray(x), jnp.asarray(pos),
                            mutable=["cache"])
    tcache = {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}
    with torch.no_grad():
        got = tattn(torch.from_numpy(x), torch.from_numpy(pos), tcache)
    return np.asarray(want), got.numpy(), mut["cache"], tcache


@pytest.mark.parametrize("int8", [False, True])
def test_paged_verify_insert_matches_reference(int8):
    rng = np.random.RandomState(11)
    extra = dict(kv_page_size=PAGE, kv_num_pages=POOL + 1, spec_window=GAMMA,
                 kv_cache_dtype="int8" if int8 else None)
    jattn, params, jcache, tattn = _layer_pair(**extra)
    cache = _random_pool(rng, int8)
    assert set(cache) == set(jcache)
    jcache = {k: jnp.asarray(v) for k, v in cache.items()}
    want, got, jout, tout = _insert(jattn, params, jcache, tattn, cache,
                                    GAMMA + 1, rng)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(tout["length"].numpy(),
                                  np.asarray(LENGTHS) + GAMMA + 1)
    # Every position the block writes inside max_decode_len sits on a
    # real page, with the reference's contents (values and scales).
    table = cache["block_table"]
    for b, n in enumerate(LENGTHS):
        for p in range(n, min(n + GAMMA + 1, LAYER["max_decode_len"])):
            page, row = table[b, p // PAGE], p % PAGE
            assert page != SCRATCH
            for key in cache:
                if key.endswith("pages") or key.endswith("scales"):
                    np.testing.assert_allclose(
                        tout[key][page, row].numpy(),
                        np.asarray(jout[key])[page, row], atol=1e-6)
    # The block from max_decode_len - 2 spilled its tail onto scratch.
    assert table[1, (LENGTHS[1] + GAMMA) // PAGE] == SCRATCH


def test_paged_insert_needs_spec_window():
    """A multi-token paged insert longer than spec_window + 1 raises the
    reference's error (no table margin: its tail would clamp onto a live
    page)."""
    jattn, params, _, tattn = _layer_pair(kv_page_size=PAGE,
                                          kv_num_pages=POOL + 1,
                                          spec_window=GAMMA)
    rng = np.random.RandomState(2)
    cache = {k: torch.from_numpy(np.array(v))
             for k, v in _random_pool(rng, False).items()}
    x = torch.zeros((len(LENGTHS), GAMMA + 2, LAYER["d_model"]))
    pos = torch.zeros((len(LENGTHS), GAMMA + 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="spec_window >= 5"):
        tattn(x, pos, cache)
    with pytest.raises(ValueError, match="spec_window"):
        jattn.apply({"params": params, "cache": {
            k: jnp.asarray(v.numpy()) for k, v in cache.items()}},
            jnp.zeros(x.shape), jnp.zeros(pos.shape, jnp.int32),
            mutable=["cache"])


@pytest.mark.parametrize("spec_window", [0, GAMMA])
@pytest.mark.parametrize("int8", [False, True])
def test_dense_insert_from_max_decode_len_minus_2(spec_window, int8):
    """A verify block of gamma + 1 tokens from max_decode_len - 2 on the
    dense cache. The reference drops its writes past max_decode_len. The
    port without spec_window drops them too (every query as the
    reference's); with spec_window they land in the extra rows, so the
    queries inside max_decode_len and every row inside it are the
    reference's."""
    length = LAYER["max_decode_len"]
    kv = "int8" if int8 else None
    jattn, params, jcache, _ = _layer_pair(kv_cache_dtype=kv)
    _, _, _, tattn = _layer_pair(kv_cache_dtype=kv, spec_window=spec_window)
    rng = np.random.RandomState(5)
    batch = len(LENGTHS)
    rows = (batch, length, LAYER["n_heads"], LAYER["d_head"])
    if int8:
        cache = {"k": rng.randint(-127, 128, rows).astype(np.int8),
                 "v": rng.randint(-127, 128, rows).astype(np.int8),
                 "k_scale": rng.rand(*rows[:3]).astype(np.float32),
                 "v_scale": rng.rand(*rows[:3]).astype(np.float32)}
    else:
        cache = {"k": rng.randn(*rows).astype(np.float32),
                 "v": rng.randn(*rows).astype(np.float32)}
    cache["index"] = np.asarray([length - 2, 7, length - 5], np.int32)
    assert set(cache) == set(jcache)
    seq = GAMMA + 1
    x = rng.randn(batch, seq, LAYER["d_model"]).astype(np.float32)
    pos = (cache["index"][:, None] + np.arange(seq)).astype(np.int32)
    want, mut = jattn.apply({"params": params, "cache": {
        k: jnp.asarray(v) for k, v in cache.items()}}, jnp.asarray(x),
        jnp.asarray(pos), mutable=["cache"])
    tcache = {}
    for key, value in cache.items():
        t = torch.from_numpy(np.array(value))
        if key != "index" and spec_window:
            pad = torch.zeros((batch, spec_window, *t.shape[2:]),
                              dtype=t.dtype)
            t = torch.cat([t, pad], dim=1)
        tcache[key] = t
    with torch.no_grad():
        got = tattn(torch.from_numpy(x), torch.from_numpy(pos),
                    tcache).numpy()
    want = np.asarray(want)
    inside = pos < length          # the queries a committed token needs
    np.testing.assert_allclose(got[inside], want[inside], atol=1e-5,
                               rtol=1e-5)
    if not spec_window:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    for key in cache:
        if key == "index":
            np.testing.assert_array_equal(tcache[key].numpy(),
                                          np.asarray(mut["cache"][key]))
        else:
            np.testing.assert_allclose(
                tcache[key][:, :length].numpy(),
                np.asarray(mut["cache"][key]), atol=1e-6)


def test_rewind_cache_moves_every_cursor_in_place():
    cfg = ttfm.TransformerConfig(dtype=torch.float32, **{
        **LAYER, "n_layers": 2})
    for extra in ({}, dict(kv_page_size=PAGE, kv_num_pages=4)):
        model = ttfm.TransformerLM(dataclasses.replace(cfg, **extra))
        cache = tinf.init_cache(model, 3)
        key = "length" if extra else "index"
        cursors = [layer[key] for layer in cache]
        for t in cursors:
            t.copy_(torch.tensor([9, 9, 9]))
        tinf._rewind_cache(cache, torch.tensor([0, 2, 5],
                                               dtype=torch.int32))
        tinf._rewind_cache(cache, 1)
        for layer, t in zip(cache, cursors):
            assert layer[key] is t
            assert t.tolist() == [8, 6, 3]
