"""The port's engine warm-up and resume against the JAX package's on the
CPU: the same flax params (params_from_flax), fp32. warmup_buckets() and
warmup()'s return must equal the JAX engine's on the dense, paged,
tight-overcommit and prefix-cache settings, and the greedy streams after
warm-up must match token for token; submit(resumed=...) must continue the
JAX engine's stream; every prefill a graph replays must stream as eager
(tests/test_torch_serving_prefill.py holds the prefill itself)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import serving as jserving
from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import serving as tserving
from batch_shipyard_tpu_torch.models import transformer as ttfm

COMMON = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=2,
              d_head=16, d_ff=64, max_seq_len=64)
JCFG = jtfm.TransformerConfig(dtype=jnp.float32, **COMMON)
TCFG = ttfm.TransformerConfig(dtype=torch.float32, **COMMON)
MAX_LEN = 32
# name -> (kv_cache_dtype, engine kwargs). The tight pool (3 pages of 8)
# cannot admit bucket 32's worst case, so warm-up skips it.
SETTINGS = {
    "dense": (None, dict(num_slots=2)),
    "paged": (None, dict(num_slots=2, kv_page_size=8,
                         prefix_cache=False)),
    "tight_overcommit": ("int8", dict(num_slots=2, kv_page_size=8,
                                      kv_num_pages=3, overcommit=True,
                                      prefix_cache=False)),
    "prefix_cache": (None, dict(num_slots=2, kv_page_size=8)),
}


@pytest.fixture(scope="module")
def params():
    flax = jtfm.TransformerLM(JCFG).init(
        jax.random.PRNGKey(11), jnp.zeros((1, 8), jnp.int32))["params"]
    return flax, convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, flax))


def _engines(params, setting, max_len=MAX_LEN):
    flax, state = params
    kv_dtype, kwargs = SETTINGS[setting]
    jeng = jserving.ContinuousBatcher(
        dataclasses.replace(JCFG, kv_cache_dtype=kv_dtype), flax,
        max_decode_len=max_len, **kwargs)
    teng = tserving.ContinuousBatcher(
        dataclasses.replace(TCFG, kv_cache_dtype=kv_dtype), state,
        max_decode_len=max_len, device="cpu", **kwargs)
    return jeng, teng


def _drain(engine, request_cls, requests, resumed=None):
    for rid, prompt, new in requests:
        if resumed is None:
            engine.submit(request_cls(rid, list(prompt), new))
        else:
            engine.submit(request_cls(rid, list(prompt), new),
                          resumed=resumed[rid])
    out = {}
    while engine.pending():
        for rid, tokens in engine.step():
            out[rid] = [int(t) for t in tokens]
    return out


def _requests(seed, lengths, new):
    rng = np.random.RandomState(seed)
    return [(f"r{i}", rng.randint(0, 97, (n,)).tolist(), new)
            for i, n in enumerate(lengths)]


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_warmup_buckets_and_streams_match_jax(params, setting):
    jeng, teng = _engines(params, setting)
    assert teng.warmup_buckets() == jeng.warmup_buckets() == [16, 32]
    want = jeng.warmup()
    assert teng.warmup() == want
    assert want == ([16] if setting == "tight_overcommit" else [16, 32])
    if teng.prefix_cache:
        stats = teng.prefix_stats()
        assert stats == jeng.prefix_stats()
        assert stats["lookups"] == stats["published_pages"] == 0
        assert stats["indexed_pages"] == 0
    assert teng.pending() == 0
    base = _requests(3, [20, 5], 6)
    # With the prefix cache, a second wave shares the first's pages.
    requests = base + [(f"s{i}", prompt + [i + 1], new)
                       for i, (_, prompt, new) in enumerate(base)]
    if setting == "tight_overcommit":
        requests = _requests(4, [7, 9, 6], 9)
    got = _drain(teng, tserving.Request, requests)
    assert got == _drain(jeng, jserving.Request, requests)
    assert teng.preemptions == jeng.preemptions
    if setting == "prefix_cache":
        assert teng.prefix_stats()["hit_tokens"] > 0
        assert teng.prefix_stats() == jeng.prefix_stats()


def test_warmup_pinned_prompt_len_matches_jax(params):
    jeng, teng = _engines(params, "paged")
    assert teng.warmup(prompt_len=20) == jeng.warmup(prompt_len=20) == [32]


@pytest.mark.parametrize("setting", ["dense", "prefix_cache"])
def test_submit_resumed_continues_jax_stream(params, setting):
    """A request resumed with the first k tokens of its uninterrupted
    greedy stream re-prefills prompt + them and continues it, in both
    engines; the checks on resumed tokens are the reference's."""
    jeng, teng = _engines(params, setting)
    requests = _requests(7, [9, 14], 10)
    whole = _drain(jeng, jserving.Request, requests)
    assert _drain(teng, tserving.Request, requests) == whole
    for k in (1, 4, 9):
        resumed = {rid: whole[rid][:k] for rid, _, _ in requests}
        want = _drain(jeng, jserving.Request, requests, resumed)
        got = _drain(teng, tserving.Request, requests, resumed)
        assert got == want == whole
    req = tserving.Request("done", [1, 2, 3], 2)
    with pytest.raises(ValueError, match="nothing left to decode"):
        teng.submit(req, resumed=[4, 5])
    with pytest.raises(ValueError, match="nothing left to decode"):
        jeng.submit(jserving.Request("done", [1, 2, 3], 2),
                    resumed=[4, 5])


class _StandInGraph:
    """A CUDA graph's stand-in on the CPU: replay() reruns the captured
    prefill body into the output the capture returned."""

    def __init__(self):
        self.rerun = None

    def replay(self):
        self.rerun()


def test_prefill_graph_dispatch_streams_like_eager(params, monkeypatch):
    """Every prefill key of a prefix-cache engine with a draft, captured
    through _capture_prefill (its eager run on parked arguments
    included) on stand-in graphs, then served: admission must push its
    arguments before each replay and use the replay's output, and the
    parked runs must disturb no live state. Streams equal the JAX
    non-speculative engine's."""
    flax, state = params
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: torch.no_grad())
    draft_cfg = dataclasses.replace(TCFG, d_model=16, d_head=8, d_ff=32,
                                    n_layers=1)
    draft = convert.init_params(draft_cfg,
                                torch.Generator().manual_seed(1))
    teng = tserving.ContinuousBatcher(
        TCFG, state, num_slots=2, max_decode_len=MAX_LEN, kv_page_size=8,
        device="cpu", speculative=tserving.SpeculativeConfig(
            draft_cfg, draft, gamma=2))
    jeng = jserving.ContinuousBatcher(JCFG, flax, num_slots=2,
                                      max_decode_len=MAX_LEN,
                                      kv_page_size=8)
    assert teng.warmup() == jeng.warmup() == [16, 32]
    keys = teng._prefill_keys([16, 32])
    assert keys == [("paged", 16), ("shared", 16), ("draft", 16),
                    ("paged", 32), ("shared", 32), ("draft", 32)]
    replays = []
    for key in keys:
        teng._capture_prefill(*key)
        graph, out = teng._prefill_graphs[key]

        def rerun(key=key, out=out):
            replays.append(key)
            out.copy_(teng._prefill_body(*key))
        graph.rerun = rerun
    base = _requests(8, [18, 11], 7)
    requests = base + [(f"s{i}", prompt + [3], new)
                       for i, (_, prompt, new) in enumerate(base)]
    got = _drain(teng, tserving.Request, requests)
    assert got == _drain(jeng, jserving.Request, requests)
    assert {kind for kind, _ in replays} == {"paged", "shared", "draft"}


# precompile() settings: name -> (kv_cache_dtype, engine kwargs, draft).
PRECOMPILE = {
    "dense": (None, dict(num_slots=2), False),
    "dense_int8": ("int8", dict(num_slots=2), False),
    "paged": (None, dict(num_slots=2, kv_page_size=8, prefix_cache=False),
              False),
    "paged_int8_prefix": ("int8", dict(num_slots=2, kv_page_size=8), False),
    "speculative": (None, dict(num_slots=2, kv_page_size=8), True),
}
DRAFT = dict(vocab_size=97, d_model=16, n_layers=1, n_heads=2, d_head=8,
             d_ff=32, max_seq_len=64)


@pytest.fixture(scope="module")
def draft_params():
    cfg = jtfm.TransformerConfig(dtype=jnp.float32, **DRAFT)
    flax = jtfm.TransformerLM(cfg).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))["params"]
    flax = jax.tree_util.tree_map(np.asarray, flax)
    return flax, convert.params_from_flax(flax)


def _precompile_engines(params, draft_params, setting, n=1):
    """The JAX engine and ``n`` port engines of a PRECOMPILE setting."""
    flax, state = params
    kv_dtype, kwargs, with_draft = PRECOMPILE[setting]
    jspec = tspec = None
    if with_draft:
        jspec = jserving.SpeculativeConfig(
            jtfm.TransformerConfig(dtype=jnp.float32, **DRAFT),
            draft_params[0], gamma=2)
        tspec = tserving.SpeculativeConfig(
            ttfm.TransformerConfig(dtype=torch.float32, **DRAFT),
            draft_params[1], gamma=2)
    jeng = jserving.ContinuousBatcher(
        dataclasses.replace(JCFG, kv_cache_dtype=kv_dtype), flax,
        max_decode_len=MAX_LEN, speculative=jspec, **kwargs)
    tengs = [tserving.ContinuousBatcher(
        dataclasses.replace(TCFG, kv_cache_dtype=kv_dtype), state,
        max_decode_len=MAX_LEN, device="cpu", speculative=tspec, **kwargs)
        for _ in range(n)]
    return jeng, tengs


def _engine_state(engine):
    """Everything a burned request or a parked run could move: the
    counters, slots, queue, pages and prefix index, the host table, every
    cache's lengths, indices and block table (the draft's too), the
    token, position and active tensors and the generator."""
    caches = [engine.cache] + ([engine._draft_cache]
                               if engine.speculative is not None else [])
    state = {
        "decode_steps": engine.decode_steps,
        "preemptions": engine.preemptions,
        "prefix": engine.prefix_stats(), "spec": engine.spec_stats(),
        "slo": engine.slo_stats(), "pending": engine.pending(),
        "slots": [s.request for s in engine._slots],
        "timed": sorted(engine._timed_buckets),
        "bookkeeping": [{key: t.tolist() for key, t in layer.items()
                         if key in ("index", "length", "block_table")}
                        for cache in caches for layer in cache],
        "tokens": engine._tokens.tolist(),
        "positions": engine._positions.tolist(),
        "active": engine._active.tolist(),
        "generator": engine._generator.get_state().tolist(),
    }
    if engine.paged:
        state.update(free=sorted(engine._free_pages),
                     avail=engine._avail_pages,
                     table=engine._table.tolist(),
                     index=dict(engine._prefix_index),
                     lru=list(engine._lru))
    return state


@pytest.mark.parametrize("setting", sorted(PRECOMPILE))
def test_precompile_counts_like_jax_and_streams_unchanged(
        params, draft_params, setting):
    """precompile() on a CPU engine (its prefill and decode bodies run on
    parked arguments, nothing captured) returns the JAX engine's count,
    moves no counter, page, index or cache length, and the greedy streams
    after it, after warmup() and with neither are the same tokens, the
    JAX engine's after its own precompile()."""
    jeng, (aot, warmed, cold) = _precompile_engines(params, draft_params,
                                                    setting, n=3)
    before = _engine_state(aot)
    assert aot.precompile() == jeng.precompile()
    assert _engine_state(aot) == before
    assert not aot._prefill_graphs and aot._graph is None
    warmed.warmup()
    base = _requests(5, [20, 5], 6)
    requests = base + [(f"s{i}", prompt + [i + 1], new)
                       for i, (_, prompt, new) in enumerate(base)]
    streams = [_drain(engine, tserving.Request, requests)
               for engine in (aot, warmed, cold)]
    assert streams[0] == streams[1] == streams[2]
    if not PRECOMPILE[setting][2]:
        assert streams[0] == _drain(jeng, jserving.Request, requests)


def test_precompile_needs_an_idle_engine(params, draft_params):
    _, (teng,) = _precompile_engines(params, draft_params, "paged")
    teng.submit(tserving.Request("r0", [1, 2, 3], 4))
    with pytest.raises(RuntimeError, match="idle engine"):
        teng.precompile()
