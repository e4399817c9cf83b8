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
