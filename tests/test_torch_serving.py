"""The port's ContinuousBatcher against the JAX package's on the CPU:
the same flax params (params_from_flax), the same request schedules
(submissions interleaved with steps), fp32. Greedy token streams must
be identical, and so must the preemption and prefix-cache counters.
Only emitted tokens are compared, never raw cache tensors: inactive
slots write garbage rows by design in both engines."""

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


@pytest.fixture(scope="module")
def params():
    flax = jtfm.TransformerLM(JCFG).init(
        jax.random.PRNGKey(7), jnp.zeros((1, 8), jnp.int32))["params"]
    return flax, convert.params_from_flax(
        jax.tree_util.tree_map(np.asarray, flax))


def _run(engine, request_cls, schedule, max_steps=600):
    """schedule: [(step, request_id, prompt, max_new_tokens)] — each
    request is submitted just before engine step ``step``."""
    results = {}
    pending = sorted(schedule, key=lambda s: s[0])
    for step in range(max_steps):
        while pending and pending[0][0] <= step:
            _, rid, prompt, max_new = pending.pop(0)
            engine.submit(request_cls(rid, list(prompt), max_new))
        for rid, toks in engine.step():
            results[rid] = [int(t) for t in toks]
        if not pending and not engine.pending():
            break
    assert not engine.pending(), "engine failed to drain"
    return results


def _both(params, schedule, kv_cache_dtype=None, **engine_kwargs):
    flax, state = params
    jcfg = dataclasses.replace(JCFG, kv_cache_dtype=kv_cache_dtype)
    tcfg = dataclasses.replace(TCFG, kv_cache_dtype=kv_cache_dtype)
    jeng = jserving.ContinuousBatcher(jcfg, flax, **engine_kwargs)
    teng = tserving.ContinuousBatcher(tcfg, state, device="cpu",
                                      **engine_kwargs)
    want = _run(jeng, jserving.Request, schedule)
    got = _run(teng, tserving.Request, schedule)
    assert set(got) == {s[1] for s in schedule}
    assert got == want
    return jeng, teng


def _check_page_partition(engine):
    """FREE / LRU / OWNED / PINNED partition the pool exactly, and the
    availability counter matches total - pinned - reservations."""
    free = list(engine._free_pages)
    lru = list(engine._lru)
    owned = [p for pages in engine._slot_pages for p in pages]
    pinned = [pid for pid, ref in engine._page_ref.items() if ref > 0]
    everything = free + lru + owned + pinned
    assert len(everything) == len(set(everything)) == engine._total_pages
    assert engine._avail_pages == (
        engine._total_pages - len(pinned) - sum(engine._slot_reserved))


def _random_schedule(seed, n, prompt_lens, gens, gap=2):
    rng = np.random.RandomState(seed)
    return [(gap * i, f"r{i}", rng.randint(0, 97, (prompt_lens[i],)),
             gens[i]) for i in range(n)]


def test_dense_streams_identical(params):
    schedule = _random_schedule(0, 5, [3, 9, 4, 17, 6], [4, 6, 5, 3, 7])
    _both(params, schedule, num_slots=2, max_decode_len=64)


def test_paged_streams_identical(params):
    schedule = _random_schedule(1, 5, [3, 9, 4, 17, 6], [4, 6, 5, 3, 7])
    _, teng = _both(params, schedule, num_slots=3, max_decode_len=64,
                    kv_page_size=8, prefix_cache=False)
    _check_page_partition(teng)


def test_paged_int8_overcommit_preemptions_identical(params):
    """A pool far below the aggregate worst case forces preemption and
    re-prefill; both engines preempt the same victims at the same
    steps."""
    schedule = _random_schedule(5, 4, [6] * 4, [18] * 4, gap=0)
    jeng, teng = _both(params, schedule, kv_cache_dtype="int8",
                       num_slots=2, max_decode_len=32, kv_page_size=8,
                       kv_num_pages=5, overcommit=True)
    assert teng.preemptions > 0
    assert teng.preemptions == jeng.preemptions
    _check_page_partition(teng)


def test_shared_prefix_hits_identical(params):
    """A pilot publishes three full pages; followers with the same
    prefix reuse them (shared-prefix prefill) in both engines."""
    rng = np.random.RandomState(0)
    base = list(rng.randint(0, 97, (24,)))
    schedule = [(0, "pilot", base, 5)]
    for i in range(3):
        suffix = list(rng.randint(0, 97, (3 + 2 * i,)))
        schedule.append((8 + i, f"fan{i}", base + suffix, 4 + i))
    jeng, teng = _both(params, schedule, num_slots=2, max_decode_len=64,
                       kv_page_size=8)
    assert teng.prefix_hit_pages > 0
    assert teng.prefix_stats() == jeng.prefix_stats()
    _check_page_partition(teng)

