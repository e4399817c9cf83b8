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



# The CUDA graph's preconditions, checked on the CPU: the captured decode
# step reads and writes fixed addresses, so no engine state may be rebound
# between steps, and page growth reads the host mirror of the positions.


def _state_addresses(engine) -> dict:
    tensors = {"tokens": engine._tokens, "positions": engine._positions,
               "active": engine._active}
    for i, layer in enumerate(engine.cache):
        for key, t in layer.items():
            tensors[f"{i}.{key}"] = t
    return {name: t.data_ptr() for name, t in tensors.items()}


def _run_watched(engine, schedule, max_steps=600):
    """_run, asserting after every step that no state tensor moved and
    that the host mirror of the positions equals the device positions."""
    addresses = _state_addresses(engine)
    results = {}
    pending = sorted(schedule, key=lambda s: s[0])
    for step in range(max_steps):
        while pending and pending[0][0] <= step:
            _, rid, prompt, max_new = pending.pop(0)
            engine.submit(tserving.Request(rid, list(prompt), max_new))
        for rid, toks in engine.step():
            results[rid] = [int(t) for t in toks]
        assert _state_addresses(engine) == addresses
        assert engine._positions_host == engine._positions.tolist()
        if not pending and not engine.pending():
            break
    assert not engine.pending(), "engine failed to drain"
    return results


def _prefix_schedule():
    rng = np.random.RandomState(0)
    base = list(rng.randint(0, 97, (24,)))
    schedule = [(0, "pilot", base, 5)]
    for i in range(3):
        suffix = list(rng.randint(0, 97, (3 + 2 * i,)))
        schedule.append((8 + i, f"fan{i}", base + suffix, 4 + i))
    return schedule


WATCHED = {
    # admission and finish, dense cache
    "dense": (dict(num_slots=2, max_decode_len=64), None,
              lambda: _random_schedule(0, 5, [3, 9, 4, 17, 6],
                                       [4, 6, 5, 3, 7])),
    # paged-int8 overcommit: preemption and re-prefill
    "paged_int8_overcommit": (
        dict(num_slots=2, max_decode_len=32, kv_page_size=8,
             kv_num_pages=5, overcommit=True), "int8",
        lambda: _random_schedule(5, 4, [6] * 4, [18] * 4, gap=0)),
    # prefix hits: shared-prefix prefill into pinned pages
    "prefix_hits": (dict(num_slots=2, max_decode_len=64, kv_page_size=8),
                    None, _prefix_schedule),
}


@pytest.mark.parametrize("case", sorted(WATCHED))
def test_state_stays_in_place_and_mirror_tracks_positions(params, case):
    kwargs, kv_dtype, schedule = WATCHED[case]
    tcfg = dataclasses.replace(TCFG, kv_cache_dtype=kv_dtype)
    engine = tserving.ContinuousBatcher(tcfg, params[1], device="cpu",
                                        **kwargs)
    results = _run_watched(engine, schedule())
    assert len(results) == len(schedule())
    if case == "paged_int8_overcommit":
        assert engine.preemptions > 0
    if case == "prefix_hits":
        assert engine.prefix_hit_pages > 0
    assert engine._graph is None        # the CPU engine steps eagerly


def test_capture_decode_raises_on_cpu(params):
    engine = tserving.ContinuousBatcher(TCFG, params[1], num_slots=2,
                                        max_decode_len=64, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        engine.capture_decode()
    assert engine._graph is None


class _EagerGraph:
    """Stands in for the captured graph on the CPU: each replay runs the
    step eagerly into one fixed output tensor, as a replay writes the
    captured one, and is counted."""

    def __init__(self, engine):
        self.engine = engine
        self.tokens = torch.zeros((engine.num_slots,), dtype=torch.int32)
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.tokens.copy_(
            tserving.ContinuousBatcher._eager_decode(self.engine))


def test_replayed_steps_stream_like_eager_and_count_launches(params):
    """step() through the replay path (fixed output tensor) streams the
    same greedy tokens as the eager engine, launching the graph exactly
    once per decode step and stepping eagerly never."""
    schedule = _random_schedule(1, 5, [3, 9, 4, 17, 6], [4, 6, 5, 3, 7])
    kwargs = dict(num_slots=3, max_decode_len=64, kv_page_size=8)
    eager = tserving.ContinuousBatcher(TCFG, params[1], device="cpu",
                                       **kwargs)
    want = _run(eager, tserving.Request, schedule)
    replayed = tserving.ContinuousBatcher(TCFG, params[1], device="cpu",
                                          **kwargs)
    graph = _EagerGraph(replayed)
    replayed._graph, replayed._graph_tokens = graph, graph.tokens
    eager_steps = []   # step() must not step eagerly once captured
    replayed._eager_decode = lambda: eager_steps.append(1)
    assert _run_watched(replayed, schedule) == want
    assert replayed.decode_steps == eager.decode_steps > 0
    assert graph.replays == replayed.decode_steps
    assert not eager_steps
