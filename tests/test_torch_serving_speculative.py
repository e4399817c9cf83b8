"""The port's speculative serving engine (models/serving.py
SpeculativeConfig) on the CPU, fp32, against the JAX package's
NON-speculative greedy decoding on the same flax params
(params_from_flax): every stream must equal the reference's greedy
tokens, across mixed per-slot acceptance with a late arrival, a hostile
draft, an identical draft (full acceptance, an eos mid-block, a
max_new_tokens that is not a multiple of gamma + 1), the paged target
crossing pages up to max_decode_len, overcommit preemption with
re-prefill of both caches, and the int8 KV cache (against the port's
non-speculative int8 engine). spec_stats equal the JAX speculative
engine's where that engine is right. Then the plumbing: the four
rejections, /v1/stats and /metrics, serve.py --speculative (with a
draft restored from a checkpoint), and the CUDA graph's preconditions
(state in place, the host mirror of the positions)."""

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import inference as jinf
from batch_shipyard_tpu.models import serving as jserving
from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import inference as tinf
from batch_shipyard_tpu_torch.models import serving as tserving
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.models.server import ServingFrontEnd
from batch_shipyard_tpu_torch.parallel import train as ttrain
from batch_shipyard_tpu_torch.workloads import checkpoint
from batch_shipyard_tpu_torch.workloads import serve

REPO = pathlib.Path(__file__).resolve().parent.parent
TARGET = dict(vocab_size=97, d_model=32, n_layers=2, n_heads=2, d_head=16,
              d_ff=64, max_seq_len=64)
DRAFT = dict(vocab_size=97, d_model=16, n_layers=1, n_heads=2, d_head=8,
             d_ff=32, max_seq_len=64)


def _cfg(common, **extra):
    return (jtfm.TransformerConfig(dtype=jnp.float32, **common, **extra),
            ttfm.TransformerConfig(dtype=torch.float32, **common, **extra))


def _flax(common, seed):
    params = jtfm.TransformerLM(_cfg(common)[0]).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def target():
    return _flax(TARGET, 7)


@pytest.fixture(scope="module")
def drafts(target):
    """name -> (config dict, flax params): an unrelated random draft, the
    target itself, and the target plus noise."""
    rng = np.random.RandomState(11)
    noisy = jax.tree_util.tree_map(
        lambda p: (p + 0.02 * rng.randn(*p.shape)).astype(p.dtype), target)
    return {"hostile": (DRAFT, _flax(DRAFT, 3)),
            "identical": (TARGET, target),
            "perturbed": (TARGET, noisy)}


_GREEDY: dict = {}


def reference_greedy(target, prompt, num_tokens, max_decode_len=64):
    """The reference's lockstep greedy decoder (the oracle)."""
    run = _GREEDY.get((id(target), max_decode_len))
    if run is None:
        run, _ = jinf.make_decoder(_cfg(TARGET)[0], target,
                                   max_decode_len=max_decode_len)
        _GREEDY[(id(target), max_decode_len)] = run
    tokens, _ = run(jnp.asarray([prompt], jnp.int32), num_tokens,
                    jax.random.PRNGKey(0))
    return [int(t) for t in np.asarray(tokens[0, len(prompt):])]


def _spec_engine(target, draft, gamma=4, num_slots=2, max_decode_len=64,
                 kv_cache_dtype=None, **kwargs):
    common, params = draft
    tcfg = _cfg(TARGET, kv_cache_dtype=kv_cache_dtype)[1]
    dcfg = _cfg(common, kv_cache_dtype=kv_cache_dtype)[1]
    return tserving.ContinuousBatcher(
        tcfg, convert.params_from_flax(target), num_slots=num_slots,
        max_decode_len=max_decode_len, device="cpu",
        speculative=tserving.SpeculativeConfig(
            dcfg, convert.params_from_flax(params), gamma=gamma), **kwargs)


def _jax_spec_engine(target, draft, gamma=4, num_slots=2, **kwargs):
    common, params = draft
    return jserving.ContinuousBatcher(
        _cfg(TARGET)[0], target, num_slots=num_slots, max_decode_len=64,
        speculative=jserving.SpeculativeConfig(_cfg(common)[0], params,
                                               gamma=gamma), **kwargs)


def _drain(engine, results=None, max_steps=800):
    results = {} if results is None else results
    for _ in range(max_steps):
        for rid, tokens in engine.step():
            results[rid] = [int(t) for t in tokens]
        if not engine.pending():
            break
    assert not engine.pending(), "engine failed to drain"
    return results


def _requests(seed, n, prompt_len, max_new):
    rng = np.random.RandomState(seed)
    return [(f"r{i}", [int(t) for t in rng.randint(0, 97, (prompt_len,))],
             max_new) for i in range(n)]


@pytest.mark.parametrize("paged", [None, 8])
def test_mixed_acceptance_with_late_arrival_matches_greedy(target, drafts,
                                                           paged):
    """Four requests through two slots with a perturbed draft (mixed
    accept/reject a slot every round), a fifth submitted mid-flight while
    another slot is mid-generation: every stream (those finished in the
    first steps too) is the reference's greedy stream."""
    engine = _spec_engine(target, drafts["perturbed"], kv_page_size=paged)
    early = _requests(0, 4, 4, 8)
    late = ("late", _requests(1, 1, 4, 12)[0][1], 12)
    for rid, prompt, max_new in early:
        engine.submit(tserving.Request(rid, prompt, max_new))
    results = {}
    for _ in range(2):
        for rid, tokens in engine.step():
            results[rid] = [int(t) for t in tokens]
    engine.submit(tserving.Request(*late))
    _drain(engine, results)
    assert set(results) == {r[0] for r in early} | {"late"}
    for rid, prompt, max_new in early + [late]:
        assert results[rid] == reference_greedy(target, prompt, max_new), rid
    stats = engine.spec_stats()
    assert 0 < stats["accepted"] < stats["proposed"], stats


def test_hostile_draft_matches_greedy_and_reference_stats(target, drafts):
    prompt = _requests(1, 1, 4, 8)[0][1]
    engine = _spec_engine(target, drafts["hostile"], gamma=3)
    engine.submit(tserving.Request("h", prompt, 8))
    assert _drain(engine)["h"] == reference_greedy(target, prompt, 8)
    jengine = _jax_spec_engine(target, drafts["hostile"], gamma=3)
    jengine.submit(jserving.Request("h", prompt, 8))
    _drain(jengine)
    assert engine.spec_stats() == jengine.spec_stats()


def test_identical_draft_full_acceptance_and_midblock_stops(target, drafts):
    """Draft == target on one engine, one slot reused by three requests:
    full acceptance (gamma + 1 tokens a round, the bonus token), an eos
    landing mid-block, and a max_new_tokens that is not a multiple of
    gamma + 1 truncate exactly as greedy decoding does; spec_stats equal
    the JAX speculative engine's on the same requests."""
    engine = _spec_engine(target, drafts["identical"], num_slots=1)
    jengine = _jax_spec_engine(target, drafts["identical"], num_slots=1)
    prompt, prompt2 = [5, 17, 31, 2], [9, 9, 1, 42]
    full = reference_greedy(target, prompt2, 12)
    eos = full[2]
    cases = [(tserving.Request("f", prompt, 12),
              reference_greedy(target, prompt, 12)),
             (tserving.Request("e", prompt2, 12, eos_id=eos),
              full[:full.index(eos) + 1]),
             (tserving.Request("t", prompt2, 8),
              reference_greedy(target, prompt2, 8))]
    for req, want in cases:
        engine.submit(req)
        assert _drain(engine)[req.request_id] == want, req.request_id
        jengine.submit(jserving.Request(req.request_id, req.prompt,
                                        req.max_new_tokens,
                                        eos_id=req.eos_id))
        _drain(jengine)
        if req.request_id == "f":
            stats = engine.spec_stats()
            assert stats["accepted"] == stats["proposed"] > 0
            assert stats["acceptance_rate"] == 1.0
    assert engine.spec_stats() == jengine.spec_stats()


def _check_pool_whole(engine, pages):
    pool = list(engine._free_pages) + list(engine._lru)
    assert len(pool) == len(set(pool)) == pages
    assert all(ref == 0 for ref in engine._page_ref.values())


def test_paged_target_crosses_pages_up_to_max_decode_len(target, drafts):
    """prompt + max_new_tokens == max_decode_len, verify blocks crossing
    page boundaries, the last ones from max_decode_len - 2 spilling their
    tails onto the scratch page: the streams are greedy's and every page
    returns to the pool."""
    rng = np.random.RandomState(4)
    p1 = [int(t) for t in rng.randint(0, 97, (8,))]
    p2 = [int(t) for t in rng.randint(0, 97, (5,))]
    engine = _spec_engine(target, drafts["perturbed"], max_decode_len=32,
                          kv_page_size=8)
    assert engine.max_blocks == 5     # ceil((32 + gamma) / 8)
    engine.submit(tserving.Request("b1", p1, 24))
    engine.submit(tserving.Request("b2", p2, 20))
    results = _drain(engine)
    assert results["b1"] == reference_greedy(target, p1, 24, 32)
    assert results["b2"] == reference_greedy(target, p2, 20, 32)
    _check_pool_whole(engine, 8)


def test_overcommit_preemption_with_speculation(target, drafts):
    """A pool far below the aggregate worst case preempts victims
    mid-speculation; resumption re-prefills the target AND the draft
    cache with prompt + resumed tokens, and the streams stay greedy's."""
    reqs = _requests(5, 4, 6, 18)
    engine = _spec_engine(target, drafts["perturbed"], gamma=2,
                          max_decode_len=32, kv_page_size=8, kv_num_pages=5,
                          overcommit=True)
    for rid, prompt, max_new in reqs:
        engine.submit(tserving.Request(rid, prompt, max_new))
    results = _drain(engine)
    assert engine.preemptions > 0
    for rid, prompt, max_new in reqs:
        assert results[rid] == reference_greedy(target, prompt, max_new,
                                                32), rid
    _check_pool_whole(engine, 5)


@pytest.mark.parametrize("paged", [None, 8])
def test_int8_kv_matches_the_nonspeculative_int8_engine(target, drafts,
                                                         paged):
    """int8 K/V (the target's cache, and the draft's dense one): the
    speculative streams equal the port's non-speculative int8 engine's
    (int8 rounding changes tokens against fp32 greedy, not against
    itself)."""
    reqs = _requests(9, 5, 6, 14)
    engine = _spec_engine(target, drafts["perturbed"], kv_page_size=paged,
                          kv_cache_dtype="int8")
    plain = tserving.ContinuousBatcher(
        _cfg(TARGET, kv_cache_dtype="int8")[1],
        convert.params_from_flax(target), num_slots=2, max_decode_len=64,
        kv_page_size=paged, device="cpu")
    for e in (engine, plain):
        for rid, prompt, max_new in reqs:
            e.submit(tserving.Request(rid, prompt, max_new))
    assert _drain(engine) == _drain(plain)
    assert 0 < engine.spec_stats()["accepted"]


def test_speculative_rejects_bad_configs(target, drafts):
    with pytest.raises(ValueError, match="temperature"):
        _spec_engine(target, drafts["hostile"],
                     sampling=tinf.SamplingConfig(temperature=0.7))
    with pytest.raises(ValueError, match="gamma"):
        _spec_engine(target, drafts["hostile"], gamma=0)
    with pytest.raises(ValueError, match="kv_page_size"):
        _spec_engine(target, (dict(DRAFT, kv_page_size=8),
                              drafts["hostile"][1]))
    with pytest.raises(ValueError, match="vocab_size"):
        _spec_engine(target, (dict(DRAFT, vocab_size=96),
                              drafts["hostile"][1]))


def test_frontend_exposes_speculative_counters(target, drafts):
    engine = _spec_engine(target, drafts["perturbed"], gamma=3)
    front = ServingFrontEnd(engine, port=0).start()
    try:
        front.generate({"prompt": [4, 8, 15], "max_new_tokens": 9})
        with urllib.request.urlopen(f"{front.url}/v1/stats",
                                    timeout=30) as resp:
            stats = json.loads(resp.read())
        with urllib.request.urlopen(f"{front.url}/metrics",
                                    timeout=30) as resp:
            text = resp.read().decode()
    finally:
        front.shutdown()
    spec = stats["speculative"]
    assert spec == engine.spec_stats()
    assert spec["gamma"] == 3 and spec["proposed"] > 0
    assert 0.0 <= spec["acceptance_rate"] <= 1.0
    for name, value in (("rounds_total", spec["rounds"]),
                        ("proposed_tokens_total", spec["proposed"]),
                        ("accepted_tokens_total", spec["accepted"]),
                        ("acceptance_rate", spec["acceptance_rate"])):
        assert f"shipyard_serving_spec_{name} {float(value):.17g}" in text


SERVE = ["--device", "cpu", "--d-model", "32", "--n-layers", "2",
         "--n-heads", "2", "--d-ff", "64", "--vocab", "97",
         "--num-slots", "2", "--max-decode-len", "64", "--speculative",
         "--gamma", "3", "--draft-d-model", "16", "--draft-n-layers", "1"]


def test_serve_cli_speculative_loadgen(tmp_path):
    report_path = tmp_path / "report.json"
    cmd = [sys.executable, "-m", "batch_shipyard_tpu_torch.workloads.serve",
           *SERVE, "--kv-page-size", "8", "--loadgen", "4", "--rate", "50",
           "--prompt-len", "4", "12", "--gen-tokens", "2", "6",
           "--port", "0", "--report", str(report_path)]
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(report_path.read_text())
    assert report["completed"] == 4 and report["failed"] == 0
    spec = report["speculative"]
    assert spec["gamma"] == 3 and spec["proposed"] > 0
    assert spec["acceptance_rate"] == spec["accepted"] / spec["proposed"]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == report


def test_serve_draft_restored_from_a_checkpoint(tmp_path, capsys):
    """--draft-checkpoint-dir serves the draft parameters of a
    train_transformer save (the latest committed step); without it the
    draft's weights come from --seed + 7."""
    config = ttrain.make_transformer_config(
        dtype=torch.float32, max_seq_len=16, vocab_size=97, d_model=16,
        n_layers=1, n_heads=2, d_head=8, d_ff=48)
    harness = ttrain.build_transformer_train(config, batch_size=2,
                                             seq_len=16, seed=3,
                                             device="cpu")
    checkpoint.save(str(tmp_path), 4, harness)
    saved = harness.model.state_dict()
    args = serve.parse_args(SERVE + ["--draft-checkpoint-dir",
                                     str(tmp_path)])
    engine = serve.build_engine(args)
    assert capsys.readouterr().out.strip() == \
        f"serving checkpoint step 4 from {tmp_path}"
    draft = engine._draft_model.state_dict()
    assert set(draft) == set(saved)
    for name, t in saved.items():
        torch.testing.assert_close(draft[name].float(),
                                   t.to(draft[name].dtype).float())
    seeded = serve.build_engine(serve.parse_args(SERVE))
    drawn = serve.bench_params(seeded.speculative.draft_config,
                               torch.device("cpu"), args.seed + 7)
    assert all(torch.equal(seeded.speculative.draft_params[k], drawn[k])
               for k in drawn)


# The CUDA graph's preconditions, checked on the CPU: the captured
# speculative step reads and writes fixed addresses, so no state tensor
# of either cache may be rebound, and page growth reads the host mirror
# of the positions.


def _state_addresses(engine):
    tensors = {"tokens": engine._tokens, "positions": engine._positions,
               "active": engine._active}
    for name, cache in (("t", engine.cache), ("d", engine._draft_cache)):
        for i, layer in enumerate(cache):
            for key, t in layer.items():
                tensors[f"{name}{i}.{key}"] = t
    return {name: t.data_ptr() for name, t in tensors.items()}


class _EagerGraph:
    """Stands in for the captured graph on the CPU: each replay runs the
    speculative step eagerly into one fixed output tensor."""

    def __init__(self, engine):
        self.engine = engine
        self.out = torch.zeros((engine.num_slots, engine.gamma + 2),
                               dtype=torch.int32)
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.out.copy_(
            tserving.ContinuousBatcher._eager_speculative(self.engine))


@pytest.mark.parametrize("paged", [None, 8])
def test_replayed_speculative_steps_stay_in_place(target, drafts, paged):
    """step() through the replay path (a fixed output tensor) streams as
    the eager engine does, one replay a step and no eager step, with no
    state tensor moved and the host positions equal to the device's
    after every step, across admissions, mid-block stops and frees; the
    overcommit pool preempts and re-prefills too."""
    kwargs = dict(kv_page_size=paged)
    if paged:
        kwargs.update(max_decode_len=32, kv_num_pages=5, overcommit=True)
    reqs = _requests(6, 5, 6, 18)
    eager = _spec_engine(target, drafts["perturbed"], **kwargs)
    replayed = _spec_engine(target, drafts["perturbed"], **kwargs)
    graph = _EagerGraph(replayed)
    replayed._graph, replayed._graph_tokens = graph, graph.out
    eager_steps = []
    replayed._eager_speculative = lambda: eager_steps.append(1)
    addresses = _state_addresses(replayed)
    for e in (eager, replayed):
        for rid, prompt, max_new in reqs:
            e.submit(tserving.Request(rid, prompt, max_new))
    want = _drain(eager)
    got = {}
    for _ in range(400):
        for rid, tokens in replayed.step():
            got[rid] = [int(t) for t in tokens]
        assert _state_addresses(replayed) == addresses
        for i, slot in enumerate(replayed._slots):
            if slot.request is not None:
                assert replayed._positions_host[i] == \
                    int(replayed._positions[i])
        if not replayed.pending():
            break
    assert got == want
    assert graph.replays == replayed.decode_steps == eager.decode_steps
    assert not eager_steps
    if paged:
        assert replayed.preemptions > 0
