"""The port's fleet router (models/router.py) on the CPU, over the port's
front ends and over a mixed fleet of one JAX front end and one port
front end: balancing, least-loaded dispatch, failover, sticky cancel,
the fleet-wide duplicate-id gate, prefix affinity, streaming, the
merged stats and metrics, and the standalone entry point. Tokens are
held against the JAX engine's greedy streams on the same weights."""

import json
import os
import pathlib
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from batch_shipyard_tpu.models import loadgen as jloadgen
from batch_shipyard_tpu.models import serving as jserving
from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu.models.server import ServingFrontEnd as JFrontEnd
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import serving as tserving
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.models.loadgen import run_load
from batch_shipyard_tpu_torch.models.router import ServingRouter
from batch_shipyard_tpu_torch.models.server import ServingFrontEnd

REPO = pathlib.Path(__file__).resolve().parent.parent
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


def _port_front(params, step_delay=0.0):
    engine = tserving.ContinuousBatcher(TCFG, params[1], num_slots=2,
                                        max_decode_len=64, device="cpu")
    if step_delay:
        # A sleep before every step keeps a long request in flight
        # while a case acts on it, however fast the host.
        step = engine.step
        engine.step = lambda: (time.sleep(step_delay), step())[1]
    return ServingFrontEnd(engine, port=0).start()


def _jax_front(params):
    engine = jserving.ContinuousBatcher(JCFG, params[0], num_slots=2,
                                        max_decode_len=64)
    return JFrontEnd(engine, port=0).start()


def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        f"{url}/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _stream(url, payload, timeout=120):
    req = urllib.request.Request(
        f"{url}/v1/generate",
        data=json.dumps(dict(payload, stream=True)).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        return [json.loads(line) for line in resp if line.strip()]


def _get(url, path):
    with urllib.request.urlopen(f"{url}{path}", timeout=30) as resp:
        return resp.status, resp.read()


def _poll(predicate, deadline_s=20.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _reference(params, payloads):
    """The JAX engine's greedy tokens for each payload, undisturbed."""
    engine = jserving.ContinuousBatcher(JCFG, params[0], num_slots=2,
                                        max_decode_len=64)
    for p in payloads:
        engine.submit(jserving.Request(p["request_id"], p["prompt"],
                                       p["max_new_tokens"]))
    out = {}
    while engine.pending():
        for rid, tokens in engine.step():
            out[rid] = [int(t) for t in tokens]
    return out


@pytest.fixture(scope="module")
def fleet(params):
    fronts = [_port_front(params, 0.01), _port_front(params, 0.01)]
    router = ServingRouter([f.url for f in fronts],
                           health_interval=0.2).start()
    yield router, fronts
    router.shutdown()
    for front in fronts:
        front.shutdown()


def _case_balances(router, fronts, params):
    payloads = [{"request_id": f"bal-{k}", "prompt": [1 + k, 2, 3],
                 "max_new_tokens": 3} for k in range(4)]
    want = _reference(params, payloads)
    seen = set()
    for p in payloads:
        out = _post(router.url, p)
        assert out["tokens"] == want[p["request_id"]]
        seen.add(out["_replica"])
    assert seen == {f.url for f in fronts}
    stats = json.loads(_get(router.url, "/v1/stats")[1])
    assert stats["healthy_replicas"] == 2
    assert all(s["completed"] >= 1 for s in stats["per_replica"])


def _case_least_loaded(router, fronts, params):
    done = {}
    thread = threading.Thread(target=lambda: done.setdefault(
        "r", _post(router.url, {"request_id": "long-run",
                                "prompt": [9, 9, 9],
                                "max_new_tokens": 60})), daemon=True)
    thread.start()
    busy = []
    assert _poll(lambda: busy.extend(
        s["url"] for s in router.replicas() if s["inflight"]) or busy)

    def other_idle():
        # The idle replica's load includes its last scraped backlog,
        # which a probe refreshes.
        return all(s["inflight"] == 0 and s["backlog"] == 0
                   for s in router.replicas() if s["url"] != busy[0])
    assert _poll(other_idle)
    short = _post(router.url, {"prompt": [4, 5], "max_new_tokens": 2})
    assert short["_replica"] != busy[0]
    thread.join(120)
    assert done["r"]["num_tokens"] == 60


def _case_sticky_cancel(router, fronts, params):
    result = {}

    def run():
        try:
            result["r"] = _post(router.url, {
                "request_id": "cancel-me", "prompt": [7, 7],
                "max_new_tokens": 60})
        except urllib.error.HTTPError as exc:
            result["code"] = exc.code
            result["body"] = json.loads(exc.read())
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert _poll(lambda: "cancel-me" in router._owner)
    assert _poll(lambda: router.cancel("cancel-me")[0] == 202)
    thread.join(60)
    assert result.get("code") == 409, result
    assert "cancelled" in result["body"]["error"]
    assert router.cancel("never-existed")[0] == 404


def _case_duplicate_id(router, fronts, params):
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault(
        "r", _post(router.url, {"request_id": "dup-id", "prompt": [6, 6],
                                "max_new_tokens": 50})), daemon=True)
    thread.start()
    assert _poll(lambda: "dup-id" in router._owner)
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(router.url, {"request_id": "dup-id", "prompt": [1],
                           "max_new_tokens": 1})
    # The reference's wire answer to a live duplicate: 400, "in flight".
    assert err.value.code == 400
    assert "in flight" in json.loads(err.value.read())["error"]
    thread.join(120)
    assert result["r"]["num_tokens"] == 50
    assert _post(router.url, {"request_id": "dup-id", "prompt": [2],
                              "max_new_tokens": 1})["num_tokens"] == 1


def _case_prefix_affinity(router, fronts, params):
    replicas = set()
    before = router.affinity_routed
    for k in range(4):
        out = _post(router.url, {"prompt": [3, 1, 4, k],
                                 "max_new_tokens": 2,
                                 "prefix_key": "system-prompt-a"})
        replicas.add(out["_replica"])
    assert len(replicas) == 1
    assert router.affinity_routed - before >= 3


def _case_streaming(router, fronts, params):
    payload = {"request_id": "stream-a", "prompt": [5, 6, 7],
               "max_new_tokens": 6}
    lines = _stream(router.url, payload)
    tokens = [line["token"] for line in lines if "token" in line]
    assert [line["index"] for line in lines if "token" in line] == \
        list(range(6))
    assert tokens == lines[-1]["tokens"] == _reference(
        params, [payload])["stream-a"]


def _case_stats_and_metrics(router, fronts, params):
    _post(router.url, {"prompt": [4, 2], "max_new_tokens": 3})
    stats = json.loads(_get(router.url, "/v1/stats")[1])
    for key in ("replicas", "healthy_replicas", "dispatched",
                "completed", "failed", "recoveries", "lost_streams",
                "per_replica", "ttft_ms", "ttft_hist"):
        assert key in stats
    # The router's sums are of the replicas' last scraped stats.
    assert _poll(lambda: router.stats()["completed_requests"] == sum(
        json.loads(_get(f.url, "/v1/stats")[1])["completed_requests"]
        for f in fronts))
    status, body = _get(router.url, "/metrics")
    text = body.decode()
    assert status == 200
    assert "shipyard_router_healthy_replicas 2" in text
    assert 'shipyard_router_ttft_ms_bucket{le="+Inf"}' in text
    for front in fronts:
        assert f'replica="{front.url}"' in text
    status, health = _get(router.url, "/healthz")
    assert status == 200 and json.loads(health)["healthy_replicas"] == 2


def _case_loadgens(router, fronts, params):
    """The port's run_load and the reference's both point at the router
    unchanged."""
    for load in (run_load, jloadgen.run_load):
        report = load(router.url, 6, rate_hz=100.0, prompt_len=(2, 6),
                      max_new_tokens=(2, 4), vocab_size=97, seed=3)
        assert report["completed"] == 6 and report["failed"] == 0


CASES = {
    "balances": _case_balances,
    "least_loaded": _case_least_loaded,
    "sticky_cancel": _case_sticky_cancel,
    "duplicate_id": _case_duplicate_id,
    "prefix_affinity": _case_prefix_affinity,
    "streaming": _case_streaming,
    "stats_and_metrics": _case_stats_and_metrics,
    "loadgens": _case_loadgens,
}


@pytest.mark.parametrize("case", list(CASES))
def test_router_over_port_fleet(fleet, params, case):
    router, fronts = fleet
    assert _poll(lambda: router.healthy_count() == 2)
    CASES[case](router, fronts, params)


def test_router_failover_and_503(params):
    """A replica that dies between probes: the dispatch itself fails
    over and flags it; with no replica left the router answers 503."""
    fronts = [_port_front(params), _port_front(params)]
    router = ServingRouter([f.url for f in fronts],
                           health_interval=30.0).start()
    try:
        fronts[1].shutdown()
        outs = [_post(router.url, {"prompt": [1, 2 + k],
                                   "max_new_tokens": 2})
                for k in range(3)]
        assert {o["_replica"] for o in outs} == {fronts[0].url}
        snap = {s["url"]: s for s in router.replicas()}
        assert not snap[fronts[1].url]["healthy"]
        assert snap[fronts[1].url]["unhealthy_total"] == 1
        fronts[0].shutdown()
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(router.url, {"prompt": [1], "max_new_tokens": 1})
        assert err.value.code == 503
    finally:
        router.shutdown()


def test_mixed_fleet_gives_reference_tokens(params):
    """The port's router over one JAX front end and one port front end:
    every request, plain and streamed, gets the reference's tokens, and
    both replicas serve."""
    fronts = [_jax_front(params), _port_front(params)]
    router = ServingRouter([f.url for f in fronts],
                           health_interval=0.2).start()
    try:
        payloads = [{"request_id": f"mix-{k}",
                     "prompt": [(k * 5 + i) % 97 for i in range(3 + k)],
                     "max_new_tokens": 4 + k} for k in range(6)]
        want = _reference(params, payloads)
        seen = set()
        for p in payloads[:4]:
            out = _post(router.url, p)
            assert out["tokens"] == want[p["request_id"]]
            seen.add(out["_replica"])
        for p in payloads[4:]:
            lines = _stream(router.url, p)
            assert [ln["token"] for ln in lines if "token" in ln] == \
                want[p["request_id"]] == lines[-1]["tokens"]
        assert seen == {f.url for f in fronts}
        # A stream's dispatch is released after its last chunk reaches
        # the client, so the count can trail the reply.
        assert _poll(lambda: router.stats()["completed"] == 6)
        assert router.stats()["failed"] == 0
    finally:
        router.shutdown()
        for front in fronts:
            front.shutdown()


def test_router_entry_point(params):
    """python -m batch_shipyard_tpu_torch.models.router URL... --port:
    the standalone router serves a running front end."""
    front = _port_front(params)
    proc = subprocess.Popen(
        [sys.executable, "-m", "batch_shipyard_tpu_torch.models.router",
         front.url, "--host", "127.0.0.1", "--port", "0",
         "--health-interval", "0.2"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=str(REPO)))
    try:
        line = proc.stdout.readline()
        assert line.startswith("router listening on http://127.0.0.1:")
        url = line.split()[3]
        out = _post(url, {"request_id": "cli", "prompt": [2, 7, 1],
                          "max_new_tokens": 3})
        assert out["_replica"] == front.url
        assert out["tokens"] == _reference(params, [{
            "request_id": "cli", "prompt": [2, 7, 1],
            "max_new_tokens": 3}])["cli"]
    finally:
        proc.terminate()
        proc.wait(30)
        proc.stdout.close()
        proc.stderr.close()
        front.shutdown()
