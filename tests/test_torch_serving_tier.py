"""The serving tier around the port's engine on the CPU, held against the
JAX package: the front end's drain ladder (503 on /healthz and on new
work with Retry-After, the queue evicted, decodes abandoned after the
grace with the draining marker, the preempt notice arming it, shedding
suspended), resume (re-prefill of resume_tokens, the cached replay, the
in-flight refusal, the 429 exemption), streams resumed on a sibling
after a drain and after kill() against the JAX engine's unfaulted
stream, per-request spans against the reference's, build_slo,
diurnal_arrivals, and serve.py with --replicas, --slo-config and
--arrival diurnal end to end."""

import argparse
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

from batch_shipyard_tpu.models import serving as jserving
from batch_shipyard_tpu.models import transformer as jtfm
from batch_shipyard_tpu.models.server import ServingFrontEnd as JFrontEnd
from batch_shipyard_tpu.sim import traces as jtraces
from batch_shipyard_tpu.workloads import serve as jserve
from batch_shipyard_tpu_torch.agent import preemption
from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import serving as tserving
from batch_shipyard_tpu_torch.models import transformer as ttfm
from batch_shipyard_tpu_torch.models.loadgen import load_requests
from batch_shipyard_tpu_torch.models.router import ServingRouter
from batch_shipyard_tpu_torch.models.server import ServingFrontEnd
from batch_shipyard_tpu_torch.sim import traces as ttraces
from batch_shipyard_tpu_torch.workloads import serve as tserve

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


def _throttle(engine, delay):
    """A sleep before every engine step, so a stream is provably live
    when a fault lands."""
    step = engine.step

    def slow_step():
        time.sleep(delay)
        return step()
    engine.step = slow_step


def _engine(params, step_delay=0.0, **kwargs):
    engine = tserving.ContinuousBatcher(TCFG, params[1], num_slots=2,
                                        max_decode_len=64, device="cpu",
                                        **kwargs)
    if step_delay:
        _throttle(engine, step_delay)
    return engine


def _front(params, step_delay=0.0, engine_kwargs=None, **kwargs):
    return ServingFrontEnd(_engine(params, step_delay,
                                   **(engine_kwargs or {})),
                           port=0, **kwargs).start()


def _post_raw(url, payload):
    req = urllib.request.Request(
        f"{url}/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read()), dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read()), dict(exc.headers)


def _get_raw(url, path):
    try:
        with urllib.request.urlopen(f"{url}{path}", timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


class _Stream(threading.Thread):
    """A background NDJSON client: token lines, then the final object."""

    def __init__(self, url, spec):
        super().__init__(daemon=True)
        self.spec, self.url = dict(spec, stream=True), url
        self.tokens, self.indexes, self.final = [], [], None
        self.start()

    def run(self):
        req = urllib.request.Request(
            f"{self.url}/v1/generate", data=json.dumps(self.spec).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            for line in resp:
                event = json.loads(line)
                if "index" in event:
                    self.tokens.append(event["token"])
                    self.indexes.append(event["index"])
                else:
                    self.final = event

    def await_tokens(self, n, timeout=30.0):
        deadline = time.monotonic() + timeout
        while len(self.tokens) < n:
            assert time.monotonic() < deadline, f"no {n} tokens"
            time.sleep(0.01)


def _reference(params, specs):
    """The JAX engine's undisturbed greedy tokens for each spec."""
    engine = jserving.ContinuousBatcher(JCFG, params[0], num_slots=2,
                                        max_decode_len=64)
    for s in specs:
        engine.submit(jserving.Request(s["request_id"], s["prompt"],
                                       s["max_new_tokens"]))
    out = {}
    while engine.pending():
        for rid, tokens in engine.step():
            out[rid] = [int(t) for t in tokens]
    return out


# ------------------------------ drain ladder ---------------------------

def test_drain_refuses_admissions_and_healthz_reports(params):
    front = _front(params)
    try:
        assert json.loads(_get_raw(front.url, "/v1/stats")[1])[
            "draining"] is False
        front.drain(grace_s=5.0, reason="test")
        assert front.draining
        status, body, headers = _post_raw(
            front.url, {"prompt": [1, 2], "max_new_tokens": 2})
        assert status == 503 and body.get("draining") is True
        assert headers.get("Retry-After") == "1"
        status, body = _get_raw(front.url, "/healthz")
        assert status == 503 and json.loads(body) == {"ok": False,
                                                      "draining": True}
        stats = json.loads(_get_raw(front.url, "/v1/stats")[1])
        assert stats["draining"] is True and stats["drain_rejections"] == 1
        metrics = _get_raw(front.url, "/metrics")[1].decode()
        assert "shipyard_serving_draining 1" in metrics
        assert "shipyard_serving_drain_rejections_total 1" in metrics
        deadline = front._drain_deadline
        front.drain(grace_s=99.0, reason="again")
        assert front._drain_deadline == deadline
    finally:
        front.shutdown()


def test_drain_abandons_actives_and_evicts_queued(params):
    front = _front(params, step_delay=0.05, drain_grace_s=0.2)
    try:
        actives = [_Stream(front.url, {"request_id": f"drain-a{i}",
                                       "prompt": [3 + i, 7],
                                       "max_new_tokens": 50})
                   for i in range(2)]
        for stream in actives:
            stream.await_tokens(2)
        queued = _Stream(front.url, {"request_id": "drain-q",
                                     "prompt": [9, 4],
                                     "max_new_tokens": 50})
        deadline = time.monotonic() + 30
        while True:
            status, body = _get_raw(front.url, "/v1/requests/drain-q")
            if status == 200 and json.loads(body)["phase"] == "queued":
                break
            assert time.monotonic() < deadline
            time.sleep(0.02)
        front.drain(reason="test")
        for stream in actives + [queued]:
            stream.join(timeout=30)
            assert not stream.is_alive()
        for stream in actives:
            assert stream.final.get("draining") is True
            assert 0 < len(stream.tokens) < 50
        assert queued.final.get("draining") is True
        assert queued.tokens == []
    finally:
        front.shutdown()


def test_arm_preempt_drain_fires_on_notice(params, tmp_path,
                                          monkeypatch):
    notice = str(tmp_path / "preempt.json")
    monkeypatch.delenv(preemption.PREEMPT_REQUEST_FILE_ENV, raising=False)
    front = _front(params)
    try:
        # No notice channel: nothing to arm.
        assert front.arm_preempt_drain() is False
        assert front.arm_preempt_drain(path=notice, grace_s=1.0,
                                       poll_interval=0.02)
        assert not front.draining
        preemption.write_request(notice, reason="test notice")
        deadline = time.monotonic() + 10
        while not front.draining:
            assert time.monotonic() < deadline
            time.sleep(0.02)
        assert "test notice" in front._drain_reason
    finally:
        front.shutdown()


def test_shed_suspended_while_draining_and_resumed_exempt(params):
    engine = _engine(params, slo_shed_grace_ms=1.0)
    shed = []
    engine.on_shed = lambda rid, why: shed.append(rid)
    engine.submit(tserving.Request("shed-me", [1, 2], 8,
                                   ttft_target_ms=0.01))
    engine.submit(tserving.Request("resumed", [1, 2], 8,
                                   ttft_target_ms=0.01), resumed=[5])
    later = time.monotonic() + 60.0
    engine.draining = True
    engine._shed_expired(later)
    assert engine.slo_sheds == 0 and not shed
    engine.draining = False
    engine._shed_expired(later)
    assert shed == ["shed-me"]
    assert [e.request.request_id for e in engine._queue] == ["resumed"]


def test_overload_shed_is_503_and_counted(params):
    """A queued request past its TTFT deadline by more than the shed
    grace, behind two long decodes: 503 with "shed", counted in its
    class and in the engine's sheds."""
    front = _front(params, step_delay=0.05,
                   engine_kwargs=dict(slo_shed_grace_ms=1.0))
    try:
        actives = [_Stream(front.url, {"request_id": f"busy{i}",
                                       "prompt": [2 + i],
                                       "max_new_tokens": 30})
                   for i in range(2)]
        for stream in actives:
            stream.await_tokens(1)
        status, body, _ = _post_raw(front.url, {
            "request_id": "late", "prompt": [5], "max_new_tokens": 2,
            "ttft_target_ms": 1.0})
        assert status == 503 and body.get("shed") is True
        stats = front.stats()
        assert stats["slo"]["classes"]["standard"]["shed"] == 1
        assert stats["slo"]["sheds"] == 1
        for stream in actives:
            stream.join(timeout=60)
            assert stream.final["num_tokens"] == 30
    finally:
        front.shutdown()


# --------------------------------- resume ------------------------------

def test_resume_reprefills_replays_and_is_exempt(params):
    """resume_tokens re-prefill and continue the reference's stream with
    global indexes; a resume of a live id is refused (400), of a
    finished one replays the cached result; resumes pass the 429 cap."""
    prompt, n = [5, 17, 31, 2], 8
    want = _reference(params, [{"request_id": "r", "prompt": prompt,
                                "max_new_tokens": n}])["r"]
    front = _front(params, step_delay=0.03, max_inflight=1)
    try:
        client = _Stream(front.url, {"request_id": "r", "prompt": prompt,
                                     "max_new_tokens": n,
                                     "resume_tokens": want[:3]})
        client.join(timeout=60)
        assert client.indexes == list(range(3, n))
        assert want[:3] + client.tokens == want == client.final["tokens"]
        status, body, _ = _post_raw(front.url, {
            "request_id": "r", "prompt": prompt, "max_new_tokens": n,
            "resume_tokens": want[:5]})
        assert status == 200 and body["cached"] is True
        assert body["tokens"] == want
        live = _Stream(front.url, {"request_id": "live", "prompt": [8, 3],
                                   "max_new_tokens": 16})
        live.await_tokens(2)
        status, body, _ = _post_raw(front.url, {
            "request_id": "live", "prompt": [8, 3], "max_new_tokens": 16,
            "resume_tokens": live.tokens[:1]})
        assert status == 400 and "in flight" in body["error"]
        status, body, _ = _post_raw(front.url, {
            "request_id": "extra", "prompt": [4], "max_new_tokens": 2})
        assert status == 429
        status, body, _ = _post_raw(front.url, {
            "request_id": "cap-resume", "prompt": [6, 1],
            "max_new_tokens": 4, "resume_tokens": [11]})
        assert status == 200 and len(body["tokens"]) == 4
        live.join(timeout=60)
        assert front.stats()["completed_requests"] == 3
    finally:
        front.shutdown()


@pytest.mark.parametrize("fault", ["drain", "kill", "kill_jax_sibling"])
def test_stream_resumed_on_sibling_matches_unfaulted(params, fault):
    """Streams through the port's router over two throttled replicas;
    the replica owning one stream drains (grace 0.1 s) or is killed
    mid-stream. Every assembled stream must equal the JAX engine's
    unfaulted stream, each index delivered once, and no stream lost.
    ``kill_jax_sibling``: the survivor is a JAX front end, so the resume
    crosses packages."""
    victim = _front(params, step_delay=0.03)
    if fault == "kill_jax_sibling":
        engine = jserving.ContinuousBatcher(JCFG, params[0], num_slots=2,
                                            max_decode_len=64)
        _throttle(engine, 0.03)
        sibling = JFrontEnd(engine, port=0).start()
    else:
        sibling = _front(params, step_delay=0.03)
    router = ServingRouter([victim.url, sibling.url],
                           health_interval=0.2).start()
    specs = [{"request_id": f"{fault}-{k}",
              "prompt": [(7 * k + i) % 97 for i in range(4 + k)],
              "max_new_tokens": 24} for k in range(3)]
    want = _reference(params, specs)
    try:
        streams = [_Stream(router.url, spec) for spec in specs]
        owned = []

        def victim_streams():
            owned[:] = [s for s in streams if len(s.tokens) >= 2 and
                        router._owner.get(s.spec["request_id"]) is not None
                        and router._owner[s.spec["request_id"]].url ==
                        victim.url]
            return owned
        deadline = time.monotonic() + 30
        while not victim_streams():
            assert time.monotonic() < deadline, "no live victim stream"
            time.sleep(0.01)
        if fault == "drain":
            victim.drain(grace_s=0.1, reason="test")
        else:
            victim.kill()
        for stream in streams:
            stream.join(timeout=60)
            assert not stream.is_alive()
        for stream in streams:
            rid = stream.spec["request_id"]
            assert stream.final is not None and "error" not in \
                stream.final, stream.final
            assert stream.indexes == list(range(24)), rid
            assert stream.tokens == want[rid] == stream.final["tokens"]
        # The router counts a recovered stream after its last chunk
        # reaches the client.
        deadline = time.monotonic() + 20
        while router.stats()["recovered_requests"] < len(owned) and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        stats = router.stats()
        assert stats["lost_streams"] == 0
        assert stats["recoveries"] >= 1
        assert stats["recovered_requests"] >= len(owned) >= 1
    finally:
        router.shutdown()
        for front in (victim, sibling):
            try:
                front.shutdown()
            except OSError:
                pass


# ---------------------------------- spans ------------------------------

def test_request_spans_have_reference_kinds_and_keys(params, tmp_path,
                                                    monkeypatch):
    monkeypatch.setenv("SHIPYARD_TRACE_ID", "a" * 32)
    monkeypatch.setenv("SHIPYARD_TRACE_SPAN_ID", "b" * 16)
    lines = {}
    for name, front in (("port", _front(params)), ("jax", JFrontEnd(
            jserving.ContinuousBatcher(JCFG, params[0], num_slots=2,
                                       max_decode_len=64),
            port=0).start())):
        sink = tmp_path / f"{name}.jsonl"
        monkeypatch.setenv("SHIPYARD_TRACE_FILE", str(sink))
        try:
            assert _post_raw(front.url, {"request_id": "span-1",
                                         "prompt": [4, 5, 6],
                                         "max_new_tokens": 3})[0] == 200
        finally:
            front.shutdown()
        lines[name] = [json.loads(x) for x in sink.read_text().splitlines()]

    def shape(records):
        return sorted((r["kind"], sorted(r), sorted(r["attrs"]))
                      for r in records)
    assert shape(lines["port"]) == shape(lines["jax"])
    kinds = {r["kind"]: r for r in lines["port"]}
    assert set(kinds) == {"serve_request", "serve_queued", "serve_prefill",
                          "serve_decode"}
    parent = kinds["serve_request"]
    assert parent["trace_id"] == "a" * 32
    assert parent["parent_span_id"] == "b" * 16
    for kind in ("serve_queued", "serve_prefill", "serve_decode"):
        assert kinds[kind]["parent_span_id"] == parent["span_id"]
        assert kinds[kind]["attrs"]["request_id"] == "span-1"
    assert parent["attrs"]["num_tokens"] == 3


def test_request_spans_are_sampled_as_the_reference(params, tmp_path,
                                                    monkeypatch):
    assert (ServingFrontEnd._SPAN_HEAD, ServingFrontEnd._SPAN_SAMPLE_EVERY
            ) == (JFrontEnd._SPAN_HEAD, JFrontEnd._SPAN_SAMPLE_EVERY)
    monkeypatch.setenv("SHIPYARD_TRACE_ID", "c" * 32)
    monkeypatch.setenv("SHIPYARD_TRACE_SPAN_ID", "d" * 16)
    sink = tmp_path / "spans.jsonl"
    monkeypatch.setenv("SHIPYARD_TRACE_FILE", str(sink))
    monkeypatch.setattr(ServingFrontEnd, "_SPAN_HEAD", 2)
    monkeypatch.setattr(ServingFrontEnd, "_SPAN_SAMPLE_EVERY", 3)
    front = _front(params)
    try:
        for k in range(7):
            assert _post_raw(front.url, {"request_id": f"s{k}",
                                         "prompt": [k + 1],
                                         "max_new_tokens": 1})[0] == 200
    finally:
        front.shutdown()
    parents = [json.loads(x) for x in sink.read_text().splitlines()]
    parents = [r["attrs"]["request_id"] for r in parents
               if r["kind"] == "serve_request"]
    # Requests 1 and 2 (the head), then every third: 3 and 6.
    assert parents == ["s0", "s1", "s2", "s5"]


# ------------------------------ SLO and load ---------------------------

def _slo_args(slo_config=None, shed=None, stall=None):
    return argparse.Namespace(slo_config=slo_config, shed_grace_ms=shed,
                              tpot_stall_factor=stall)


@pytest.mark.parametrize("case", ["default", "file", "overrides", "off"])
def test_build_slo_matches_reference(tmp_path, case):
    path = tmp_path / "slo.json"
    path.write_text(json.dumps({"serving": {"slo": {
        "classes": [{"name": "gold", "ttft_ms": 100.0, "tpot_ms": 20.0},
                    {"name": "bulk"}],
        "shed_grace_ms": 250.0, "tpot_stall_factor": 2.5}}}))
    args = {"default": _slo_args("default"),
            "file": _slo_args(str(path)),
            "overrides": _slo_args(str(path), shed=50.0, stall=8.0),
            "off": _slo_args()}[case]
    got, want = tserve.build_slo(args), jserve.build_slo(args)
    if case == "off":
        assert got is None and want is None
        return
    assert got.class_targets() == want.class_targets()
    assert got.shed_grace_ms == want.shed_grace_ms
    assert got.tpot_stall_factor == want.tpot_stall_factor
    if case == "default":
        assert set(got.class_targets()) == {"interactive", "standard",
                                            "batch"}


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_diurnal_arrivals_equal_reference(seed):
    for num, day, peak, trough in ((24, 20.0, 16.0, 4.0),
                                   (200, 60.0, 8.0, 1.5)):
        got = ttraces.diurnal_arrivals(seed, num, day, peak, trough)
        assert got == jtraces.diurnal_arrivals(seed, num, day, peak,
                                               trough)


def test_diurnal_load_requests_follow_the_curve():
    gaps, payloads = load_requests(
        24, 16.0, (9, 16), (4, 12), 4096, seed=0, shared_prefix_groups=2,
        shared_prefix_len=96, slo_classes={"a": {}, "b": {}},
        arrival="diurnal", day_seconds=20.0)
    times = jtraces.diurnal_arrivals(0, 24, 20.0, 16.0, 4.0)
    assert gaps == [b - a for a, b in zip(times, times[1:])]
    assert len(payloads) == 24
    assert all(len(p["prompt"]) >= 96 + 9 for p in payloads)
    with pytest.raises(ValueError, match="arrival"):
        load_requests(2, arrival="bursty")


def test_serve_cli_fleet_slo_diurnal(tmp_path):
    report_path = tmp_path / "report.json"
    cmd = [sys.executable, "-m", "batch_shipyard_tpu_torch.workloads.serve",
           "--device", "cpu", "--d-model", "32", "--n-layers", "2",
           "--n-heads", "2", "--d-ff", "64", "--vocab", "97",
           "--num-slots", "2", "--max-decode-len", "64",
           "--kv-page-size", "8", "--replicas", "2", "--loadgen", "8",
           "--rate", "50", "--slo-config", "default", "--arrival",
           "diurnal", "--prompt-len", "4", "12", "--gen-tokens", "2", "6",
           "--shared-prefix-groups", "1", "--shared-prefix-len", "16",
           "--port", "0", "--report", str(report_path)]
    proc = subprocess.run(cmd, cwd=tmp_path, capture_output=True,
                          text=True, timeout=240,
                          env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(report_path.read_text())
    assert report["completed"] == 8 and report["failed"] == 0
    assert report["arrival"] == "diurnal"
    assert report["router"]["replicas"] == 2
    assert report["router"]["dispatched"] >= 8
    assert set(report["slo_attainment"]) == {"interactive", "standard",
                                             "batch"}
    assert report["prefix_cache"]["total_prompt_tokens"] > 0
    assert "fleet router on" in proc.stdout
