"""The port's HTTP front end and load generator on the CPU: JSON and
NDJSON generate, health/stats/metrics/request-status, cancel, the 429
in-flight cap, and the serve.py CLI end to end in a subprocess."""

import json
import os
import pathlib
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest
import torch

from batch_shipyard_tpu_torch.models import convert
from batch_shipyard_tpu_torch.models import serving
from batch_shipyard_tpu_torch.models import transformer as tfm
from batch_shipyard_tpu_torch.models.loadgen import run_load
from batch_shipyard_tpu_torch.models.server import ServingFrontEnd

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = tfm.TransformerConfig(vocab_size=97, d_model=32, n_layers=2,
                            n_heads=2, d_head=16, d_ff=64,
                            dtype=torch.float32)


def _engine(**kwargs):
    params = convert.init_params(CFG, torch.Generator().manual_seed(3))
    return serving.ContinuousBatcher(CFG, params, num_slots=2,
                                     max_decode_len=64, device="cpu",
                                     **kwargs)


@pytest.fixture()
def front():
    server = ServingFrontEnd(_engine(kv_page_size=8)).start()
    yield server
    server.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return resp.status, resp.read()


def _post(url, payload):
    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=60)


def test_generate_json_and_stream_agree(front):
    payload = {"prompt": [5, 6, 7, 8], "max_new_tokens": 5,
               "request_id": "a"}
    with _post(front.url, payload) as resp:
        result = json.loads(resp.read())
    assert result["num_tokens"] == 5 and result["request_id"] == "a"
    for key in ("tokens", "ttft_ms", "tpot_ms", "latency_ms",
                "slo_class"):
        assert key in result
    with _post(front.url, dict(payload, request_id="b",
                               stream=True)) as resp:
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        lines = [json.loads(line) for line in resp.read().splitlines()]
    assert [e["index"] for e in lines[:-1]] == list(range(5))
    assert [e["token"] for e in lines[:-1]] == result["tokens"]
    assert lines[-1]["tokens"] == result["tokens"]


def test_health_stats_metrics_and_status(front):
    assert _get(front.url + "/healthz") == (200, b'{"ok": true}')
    with _post(front.url, {"prompt": [1, 2], "max_new_tokens": 3}) as r:
        r.read()
    status, body = _get(front.url + "/v1/stats")
    stats = json.loads(body)
    assert stats["completed_requests"] == 1
    assert stats["generated_tokens"] == 3
    assert set(stats["ttft_ms"]) == {"50", "90", "99"}
    assert "prefix_cache" in stats
    status, body = _get(front.url + "/metrics")
    assert b"shipyard_serving_completed_requests_total 1" in body
    assert b'shipyard_serving_ttft_ms_bucket{le="+Inf"} 1' in body
    with pytest.raises(urllib.error.HTTPError) as err:
        _get(front.url + "/v1/requests/nope")
    assert err.value.code == 404


def test_cancel_and_inflight_cap():
    engine = _engine()
    front = ServingFrontEnd(engine, max_inflight=1)
    # Engine thread not started: the first request stays in flight.
    front._http_thread.start()
    try:
        result = {}

        def first():
            try:
                _post(front.url, {"prompt": [1, 2, 3],
                                  "max_new_tokens": 4,
                                  "request_id": "held"}).read()
            except urllib.error.HTTPError as exc:
                result["code"] = exc.code
        thread = threading.Thread(target=first, daemon=True)
        thread.start()
        for _ in range(200):
            if front.knows("held"):
                break
            threading.Event().wait(0.01)
        status = front.request_status("held")
        assert status["phase"] == "queued"
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(front.url, {"prompt": [4], "max_new_tokens": 2})
        assert err.value.code == 429
        req = urllib.request.Request(front.url + "/v1/requests/held",
                                     method="DELETE")
        front._engine_thread.start()
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 202
        thread.join(60)
        assert not thread.is_alive()
        # Cancelled (409) unless it finished before the cancel landed.
        assert result.get("code") in (409, None)
    finally:
        front.shutdown()


def test_run_load_report(front):
    report = run_load(front.url, 6, rate_hz=200.0, prompt_len=(10, 20),
                      max_new_tokens=(2, 5), vocab_size=97, seed=1,
                      shared_prefix_groups=1, shared_prefix_len=16)
    assert report["completed"] == 6 and report["failed"] == 0
    for key in ("ttft_ms", "tpot_ms", "latency_ms", "tokens_per_second",
                "outputs_sha256", "ttft_hist", "shared_prefix_groups"):
        assert key in report
    assert report["generated_tokens"] >= 12


def test_serve_cli_cpu_loadgen(tmp_path):
    report_path = tmp_path / "report.json"
    cmd = [sys.executable, "-m", "batch_shipyard_tpu_torch.workloads.serve",
           "--device", "cpu", "--d-model", "32", "--n-layers", "2",
           "--n-heads", "2", "--d-ff", "64", "--vocab", "97",
           "--num-slots", "2", "--max-decode-len", "64",
           "--kv-page-size", "8", "--kv-cache-dtype", "int8",
           "--loadgen", "4", "--rate", "50", "--prompt-len", "4", "12",
           "--gen-tokens", "2", "6", "--port", "0",
           "--report", str(report_path)]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-2000:]
    report = json.loads(report_path.read_text())
    assert report["completed"] == 4 and report["failed"] == 0
    assert report["device"] == "cpu"
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == report
