"""Load generator for the serving front end.

The port's own copy of batch_shipyard_tpu/models/loadgen.py: Poisson
arrivals or the fleet simulator's diurnal curve (sim/traces.py),
optional shared-prefix request groups and SLO classes, and the same
report keys (TTFT/TPOT/latency percentiles from merged fixed-bucket
histograms, tokens/s, the outputs digest). stdlib only;
``random.Random(seed)`` makes a run's requests reproducible.
"""

from __future__ import annotations

import hashlib
import json
import math
import random
import threading
import time
import urllib.error
import urllib.request
from typing import Optional, Sequence, Union

from batch_shipyard_tpu_torch.sim import traces as sim_traces
from batch_shipyard_tpu_torch.trace.histogram import LatencyHistogram


def _exact_percentile(values: list, q: float) -> float:
    """Nearest-rank percentile over the raw values (no binning)."""
    if not values:
        return 0.0
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def _post_generate(base_url: str, payload: dict, timeout: float) -> dict:
    req = urllib.request.Request(
        f"{base_url}/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def load_requests(num_requests: int, rate_hz: float = 8.0,
                  prompt_len: tuple[int, int] = (4, 32),
                  max_new_tokens: tuple[int, int] = (8, 32),
                  vocab_size: int = 97, seed: int = 0,
                  eos_id: Optional[int] = None,
                  shared_prefix_groups: int = 0,
                  shared_prefix_len: int = 0,
                  slo_classes: Optional[dict] = None,
                  arrival: str = "poisson", day_seconds: float = 60.0,
                  trough_rate_hz: Optional[float] = None
                  ) -> tuple[list, list]:
    """run_load's requests, drawn from ``random.Random(seed)``: the gaps
    between arrivals (seconds) and the /v1/generate payloads in arrival
    order, so a caller can replay the same prompts. ``arrival="poisson"``
    spaces them at ``rate_hz``; ``"diurnal"`` replays the fleet
    simulator's curve (peak ``rate_hz``, trough ``trough_rate_hz`` or
    rate_hz / 4, one virtual day of ``day_seconds``)."""
    rng = random.Random(seed)
    prefixes = [[rng.randrange(vocab_size)
                 for _ in range(shared_prefix_len)]
                for _ in range(shared_prefix_groups)]
    class_names = sorted(slo_classes) if slo_classes else []
    if arrival == "diurnal":
        trough = (trough_rate_hz if trough_rate_hz is not None
                  else rate_hz / 4.0)
        times = sim_traces.diurnal_arrivals(seed, num_requests,
                                            day_seconds, rate_hz, trough)
        gaps = [times[k + 1] - times[k] for k in range(num_requests - 1)]
    elif arrival == "poisson":
        gaps = [rng.expovariate(rate_hz) for _ in range(num_requests - 1)]
    else:
        raise ValueError(f"unknown arrival process: {arrival!r}")
    payloads = []
    for k in range(num_requests):
        plen = rng.randint(*prompt_len)
        prompt = [rng.randrange(vocab_size) for _ in range(plen)]
        payload = {
            "request_id": f"load-{seed}-{k}",
            "max_new_tokens": rng.randint(*max_new_tokens),
        }
        if prefixes:
            g = rng.randrange(len(prefixes))
            prompt = prefixes[g] + prompt
            payload["prefix_key"] = f"load-{seed}-g{g}"
        payload["prompt"] = prompt
        if class_names:
            payload["slo_class"] = class_names[k % len(class_names)]
        if eos_id is not None:
            payload["eos_id"] = eos_id
        payloads.append(payload)
    return gaps, payloads


def run_load(base_url: Union[str, Sequence[str]],
             num_requests: int,
             rate_hz: float = 8.0,
             prompt_len: tuple[int, int] = (4, 32),
             max_new_tokens: tuple[int, int] = (8, 32),
             vocab_size: int = 97,
             seed: int = 0,
             eos_id: Optional[int] = None,
             request_timeout: float = 300.0,
             arrival: str = "poisson",
             day_seconds: float = 60.0,
             trough_rate_hz: Optional[float] = None,
             shared_prefix_groups: int = 0,
             shared_prefix_len: int = 0,
             slo_classes: Optional[dict] = None) -> dict:
    """Fire ``num_requests`` at the arrivals of ``arrival`` (load_requests:
    Poisson at ``rate_hz``, or the diurnal curve) and return the latency
    report. With ``shared_prefix_groups`` > 0 each
    prompt starts with one of that many fixed ``shared_prefix_len``
    prefixes (and carries a matching ``prefix_key``). ``slo_classes``
    (name -> {"ttft_ms", "tpot_ms"}) cycles requests through the
    classes and adds per-class attainment. 503-shed requests count
    apart from failures. ``base_url`` may list several replicas;
    requests then round-robin across them."""
    urls = [base_url] if isinstance(base_url, str) else list(base_url)
    class_names = sorted(slo_classes) if slo_classes else []
    gaps, payloads = load_requests(
        num_requests, rate_hz, prompt_len, max_new_tokens, vocab_size,
        seed, eos_id, shared_prefix_groups, shared_prefix_len, slo_classes,
        arrival, day_seconds, trough_rate_hz)
    results: list[Optional[dict]] = [None] * num_requests
    errors: list[Optional[str]] = [None] * num_requests
    sheds: list[Optional[str]] = [None] * num_requests
    threads = []

    def one(k: int, url: str, payload: dict) -> None:
        try:
            result = _post_generate(url, payload, request_timeout)
            result["_replica"] = url
            results[k] = result
        except urllib.error.HTTPError as exc:
            try:
                body = json.loads(exc.read())
            except (ValueError, OSError):
                body = {}
            if exc.code == 503 and body.get("shed"):
                sheds[k] = payload.get("slo_class", "standard")
            else:
                errors[k] = f"HTTP {exc.code}: {body.get('error', '')}"
        except (urllib.error.URLError, OSError, TimeoutError) as exc:
            errors[k] = str(exc)

    started = time.perf_counter()
    for k, payload in enumerate(payloads):
        thread = threading.Thread(
            target=one, args=(k, urls[k % len(urls)], payload),
            daemon=True)
        thread.start()
        threads.append(thread)
        if k < num_requests - 1:
            time.sleep(gaps[k])
    for thread in threads:
        thread.join(request_timeout)
    elapsed = time.perf_counter() - started
    done = [r for r in results if r is not None]
    failed = [e for e in errors if e is not None]
    shed = [s for s in sheds if s is not None]
    tokens = sum(r["num_tokens"] for r in done)
    per_replica = {
        metric: {url: LatencyHistogram() for url in urls}
        for metric in ("ttft_ms", "tpot_ms", "latency_ms")}
    for r in done:
        for metric in ("ttft_ms", "tpot_ms", "latency_ms"):
            per_replica[metric][r["_replica"]].observe(r[metric])
    merged = {metric: LatencyHistogram.merged(hists.values())
              for metric, hists in per_replica.items()}
    report = {
        "num_requests": num_requests,
        "completed": len(done),
        "failed": len(failed),
        "shed": len(shed),
        "arrival": arrival,
        "offered_rate_hz": rate_hz,
        "elapsed_seconds": elapsed,
        "requests_per_second": len(done) / elapsed if elapsed else 0.0,
        "tokens_per_second": tokens / elapsed if elapsed else 0.0,
        "generated_tokens": tokens,
        "ttft_ms": merged["ttft_ms"].percentiles((50, 90, 99)),
        "tpot_ms": merged["tpot_ms"].percentiles((50, 90, 99)),
        "ttft_mean_ms": (sum(r["ttft_ms"] for r in done) / len(done)
                         if done else 0.0),
        "tpot_mean_ms": (sum(r["tpot_ms"] for r in done) / len(done)
                         if done else 0.0),
        "ttft_exact_ms": {
            f"p{q}": _exact_percentile([r["ttft_ms"] for r in done], q)
            for q in (50, 99)},
        "tpot_exact_ms": {
            f"p{q}": _exact_percentile([r["tpot_ms"] for r in done], q)
            for q in (50, 99)},
        "latency_ms": merged["latency_ms"].percentiles((50, 90, 99)),
        "ttft_hist": merged["ttft_ms"].to_dict(),
        "tpot_hist": merged["tpot_ms"].to_dict(),
    }
    if slo_classes:
        per_class: dict[str, dict] = {
            name: {"requests": 0, "completed": 0, "shed": 0,
                   "ttft_ok": 0, "tpot_ok": 0}
            for name in class_names}
        for s in shed:
            if s in per_class:
                per_class[s]["requests"] += 1
                per_class[s]["shed"] += 1
        for r in done:
            row = per_class.setdefault(
                r.get("slo_class", "standard"),
                {"requests": 0, "completed": 0, "shed": 0,
                 "ttft_ok": 0, "tpot_ok": 0})
            row["requests"] += 1
            row["completed"] += 1
            targets = slo_classes.get(r.get("slo_class")) or {}
            for metric, key in (("ttft_ms", "ttft_ok"),
                                ("tpot_ms", "tpot_ok")):
                target = targets.get(metric)
                if target is None or r[metric] <= target:
                    row[key] += 1
        for name, row in per_class.items():
            n = row["completed"]
            targets = slo_classes.get(name) or {}
            row["ttft_target_ms"] = targets.get("ttft_ms")
            row["tpot_target_ms"] = targets.get("tpot_ms")
            row["ttft_attainment"] = row["ttft_ok"] / n if n else None
            row["tpot_attainment"] = row["tpot_ok"] / n if n else None
        report["slo_attainment"] = per_class
    if shared_prefix_groups:
        report["shared_prefix_groups"] = shared_prefix_groups
        report["shared_prefix_len"] = shared_prefix_len
    # Digest of every completed request's token ids: equal engines at
    # the same seed agree.
    digest = hashlib.sha256()
    for r in sorted(done, key=lambda r: r["request_id"]):
        digest.update(f"{r['request_id']}:{r['tokens']};".encode())
    report["outputs_sha256"] = digest.hexdigest()
    if len(urls) > 1:
        by_replica: dict[str, int] = {}
        for r in done:
            by_replica[r["_replica"]] = by_replica.get(
                r["_replica"], 0) + 1
        report["replicas"] = len(urls)
        report["completed_by_replica"] = by_replica
    if failed:
        report["errors"] = failed[:8]
    return report
