"""Serving-tier chaos drills: replica kill, replica drain, router
restart.

The batch drills (chaos/drill.py) prove the scheduler's recovery
layer; these prove the SERVING fleet's (models/server.py drain
ladder, models/router.py mid-stream recovery). Each drill stands up a
real two-replica fleet — in-process ServingFrontEnds over tiny fp32
engines, a real ServingRouter, real HTTP streaming clients —
replays one seeded injection from a ChaosPlan, and asserts the
serving acceptance invariants:

  * ZERO lost requests: every client stream ends with a final result
    line, and the router's lost_streams counter stays 0,
  * EXACTLY-ONCE token delivery: every client's token indexes are
    contiguous from 0 with no duplicates across the failover, and the
    fleet's completed-decode count equals the request count (no
    request ever decoded to completion twice),
  * BYTE-IDENTICAL greedy streams: the tokens a client assembles
    across the fault equal a clean replica's greedy decode of the
    same request, token for token,
  * the ``serving_recovery`` goodput leg is populated with the
    measured recovery windows and the partition stays exact.

Greedy decode is deterministic, so the byte-identical yardstick is
computed once per drill from an untouched reference replica. The
engines are throttled (a small sleep per decode step) so the seeded
injection provably lands MID-stream — every drill asserts its fault
was non-vacuous (recoveries >= 1, resumed_tokens strictly inside
(0, max_new_tokens)).

The port's copy of batch_shipyard_tpu/chaos/serving_drill.py over the
port's ContinuousBatcher, ServingFrontEnd and ServingRouter, used by
`shipyard-tpu-torch chaos drill --serve-kill|--serve-drain|
--serve-router`. The drill's model is the reference's (vocab 97, d 32,
2 layers, fp32, 2 slots, max length 64, the dense cache), its weights
``drill_params`` (the port's init at seed 7, where the reference inits
flax at PRNGKey(7)). Each drill takes a ``device``: None means the card
(``device.resolve_device``, which raises without one), "cpu" only when
asked; the report's ``device`` reads back where the engines' weights
lie. The router drill also records its successor's lost streams.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import os
import random
import tempfile
import threading
import time
import urllib.error
import urllib.request
from typing import Optional

from batch_shipyard_tpu_torch.chaos.drill import _assert_partition_exact
from batch_shipyard_tpu_torch.chaos.plan import ChaosPlan
from batch_shipyard_tpu_torch.goodput import events as gp_events
from batch_shipyard_tpu_torch.state.memory import MemoryStateStore
from batch_shipyard_tpu_torch.utils import util

logger = util.get_logger(__name__)

POOL_ID = "serving-drill"


# ------------------------------ harness --------------------------------

def drill_params(cfg, device) -> dict:
    """The fleet's one parameter set, made on ``device`` from a
    generator seeded 7 (the reference's PRNGKey(7))."""
    import torch

    from batch_shipyard_tpu_torch.models import convert
    return convert.init_params(
        cfg, torch.Generator(device=device).manual_seed(7))


def drill_config():
    """The drill's model: vocab 97, d 32, 2 layers, fp32."""
    import torch

    from batch_shipyard_tpu_torch.models import transformer as tfm
    return tfm.TransformerConfig(
        vocab_size=97, d_model=32, n_layers=2, n_heads=2, d_head=16,
        d_ff=64, max_seq_len=64, dtype=torch.float32,
        param_dtype=torch.float32)


def _build_fleet(num_replicas: int, step_delay: float, device=None,
                 **front_kwargs):
    """A tiny fp32 serving fleet on ``device``: shared params (greedy
    decode is then identical across replicas), one throttled engine per
    front end so injections land mid-stream."""
    from batch_shipyard_tpu_torch import device as device_mod
    from batch_shipyard_tpu_torch.models import serving
    from batch_shipyard_tpu_torch.models.server import ServingFrontEnd

    dev = device_mod.resolve_device(device)
    cfg = drill_config()
    params = drill_params(cfg, dev)
    engines = [_warm_engine(serving, cfg, params, dev)
               for _ in range(num_replicas)]
    fronts = []
    for engine in engines:
        if step_delay:
            _throttle(engine, step_delay)
        fronts.append(
            ServingFrontEnd(engine, port=0, **front_kwargs).start())
    return cfg, params, fronts


def _warm_engine(serving, cfg, params, dev):
    """One replica's engine, warmed before any front end serves: on the
    card warm-up captures its decode and prefill graphs, and a capture
    holds the process's other engines (``serving._DeviceGate``), so every
    capture happens here, while the fleet is idle, and none stalls a
    drill's streams. The CPU runs the same warm-up."""
    engine = serving.ContinuousBatcher(cfg, params, num_slots=2,
                                       max_decode_len=64, device=dev)
    engine.warmup()
    return engine


def _engine_devices(fronts) -> list[str]:
    """Where the replicas' weights lie, read back from their engines."""
    return sorted({str(next(f.engine.model.parameters()).device)
                   for f in fronts})


def _throttle(engine, delay: float) -> None:
    """Slow the decode loop (a sleep per engine step) so a drill's
    streams are provably still live when its injection fires — the
    non-vacuousness every invariant depends on."""
    step = engine.step

    def slow_step():
        time.sleep(delay)
        return step()

    engine.step = slow_step


def _reference_outputs(cfg, params, specs: list[dict],
                       device=None) -> dict:
    """The byte-identical yardstick: a clean, unthrottled replica
    decodes every drill request fault-free; greedy decode is
    deterministic, so whatever the faulted fleet assembles must equal
    these tokens exactly."""
    from batch_shipyard_tpu_torch import device as device_mod
    from batch_shipyard_tpu_torch.models import serving
    from batch_shipyard_tpu_torch.models.server import ServingFrontEnd

    engine = _warm_engine(serving, cfg, params,
                          device_mod.resolve_device(device))
    front = ServingFrontEnd(engine, port=0).start()
    try:
        return {spec["request_id"]:
                [int(t) for t in _post_json(front.url, spec)["tokens"]]
                for spec in specs}
    finally:
        front.shutdown()


def _drill_requests(seed: int, count: int,
                    max_new_tokens: int) -> list[dict]:
    """Deterministic per-seed request set (prompts drawn from a
    seed-keyed RNG, like ChaosPlan draws its schedule)."""
    rng = random.Random(seed * 7919 + 11)
    return [{"request_id": f"serve-drill-{seed}-{i}",
             "prompt": [rng.randrange(1, 96)
                        for _ in range(rng.randrange(2, 6))],
             "max_new_tokens": max_new_tokens}
            for i in range(count)]


def _post_json(url: str, payload: dict, timeout: float = 120) -> dict:
    req = urllib.request.Request(
        f"{url}/v1/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _safe_json(body: bytes) -> dict:
    try:
        out = json.loads(body)
        return out if isinstance(out, dict) else {"raw": out}
    except ValueError:
        return {"raw": body.decode(errors="replace")}


def _request_raw(url: str, method: str = "GET",
                 payload: Optional[dict] = None,
                 timeout: float = 30) -> tuple[int, dict, dict]:
    """(status, json body, headers) without raising on HTTP errors —
    the drain-ladder assertions need the 503s' markers and
    Retry-After headers, not exceptions."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"}, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, _safe_json(resp.read()), \
                dict(resp.headers)
    except urllib.error.HTTPError as exc:
        return exc.code, _safe_json(exc.read()), dict(exc.headers)


def _await(cond, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class _StreamClient(threading.Thread):
    """One streaming request through the router: collects every token
    line and the final result — the exactly-once evidence is exactly
    what this client observed on the wire."""

    def __init__(self, url: str, spec: dict) -> None:
        super().__init__(
            daemon=True, name=f"drill-client-{spec['request_id']}")
        self.url = url
        self.spec = dict(spec, stream=True)
        self.token_events: list[dict] = []
        self.final: Optional[dict] = None
        self.error: Optional[str] = None
        self.duplicates = 0

    def run(self) -> None:
        try:
            self._read(self.url, self.spec)
        except Exception as exc:  # noqa: BLE001 - recorded, asserted
            self.error = f"{type(exc).__name__}: {exc}"

    def _read(self, url: str, spec: dict) -> None:
        req = urllib.request.Request(
            f"{url}/v1/generate", data=json.dumps(spec).encode(),
            headers={"Content-Type": "application/json"},
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as resp:
            for line in resp:
                if not line.strip():
                    continue
                self._handle(json.loads(line))

    def _handle(self, event: dict) -> None:
        if "token" in event and "index" in event:
            idx = int(event["index"])
            if any(int(e["index"]) == idx
                   for e in self.token_events):
                self.duplicates += 1
            self.token_events.append(event)
        elif "tokens" in event:
            self.final = event
        elif event.get("error"):
            self.error = str(event["error"])

    def tokens(self) -> list[int]:
        return [int(e["token"]) for e in self.token_events]


class _RecoveringClient(_StreamClient):
    """The router-crash client protocol (docs/37): when the stream
    dies without a final line, cancel the request through the
    SUCCESSOR router (the dead router's relay may have left the run
    live on a replica), then re-submit with ``resume_tokens`` set to
    the journaled progress. The replica's duplicate gate (400 while
    the old run is still winding down, CompletedReplay if it already
    finished) is what keeps delivery exactly-once."""

    def __init__(self, url: str, spec: dict) -> None:
        super().__init__(url, spec)
        self.successor_url: Optional[str] = None
        self.successor_ready = threading.Event()
        self.resumed = False
        self.resume_from = 0  # journaled tokens at resume time
        self.broke_wall: Optional[float] = None
        self.recovered_window: Optional[tuple[float, float]] = None
        self._resume_reading = False

    def run(self) -> None:
        try:
            self._read(self.url, self.spec)
        except (OSError, http.client.HTTPException,
                urllib.error.URLError):
            pass  # the router died under us — recover below
        if self.final is not None or self.error is not None:
            return
        self.broke_wall = time.time()
        if not self.successor_ready.wait(timeout=60):
            self.error = "no successor router appeared"
            return
        try:
            self._resume()
        except Exception as exc:  # noqa: BLE001 - recorded, asserted
            self.error = (f"resume failed: "
                          f"{type(exc).__name__}: {exc}")

    def _handle(self, event: dict) -> None:
        super()._handle(event)
        if self._resume_reading and self.recovered_window is None:
            self.recovered_window = (self.broke_wall, time.time())

    def _resume(self) -> None:
        request_id = self.spec["request_id"]
        # Cancel-then-resume step 1: free the id fleet-wide. 404 just
        # means no replica owns a live run (it finished — the replay
        # cache will serve the resume).
        _request_raw(
            f"{self.successor_url}/v1/requests/{request_id}",
            method="DELETE")
        spec = dict(self.spec, resume_tokens=self.tokens())
        self.resumed = True
        self.resume_from = len(spec["resume_tokens"])
        self._resume_reading = True
        deadline = time.monotonic() + 60
        while True:
            try:
                self._read(self.successor_url, spec)
                return
            except urllib.error.HTTPError as exc:
                body = exc.read()
                # The cancel is asynchronous on the replica's engine
                # thread: "in flight" 400s just mean not-yet — retry.
                if exc.code == 400 and b"in flight" in body and \
                        time.monotonic() < deadline:
                    time.sleep(0.05)
                    continue
                raise


def _check_stream(client: _StreamClient, reference: dict) -> None:
    request_id = client.spec["request_id"]
    assert client.error is None, f"{request_id}: {client.error}"
    assert client.final is not None, (
        f"{request_id}: stream ended without a final result line")
    assert client.duplicates == 0, (
        f"{request_id}: {client.duplicates} duplicate token indexes "
        f"reached the client (exactly-once broke)")
    indexes = [int(e["index"]) for e in client.token_events]
    assert indexes == list(range(len(indexes))), (
        f"{request_id}: token indexes not contiguous-from-zero: "
        f"{indexes}")
    tokens = client.tokens()
    assert tokens == [int(t) for t in client.final["tokens"]], (
        f"{request_id}: streamed tokens disagree with the final "
        f"result line")
    assert tokens == reference[request_id], (
        f"{request_id}: tokens diverged from the clean greedy "
        f"decode: {tokens} != {reference[request_id]}")


def _fleet_completed(fronts) -> int:
    return sum(f.stats()["completed_requests"] for f in fronts)


def _recovery_windows(recovery_log: list[dict]) -> list[dict]:
    return [{"start": e["at"] - e["recovery_seconds"], "end": e["at"],
             "request_id": e.get("request_id"),
             "resumed_tokens": e.get("resumed_tokens", 0)}
            for e in recovery_log
            if e.get("recovery_seconds", 0) > 0]


def _goodput_proof(report: dict, invariants: dict,
                   started_wall: float, ended_wall: float,
                   windows: list[dict]) -> None:
    """Price the drill like production would: the drill window is
    productive serving time, each measured recovery is a
    ``serving_recovery`` badput interval — the leg must be populated
    and the partition must stay exact."""
    store = MemoryStateStore()
    gp_events.emit(store, POOL_ID, gp_events.PROGRAM_STEP_WINDOW,
                   job_id="serving", task_id="drill",
                   start=started_wall, end=ended_wall,
                   attrs={"steps": len(windows) + 1})
    for window in windows:
        gp_events.emit(
            store, POOL_ID, gp_events.SERVE_RECOVERY,
            job_id="serving",
            task_id=window.get("request_id") or "drill",
            start=max(window["start"], started_wall),
            end=min(window["end"], ended_wall),
            attrs={"resumed_tokens": window.get("resumed_tokens", 0)})
    pool_report = _assert_partition_exact(store, POOL_ID, invariants)
    leg = pool_report["badput_seconds"].get("serving_recovery", 0.0)
    invariants["serving_recovery_seconds"] = leg
    assert leg > 0.0, (
        f"serving_recovery leg not populated: "
        f"{pool_report['badput_seconds']}")
    report["goodput"] = {
        "goodput_ratio": pool_report["goodput_ratio"],
        "badput_seconds": pool_report["badput_seconds"],
    }


def _pin_at(plan: ChaosPlan, lo: float = 0.05,
            hi: float = 0.25, **params) -> ChaosPlan:
    """Deterministic sequencing, like the batch drills: the fault
    must land with streams mid-decode. The drills gate on observed
    tokens (every stream >= 2) before honouring the offset, so the
    offset only needs to be a small floor past the gate — clamp it
    well under the throttled decode's runway (~0.8s for the default
    28 tokens at 0.03s/step), or a warm jit cache lets streams
    finish before the fault lands and the drill turns vacuous. Pins
    any drill-argument params too; still a pure function of the
    seed + arguments."""
    return dataclasses.replace(plan, injections=tuple(
        dataclasses.replace(
            inj, at=min(max(inj.at, lo), hi),
            params=tuple(sorted(
                {**dict(inj.params), **params}.items())))
        for inj in plan.injections))


def _shutdown_all(*servers) -> None:
    for server in servers:
        if server is None:
            continue
        try:
            server.shutdown()
        except Exception:  # noqa: BLE001 - already-killed servers
            pass


# ------------------------------- drills --------------------------------

def run_replica_kill_drill(seed: int = 0, num_requests: int = 4,
                           max_new_tokens: int = 28,
                           step_delay: float = 0.03,
                           wait_timeout: float = 120.0,
                           device=None) -> dict:
    """Replica-kill drill: a serving replica dies SIGKILL-style
    mid-decode (sockets severed, no drain, no final lines) under
    live streams. The router must detect the dead streams (bare EOF
    without a final line), resume each on the sibling via
    ``resume_tokens``, and keep every client's token stream
    exactly-once and byte-identical to a clean decode."""
    from batch_shipyard_tpu_torch.models.router import ServingRouter

    plan = _pin_at(ChaosPlan.generate(
        seed, duration=4.0, num_nodes=2, kinds=("replica_kill",)))
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    invariants = report["invariants"]
    specs = _drill_requests(seed, num_requests, max_new_tokens)
    cfg, params, fronts = _build_fleet(2, step_delay, device=device)
    report["device"] = _engine_devices(fronts)
    router = None
    started_wall = time.time()
    try:
        reference = _reference_outputs(cfg, params, specs,
                                       device=device)
        router = ServingRouter(
            [f.url for f in fronts], health_interval=0.1,
            retry_backoff_base=0.02).start()
        clients = [_StreamClient(router.url, spec) for spec in specs]
        started = time.monotonic()
        for client in clients:
            client.start()
        injection = plan.injections[0]
        _await(lambda: all(len(c.token_events) >= 2
                           for c in clients),
               wait_timeout, "every stream mid-decode")
        delay = started + injection.at - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        victim = fronts[injection.node_index % len(fronts)]
        victim.kill()
        report["applied"].append(dict(
            injection.to_dict(), victim=victim.url,
            applied_at=round(time.monotonic() - started, 3)))
        for client in clients:
            client.join(wait_timeout)
        assert not any(c.is_alive() for c in clients), (
            "stream clients hung past the drill window")
        for client in clients:
            _check_stream(client, reference)
        stats = router.stats()
        invariants["completed_streams"] = num_requests
        invariants["lost_streams"] = stats["lost_streams"]
        assert stats["lost_streams"] == 0, (
            f"lost streams: {stats['lost_streams']}")
        invariants["recoveries"] = stats["recoveries"]
        assert stats["recoveries"] >= 1, (
            "the kill never interrupted a stream (vacuous drill)")
        for entry in stats["recovery_log"]:
            if not entry.get("synthesized"):
                assert 0 < entry["resumed_tokens"] < max_new_tokens, (
                    f"recovery was not mid-stream: {entry}")
        completed = _fleet_completed(fronts)
        invariants["fleet_completed_requests"] = completed
        assert completed == num_requests, (
            f"exactly-once decode broke: {completed} completions "
            f"for {num_requests} requests")
        _goodput_proof(report, invariants, started_wall, time.time(),
                       _recovery_windows(stats["recovery_log"]))
        invariants["ok"] = True
    finally:
        _shutdown_all(router, *fronts)
    return report


def run_replica_drain_drill(seed: int = 0, num_requests: int = 4,
                            max_new_tokens: int = 28,
                            step_delay: float = 0.03,
                            grace: float = 0.25,
                            wait_timeout: float = 120.0,
                            device=None) -> dict:
    """Replica-drain drill: a preempt notice (the agent's cooperative
    channel, agent/preemption.py) lands on a replica under live
    streams. The full drain ladder must fire: healthz flips to
    503+draining (the router pulls it from rotation as COOPERATIVE,
    not a fault), direct admissions get 503+Retry-After with the
    draining marker, new routed requests land on the sibling, and
    decodes still active at the grace deadline are abandoned with a
    draining marker the router resumes from — zero lost requests,
    byte-identical streams."""
    from batch_shipyard_tpu_torch.agent import preemption
    from batch_shipyard_tpu_torch.models.router import ServingRouter

    plan = _pin_at(ChaosPlan.generate(
        seed, duration=4.0, num_nodes=2,
        kinds=("replica_drain_notice",)), grace=grace)
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    invariants = report["invariants"]
    specs = _drill_requests(seed, num_requests, max_new_tokens)
    cfg, params, fronts = _build_fleet(2, step_delay, device=device)
    report["device"] = _engine_devices(fronts)
    router = None
    started_wall = time.time()
    notice_path = os.path.join(
        tempfile.mkdtemp(prefix="shipyard-serve-drill-"),
        "preempt-request.json")
    try:
        reference = _reference_outputs(cfg, params, specs,
                                       device=device)
        injection = plan.injections[0]
        victim = fronts[injection.node_index % len(fronts)]
        survivor = fronts[1 - fronts.index(victim)]
        assert victim.arm_preempt_drain(
            path=notice_path, grace_s=injection.param("grace"),
            poll_interval=0.05), "preempt watcher failed to arm"
        router = ServingRouter(
            [f.url for f in fronts], health_interval=0.1,
            retry_backoff_base=0.02).start()
        clients = [_StreamClient(router.url, spec) for spec in specs]
        started = time.monotonic()
        for client in clients:
            client.start()
        _await(lambda: all(len(c.token_events) >= 2
                           for c in clients),
               wait_timeout, "every stream mid-decode")
        delay = started + injection.at - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        preemption.write_request(notice_path,
                                 reason="serving drain drill")
        report["applied"].append(dict(
            injection.to_dict(), victim=victim.url,
            applied_at=round(time.monotonic() - started, 3)))
        _await(lambda: victim.draining, 10.0,
               "the preempt notice to flip the replica draining")
        # The drain ladder, rung by rung. healthz:
        code, payload, _ = _request_raw(f"{victim.url}/healthz")
        assert code == 503 and payload.get("draining"), (
            f"draining healthz: {code} {payload}")
        # direct admission:
        code, payload, headers = _request_raw(
            f"{victim.url}/v1/generate", method="POST",
            payload={"prompt": [2, 7], "max_new_tokens": 2})
        assert code == 503 and payload.get("draining"), (
            f"draining admission: {code} {payload}")
        assert headers.get("Retry-After"), (
            "draining 503 without Retry-After")
        # router rotation:
        _await(lambda: any(s["draining"]
                           for s in router.replicas()),
               10.0, "the router to observe the drain")
        probe = _post_json(router.url, {
            "request_id": f"serve-drill-{seed}-probe",
            "prompt": [3, 1, 4], "max_new_tokens": 2})
        assert probe["_replica"] == survivor.url, (
            f"routed to the draining replica: {probe['_replica']}")
        for client in clients:
            client.join(wait_timeout)
        assert not any(c.is_alive() for c in clients), (
            "stream clients hung past the drill window")
        for client in clients:
            _check_stream(client, reference)
        stats = router.stats()
        invariants["completed_streams"] = num_requests
        invariants["lost_streams"] = stats["lost_streams"]
        assert stats["lost_streams"] == 0, (
            f"lost streams: {stats['lost_streams']}")
        invariants["recoveries"] = stats["recoveries"]
        assert stats["recoveries"] >= 1, (
            "no decode was drain-abandoned (vacuous drill: raise "
            "max_new_tokens or lower grace)")
        snapshots = {s["url"]: s for s in router.replicas()}
        invariants["victim_unhealthy_total"] = \
            snapshots[victim.url]["unhealthy_total"]
        assert snapshots[victim.url]["unhealthy_total"] == 0, (
            "cooperative drain was counted as a fault")
        invariants["drain_rejections"] = \
            victim.stats()["drain_rejections"]
        assert invariants["drain_rejections"] >= 1
        completed = _fleet_completed(fronts)
        invariants["fleet_completed_requests"] = completed
        assert completed == num_requests + 1, (  # +1: the probe
            f"exactly-once decode broke: {completed} completions "
            f"for {num_requests + 1} requests")
        _goodput_proof(report, invariants, started_wall, time.time(),
                       _recovery_windows(stats["recovery_log"]))
        invariants["ok"] = True
    finally:
        _shutdown_all(router, *fronts)
    return report


def run_router_restart_drill(seed: int = 0, num_requests: int = 4,
                             max_new_tokens: int = 28,
                             step_delay: float = 0.03,
                             wait_timeout: float = 120.0,
                             device=None) -> dict:
    """Router-restart drill: the serving ROUTER process crashes
    mid-stream (every client connection severed) and a successor
    router takes over the same replica fleet after a short downtime.
    Clients run the documented cancel-then-resume protocol against
    the successor; the REPLICAS' duplicate gates (in-flight 400s,
    the completed-replay cache) — not any router state — must keep
    delivery exactly-once and byte-identical."""
    from batch_shipyard_tpu_torch.models.router import ServingRouter

    plan = _pin_at(ChaosPlan.generate(
        seed, duration=4.0, num_nodes=2, kinds=("router_restart",)))
    plan = dataclasses.replace(plan, injections=tuple(
        dataclasses.replace(inj, params=tuple(sorted(
            {**dict(inj.params),
             "downtime": min(max(inj.param("downtime", 0.2), 0.1),
                             0.3)}.items())))
        for inj in plan.injections))
    report: dict = {"seed": plan.seed,
                    "fingerprint": plan.fingerprint(),
                    "plan": plan.to_dict(),
                    "applied": [], "invariants": {}}
    invariants = report["invariants"]
    specs = _drill_requests(seed, num_requests, max_new_tokens)
    cfg, params, fronts = _build_fleet(2, step_delay, device=device)
    report["device"] = _engine_devices(fronts)
    router = successor = None
    started_wall = time.time()
    try:
        reference = _reference_outputs(cfg, params, specs,
                                       device=device)
        urls = [f.url for f in fronts]
        router = ServingRouter(urls, health_interval=0.1,
                               retry_backoff_base=0.02).start()
        clients = [_RecoveringClient(router.url, spec)
                   for spec in specs]
        started = time.monotonic()
        for client in clients:
            client.start()
        injection = plan.injections[0]
        _await(lambda: all(len(c.token_events) >= 2
                           for c in clients),
               wait_timeout, "every stream mid-decode")
        delay = started + injection.at - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        router.kill()
        report["applied"].append(dict(
            injection.to_dict(),
            applied_at=round(time.monotonic() - started, 3)))
        time.sleep(injection.param("downtime", 0.2))
        successor = ServingRouter(urls, health_interval=0.1,
                                  retry_backoff_base=0.02).start()
        for client in clients:
            client.successor_url = successor.url
            client.successor_ready.set()
        for client in clients:
            client.join(wait_timeout)
        assert not any(c.is_alive() for c in clients), (
            "stream clients hung past the drill window")
        for client in clients:
            _check_stream(client, reference)
        resumed = sum(1 for c in clients if c.resumed)
        invariants["lost_streams"] = successor.stats()["lost_streams"]
        assert invariants["lost_streams"] == 0, (
            f"lost streams: {invariants['lost_streams']}")
        invariants["completed_streams"] = num_requests
        invariants["resumed_clients"] = resumed
        assert resumed >= 1, (
            "the crash never interrupted a stream (vacuous drill)")
        completed = _fleet_completed(fronts)
        invariants["fleet_completed_requests"] = completed
        assert completed == num_requests, (
            f"exactly-once decode broke: {completed} completions "
            f"for {num_requests} requests — a request decoded to "
            f"completion twice across the router handoff")
        windows = [
            {"start": c.recovered_window[0],
             "end": c.recovered_window[1],
             "request_id": c.spec["request_id"],
             "resumed_tokens": c.resume_from}
            for c in clients
            if c.resumed and c.recovered_window is not None and
            c.recovered_window[1] > c.recovered_window[0]]
        invariants["recovery_windows"] = len(windows)
        _goodput_proof(report, invariants, started_wall, time.time(),
                       windows)
        invariants["ok"] = True
    finally:
        _shutdown_all(router, successor, *fronts)
    return report
