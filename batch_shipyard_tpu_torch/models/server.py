"""HTTP serving front end over the port's continuous-batching engine.

Counterpart of batch_shipyard_tpu/models/server.py (``ServingFrontEnd``)
with the same wire format, bound to
``batch_shipyard_tpu_torch.models.serving.ContinuousBatcher``. stdlib
only: one engine thread owns the engine (drains the submission queue,
steps while work is active, completes waiters); HTTP handler threads
parse, validate and wait.

Endpoints:
  POST /v1/generate   {"prompt": [ids], "max_new_tokens": n,
                       "request_id"?: str, "eos_id"?: int,
                       "priority"?: int, "slo_class"?: str,
                       "ttft_target_ms"?: float, "tpot_target_ms"?: float,
                       "stream"?: bool}
      -> {"request_id", "tokens", "num_tokens", "ttft_ms", "tpot_ms",
          "latency_ms", "slo_class"}
      With "stream": true the reply is NDJSON over chunked transfer:
      one {"token": t, "index": i} line per token as it decodes, then
      the final result object.
  DELETE /v1/requests/<id>   abort (202; 404 for unknown ids)
  GET  /v1/requests/<id>     phase (queued/prefill/decode) + progress
  GET  /v1/stats, /metrics (Prometheus), /healthz
Beyond max_inflight accepted-but-unfinished requests, POST gets 429.
Drain, mid-stream resume, trace spans and the fleet router come with a
later slice of the port.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from batch_shipyard_tpu_torch.models.serving import (ContinuousBatcher,
                                                     Request)
from batch_shipyard_tpu_torch.trace.histogram import LatencyHistogram

logger = logging.getLogger(__name__)


class RequestCancelled(Exception):
    """The request was aborted via the cancel API (409)."""


class RequestShed(Exception):
    """The engine dropped the request under overload (503, "shed")."""


class TooManyRequests(Exception):
    """Front-door concurrency cap exceeded (429 back-pressure)."""


def prometheus_lines(prefix: str, values: dict,
                     labels: Optional[dict] = None) -> list[str]:
    """Render {name: number} as Prometheus gauges; None values are
    skipped (absent metric, not zero)."""
    label_str = ""
    if labels:
        inner = ",".join(
            '{}="{}"'.format(k, str(v).replace("\\", "\\\\")
                             .replace('"', '\\"').replace("\n", "\\n"))
            for k, v in sorted(labels.items()))
        label_str = "{" + inner + "}"
    return [f"{prefix}_{name}{label_str} {float(value):.17g}"
            for name, value in values.items() if value is not None]


class _Pending:
    __slots__ = ("request", "event", "submitted_at", "admitted_at",
                 "first_token_at", "finished_at", "tokens", "error",
                 "token_queue", "cancelled", "shed", "emitted")

    def __init__(self, request: Request, stream: bool = False) -> None:
        self.request = request
        self.event = threading.Event()
        self.submitted_at = time.perf_counter()
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.tokens: Optional[list[int]] = None
        self.error: Optional[str] = None
        self.cancelled = False
        self.shed = False
        self.emitted = 0
        # Streaming: the engine thread feeds (index, token) pairs here;
        # None terminates the stream.
        self.token_queue: Optional["queue.Queue"] = (
            queue.Queue() if stream else None)


class _Handler(BaseHTTPRequestHandler):
    """HTTP/1.1 (chunked streaming; every other reply carries
    Content-Length so keep-alive is safe), quiet logging, JSON replies.
    ``front`` is bound per server by ServingFrontEnd."""

    protocol_version = "HTTP/1.1"
    front: "ServingFrontEnd"

    def log_message(self, fmt, *args):  # noqa: N802
        pass

    def _reply(self, code: int, payload: dict,
               headers: Optional[dict] = None) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, str(value))
        self.end_headers()
        self.wfile.write(body)

    def do_DELETE(self):  # noqa: N802
        prefix = "/v1/requests/"
        if not self.path.startswith(prefix):
            self._reply(404, {"error": "not found"})
            return
        request_id = self.path[len(prefix):]
        if not self.front.knows(request_id):
            self._reply(404, {"error": f"unknown request_id "
                                       f"{request_id}"})
            return
        self.front.cancel(request_id)
        self._reply(202, {"request_id": request_id, "cancelling": True})

    def do_GET(self):  # noqa: N802
        front = self.front
        if self.path == "/healthz":
            self._reply(200, {"ok": True})
        elif self.path == "/metrics":
            body = ("\n".join(front.prometheus_metrics()) + "\n").encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/v1/stats":
            self._reply(200, front.stats())
        elif self.path.startswith("/v1/requests/"):
            request_id = self.path[len("/v1/requests/"):]
            status = front.request_status(request_id)
            if status is not None:
                self._reply(200, status)
            else:
                self._reply(404, {"request_id": request_id,
                                  "in_flight": False})
        else:
            self._reply(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802
        if self.path != "/v1/generate":
            self._reply(404, {"error": "not found"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            spec = json.loads(self.rfile.read(length))
        except (ValueError, OSError) as exc:
            self._reply(400, {"error": str(exc)})
            return
        if not isinstance(spec, dict):
            self._reply(400, {"error": "body must be a JSON object"})
            return
        if spec.get("stream"):
            self._stream_generate(spec)
            return
        try:
            result = self.front.generate(spec)
        except TooManyRequests as exc:
            self._reply(429, {"error": str(exc), "backpressure": True},
                        headers={"Retry-After": "1"})
            return
        except RequestCancelled as exc:
            self._reply(409, {"error": str(exc)})
            return
        except RequestShed as exc:
            self._reply(503, {"error": str(exc), "shed": True})
            return
        except ValueError as exc:
            self._reply(400, {"error": str(exc)})
            return
        except Exception as exc:  # noqa: BLE001 - keep serving
            logger.exception("generate failed")
            self._reply(500, {"error": str(exc)})
            return
        self._reply(200, result)

    def _stream_generate(self, spec: dict) -> None:
        """NDJSON token stream over chunked transfer. Validation errors
        before the headers are plain replies; errors after them are a
        final {"error": ...} line and a clean terminating chunk."""
        try:
            request_id, stream = self.front.generate_stream(spec)
        except TooManyRequests as exc:
            self._reply(429, {"error": str(exc), "backpressure": True},
                        headers={"Retry-After": "1"})
            return
        except ValueError as exc:
            self._reply(400, {"error": str(exc)})
            return
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
        except OSError:
            self.front.abandon(request_id)
            stream.close()
            return

        def chunk(obj: dict) -> None:
            line = json.dumps(obj).encode() + b"\n"
            self.wfile.write(f"{len(line):x}\r\n".encode() + line +
                             b"\r\n")
            self.wfile.flush()

        try:
            try:
                for event in stream:
                    chunk(event)
            except (BrokenPipeError, ConnectionResetError):
                raise
            except RequestShed as exc:
                chunk({"error": str(exc), "shed": True})
            except (ValueError, TimeoutError, RequestCancelled) as exc:
                chunk({"error": str(exc)})
            except Exception as exc:  # noqa: BLE001 - keep serving
                logger.exception("stream failed")
                chunk({"error": str(exc)})
            self.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            pass  # client went away; the engine finishes the run
        finally:
            stream.close()


class ServingFrontEnd:
    """Owns the engine thread and the HTTP server around a
    ContinuousBatcher."""

    def __init__(self, engine: ContinuousBatcher,
                 host: str = "127.0.0.1", port: int = 0,
                 slo_classes: Optional[dict] = None,
                 max_inflight: Optional[int] = None,
                 io_timeout_s: Optional[float] = None) -> None:
        """slo_classes maps class name -> {"ttft_ms", "tpot_ms"}
        targets a request's "slo_class" resolves to (explicit
        *_target_ms fields override). max_inflight caps
        accepted-but-unfinished requests (excess -> 429); io_timeout_s
        is a per-connection socket deadline."""
        self.engine = engine
        self.slo_classes = dict(slo_classes or {})
        self.max_inflight = max_inflight
        engine.on_token = self._on_token
        engine.on_admit = self._on_admit
        engine.on_shed = self._on_shed
        self._submit_q: "queue.Queue[_Pending]" = queue.Queue()
        self._cancel_q: "queue.Queue[str]" = queue.Queue()
        self._inflight: dict[str, _Pending] = {}
        self._inflight_lock = threading.Lock()
        # Engine-side ownership: request_id -> the _Pending the engine
        # is decoding. Written only by the engine thread;
        # _engine_active mirrors its keys under _inflight_lock so an id
        # still decoding cannot be reused by a retried request.
        self._active_runs: dict[str, _Pending] = {}
        self._engine_active: set[str] = set()
        self._stop = threading.Event()
        self._stats_lock = threading.Lock()
        self._completed: "collections.deque" = collections.deque(
            maxlen=2048)
        self._total_completed = 0
        self._total_tokens = 0
        self._ttft_hist = LatencyHistogram()
        self._tpot_hist = LatencyHistogram()
        self._class_stats: dict[str, dict] = {}
        self._started_at = time.perf_counter()
        self._engine_thread = threading.Thread(
            target=self._engine_loop, name="serving-engine", daemon=True)
        handler = type("Handler", (_Handler,), {"front": self})
        if io_timeout_s is not None:
            handler.timeout = io_timeout_s
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serving-http",
            daemon=True)

    # ------------------------------ lifecycle --------------------------

    @property
    def address(self) -> tuple[str, int]:
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "ServingFrontEnd":
        self._engine_thread.start()
        self._http_thread.start()
        return self

    def shutdown(self) -> None:
        self._stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()
        self._engine_thread.join(timeout=10.0)

    # ------------------------------ serving ----------------------------

    def _make_pending(self, spec: dict, stream: bool = False) -> _Pending:
        prompt = spec.get("prompt")
        if not isinstance(prompt, list) or not all(
                isinstance(t, int) for t in prompt):
            raise ValueError("prompt must be a list of token ids")
        request_id = str(spec.get("request_id") or uuid.uuid4().hex[:12])
        try:
            max_new_tokens = int(spec.get("max_new_tokens", 16))
            priority = int(spec.get("priority") or 0)
        except (TypeError, ValueError) as exc:
            raise ValueError(
                f"max_new_tokens/priority must be integers: {exc}")
        slo_class = str(spec.get("slo_class") or "standard")
        if self.slo_classes and "slo_class" in spec and \
                slo_class not in self.slo_classes:
            raise ValueError(
                f"unknown slo_class {slo_class!r}; configured: "
                f"{sorted(self.slo_classes)}")
        targets = self.slo_classes.get(slo_class, {})

        def target(key):
            value = spec.get(key, targets.get(key.replace("_target", "")))
            if value is None:
                return None
            try:
                return float(value)
            except (TypeError, ValueError) as exc:
                raise ValueError(f"{key} must be a number: {exc}")

        request = Request(
            request_id=request_id, prompt=prompt,
            max_new_tokens=max_new_tokens, eos_id=spec.get("eos_id"),
            priority=priority, ttft_target_ms=target("ttft_target_ms"),
            tpot_target_ms=target("tpot_target_ms"), slo_class=slo_class)
        pending = _Pending(request, stream=stream)
        with self._inflight_lock:
            if (request_id in self._inflight or
                    request_id in self._engine_active):
                raise ValueError(f"request_id {request_id} in flight")
            if (self.max_inflight is not None and
                    len(self._inflight) >= self.max_inflight):
                raise TooManyRequests(
                    f"request {request_id} refused: "
                    f"{len(self._inflight)} in flight >= cap "
                    f"{self.max_inflight}")
            self._inflight[request_id] = pending
        return pending

    def _result(self, pending: _Pending) -> dict:
        request_id = pending.request.request_id
        n = len(pending.tokens)
        ttft = (pending.first_token_at or pending.finished_at) - \
            pending.submitted_at
        decode = pending.finished_at - (pending.first_token_at or
                                        pending.submitted_at)
        result = {
            "request_id": request_id,
            "tokens": pending.tokens,
            "num_tokens": n,
            "ttft_ms": ttft * 1e3,
            "tpot_ms": decode / max(1, n - 1) * 1e3,
            "latency_ms": (pending.finished_at -
                           pending.submitted_at) * 1e3,
            "slo_class": pending.request.slo_class,
        }
        req = pending.request
        with self._stats_lock:
            cls = self._class_stats.setdefault(
                req.slo_class,
                {"requests": 0, "ttft_ok": 0, "tpot_ok": 0, "shed": 0})
            cls["requests"] += 1
            if req.ttft_target_ms is None or \
                    result["ttft_ms"] <= req.ttft_target_ms:
                cls["ttft_ok"] += 1
            if req.tpot_target_ms is None or \
                    result["tpot_ms"] <= req.tpot_target_ms:
                cls["tpot_ok"] += 1
            self._completed.append({
                "ttft_ms": result["ttft_ms"],
                "tpot_ms": result["tpot_ms"],
                "latency_ms": result["latency_ms"],
                "num_tokens": n,
            })
            self._total_completed += 1
            self._total_tokens += n
            self._ttft_hist.observe(result["ttft_ms"])
            self._tpot_hist.observe(result["tpot_ms"])
        with self._inflight_lock:
            self._inflight.pop(request_id, None)
        return result

    def generate(self, spec: dict, timeout: float = 300.0) -> dict:
        """Blocking generate: enqueue to the engine thread, wait, return
        tokens and the latency breakdown."""
        pending = self._make_pending(spec)
        self._submit_q.put(pending)
        try:
            self._wait_complete(pending, timeout)
        except BaseException:
            self.abandon(pending.request.request_id)
            raise
        return self._result(pending)

    def generate_stream(self, spec: dict, timeout: float = 300.0):
        """Streaming generate: validates now, then returns (request_id,
        iterator of {"token", "index"} events ending with the result)."""
        pending = self._make_pending(spec, stream=True)
        self._submit_q.put(pending)
        return (pending.request.request_id,
                self._stream_tokens(pending, timeout))

    def abandon(self, request_id: str) -> None:
        """Drop the front-end registration of a request (the engine
        keeps decoding; _engine_active still blocks id reuse)."""
        with self._inflight_lock:
            self._inflight.pop(request_id, None)

    def _stream_tokens(self, pending: _Pending, timeout: float):
        request_id = pending.request.request_id
        try:
            while True:
                try:
                    item = pending.token_queue.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(
                        f"request {request_id} timed out after "
                        f"{timeout}s")
                if item is None:
                    break
                index, token = item
                yield {"token": token, "index": index}
            self._wait_complete(pending, timeout)
        except BaseException:
            self.abandon(request_id)
            raise
        yield self._result(pending)

    def _wait_complete(self, pending: _Pending, timeout: float) -> None:
        if not pending.event.wait(timeout):
            raise TimeoutError(
                f"request {pending.request.request_id} timed out "
                f"after {timeout}s")
        if pending.cancelled:
            raise RequestCancelled(pending.error)
        if pending.shed:
            raise RequestShed(pending.error)
        if pending.error is not None:
            raise ValueError(pending.error)

    def knows(self, request_id: str) -> bool:
        with self._inflight_lock:
            return (request_id in self._inflight or
                    request_id in self._engine_active)

    def request_status(self, request_id: str) -> Optional[dict]:
        """Phase (queued/prefill/decode) and emitted-token count of an
        in-flight request; None once finished or never seen."""
        with self._inflight_lock:
            pending = self._inflight.get(request_id)
            if pending is None and request_id in self._engine_active:
                pending = self._active_runs.get(request_id)
        if pending is None:
            return None
        if pending.admitted_at is None:
            phase = "queued"
        elif pending.emitted == 0:
            phase = "prefill"
        else:
            phase = "decode"
        return {"request_id": request_id, "in_flight": True,
                "phase": phase, "emitted_tokens": int(pending.emitted)}

    def cancel(self, request_id: str) -> None:
        """Request an abort; the engine thread performs it and the
        waiter completes with a 'cancelled' error."""
        self._cancel_q.put(request_id)

    def stats(self) -> dict:
        with self._stats_lock:
            completed = self._total_completed
            tokens = self._total_tokens
            ttft_hist = self._ttft_hist.to_dict()
            tpot_hist = self._tpot_hist.to_dict()
            ttft_pcts = self._ttft_hist.percentiles((50, 90, 99))
            tpot_pcts = self._tpot_hist.percentiles((50, 90, 99))
            class_stats = {name: dict(counters) for name, counters
                           in self._class_stats.items()}
        elapsed = time.perf_counter() - self._started_at
        with self._inflight_lock:
            inflight = len(self._inflight)
        out = {
            "completed_requests": completed,
            "generated_tokens": tokens,
            "uptime_seconds": elapsed,
            "tokens_per_second": tokens / elapsed if elapsed else 0.0,
            "ttft_ms": {p: ttft_pcts[f"p{p}"] for p in (50, 90, 99)},
            "tpot_ms": {p: tpot_pcts[f"p{p}"] for p in (50, 90, 99)},
            "ttft_hist": ttft_hist,
            "tpot_hist": tpot_hist,
            "inflight": inflight,
            "engine_backlog": self.engine.pending(),
            "draining": False,
            "drain_rejections": 0,
        }
        out["slo"] = {
            "classes": {
                name: dict(
                    counters,
                    targets=self.slo_classes.get(name),
                    ttft_attainment=(
                        counters["ttft_ok"] / counters["requests"]
                        if counters["requests"] else None),
                    tpot_attainment=(
                        counters["tpot_ok"] / counters["requests"]
                        if counters["requests"] else None))
                for name, counters in class_stats.items()},
            **self.engine.slo_stats(),
        }
        prefix = self.engine.prefix_stats()
        if prefix is not None:
            out["prefix_cache"] = prefix
        spec = self.engine.spec_stats()
        if spec is not None:
            out["speculative"] = spec
        return out

    def prometheus_metrics(self) -> list[str]:
        """Serving metrics in Prometheus text exposition format."""
        stats = self.stats()
        lines = prometheus_lines("shipyard_serving", {
            "completed_requests_total": stats["completed_requests"],
            "generated_tokens_total": stats["generated_tokens"],
            "tokens_per_second": stats["tokens_per_second"],
            "uptime_seconds": stats["uptime_seconds"],
            "inflight": stats["inflight"],
            "engine_backlog": stats["engine_backlog"],
        })
        for metric in ("ttft_ms", "tpot_ms"):
            for pct, value in stats[metric].items():
                lines.extend(prometheus_lines(
                    "shipyard_serving", {metric: value},
                    labels={"quantile": f"0.{pct}"}))
        with self._stats_lock:
            for metric, hist in (("ttft_ms", self._ttft_hist),
                                 ("tpot_ms", self._tpot_hist)):
                lines.extend(hist.prometheus_bucket_lines(
                    f"shipyard_serving_{metric}"))
        spec = stats.get("speculative")
        if spec:
            lines.extend(prometheus_lines("shipyard_serving", {
                "spec_rounds_total": spec["rounds"],
                "spec_proposed_tokens_total": spec["proposed"],
                "spec_accepted_tokens_total": spec["accepted"],
                "spec_acceptance_rate": spec["acceptance_rate"],
            }))
        prefix = stats.get("prefix_cache")
        if prefix:
            lines.extend(prometheus_lines("shipyard_serving", {
                "prefix_hit_rate": prefix["hit_rate"],
                "prefix_hit_tokens_total": prefix["hit_tokens"],
                "prefix_prompt_tokens_total":
                    prefix["total_prompt_tokens"],
                "prefix_indexed_pages": prefix["indexed_pages"],
                "prefix_published_pages_total":
                    prefix["published_pages"],
                "prefix_evictions_total": prefix["evictions"],
            }))
        slo = stats["slo"]
        lines.extend(prometheus_lines("shipyard_serving", {
            "slo_sheds_total": slo.get("sheds"),
            "slo_deferrals_total": slo.get("deferrals"),
        }))
        return lines

    # --------------------------- engine thread -------------------------

    def _on_admit(self, request_id: str) -> None:
        pending = self._active_runs.get(request_id)
        if pending is not None and pending.admitted_at is None:
            pending.admitted_at = time.perf_counter()

    def _on_token(self, request_id: str, token: int, index: int) -> None:
        pending = self._active_runs.get(request_id)
        if pending is None:
            return
        if pending.first_token_at is None:
            pending.first_token_at = time.perf_counter()
        pending.emitted = max(pending.emitted, index + 1)
        if pending.token_queue is not None:
            pending.token_queue.put((index, token))

    def _finish(self, request_id: str, error: Optional[str] = None,
                tokens: Optional[list[int]] = None, **flags) -> None:
        """Engine thread: retire a run and wake its waiter."""
        pending = self._active_runs.pop(request_id, None)
        with self._inflight_lock:
            self._engine_active.discard(request_id)
        if pending is None:
            return
        pending.tokens = tokens
        pending.error = error
        for name, value in flags.items():
            setattr(pending, name, value)
        pending.finished_at = time.perf_counter()
        if pending.token_queue is not None:
            pending.token_queue.put(None)
        pending.event.set()

    def _on_shed(self, request_id: str, reason: str) -> None:
        pending = self._active_runs.get(request_id)
        if pending is not None:
            with self._stats_lock:
                cls = self._class_stats.setdefault(
                    pending.request.slo_class,
                    {"requests": 0, "ttft_ok": 0, "tpot_ok": 0,
                     "shed": 0})
                cls["shed"] += 1
        self._finish(request_id, f"request {request_id} shed: {reason}",
                     shed=True)

    def _engine_loop(self) -> None:
        while not self._stop.is_set():
            # Park only when fully idle; with active slots the loop
            # steps at full rate.
            if not self.engine.pending():
                try:
                    self._submit(self._submit_q.get(timeout=0.2))
                except queue.Empty:
                    pass
            while True:
                try:
                    self._submit(self._submit_q.get_nowait())
                except queue.Empty:
                    break
            while True:
                try:
                    request_id = self._cancel_q.get_nowait()
                except queue.Empty:
                    break
                if self.engine.cancel(request_id):
                    self._finish(request_id,
                                 f"request {request_id} cancelled",
                                 cancelled=True)
            if not self.engine.pending():
                continue
            try:
                finished = self.engine.step()
            except Exception as exc:  # noqa: BLE001 - thread lives on
                # Fail the runs in the engine now rather than let their
                # clients wait out the timeout on a step that keeps
                # failing (a kernel that cannot launch, say).
                logger.exception("engine step failed")
                for request_id in list(self._active_runs):
                    self.engine.cancel(request_id)
                    self._finish(request_id,
                                 f"engine step failed: {exc}")
                continue
            for request_id, tokens in finished:
                self._finish(request_id, tokens=tokens)

    def _submit(self, pending: _Pending) -> None:
        request_id = pending.request.request_id
        try:
            self.engine.submit(pending.request)
        except ValueError as exc:
            pending.error = str(exc)
            pending.finished_at = time.perf_counter()
            if pending.token_queue is not None:
                pending.token_queue.put(None)
            pending.event.set()
            return
        self._active_runs[request_id] = pending
        with self._inflight_lock:
            self._engine_active.add(request_id)
