"""Long-running packed-inference HTTP server (stdlib-only transport).

Counterpart of the JAX package's ``serve/server.py``: a
``ThreadingHTTPServer`` front end over the :class:`~.core.ServeEngine`
micro-batcher, serving ``infer.load_packed`` artifacts on a ``device``
(default ``"cuda"``):

  POST /predict        {"images": [...], "deadline_ms": optional,
                        "tier": optional}
                       -> {"argmax": [...], "log_probs": [[...]]}
                       200 ok | 503 shed (queue_full/breaker_open/
                       draining) | 504 deadline | 502 backend error |
                       400 bad input | 413 batch too large
  GET  /healthz        status (ok|draining), breaker state, queue depth,
                       request/shed/batch counts

Lifecycle: SIGTERM/SIGINT set a :class:`~..resilience.preempt.
StopRequest` flag — stop admitting (new work is shed with reason
``draining``), flush everything in flight, exit 0.

Telemetry, tracing, chaos, AOT boot, ``/admin/reload``,
``/admin/profile`` and ``/metrics`` are not in this package yet.
"""

from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from http.server import ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..infer import load_packed
from ..resilience.policy import CircuitBreaker
from ..resilience.preempt import StopRequest
from .core import DEFAULT_TIER, TIERS, AdmissionQueue, Counter, ServeEngine
from .httpbase import JsonHandler

log = logging.getLogger(__name__)

# Extra slack a waiter grants the engine past the request deadline
# before abandoning (claiming) it.
_WAIT_SLACK_S = 0.05

_SHED_HTTP = {"queue_full": 503, "breaker_open": 503, "draining": 503}

# Retry-After hint (seconds) on non-breaker sheds: one linger window
# plus slack. Breaker sheds hint the breaker's remaining open time.
_RETRY_AFTER_S = 0.1


@dataclass
class ServeConfig:
    """Server shape + robustness budgets (CLI flags mirror these)."""

    artifact: str
    device: str = "cuda"
    host: str = "127.0.0.1"
    port: int = 8000                 # 0 = ephemeral (tests)
    batch_size: int = 32             # the ONE kernel batch shape
    queue_depth: int = 64            # admission bound (reject past it)
    default_deadline_ms: float = 1000.0
    linger_ms: float = 2.0           # micro-batch coalescing window
    stall_timeout_s: float = 1.0     # backend call past this = failure
    breaker_threshold: int = 3       # consecutive failures to trip
    breaker_reset_s: float = 5.0     # open -> half-open timeout
    breaker_probes: int = 1          # half-open probe batches
    drain_timeout_s: float = 30.0    # flush budget on SIGTERM
    input_shape: Tuple[int, ...] = (28, 28, 1)


class PackedInferenceServer:
    """Owns the engine, the HTTP front end and the drain lifecycle."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self.breaker_transitions = Counter()
        self.breaker = CircuitBreaker(
            failure_threshold=config.breaker_threshold,
            reset_timeout_s=config.breaker_reset_s,
            half_open_probes=config.breaker_probes,
            on_transition=lambda old, new, reason:
                self.breaker_transitions.inc(to=new),
        )
        self.queue = AdmissionQueue(config.queue_depth)
        self.stop_request = StopRequest()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._started_at = time.time()
        self.engine: Optional[ServeEngine] = None
        self.artifact_info: Dict[str, Any] = {}
        # Request-body cap: a full micro-batch of JSON floats (~32
        # chars/value incl. separators) plus headroom, floored at 1 MiB,
        # enforced BEFORE the body is read.
        n_vals = 1
        for d in config.input_shape:
            n_vals *= int(d)
        self.max_body_bytes = max(
            1 << 20, config.batch_size * n_vals * 32 + (1 << 16)
        )

    def _load_and_warm(self, path: str):
        """load_packed + one padded-shape call before the first request,
        so the kernels are built and loaded before traffic arrives."""
        fn, info = load_packed(path, device=self.config.device)
        warm = np.zeros(
            (self.config.batch_size, *self.config.input_shape), np.float32
        )
        fn(warm).cpu()
        return fn, info

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> Tuple[str, int]:
        """Load + warm the artifact, start the engine and the HTTP
        front end. Returns the bound (host, port)."""
        cfg = self.config
        fn, info = self._load_and_warm(cfg.artifact)
        self.artifact_info = dict(info)
        self.engine = ServeEngine(
            fn,
            batch_size=cfg.batch_size,
            queue=self.queue,
            breaker=self.breaker,
            stall_timeout_s=cfg.stall_timeout_s,
            linger_s=cfg.linger_ms / 1e3,
        ).start()
        server = self

        class Handler(_Handler):
            srv = server

        self._httpd = ThreadingHTTPServer((cfg.host, cfg.port), Handler)
        self._httpd.daemon_threads = True
        host, port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="serve-http",
            daemon=True,
        )
        self._http_thread.start()
        log.info(
            "serving %s (%s) on %s:%d, device %s — batch %d, queue %d, "
            "deadline %.0fms", cfg.artifact, info.get("family"), host, port,
            cfg.device, cfg.batch_size, cfg.queue_depth,
            cfg.default_deadline_ms,
        )
        return host, port

    def health(self) -> Dict[str, Any]:
        eng = self.engine
        return {
            "status": "draining" if eng is not None and eng.draining else "ok",
            "breaker": self.breaker.state,
            "queue_depth": len(self.queue),
            "batch_size": self.config.batch_size,
            "device": self.config.device,
            "family": self.artifact_info.get("family"),
            "requests": eng.requests_ctr.snapshot() if eng else {},
            "sheds": eng.shed_ctr.snapshot() if eng else {},
            "batches_total": eng.batches_ctr.total() if eng else 0,
            "uptime_s": round(time.time() - self._started_at, 3),
        }

    def request_stop(self, reason: str = "stop requested") -> None:
        self.stop_request.request(reason)

    def drain_and_stop(self) -> Dict[str, Any]:
        """Stop admitting, flush in-flight work, shut the front end
        down. Safe to call once after the run loop exits."""
        if self.engine is None:
            raise RuntimeError("drain_and_stop before start")
        t0 = time.monotonic()
        inflight = len(self.queue)
        self.engine.begin_drain()
        flushed = self.engine.drain(timeout=self.config.drain_timeout_s)
        self.engine.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        stats = {
            "reason": self.stop_request.reason or "stop requested",
            "inflight_at_drain": inflight,
            "flushed": flushed,
            "requests_total": self.engine.requests_ctr.total(),
            "shed_total": self.engine.shed_ctr.total(),
            "batches_total": self.engine.batches_ctr.total(),
            "wall_s": round(time.monotonic() - t0, 3),
        }
        log.info("drained and stopped: %s", stats)
        return stats

    def run(self) -> int:
        """CLI entry: serve until SIGTERM/SIGINT, graceful-drain, exit
        0. Handlers install BEFORE ``start()``, so a SIGTERM during the
        warmup also lands as a graceful drain."""
        with self.stop_request.install():
            self.start()
            while not self.stop_request.requested:
                time.sleep(0.05)
        self.drain_and_stop()
        return 0


class _Handler(JsonHandler):
    """Per-connection handler; ``srv`` is bound by the enclosing
    server's subclass. Threaded: N handlers block in ``Request.event``
    waits while the single engine worker batches behind them."""

    srv: PackedInferenceServer
    logger = log

    def _max_body_bytes(self) -> int:
        return self.srv.max_body_bytes

    def _body_limit_error(self, n: int) -> str:
        return (f"body of {n} bytes exceeds the "
                f"{self.srv.max_body_bytes}-byte limit "
                "(one micro-batch of examples)")

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._reply(200, self.srv.health())
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/predict":
            self._predict()
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _predict(self) -> None:
        body = self._read_json()
        if body is None:
            return
        engine = self.srv.engine
        try:
            images = np.asarray(body["images"], np.float32)
        except (KeyError, TypeError, ValueError) as e:
            self._reply(400, {"error": f"bad images payload: {e}"})
            return
        expected = tuple(self.srv.config.input_shape)
        if images.ndim == len(expected):
            images = images[None]  # single unbatched example
        if images.shape[1:] != expected:
            # One kernel batch shape is the micro-batcher's contract: a
            # differently-shaped example is an explicit 400.
            self._reply(400, {
                "error": f"per-example shape {list(images.shape[1:])} "
                         f"does not match the served input shape "
                         f"{list(expected)}",
            })
            return
        if images.shape[0] > engine.batch_size:
            self._reply(413, {
                "error": f"request batch {images.shape[0]} exceeds the "
                         f"micro-batch size {engine.batch_size}",
            })
            return
        try:
            deadline_ms = float(
                body.get("deadline_ms",
                         self.srv.config.default_deadline_ms)
            )
        except (TypeError, ValueError):
            deadline_ms = float("nan")
        if not (math.isfinite(deadline_ms) and deadline_ms > 0):
            self._reply(400, {
                "error": f"deadline_ms must be a positive finite "
                         f"number, got {body.get('deadline_ms')!r}",
            })
            return
        deadline = time.monotonic() + deadline_ms / 1e3
        tier = body.get("tier", DEFAULT_TIER)
        if tier not in TIERS:
            self._reply(400, {
                "error": f"unknown tier {tier!r} (have: "
                         f"{', '.join(TIERS)})",
            })
            return
        req = engine.submit(images, deadline, tier=tier)
        if isinstance(req, str):  # shed reason
            self._reply(_SHED_HTTP[req], {"error": "shed", "reason": req},
                        headers=self._shed_headers(req))
            return
        self._wait_and_reply(req, deadline)

    def _shed_headers(self, reason: str) -> Dict[str, str]:
        """Retry-After for every 503; breaker sheds hint the remaining
        open time."""
        if reason == "breaker_open":
            after = max(
                self.srv.breaker.seconds_until_half_open(), _RETRY_AFTER_S
            )
        else:
            after = _RETRY_AFTER_S
        return {"Retry-After": f"{after:.3f}"}

    def _wait_and_reply(self, req, deadline: float) -> None:
        """Block until the engine resolves ``req`` or its deadline
        passes — the response ALWAYS arrives within deadline + slack,
        even if the backend is mid-stall (the abandoned request is
        claimed, so the engine discards its late result)."""
        remaining = deadline - time.monotonic() + _WAIT_SLACK_S
        if not req.event.wait(max(remaining, 0.0)):
            if req.finish("deadline", error="deadline exceeded"):
                self._reply(504, {"error": "deadline exceeded", "id": req.id})
                return
            # engine won the race after our timeout check: fall through
        status = req.status
        if status == "ok":
            lp = req.log_probs
            self._reply(200, {
                "argmax": [int(i) for i in lp.argmax(-1)],
                "log_probs": [[float(v) for v in row] for row in lp],
            })
        elif status == "deadline":
            self._reply(504, {"error": req.error or "deadline exceeded",
                              "id": req.id})
        elif status == "breaker_open":
            self._reply(503, {"error": "shed", "reason": "breaker_open",
                              "id": req.id},
                        headers=self._shed_headers("breaker_open"))
        elif status == "shed":
            self._reply(503, {"error": "shed", "reason": "displaced",
                              "tier": req.tier, "id": req.id},
                        headers=self._shed_headers("displaced"))
        else:
            self._reply(502, {"error": req.error or "backend failure",
                              "id": req.id})
