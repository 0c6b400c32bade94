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
  GET  /healthz        status (ok|draining|failed), breaker state, queue
                       depth, the engine's fence_error, the AOT boot's
                       status (aot: hit|miss|disabled), the fence's
                       budget and the fenced builds since the boot,
                       request/shed/batch counts (+ per-program costs
                       and the cards' memory with --costs)
  GET  /metrics        the obs registry (with the process's kernel
                       launches, ``kernel_launches_total{kernel}``): JSON,
                       or Prometheus text under ``Accept: text/plain``
  POST /admin/reload   {"artifact": path} — hot swap: the new artifact
                       is loaded AND warmed off-path, then swapped in
                       atomically; unchanged weights give bitwise-
                       identical responses across the swap
  POST /admin/profile  {"duration_ms": N} — an on-demand torch.profiler
                       capture of a live window, off the serving path;
                       409 while another capture runs

With ``telemetry_dir`` the server writes the JAX package's events
(``run_manifest``, ``request``, ``shed``, ``breaker_open`` /
``breaker_close``, ``reload``, ``drain``, ``program_cost``,
``profile_capture``, ``metrics``, ``run_end``); ``trace`` adds each
request's span tree, rooted under the client's ``x-jg-trace`` header
when it sends one (echoed in the reply).

Lifecycle: SIGTERM/SIGINT set a :class:`~..resilience.preempt.
StopRequest` flag — stop admitting (new work is shed with reason
``draining``), flush everything in flight, emit ``drain``, exit 0.

With ``aot`` the boot consults the AOT store first (``aot/``): a hit
installs the banked kernel libraries (no ``nvcc``) and arms the
recompile fence at budget 0 from the boot mark, taken before the
artifact loads; a miss builds the libraries, banks them and serves
unfenced, as JAX's server does.
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

from ..analysis.guards import Sanitizer, SanitizerConfig, fenced_build_count
from ..infer import load_packed
from ..obs import Telemetry
from ..obs.costs import arm_ledger
from ..obs.profile import default_capture_dir
from ..obs.trace import TRACE_HEADER, format_header, parse_header
from ..resilience.policy import CircuitBreaker
from ..resilience.preempt import StopRequest
from .core import (
    BREAKER_TRANSITIONS_TOTAL,
    DEFAULT_TIER,
    TIERS,
    AdmissionQueue,
    Request,
    ServeEngine,
    labeled,
)
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
    telemetry_dir: Optional[str] = None  # JSONL events here (obs/)
    trace: Optional[bool] = None     # per-request span trees in the event
                                     # log; None: the JG_TRACE env var;
                                     # needs telemetry_dir
    costs: Optional[bool] = None     # the per-program cost ledger and
                                     # measured MFU in /healthz (obs/costs);
                                     # None: the JG_COSTS env var
    events_max_bytes: Optional[int] = None  # size-rotate events.jsonl
                                     # past this (None: the
                                     # JG_EVENTS_MAX_BYTES env var, else
                                     # unbounded)
    chaos: Optional[str] = None      # serving fault injection
                                     # (resilience/chaos; None: JG_CHAOS)
    seed: int = 0                    # the chaos rules' draws
    aot: bool = False                # consult the AOT store (aot/): hit =
                                     # the banked kernel libraries, no
                                     # nvcc, and the recompile fence at
                                     # budget 0 from the boot; miss =
                                     # build, re-bank, serve unfenced
    aot_dir: Optional[str] = None    # store root (default:
                                     # JG_TORCH_AOT_STORE or
                                     # <repo>/.torch_aot)


class PackedInferenceServer:
    """Owns the engine, the HTTP front end and the drain lifecycle."""

    def __init__(self, config: ServeConfig):
        self.config = config
        self.telemetry = Telemetry(
            config.telemetry_dir, heartbeat=False, trace=config.trace,
            events_max_bytes=config.events_max_bytes,
        )
        # the process-wide ledger; an explicit flag wins over JG_COSTS
        self._ledger = arm_ledger(config.costs)
        from ..resilience.chaos import ChaosController

        self.chaos = ChaosController.from_config(
            config.chaos, seed=config.seed, telemetry=self.telemetry)
        self.breaker_transitions = self.telemetry.registry.counter(
            BREAKER_TRANSITIONS_TOTAL, "circuit-breaker state transitions")
        self.breaker = CircuitBreaker(
            failure_threshold=config.breaker_threshold,
            reset_timeout_s=config.breaker_reset_s,
            half_open_probes=config.breaker_probes,
            on_transition=self._on_breaker_transition,
        )
        self.queue = AdmissionQueue(config.queue_depth)
        self.stop_request = StopRequest()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._reload_lock = threading.Lock()
        # requests a handler thread is still answering: the drain seals
        # the event log only after their last spans are recorded
        self._handling = 0
        self._handling_cond = threading.Condition()
        self._started_at = time.time()
        self.engine: Optional[ServeEngine] = None
        # (artifact info, AOT status) of the serving artifact: ONE tuple
        # swapped in one store, so that /healthz never reads one
        # artifact's family beside another's load status
        self._artifact: Tuple[Dict[str, Any], Optional[str]] = ({}, None)
        self._aot_store = None
        if config.aot:
            from ..aot.store import AotStore, DeferredEvents

            # the boot's store events wait for the manifest (start)
            self._aot_store = AotStore(config.aot_dir,
                                       telemetry=DeferredEvents(),
                                       registry=self.telemetry.registry)
        self.aot_meta: Dict[str, Any] = {}     # the boot's load_packed_aot
        self._boot_mark: Optional[int] = None   # fenced builds at boot
        self._engine_sanitizer = None
        # Request-body cap: a full micro-batch of JSON floats (~32
        # chars/value incl. separators) plus headroom, floored at 1 MiB,
        # enforced BEFORE the body is read.
        n_vals = 1
        for d in config.input_shape:
            n_vals *= int(d)
        self.max_body_bytes = max(
            1 << 20, config.batch_size * n_vals * 32 + (1 << 16)
        )

    def _warm(self, fn, path: str) -> None:
        """One padded-shape call, off the serving path (at boot, or
        before a reload's swap), so the kernels are built and loaded
        before traffic meets them. With the cost ledger armed it is the
        ``classifier_predict`` row's run."""
        warm = np.zeros(
            (self.config.batch_size, *self.config.input_shape), np.float32
        )
        self._ledger.measure(
            "classifier_predict", fn, warm, device=self.config.device,
            telemetry=self.telemetry, extra={"artifact": path}).cpu()

    def _load(self, path: str):
        """(fn, info, aot_meta): through the AOT store with ``aot`` (a
        hit installs the banked libraries), else ``load_packed``."""
        cfg = self.config
        if self._aot_store is None:
            fn, info = load_packed(path, device=cfg.device)
            return fn, info, {"status": "disabled"}
        from ..aot import load_packed_aot

        return load_packed_aot(
            path, batch_size=cfg.batch_size, input_shape=cfg.input_shape,
            device=cfg.device, store=self._aot_store)

    def _load_and_warm(self, path: str):
        fn, info, meta = self._load(path)
        self._warm(fn, path)
        return fn, info, meta

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> Tuple[str, int]:
        """Load + warm the artifact, start the engine and the HTTP
        front end. Returns the bound (host, port)."""
        cfg = self.config
        # the boot mark BEFORE the artifact loads: after a hit, "zero
        # builds" counts from here, not from the end of the warm-up
        self._boot_mark = fenced_build_count()
        fn, info, aot_meta = self._load(cfg.artifact)
        self.aot_meta = aot_meta
        info, status = dict(info), aot_meta.get("status")
        # jg: disable=JG007 -- single-threaded startup: the HTTP front end (the only other reader, and the admin reload, the only other writer) starts below; later writes happen inside reload_artifact under _reload_lock
        self._artifact = (info, status)
        if status == "hit":
            # every library came from the store: nothing is left to build
            self._engine_sanitizer = Sanitizer(
                SanitizerConfig(recompile_fence=True, recompile_budget=0,
                                warmup_steps=0),
                telemetry=self.telemetry, registry=self.telemetry.registry)
            self._engine_sanitizer.pin_baseline(self._boot_mark)
        # the manifest opens the log, before the warm-up's cost row
        self.telemetry.manifest(
            config={
                "artifact": cfg.artifact,
                "batch_size": cfg.batch_size,
                "queue_depth": cfg.queue_depth,
                "default_deadline_ms": cfg.default_deadline_ms,
                "stall_timeout_s": cfg.stall_timeout_s,
                "breaker_threshold": cfg.breaker_threshold,
                "breaker_reset_s": cfg.breaker_reset_s,
                "aot": status,
            },
            device=cfg.device, artifact_info=info,
        )
        if self._aot_store is not None:
            self._aot_store.telemetry.flush(self.telemetry)
            self._aot_store.telemetry = self.telemetry
        self._warm(fn, cfg.artifact)
        self.engine = ServeEngine(
            fn,
            batch_size=cfg.batch_size,
            queue=self.queue,
            breaker=self.breaker,
            telemetry=self.telemetry,
            device=cfg.device,
            stall_timeout_s=cfg.stall_timeout_s,
            linger_s=cfg.linger_ms / 1e3,
            chaos=self.chaos if self.chaos.active else None,
            sanitizer=self._engine_sanitizer,
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

    def _on_breaker_transition(
        self, old: str, new: str, reason: str
    ) -> None:
        self.breaker_transitions.inc(to=new)
        if new == "open":
            self.telemetry.emit(
                "breaker_open", from_state=old, reason=reason
            )
        elif new == "closed":
            self.telemetry.emit(
                "breaker_close", from_state=old, reason=reason
            )
        # half_open is an internal hop; the close/open events bracket it

    def reload_artifact(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Hot swap to ``path`` (default: the configured artifact, read
        again from disk). Load and warm happen before the swap, so the
        worker sees the old or the new predictor, never a half-built
        one."""
        path = path or self.config.artifact
        with self._reload_lock:   # one admin reload at a time
            if self._engine_sanitizer is not None:
                # a reload that misses the store builds off-path, rightly:
                # park the budget-0 fence for its duration, then re-pin
                # it to the count after the reload
                self._engine_sanitizer.pin_baseline(1 << 62)
            try:
                fn, info, aot_meta = self._load_and_warm(path)
                if self.engine is None:
                    raise RuntimeError("reload before start")
                self.engine.swap_predictor(fn)
                # /healthz describes the serving artifact and its load
                self._artifact = (dict(info), aot_meta.get("status"))
            finally:
                if self._engine_sanitizer is not None:
                    self._engine_sanitizer.pin_baseline(
                        fenced_build_count())
        # info nests under its own field: an artifact's "kind" would
        # clobber the event envelope's
        self.telemetry.emit("reload", artifact=path, info=dict(info),
                            aot=aot_meta.get("status"))
        log.info("hot-reloaded artifact %s (%s)", path, info.get("family"))
        return dict(info)

    @property
    def artifact_info(self) -> Dict[str, Any]:
        """The serving artifact's info."""
        # jg: disable=JG007 -- one read of a tuple swapped in one store (reload_artifact, under _reload_lock): the old or the new pair, never a torn one
        return self._artifact[0]

    @property
    def aot_status(self) -> Optional[str]:
        """How the serving artifact loaded: ``hit``, ``miss``,
        ``disabled`` (no ``aot``), ..."""
        # jg: disable=JG007 -- one read of a tuple swapped in one store (reload_artifact, under _reload_lock): the old or the new pair, never a torn one
        return self._artifact[1]

    def health(self) -> Dict[str, Any]:
        eng = self.engine
        # ONE read: the family and the load status of the same artifact.
        # jg: disable=JG007 -- benign racy read of a tuple swapped in one store; taking _reload_lock here would stall /healthz behind a reload's load and warm-up (a JG009 shape)
        info, aot = self._artifact
        if eng is not None and eng.fence_error is not None:
            status = "failed"          # load balancers must route away
        elif eng is not None and eng.draining:
            status = "draining"
        else:
            status = "ok"
        health = {
            "status": status,
            "breaker": self.breaker.state,
            "queue_depth": len(self.queue),
            "batch_size": self.config.batch_size,
            "device": self.config.device,
            "family": info.get("family"),
            "requests": labeled(eng.requests_ctr) if eng else {},
            "sheds": labeled(eng.shed_ctr) if eng else {},
            "batches_total": int(eng.batches_ctr.total()) if eng else 0,
            "fence_error": eng.fence_error if eng is not None else None,
            "aot": aot,
            "fence_budget": (0 if self._engine_sanitizer is not None
                             else None),
            "recompiles_post_boot": (
                fenced_build_count() - self._boot_mark
                if self._boot_mark is not None else None),
            "uptime_s": round(time.time() - self._started_at, 3),
        }
        if self._ledger.enabled:
            # per-program costs and measured MFU, and the memory census
            # (healthz is a poll-rate path)
            from ..obs import device_memory_stats

            health["programs"] = self._ledger.snapshot()
            mem = device_memory_stats(live_fallback=True)
            if mem is not None:
                health["device_memory"] = mem
        return health

    def profile_dir_default(self) -> Optional[str]:
        """The /admin/profile artifact dir without a ``dir`` in the body:
        ``<telemetry_dir>/profile`` (None: the body must name one)."""
        return default_capture_dir(self.config.telemetry_dir)

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
        with self._handling_cond:
            self._handling_cond.wait_for(lambda: self._handling == 0,
                                         timeout=5.0)
        stats = {
            "reason": self.stop_request.reason or "stop requested",
            "inflight_at_drain": inflight,
            "flushed": flushed,
            "requests_total": int(self.engine.requests_ctr.total()),
            "shed_total": int(self.engine.shed_ctr.total()),
            "batches_total": int(self.engine.batches_ctr.total()),
            "wall_s": round(time.monotonic() - t0, 3),
        }
        self.telemetry.emit("drain", **stats)
        self.telemetry.close()
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
        elif self.path == "/metrics":
            # JSON by default, Prometheus text under Accept: text/plain
            from ..ops._kernels import export_launches

            # the process's kernel launches, read from outside (a fleet)
            export_launches(self.srv.telemetry.registry)
            self._reply_metrics(self.srv.telemetry.registry)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        srv = self.srv
        with srv._handling_cond:
            srv._handling += 1
        try:
            self._route_post()
        finally:
            with srv._handling_cond:
                srv._handling -= 1
                srv._handling_cond.notify_all()

    def _route_post(self) -> None:
        if self.path == "/predict":
            self._predict()
        elif self.path == "/admin/reload":
            self._reload()
        elif self.path == "/admin/profile":
            # this handler thread sleeps through the capture window;
            # traffic keeps flowing through the worker
            self._admin_profile(
                self.srv.telemetry, self.srv.profile_dir_default()
            )
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _reload(self) -> None:
        body = self._read_json()
        if body is None:
            return
        try:
            info = self.srv.reload_artifact(body.get("artifact"))
        except (OSError, ValueError, KeyError) as e:
            self._reply(
                400, {"error": f"reload failed: {type(e).__name__}: {e}"}
            )
            return
        self._reply(200, {"reloaded": True, "info": info})

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
        # x-jg-trace: the client mints, this server adopts (malformed
        # headers degrade to a fresh trace, never a 4xx)
        ctx = parse_header(self.headers.get(TRACE_HEADER))
        req = engine.submit(images, deadline, ctx, tier=tier)
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

    def _trace_headers(self, req: Request) -> Optional[Dict[str, str]]:
        """The request's trace id, so a caller that sent no header can
        still find its span tree in the server's log."""
        ctx = req.span.context
        return {TRACE_HEADER: format_header(ctx)} if ctx else None

    def _wait_and_reply(self, req: Request, deadline: float) -> None:
        """Block until the engine resolves ``req`` or its deadline
        passes — the response ALWAYS arrives within deadline + slack,
        even if the backend is mid-stall (the abandoned request is
        claimed, so the engine discards its late result)."""
        remaining = deadline - time.monotonic() + _WAIT_SLACK_S
        if not req.event.wait(max(remaining, 0.0)):
            if req.finish("deadline", error="deadline exceeded"):
                # the waiter owns the root span's end too
                req.span.end("deadline")
                self._reply(504, {"error": "deadline exceeded",
                                  "id": req.id},
                            headers=self._trace_headers(req))
                return
            # engine won the race after our timeout check: fall through
        status = req.status
        m_resp = time.monotonic()
        trace_headers = self._trace_headers(req)
        if status == "ok":
            lp = req.log_probs
            self._reply(200, {
                "argmax": [int(i) for i in lp.argmax(-1)],
                "log_probs": [[float(v) for v in row] for row in lp],
            }, headers=trace_headers)
        elif status == "deadline":
            self._reply(504, {"error": req.error or "deadline exceeded",
                              "id": req.id}, headers=trace_headers)
        elif status == "breaker_open":
            self._reply(503, {"error": "shed", "reason": "breaker_open",
                              "id": req.id},
                        headers={**(trace_headers or {}),
                                 **self._shed_headers("breaker_open")})
        elif status == "shed":
            self._reply(503, {"error": "shed", "reason": "displaced",
                              "tier": req.tier, "id": req.id},
                        headers={**(trace_headers or {}),
                                 **self._shed_headers("displaced")})
        else:
            self._reply(502, {"error": req.error or "backend failure",
                              "id": req.id}, headers=trace_headers)
        engine = self.srv.engine
        if engine is not None and engine.tracer.enabled:
            # wake-to-reply-written: the respond phase of the tree
            engine.tracer.record(
                "serve.respond", kind="respond", parent=req.span,
                t0=m_resp, t1=time.monotonic(), status=str(status),
            )
