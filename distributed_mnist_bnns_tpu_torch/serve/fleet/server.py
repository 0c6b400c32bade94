"""`cli fleet` — the multi-replica serving front end.

One process owns the whole serving fleet: the :class:`~.router.
RouterCore` (deadline-aware dispatch + health probing + per-replica
breakers), the :class:`~.supervisor.ReplicaSupervisor` (replica
subprocesses of the port's ``cli serve`` on ``--device``, respawn on
death, autoscaling between min/max), and the :class:`~.rollout.
RolloutManager` (transfer-shipped artifacts, canary, fleet-wide
rollback) — behind one stdlib HTTP endpoint:

  POST /predict        classifier requests: parsed just enough to read
                       ``deadline_ms``/``tier``, then the ORIGINAL
                       bytes are forwarded to the picked replica (the
                       bitwise reload-identity contract passes through
                       the router); failover to another replica within
                       the client deadline
  POST /generate       LM requests (``--lm`` fleets): prefix-affinity
                       pick, the replica's ndjson stream relayed
                       incrementally; no mid-stream retry
  GET  /healthz        fleet view: per-replica health/breaker/inflight
                       rows, live/target counts, current artifact
  GET  /metrics        obs registry snapshot (fleet counters + gauges);
                       Prometheus text under Accept: text/plain
  POST /admin/rollout  {"artifact": path, "ship": bool} — the rolling
                       deploy state machine (canary → promote →
                       automatic fleet-wide rollback on trip)
  POST /admin/scale    {"target": N} — manual target override, clamped
                       to [min, max] (the autoscaler keeps adjusting
                       from there unless disabled)

Lifecycle matches the single servers (crash-only, SERVING.md): SIGTERM
stops admission (503 ``draining``), SIGTERMs every replica and waits
for their graceful drains, emits one fleet ``drain`` event, exits 0.
"""

from __future__ import annotations

import http.client
import json
import logging
import math
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from http.server import ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...resilience.preempt import StopRequest
from ..core import DEFAULT_TIER, TIERS
from ..httpbase import JsonHandler
from .router import RouterCore, affinity_key
from .rollout import RolloutManager
from .supervisor import (
    Autoscaler,
    FleetView,
    ReplicaSupervisor,
)

log = logging.getLogger(__name__)


@dataclass
class FleetConfig:
    """Fleet shape + robustness budgets (CLI flags mirror these)."""

    artifact: str
    host: str = "127.0.0.1"
    port: int = 8100                 # router port; 0 = ephemeral
    replicas: int = 2                # initial target
    min_replicas: int = 1
    max_replicas: int = 4
    lm: bool = False                 # `cli serve --lm` replicas +
                                     # /generate prefix-affinity routing
    device: str = "cuda"             # the replicas' `cli serve --device`
    page_size: int = 16              # LM: the prefix-affinity block
    input_shape: Tuple[int, ...] = (28, 28, 1)   # rollout probe shape
    default_deadline_ms: float = 1000.0
    max_attempts: int = 3            # dispatch attempts per request
    probe_interval_s: float = 0.25   # replica /healthz poll cadence
    breaker_threshold: int = 3       # per-replica router breaker
    breaker_reset_s: float = 1.0
    boot_timeout_s: float = 180.0    # replica spawn -> healthy budget
    autoscale: bool = True
    queue_high: float = 4.0          # mean replica queue depth to grow
    queue_low: float = 0.5           # ... and to shrink below
    sustain_s: float = 1.0           # signal hold before acting
    cooldown_s: float = 3.0          # between autoscale decisions
    scrape_interval_s: float = 1.0   # replica /metrics scrape cadence
    slo: bool = True                 # burn-rate SLO alerting
    slo_fast_window_s: float = 60.0  # burn-rate fast/slow windows —
    slo_slow_window_s: float = 300.0 # smokes shrink these to seconds
    drain_timeout_s: float = 60.0
    staging_dir: Optional[str] = None   # rollout ship target (default:
                                     # <telemetry_dir>/staging)
    telemetry_dir: Optional[str] = None
    trace: Optional[bool] = None
    events_max_bytes: Optional[int] = None
    seed: int = 0
    replica_flags: List[str] = field(default_factory=list)
                                     # extra `cli serve` argv passed to
                                     # every replica (chaos, engine
                                     # geometry, ...)


class FleetServer:
    """Owns router + supervisor + rollout + the HTTP front end."""

    def __init__(self, config: FleetConfig):
        self.config = config
        from ...obs import SLOMonitor, Telemetry, default_fleet_slos

        self.telemetry = Telemetry(
            config.telemetry_dir, heartbeat=False, trace=config.trace,
            events_max_bytes=config.events_max_bytes,
        )
        self.slo = SLOMonitor(
            default_fleet_slos(
                request_p99_ms=config.default_deadline_ms * 1.5,
                fast_window_s=config.slo_fast_window_s,
                slow_window_s=config.slo_slow_window_s,
            ),
            registry=self.telemetry.registry,
            emit=self.telemetry.emit,
        ) if config.slo else None
        self.router = RouterCore(
            telemetry=self.telemetry,
            probe_timeout_s=2.0,
            breaker_threshold=config.breaker_threshold,
            breaker_reset_s=config.breaker_reset_s,
            page_size=config.page_size,
            max_attempts=config.max_attempts,
            slo=self.slo,
        )
        self.view = FleetView(
            min_replicas=config.min_replicas,
            max_replicas=config.max_replicas,
            target=max(config.min_replicas,
                       min(config.replicas, config.max_replicas)),
        )
        autoscaler = Autoscaler(
            queue_high=config.queue_high,
            queue_low=config.queue_low,
            sustain_s=config.sustain_s,
            cooldown_s=config.cooldown_s,
        ) if config.autoscale else None
        self.supervisor = ReplicaSupervisor(
            self.router,
            self._spawn_command,
            artifact=config.artifact,
            view=self.view,
            telemetry=self.telemetry,
            host="127.0.0.1",
            boot_timeout_s=config.boot_timeout_s,
            autoscaler=autoscaler,
        )
        staging = config.staging_dir
        if staging is None and config.telemetry_dir:
            staging = os.path.join(config.telemetry_dir, "staging")
        probe_body = None
        if not config.lm:
            probe = np.zeros((1, *config.input_shape), np.float32)
            probe_body = json.dumps(
                {"images": probe.tolist(), "deadline_ms": 10000.0}
            ).encode()
        self.rollout = RolloutManager(
            self.router,
            artifact=config.artifact,
            supervisor=self.supervisor,
            telemetry=self.telemetry,
            staging_dir=staging,
            probe_body=probe_body,
        )
        self.stop_request = StopRequest()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._started_at = time.time()
        self.draining = False

    # -- replica command -----------------------------------------------------

    def _spawn_command(
        self, rid: str, port: int, artifact: str
    ) -> List[str]:
        cfg = self.config
        cmd = [
            sys.executable, "-m", "distributed_mnist_bnns_tpu_torch.cli",
            "serve",
            "--artifact", artifact,
            "--host", "127.0.0.1",
            "--port", str(port),
            "--device", cfg.device,
        ]
        if cfg.lm:
            cmd.append("--lm")
            cmd += ["--page-size", str(cfg.page_size)]
        if cfg.telemetry_dir:
            cmd += [
                "--telemetry-dir",
                os.path.join(cfg.telemetry_dir, rid),
                "--log-file",
                os.path.join(cfg.telemetry_dir, f"{rid}.log"),
            ]
            if self.telemetry.tracer.enabled:
                cmd.append("--trace")
        cmd += cfg.replica_flags
        return cmd

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> Tuple[str, int]:
        cfg = self.config
        server = self

        class Handler(_FleetHandler):
            srv = server

        self._httpd = ThreadingHTTPServer((cfg.host, cfg.port), Handler)
        self._httpd.daemon_threads = True
        host, port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="fleet-http",
            daemon=True,
        )
        self._http_thread.start()
        self.supervisor.start()
        self.router.start_prober(cfg.probe_interval_s)
        if cfg.scrape_interval_s > 0:
            self.router.start_scraper(cfg.scrape_interval_s)
        self.telemetry.manifest(config={
            "artifact": cfg.artifact,
            "engine": "fleet",
            "lm": cfg.lm,
            "device": cfg.device,
            "replicas": self.view.target,
            "min_replicas": cfg.min_replicas,
            "max_replicas": cfg.max_replicas,
            "autoscale": cfg.autoscale,
            "default_deadline_ms": cfg.default_deadline_ms,
            "replica_flags": cfg.replica_flags,
        })
        log.info(
            "fleet router on %s:%d — %d replica(s) [%d, %d], "
            "artifact %s", host, port, self.view.target,
            cfg.min_replicas, cfg.max_replicas, cfg.artifact,
        )
        return host, port

    def health(self) -> Dict[str, Any]:
        from ...obs import healthz_rollup

        snap = self.router.snapshot()
        store = self.router.metrics_store
        rollup = healthz_rollup(snap["replicas"], store.healthz())
        out = {
            "status": "draining" if self.draining else "ok",
            "engine": "fleet",
            "target_replicas": self.view.target,
            "min_replicas": self.view.min_replicas,
            "max_replicas": self.view.max_replicas,
            "artifact": self.rollout.current_artifact,
            "uptime_s": round(time.time() - self._started_at, 3),
            **snap,
            "fleet": {
                "replicas_total": rollup["replicas_total"],
                "replicas_healthy": rollup["replicas_healthy"],
                "status": rollup["status"],
                **store.status(),
            },
            "replica_health": rollup["replicas"],
        }
        if self.slo is not None:
            out["slo_open_alerts"] = self.slo.open_alerts()
        return out

    def request_stop(self, reason: str = "stop requested") -> None:
        self.stop_request.request(reason)

    def drain_and_stop(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        self.draining = True        # front end replies 503 draining
        self.router.stop_scraper()
        self.router.stop_prober()
        rcs = self.supervisor.drain_all(
            timeout=self.config.drain_timeout_s
        )
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        stats = {
            "reason": self.stop_request.reason or "stop requested",
            "replica_rcs": rcs,
            "requests_total": int(self.router.requests_ctr.total()),
            "retries_total": int(self.router.retries_ctr.total()),
            "wall_s": round(time.monotonic() - t0, 3),
        }
        self.telemetry.emit("drain", engine="fleet", **stats)
        self.telemetry.close()
        log.info("fleet drained and stopped: %s", stats)
        return stats

    def run(self) -> int:
        """CLI entry: serve until SIGTERM/SIGINT, drain the whole
        fleet, exit 0 (replica exit codes folded in: a replica that
        failed its own drain fails the fleet's)."""
        with self.stop_request.install():
            self.start()
            while not self.stop_request.requested:
                time.sleep(0.05)
        stats = self.drain_and_stop()
        bad = {
            rid: rc for rid, rc in stats["replica_rcs"].items()
            if rc != 0
        }
        if bad:
            log.error("replica(s) exited non-zero at drain: %s", bad)
            return 1
        return 0


class _FleetHandler(JsonHandler):
    """Router front end. Request bodies are read RAW (one read, under
    the shared size cap) and parsed only for the routing envelope —
    the replica sees the client's exact bytes."""

    srv: FleetServer
    logger = log

    def _max_body_bytes(self) -> int:
        return 1 << 22

    def _read_raw(self) -> Optional[bytes]:
        try:
            n = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._reply(400, {"error": "bad Content-Length"})
            return None
        if n > self._max_body_bytes():
            self.close_connection = True
            self._reply(413, {"error": self._body_limit_error(n)})
            return None
        return self.rfile.read(n) if n else b"{}"

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._reply(200, self.srv.health())
        elif self.path == "/metrics":
            from ...obs import FleetMetricsView

            self._reply_metrics(FleetMetricsView(
                self.srv.telemetry.registry,
                self.srv.router.metrics_store,
            ))
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/predict":
            self._predict()
        elif self.path == "/generate":
            self._generate()
        elif self.path == "/admin/rollout":
            self._rollout()
        elif self.path == "/admin/scale":
            self._scale()
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    # -- routing envelope ----------------------------------------------------

    def _envelope(
        self, raw: bytes
    ) -> Optional[Tuple[Dict[str, Any], float, str]]:
        """Parse just deadline_ms + tier out of the client body (the
        rest is the replica's to validate)."""
        try:
            body = json.loads(raw or b"{}")
            if not isinstance(body, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request body: {e}"})
            return None
        try:
            deadline_ms = float(body.get(
                "deadline_ms", self.srv.config.default_deadline_ms
            ))
        except (TypeError, ValueError):
            deadline_ms = float("nan")
        if not (math.isfinite(deadline_ms) and deadline_ms > 0):
            self._reply(400, {
                "error": f"deadline_ms must be a positive finite "
                         f"number, got {body.get('deadline_ms')!r}",
            })
            return None
        tier = body.get("tier", DEFAULT_TIER)
        if tier not in TIERS:
            self._reply(400, {
                "error": f"unknown tier {tier!r} (have: "
                         f"{', '.join(TIERS)})",
            })
            return None
        return body, time.monotonic() + deadline_ms / 1e3, tier

    def _shed_if_draining(self) -> bool:
        if self.srv.draining:
            self._reply(503, {"error": "shed", "reason": "draining"},
                        headers={"Retry-After": "1.000"})
            return True
        return False

    def _predict(self) -> None:
        if self._shed_if_draining():
            return
        if self.srv.config.lm:
            self._reply(404, {"error": "this is an --lm fleet; "
                                       "POST /generate"})
            return
        raw = self._read_raw()
        if raw is None:
            return
        env = self._envelope(raw)
        if env is None:
            return
        _, deadline, tier = env
        from ...obs.trace import TRACE_HEADER, parse_header

        hdr = self.headers.get(TRACE_HEADER)
        status, body, rheaders = self.srv.router.dispatch_predict(
            raw, deadline=deadline,
            headers={TRACE_HEADER: hdr} if hdr else None,
            ctx=parse_header(hdr), tier=tier,
        )
        self._reply_raw(status, body, rheaders)

    def _generate(self) -> None:
        if self._shed_if_draining():
            return
        if not self.srv.config.lm:
            self._reply(404, {"error": "not an --lm fleet; "
                                       "POST /predict"})
            return
        raw = self._read_raw()
        if raw is None:
            return
        env = self._envelope(raw)
        if env is None:
            return
        body, deadline, tier = env
        key = affinity_key(
            prompt=body.get("prompt"), text=body.get("text"),
            page_size=self.srv.config.page_size,
        )
        from ...obs.trace import TRACE_HEADER, parse_header

        hdr = self.headers.get(TRACE_HEADER)
        status, payload, rheaders, _rid = (
            self.srv.router.dispatch_generate(
                raw, deadline=deadline, affinity=key,
                headers={TRACE_HEADER: hdr} if hdr else None,
                ctx=parse_header(hdr), tier=tier,
            )
        )
        if status != 200:
            self._reply_raw(status, payload, rheaders)
            return
        # relay the live ndjson stream, re-chunked to our client
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            if TRACE_HEADER in rheaders:
                self.send_header(TRACE_HEADER, rheaders[TRACE_HEADER])
            self.end_headers()
            for line in payload:
                self.wfile.write(
                    f"{len(line):X}\r\n".encode() + line + b"\r\n"
                )
                self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()
        except (OSError, http.client.HTTPException):
            # OSError: OUR client went away. HTTPException
            # (IncompleteRead/BadStatusLine, not OSErrors): the REPLICA
            # died mid-stream — either way the chunked reply cannot be
            # terminated cleanly; drop the connection.
            self.close_connection = True
        finally:
            close = getattr(payload, "close", None)
            if close is not None:
                close()

    def _reply_raw(
        self, status: int, body: bytes, rheaders: Dict[str, str]
    ) -> None:
        """Relay a buffered replica response byte-for-byte (plus the
        pass-through headers that matter: trace id + Retry-After)."""
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k in ("x-jg-trace", "Retry-After"):
            for name, value in rheaders.items():
                if name.lower() == k.lower():
                    self.send_header(k, value)
        self.end_headers()
        self.wfile.write(body)

    # -- admin ---------------------------------------------------------------

    def _rollout(self) -> None:
        body = self._read_json()
        if body is None:
            return
        artifact = body.get("artifact")
        if not artifact:
            self._reply(400, {"error": "need {\"artifact\": path}"})
            return
        try:
            result = self.srv.rollout.rolling_reload(
                str(artifact), ship=body.get("ship"),
            )
        except (OSError, ValueError, RuntimeError) as e:
            self._reply(400, {
                "error": f"rollout failed: {type(e).__name__}: {e}",
            })
            return
        self._reply(200, result)

    def _scale(self) -> None:
        body = self._read_json()
        if body is None:
            return
        try:
            target = int(body["target"])
        except (KeyError, TypeError, ValueError):
            self._reply(400, {"error": "need {\"target\": int}"})
            return
        view = self.srv.view
        clamped = view.clamp(target)
        previous, view.target = view.target, clamped
        self.srv.telemetry.emit(
            "autoscale", direction="manual",
            target_from=previous, target_to=clamped,
        )
        self.srv.telemetry.emit(
            "decision", actor="operator", action="manual_scale",
            inputs={"requested": target, "target_to": clamped,
                    "target_from": previous,
                    "min_replicas": view.min_replicas,
                    "max_replicas": view.max_replicas},
        )
        self._reply(200, {"target": clamped, "previous": previous})
