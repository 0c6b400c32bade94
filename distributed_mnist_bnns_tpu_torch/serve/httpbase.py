"""Shared stdlib-HTTP handler plumbing for the serving front ends (the
JAX package's ``serve/httpbase.py``).

Both servers (serve/server.py classifier micro-batcher, serve/lm/
streaming generation) speak JSON over ``ThreadingHTTPServer``; the
request/response mechanics that must not drift between them live here:
keep-alive HTTP/1.1 with a connection-socket timeout (a client that
declares a Content-Length and never sends the body must not pin a
handler thread forever), stderr chatter routed into logging, one
``_reply`` shape, a body-size cap enforced BEFORE the body is read
(overload protection must not be bypassable by size; replying without
reading desyncs a keep-alive connection, so an oversize request closes
it), and the shared ``/metrics`` content negotiation: JSON by default,
Prometheus text exposition under ``Accept: text/plain`` — one scrape
format for the whole replica fleet (OBSERVABILITY.md).
"""

from __future__ import annotations

import json
import logging
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Optional

_log = logging.getLogger(__name__)

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class JsonHandler(BaseHTTPRequestHandler):
    """JSON request/response base; subclasses bind their server object
    and override ``_max_body_bytes`` / ``logger`` as needed."""

    protocol_version = "HTTP/1.1"
    timeout = 30.0
    logger = _log

    # route BaseHTTPRequestHandler's stderr chatter into logging
    def log_message(self, fmt: str, *args: Any) -> None:
        self.logger.debug("http: " + fmt, *args)

    def _max_body_bytes(self) -> int:
        return 1 << 20

    def _body_limit_error(self, n: int) -> str:
        return (f"body of {n} bytes exceeds the "
                f"{self._max_body_bytes()}-byte limit")

    def _reply(
        self, code: int, payload: Dict[str, Any],
        headers: Optional[Dict[str, str]] = None,
    ) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _reply_metrics(self, registry: Any) -> None:
        """``GET /metrics`` for both serving engines: the registry
        snapshot as JSON (the default, what the repo's own tooling
        reads), or Prometheus text exposition when the client asks for
        ``text/plain`` — fleet scrapers negotiate, nothing breaks."""
        accept = self.headers.get("Accept", "")
        if "text/plain" not in accept:
            self._reply(200, registry.snapshot())
            return
        from ..obs import render_prometheus

        body = render_prometheus(registry.snapshot()).encode()
        self.send_response(200)
        self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _admin_profile(
        self, telemetry: Any, default_dir: Optional[str],
    ) -> None:
        """``POST /admin/profile {"duration_ms": N, "dir": optional}``
        for both serving front ends: arm an on-demand ``torch.profiler``
        capture for the window, off the serving path (THIS handler
        thread sleeps through it; the engine worker never blocks), and
        reply with the artifact dir + sizes. One capture per process: a
        concurrent request gets 409."""
        from ..obs.profile import ProfileBusyError, get_profiler

        body = self._read_json()
        if body is None:
            return
        try:
            duration_ms = float(body.get("duration_ms", 1000.0))
        except (TypeError, ValueError):
            duration_ms = float("nan")
        if not duration_ms > 0:   # also catches NaN
            self._reply(400, {
                "error": "duration_ms must be a positive number, got "
                         f"{body.get('duration_ms')!r}",
            })
            return
        artifact_dir = body.get("dir") or default_dir
        if not artifact_dir:
            self._reply(400, {
                "error": "no artifact dir: pass {\"dir\": ...} or run "
                         "the server with --telemetry-dir",
            })
            return
        try:
            summary = get_profiler().capture(
                duration_ms, artifact_dir=str(artifact_dir),
                telemetry=telemetry,
            )
        except ProfileBusyError as e:
            self._reply(409, {"error": str(e)})
            return
        except (OSError, RuntimeError, ValueError) as e:
            self._reply(500, {
                "error": f"capture failed: {type(e).__name__}: {e}",
            })
            return
        self._reply(200, summary)

    def _read_json(self) -> Optional[Dict[str, Any]]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            if n > self._max_body_bytes():
                # replying without reading the body desyncs a keep-
                # alive connection — close it instead of draining GBs
                self.close_connection = True
                self._reply(413, {"error": self._body_limit_error(n)})
                return None
            return json.loads(self.rfile.read(n) or b"{}")
        except (ValueError, json.JSONDecodeError) as e:
            self._reply(400, {"error": f"bad request body: {e}"})
            return None
