"""Stdlib-HTTP handler plumbing for the serving front end.

A copy of the JAX package's ``serve/httpbase.py`` without the
``/metrics`` and ``/admin/profile`` helpers (those endpoints are not in
this package yet): keep-alive HTTP/1.1 with a connection-socket timeout
(a client that declares a Content-Length and never sends the body must
not pin a handler thread forever), stderr chatter routed into logging,
one ``_reply`` shape, and a body-size cap enforced BEFORE the body is
read (replying without reading desyncs a keep-alive connection, so an
oversize request closes it).
"""

from __future__ import annotations

import json
import logging
from http.server import BaseHTTPRequestHandler
from typing import Any, Dict, Optional

_log = logging.getLogger(__name__)


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
