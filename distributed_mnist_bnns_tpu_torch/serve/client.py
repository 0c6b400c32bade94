"""Minimal stdlib HTTP client for the packed-inference server.

Counterpart of the JAX package's ``serve/client.py`` (``predict`` and
``healthz``). Every helper returns ``(status_code, body_bytes)``: raw
bytes on purpose, so callers can compare response bodies bitwise.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple


def _request(
    url: str, *, data: Optional[bytes] = None, timeout: float = 30.0,
) -> Tuple[int, bytes]:
    req = urllib.request.Request(
        url, data=data,
        headers={"Content-Type": "application/json"} if data else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        # 4xx/5xx still carry the server's JSON body — that's the shed/
        # deadline/breaker signal callers assert on, not a client crash.
        return e.code, e.read()


def predict(
    base_url: str, images: Any, *,
    deadline_ms: Optional[float] = None, timeout: float = 30.0,
    tier: Optional[str] = None,
) -> Tuple[int, bytes]:
    """POST /predict. ``images``: nested lists (one example or a batch);
    ``tier``: the SLO class (``interactive`` / ``batch``)."""
    body: Dict[str, Any] = {"images": images}
    if deadline_ms is not None:
        body["deadline_ms"] = deadline_ms
    if tier is not None:
        body["tier"] = tier
    return _request(
        base_url + "/predict", data=json.dumps(body).encode(),
        timeout=timeout,
    )


def healthz(base_url: str, timeout: float = 10.0) -> Tuple[int, bytes]:
    return _request(base_url + "/healthz", timeout=timeout)
