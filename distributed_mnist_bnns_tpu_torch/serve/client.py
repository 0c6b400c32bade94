"""Minimal stdlib HTTP client for the packed-inference server.

Counterpart of the JAX package's ``serve/client.py`` (``predict`` with
the ``x-jg-trace`` header, ``healthz``, ``metrics``,
``reload_artifact``), without its retrying wrapper. Every helper returns
``(status_code, body_bytes)``: raw bytes on purpose, so callers can
compare response bodies bitwise (the hot-reload check does);
``request_full`` also returns the reply's headers.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple

from ..obs.trace import TRACE_HEADER, format_header, mint_context


def request_full(
    url: str, *, data: Optional[bytes] = None, timeout: float = 30.0,
    headers: Optional[Dict[str, str]] = None,
) -> Tuple[int, bytes, Dict[str, str]]:
    req = urllib.request.Request(
        url, data=data,
        headers={
            **({"Content-Type": "application/json"} if data else {}),
            **(headers or {}),
        },
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), dict(resp.headers)
    except urllib.error.HTTPError as e:
        # 4xx/5xx still carry the server's JSON body — that's the shed/
        # deadline/breaker signal callers assert on, not a client crash.
        return e.code, e.read(), dict(e.headers or {})


def _request(
    url: str, *, data: Optional[bytes] = None, timeout: float = 30.0,
    headers: Optional[Dict[str, str]] = None,
) -> Tuple[int, bytes]:
    status, body, _ = request_full(url, data=data, timeout=timeout,
                                   headers=headers)
    return status, body


def trace_headers(trace: Any) -> Optional[Dict[str, str]]:
    """The ``x-jg-trace`` header of the contract's client half: ``True``
    mints a fresh context; a ``TraceContext`` or a preformatted header
    string is sent as it is; None sends none."""
    if trace is None:
        return None
    if trace is True:
        trace = mint_context()
    value = trace if isinstance(trace, str) else format_header(trace)
    return {TRACE_HEADER: value}


def predict(
    base_url: str, images: Any, *,
    deadline_ms: Optional[float] = None, timeout: float = 30.0,
    trace: Any = None, tier: Optional[str] = None,
) -> Tuple[int, bytes]:
    """POST /predict. ``images``: nested lists (one example or a batch);
    ``trace``: the ``x-jg-trace`` header (``trace_headers``), which the
    server adopts as the parent of the request's span tree; ``tier``:
    the SLO class (``interactive`` / ``batch``)."""
    body: Dict[str, Any] = {"images": images}
    if deadline_ms is not None:
        body["deadline_ms"] = deadline_ms
    if tier is not None:
        body["tier"] = tier
    return _request(
        base_url + "/predict", data=json.dumps(body).encode(),
        timeout=timeout, headers=trace_headers(trace),
    )


def healthz(base_url: str, timeout: float = 10.0) -> Tuple[int, bytes]:
    return _request(base_url + "/healthz", timeout=timeout)


def metrics(base_url: str, timeout: float = 10.0, *,
            prometheus: bool = False) -> Tuple[int, bytes]:
    """GET /metrics: the registry as JSON, or with ``prometheus`` the
    text exposition (``Accept: text/plain``)."""
    return _request(base_url + "/metrics", timeout=timeout,
                    headers={"Accept": "text/plain"} if prometheus
                    else None)


def reload_artifact(
    base_url: str, artifact: Optional[str] = None, timeout: float = 60.0
) -> Tuple[int, bytes]:
    body = {"artifact": artifact} if artifact else {}
    return _request(
        base_url + "/admin/reload", data=json.dumps(body).encode(),
        timeout=timeout,
    )


def profile(base_url: str, duration_ms: float = 1000.0, *,
            artifact_dir: Optional[str] = None,
            timeout: float = 120.0) -> Tuple[int, bytes]:
    """POST /admin/profile: a ``torch.profiler`` capture of the next
    ``duration_ms`` into ``artifact_dir`` (default: the server's
    ``<telemetry_dir>/profile``)."""
    body: Dict[str, Any] = {"duration_ms": duration_ms}
    if artifact_dir:
        body["dir"] = artifact_dir
    return _request(base_url + "/admin/profile",
                    data=json.dumps(body).encode(), timeout=timeout)
