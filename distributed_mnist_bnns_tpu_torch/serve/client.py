"""Minimal stdlib HTTP client for the packed-inference server.

Counterpart of the JAX package's ``serve/client.py`` (``predict`` with
the ``x-jg-trace`` header, ``healthz``, ``metrics``,
``reload_artifact``, ``predict_with_retries``: retries inside one
overall deadline, the client half a fleet router expects). Every helper
returns ``(status_code, body_bytes)``: raw bytes on purpose, so callers can
compare response bodies bitwise (the hot-reload check does);
``request_full`` also returns the reply's headers.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Optional, Tuple

from ..obs.trace import TRACE_HEADER, format_header, mint_context


def parse_retry_after(value: Optional[str]) -> Optional[float]:
    """The servers' fractional delta-seconds ``Retry-After``; an absent,
    malformed or negative value gives None."""
    if not value:
        return None
    try:
        after = float(value)
    except ValueError:
        return None
    return after if after >= 0 else None


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


def predict_with_retries(
    base_url: str, images: Any, *,
    deadline_ms: float = 2000.0,
    max_attempts: int = 6,
    backoff_s: float = 0.05,
    timeout: float = 30.0,
    trace: Any = None,
    tier: Optional[str] = None,
    seed: Optional[int] = 0,
    sleep=time.sleep,
) -> Tuple[int, bytes]:
    """``predict`` with retries on 503 and 502 inside ONE overall
    deadline, the client half a fleet router expects. A 503 shed waits
    the server's ``Retry-After`` hint (capped by the remaining budget);
    502s and transport errors back off jittered exponentially
    (``resilience.policy.RetryPolicy``); 200 and 4xx return at once, and
    so does a 504 (the budget died server-side). Each attempt's body
    carries the REMAINING deadline, never the original."""
    from ..resilience.policy import RetryPolicy

    policy = RetryPolicy(base_backoff_s=backoff_s, max_backoff_s=1.0,
                         seed=seed)
    overall = time.monotonic() + deadline_ms / 1e3
    last: Tuple[int, bytes] = (599, b'{"error": "no attempt made"}')
    if trace is True:   # one trace for every attempt
        trace = mint_context()
    for attempt in range(1, max_attempts + 1):
        remaining_ms = (overall - time.monotonic()) * 1e3
        if remaining_ms <= 0:
            return last
        body: Dict[str, Any] = {"images": images,
                                "deadline_ms": remaining_ms}
        if tier is not None:
            body["tier"] = tier
        try:
            status, payload, rheaders = request_full(
                base_url + "/predict", data=json.dumps(body).encode(),
                timeout=min(timeout, remaining_ms / 1e3 + 1.0),
                headers=trace_headers(trace))
        except OSError as e:
            status, payload, rheaders = (
                -1, f'{{"error": "{type(e).__name__}"}}'.encode(), {})
        last = (status, payload)
        if status == 200 or (400 <= status < 500) or status == 504:
            return last
        if attempt >= max_attempts:
            return last          # decided: sleep no dead delay
        delay = (parse_retry_after(rheaders.get("Retry-After"))
                 if status == 503 else None)
        if delay is None:
            delay = policy.backoff(attempt)
        sleep(min(delay, max(overall - time.monotonic(), 0.0)))
    return last


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
