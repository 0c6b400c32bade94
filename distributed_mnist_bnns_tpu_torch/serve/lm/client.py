"""Minimal stdlib client for the streaming LM server.

Counterpart of the JAX package's ``serve/lm/client.py`` (with the
``x-jg-trace`` header, ``metrics`` and ``generate_with_retries``).
``http.client`` decodes chunked transfer encoding, so iterating the
response yields one JSON object per emitted token as it arrives.
``profile`` is the classifier client's (the same endpoint).
"""

from __future__ import annotations

import http.client
import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ...resilience.policy import RetryPolicy
from ..client import metrics, parse_retry_after, profile, trace_headers

__all__ = ["generate", "generate_with_retries", "healthz", "iter_lines",
           "metrics", "open_stream", "parse_retry_after", "profile"]


def open_stream(
    base_url: str, prompt: Any, *,
    max_new_tokens: Optional[int] = None,
    deadline_ms: Optional[float] = None,
    temperature: Optional[float] = None,
    seed: Optional[int] = None,
    timeout: float = 60.0,
    trace: Any = None,
) -> Tuple[int, Any]:
    """Start a generation. Returns ``(200, response)`` (read the stream
    with :func:`iter_lines`; its ``x-jg-trace`` header names the
    stream's trace) or ``(code, parsed_error_body)``, the body carrying
    a shed's ``Retry-After`` as ``_retry_after``. A ``str`` prompt is
    sent as ``"text"``, anything else as the token list; ``trace``: the
    ``x-jg-trace`` header the server adopts (``True`` mints one)."""
    body: Dict[str, Any] = (
        {"text": prompt} if isinstance(prompt, str)
        else {"prompt": list(prompt)}
    )
    for key, value in (("max_new_tokens", max_new_tokens),
                       ("deadline_ms", deadline_ms),
                       ("temperature", temperature), ("seed", seed)):
        if value is not None:
            body[key] = value
    req = urllib.request.Request(
        base_url + "/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json",
                 **(trace_headers(trace) or {})},
    )
    try:
        resp = urllib.request.urlopen(req, timeout=timeout)
        return resp.status, resp
    except urllib.error.HTTPError as e:
        raw = e.read()
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = {"error": raw.decode("utf-8", "replace")}
        if isinstance(parsed, dict):
            after = parse_retry_after((e.headers or {}).get("Retry-After"))
            if after is not None:
                parsed["_retry_after"] = after
        return e.code, parsed


def iter_lines(resp) -> Iterator[Dict[str, Any]]:
    """Yield each ndjson event of a 200 stream as it arrives."""
    with resp:
        for line in resp:
            line = line.strip()
            if line:
                yield json.loads(line)


def generate(
    base_url: str, prompt: Any, **kw: Any
) -> Tuple[int, List[Dict[str, Any]]]:
    """Collect a whole generation: ``(200, [token events..., done])`` or
    ``(code, [error body])``."""
    code, resp = open_stream(base_url, prompt, **kw)
    if code != 200:
        return code, [resp]
    return code, list(iter_lines(resp))


def generate_with_retries(
    base_url: str, prompt: Any, *, max_attempts: int = 4,
    backoff_s: float = 0.05, seed: Optional[int] = 0, sleep: Any = None,
    **kw: Any,
) -> Tuple[int, List[Dict[str, Any]]]:
    """``generate``, retried only before the stream opens: a 503 shed
    (after its ``Retry-After``, else the policy's backoff) and a failed
    connect both prove no token was produced. Once a 200 stream opens the
    generation is not idempotent: a stream that dies mid-way comes back
    as its events so far plus ``{"error": ..., "truncated": True}``,
    never as a silent second generation."""
    sleep = sleep if sleep is not None else time.sleep
    policy = RetryPolicy(base_backoff_s=backoff_s, max_backoff_s=1.0,
                         seed=seed)
    last: Tuple[int, List[Dict[str, Any]]] = (
        599, [{"error": "no attempt made"}])
    for attempt in range(1, max_attempts + 1):
        try:
            code, resp = open_stream(base_url, prompt, **kw)
        except OSError as e:
            last = (-1, [{"error": f"transport: {type(e).__name__}"}])
            if attempt >= max_attempts:
                return last
            sleep(policy.backoff(attempt))
            continue
        if code == 200:
            events: List[Dict[str, Any]] = []
            try:
                for ev in iter_lines(resp):
                    events.append(ev)
            except (OSError, ValueError, http.client.HTTPException) as e:
                events.append({"error": f"stream failed: {type(e).__name__}",
                               "truncated": True})
            if not events or not (events[-1].get("done")
                                  or events[-1].get("truncated")):
                # the protocol ends every stream with a done event; a
                # chunked EOF without one is silent at this layer
                events.append({"error": "stream ended without a done event",
                               "truncated": True})
            return code, events
        last = (code, [resp])
        if code != 503 or attempt >= max_attempts:
            return last
        after = resp.get("_retry_after") if isinstance(resp, dict) else None
        sleep(after if after is not None else policy.backoff(attempt))
    return last


def healthz(base_url: str, timeout: float = 10.0) -> Tuple[int, bytes]:
    try:
        with urllib.request.urlopen(
            base_url + "/healthz", timeout=timeout
        ) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
