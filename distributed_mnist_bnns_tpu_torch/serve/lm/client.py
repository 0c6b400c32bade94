"""Minimal stdlib client for the streaming LM server.

Counterpart of the JAX package's ``serve/lm/client.py`` (with the
``x-jg-trace`` header and ``metrics``), without its retrying wrapper.
``http.client`` decodes chunked transfer encoding, so iterating the
response yields one JSON object per emitted token as it arrives.
``profile`` is the classifier client's (the same endpoint).
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..client import metrics, profile, trace_headers

__all__ = ["generate", "healthz", "iter_lines", "metrics", "open_stream",
           "profile"]


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
    stream's trace) or ``(code, parsed_error_body)``. A ``str`` prompt
    is sent as ``"text"``, anything else as the token list; ``trace``:
    the ``x-jg-trace`` header the server adopts (``True`` mints one)."""
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
            return e.code, json.loads(raw)
        except ValueError:
            return e.code, {"error": raw.decode("utf-8", "replace")}


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


def healthz(base_url: str, timeout: float = 10.0) -> Tuple[int, bytes]:
    try:
        with urllib.request.urlopen(
            base_url + "/healthz", timeout=timeout
        ) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()
