"""Minimal stdlib client for the streaming LM server.

Counterpart of the JAX package's ``serve/lm/client.py`` without its trace
header and retrying wrapper. ``http.client`` decodes chunked transfer
encoding, so iterating the response yields one JSON object per emitted
token as it arrives.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from typing import Any, Dict, Iterator, List, Optional, Tuple


def open_stream(
    base_url: str, prompt: Any, *,
    max_new_tokens: Optional[int] = None,
    deadline_ms: Optional[float] = None,
    temperature: Optional[float] = None,
    seed: Optional[int] = None,
    timeout: float = 60.0,
) -> Tuple[int, Any]:
    """Start a generation. Returns ``(200, response)`` (read the stream
    with :func:`iter_lines`) or ``(code, parsed_error_body)``. A ``str``
    prompt is sent as ``"text"``, anything else as the token list."""
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
        headers={"Content-Type": "application/json"},
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
