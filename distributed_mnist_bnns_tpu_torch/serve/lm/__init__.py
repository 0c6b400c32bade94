"""serve.lm — continuous-batching LM serving over a paged KV cache.

  engine.py   iteration-level scheduler: admission, deadlines, paged
              allocation at admission, chunked prefill, decode rounds,
              eviction that frees pages, host-side sampling
  server.py   the streaming HTTP front end (POST /generate as ndjson,
              GET /healthz, GET /metrics, POST /admin/profile), its
              telemetry and the SIGTERM drain
  client.py   a stdlib streaming client (with the x-jg-trace header)
"""

from .engine import LMEngine, LMRequest
from .server import LMServeConfig, LMServer

__all__ = ["LMEngine", "LMRequest", "LMServeConfig", "LMServer"]
