"""serve — the long-running packed-inference HTTP server.

  core.py      requests with deadlines, the bounded admission queue with
               load shedding, and the micro-batching engine that pads
               every dispatch to the one kernel batch shape
  server.py    the stdlib HTTP front end (/predict, /healthz) and the
               SIGTERM graceful drain
  client.py    a tiny urllib client
  httpbase.py  shared JSON handler plumbing
"""

from .core import AdmissionQueue, Request, ServeEngine
from .server import PackedInferenceServer, ServeConfig

__all__ = [
    "AdmissionQueue",
    "PackedInferenceServer",
    "Request",
    "ServeConfig",
    "ServeEngine",
]
