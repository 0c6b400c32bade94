"""serve.fleet — multi-replica serving: router, supervisor, rollouts.

The port's copy of the JAX package's ``serve/fleet/``: the layer between
one hardened server and real traffic (Dean & Barroso's Tail at Scale
argues tail tolerance must live HERE, not in any single replica). The
replicas are the port's own ``cli serve`` processes (on the card unless
told otherwise); the wire formats, event and decision records and gate
bands are the JAX package's.

  router.py      deadline-aware least-loaded dispatch over N replicas,
                 per-replica health probing + circuit breakers,
                 retry-on-another-replica inside the client deadline,
                 x-jg-trace forwarded unchanged, prefix-affinity
                 routing for LM fleets (rendezvous hash of the first
                 page-size prompt block)
  supervisor.py  replica subprocesses spawned and probed until healthy,
                 reap + respawn with jittered backoff, autoscaling
                 between min/max off sustained queue depth + shed rate
  rollout.py     rolling deploys: artifact shipped over utils/transfer
                 (digest-verified), canary reload with health + error-
                 rate gates, automatic fleet-wide rollback on a trip
  remote.py      replicas on another machine: a JSON-line HostAgent on
                 the replica host (spawn/poll/signal + artifact staging
                 by digest over utils/transfer) and a RemoteLauncher
                 whose Popen-shaped handles plug into the same
                 supervisor — probes/breakers/respawn unchanged
  server.py      the `cli fleet` HTTP front end + SIGTERM drain
  harness.py     importable 3-replica availability-under-chaos probe

None of these modules imports torch itself: the replicas do the
inference, and the fleet process is control plane (``harness.py``
builds in-process engines, and imports the predictor only when
called). See SERVING.md "Fleet" and OBSERVABILITY.md for the
fleet_dispatch / replica_health / autoscale / rollout event schema.
"""

from .remote import HostAgent, RemoteLauncher, RemoteProcess
from .router import (
    HttpTransport,
    Replica,
    RouterCore,
    affinity_key,
)
from .rollout import RolloutManager, stage_artifact
from .server import FleetConfig, FleetServer
from .supervisor import (
    Autoscaler,
    FleetView,
    ReplicaSupervisor,
)

__all__ = [
    "Autoscaler",
    "FleetConfig",
    "FleetServer",
    "FleetView",
    "HostAgent",
    "HttpTransport",
    "RemoteLauncher",
    "RemoteProcess",
    "Replica",
    "ReplicaSupervisor",
    "RolloutManager",
    "RouterCore",
    "affinity_key",
    "stage_artifact",
]
