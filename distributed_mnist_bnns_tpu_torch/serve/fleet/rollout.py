"""Rolling deploys: ship → canary → health-gated promote → rollback.

A new artifact reaches a running fleet in three stages, none of which
stops traffic (the replica's ``/admin/reload`` loads + warms the new
weights OFF the serving path and swaps atomically — serve/server.py —
so a mid-rollout fleet serves every request from either the old or the
new artifact, never neither):

  1. **ship** — :func:`stage_artifact` moves the artifact bytes into
     the fleet's staging directory over ``utils/transfer`` (the
     length-prefixed, sha256-verify-before-rename protocol): a
     truncated or bit-flipped ship is rejected at the wire, never
     handed to a replica. Each rollout stages into its own numbered
     subdirectory so the previous artifact stays on disk for rollback.
  2. **canary** — ONE replica reloads first and must pass the gate:
     the reload call itself succeeded, ``/healthz`` reports ``ok``
     again within the budget, and a burst of live probe requests
     through the replica keeps its error rate under the trip
     threshold. A bad artifact — unloadable, fence-tripping, or
     serving garbage — stops here, with one replica briefly degraded
     and instantly rolled back.
  3. **promote / rollback** — the remaining replicas reload one at a
     time behind the same gate. ANY trip rolls the WHOLE fleet back to
     the previous artifact (the replicas already promoted reload the
     old path — the same off-path swap, so rollback drops nothing
     either), and the supervisor keeps respawning from the old
     artifact. On full promotion the supervisor's spawn artifact
     advances, so autoscale-ups and respawns boot the new weights.

Every stage lands as a ``rollout`` event (``phase`` =
start/ship/canary_ok/promoted/trip/rolled_back/complete) — the state
machine is replayable from the event log alone. See SERVING.md
"Fleet".
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .router import Replica, RouterCore
from .supervisor import ReplicaSupervisor, free_port

log = logging.getLogger(__name__)

ROLLOUTS_TOTAL = "fleet_rollouts_total"


def stage_artifact(
    src: str,
    staging_dir: str,
    *,
    host: str = "127.0.0.1",
    timeout: float = 60.0,
) -> str:
    """Ship ``src`` into ``staging_dir`` over the digest-verified
    ``utils/transfer`` protocol (loopback here; the same call with a
    remote receiver ships across machines). Returns the staged path.
    The sha256 is verified before the atomic rename AND echoed in the
    ack — corruption fails the ship on both sides."""
    from ...utils.transfer import receive_file, send_file

    port = free_port(host)
    result: Dict[str, Any] = {}

    def recv() -> None:
        try:
            result["path"], result["bytes"] = receive_file(
                staging_dir, port, host=host, timeout=timeout
            )
        except BaseException as e:  # surfaced to the sender side below
            result["error"] = e

    thread = threading.Thread(target=recv, name="rollout-recv",
                              daemon=True)
    thread.start()
    send_file(src, host, port, timeout=timeout)
    thread.join(timeout=timeout)
    if "path" not in result:
        err = result.get("error")
        raise IOError(
            f"artifact ship into {staging_dir} did not complete"
            + (f": {type(err).__name__}: {err}" if err else "")
        )
    return str(result["path"])


class RolloutTrip(RuntimeError):
    """Internal signal: a gate failed; carries the reason."""


class RolloutManager:
    """Drives the rolling-reload state machine over a router's live
    replicas. ``probe_body`` is a valid ``/predict`` JSON body (the
    fleet server builds one from its configured input shape); tests
    may replace :attr:`probe_fn` wholesale."""

    def __init__(
        self,
        router: RouterCore,
        *,
        artifact: str,
        supervisor: Optional[ReplicaSupervisor] = None,
        telemetry: Any = None,
        staging_dir: Optional[str] = None,
        probe_body: Optional[bytes] = None,
        probe_n: int = 8,
        error_rate_limit: float = 0.34,
        reload_timeout_s: float = 120.0,
        health_timeout_s: float = 15.0,
    ):
        self.router = router
        self.supervisor = supervisor
        self.telemetry = telemetry
        self.current_artifact = artifact
        self.staging_dir = staging_dir
        self.probe_body = probe_body
        self.probe_n = int(probe_n)
        self.error_rate_limit = float(error_rate_limit)
        self.reload_timeout_s = float(reload_timeout_s)
        self.health_timeout_s = float(health_timeout_s)
        self.probe_fn: Callable[[Replica], Tuple[int, str]] = (
            self._default_probe
        )
        self._lock = threading.Lock()   # one rollout at a time
        self._roll_seq = 0
        reg = telemetry.registry if telemetry is not None else None
        if reg is None:
            from ...obs import default_registry

            reg = default_registry()
        self.rollouts_ctr = reg.counter(
            ROLLOUTS_TOTAL, "rolling deploys by outcome"
        )

    def _emit(self, phase: str, **fields: Any) -> None:
        if self.telemetry is not None:
            self.telemetry.emit("rollout", phase=phase, **fields)

    def _decision(self, action: str, **fields: Any) -> None:
        """Control-plane decision audit record (OBSERVABILITY.md): gate
        verdicts and rollbacks carry the thresholds and observations
        that produced them, for ``cli fleet explain``."""
        if self.telemetry is not None:
            self.telemetry.emit("decision", actor="rollout",
                                action=action, **fields)

    # -- gates ---------------------------------------------------------------

    def _default_probe(self, replica: Replica) -> Tuple[int, str]:
        """One live probe request straight at the replica; returns
        ``(errors, detail)`` for a single attempt (0 or 1 errors).
        Replica sheds (503) are overload, not artifact badness — they
        count as neutral and are retried by the caller's loop."""
        if self.probe_body is None:
            return 0, "no probe body configured"
        try:
            status, body, _ = replica.transport.request(
                "POST", "/predict", self.probe_body, {}, 10.0
            )
        except (OSError, ConnectionError,
                http.client.HTTPException) as e:
            return 1, f"transport: {type(e).__name__}"
        if status == 200:
            return 0, "ok"
        if status == 503:
            return 0, "shed"
        return 1, f"http_{status}"

    def _reload_one(self, replica: Replica, artifact: str) -> Tuple[
        bool, str
    ]:
        body = json.dumps({"artifact": artifact}).encode()
        try:
            status, rbody, _ = replica.transport.request(
                "POST", "/admin/reload", body, {},
                self.reload_timeout_s,
            )
        except (OSError, ConnectionError,
                http.client.HTTPException) as e:
            return False, f"reload transport: {type(e).__name__}: {e}"
        if status != 200:
            return False, (
                f"reload http_{status}: "
                f"{rbody[:200].decode('utf-8', 'replace')}"
            )
        return True, "reloaded"

    def _gate(self, replica: Replica, artifact: str) -> Dict[str, Any]:
        """Reload ``replica`` to ``artifact`` and hold it to the
        promotion gate; raises :class:`RolloutTrip` on any failure.
        Returns the gate observations (probe counts / error rate) for
        the decision audit record."""
        ok, detail = self._reload_one(replica, artifact)
        if not ok:
            raise RolloutTrip(detail)
        # health gate: /healthz must come back ok (a fence trip or a
        # failed engine after the swap shows up here)
        deadline = time.monotonic() + self.health_timeout_s
        healthy = False
        while time.monotonic() < deadline:
            try:
                status, body, _ = replica.transport.request(
                    "GET", "/healthz", None, {}, 5.0
                )
                health = json.loads(body)
            except (OSError, ValueError,
                    http.client.HTTPException):
                time.sleep(0.05)
                continue
            if status == 200 and health.get("status") == "ok" \
                    and not health.get("fence_error"):
                healthy = True
                break
            time.sleep(0.05)
        if not healthy:
            raise RolloutTrip("post-reload health gate timed out")
        # error-rate gate: live probes through the new weights. Sheds
        # (503) are overload, not artifact badness — they are RETRIED,
        # not counted as success: the gate must observe probe_n real
        # outcomes, or refuse to promote at all (a canary that sheds
        # every probe under saturation has proven nothing about the
        # new artifact).
        errors = 0
        samples = 0
        details: List[str] = []
        for _ in range(self.probe_n * 5):
            if samples >= self.probe_n:
                break
            e, detail = self.probe_fn(replica)
            if detail == "shed":
                time.sleep(0.05)
                continue
            samples += 1
            errors += e
            if e:
                details.append(detail)
        if samples == 0:
            raise RolloutTrip(
                "canary gate got no probe through (every attempt "
                "shed) — cannot validate the new artifact"
            )
        rate = errors / samples
        if rate > self.error_rate_limit:
            raise RolloutTrip(
                f"canary error rate {rate:.2f} > "
                f"{self.error_rate_limit:.2f} over {samples} probe(s) "
                f"({details[:3]})"
            )
        return {
            "probes": samples,
            "probe_errors": errors,
            "error_rate": round(rate, 4),
            "error_rate_limit": self.error_rate_limit,
        }

    # -- the state machine ---------------------------------------------------

    def rolling_reload(
        self, artifact: str, *, ship: Optional[bool] = None
    ) -> Dict[str, Any]:
        """Roll ``artifact`` across every healthy replica, one at a
        time, canary first. Returns the outcome dict; ``status`` is
        ``promoted`` or ``rolled_back`` (with the tripped replica and
        reason). ``ship`` stages the artifact through utils/transfer
        first (default: when a staging dir is configured)."""
        with self._lock:
            return self._rolling_reload_locked(artifact, ship)

    def _rolling_reload_locked(
        self, artifact: str, ship: Optional[bool]
    ) -> Dict[str, Any]:
        prev = self.current_artifact
        if ship is None:
            ship = self.staging_dir is not None
        if ship:
            if self.staging_dir is None:
                raise ValueError("ship=True needs a staging_dir")
            self._roll_seq += 1
            dest = os.path.join(
                self.staging_dir, f"roll-{self._roll_seq:04d}"
            )
            staged = stage_artifact(artifact, dest)
            self._emit("ship", src=artifact, staged=staged)
            artifact = staged
        replicas = sorted(
            (r for r in self.router.replicas() if r.healthy),
            key=lambda r: r.seq,
        )
        if not replicas:
            raise RuntimeError("no healthy replica to roll out to")
        self._emit(
            "start", artifact=artifact, previous=prev,
            replicas=[r.rid for r in replicas],
        )
        promoted: List[Replica] = []
        for i, replica in enumerate(replicas):
            try:
                gate = self._gate(replica, artifact)
            except RolloutTrip as trip:
                self._emit(
                    "trip", replica=replica.rid, reason=str(trip),
                    canary=(i == 0),
                )
                self._decision(
                    "gate_trip", replica=replica.rid,
                    inputs={
                        "reason": str(trip),
                        "canary": i == 0,
                        "artifact": artifact,
                        "error_rate_limit": self.error_rate_limit,
                        "probe_n": self.probe_n,
                    },
                )
                log.error(
                    "rollout of %s tripped at %s (%s) — rolling the "
                    "fleet back to %s", artifact, replica.rid, trip,
                    prev,
                )
                rolled: List[str] = []
                for rb in (*promoted, replica):
                    ok, detail = self._reload_one(rb, prev)
                    if ok:
                        rolled.append(rb.rid)
                    else:
                        # best-effort: an unreachable replica respawns
                        # from the supervisor's (old) artifact anyway
                        log.error(
                            "rollback reload of %s failed: %s",
                            rb.rid, detail,
                        )
                self.rollouts_ctr.inc(outcome="rolled_back")
                self._emit(
                    "rolled_back", artifact=prev,
                    tripped=replica.rid, reason=str(trip),
                    rolled=rolled,
                )
                self._decision(
                    "rollback",
                    inputs={
                        "tripped": replica.rid,
                        "reason": str(trip),
                        "rolled": rolled,
                        "artifact": prev,
                    },
                )
                return {
                    "status": "rolled_back",
                    "tripped": replica.rid,
                    "reason": str(trip),
                    "rolled": rolled,
                    "artifact": prev,
                }
            promoted.append(replica)
            self._emit(
                "canary_ok" if i == 0 else "promoted",
                replica=replica.rid, artifact=artifact,
            )
            self._decision(
                "gate_pass", replica=replica.rid,
                inputs={"canary": i == 0, "artifact": artifact, **gate},
            )
        self.current_artifact = artifact
        if self.supervisor is not None:
            # future respawns / scale-ups boot the promoted artifact
            self.supervisor.artifact = artifact
        self.rollouts_ctr.inc(outcome="promoted")
        self._emit(
            "complete", artifact=artifact,
            replicas=[r.rid for r in promoted],
        )
        log.info(
            "rollout complete: %d replica(s) on %s",
            len(promoted), artifact,
        )
        return {
            "status": "promoted",
            "artifact": artifact,
            "replicas": [r.rid for r in promoted],
        }
