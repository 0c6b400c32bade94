"""Replica supervisor: spawn/reap replica processes, autoscale them.

The serving twin of the elastic training supervisor
(resilience/elastic.py): where ``run_elastic`` turns a lost WORKER into
a remesh, this module turns a lost REPLICA into a respawn — and a
sustained load change into a membership change. The same discipline
carries over:

  * a :class:`FleetView` records the target membership (the analogue of
    ``MembershipView``): ``target`` is what the fleet should run,
    bounded by ``[min_replicas, max_replicas]``; every maintenance tick
    converges the live set toward it;
  * replica death is the COMMON case, not an incident: a dead process
    is reaped, removed from the router, and respawned with jittered
    backoff (:class:`~...resilience.policy.RetryPolicy`) so a
    crash-looping artifact cannot hot-loop the host. A replica counts
    as live once its ``/healthz`` answers ``ok`` (its start, the
    artifact's load and the kernels' warm-up take process time, bounded
    by ``boot_timeout_s``);
  * the :class:`Autoscaler` converts sustained queue depth and shed
    rate into target changes: scale up when replicas stay saturated
    (mean queue depth past the high watermark, or the router observing
    replica sheds), scale down when the fleet stays idle. Both
    directions demand the signal hold for ``sustain_s`` (a burst is the
    micro-batcher's job, not the autoscaler's) and respect a cooldown
    between changes so the controller cannot flap. Decisions are
    pure-function-testable with injected clocks.

Scale-down retires the NEWEST live replica (LIFO): it is removed from
the router first (no new dispatches), then SIGTERM'd — its graceful
drain (serve/server.py) flushes whatever it already admitted, so a
scale-down never drops a request. See SERVING.md "Fleet".
"""

from __future__ import annotations

import http.client
import logging
import signal
import socket
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from ...resilience.policy import RetryPolicy
from .router import HttpTransport, RouterCore

log = logging.getLogger(__name__)

AUTOSCALE_TOTAL = "fleet_autoscale_total"
RESPAWNS_TOTAL = "fleet_respawns_total"


def free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port that was free a moment ago (bind/release —
    the small race is acceptable for replica spawning: a collision
    fails the boot gate and the respawn path picks a new one)."""
    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclass
class FleetView:
    """The supervisor's view of fleet membership (the serving analogue
    of ``resilience.elastic.MembershipView``): ``target`` is the
    replica count the maintenance loop converges toward, clamped to
    ``[min_replicas, max_replicas]``."""

    min_replicas: int
    max_replicas: int
    target: int

    def clamp(self, n: int) -> int:
        return max(self.min_replicas, min(self.max_replicas, n))


class Autoscaler:
    """Sustained-signal scale decisions, clock-injectable for tests.

    ``observe`` is called once per maintenance tick with the current
    pressure signals and returns a NEW target count or None. Scale-up
    needs ``queue_depth >= queue_high`` OR ``shed_rate > 0`` sustained
    for ``sustain_s``; scale-down needs ``queue_depth <= queue_low``
    AND zero sheds sustained. ``cooldown_s`` separates consecutive
    changes in either direction.
    """

    def __init__(
        self,
        *,
        queue_high: float = 4.0,
        queue_low: float = 0.5,
        sustain_s: float = 1.0,
        cooldown_s: float = 3.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.sustain_s = float(sustain_s)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._over_since: Optional[float] = None
        self._under_since: Optional[float] = None
        self._last_change = -float("inf")
        #: The audit record of the most recent ``observe`` call: the
        #: inputs, thresholds and cooldown/sustain state that drove the
        #: outcome. A cooldown hold used to be an invisible ``None`` —
        #: the decision event the supervisor emits is built from this.
        self.last_decision: Optional[Dict[str, Any]] = None

    def observe(
        self,
        view: FleetView,
        *,
        queue_depth: float,
        shed_rate: float,
        now: Optional[float] = None,
    ) -> Optional[int]:
        """New target or None. ``queue_depth`` is the mean replica
        admission-queue depth from the last health probes; ``shed_rate``
        is replica 503s/s observed by the router since the last tick."""
        now = self._clock() if now is None else now
        overloaded = queue_depth >= self.queue_high or shed_rate > 0
        idle = queue_depth <= self.queue_low and shed_rate == 0
        self._over_since = (
            (self._over_since if self._over_since is not None else now)
            if overloaded else None
        )
        self._under_since = (
            (self._under_since if self._under_since is not None else now)
            if idle else None
        )
        cooldown_remaining = max(
            0.0, self.cooldown_s - (now - self._last_change)
        )
        decision: Dict[str, Any] = {
            "queue_depth": round(queue_depth, 3),
            "shed_rate": round(shed_rate, 3),
            "queue_high": self.queue_high,
            "queue_low": self.queue_low,
            "sustain_s": self.sustain_s,
            "cooldown_s": self.cooldown_s,
            "cooldown_remaining_s": round(cooldown_remaining, 3),
            "over_for_s": (round(now - self._over_since, 3)
                           if self._over_since is not None else None),
            "under_for_s": (round(now - self._under_since, 3)
                            if self._under_since is not None else None),
            "target": view.target,
            "min_replicas": view.min_replicas,
            "max_replicas": view.max_replicas,
        }
        self.last_decision = decision
        if cooldown_remaining > 0:
            decision["action"] = "hold"
            decision["reason"] = (
                "cooldown" if (overloaded or idle) else "steady"
            )
            return None
        if (
            self._over_since is not None
            and now - self._over_since >= self.sustain_s
        ):
            if view.target < view.max_replicas:
                self._last_change = now
                self._over_since = None
                decision["action"] = "scale_up"
                decision["reason"] = (
                    "queue_high" if queue_depth >= self.queue_high
                    else "sheds"
                )
                return view.target + 1
            decision["action"] = "hold"
            decision["reason"] = "at_max"
            return None
        if (
            self._under_since is not None
            and now - self._under_since >= self.sustain_s
        ):
            if view.target > view.min_replicas:
                self._last_change = now
                self._under_since = None
                decision["action"] = "scale_down"
                decision["reason"] = "idle"
                return view.target - 1
            decision["action"] = "hold"
            decision["reason"] = "at_min"
            return None
        decision["action"] = "hold"
        decision["reason"] = (
            "sustaining" if (overloaded or idle) else "steady"
        )
        return None


class ReplicaMember:
    """One supervised replica process."""

    def __init__(self, rid: str, seq: int, proc: subprocess.Popen,
                 port: int, url: str, boot_deadline: float):
        self.rid = rid
        self.seq = seq                  # spawn order (LIFO retirement)
        self.proc = proc
        self.port = port
        self.url = url
        self.boot_deadline = boot_deadline
        self.state = "booting"          # booting | live | retiring


class ReplicaSupervisor:
    """Owns the replica processes behind a :class:`~.router.RouterCore`.

    ``spawn_command(rid, port, artifact)`` builds the replica's argv —
    the fleet server passes the real ``cli serve`` invocation; tests
    pass a stub server. The supervisor converges the live set toward
    ``view.target`` on every :meth:`tick` (reap → boot-gate → scale),
    which the maintenance thread runs at ``tick_interval_s``.
    """

    def __init__(
        self,
        router: RouterCore,
        spawn_command: Callable[[str, int, str], List[str]],
        *,
        artifact: str,
        view: FleetView,
        telemetry: Any = None,
        host: str = "127.0.0.1",
        boot_timeout_s: float = 120.0,
        tick_interval_s: float = 0.25,
        autoscaler: Optional[Autoscaler] = None,
        respawn_policy: Optional[RetryPolicy] = None,
        env: Optional[Dict[str, str]] = None,
        launcher: Any = None,
    ):
        self.router = router
        self.spawn_command = spawn_command
        self.artifact = artifact       # respawns/rollouts read this live
        #: Optional :class:`~.remote.RemoteLauncher`-shaped placer
        #: (``free_port``/``launch``/``ensure_artifact``/``host``): the
        #: fleet's replicas run on ITS host, artifacts shipped by
        #: digest over utils/transfer. None = local subprocesses.
        self.launcher = launcher
        self.view = view
        self.telemetry = telemetry
        self.host = host
        self.boot_timeout_s = float(boot_timeout_s)
        self.tick_interval_s = float(tick_interval_s)
        self.autoscaler = autoscaler
        self.respawn_policy = respawn_policy or RetryPolicy(
            max_restarts=1 << 30, base_backoff_s=0.2, max_backoff_s=5.0,
        )
        self.env = env
        self._members: Dict[str, ReplicaMember] = {}
        self._lock = threading.Lock()
        self._spawn_seq = 0
        self._next_spawn_at = 0.0      # respawn backoff gate
        self._consecutive_respawns = 0  # resets on a successful boot
        self._last_shed_total = 0.0
        self._last_signal_t = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.draining = False
        self._last_hold_key: Optional[tuple] = None
        reg = telemetry.registry if telemetry is not None else None
        if reg is None:
            from ...obs import default_registry

            reg = default_registry()
        self.autoscale_ctr = reg.counter(
            AUTOSCALE_TOTAL, "autoscale decisions by direction"
        )
        self.respawn_ctr = reg.counter(
            RESPAWNS_TOTAL, "replica respawns after unexpected exits"
        )

    # -- membership ----------------------------------------------------------

    def members(self) -> List[ReplicaMember]:
        with self._lock:
            return list(self._members.values())

    def live_count(self) -> int:
        return sum(1 for m in self.members() if m.state == "live")

    def _emit(self, kind: str, **fields: Any) -> None:
        if self.telemetry is not None:
            self.telemetry.emit(kind, **fields)

    def _decision(self, action: str, **fields: Any) -> None:
        """Control-plane decision audit record (OBSERVABILITY.md):
        every scale/hold/respawn/retire lands in the event log with the
        inputs that drove it, so ``cli fleet explain`` can replay why
        the fleet did what it did."""
        self._emit("decision", actor="supervisor", action=action,
                   **fields)

    def spawn_replica(self) -> ReplicaMember:
        """Launch one replica process; it joins the router only after
        its /healthz boot gate passes (``tick``). With a ``launcher``
        the process runs on the launcher's host — the spawn command is
        built against the remotely staged artifact (shipped by digest,
        zero-copy on respawn), and everything downstream (boot gate,
        probes, breakers, reap/retire signals) drives the returned
        Popen-shaped handle exactly as it would a local child."""
        with self._lock:
            self._spawn_seq += 1
            seq = self._spawn_seq
            rid = f"replica-{seq}"
        if self.launcher is not None:
            host = self.launcher.host
            port = self.launcher.free_port()
            artifact = self.launcher.ensure_artifact(self.artifact)
            proc = self.launcher.launch(
                self.spawn_command(rid, port, artifact),
                env=self.env,
            )
        else:
            host = self.host
            port = free_port(self.host)
            cmd = self.spawn_command(rid, port, self.artifact)
            proc = subprocess.Popen(cmd, env=self.env)
        member = ReplicaMember(
            rid, seq, proc, port, f"http://{host}:{port}",
            boot_deadline=time.monotonic() + self.boot_timeout_s,
        )
        with self._lock:
            self._members[rid] = member
        self._emit(
            "replica_spawn", replica=rid, port=port, pid=proc.pid,
            artifact=self.artifact,
        )
        log.info("supervisor: spawned %s (pid %d, port %d)",
                 rid, proc.pid, port)
        return member

    def _retire(self, member: ReplicaMember) -> None:
        """Graceful scale-down: unroute first, then SIGTERM — the
        replica's own drain flushes admitted work, so a scale-down
        never drops a request."""
        member.state = "retiring"
        self.router.remove_replica(member.rid)
        try:
            member.proc.send_signal(signal.SIGTERM)
        except OSError:
            pass
        self._emit("replica_exit", replica=member.rid, cause="retired",
                   pid=member.proc.pid)
        self._decision(
            "retire", replica=member.rid,
            inputs={"seq": member.seq, "target": self.view.target},
        )
        log.info("supervisor: retiring %s (scale-down)", member.rid)

    # -- boot gate -----------------------------------------------------------

    def _probe_boot(self, member: ReplicaMember) -> bool:
        """One /healthz poll of a booting replica; True when it is
        ready to route."""
        transport = HttpTransport(member.url)
        try:
            status, body, _ = transport.request(
                "GET", "/healthz", None, {}, 2.0
            )
        except (OSError, http.client.HTTPException):
            return False
        if status != 200:
            return False
        import json as _json

        try:
            health = _json.loads(body)
        except ValueError:
            return False
        return health.get("status") == "ok"

    # -- maintenance ---------------------------------------------------------

    def tick(self) -> None:
        """One maintenance pass: reap dead replicas (respawn with
        backoff), promote booted ones into the router, converge the
        live count toward ``view.target``, and consult the autoscaler."""
        now = time.monotonic()
        for member in self.members():
            rc = member.proc.poll()
            if rc is not None:
                self._reap(member, rc, now)
                continue
            if member.state == "booting":
                if self._probe_boot(member):
                    member.state = "live"
                    self._consecutive_respawns = 0
                    self.router.add_replica(
                        member.rid, HttpTransport(member.url),
                        url=member.url,
                        meta={"pid": member.proc.pid,
                              "port": member.port},
                    )
                    log.info("supervisor: %s live", member.rid)
                elif now >= member.boot_deadline:
                    log.error(
                        "supervisor: %s never became healthy within "
                        "%.0fs; killing", member.rid, self.boot_timeout_s,
                    )
                    try:
                        member.proc.kill()
                    except OSError:
                        pass
        if self.draining:
            return
        self._converge(now)
        if self.autoscaler is not None:
            self._autoscale(now)

    def _reap(self, member: ReplicaMember, rc: int, now: float) -> None:
        with self._lock:
            self._members.pop(member.rid, None)
        self.router.remove_replica(member.rid)
        if member.state == "retiring" or self.draining:
            log.info("supervisor: %s exited %d (retired)",
                     member.rid, rc)
            return
        self.respawn_ctr.inc()
        self._consecutive_respawns += 1
        delay = self.respawn_policy.backoff(self._consecutive_respawns)
        self._next_spawn_at = max(self._next_spawn_at, now + delay)
        self._emit(
            "replica_exit", replica=member.rid, cause="died", rc=rc,
            pid=member.proc.pid, respawn_backoff_s=round(delay, 3),
        )
        self._decision(
            "respawn", replica=member.rid,
            inputs={
                "rc": rc,
                "pid": member.proc.pid,
                "backoff_s": round(delay, 3),
                "consecutive_respawns": self._consecutive_respawns,
                "target": self.view.target,
            },
        )
        log.warning(
            "supervisor: %s died (rc %s) — respawning after %.2fs",
            member.rid, rc, delay,
        )

    def _converge(self, now: float) -> None:
        members = self.members()
        alive = [m for m in members if m.state != "retiring"]
        if len(alive) < self.view.target and now >= self._next_spawn_at:
            self.spawn_replica()
        elif len(alive) > self.view.target:
            live = [m for m in alive if m.state == "live"]
            if live:
                self._retire(max(live, key=lambda m: m.seq))

    def _signals(self, now: float) -> Dict[str, float]:
        """The autoscaler's inputs: mean replica queue depth from the
        router's last health probes + replica sheds/s observed by the
        router since the previous tick."""
        depths = [
            float(r.health.get("queue_depth") or 0)
            for r in self.router.replicas() if r.healthy
        ]
        queue_depth = sum(depths) / len(depths) if depths else 0.0
        shed_total = float(self.router.sheds_ctr.total())
        dt = max(now - self._last_signal_t, 1e-6)
        shed_rate = max(shed_total - self._last_shed_total, 0.0) / dt
        self._last_shed_total = shed_total
        self._last_signal_t = now
        return {"queue_depth": queue_depth, "shed_rate": shed_rate}

    def _autoscale(self, now: float) -> None:
        signals = self._signals(now)
        new_target = self.autoscaler.observe(
            self.view, queue_depth=signals["queue_depth"],
            shed_rate=signals["shed_rate"], now=now,
        )
        inputs = dict(getattr(self.autoscaler, "last_decision", None)
                      or {})
        if new_target is None:
            # A hold is a decision too — but only the pressure-driven
            # ones are worth auditing (cooldown suppressing a wanted
            # change, sustain still accumulating, bounds clamping), and
            # only on transition, not every 250 ms tick.
            reason = inputs.get("reason")
            key = (inputs.get("action"), reason)
            if reason in (None, "steady"):
                self._last_hold_key = None
            elif key != self._last_hold_key:
                self._last_hold_key = key
                self._decision("hold", inputs=inputs)
            return
        new_target = self.view.clamp(new_target)
        if new_target == self.view.target:
            return
        direction = "up" if new_target > self.view.target else "down"
        self._last_hold_key = None
        self.autoscale_ctr.inc(direction=direction)
        self._emit(
            "autoscale", direction=direction,
            target_from=self.view.target, target_to=new_target,
            queue_depth=round(signals["queue_depth"], 3),
            shed_rate=round(signals["shed_rate"], 3),
        )
        self._decision(
            f"scale_{direction}",
            inputs={**inputs, "target_to": new_target},
        )
        log.warning(
            "autoscale %s: target %d -> %d (queue_depth %.2f, "
            "shed_rate %.2f/s)", direction, self.view.target,
            new_target, signals["queue_depth"], signals["shed_rate"],
        )
        self.view.target = new_target

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ReplicaSupervisor":
        """Spawn the initial fleet and start the maintenance thread."""
        for _ in range(self.view.target):
            self.spawn_replica()

        def run() -> None:
            while not self._stop.wait(self.tick_interval_s):
                try:
                    self.tick()
                except Exception:
                    # The maintenance loop must outlive any one bad
                    # tick — a dead supervisor is an unsupervised fleet.
                    log.exception("supervisor tick failed; continuing")

        self._thread = threading.Thread(
            target=run, name="fleet-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def wait_live(self, n: Optional[int] = None,
                  timeout: float = 180.0) -> bool:
        """Block until ``n`` (default: the target) replicas are live."""
        want = self.view.target if n is None else n
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.live_count() >= want:
                return True
            time.sleep(0.05)
        return False

    def drain_all(self, timeout: float = 60.0) -> Dict[str, Optional[int]]:
        """SIGTERM every replica and wait for graceful exits; returns
        {rid: returncode}. Stops the maintenance thread first so
        nothing respawns what we are stopping."""
        self.draining = True
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        rcs: Dict[str, Optional[int]] = {}
        for member in self.members():
            self.router.remove_replica(member.rid)
            if member.proc.poll() is None:
                try:
                    member.proc.send_signal(signal.SIGTERM)
                except OSError:
                    pass
        deadline = time.monotonic() + timeout
        for member in self.members():
            budget = max(deadline - time.monotonic(), 0.1)
            try:
                rcs[member.rid] = member.proc.wait(timeout=budget)
            except subprocess.TimeoutExpired:
                member.proc.kill()
                rcs[member.rid] = member.proc.wait()
                log.error(
                    "supervisor: %s did not drain in time; killed",
                    member.rid,
                )
        return rcs
