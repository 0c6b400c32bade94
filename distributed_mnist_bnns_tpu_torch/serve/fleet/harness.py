"""Importable fleet availability-under-chaos probe.

The fleet twin of serve/harness.py's p99 probe (the port's copy of the
JAX package's ``serve/fleet/harness.py``): drive a REAL 3-replica
fleet — three live :class:`~..core.ServeEngine` micro-batchers over the
port's frozen predictor, behind the REAL :class:`~.router.RouterCore`
dispatch policy (in-process transports, no sockets: a gate needs
determinism and a wall clock of seconds, and the policy code is
identical either way) — at
saturation, then KILL one replica mid-probe. The router must absorb it:
transport errors trip that replica's breaker, the prober ejects it,
and every request that failed there retries on a surviving replica
inside its deadline.

The headline number is **availability**: the fraction of client
requests that completed 200 within their deadline, measured across the
whole window INCLUDING the kill; its floor is 0.99, and a trip prints
the per-replica health/breaker transition log this section carries, so
the failure explains itself (which replica flapped, when, why).

Chaos composes the same way as the single-server smoke: the doomed
replica also takes scripted ``infer_slow`` stalls before dying, so the
failover path is exercised against a straggler, not only a corpse.

The window runs with the caller's heap frozen out of the garbage
collector (``gc.freeze``). The in-process fleet shares one interpreter,
and a full collection stops every thread while it walks the whole heap:
in a long-lived test worker under load that walk stopped the replicas,
the router and the clients together for 1.7 s, and requests in flight
outlived their 1.5 s deadlines. Replicas and a router in processes of
their own pause only for their own heaps. The section lists each full
collection's pause in the window (``gc_full_pauses_s``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from ...resilience.policy import CircuitBreaker
from ..core import AdmissionQueue, ServeEngine
from .router import RouterCore

# The engine-side wait slack (mirrors serve/server.py._WAIT_SLACK_S).
_WAIT_SLACK_S = 0.05
# Failed requests the section lists (send time from the window's start,
# latency, status and the router's reply), so a trip names its cause.
_MAX_FAILED_LISTED = 50


class EngineReplicaTransport:
    """The router transport interface over an in-process ServeEngine:
    ``/predict`` and ``/healthz`` with the same status semantics as
    serve/server.py, minus the sockets. ``kill()`` makes every call
    raise — the wire behavior of a dead process."""

    def __init__(self, rid: str, engine: ServeEngine,
                 input_shape=(28, 28, 1)):
        self.rid = rid
        self.engine = engine
        self.input_shape = input_shape
        self.dead = False

    def kill(self) -> None:
        self.dead = True
        self.engine.stop()

    def request(self, method: str, path: str, body: Optional[bytes],
                headers: Dict[str, str], timeout: float):
        if self.dead:
            raise ConnectionError(f"{self.rid} killed")
        if method == "GET" and path == "/healthz":
            status = (
                "failed" if self.engine.fence_error is not None
                else "draining" if self.engine.draining else "ok"
            )
            return 200, json.dumps({
                "status": status,
                "queue_depth": len(self.engine.queue),
                "fence_error": self.engine.fence_error,
            }).encode(), {}
        if method == "POST" and path == "/predict":
            return self._predict(body or b"{}")
        return 404, b'{"error": "no route"}', {}

    def _predict(self, raw: bytes):
        payload = json.loads(raw)
        images = np.asarray(payload["images"], np.float32)
        deadline = time.monotonic() + float(
            payload.get("deadline_ms", 1000.0)
        ) / 1e3
        req = self.engine.submit(images, deadline)
        if isinstance(req, str):
            return 503, json.dumps(
                {"error": "shed", "reason": req}
            ).encode(), {"Retry-After": "0.050"}
        # Chunked wait so a kill() mid-request surfaces as the reset
        # connection a dead process would give the router (which then
        # fails over), not a full client-deadline burn.
        end = deadline + _WAIT_SLACK_S
        while not req.event.wait(0.02):
            if self.dead:
                raise ConnectionError(f"{self.rid} connection reset")
            if time.monotonic() >= end:
                req.finish("deadline", error="deadline exceeded")
                break
        if req.status == "ok":
            lp = req.log_probs
            return 200, json.dumps({
                "argmax": [int(i) for i in lp.argmax(-1)],
            }).encode(), {}
        if req.status == "deadline":
            return 504, b'{"error": "deadline exceeded"}', {}
        if req.status in ("shed", "breaker_open"):
            return 503, json.dumps({
                "error": "shed", "reason": req.status,
            }).encode(), {"Retry-After": "0.050"}
        return 502, json.dumps({
            "error": req.error or "backend failure",
        }).encode(), {}

    def stream(self, path, body, headers, timeout):
        raise NotImplementedError("classifier fleet probe only")


class _CaptureTelemetry:
    """Just enough of the Telemetry facade for the chaos probe: a live
    registry (the router's counters need one) plus an in-memory event
    list — so the SLO monitor's ``slo_alert``s and the control plane's
    ``decision``s land in the returned section instead of a log dir."""

    def __init__(self):
        from ...obs import MetricsRegistry

        self.registry = MetricsRegistry()
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def emit(self, kind: str, **fields: Any) -> None:
        with self._lock:
            self.events.append({"kind": kind, **fields})

    def of_kind(self, kind: str) -> List[Dict[str, Any]]:
        with self._lock:
            return [e for e in self.events if e["kind"] == kind]


@contextlib.contextmanager
def _own_heap(pauses: List[float]):
    """Freeze what the caller's heap holds now, so that the window's full
    collections walk only what the window allocates, and unfreeze it all
    after; append each full collection's pause to ``pauses``."""
    started: List[float] = []

    def timed(phase: str, info: Dict[str, Any]) -> None:
        if info["generation"] != 2:
            return
        if phase == "start":
            started.append(time.monotonic())
        elif started:
            pauses.append(round(time.monotonic() - started.pop(), 3))

    gc.collect()
    gc.freeze()
    gc.callbacks.append(timed)
    try:
        yield
    finally:
        gc.callbacks.remove(timed)
        gc.unfreeze()


def _make_engine(
    predict_fn, *, batch_size: int, chaos: Any = None,
) -> ServeEngine:
    return ServeEngine(
        predict_fn,
        batch_size=batch_size,
        queue=AdmissionQueue(16),
        breaker=CircuitBreaker(
            failure_threshold=1 << 30, reset_timeout_s=3600.0,
        ),
        chaos=chaos,
        stall_timeout_s=3600.0,
        linger_s=0.001,
    ).start()


def fleet_availability_section(
    *,
    replicas: int = 3,
    batch_size: int = 8,
    n_threads: int = 8,
    duration_s: float = 3.0,
    deadline_ms: float = 1500.0,
    kill_after_s: float = 1.0,
    device="cuda",
    seed: int = 0,
    telemetry: Any = None,
) -> Dict[str, Any]:
    """The bench-record section (``fleet_availability``): saturate a
    3-replica fleet through the real router, chaos-stall then KILL one
    replica mid-window, report the end-to-end success fraction plus the
    per-replica transition log a tripped band prints. The replicas'
    predictor runs on ``device``."""
    from ...obs import SLOMonitor, default_fleet_slos
    from ...resilience.chaos import ChaosController, reset_fire_counts
    from ..harness import make_tiny_packed_predictor

    predict_fn, input_shape = make_tiny_packed_predictor(
        batch_size, device=device, seed=seed
    )
    reset_fire_counts()
    capture = telemetry if telemetry is not None else _CaptureTelemetry()
    slo = SLOMonitor(
        default_fleet_slos(
            request_p99_ms=deadline_ms,
            fast_window_s=max(duration_s / 6.0, 0.1),
            slow_window_s=max(duration_s / 2.0, 0.3),
        ),
        registry=getattr(capture, "registry", None),
        emit=capture.emit,
    )
    router = RouterCore(
        telemetry=capture,
        breaker_threshold=2,
        breaker_reset_s=0.5,
        max_attempts=replicas,
        slo=slo,
    )
    transports: List[EngineReplicaTransport] = []
    for i in range(replicas):
        # The doomed replica (0) staggers first: scripted stalls make
        # it a straggler before the kill makes it a corpse.
        chaos = None
        if i == 0:
            chaos = ChaosController.from_config(
                "infer_slow@step=3,times=2,delay_s=0.2",
                seed=seed, telemetry=capture,
            )
        engine = _make_engine(
            predict_fn, batch_size=batch_size, chaos=chaos,
        )
        transport = EngineReplicaTransport(
            f"fleet-r{i}", engine, input_shape
        )
        transports.append(transport)
        router.add_replica(transport.rid, transport)
    router.start_prober(0.05)

    gc_pauses: List[float] = []
    with _own_heap(gc_pauses):
        ok = 0
        total = 0
        outcomes: Dict[str, int] = {}
        failed: List[Dict[str, Any]] = []
        lock = threading.Lock()
        stop_at = time.monotonic() + duration_s

        def hammer(tid: int) -> None:
            nonlocal ok, total
            rng = np.random.RandomState(tid)
            body = json.dumps({
                "images": rng.randn(1, *input_shape).astype(
                    np.float32
                ).tolist(),
                "deadline_ms": deadline_ms,
            }).encode()
            while time.monotonic() < stop_at:
                sent = time.monotonic()
                status, rbody, _ = router.dispatch_predict(
                    body, deadline=sent + deadline_ms / 1e3,
                )
                done = time.monotonic()
                with lock:
                    total += 1
                    outcomes[str(status)] = outcomes.get(str(status), 0) + 1
                    if status == 200:
                        ok += 1
                    elif len(failed) < _MAX_FAILED_LISTED:
                        failed.append({
                            "sent_s": round(sent - t0, 3),
                            "latency_s": round(done - sent, 3),
                            "status": status,
                            "body": rbody[:200].decode("utf-8", "replace"),
                        })

        threads = [
            threading.Thread(target=hammer, args=(i,), daemon=True)
            for i in range(n_threads)
        ]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        time.sleep(min(kill_after_s, duration_s))
        transports[0].kill()
        killed_at = time.monotonic() - t0
        for t in threads:
            t.join(timeout=duration_s + deadline_ms / 1e3 + 30.0)
        wall = time.monotonic() - t0
    router.stop_prober()
    slo.evaluate()      # final pass so a still-open burn is visible
    for transport in transports[1:]:
        transport.engine.begin_drain()
        transport.engine.drain(timeout=5.0)
        transport.engine.stop()
    reset_fire_counts()
    events_of = getattr(capture, "of_kind", lambda kind: [])
    return {
        "replicas": replicas,
        "n_threads": n_threads,
        "duration_s": round(wall, 3),
        "killed_replica": transports[0].rid,
        "killed_at_s": round(killed_at, 3),
        "requests_total": total,
        "requests_ok": ok,
        "availability": round(ok / total, 5) if total else None,
        "outcomes": outcomes,
        "failed_requests": failed,
        "retries_total": int(router.retries_ctr.total()),
        "gc_full_pauses_s": gc_pauses,
        "replica_transitions": {
            r.rid: r.transitions for r in sorted(
                router.replicas() or [], key=lambda r: r.seq
            )
        },
        "slo": slo.summary(),
        "slo_alerts": events_of("slo_alert"),
        "decisions": events_of("decision"),
        "device": str(device),
    }
