"""Fleet router: deadline-aware least-loaded dispatch over N replicas.

The Tail-at-Scale argument (Dean & Barroso) is that tail tolerance must
come from the FLEET layer — no single replica, however hardened, can
hide its own stall. This module is that layer for the serving tier:

  * **health-aware membership** — a prober polls every replica's
    ``/healthz``; a replica reporting ``failed`` (recompile fence
    tripped — ``fence_error``), ``draining``, or not answering at all
    is ejected from dispatch until a later probe readmits it. Every
    transition lands as a ``replica_health`` event.
  * **per-replica circuit breaker** — transport errors and 5xx
    responses feed a :class:`~...resilience.policy.CircuitBreaker` per
    replica, so a replica that answers probes but fails requests is
    ejected too (and re-enters through the breaker's half-open probe).
  * **deadline-aware dispatch** — a request whose deadline has already
    passed fails fast with NO dispatch; the per-attempt transport
    timeout is the request's remaining budget, never a fixed number.
  * **retry-on-another-replica** — idempotent requests (classifier
    ``/predict``) that fail on one replica retry on a different one
    while the client's deadline allows; replica sheds (503) also fail
    over, because another replica's queue may have room. LM
    ``/generate`` only fails over BEFORE its stream opens (a 503 shed
    or a refused connect proves no tokens were produced); once tokens
    flow the generation is non-idempotent and is never retried.
  * **prefix-affinity routing** — LM requests hash the FIRST page-size
    block of the prompt and rendezvous-hash it over the live replicas,
    so requests sharing a prompt prefix (system prompts) land on the
    replica whose prefix cache is warm (SERVING.md "Prefix caching").
    Rendezvous hashing keeps the mapping stable under membership
    churn: a replica joining or leaving only remaps the keys it owns.
  * **one trace per hop chain** — an incoming ``x-jg-trace`` header is
    forwarded UNCHANGED, so the client's span tree, the router's
    ``fleet.request``/``fleet.dispatch`` spans and the replica's
    ``serve.request`` tree all join on one trace id; an untraced client
    gets a router-minted context forwarded downstream instead.

Transport is pluggable: :class:`HttpTransport` speaks to real replica
processes; tests and the availability harness plug in-process
callables, so the dispatch policy is unit-testable with fake clocks
and no sockets. See SERVING.md "Fleet".
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import threading
import time
import urllib.parse
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ...obs.aggregate import FleetMetricsStore
from ...obs.trace import (
    NULL_TRACER,
    TRACE_HEADER,
    TraceContext,
    format_header,
)
from ...resilience.policy import CircuitBreaker
from ..core import DEFAULT_TIER

log = logging.getLogger(__name__)

FLEET_REQUESTS_TOTAL = "fleet_requests_total"
FLEET_RETRIES_TOTAL = "fleet_retries_total"
FLEET_DISPATCH_TOTAL = "fleet_dispatch_total"
FLEET_SHEDS_TOTAL = "fleet_sheds_observed_total"
REPLICAS_GAUGE = "fleet_replicas"
REPLICAS_HEALTHY_GAUGE = "fleet_replicas_healthy"

# Extra transport slack past the client deadline: covers response
# serialization on the replica side (mirrors server.py's wait slack).
_DISPATCH_SLACK_S = 0.1

# Retry-After on router-level sheds (no healthy replica): one probe
# interval is when membership can next change.
_NO_REPLICA_RETRY_AFTER_S = 0.25


class HttpTransport:
    """stdlib transport to one replica. ``request`` buffers the whole
    response; ``stream`` hands back the live ``HTTPResponse`` for
    ndjson relaying (http.client undoes the chunked encoding)."""

    def __init__(self, base_url: str):
        self.base_url = base_url.rstrip("/")
        parsed = urllib.parse.urlsplit(self.base_url)
        self._host = parsed.hostname or "127.0.0.1"
        self._port = parsed.port or 80

    def _connect(self, timeout: float) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(
            self._host, self._port, timeout=max(timeout, 0.001)
        )

    def request(
        self, method: str, path: str, body: Optional[bytes],
        headers: Dict[str, str], timeout: float,
    ) -> Tuple[int, bytes, Dict[str, str]]:
        conn = self._connect(timeout)
        try:
            conn.request(
                method, path, body=body,
                headers={
                    **({"Content-Type": "application/json"} if body
                       else {}),
                    **headers,
                },
            )
            resp = conn.getresponse()
            return resp.status, resp.read(), dict(resp.headers)
        finally:
            conn.close()

    def stream(
        self, path: str, body: Optional[bytes],
        headers: Dict[str, str], timeout: float,
    ):
        """``(status, payload, headers)``; on 200 ``payload`` is a
        ``close()``-able iterator of ndjson lines (the live response),
        else the buffered error body bytes."""
        conn = self._connect(timeout)
        try:
            conn.request(
                "POST", path, body=body,
                headers={
                    **({"Content-Type": "application/json"} if body
                       else {}),
                    **headers,
                },
            )
            resp = conn.getresponse()
            if resp.status != 200:
                try:
                    return resp.status, resp.read(), dict(resp.headers)
                finally:
                    conn.close()
            return resp.status, _LiveStream(conn, resp), \
                dict(resp.headers)
        except BaseException:
            conn.close()
            raise


class _LiveStream:
    """Line iterator over a streaming replica response that closes its
    connection when done (or abandoned)."""

    def __init__(self, conn: http.client.HTTPConnection, resp: Any):
        self._conn = conn
        self._resp = resp

    def __iter__(self):
        return self

    def __next__(self) -> bytes:
        line = self._resp.readline()
        if not line:
            self.close()
            raise StopIteration
        return line

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass


class Replica:
    """Router-side state for one backend replica."""

    def __init__(
        self,
        rid: str,
        transport: Any,
        *,
        url: str = "",
        breaker: Optional[CircuitBreaker] = None,
        clock: Callable[[], float] = time.monotonic,
        meta: Optional[Dict[str, Any]] = None,
    ):
        self.rid = rid
        self.transport = transport
        self.url = url
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=3, reset_timeout_s=1.0,
        )
        self.meta: Dict[str, Any] = dict(meta or {})
        self.health: Dict[str, Any] = {}
        self.healthy = True           # optimistic until a probe says no
        self.transitions: List[Dict[str, Any]] = []
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight = 0
        self.seq = 0                  # registration order (tie-break)

    @property
    def inflight(self) -> int:
        with self._lock:
            return self._inflight

    def _enter(self) -> None:
        with self._lock:
            self._inflight += 1

    def _exit(self) -> None:
        with self._lock:
            self._inflight -= 1

    def note_transition(self, what: str, reason: str) -> None:
        self.transitions.append({
            "t": round(self._clock(), 4), "to": what, "reason": reason,
        })

    def snapshot(self) -> Dict[str, Any]:
        """The /healthz row for this replica."""
        return {
            "id": self.rid,
            "url": self.url,
            "healthy": self.healthy,
            "breaker": self.breaker.state,
            "inflight": self.inflight,
            "status": self.health.get("status"),
            "queue_depth": self.health.get("queue_depth"),
            "aot": self.health.get("aot"),
            "recompiles_post_boot": self.health.get(
                "recompiles_post_boot",
                self.health.get("recompiles_post_warmup"),
            ),
            "fence_error": self.health.get("fence_error"),
            **self.meta,
        }


def affinity_key(
    prompt: Any = None, text: Optional[str] = None, *, page_size: int = 16
) -> Optional[str]:
    """The prefix-affinity contract (SERVING.md "Fleet"): hash ONLY the
    first page-size block of the prompt — the largest unit the prefix
    cache shares whole — so every request with the same leading block
    (system prompt) maps to the same replica, and requests differing
    anywhere in that block spread. Sub-block prompts return None (no
    full page to share — least-loaded is the better policy)."""
    if text is not None:
        raw = text.encode("utf-8")
        if len(raw) < page_size:
            return None
        block = raw[:page_size]
    elif prompt is not None:
        toks = list(prompt)
        if len(toks) < page_size:
            return None
        block = json.dumps(toks[:page_size]).encode()
    else:
        return None
    return hashlib.sha1(block).hexdigest()


def _rewrite_deadline(body: bytes, remaining_ms: float) -> bytes:
    """Re-encode a request body with ``deadline_ms`` set to the
    remaining budget (failover attempts must never forward the
    original, already-part-spent deadline). Unparseable bodies pass
    through untouched — the replica will 400 them itself."""
    try:
        obj = json.loads(body or b"{}")
        if not isinstance(obj, dict):
            return body
    except ValueError:
        return body
    obj["deadline_ms"] = max(round(remaining_ms, 3), 1.0)
    return json.dumps(obj).encode()


class _CountedStream:
    """Wraps a live generate stream so the owning replica's in-flight
    count (the least-loaded signal) covers the stream's whole lifetime,
    not just the dispatch call; decrements exactly once."""

    def __init__(self, inner: Any, on_close: Callable[[], None]):
        self._inner = inner
        self._on_close = on_close
        self._open = True

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._inner)
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        if self._open:
            self._open = False
            self._on_close()
        close = getattr(self._inner, "close", None)
        if close is not None:
            close()


def _rendezvous_score(key: str, rid: str) -> int:
    return int.from_bytes(
        hashlib.sha1(f"{key}|{rid}".encode()).digest()[:8], "big"
    )


class RouterCore:
    """The dispatch policy, transport-agnostic (no HTTP front end —
    :class:`~.server.FleetServer` adds that). Thread-safe: handler
    threads dispatch concurrently while the prober and the supervisor
    mutate membership."""

    def __init__(
        self,
        *,
        telemetry: Any = None,
        clock: Callable[[], float] = time.monotonic,
        probe_timeout_s: float = 2.0,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 1.0,
        page_size: int = 16,
        max_attempts: int = 3,
        slo: Any = None,
    ):
        self.telemetry = telemetry
        self.tracer = getattr(telemetry, "tracer", None) or NULL_TRACER
        self._clock = clock
        self.probe_timeout_s = float(probe_timeout_s)
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_reset_s = float(breaker_reset_s)
        self.page_size = int(page_size)
        self.max_attempts = int(max_attempts)
        self.slo = slo               # obs.slo.SLOMonitor (optional)
        self.metrics_store = FleetMetricsStore(clock=clock)
        self._lock = threading.Lock()
        self._replicas: Dict[str, Replica] = {}
        self._seq = 0
        self._prober: Optional[threading.Thread] = None
        self._scraper: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._stop_scrape = threading.Event()
        reg = telemetry.registry if telemetry is not None else None
        if reg is None:
            from ...obs import default_registry

            reg = default_registry()
        self.requests_ctr = reg.counter(
            FLEET_REQUESTS_TOTAL, "router requests by final status"
        )
        self.retries_ctr = reg.counter(
            FLEET_RETRIES_TOTAL, "failover retries by cause"
        )
        self.sheds_ctr = reg.counter(
            FLEET_SHEDS_TOTAL,
            "replica-side 503 sheds seen by the router (the "
            "autoscaler's scale-up pressure signal)",
        )
        self.dispatch_ctr = reg.counter(
            FLEET_DISPATCH_TOTAL, "dispatches per replica"
        )
        self.replicas_gauge = reg.gauge(
            REPLICAS_GAUGE, "registered replicas"
        )
        self.healthy_gauge = reg.gauge(
            REPLICAS_HEALTHY_GAUGE, "replicas currently routable"
        )

    # -- membership ----------------------------------------------------------

    def add_replica(
        self, rid: str, transport: Any, *, url: str = "",
        meta: Optional[Dict[str, Any]] = None,
    ) -> Replica:
        replica = Replica(
            rid, transport, url=url, clock=self._clock, meta=meta,
            breaker=CircuitBreaker(
                failure_threshold=self.breaker_threshold,
                reset_timeout_s=self.breaker_reset_s,
                clock=self._clock,
                on_transition=self._breaker_transition(rid),
            ),
        )
        with self._lock:
            self._seq += 1
            replica.seq = self._seq
            self._replicas[rid] = replica
        self._gauges()
        log.info("router: replica %s registered (%s)", rid, url or "local")
        return replica

    def remove_replica(self, rid: str) -> Optional[Replica]:
        with self._lock:
            replica = self._replicas.pop(rid, None)
        self._gauges()
        self.metrics_store.discard(rid)
        if replica is not None:
            log.info("router: replica %s removed", rid)
        return replica

    def replicas(self) -> List[Replica]:
        with self._lock:
            return list(self._replicas.values())

    def get_replica(self, rid: str) -> Optional[Replica]:
        with self._lock:
            return self._replicas.get(rid)

    def _gauges(self) -> None:
        reps = self.replicas()
        self.replicas_gauge.set(len(reps))
        self.healthy_gauge.set(sum(1 for r in reps if r.healthy))

    def _breaker_transition(self, rid: str):
        def on_transition(old: str, new: str, reason: str) -> None:
            if self.telemetry is not None:
                self.telemetry.emit(
                    "replica_health", replica=rid, breaker=new,
                    breaker_from=old, reason=reason,
                )
            self._decision(
                f"breaker_{new}", replica=rid,
                inputs={
                    "from": old,
                    "reason": reason,
                    "failure_threshold": self.breaker_threshold,
                    "reset_timeout_s": self.breaker_reset_s,
                },
            )
            replica = self.get_replica(rid)
            if replica is not None:
                replica.note_transition(f"breaker_{new}", reason)
        return on_transition

    def _decision(self, action: str, **fields: Any) -> None:
        """The control-plane audit record: WHAT the router decided and
        the inputs that drove it (OBSERVABILITY.md `decision` kind —
        `cli fleet explain` renders the timeline)."""
        if self.telemetry is not None:
            self.telemetry.emit(
                "decision", actor="router", action=action, **fields
            )

    # -- health probing ------------------------------------------------------

    def probe_replicas(self) -> None:
        """One probe pass over the registered replicas (the prober
        thread loops this; tests call it directly)."""
        for replica in self.replicas():
            try:
                status, body, _ = replica.transport.request(
                    "GET", "/healthz", None, {}, self.probe_timeout_s
                )
                health = json.loads(body)
            except (OSError, ValueError,
                    http.client.HTTPException) as e:
                self._mark(
                    replica, False,
                    f"probe_error:{type(e).__name__}",
                )
                continue
            replica.health = health
            if status != 200:
                self._mark(replica, False, f"http_{status}")
            elif health.get("fence_error"):
                # The replica's recompile fence tripped: it answers
                # probes but sheds everything — route away NOW.
                self._mark(replica, False, "fence_error")
            elif health.get("status") != "ok":
                self._mark(replica, False, str(health.get("status")))
            else:
                self._mark(replica, True, "ok")

    def _mark(self, replica: Replica, healthy: bool, reason: str) -> None:
        if replica.healthy == healthy:
            return
        replica.healthy = healthy
        replica.note_transition("healthy" if healthy else "ejected",
                                reason)
        self._gauges()
        if self.telemetry is not None:
            self.telemetry.emit(
                "replica_health", replica=replica.rid,
                healthy=healthy, reason=reason,
            )
        self._decision(
            "readmit" if healthy else "eject", replica=replica.rid,
            inputs={
                "reason": reason,
                "probe_status": replica.health.get("status"),
                "queue_depth": replica.health.get("queue_depth"),
                "breaker": replica.breaker.state,
                "inflight": replica.inflight,
            },
        )
        log.warning(
            "router: replica %s %s (%s)", replica.rid,
            "healthy" if healthy else "EJECTED", reason,
        )

    def start_prober(self, interval_s: float = 0.25) -> None:
        self._stop.clear()

        def run() -> None:
            while not self._stop.wait(interval_s):
                self.probe_replicas()
                # Burn rates re-evaluate on the probe cadence: the same
                # clock tick that can change membership can open/close
                # an slo_alert (obs/slo.py).
                if self.slo is not None:
                    self.slo.evaluate()

        self._prober = threading.Thread(
            target=run, name="fleet-prober", daemon=True
        )
        self._prober.start()

    def stop_prober(self) -> None:
        self._stop.set()
        if self._prober is not None:
            self._prober.join(timeout=5.0)
            self._prober = None

    # -- metrics scraping ----------------------------------------------------

    def scrape_replicas(self) -> None:
        """One scrape pass: pull every registered replica's ``/metrics``
        (the registry-snapshot JSON) into :attr:`metrics_store`, which
        the fleet-merged ``/metrics`` endpoint folds with the router's
        own registry (obs/aggregate.py). The `/healthz` half reuses the
        probe plumbing — the prober already banks each replica's latest
        health body on ``replica.health``."""
        for replica in self.replicas():
            try:
                status, body, _ = replica.transport.request(
                    "GET", "/metrics", None, {}, self.probe_timeout_s
                )
                snapshot = json.loads(body) if status == 200 else None
            except (OSError, ValueError,
                    http.client.HTTPException) as e:
                self.metrics_store.update(
                    replica.rid,
                    error=f"{type(e).__name__}: {e}",
                )
                continue
            if not isinstance(snapshot, dict):
                self.metrics_store.update(
                    replica.rid, error=f"http_{status}"
                )
                continue
            self.metrics_store.update(
                replica.rid, snapshot=snapshot,
                healthz=dict(replica.health),
            )

    def start_scraper(self, interval_s: float = 1.0) -> None:
        self._stop_scrape.clear()

        def run() -> None:
            while not self._stop_scrape.wait(interval_s):
                self.scrape_replicas()

        self._scraper = threading.Thread(
            target=run, name="fleet-scraper", daemon=True
        )
        self._scraper.start()

    def stop_scraper(self) -> None:
        self._stop_scrape.set()
        if self._scraper is not None:
            self._scraper.join(timeout=5.0)
            self._scraper = None

    # -- dispatch ------------------------------------------------------------

    def pick(
        self, *, exclude: Iterable[str] = (),
        affinity: Optional[str] = None,
    ) -> Optional[Replica]:
        """Routable replica for one attempt: healthy, breaker admitting,
        not already tried. With an affinity key: the rendezvous-hash
        winner among the candidates (stable under membership churn);
        otherwise least-loaded (fewest in-flight dispatches, oldest
        registration breaking ties)."""
        excluded = set(exclude)
        candidates = [
            r for r in self.replicas()
            if r.healthy and r.rid not in excluded and r.breaker.admits()
        ]
        if not candidates:
            return None
        if affinity is not None:
            return max(
                candidates,
                key=lambda r: _rendezvous_score(affinity, r.rid),
            )
        return min(candidates, key=lambda r: (r.inflight, r.seq))

    def _forward_headers(
        self, headers: Optional[Dict[str, str]],
        ctx: Optional[TraceContext], root: Any,
    ) -> Dict[str, str]:
        """The x-jg-trace contract: an incoming header is forwarded
        UNCHANGED; an untraced client gets the router's own context so
        the replica still joins the router's trace."""
        out = dict(headers or {})
        if TRACE_HEADER not in out:
            fwd = ctx or getattr(root, "context", None)
            if fwd:
                out[TRACE_HEADER] = format_header(fwd)
        return out

    def dispatch_predict(
        self,
        body: bytes,
        *,
        deadline: float,
        headers: Optional[Dict[str, str]] = None,
        ctx: Optional[TraceContext] = None,
        tier: str = DEFAULT_TIER,
    ) -> Tuple[int, bytes, Dict[str, str]]:
        """Route one idempotent ``/predict`` request: least-loaded
        dispatch, failover to ANOTHER replica on transport error / 5xx
        / replica shed while the deadline allows. Returns ``(status,
        body_bytes, response_headers)`` — the replica's bytes untouched
        on success (the rolling-reload bitwise-identity contract passes
        through the router)."""
        t0 = self._clock()
        root = self.tracer.start(
            "fleet.request", kind="request", ctx=ctx, fresh=True,
            tier=tier,
        )
        fwd_headers = self._forward_headers(headers, ctx, root)
        tried: List[str] = []
        attempts = 0
        last: Tuple[int, bytes, Dict[str, str]] = (
            503,
            json.dumps({"error": "shed", "reason": "no_replica"}).encode(),
            {"Retry-After": f"{_NO_REPLICA_RETRY_AFTER_S:.3f}"},
        )
        send_body = body
        while True:
            now = self._clock()
            if now >= deadline:
                # Deadline-expired fail-fast: never dispatch work the
                # client has already given up on.
                out = json.dumps({
                    "error": "deadline exceeded at router",
                    "retries": attempts,
                }).encode()
                self._done(root, t0, "deadline", None, attempts, tier)
                return 504, out, {}
            if attempts >= self.max_attempts:
                self._done(root, t0, f"gave_up_{last[0]}", None,
                           attempts, tier)
                return last
            replica = self.pick(exclude=tried)
            if replica is None or not replica.breaker.allow():
                if replica is not None:
                    # half-open with its probe budget spent this tick
                    tried.append(replica.rid)
                    continue
                self._done(root, t0, "no_replica", None, attempts, tier)
                return last
            attempts += 1
            self.dispatch_ctr.inc(replica=replica.rid)
            budget = deadline - now + _DISPATCH_SLACK_S
            if attempts > 1:
                # Failover attempts carry the REMAINING deadline, never
                # the client's original: the next replica must not be
                # promised budget that is already spent (it would serve
                # an abandoned request, and the router's own transport
                # timeout would then be miscounted as a replica fault).
                send_body = _rewrite_deadline(
                    body, (deadline - now) * 1e3
                )
            replica._enter()
            try:
                with self.tracer.start(
                    "fleet.dispatch", kind="dispatch", parent=root,
                    replica=replica.rid, attempt=attempts,
                ):
                    status, rbody, rheaders = replica.transport.request(
                        "POST", "/predict", send_body, fwd_headers,
                        budget,
                    )
            except (OSError, http.client.HTTPException) as e:
                # HTTPException covers a replica dying mid-response
                # (RemoteDisconnected is an OSError, BadStatusLine and
                # IncompleteRead are not) — all of them are the same
                # routing fact: this replica failed this request.
                replica.breaker.record_failure(
                    f"{type(e).__name__}: {e}"
                )
                tried.append(replica.rid)
                last = (
                    502,
                    json.dumps({
                        "error": f"replica {replica.rid} unreachable: "
                                 f"{type(e).__name__}",
                    }).encode(),
                    {},
                )
                self.retries_ctr.inc(reason="transport_error")
                continue
            finally:
                replica._exit()
            if status == 200:
                replica.breaker.record_success()
                self._done(root, t0, "ok", replica.rid, attempts, tier)
                return status, rbody, rheaders
            if status in (500, 502):
                replica.breaker.record_failure(f"HTTP {status}")
                tried.append(replica.rid)
                last = (status, rbody, rheaders)
                self.retries_ctr.inc(reason=f"http_{status}")
                continue
            if status == 503:
                # A replica-side shed is healthy overload behavior, not
                # a replica fault: no breaker hit, but another replica's
                # queue may have room — fail over.
                tried.append(replica.rid)
                last = (status, rbody, rheaders)
                self.sheds_ctr.inc(replica=replica.rid)
                self.retries_ctr.inc(reason="replica_shed")
                continue
            # 504 (deadline burned replica-side) and 4xx are final: the
            # backend is healthy, the request itself is done/denied.
            replica.breaker.record_success()
            self._done(root, t0, f"http_{status}", replica.rid,
                       attempts, tier)
            return status, rbody, rheaders

    def dispatch_generate(
        self,
        body: bytes,
        *,
        deadline: float,
        affinity: Optional[str] = None,
        headers: Optional[Dict[str, str]] = None,
        ctx: Optional[TraceContext] = None,
        tier: str = DEFAULT_TIER,
    ) -> Tuple[int, Any, Dict[str, str], Optional[str]]:
        """Route one LM ``/generate``: prefix-affinity pick, failover
        ONLY before the stream opens (503 shed / refused connect — no
        tokens were produced); a mid-stream failure is the caller's to
        surface, never retried. Returns ``(status, payload, headers,
        replica_id)`` — payload is a line iterator on 200."""
        t0 = self._clock()
        root = self.tracer.start(
            "fleet.request", kind="request", ctx=ctx, fresh=True,
            tier=tier, lm=True,
        )
        fwd_headers = self._forward_headers(headers, ctx, root)
        tried: List[str] = []
        attempts = 0
        last: Tuple[int, Any, Dict[str, str], Optional[str]] = (
            503,
            json.dumps({"error": "shed", "reason": "no_replica"}).encode(),
            {"Retry-After": f"{_NO_REPLICA_RETRY_AFTER_S:.3f}"},
            None,
        )
        send_body = body
        while True:
            now = self._clock()
            if now >= deadline:
                self._done(root, t0, "deadline", None, attempts, tier)
                return (
                    504,
                    json.dumps({
                        "error": "deadline exceeded at router",
                    }).encode(),
                    {}, None,
                )
            if attempts >= self.max_attempts:
                self._done(root, t0, f"gave_up_{last[0]}", None,
                           attempts, tier)
                return last
            replica = self.pick(exclude=tried, affinity=affinity)
            if replica is None or not replica.breaker.allow():
                if replica is not None:
                    tried.append(replica.rid)
                    continue
                self._done(root, t0, "no_replica", None, attempts, tier)
                return last
            attempts += 1
            self.dispatch_ctr.inc(replica=replica.rid)
            budget = deadline - now + _DISPATCH_SLACK_S
            if attempts > 1:
                send_body = _rewrite_deadline(
                    body, (deadline - now) * 1e3
                )
            replica._enter()
            try:
                status, payload, rheaders = replica.transport.stream(
                    "/generate", send_body, fwd_headers, budget
                )
            except (OSError, http.client.HTTPException) as e:
                replica._exit()
                # The connect/send failed — no stream, no tokens: the
                # one LM failover case that is provably idempotent.
                replica.breaker.record_failure(
                    f"{type(e).__name__}: {e}"
                )
                tried.append(replica.rid)
                last = (
                    502,
                    json.dumps({
                        "error": f"replica {replica.rid} unreachable: "
                                 f"{type(e).__name__}",
                    }).encode(),
                    {}, None,
                )
                self.retries_ctr.inc(reason="transport_error")
                continue
            if status == 503:
                replica._exit()
                tried.append(replica.rid)
                last = (status, payload, rheaders, replica.rid)
                self.sheds_ctr.inc(replica=replica.rid)
                self.retries_ctr.inc(reason="replica_shed")
                continue
            if status in (500, 502):
                replica._exit()
                replica.breaker.record_failure(f"HTTP {status}")
                tried.append(replica.rid)
                last = (status, payload, rheaders, replica.rid)
                self.retries_ctr.inc(reason=f"http_{status}")
                continue
            if status == 200:
                replica.breaker.record_success()
                # The stream outlives this call: keep the replica's
                # in-flight count (the least-loaded signal) held until
                # the caller closes/exhausts it.
                payload = _CountedStream(payload, replica._exit)
            else:
                replica._exit()
            self._done(
                root, t0, "ok" if status == 200 else f"http_{status}",
                replica.rid, attempts, tier,
            )
            return status, payload, rheaders, replica.rid

    def _done(
        self, root: Any, t0: float, status: str,
        replica: Optional[str], attempts: int, tier: str,
    ) -> None:
        self.requests_ctr.inc(status=status)
        root.end(status, replica=replica, attempts=attempts)
        ms = round((self._clock() - t0) * 1e3, 3)
        if self.slo is not None:
            # 4xx is a client error, not fleet unavailability — the
            # Google availability convention (5xx/timeouts burn budget).
            ok = status == "ok" or status.startswith("http_4")
            self.slo.observe_request(ok, latency_ms=ms)
        if self.telemetry is not None:
            self.telemetry.emit(
                "fleet_dispatch", status=status, replica=replica,
                attempts=attempts, tier=tier, ms=ms,
            )

    # -- introspection -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        reps = self.replicas()
        return {
            "replicas": [r.snapshot() for r in sorted(
                reps, key=lambda r: r.seq
            )],
            "live": sum(1 for r in reps if r.healthy),
            "registered": len(reps),
        }
