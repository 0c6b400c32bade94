"""The port's serving fleet (``serve/fleet``) against the JAX package's
tests/test_fleet.py, case for case: router dispatch policy (least-loaded
pick, breaker ejection + half-open re-entry, deadline fail-fast, trace
forwarding, prefix affinity, failover), tier-aware admission
displacement, autoscaler decisions on fake clocks, supervisor
spawn/reap/respawn with real subprocesses (stub replicas, as JAX's),
rolling-reload promotion + automatic rollback, retrying clients
(Retry-After honored, no mid-stream LM retry), and the acceptance: a
3-replica fleet of the port's in-process engines over its frozen
predictor survives killing one replica mid-saturation with availability
>= 0.99. The fleet's replica command is the port's own ``cli serve``.
"""

import json
import os
import sys
import textwrap
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from distributed_mnist_bnns_tpu_torch.resilience.policy import (
    CircuitBreaker,
    RetryPolicy,
)
from distributed_mnist_bnns_tpu_torch.serve import AdmissionQueue, Request
from distributed_mnist_bnns_tpu_torch.serve.core import ServeEngine
from distributed_mnist_bnns_tpu_torch.serve.fleet import (
    Autoscaler,
    FleetView,
    ReplicaSupervisor,
    RolloutManager,
    RouterCore,
    affinity_key,
    stage_artifact,
)


class FakeClock:
    def __init__(self, t: float = 100.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class FakeTransport:
    """Scriptable replica transport: ``responder(method, path, body,
    headers)`` -> (status, body, headers) or raises."""

    def __init__(self, responder=None):
        self.calls = []
        self.responder = responder or (
            lambda m, p, b, h: (200, b'{"ok": true}', {})
        )

    def request(self, method, path, body, headers, timeout):
        self.calls.append((method, path, body, dict(headers or {})))
        return self.responder(method, path, body, headers)

    def stream(self, path, body, headers, timeout):
        status, payload, rheaders = self.responder(
            "POST", path, body, headers
        )
        if status == 200:
            return status, iter([payload]), rheaders
        return status, payload, rheaders


def _router(clock=None, **kw):
    kw.setdefault("breaker_threshold", 2)
    kw.setdefault("breaker_reset_s", 1.0)
    if clock is not None:
        kw["clock"] = clock
    return RouterCore(**kw)


def _deadline(clock=None, ms=1000.0):
    now = clock() if clock is not None else time.monotonic()
    return now + ms / 1e3


# -- router units ------------------------------------------------------------


def test_pick_least_loaded_with_stable_tiebreak():
    router = _router()
    a = router.add_replica("a", FakeTransport())
    b = router.add_replica("b", FakeTransport())
    c = router.add_replica("c", FakeTransport())
    a._enter(), a._enter(), c._enter()
    assert router.pick() is b
    b._enter(), b._enter()
    # ties (c=1 in flight after a releases nothing) break by seq
    assert router.pick() is c
    c._enter(), c._enter()
    assert router.pick() is a


def test_dispatch_forwards_trace_header_and_echoes_bytes():
    sent = b'{"argmax": [3], "log_probs": [[0.5]]}'
    responder = lambda m, p, b, h: (  # noqa: E731
        200, sent, {"x-jg-trace": h.get("x-jg-trace", "")}
    )
    router = _router()
    router.add_replica("a", FakeTransport(responder))
    hdr = "deadbeefdeadbeef-cafecafecafecafe"
    status, body, rheaders = router.dispatch_predict(
        b'{"images": []}', deadline=_deadline(),
        headers={"x-jg-trace": hdr},
    )
    assert status == 200
    assert body == sent                      # bytes pass through untouched
    assert rheaders.get("x-jg-trace") == hdr  # echoed back
    transport = router.get_replica("a").transport
    assert transport.calls[0][3].get("x-jg-trace") == hdr  # forwarded


def test_deadline_expired_fails_fast_without_dispatch():
    clock = FakeClock()
    router = _router(clock=clock)
    transport = FakeTransport()
    router.add_replica("a", transport)
    status, body, _ = router.dispatch_predict(
        b"{}", deadline=clock() - 0.001,
    )
    assert status == 504
    assert b"deadline" in body
    assert transport.calls == []             # nothing was dispatched


def test_retry_on_another_replica_after_transport_error():
    def boom(m, p, b, h):
        raise ConnectionError("replica down")

    router = _router()
    router.add_replica("a", FakeTransport(boom))
    ok = FakeTransport()
    router.add_replica("b", ok)
    status, _, _ = router.dispatch_predict(
        b"{}", deadline=_deadline()
    )
    assert status == 200
    assert len(ok.calls) == 1
    assert int(router.retries_ctr.total()) == 1


def test_replica_shed_fails_over_without_breaker_hit():
    shed = lambda m, p, b, h: (  # noqa: E731
        503, b'{"error": "shed", "reason": "queue_full"}',
        {"Retry-After": "0.1"},
    )
    router = _router()
    router.add_replica("a", FakeTransport(shed))
    router.add_replica("b", FakeTransport())
    status, _, _ = router.dispatch_predict(
        b"{}", deadline=_deadline()
    )
    assert status == 200
    assert router.get_replica("a").breaker.state == "closed"
    assert int(router.sheds_ctr.total()) == 1


def test_breaker_ejection_and_half_open_reentry():
    clock = FakeClock()
    mode = {"a": "fail"}

    def flaky(m, p, b, h):
        if mode["a"] == "fail":
            return 502, b'{"error": "backend"}', {}
        return 200, b'{"ok": true}', {}

    router = _router(clock=clock)
    a_transport = FakeTransport(flaky)
    router.add_replica("a", a_transport)
    router.add_replica("b", FakeTransport())
    # two failing dispatches trip a's breaker (threshold 2); both
    # requests still succeed via failover to b
    for _ in range(2):
        status, _, _ = router.dispatch_predict(
            b"{}", deadline=_deadline(clock)
        )
        assert status == 200
    a = router.get_replica("a")
    assert a.breaker.state == "open"
    calls_when_open = len(a_transport.calls)
    status, _, _ = router.dispatch_predict(
        b"{}", deadline=_deadline(clock)
    )
    assert status == 200
    assert len(a_transport.calls) == calls_when_open  # a skipped while open
    # reset timeout elapses -> half-open probe goes to a and, now
    # healthy, closes the breaker
    mode["a"] = "ok"
    clock.advance(1.1)
    status, _, _ = router.dispatch_predict(
        b"{}", deadline=_deadline(clock)
    )
    assert status == 200
    assert len(a_transport.calls) == calls_when_open + 1
    assert a.breaker.state == "closed"


def test_health_probe_ejects_fence_error_and_readmits():
    health = {"status": "ok", "fence_error": None, "queue_depth": 0}
    responder = lambda m, p, b, h: (  # noqa: E731
        200, json.dumps(health).encode(), {}
    )
    router = _router()
    router.add_replica("a", FakeTransport(responder))
    router.probe_replicas()
    assert router.pick() is not None
    health["fence_error"] = "compile after budget-0 boot"
    router.probe_replicas()
    assert router.get_replica("a").healthy is False
    assert router.pick() is None
    health["fence_error"] = None
    router.probe_replicas()
    assert router.pick() is not None
    kinds = [t["to"] for t in router.get_replica("a").transitions]
    assert kinds == ["ejected", "healthy"]


def test_prefix_affinity_stability_and_fallback():
    router = _router(page_size=4)
    for rid in ("a", "b", "c"):
        router.add_replica(rid, FakeTransport())
    key = affinity_key(prompt=[1, 2, 3, 4, 99], page_size=4)
    assert key is not None
    first = router.pick(affinity=key).rid
    # stable: same key -> same replica, independent of load
    router.get_replica(first)._enter()
    assert all(
        router.pick(affinity=key).rid == first for _ in range(10)
    )
    # same leading block, different tail -> same replica (the contract)
    key2 = affinity_key(prompt=[1, 2, 3, 4, 7, 7, 7], page_size=4)
    assert key2 == key
    # a dead preferred replica falls back to another deterministically
    router.get_replica(first).healthy = False
    fallback = router.pick(affinity=key).rid
    assert fallback != first
    # sub-block prompts have no full shared page: no affinity
    assert affinity_key(prompt=[1, 2], page_size=4) is None
    assert affinity_key(text="ab", page_size=4) is None


# -- tier-aware admission ----------------------------------------------------


def _req(n=1, tier="interactive"):
    return Request(
        np.zeros((n, 4), np.float32), time.monotonic() + 10, tier=tier
    )


def test_queue_displaces_newest_lower_tier():
    q = AdmissionQueue(maxsize=2)
    b1, b2 = _req(tier="batch"), _req(tier="batch")
    assert q.try_put(b1) and q.try_put(b2)
    hi = _req(tier="interactive")
    admitted, victim = q.put_or_displace(hi)
    assert admitted and victim is b2          # newest batch evicted
    # a second batch request cannot displace its own tier
    admitted, victim = q.put_or_displace(_req(tier="batch"))
    assert not admitted and victim is None
    # pop serves the interactive request first, then FIFO batch
    batch = q.pop_batch(10, linger_s=0)
    assert [r.tier for r in batch] == ["interactive", "batch"]
    assert batch[0] is hi and batch[1] is b1


def test_engine_sheds_low_tier_first_with_tier_labels():
    from distributed_mnist_bnns_tpu_torch.obs import Telemetry

    telemetry = Telemetry(None, heartbeat=False)
    engine = ServeEngine(          # never started: queue stays frozen
        lambda x: np.zeros((x.shape[0], 10), np.float32),
        batch_size=4,
        queue=AdmissionQueue(2),
        breaker=CircuitBreaker(failure_threshold=100),
        telemetry=telemetry,
    )
    imgs = np.zeros((1, 4), np.float32)
    deadline = time.monotonic() + 10
    b1 = engine.submit(imgs, deadline, tier="batch")
    b2 = engine.submit(imgs, deadline, tier="batch")
    assert isinstance(b1, Request) and isinstance(b2, Request)
    hi = engine.submit(imgs, deadline, tier="interactive")
    assert isinstance(hi, Request)
    # the newest batch request was displaced and resolved as shed
    assert b2.event.is_set() and b2.status == "shed"
    assert b1.status is None                  # older batch still queued
    # full of [batch, interactive]: another batch request sheds ITSELF
    assert engine.submit(imgs, deadline, tier="batch") == "queue_full"
    # ... but interactive still displaces the remaining batch request
    hi2 = engine.submit(imgs, deadline, tier="interactive")
    assert isinstance(hi2, Request)
    assert b1.status == "shed"
    snap = telemetry.registry.snapshot()
    shed_series = {
        (s["labels"]["reason"], s["labels"]["tier"]): s["value"]
        for s in snap["serve_shed_total"]["series"]
    }
    assert shed_series[("displaced", "batch")] == 2
    assert shed_series[("queue_full", "batch")] == 1


# -- autoscaler --------------------------------------------------------------


def test_autoscaler_scales_up_on_sustained_pressure_only():
    view = FleetView(min_replicas=1, max_replicas=4, target=2)
    scaler = Autoscaler(
        queue_high=4.0, queue_low=0.5, sustain_s=1.0, cooldown_s=3.0,
        clock=lambda: 0.0,
    )
    # a burst shorter than sustain_s does nothing
    assert scaler.observe(view, queue_depth=9, shed_rate=0, now=0.0) is None
    assert scaler.observe(view, queue_depth=0, shed_rate=0, now=0.5) is None
    assert scaler.observe(view, queue_depth=9, shed_rate=0, now=1.0) is None
    # sustained pressure scales up exactly once per cooldown
    assert scaler.observe(view, queue_depth=9, shed_rate=0, now=2.1) == 3
    view.target = 3
    assert scaler.observe(view, queue_depth=9, shed_rate=0, now=2.5) is None
    assert scaler.observe(view, queue_depth=9, shed_rate=0, now=5.0) is None
    assert scaler.observe(view, queue_depth=9, shed_rate=0, now=6.2) == 4
    view.target = 4
    # at max: no further growth even under pressure
    assert scaler.observe(view, queue_depth=99, shed_rate=5,
                          now=20.0) is None


def test_autoscaler_scale_down_needs_idle_and_respects_min():
    view = FleetView(min_replicas=1, max_replicas=4, target=2)
    scaler = Autoscaler(
        queue_high=4.0, queue_low=0.5, sustain_s=1.0, cooldown_s=0.0,
        clock=lambda: 0.0,
    )
    assert scaler.observe(view, queue_depth=0, shed_rate=0, now=0.0) is None
    # sheds during an otherwise idle window block the scale-down
    assert scaler.observe(view, queue_depth=0, shed_rate=2.0,
                          now=0.6) is None
    assert scaler.observe(view, queue_depth=0, shed_rate=0, now=1.0) is None
    assert scaler.observe(view, queue_depth=0, shed_rate=0, now=2.1) == 1
    view.target = 1
    assert scaler.observe(view, queue_depth=0, shed_rate=0,
                          now=10.0) is None   # at min


def test_autoscaler_shed_rate_alone_scales_up():
    view = FleetView(min_replicas=1, max_replicas=4, target=1)
    scaler = Autoscaler(sustain_s=0.5, cooldown_s=0.0,
                        clock=lambda: 0.0)
    assert scaler.observe(view, queue_depth=0, shed_rate=3.0,
                          now=0.0) is None
    assert scaler.observe(view, queue_depth=0, shed_rate=3.0,
                          now=0.6) == 2


# -- supervisor (real subprocesses, stub replicas) ---------------------------


STUB_REPLICA = textwrap.dedent("""
    import json, os, signal, sys
    from http.server import BaseHTTPRequestHandler, HTTPServer

    class H(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        def do_GET(self):
            body = json.dumps(
                {"status": "ok", "queue_depth": 0, "fence_error": None}
            ).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        def log_message(self, *a):
            pass

    signal.signal(signal.SIGTERM, lambda *a: os._exit(0))
    HTTPServer(("127.0.0.1", int(sys.argv[1])), H).serve_forever()
""")


@pytest.fixture
def stub_replica(tmp_path):
    path = tmp_path / "stub_replica.py"
    path.write_text(STUB_REPLICA)

    def spawn_command(rid, port, artifact):
        return [sys.executable, str(path), str(port)]

    return spawn_command


def _tick_until(supervisor, predicate, timeout=20.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        supervisor.tick()
        if predicate():
            return True
        time.sleep(0.05)
    return False


def test_supervisor_boots_reaps_respawns_and_drains(stub_replica):
    from distributed_mnist_bnns_tpu_torch.obs import Telemetry

    telemetry = Telemetry(None, heartbeat=False)
    router = RouterCore(telemetry=telemetry)
    supervisor = ReplicaSupervisor(
        router, stub_replica, artifact="a.msgpack",
        view=FleetView(min_replicas=1, max_replicas=3, target=2),
        telemetry=telemetry, boot_timeout_s=20.0,
        respawn_policy=RetryPolicy(
            base_backoff_s=0.01, max_backoff_s=0.05, jitter=0.0
        ),
    )
    try:
        supervisor.spawn_replica()
        supervisor.spawn_replica()
        assert _tick_until(
            supervisor, lambda: supervisor.live_count() == 2
        ), "replicas never became live"
        rids_before = {m.rid for m in supervisor.members()}
        # kill one replica: the supervisor must reap it, remove it from
        # the router and respawn a NEW member back to target
        victim = supervisor.members()[0]
        victim.proc.kill()
        assert _tick_until(
            supervisor,
            lambda: supervisor.live_count() == 2
            and victim.rid not in {m.rid for m in supervisor.members()},
        ), "killed replica was not replaced"
        assert {m.rid for m in supervisor.members()} != rids_before
        assert router.get_replica(victim.rid) is None
        assert int(supervisor.respawn_ctr.total()) == 1
    finally:
        rcs = supervisor.drain_all(timeout=10.0)
    assert all(rc == 0 for rc in rcs.values()), rcs


def test_supervisor_scale_down_retires_newest(stub_replica):
    router = RouterCore()
    supervisor = ReplicaSupervisor(
        router, stub_replica, artifact="a.msgpack",
        view=FleetView(min_replicas=1, max_replicas=3, target=2),
        boot_timeout_s=20.0,
    )
    try:
        supervisor.spawn_replica()
        supervisor.spawn_replica()
        assert _tick_until(
            supervisor, lambda: supervisor.live_count() == 2
        )
        newest = max(supervisor.members(), key=lambda m: m.seq)
        supervisor.view.target = 1
        assert _tick_until(
            supervisor,
            lambda: supervisor.live_count() == 1
            and newest.rid not in {m.rid for m in supervisor.members()},
        ), "newest replica was not retired"
    finally:
        rcs = supervisor.drain_all(timeout=10.0)
    assert all(rc == 0 for rc in rcs.values()), rcs


# -- rolling deploys ---------------------------------------------------------


class FakeReplicaBackend:
    """A fake replica whose /predict behavior depends on the loaded
    artifact — 'garbage' artifacts serve 502s, 'unloadable' ones fail
    the reload call itself."""

    def __init__(self, artifact="old.msgpack"):
        self.artifact = artifact
        self.reloads = []

    def request(self, method, path, body, headers, timeout):
        if path == "/admin/reload":
            target = json.loads(body)["artifact"]
            self.reloads.append(target)
            if "unloadable" in target:
                return 400, b'{"error": "reload failed"}', {}
            self.artifact = target
            return 200, b'{"reloaded": true}', {}
        if path == "/healthz":
            return 200, json.dumps(
                {"status": "ok", "fence_error": None}
            ).encode(), {}
        if path == "/predict":
            if "garbage" in self.artifact:
                return 502, b'{"error": "backend failure"}', {}
            return 200, b'{"argmax": [0]}', {}
        return 404, b"{}", {}


def _rollout_fixture(n=3, **kw):
    from distributed_mnist_bnns_tpu_torch.obs import Telemetry

    telemetry = Telemetry(None, heartbeat=False)
    router = RouterCore(telemetry=telemetry)
    backends = [FakeReplicaBackend() for _ in range(n)]
    for i, backend in enumerate(backends):
        router.add_replica(f"r{i}", backend)
    kw.setdefault("probe_n", 4)
    kw.setdefault("health_timeout_s", 2.0)
    manager = RolloutManager(
        router, artifact="old.msgpack", telemetry=telemetry,
        probe_body=b'{"images": []}', **kw,
    )
    return manager, backends, telemetry


def test_rolling_reload_promotes_canary_first_then_all():
    manager, backends, telemetry = _rollout_fixture()
    result = manager.rolling_reload("new.msgpack")
    assert result["status"] == "promoted"
    assert all(b.artifact == "new.msgpack" for b in backends)
    assert manager.current_artifact == "new.msgpack"
    # canary ordering: r0 reloaded before r1/r2 saw anything
    assert backends[0].reloads == ["new.msgpack"]


def test_unloadable_canary_rolls_fleet_back():
    manager, backends, _ = _rollout_fixture()
    result = manager.rolling_reload("unloadable.msgpack")
    assert result["status"] == "rolled_back"
    assert result["tripped"] == "r0"
    assert all(b.artifact == "old.msgpack" for b in backends)
    assert manager.current_artifact == "old.msgpack"
    # the non-canary replicas never saw the bad artifact at all
    assert backends[1].reloads == [] and backends[2].reloads == []


def test_error_rate_canary_trip_rolls_back_promoted():
    manager, backends, telemetry = _rollout_fixture()
    # 'garbage' loads fine but serves 502s: the canary's live-probe
    # error-rate gate must trip and the whole fleet roll back
    result = manager.rolling_reload("garbage.msgpack")
    assert result["status"] == "rolled_back"
    assert "error rate" in result["reason"]
    assert all(b.artifact == "old.msgpack" for b in backends)


def test_stage_artifact_ships_digest_verified(tmp_path):
    src = tmp_path / "model.msgpack"
    payload = os.urandom(4096)
    src.write_bytes(payload)
    staged = stage_artifact(str(src), str(tmp_path / "staging"))
    assert staged != str(src)
    with open(staged, "rb") as f:
        assert f.read() == payload


# -- retrying clients --------------------------------------------------------


class _ScriptedHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    script = []          # list of ("code", payload) consumed per request
    hits = None

    def log_message(self, *a):
        pass

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        self.rfile.read(n)
        self.hits.append(self.path)
        step = (
            self.script.pop(0) if self.script else ("json", 200, b"{}")
        )
        if step[0] == "json":
            _, code, body = step
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if code == 503:
                self.send_header("Retry-After", "0.07")
            self.end_headers()
            self.wfile.write(body)
        elif step[0] == "stream":
            _, lines, complete = step
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for obj in lines:
                data = json.dumps(obj).encode() + b"\n"
                self.wfile.write(
                    f"{len(data):X}\r\n".encode() + data + b"\r\n"
                )
                self.wfile.flush()
            if complete:
                self.wfile.write(b"0\r\n\r\n")
            else:
                self.connection.close()   # mid-stream death


@pytest.fixture
def scripted_server():
    servers = []

    def make(script):
        handler = type("H", (_ScriptedHandler,), {
            "script": list(script), "hits": [],
        })
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append(httpd)
        host, port = httpd.server_address[:2]
        return f"http://{host}:{port}", handler

    yield make
    for httpd in servers:
        httpd.shutdown()
        httpd.server_close()


def test_predict_with_retries_honors_retry_after(scripted_server):
    from distributed_mnist_bnns_tpu_torch.serve import client as sc

    base, handler = scripted_server([
        ("json", 503, b'{"error": "shed", "reason": "queue_full"}'),
        ("json", 200, b'{"argmax": [1]}'),
    ])
    slept = []
    code, body = sc.predict_with_retries(
        base, [[[0.0]]], deadline_ms=5000.0, sleep=slept.append,
    )
    assert code == 200 and b"argmax" in body
    assert len(handler.hits) == 2
    assert slept == [pytest.approx(0.07)]    # the server's hint, not a guess


def test_predict_with_retries_never_retries_4xx(scripted_server):
    from distributed_mnist_bnns_tpu_torch.serve import client as sc

    base, handler = scripted_server([
        ("json", 400, b'{"error": "bad images payload"}'),
    ])
    code, _ = sc.predict_with_retries(base, "junk", deadline_ms=2000.0)
    assert code == 400
    assert len(handler.hits) == 1


def test_generate_with_retries_503_then_stream(scripted_server):
    from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc

    base, handler = scripted_server([
        ("json", 503, b'{"error": "shed", "reason": "queue_full"}'),
        ("stream",
         [{"i": 0, "token": 5}, {"done": True, "status": "ok", "n": 1,
                                 "id": "r1"}],
         True),
    ])
    slept = []
    code, events = lc.generate_with_retries(
        base, [1, 2, 3], sleep=slept.append,
    )
    assert code == 200
    assert events[0]["token"] == 5 and events[-1]["done"]
    assert len(handler.hits) == 2
    assert slept == [pytest.approx(0.07)]    # shed hint honored


def test_generate_never_retries_mid_stream(scripted_server):
    from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc

    base, handler = scripted_server([
        ("stream", [{"i": 0, "token": 9}], False),   # dies mid-stream
        ("stream", [{"i": 0, "token": 1}], True),    # must NOT be reached
    ])
    code, events = lc.generate_with_retries(base, [1, 2, 3])
    assert code == 200
    assert len(handler.hits) == 1, "mid-stream failure must not retry"
    assert events[0] == {"i": 0, "token": 9}
    assert events[-1].get("truncated") is True


# -- acceptance: no availability collapse when a replica dies ----------------


def test_fleet_survives_replica_kill_at_saturation():
    """The acceptance: a saturated 3-replica fleet (real engines over the
    port's frozen predictor, real router policy) chaos-stalls then loses
    one replica mid-window;
    retry/failover must keep end-to-end availability >= 0.99, the dead
    replica's breaker must open, and the prober must eject it."""
    from distributed_mnist_bnns_tpu_torch.serve.fleet.harness import (
        fleet_availability_section,
    )

    section = fleet_availability_section(
        duration_s=2.0, kill_after_s=0.7, device="cpu",
    )
    assert section["requests_total"] > 50
    # the whole section as text: pytest cuts a dict's repr short
    assert section["availability"] >= 0.99, json.dumps(section, default=str)
    transitions = section["replica_transitions"][
        section["killed_replica"]
    ]
    assert any(
        t["to"] in ("breaker_open", "ejected") for t in transitions
    ), transitions
    # the survivors never flapped
    for rid, trs in section["replica_transitions"].items():
        if rid != section["killed_replica"]:
            assert trs == [], (rid, trs)


def test_probe_window_runs_with_the_callers_heap_frozen():
    """The kill probe's fleet shares its caller's interpreter, and a full
    collection over a test worker's heap stopped replicas, router and
    clients together for 1.7 s under load (4 requests 504). In the
    window the heap the caller held is frozen out of the collector, and
    it is given back unfrozen."""
    import gc

    from distributed_mnist_bnns_tpu_torch.serve.fleet.harness import (
        fleet_availability_section,
    )

    held = [[i] for i in range(100_000)]
    frozen_seen = []

    def seen(phase, info):
        if phase == "start":
            frozen_seen.append(gc.get_freeze_count())

    gc.callbacks.append(seen)
    try:
        section = fleet_availability_section(
            duration_s=0.5, kill_after_s=0.2, device="cpu",
        )
    finally:
        gc.callbacks.remove(seen)
    assert section["requests_total"] > 0
    assert max(frozen_seen) >= len(held), max(frozen_seen)
    assert gc.get_freeze_count() == 0
    assert all(p >= 0 for p in section["gc_full_pauses_s"])


def test_replicas_are_the_ports_cli_serve_on_the_fleet_device(tmp_path):
    """The supervisor spawns ``python -m distributed_mnist_bnns_tpu_torch.
    cli serve`` at the fleet's ``--device`` (the card by default), with
    the JAX fleet's flags; the command parses as the port's ``serve``."""
    from distributed_mnist_bnns_tpu_torch.cli import build_parser
    from distributed_mnist_bnns_tpu_torch.serve.fleet import (
        FleetConfig,
        FleetServer,
    )

    tel = tmp_path / "tel"
    for cfg, device in ((FleetConfig(artifact="a.msgpack"), "cuda"),
                        (FleetConfig(artifact="lm.msgpack", lm=True,
                                     device="cpu", telemetry_dir=str(tel),
                                     replica_flags=["--slots", "8"]),
                         "cpu")):
        fleet = FleetServer(cfg)
        cmd = fleet._spawn_command("replica-3", 8123, cfg.artifact)
        assert cmd[:4] == [sys.executable, "-m",
                           "distributed_mnist_bnns_tpu_torch.cli", "serve"]
        args = build_parser().parse_args(cmd[3:])
        assert (args.cmd, args.artifact, args.port, args.device) == (
            "serve", cfg.artifact, 8123, device)
        assert args.lm == cfg.lm
        fleet.telemetry.close()
    assert args.slots == 8 and args.page_size == 16
    assert args.telemetry_dir == str(tel / "replica-3")
    assert args.log_file == str(tel / "replica-3.log")
