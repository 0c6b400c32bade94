"""The PyTorch port's serving stack on ``device="cpu"``: admission queue
and micro-batcher units, the HTTP round trip, queue-full shedding,
deadlines, the circuit breaker and the graceful drain.

The cases follow the JAX package's tests/test_serve.py. Where those use
fault injection (not in the port yet), these wrap the engine's predictor
with a slow, gated or failing one.
"""

import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu_torch.infer import export_packed
from distributed_mnist_bnns_tpu_torch.models import bnn_mlp_small
from distributed_mnist_bnns_tpu_torch.serve import (
    AdmissionQueue,
    PackedInferenceServer,
    Request,
    ServeConfig,
)
from distributed_mnist_bnns_tpu_torch.serve import client as sc


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A tiny exported bnn-mlp artifact from a seeded init (serving
    mechanics do not care about accuracy)."""
    model = bnn_mlp_small(
        infl_ratio=1, generator=torch.Generator().manual_seed(0)
    ).eval()
    path = tmp_path_factory.mktemp("serve_artifact") / "m.msgpack"
    export_packed(model, str(path))
    return str(path)


def _server(artifact, **kw):
    kw.setdefault("port", 0)
    kw.setdefault("batch_size", 4)
    kw.setdefault("queue_depth", 8)
    kw.setdefault("default_deadline_ms", 5000.0)
    srv = PackedInferenceServer(
        ServeConfig(artifact=artifact, device="cpu", **kw)
    )
    host, port = srv.start()
    return srv, f"http://{host}:{port}"


def _stop(srv):
    srv.request_stop("test over")
    return srv.drain_and_stop()


def _imgs(n, seed=0):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).tolist()


def _wrap(srv, before):
    """Run ``before()`` ahead of every predictor call."""
    inner = srv.engine.predict_fn

    def fn(x):
        before()
        return inner(x)

    srv.engine.predict_fn = fn


def _wait_for(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


# -- data-plane units (no HTTP) ----------------------------------------------


def test_admission_queue_bounded_and_coalescing():
    q = AdmissionQueue(maxsize=3)
    for n in (2, 1, 1):
        assert q.try_put(Request(np.zeros((n, 4), np.float32),
                                 time.monotonic() + 10))
    assert not q.try_put(
        Request(np.zeros((1, 4), np.float32), time.monotonic() + 10)
    )
    batch = q.pop_batch(4, linger_s=0)
    assert [r.n for r in batch] == [2, 1, 1]
    assert len(q) == 0
    t0 = time.monotonic()
    assert q.pop_batch(4, timeout=0.05) == []
    assert time.monotonic() - t0 < 1.0


def test_admission_queue_head_never_splits():
    q = AdmissionQueue(maxsize=4)
    q.try_put(Request(np.zeros((3, 4), np.float32), time.monotonic() + 10))
    q.try_put(Request(np.zeros((2, 4), np.float32), time.monotonic() + 10))
    assert [r.n for r in q.pop_batch(4, linger_s=0)] == [3]
    assert [r.n for r in q.pop_batch(4, linger_s=0)] == [2]


def test_request_finish_claims_once():
    r = Request(np.zeros((1, 4), np.float32), time.monotonic() + 10)
    assert r.finish("deadline", error="waiter gave up")
    assert not r.finish("ok", log_probs=np.zeros((1, 10)))
    assert r.status == "deadline"
    assert r.event.is_set()


def test_interactive_displaces_newest_batch_tier():
    q = AdmissionQueue(maxsize=2)
    old = Request(np.zeros((1, 4), np.float32), time.monotonic() + 10,
                  tier="batch")
    new = Request(np.zeros((1, 4), np.float32), time.monotonic() + 10,
                  tier="batch")
    assert q.put_or_displace(old) == (True, None)
    assert q.put_or_displace(new) == (True, None)
    vip = Request(np.zeros((1, 4), np.float32), time.monotonic() + 10)
    assert q.put_or_displace(vip) == (True, new)
    late = Request(np.zeros((1, 4), np.float32), time.monotonic() + 10,
                   tier="batch")
    assert q.put_or_displace(late) == (False, None)
    assert [r is vip for r in q.pop_batch(4, linger_s=0)] == [True, False]


# -- HTTP server -------------------------------------------------------------


def test_roundtrip_health_and_bad_inputs(artifact):
    srv, base = _server(artifact)
    try:
        code, body = sc.healthz(base)
        health = json.loads(body)
        assert code == 200
        assert health["status"] == "ok" and health["breaker"] == "closed"
        assert health["family"] == "bnn-mlp" and health["device"] == "cpu"

        code, body = sc.predict(base, _imgs(3))
        assert code == 200
        out = json.loads(body)
        # the engine's own predictor on the same zero-padded batch
        x = np.zeros((4, 28, 28, 1), np.float32)
        x[:3] = np.asarray(_imgs(3), np.float32)
        direct = srv.engine.predict_fn(x)[:3].numpy()
        assert out["argmax"] == direct.argmax(-1).tolist()
        np.testing.assert_array_equal(
            np.asarray(out["log_probs"], np.float32), direct
        )
        # one unbatched example is a batch of one
        code, body = sc.predict(base, _imgs(1)[0])
        assert code == 200 and len(json.loads(body)["argmax"]) == 1

        assert sc.predict(base, "not-an-image")[0] == 400
        assert sc.predict(base, _imgs(5))[0] == 413
        code, body = sc.predict(base, np.zeros((2, 784)).tolist())
        assert code == 400 and b"input shape" in body
        assert sc.predict(base, _imgs(1), deadline_ms="fast")[0] == 400
        assert sc.predict(base, _imgs(1), deadline_ms=-1)[0] == 400
        assert sc.predict(base, _imgs(1), tier="junk")[0] == 400
        assert sc.predict(base, _imgs(1), tier="batch")[0] == 200
        assert sc._request(base + "/nope")[0] == 404
        assert sc.predict(base, _imgs(1))[0] == 200  # still serving
    finally:
        stats = _stop(srv)
    assert stats["flushed"]
    assert srv.engine.requests_ctr.snapshot()["status=ok"] == 4


def test_queue_full_sheds_503(artifact):
    srv, base = _server(artifact, batch_size=1, queue_depth=1)
    gate = threading.Event()
    _wrap(srv, lambda: gate.wait(10))
    results = {}

    def ask(key):
        results[key] = sc.predict(base, _imgs(1))

    first = threading.Thread(target=ask, args=("first",))
    second = threading.Thread(target=ask, args=("second",))
    try:
        first.start()
        _wait_for(lambda: srv.engine._busy)      # the worker holds it
        second.start()
        _wait_for(lambda: len(srv.queue) == 1)   # the queue is full
        code, body = sc.predict(base, _imgs(1))
        assert code == 503
        assert json.loads(body)["reason"] == "queue_full"
        gate.set()
        first.join(10)
        second.join(10)
        assert results["first"][0] == 200 and results["second"][0] == 200
    finally:
        gate.set()
        _stop(srv)
    assert srv.engine.shed_ctr.snapshot() == {
        "reason=queue_full,tier=interactive": 1
    }


def test_deadline_bounds_response_under_stall(artifact):
    """A stalled backend does not hang the client: the waiter abandons
    at its deadline and gets a prompt 504."""
    srv, base = _server(artifact, stall_timeout_s=10.0)
    _wrap(srv, lambda: time.sleep(1.0))
    try:
        t0 = time.monotonic()
        code, body = sc.predict(base, _imgs(1), deadline_ms=200)
        elapsed = time.monotonic() - t0
        assert code == 504
        assert elapsed < 0.9, f"504 took {elapsed:.3f}s (stall was 1s)"
    finally:
        _stop(srv)
    assert srv.engine.requests_ctr.snapshot()["status=deadline"] == 1


def test_breaker_trips_on_backend_errors_and_recovers(artifact):
    srv, base = _server(artifact, breaker_threshold=3, breaker_reset_s=0.3)
    failing = {"on": True}

    def maybe_fail():
        if failing["on"]:
            raise RuntimeError("injected backend failure")

    _wrap(srv, maybe_fail)
    try:
        for _ in range(3):
            assert sc.predict(base, _imgs(1))[0] == 502
        assert json.loads(sc.healthz(base)[1])["breaker"] == "open"
        code, body = sc.predict(base, _imgs(1))
        assert code == 503
        assert json.loads(body)["reason"] == "breaker_open"
        failing["on"] = False
        time.sleep(0.35)
        assert sc.predict(base, _imgs(1))[0] == 200   # the half-open probe
        assert json.loads(sc.healthz(base)[1])["breaker"] == "closed"
    finally:
        _stop(srv)
    assert srv.breaker_transitions.snapshot() == {
        "to=open": 1, "to=half_open": 1, "to=closed": 1,
    }


def test_drain_rejects_new_work_but_flushes_queued(artifact):
    """Requests queued before the drain get real answers; requests after
    it get an explicit draining 503."""
    srv, base = _server(artifact, stall_timeout_s=10.0)
    _wrap(srv, lambda: time.sleep(0.3))
    results = {}

    def slow_req():
        results["queued"] = sc.predict(base, _imgs(1))

    t = threading.Thread(target=slow_req)
    t.start()
    _wait_for(lambda: srv.engine._busy)
    srv.engine.begin_drain()
    code, body = sc.predict(base, _imgs(1))
    assert code == 503
    assert json.loads(body)["reason"] == "draining"
    assert json.loads(sc.healthz(base)[1])["status"] == "draining"
    t.join(timeout=10)
    assert results["queued"][0] == 200, "in-flight request lost in drain"
    stats = _stop(srv)
    assert stats["flushed"] and len(srv.queue) == 0


def test_sigterm_handler_drains_and_run_returns_zero(artifact):
    """``run()`` serves until the SIGTERM handler sets the stop flag, then
    flushes and returns 0. The handler is invoked directly: a real
    signal would go to the test runner itself."""
    srv = PackedInferenceServer(ServeConfig(
        artifact=artifact, device="cpu", port=0, batch_size=4,
    ))
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", srv.run()))
    t.start()
    _wait_for(lambda: srv._httpd is not None, timeout=30)
    host, port = srv._httpd.server_address[:2]
    assert sc.predict(f"http://{host}:{port}", _imgs(2))[0] == 200
    srv.stop_request._handler(signal.SIGTERM, None)
    t.join(timeout=30)
    assert rc == {"rc": 0}
    assert srv.stop_request.reason == "signal SIGTERM"
    assert srv._httpd is None
