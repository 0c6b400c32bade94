"""The PyTorch port's continuous-batching LM server on ``device="cpu"``.

The tiny LM of ``tests/test_lm_serve.py`` (weights from a numpy seed,
carried from the JAX package) is exported and served. Every stream must
equal the port's own ``generate`` for its prompt alone (token for token:
the projections are exact integer sums and every other op is per row).
The cases follow the JAX package's tests/test_lm_serve.py; where those
use fault injection (not in the port yet), these slow the decoder down.
"""

import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

from distributed_mnist_bnns_tpu_torch.infer_transformer import (
    generate,
    make_lm_decoder,
    make_paged_lm_decoder,
)
from distributed_mnist_bnns_tpu_torch.serve.lm import (
    LMEngine,
    LMServeConfig,
    LMServer,
)
from distributed_mnist_bnns_tpu_torch.interop import frozen_to_jax
from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc
from distributed_mnist_bnns_tpu_torch.utils import msgpack
from tests.torch_lm_util import frozen_pair, tokens


@pytest.fixture(scope="module")
def frozen():
    return frozen_pair(seed=0)[1]


@pytest.fixture(scope="module")
def artifact(frozen, tmp_path_factory):
    path = tmp_path_factory.mktemp("lm_artifact") / "lm.msgpack"
    path.write_bytes(msgpack.msgpack_serialize(frozen_to_jax(frozen)))
    return str(path)


@pytest.fixture(scope="module")
def oracle(frozen):
    decoder = make_lm_decoder(frozen, device="cpu")

    def want(prompt, n):
        out = generate(frozen, np.asarray(prompt)[None], n, decoder=decoder)
        return out[0, len(prompt):].tolist()

    return want


def _server(artifact, **kw):
    kw.setdefault("port", 0)
    kw.setdefault("slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("prefill_chunk", 8)
    srv = LMServer(LMServeConfig(artifact=artifact, device="cpu", **kw))
    host, port = srv.start()
    return srv, f"http://{host}:{port}"


def _stop(srv):
    srv.request_stop("test over")
    return srv.drain_and_stop()


def _slow_decode(srv, seconds):
    dec = srv.engine.decoder
    inner = dec.decode

    def decode(*args):
        time.sleep(seconds)
        return inner(*args)

    srv.engine.decoder = dec._replace(decode=decode)


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.005)


def _tokens_of(events):
    assert events[-1]["done"] and events[-1]["status"] == "ok", events[-1]
    return [e["token"] for e in events[:-1]]


def test_engine_streams_equal_generate_and_free_their_pages(frozen, oracle):
    """Four staggered requests through two slots: later ones wait for
    freed slots and join mid-generation."""
    dec = make_paged_lm_decoder(frozen, slots=2, page_size=4,
                                prefill_chunk=8, device="cpu")
    eng = LMEngine(dec, queue_depth=8).start()
    try:
        jobs = [(tokens(s, plen), n) for s, (plen, n) in
                enumerate([(3, 9), (9, 4), (17, 6), (1, 12)])]
        reqs = [eng.submit(p, n, time.monotonic() + 60) for p, n in jobs]
        for req, (prompt, n) in zip(reqs, jobs):
            got = []
            while True:
                ev = req.events.get(timeout=60)
                if ev["kind"] == "done":
                    break
                got.append(ev["token"])
            assert ev["status"] == "ok" and got == oracle(prompt, n)
        _wait_for(lambda: eng.active_streams == 0)
        assert eng.allocator.used_count() == 0
        m = eng.metrics()
        assert m["lm_requests_total"] == {"status=ok": 4}
        assert m["lm_tokens_total"]["phase=decode"] == 9 + 4 + 6 + 12
        assert m["lm_tokens_total"]["phase=prefill"] == 3 + 9 + 17 + 1
        assert m["lm_active_streams"] == 0 and m["lm_page_occupancy"] == 0
    finally:
        eng.stop()


def test_http_streams_concurrent_requests(artifact, frozen, oracle):
    srv, base = _server(artifact)
    jobs = [(tokens(10, 5), 7), (tokens(11, 13), 5), (tokens(12, 20), 6)]
    results = {}

    def ask(i, prompt, n):
        results[i] = lc.generate(base, [int(t) for t in prompt],
                                 max_new_tokens=n)

    threads = [threading.Thread(target=ask, args=(i, p, n))
               for i, (p, n) in enumerate(jobs)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for i, (prompt, n) in enumerate(jobs):
            code, events = results[i]
            assert code == 200
            assert _tokens_of(events) == oracle(prompt, n)
            assert [e["i"] for e in events[:-1]] == list(range(n))
        # "text" is its UTF-8 bytes mod vocab
        code, events = lc.generate(base, "hi!", max_new_tokens=4)
        prompt = [b % 32 for b in "hi!".encode()]
        assert code == 200 and _tokens_of(events) == oracle(prompt, 4)
        health = json.loads(lc.healthz(base)[1])
        assert health["status"] == "ok" and health["kernels"]
        assert health["device"] == "cpu" and health["pages_in_use"] == 0
    finally:
        stats = _stop(srv)
    assert stats["flushed"] and stats["pages_in_use"] == 0
    assert stats["requests_total"] == 4


def test_bad_inputs(artifact):
    srv, base = _server(artifact)
    try:
        assert lc.generate(base, [])[0] == 400
        assert lc.generate(base, [40])[0] == 400          # outside vocab
        assert lc.generate(base, [[1, 2]])[0] == 400
        assert lc.generate(base, [1] * 32)[0] == 413      # max_len - 1 = 31
        assert lc.generate(base, [1], max_new_tokens=0)[0] == 400
        assert lc.generate(base, [1], temperature=-1)[0] == 400
        assert lc.generate(base, [1], deadline_ms=-5)[0] == 400
        assert lc.generate(base, [1], seed=-1)[0] == 400
        code, events = lc.generate(base, [1, 2], max_new_tokens=3,
                                   temperature=0.7, seed=3)
        assert code == 200 and len(events) == 4           # sampled stream
    finally:
        _stop(srv)


def test_queue_full_sheds_503(artifact):
    srv, base = _server(artifact, slots=1, queue_depth=1)
    _slow_decode(srv, 0.05)
    results = {}

    def ask(key):
        results[key] = lc.generate(base, [1, 2, 3], max_new_tokens=20)

    first = threading.Thread(target=ask, args=("first",))
    second = threading.Thread(target=ask, args=("second",))
    try:
        first.start()
        _wait_for(lambda: srv.engine.active_streams == 1)
        second.start()
        _wait_for(lambda: srv.engine.queue_len == 1)
        code, body = lc.generate(base, [4], max_new_tokens=2)
        assert code == 503 and body[0]["reason"] == "queue_full"
        first.join(30)
        second.join(30)
        assert results["first"][0] == 200 and results["second"][0] == 200
    finally:
        _stop(srv)
    assert srv.engine.shed_ctr.snapshot() == {"reason=queue_full": 1}


def test_queued_deadline_504_never_takes_pages(artifact):
    srv, base = _server(artifact, slots=1)
    _slow_decode(srv, 0.05)
    holder = threading.Thread(
        target=lambda: lc.generate(base, [1, 2], max_new_tokens=20))
    try:
        holder.start()
        _wait_for(lambda: srv.engine.active_streams == 1)
        pages = srv.engine.allocator.used_count()
        t0 = time.monotonic()
        code, body = lc.generate(base, [3, 4], max_new_tokens=4,
                                 deadline_ms=200)
        assert code == 504 and time.monotonic() - t0 < 0.9
        assert srv.engine.allocator.used_count() == pages
        holder.join(30)
        _wait_for(lambda: srv.engine.allocator.used_count() == 0)
    finally:
        _stop(srv)
    assert srv.engine.requests_ctr.snapshot()["status=deadline"] == 1


def test_mid_stream_deadline_ends_the_stream_and_frees_pages(artifact):
    srv, base = _server(artifact)
    _slow_decode(srv, 0.05)
    try:
        code, events = lc.generate(base, [5, 6, 7], max_new_tokens=25,
                                   deadline_ms=400)
        assert code == 200
        assert events[-1]["done"] and events[-1]["status"] == "deadline"
        assert 1 <= events[-1]["n"] < 25
        _wait_for(lambda: srv.engine.allocator.used_count() == 0)
    finally:
        _stop(srv)


def test_drain_rejects_new_work_but_finishes_streams(artifact, oracle):
    srv, base = _server(artifact)
    _slow_decode(srv, 0.02)
    results = {}
    t = threading.Thread(target=lambda: results.setdefault(
        "stream", lc.generate(base, [9, 8, 7], max_new_tokens=10)))
    t.start()
    _wait_for(lambda: srv.engine.active_streams == 1)
    srv.engine.begin_drain()
    code, body = lc.generate(base, [1], max_new_tokens=2)
    assert code == 503 and body[0]["reason"] == "draining"
    assert json.loads(lc.healthz(base)[1])["status"] == "draining"
    t.join(30)
    code, events = results["stream"]
    assert code == 200 and _tokens_of(events) == oracle([9, 8, 7], 10)
    stats = _stop(srv)
    assert stats["flushed"] and stats["pages_in_use"] == 0


def test_sigterm_handler_drains_and_run_returns_zero(artifact):
    srv = LMServer(LMServeConfig(artifact=artifact, device="cpu", port=0,
                                 slots=2, page_size=4, prefill_chunk=8))
    rc = {}
    t = threading.Thread(target=lambda: rc.setdefault("rc", srv.run()))
    t.start()
    _wait_for(lambda: srv._httpd is not None, timeout=30)
    host, port = srv._httpd.server_address[:2]
    assert lc.generate(f"http://{host}:{port}", [1, 2],
                       max_new_tokens=3)[0] == 200
    srv.stop_request._handler(signal.SIGTERM, None)
    t.join(timeout=30)
    assert rc == {"rc": 0} and srv._httpd is None


def test_server_defaults_to_cuda_and_refuses_non_lm(artifact, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert LMServeConfig(artifact=artifact).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LMServer(LMServeConfig(artifact=artifact)).start()
    other = tmp_path / "mlp.msgpack"
    other.write_bytes(msgpack.msgpack_serialize({"family": "bnn-mlp"}))
    with pytest.raises(ValueError, match="not a packed LM"):
        LMServer(LMServeConfig(artifact=str(other), device="cpu")).start()
