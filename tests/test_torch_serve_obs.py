"""The telemetry of the port's servers and pipeline on the CPU, held to
the JAX package's contracts: ``/metrics`` (JSON, and Prometheus text by
content negotiation, byte-equal to the JAX renderer on the same
snapshot), ``request`` events with complete span trees, the
``x-jg-trace`` round trip, ``/admin/profile`` (a capture; 409 while
another runs; 400 without a directory), ``/admin/reload`` (bitwise the
same answers, a ``reload`` event), the cost ledger in /healthz, the LM
server's events, metrics, trace header and profile, and the pipeline's
gauges equal to JAX's for (stages, microbatches) (2, 4) and (4, 8)."""

import json
import threading

import jax
import numpy as np
import pytest
import torch

import distributed_mnist_bnns_tpu.obs as jobs
from distributed_mnist_bnns_tpu.parallel.pipeline import (
    make_pipeline_fn as jax_make_pipeline_fn,
)

import distributed_mnist_bnns_tpu_torch.obs as pobs
from distributed_mnist_bnns_tpu_torch.infer import export_packed
from distributed_mnist_bnns_tpu_torch.models import bnn_mlp_small
from distributed_mnist_bnns_tpu_torch.obs.costs import arm_ledger
from distributed_mnist_bnns_tpu_torch.obs.profile import get_profiler
from distributed_mnist_bnns_tpu_torch.obs.trace import (
    TRACE_HEADER,
    TraceContext,
    format_header,
    unresolved_parents,
)
from distributed_mnist_bnns_tpu_torch.serve import (
    PackedInferenceServer,
    ServeConfig,
)
from distributed_mnist_bnns_tpu_torch.serve import client as sc
from distributed_mnist_bnns_tpu_torch.serve.lm import LMServeConfig, LMServer
from distributed_mnist_bnns_tpu_torch.serve.lm import client as lc
from distributed_mnist_bnns_tpu_torch.interop import frozen_to_jax
from distributed_mnist_bnns_tpu_torch.utils import msgpack
from tests.torch_lm_util import frozen_pair


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    model = bnn_mlp_small(
        infl_ratio=1, generator=torch.Generator().manual_seed(0)).eval()
    path = tmp_path_factory.mktemp("obs_artifact") / "m.msgpack"
    export_packed(model, str(path))
    return str(path)


def _server(artifact, tmp_path, **kw):
    srv = PackedInferenceServer(ServeConfig(
        artifact=artifact, device="cpu", port=0, batch_size=4,
        queue_depth=8, default_deadline_ms=5000.0,
        telemetry_dir=str(tmp_path / "tel"), trace=True, **kw))
    host, port = srv.start()
    return srv, f"http://{host}:{port}"


def _stop(srv):
    srv.request_stop("test over")
    return srv.drain_and_stop()


def _imgs(n, seed=0):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).tolist()


def _prom_value(text, line_start):
    for line in text.splitlines():
        if line.startswith(line_start + " "):
            return float(line.rsplit(" ", 1)[1])
    raise AssertionError(f"no series {line_start!r} in:\n{text}")


def test_metrics_events_and_span_trees(artifact, tmp_path):
    srv, base = _server(artifact, tmp_path)
    n = 5
    try:
        for i in range(n):
            assert sc.predict(base, _imgs(1 + i % 3, i),
                              trace=(i % 2 == 0) or None)[0] == 200
        code, body = sc.metrics(base)
        assert code == 200
        snap = json.loads(body)
        ok = [s for s in snap["serve_requests_total"]["series"]
              if s["labels"] == {"status": "ok"}]
        assert ok[0]["value"] == n
        assert snap["serve_batches_total"]["series"][0]["value"] >= 1
        code, text = sc.metrics(base, prometheus=True)
        text = text.decode()
        assert code == 200 and "# TYPE serve_requests_total counter" in text
        assert _prom_value(text, 'serve_requests_total{status="ok"}') == n
        assert _prom_value(text, "serve_batch_seconds_count") >= 1
        # the same snapshot renders byte-equal through the JAX renderer
        now = srv.telemetry.registry.snapshot()
        assert pobs.render_prometheus(now) == jobs.render_prometheus(now)
        health = json.loads(sc.healthz(base)[1])
        assert health["requests"] == {"status=ok": n}
        assert "programs" not in health
    finally:
        _stop(srv)
    path = str(tmp_path / "tel" / "events.jsonl")
    events = pobs.load_events(path)
    kinds = [e["kind"] for e in events]
    assert kinds[0] == "run_manifest" and kinds[-1] == "run_end"
    reqs = [e for e in events if e["kind"] == "request"]
    assert len(reqs) == n and all(e["status"] == "ok" for e in reqs)
    assert {"drain", "metrics"} <= set(kinds)
    spans = pobs.load_spans(path)
    roots = [s for s in spans if s["span_kind"] == "request"]
    assert sorted(s["attrs"]["id"] for s in roots) == \
        sorted(e["id"] for e in reqs)
    kids = pobs.trace.children_index(spans)
    for root in roots:
        got = {s["span_kind"] for s in kids[(root["trace"], root["span"])]}
        assert {"queue", "assemble", "infer", "respond"} <= got, got
    assert unresolved_parents(spans) == []
    assert pobs.tail_attribution(spans)["n_requests"] == n
    assert jobs.summarize(path)["event_counts"] == \
        pobs.summarize(path)["event_counts"]


def test_trace_header_round_trip(artifact, tmp_path):
    srv, base = _server(artifact, tmp_path)
    ctx = TraceContext("0123456789abcdef", "fedcba9876543210")
    try:
        code, _, headers = sc.request_full(
            base + "/predict",
            data=json.dumps({"images": _imgs(1)}).encode(),
            headers={TRACE_HEADER: format_header(ctx)})
        echoed = {k.lower(): v for k, v in headers.items()}[TRACE_HEADER]
        code2, _, h2 = sc.request_full(
            base + "/predict",
            data=json.dumps({"images": _imgs(1)}).encode(),
            headers={TRACE_HEADER: "not-a-trace"})
    finally:
        _stop(srv)
    assert code == code2 == 200
    trace_id, span_id = echoed.split("-")
    assert trace_id == ctx.trace_id and span_id != ctx.span_id
    spans = pobs.load_spans(str(tmp_path / "tel" / "events.jsonl"))
    root = next(s for s in spans if s["span"] == span_id)
    assert root["parent"] == ctx.span_id and root["trace"] == ctx.trace_id
    fresh = {k.lower(): v for k, v in h2.items()}[TRACE_HEADER]
    assert not fresh.startswith(ctx.trace_id)


def test_admin_profile_capture_busy_and_errors(artifact, tmp_path):
    srv, base = _server(artifact, tmp_path)
    prof = get_profiler()
    stop = threading.Event()

    def traffic():
        while not stop.is_set():
            sc.predict(base, _imgs(2))

    th = threading.Thread(target=traffic)
    th.start()
    try:
        code, body = sc.profile(base, 200.0)
        assert code == 200, body
        summary = json.loads(body)
        assert summary["files"] == 1 and summary["total_bytes"] > 0
        cap = pobs.summarize_capture(summary["dir"])
        assert cap["events"] > 0
        prof.start(str(tmp_path / "held"))
        try:
            assert sc.profile(base, 50.0)[0] == 409
        finally:
            prof.stop()
        assert sc.profile(base, -1)[0] == 400
        assert sc._request(base + "/admin/profile",
                           data=b'{"duration_ms": "x"}')[0] == 400
    finally:
        stop.set()
        th.join(10)
        _stop(srv)
    events = pobs.load_events(str(tmp_path / "tel" / "events.jsonl"))
    assert sum(e["kind"] == "profile_capture" for e in events) == 1
    plain = PackedInferenceServer(ServeConfig(
        artifact=artifact, device="cpu", port=0, batch_size=4))
    host, port = plain.start()
    try:
        assert sc.profile(f"http://{host}:{port}", 10.0)[0] == 400
    finally:
        _stop(plain)


def test_admin_reload_and_the_cost_ledger(artifact, tmp_path):
    ledger = arm_ledger(True)
    try:
        srv, base = _server(artifact, tmp_path, costs=True)
        try:
            before = [sc.predict(base, _imgs(2, s))[1] for s in range(3)]
            code, body = sc.reload_artifact(base)
            assert code == 200 and json.loads(body)["reloaded"]
            after = [sc.predict(base, _imgs(2, s))[1] for s in range(3)]
            assert before == after
            assert sc.reload_artifact(base, str(tmp_path / "none"))[0] == 400
            health = json.loads(sc.healthz(base)[1])
        finally:
            _stop(srv)
    finally:
        arm_ledger(False)
    assert not ledger.enabled
    row = health["programs"]["classifier_predict"]
    assert row["flops"] > 0 and row["bytes_accessed"] > 0
    assert row["dispatches"] == 6 and row["mfu"] > 0
    assert row["peak_precision"] == "nominal"
    assert health["device_memory"]["0"]["source"] == "live_arrays"
    events = pobs.load_events(str(tmp_path / "tel" / "events.jsonl"))
    assert sum(e["kind"] == "reload" for e in events) == 1
    # boot and reload each banked the predictor's row
    assert sum(e["kind"] == "program_cost" and not e.get("final")
               for e in events) == 2


@pytest.fixture(scope="module")
def lm_artifact(tmp_path_factory):
    frozen = frozen_pair(seed=0)[1]
    path = tmp_path_factory.mktemp("obs_lm") / "lm.msgpack"
    path.write_bytes(msgpack.msgpack_serialize(frozen_to_jax(frozen)))
    return str(path)


def test_lm_server_metrics_events_trace_and_profile(lm_artifact, tmp_path):
    srv = LMServer(LMServeConfig(
        artifact=lm_artifact, device="cpu", port=0, slots=2, page_size=4,
        prefill_chunk=8, telemetry_dir=str(tmp_path / "tel"), trace=True,
        costs=True))
    try:
        host, port = srv.start()
    except BaseException:
        arm_ledger(False)
        raise
    base = f"http://{host}:{port}"
    srv.engine.decode_event_every = 2
    ctx = TraceContext("aaaabbbbccccdddd", "1111222233334444")
    try:
        code, resp = lc.open_stream(base, [1, 2, 3, 4, 5, 6, 7, 8, 9],
                                    max_new_tokens=6, trace=ctx)
        assert code == 200
        echoed = resp.headers[TRACE_HEADER]
        events = list(lc.iter_lines(resp))
        assert events[-1]["done"] and events[-1]["status"] == "ok"
        assert lc.generate(base, [3, 1], max_new_tokens=4)[0] == 200
        snap = json.loads(lc.metrics(base)[1])
        toks = {tuple(s["labels"].items()): s["value"]
                for s in snap["lm_tokens_total"]["series"]}
        assert toks[(("phase", "prefill"),)] == 11
        assert toks[(("phase", "decode"),)] == 10
        assert snap["lm_requests_total"]["series"][0]["value"] == 2
        text = lc.metrics(base, prometheus=True)[1].decode()
        assert _prom_value(text, 'lm_requests_total{status="ok"}') == 2
        code, body = lc.profile(base, 100.0)
        assert code == 200 and json.loads(body)["files"] == 1
        health = json.loads(lc.healthz(base)[1])
        assert health["kv_pool"]["reserved_bytes"] > 0
        assert health["recompiles_post_warmup"] == 0
    finally:
        arm_ledger(False)
        srv.request_stop("test over")
        srv.drain_and_stop()
    # the warm-up's rows, fed by every prefill and decode since
    programs = health["programs"]
    assert programs["lm_prefill"]["flops"] > 0
    assert programs["lm_decode"]["flops"] > 0
    assert programs["lm_prefill"]["dispatches"] == 3   # 2 + 1 chunks
    assert programs["lm_decode"]["dispatches"] >= 5
    assert echoed.split("-")[0] == ctx.trace_id
    path = str(tmp_path / "tel" / "events.jsonl")
    events = pobs.load_events(path)
    kinds = [e["kind"] for e in events]
    for kind in ("run_manifest", "lm_warmup", "lm_admit", "lm_evict",
                 "lm_decode", "drain", "profile_capture", "run_end"):
        assert kind in kinds, kind
    assert sum(k == "lm_evict" for k in kinds) == 2
    spans = pobs.load_spans(path)
    traced = [s for s in spans if s["trace"] == ctx.trace_id]
    assert {s["span_kind"] for s in traced} >= {
        "request", "queue", "page_alloc", "prefill", "decode"}
    root = next(s for s in traced if s["span_kind"] == "request")
    assert root["parent"] == ctx.span_id
    assert unresolved_parents(spans) == []
    assert any(s["span_kind"] == "decode_iter" for s in spans)


def _jax_gauges(n_stages, n_micro):
    from jax.sharding import Mesh

    mesh = Mesh(np.array(jax.devices()[:n_stages]), ("pipe",))
    jax_make_pipeline_fn(mesh, lambda p, x: x, n_micro=n_micro)
    snap = jobs.default_registry().snapshot()
    return {name: snap[name]["series"] for name in (
        "pipeline_stages", "pipeline_microbatches",
        "pipeline_bubble_fraction")}


def test_pipeline_gauges_equal_jax():
    from distributed_mnist_bnns_tpu_torch.parallel import spawn
    from tests import torch_mp_util as util

    cases = [(2, 4), (4, 8)]
    ranks = spawn(util.pipeline_gauges_run, 4, backend="gloo",
                  device="cpu", args=(cases,))
    for rank in ranks:
        for (n_stages, n_micro), got in zip(cases, rank):
            want = _jax_gauges(n_stages, n_micro)
            for name, series in want.items():
                assert got[name] == series, (name, n_stages, n_micro)
            assert got["pipeline_bubble_fraction"][0]["value"] == \
                (n_stages - 1) / (n_micro + n_stages - 1)
        assert [g["pipeline_calls_total"][0]["value"] for g in rank] == \
            [1.0, 2.0]
