"""The port's ``obs/trace`` against the JAX package's on the same spans:
``tail_attribution``, ``stitch_spans``, ``to_chrome_trace``,
``span_kind_totals``, ``percentile`` and the rendered report give equal
outputs; the tracer's records (nesting, cross-thread parents,
retrospective ``record(t0=, t1=)``, drops) have the JAX records' shape;
the ``x-jg-trace`` header contract parses alike; the trainer's spans
reach ``cli trace``. CPU only."""

import copy
import json
import threading

import numpy as np
import pytest

from distributed_mnist_bnns_tpu.obs import trace as jtrace

from distributed_mnist_bnns_tpu_torch.obs import trace as ptrace
from distributed_mnist_bnns_tpu_torch.obs.registry import MetricsRegistry


def _request_spans(seed=0, n=40, trace_prefix="t"):
    """Request trees of a serving log: queue, assemble, infer, stall and
    respond children under each request root, a sibling shed, a
    zero-length root, a broken parent link."""
    rng = np.random.RandomState(seed)
    spans = []
    for i in range(n):
        tid = f"{trace_prefix}{i:07x}"
        t0 = float(i * 10)
        phases = {k: float(rng.exponential(s)) for k, s in
                  (("queue", 2.0), ("assemble", 0.1), ("stall", 0.5),
                   ("infer", 3.0), ("respond", 0.2))}
        if i % 13 == 0:
            phases["queue"] += 40.0          # a queue-dominated tail
        if i % 17 == 0:
            phases["stall"] += 30.0          # a stall-dominated tail
        total = sum(phases.values()) + float(rng.exponential(0.3))
        root = f"r{i:07x}"
        spans.append({"trace": tid, "span": root, "parent": "client",
                      "name": "serve.request", "span_kind": "request",
                      "t0_ms": t0, "dur_ms": round(total, 3),
                      "status": "ok" if i % 7 else "deadline",
                      "tid": 1, "attrs": {"id": f"n-{i}", "n": 1}})
        t = t0
        for j, (kind, d) in enumerate(phases.items()):
            spans.append({"trace": tid, "span": f"c{i:05x}{j}",
                          "parent": root, "name": f"serve.{kind}",
                          "span_kind": kind, "t0_ms": round(t, 3),
                          "dur_ms": round(d, 3), "status": "ok",
                          "tid": 2})
            t += d
    spans.append({"trace": "shed", "span": "s0", "parent": None,
                  "name": "serve.request", "span_kind": "request",
                  "t0_ms": 5.0, "dur_ms": 0.0, "status": "shed", "tid": 3,
                  "attrs": {"reason": "queue_full"}})
    spans.append({"trace": "t0000000", "span": "orphan", "parent": "gone",
                  "name": "serve.infer", "span_kind": "infer",
                  "t0_ms": 1.0, "dur_ms": 1.0, "status": "ok", "tid": 2})
    return spans


@pytest.mark.parametrize("pct", [50.0, 90.0, 99.0])
def test_tail_attribution_equals_jax(pct):
    spans = _request_spans()
    p = ptrace.tail_attribution(copy.deepcopy(spans), pct=pct)
    j = jtrace.tail_attribution(copy.deepcopy(spans), pct=pct)
    assert p == j and p["n_requests"] == 41
    assert ptrace.render_attribution(p) == jtrace.render_attribution(j)
    assert p["dominant"] in ("queue", "stall", "infer")
    assert ptrace.unresolved_parents(spans) == \
        jtrace.unresolved_parents(spans) == ["orphan"]


def test_chrome_trace_kind_totals_and_percentile_equal_jax():
    spans = _request_spans(seed=1, n=12)
    for kw in ({}, {"pid": 3, "process_name": "replica-a"}):
        assert ptrace.to_chrome_trace(spans, **kw) == \
            jtrace.to_chrome_trace(spans, **kw)
    assert ptrace.span_kind_totals(spans) == jtrace.span_kind_totals(spans)
    vals = sorted(float(s["dur_ms"]) for s in spans)
    for q in (0, 1, 37.5, 50, 99, 100):
        assert ptrace.percentile(vals, q) == jtrace.percentile(vals, q)
    assert ptrace.percentile([], 50) is None
    assert ptrace.children_index(spans) == jtrace.children_index(spans)


def test_stitch_spans_equals_jax():
    """A router's dispatch spans (with a retry) joined to two replicas'
    request roots across the hop."""
    router, rep_a, rep_b = [], [], []
    for i in range(6):
        tid = f"{i:08x}"
        router.append({"trace": tid, "span": f"R{i}", "parent": None,
                       "name": "fleet.request", "span_kind": "request",
                       "t0_ms": 100.0 * i, "dur_ms": 20.0, "tid": 1,
                       "status": "ok"})
        reps = ["a"] if i % 3 else ["b", "a"]    # a retry: b, then a
        for k, rid in enumerate(reps):
            router.append({"trace": tid, "span": f"D{i}{k}",
                           "parent": f"R{i}", "name": "fleet.dispatch",
                           "span_kind": "dispatch",
                           "t0_ms": 100.0 * i + 1 + 5 * k, "dur_ms": 4.0,
                           "tid": 1, "status": "ok",
                           "attrs": {"replica": rid}})
            side = rep_a if rid == "a" else rep_b
            side.append({"trace": tid, "span": f"Q{rid}{i}",
                         "parent": "client", "name": "serve.request",
                         "span_kind": "request", "t0_ms": 7.0 * i,
                         "dur_ms": 3.5, "tid": 9, "status": "ok",
                         "attrs": {"id": f"{rid}-{i}"}})
            side.append({"trace": tid, "span": f"I{rid}{i}",
                         "parent": f"Q{rid}{i}", "name": "serve.infer",
                         "span_kind": "infer", "t0_ms": 7.0 * i + 1,
                         "dur_ms": 2.0, "tid": 9, "status": "ok"})
    rep_b.append({"trace": "lost", "span": "Qx", "parent": None,
                  "name": "serve.request", "span_kind": "request",
                  "t0_ms": 0.0, "dur_ms": 1.0, "tid": 9, "status": "ok"})
    groups = {"router": router, "a": rep_a, "b": rep_b}
    before = copy.deepcopy(groups)
    p = ptrace.stitch_spans(copy.deepcopy(groups))
    j = jtrace.stitch_spans(copy.deepcopy(groups))
    assert p == j
    assert p["joined"] == 8 and p["unjoined"] == ["Qx"]
    assert groups == before
    assert ptrace.tail_attribution(p["spans"]) == \
        jtrace.tail_attribution(j["spans"])


def _shape(rec):
    """A span record without its random ids and thread."""
    return {k: v for k, v in rec.items()
            if k not in ("trace", "span", "parent", "tid")}


def test_tracer_records_have_the_jax_shape():
    recs = []
    for mod in (ptrace, jtrace):
        tr = mod.Tracer(sink=None, registry=None)
        ctx = mod.TraceContext("ab" * 8, "cd" * 8)
        with tr.start("req", kind="request", ctx=ctx, id="x") as root:
            with tr.start("child", kind="queue", n=2):
                pass
            got = []
            th = threading.Thread(target=lambda: got.append(tr.record(
                "later", kind="infer", parent=root, t0=1.5, t1=2.25,
                batch_seq=3)))
            th.start()
            th.join()
        tr.record("fresh", t0=4.0, fresh=True, status="shed")
        tr.record("internal", t0=5.0, t1=5.5)
        recs.append(tr.drain())
    p, j = recs
    assert [_shape(r) for r in p if r["name"] in ("later", "fresh",
                                                  "internal")] == \
        [_shape(r) for r in j if r["name"] in ("later", "fresh", "internal")]
    assert [r["name"] for r in p] == [r["name"] for r in j]
    assert [sorted(r) for r in p] == [sorted(r) for r in j]
    by = {r["name"]: r for r in p}
    assert by["req"]["trace"] == "ab" * 8 and by["req"]["parent"] == "cd" * 8
    assert by["child"]["parent"] == by["req"]["span"]
    assert by["later"]["parent"] == by["req"]["span"]
    assert by["later"]["dur_ms"] == 750.0
    assert by["fresh"]["trace"] != by["req"]["trace"]


def test_drops_claim_once_and_the_disabled_tracer():
    reg = MetricsRegistry()
    tr = ptrace.Tracer(sink=None, capacity=3, registry=reg)
    for i in range(5):
        tr.record(f"s{i}", t0=0.0)
    assert tr.dropped == 2 and len(tr.drain()) == 3
    assert reg.counter(ptrace.SPANS_DROPPED_TOTAL).total() == 2
    span = tr.start("once")
    assert span.end() is True and span.end() is False
    off = ptrace.NULL_TRACER
    assert off.start("x") is ptrace.NULL_SPAN
    assert off.record("x", t0=0.0) is None and off.current() is None


@pytest.mark.parametrize("value", [
    "0123456789abcdef-fedcba9876543210", "  ABCDEF0123456789-0011223344556677 ",
    "abc-def", "", None, "0123456789abcdef", "g123456789abcdef-00112233",
])
def test_header_contract_parses_alike(value):
    assert ptrace.parse_header(value) == (
        None if jtrace.parse_header(value) is None
        else ptrace.TraceContext(*jtrace.parse_header(value)))
    ctx = ptrace.mint_context()
    assert ptrace.parse_header(ptrace.format_header(ctx)) == ctx
    assert ptrace.TRACE_HEADER == jtrace.TRACE_HEADER == "x-jg-trace"


def test_request_ids_are_run_scoped():
    src = ptrace.RequestIdSource(nonce="abcd1234")
    assert [src.next() for _ in range(3)] == [
        "abcd1234-0", "abcd1234-1", "abcd1234-2"]
    a, b = ptrace.next_request_id(), ptrace.next_request_id()
    assert a != b and a.split("-")[0] == b.split("-")[0]


def test_spans_flush_to_the_log_and_load_back(tmp_path):
    from distributed_mnist_bnns_tpu_torch.obs import Telemetry

    tel = Telemetry(str(tmp_path), heartbeat=False, trace=True)
    for i in range(40):
        tel.tracer.record("train.step", kind="step", t0=float(i),
                          t1=i + 0.5, step=i)
    tel.close()
    path = str(tmp_path / "events.jsonl")
    p, j = ptrace.load_spans(path), jtrace.load_spans(path)
    assert p == j and len(p) == 40
    totals = ptrace.span_kind_totals(p)
    assert totals == {"step": {"count": 40, "total_ms": 20000.0}}


def test_trainer_spans_reach_cli_trace(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    td = str(tmp_path / "tel")
    Trainer(TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1}, epochs=1,
        batch_size=32, device="cpu", telemetry_dir=td, trace=True,
        checkpoint_dir=str(tmp_path / "ck"),
    )).fit(load_mnist(None, synthetic_sizes=(128, 32)))
    assert main(["trace", td, "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["n_requests"] == 0
    assert out["kind_totals"]["step"]["count"] == 4
    assert out["kind_totals"]["checkpoint"]["count"] == 1
    export = str(tmp_path / "chrome.json")
    assert main(["trace", td, "--export", export]) == 0
    with open(export) as f:
        chrome = json.load(f)
    assert sum(e.get("cat") == "step" for e in chrome["traceEvents"]) == 4
    assert main(["trace", str(tmp_path / "none")]) == 2
