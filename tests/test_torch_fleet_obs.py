"""The port's fleet observability plane (``obs/aggregate.py``,
``obs/slo.py``, the fleet read side of ``obs/summary.py``, the router's
decisions, ``cli fleet explain``, ``telemetry --fleet`` and multi-dir
``trace``) against the JAX package's tests/test_fleet_obs.py, case for
case: registry-snapshot merge semantics (counters sum, gauges fan out,
histograms merge their cumulative le buckets EXACTLY vs a pooled single
registry), the scraped-store /metrics + /healthz rollup, SLO burn-rate
alerting through open->close transitions on an injected clock, the
control-plane decision audit trail, cross-process trace stitching, and
the CLI surfaces. The last cases hold the port's outputs byte-equal to
the JAX package's on the same replica texts and event logs: the
fleet-merged Prometheus text and JSON, the SLO records, gauges and
summary, and the decision timeline and fleet summary.
"""

import json
import os

import numpy as np
import pytest

from distributed_mnist_bnns_tpu_torch.obs import (
    MetricsRegistry,
    SLOMonitor,
    SLOSpec,
    decision_timeline,
    default_fleet_slos,
    healthz_rollup,
    merge_snapshots,
    render_decision_timeline,
    render_fleet_table,
    render_prometheus,
    stitch_spans,
    summarize_fleet,
)
from distributed_mnist_bnns_tpu_torch.obs.aggregate import (
    FleetMetricsStore,
    FleetMetricsView,
)
from distributed_mnist_bnns_tpu_torch.serve.fleet import (
    Autoscaler,
    FleetView,
    RouterCore,
)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


# ---------------------------------------------------------------------------
# merge_snapshots


def test_merge_counters_sum_by_label_key():
    regs = [MetricsRegistry() for _ in range(3)]
    for i, reg in enumerate(regs):
        c = reg.counter("requests_total", "served")
        c.inc(10 * (i + 1), status="ok")
        c.inc(i, status="error")
    merged = merge_snapshots({
        f"replica-{i}": reg.snapshot() for i, reg in enumerate(regs)
    })
    series = {
        tuple(sorted(s["labels"].items())): s["value"]
        for s in merged["requests_total"]["series"]
    }
    assert series[(("status", "ok"),)] == 60.0
    assert series[(("status", "error"),)] == 3.0
    assert merged["requests_total"]["type"] == "counter"
    assert merged.conflicts == []


def test_merge_gauges_fan_out_plus_fleet_envelope():
    regs = {}
    for name, depth in (("replica-0", 2.0), ("replica-1", 7.0)):
        reg = MetricsRegistry()
        reg.gauge("queue_depth", "admission queue").set(depth)
        regs[name] = reg.snapshot()
    merged = merge_snapshots(regs)
    rows = {
        tuple(sorted(s["labels"].items())): s["value"]
        for s in merged["queue_depth"]["series"]
    }
    assert rows[(("replica", "replica-0"),)] == 2.0
    assert rows[(("replica", "replica-1"),)] == 7.0
    assert rows[(("agg", "min"), ("replica", "fleet"))] == 2.0
    assert rows[(("agg", "max"), ("replica", "fleet"))] == 7.0
    assert rows[(("agg", "sum"), ("replica", "fleet"))] == 9.0


def test_merge_histograms_exact_vs_pooled_registry():
    """The exactness pin: merged cumulative le buckets +
    _sum/_count over N replica snapshots must equal one registry fed
    the pooled observations."""
    buckets = (0.001, 0.01, 0.1, 1.0)
    observations = {
        "replica-0": [0.0005, 0.004, 0.05, 0.3, 5.0],
        "replica-1": [0.002, 0.02, 0.02, 0.9],
        "replica-2": [0.7, 2.0, 0.0001],
    }
    pooled = MetricsRegistry()
    pooled_h = pooled.histogram("latency_s", "e2e", buckets=buckets)
    sources = {}
    for rid, vals in observations.items():
        reg = MetricsRegistry()
        h = reg.histogram("latency_s", "e2e", buckets=buckets)
        for v in vals:
            h.observe(v)
            pooled_h.observe(v)
        sources[rid] = reg.snapshot()
    merged = merge_snapshots(sources)
    want = pooled.snapshot()["latency_s"]
    got = merged["latency_s"]
    assert got["buckets"] == list(want["buckets"])
    (grow,), (wrow,) = got["series"], want["series"]
    assert grow["bucket_counts"] == wrow["bucket_counts"]
    assert grow["count"] == wrow["count"]
    assert grow["sum"] == pytest.approx(wrow["sum"])
    assert grow["min"] == pytest.approx(wrow["min"])
    assert grow["max"] == pytest.approx(wrow["max"])
    # ... and the merged snapshot renders through the stock Prometheus
    # path identically to the pooled registry (cumulative le series;
    # _sum compares as float — summation order differs in the last ulp).
    for gline, wline in zip(
        render_prometheus({"latency_s": got}).splitlines(),
        render_prometheus({"latency_s": want}).splitlines(),
    ):
        if gline.startswith("latency_s_sum"):
            assert (float(gline.rsplit(" ", 1)[1])
                    == pytest.approx(float(wline.rsplit(" ", 1)[1])))
        else:
            assert gline == wline


def test_merge_histogram_bucket_mismatch_dropped_not_approximated():
    a = MetricsRegistry()
    a.histogram("lat", "x", buckets=(0.1, 1.0)).observe(0.05)
    b = MetricsRegistry()
    b.histogram("lat", "x", buckets=(0.2, 2.0)).observe(0.05)
    merged = merge_snapshots({"r0": a.snapshot(), "r1": b.snapshot()})
    (row,) = merged["lat"]["series"]
    assert row["count"] == 1            # only r0 contributed
    assert any("r1/lat" in c for c in merged.conflicts)


def test_merge_type_conflict_keeps_first_seen():
    a = MetricsRegistry()
    a.counter("thing", "x").inc(1)
    b = MetricsRegistry()
    b.gauge("thing", "x").set(9)
    merged = merge_snapshots({"r0": a.snapshot(), "r1": b.snapshot()})
    assert merged["thing"]["type"] == "counter"
    assert any("r1/thing" in c for c in merged.conflicts)


def test_merge_deterministic_prometheus_text():
    regs = {}
    for rid in ("replica-1", "replica-0"):
        reg = MetricsRegistry()
        reg.counter("n", "x").inc(1, src=rid)
        reg.gauge("g", "x").set(1.0)
        regs[rid] = reg.snapshot()
    one = render_prometheus(merge_snapshots(regs))
    two = render_prometheus(merge_snapshots(
        dict(reversed(list(regs.items())))
    ))
    assert one == two


# ---------------------------------------------------------------------------
# store / view / healthz rollup


def test_fleet_store_and_view_merge_local_plus_scraped():
    clock = FakeClock()
    store = FleetMetricsStore(clock=clock)
    local = MetricsRegistry()
    local.counter("fleet_requests_total", "routed").inc(5)
    rep = MetricsRegistry()
    rep.counter("requests_total", "served").inc(7)
    store.update("replica-0", snapshot=rep.snapshot(),
                 healthz={"status": "ok"})
    view = FleetMetricsView(local, store)
    snap = view.snapshot()
    assert snap["fleet_requests_total"]["series"][0]["value"] == 5.0
    assert snap["requests_total"]["series"][0]["value"] == 7.0
    clock.advance(2.5)
    status = store.status()
    assert status["replicas_scraped"] == 1
    assert status["scrape_age_s"]["replica-0"] == pytest.approx(2.5)
    store.discard("replica-0")
    assert "requests_total" not in view.snapshot()


def test_fleet_store_error_then_recovery():
    store = FleetMetricsStore(clock=FakeClock())
    store.update("replica-0", error="ConnectionError: dead")
    assert store.status()["scrape_errors"] == {
        "replica-0": "ConnectionError: dead"
    }
    store.update("replica-0", snapshot={}, healthz={"status": "ok"})
    assert store.status()["scrape_errors"] == {}


def test_healthz_rollup_worst_status_and_counts():
    rows = [
        {"id": "replica-0", "healthy": True},
        {"id": "replica-1", "healthy": False},
    ]
    healthz = {
        "replica-0": {"status": "ok", "queue_depth": 1},
        "replica-1": {"status": "draining"},
    }
    roll = healthz_rollup(rows, healthz)
    assert roll["replicas_total"] == 2
    assert roll["replicas_healthy"] == 1
    assert roll["status"] == "draining"
    by_id = {r["id"]: r for r in roll["replicas"]}
    assert by_id["replica-0"]["status"] == "ok"
    assert by_id["replica-1"]["scraped"]["status"] == "draining"
    # all healthy -> ok; none -> failed
    assert healthz_rollup(
        [{"id": "r", "healthy": True}], {}
    )["status"] == "ok"
    assert healthz_rollup(
        [{"id": "r", "healthy": False}], {}
    )["status"] == "failed"
    assert healthz_rollup([], {})["status"] == "unknown"


# ---------------------------------------------------------------------------
# SLO burn-rate alerting (injected clock)


def _slo_spec(**kw):
    base = dict(
        name="availability", objective=0.99, signal="availability",
        fast_window_s=10.0, slow_window_s=60.0, min_events=10,
    )
    base.update(kw)
    return SLOSpec(**base)


def test_slo_opens_pages_and_closes_on_injected_clock():
    clock = FakeClock()
    reg = MetricsRegistry()
    events = []
    mon = SLOMonitor(
        [_slo_spec()], registry=reg,
        emit=lambda kind, **f: events.append({"kind": kind, **f}),
        clock=clock,
    )
    # Healthy traffic: no alert.
    for _ in range(50):
        mon.observe_request(True)
        clock.advance(0.1)
    assert mon.evaluate() == []
    assert mon.state("availability") == "ok"
    # Total outage: both windows burn far past 14.4x / 6x.
    for _ in range(50):
        mon.observe_request(False)
        clock.advance(0.1)
    (tr,) = mon.evaluate()
    assert tr["state"] == "open" and tr["slo"] == "availability"
    assert tr["severity"] == "page"
    assert tr["burn_fast"] >= 14.4 and tr["burn_slow"] >= 6.0
    assert mon.open_alerts() == ["availability"]
    # Idempotent while still burning.
    assert mon.evaluate() == []
    # Recovery: the fast window forgets quickly -> close.
    for _ in range(200):
        mon.observe_request(True)
        clock.advance(0.1)
    (tr,) = mon.evaluate()
    assert tr["state"] == "close"
    assert mon.state("availability") == "ok"
    # Events + gauges + counter all saw both transitions.
    assert [e["state"] for e in events
            if e["kind"] == "slo_alert"] == ["open", "close"]
    snap = reg.snapshot()
    assert "slo_burn_rate" in snap and "slo_budget_remaining" in snap
    totals = {
        tuple(sorted(s["labels"].items())): s["value"]
        for s in snap["slo_alerts_total"]["series"]
    }
    assert totals[(("slo", "availability"), ("state", "open"))] == 1.0
    assert totals[(("slo", "availability"), ("state", "close"))] == 1.0
    summary = mon.summary()
    assert summary["availability"]["alerts_opened"] == 1
    assert summary["availability"]["alerts_closed"] == 1
    assert summary["availability"]["state"] == "ok"


def test_slo_needs_min_events_and_both_windows():
    clock = FakeClock()
    mon = SLOMonitor([_slo_spec(min_events=10)], clock=clock)
    # 5 failures: burn is huge but n_fast < min_events -> no page.
    for _ in range(5):
        mon.observe_request(False)
        clock.advance(0.1)
    assert mon.evaluate() == []
    # Old failures beyond the fast window but inside the slow one:
    # slow burn alone must NOT open.
    clock.advance(15.0)
    for _ in range(20):
        mon.observe_request(True)
        clock.advance(0.1)
    assert mon.evaluate() == []
    assert mon.state("availability") == "ok"


def test_slo_latency_signal_counts_slow_and_failed_as_bad():
    clock = FakeClock()
    mon = SLOMonitor(
        [_slo_spec(name="request_p99", signal="latency",
                   threshold_ms=100.0)],
        clock=clock,
    )
    for _ in range(20):
        mon.observe_request(True, latency_ms=500.0)   # slow = bad
        clock.advance(0.1)
    (tr,) = mon.evaluate()
    assert tr["state"] == "open" and tr["slo"] == "request_p99"
    mon2 = SLOMonitor(
        [_slo_spec(name="request_p99", signal="latency",
                   threshold_ms=100.0)],
        clock=clock,
    )
    for _ in range(20):
        mon2.observe_request(False, latency_ms=5.0)   # fast-and-broken
        clock.advance(0.1)
    assert mon2.evaluate()[0]["state"] == "open"


def test_slo_token_stream_routed_separately():
    clock = FakeClock()
    mon = SLOMonitor(default_fleet_slos(fast_window_s=5.0,
                                        slow_window_s=30.0),
                     clock=clock)
    for _ in range(20):
        mon.observe_token(inter_token_ms=2000.0)
        clock.advance(0.1)
    (tr,) = mon.evaluate()
    assert tr["slo"] == "lm_inter_token_p99"
    assert mon.summary()["availability"]["events_total"] == 0


def test_slo_spec_validation():
    with pytest.raises(ValueError):
        SLOSpec("x", 1.5)
    with pytest.raises(ValueError):
        SLOSpec("x", 0.99, signal="latency")     # no threshold
    with pytest.raises(ValueError):
        SLOSpec("x", 0.99, fast_window_s=60.0, slow_window_s=60.0)
    with pytest.raises(ValueError):
        SLOMonitor([_slo_spec(), _slo_spec()])   # duplicate names


# ---------------------------------------------------------------------------
# control-plane decision audit


def test_autoscaler_last_decision_carries_inputs():
    clock = FakeClock()
    a = Autoscaler(queue_high=4.0, queue_low=0.5, sustain_s=1.0,
                   cooldown_s=3.0, clock=clock)
    view = FleetView(min_replicas=1, max_replicas=4, target=2)
    assert a.observe(view, queue_depth=10.0, shed_rate=0.0) is None
    d = a.last_decision
    assert d["action"] == "hold" and d["reason"] == "sustaining"
    assert d["queue_depth"] == 10.0 and d["queue_high"] == 4.0
    clock.advance(1.5)
    assert a.observe(view, queue_depth=10.0, shed_rate=0.0) == 3
    d = a.last_decision
    assert d["action"] == "scale_up" and d["reason"] == "queue_high"
    view.target = 3
    # Inside cooldown: the previously-invisible None now explains itself.
    clock.advance(0.5)
    assert a.observe(view, queue_depth=10.0, shed_rate=0.0) is None
    d = a.last_decision
    assert d["action"] == "hold" and d["reason"] == "cooldown"
    assert d["cooldown_remaining_s"] > 0
    # At max: sustained pressure but nowhere to go.
    view.target = 4
    clock.advance(10.0)
    a.observe(view, queue_depth=10.0, shed_rate=1.0)
    clock.advance(1.5)
    assert a.observe(view, queue_depth=10.0, shed_rate=1.0) is None
    assert a.last_decision["reason"] == "at_max"


class _FakeTransport:
    """Scriptable replica transport for router decision tests."""

    def __init__(self):
        self.healthy = True
        self.registry = MetricsRegistry()
        self.registry.counter("requests_total", "served").inc(3)

    def request(self, method, path, body, headers, timeout):
        if not self.healthy:
            raise ConnectionError("down")
        if path == "/healthz":
            return 200, json.dumps(
                {"status": "ok", "queue_depth": 0}
            ).encode(), {}
        if path == "/metrics":
            return 200, json.dumps(self.registry.snapshot()).encode(), {}
        return 200, b'{"ok": true}', {}


class _ListTelemetry:
    def __init__(self):
        self.events = []
        self.registry = MetricsRegistry()

    def emit(self, kind, **fields):
        self.events.append({"kind": kind, **fields})

    def of_kind(self, kind):
        return [e for e in self.events if e["kind"] == kind]


def test_router_eject_readmit_emit_decisions_and_scrape_feeds_store():
    telem = _ListTelemetry()
    router = RouterCore(telemetry=telem, breaker_threshold=2,
                        breaker_reset_s=0.05)
    t = _FakeTransport()
    router.add_replica("replica-0", t)
    router.probe_replicas()
    router.scrape_replicas()
    snap = router.metrics_store.snapshots()
    assert snap["replica-0"]["requests_total"]["series"][0]["value"] == 3
    assert router.metrics_store.healthz()["replica-0"]["status"] == "ok"
    t.healthy = False
    router.probe_replicas()
    eject = [e for e in telem.of_kind("decision")
             if e["action"] == "eject"]
    assert eject and eject[0]["replica"] == "replica-0"
    assert "reason" in eject[0]["inputs"]
    router.scrape_replicas()
    assert "replica-0" in router.metrics_store.status()["scrape_errors"]
    t.healthy = True
    router.probe_replicas()
    readmit = [e for e in telem.of_kind("decision")
               if e["action"] == "readmit"]
    assert readmit and readmit[0]["replica"] == "replica-0"
    # The timeline renderer accepts these raw events directly.
    rows = decision_timeline(telem.events)
    assert [r["action"] for r in rows] == ["eject", "readmit"]
    text = render_decision_timeline(rows, title="t")
    assert "[router]" in text and "eject replica-0" in text


# ---------------------------------------------------------------------------
# cross-process trace stitching


def _span(trace, span, name, kind, t0, dur, parent=None, **attrs):
    return {
        "trace": trace, "span": span, "parent": parent, "name": name,
        "span_kind": kind, "t0_ms": float(t0), "dur_ms": float(dur),
        "status": "ok", "attrs": attrs,
    }


def _fleet_span_groups():
    """Router + one replica, two requests, per-process clocks."""
    router = [
        _span("t1", "r1", "fleet.request", "request", 1000.0, 50.0),
        _span("t1", "d1", "fleet.dispatch", "dispatch", 1010.0, 35.0,
              parent="r1", replica="replica-0"),
        _span("t2", "r2", "fleet.request", "request", 1100.0, 40.0),
        _span("t2", "d2", "fleet.dispatch", "dispatch", 1105.0, 30.0,
              parent="r2", replica="replica-0"),
    ]
    replica = [
        # Replica clock starts near zero — a different monotonic lane.
        _span("t1", "s1", "serve.request", "request", 5.0, 30.0),
        _span("t1", "q1", "serve.queue", "queue", 6.0, 10.0,
              parent="s1"),
        _span("t1", "i1", "serve.infer", "infer", 16.0, 15.0,
              parent="s1"),
        _span("t2", "s2", "serve.request", "request", 100.0, 25.0,
              parent="zz-client-span"),
        _span("t2", "i2", "serve.infer", "infer", 105.0, 18.0,
              parent="s2"),
    ]
    return {"router": router, "replica-0": replica}


def test_stitch_spans_joins_and_time_shifts():
    groups = _fleet_span_groups()
    out = stitch_spans(groups)
    assert out["joined"] == 2 and out["replica_roots"] == 2
    assert out["unjoined"] == []
    by_id = {s["span"]: s for s in out["spans"]}
    # Replica roots re-parented under their dispatches, demoted.
    assert by_id["s1"]["parent"] == "d1"
    assert by_id["s2"]["parent"] == "d2"
    assert by_id["s1"]["span_kind"] == "replica_request"
    # Subtrees shifted onto the router clock lane: s1 starts at d1.t0,
    # children keep their relative offsets.
    assert by_id["s1"]["t0_ms"] == 1010.0
    assert by_id["q1"]["t0_ms"] == 1011.0
    assert by_id["i1"]["t0_ms"] == 1021.0
    assert by_id["s2"]["t0_ms"] == 1105.0
    # Router spans untouched; every span tagged with its process.
    assert by_id["r1"]["t0_ms"] == 1000.0
    assert by_id["r1"]["attrs"]["process"] == "router"
    assert by_id["i1"]["attrs"]["process"] == "replica-0"
    # Inputs never mutated.
    assert groups["replica-0"][0]["parent"] is None
    assert groups["replica-0"][0]["span_kind"] == "request"


def test_stitch_spans_tail_attribution_splits_hop():
    from distributed_mnist_bnns_tpu_torch.obs.trace import tail_attribution

    out = stitch_spans(_fleet_span_groups())
    report = tail_attribution(out["spans"], pct=0.0)
    # Exactly the two ROUTER roots survive as request roots.
    assert report["n_requests"] == 2
    agg = report["aggregate_ms"]
    # Router-side hop time and replica-side time both attributed —
    # dispatch self-time is the hop, infer/queue/replica_request is
    # replica-side.
    assert agg.get("dispatch", 0) > 0
    assert agg.get("infer", 0) > 0
    assert agg.get("replica_request", 0) > 0


def test_stitch_spans_fallback_join_and_unjoined():
    groups = _fleet_span_groups()
    # Dir named differently from the rid: unambiguous trace-only join.
    groups["some-dir"] = groups.pop("replica-0")
    out = stitch_spans(groups)
    assert out["joined"] == 2 and out["unjoined"] == []
    # No dispatches at all -> roots stay unjoined, not dropped.
    out2 = stitch_spans(
        {"replica-0": _fleet_span_groups()["replica-0"]}
    )
    assert out2["joined"] == 0
    assert len(out2["unjoined"]) == 2
    assert len(out2["spans"]) == 5


# ---------------------------------------------------------------------------
# CLI surfaces + fleet summary readers


def _write_events(path, events):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps({"v": 1, "ts": "2026-08-06T00:00:01Z",
                                **ev}) + "\n")


def _fleet_log_tree(tmp_path):
    root = tmp_path / "fleet-telemetry"
    _write_events(str(root / "events.jsonl"), [
        {"kind": "decision", "actor": "router", "action": "eject",
         "replica": "replica-0", "inputs": {"reason": "probe_error"}},
        {"kind": "decision", "actor": "supervisor", "action": "respawn",
         "replica": "replica-0", "inputs": {"rc": -9, "backoff_s": 0.1}},
        {"kind": "slo_alert", "slo": "availability", "state": "open",
         "burn_fast": 99.0, "burn_slow": 42.0, "events_fast": 31,
         "budget_remaining": 0.2, "severity": "page"},
        {"kind": "request", "status": "ok"},
    ] + [s | {"kind": "span"} for s in _fleet_span_groups()["router"]])
    _write_events(str(root / "replica-0" / "events.jsonl"), [
        {"kind": "request", "status": "ok"},
        {"kind": "error", "error": "boom"},
    ] + [s | {"kind": "span"}
         for s in _fleet_span_groups()["replica-0"]])
    return root


def test_summarize_fleet_and_render(tmp_path):
    root = _fleet_log_tree(tmp_path)
    combined = summarize_fleet(str(root))
    assert combined["fleet"]["replica_logs"] == 1
    assert sorted(combined["replicas"]) == ["replica-0"]
    assert combined["fleet"]["decisions"] == 2
    assert combined["fleet"]["slo_alerts"] == 1
    assert combined["fleet"]["event_counts"]["request"] == 2
    assert combined["fleet"]["errors_total"] == 1
    text = render_fleet_table(combined)
    assert "combined" in text and "replica-0" in text
    with pytest.raises(FileNotFoundError):
        summarize_fleet(str(tmp_path / "nope"))


def test_cli_fleet_explain(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    root = _fleet_log_tree(tmp_path)
    assert main(["fleet", "explain", str(root)]) == 0
    out = capsys.readouterr().out
    assert "fleet decision timeline" in out
    assert "[router]" in out and "[supervisor]" in out
    assert "open availability" in out
    assert main(["fleet", "explain", str(root), "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)
    assert [r["action"] for r in rows] == [
        "eject", "respawn", "open availability",
    ]
    assert main(["fleet", "explain", str(tmp_path / "nope")]) == 2


def test_cli_fleet_requires_artifact_or_explain(tmp_path):
    from distributed_mnist_bnns_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["fleet"])                       # no artifact, no action
    with pytest.raises(SystemExit):
        main(["fleet", "frobnicate", str(tmp_path)])


def test_cli_telemetry_fleet(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    root = _fleet_log_tree(tmp_path)
    assert main(["telemetry", str(root), "--fleet"]) == 0
    assert "replica-0" in capsys.readouterr().out
    assert main(
        ["telemetry", str(root), "--fleet", "--json"]
    ) == 0
    data = json.loads(capsys.readouterr().out)
    assert data["fleet"]["decisions"] == 2


def test_cli_trace_multi_dir_stitches(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    root = _fleet_log_tree(tmp_path)
    rc = main([
        "trace", str(root), str(root / "replica-0"),
    ])
    assert rc == 0
    err = capsys.readouterr().err
    assert "stitched 2/2 replica request tree(s)" in err
    # Perfetto export keeps one pid lane per process.
    export = tmp_path / "trace.json"
    assert main([
        "trace", str(root), str(root / "replica-0"),
        "--export", str(export),
    ]) == 0
    chrome = json.loads(export.read_text())
    pids = {e.get("pid") for e in chrome["traceEvents"]}
    assert len(pids) == 2


def test_cli_trace_single_dir_unchanged(tmp_path, capsys):
    from distributed_mnist_bnns_tpu_torch.cli import main

    root = _fleet_log_tree(tmp_path)
    assert main(["trace", str(root)]) == 0
    err = capsys.readouterr().err
    assert "stitched" not in err


# ---------------------------------------------------------------------------
# byte-equal to the JAX package's plane on the same inputs


def _both_registries(seed):
    """The same observations into a port and a JAX registry of each
    replica."""
    from distributed_mnist_bnns_tpu.obs import MetricsRegistry as JRegistry

    rng = np.random.RandomState(seed)
    out = {}
    for i in range(3):
        pair = (MetricsRegistry(), JRegistry())
        vals = rng.exponential(0.05, 20)
        depth = float(rng.randint(0, 9))
        for reg in pair:
            c = reg.counter("serve_requests_total", "served")
            c.inc(10 * (i + 1), status="ok")
            c.inc(i, status="shed")
            reg.gauge("serve_queue_depth", "queue").set(depth)
            h = reg.histogram("serve_batch_seconds", "batch")
            for v in vals:
                h.observe(float(v))
            if i == 2:   # a type conflict the merge must record
                reg.gauge("serve_batches_total", "x").set(1.0)
            else:
                reg.counter("serve_batches_total", "x").inc(i + 4)
        out[f"replica-{i}"] = pair
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_merged_metrics_are_the_jax_aggregators_bytes(seed):
    """The fleet-merged /metrics of the same replica snapshots: the
    Prometheus text byte-equal, the JSON equal, the conflicts the same;
    through the scraped store and view as through ``merge_snapshots``."""
    from distributed_mnist_bnns_tpu.obs import (
        MetricsRegistry as JRegistry,
    )
    from distributed_mnist_bnns_tpu.obs import (
        merge_snapshots as jmerge,
    )
    from distributed_mnist_bnns_tpu.obs import (
        render_prometheus as jrender,
    )
    from distributed_mnist_bnns_tpu.obs.aggregate import (
        FleetMetricsStore as JStore,
    )
    from distributed_mnist_bnns_tpu.obs.aggregate import (
        FleetMetricsView as JView,
    )

    regs = _both_registries(seed)
    mine = merge_snapshots({r: p[0].snapshot() for r, p in regs.items()})
    theirs = jmerge({r: p[1].snapshot() for r, p in regs.items()})
    assert render_prometheus(mine).encode() == jrender(theirs).encode()
    assert json.dumps(mine, sort_keys=True) == json.dumps(
        theirs, sort_keys=True)
    assert mine.conflicts == theirs.conflicts and mine.conflicts
    clock = FakeClock()
    store, jstore = FleetMetricsStore(clock=clock), JStore(clock=clock)
    local, jlocal = MetricsRegistry(), JRegistry()
    for reg in (local, jlocal):
        reg.counter("fleet_requests_total", "routed").inc(5, status="200")
    for rid, (_, jreg) in regs.items():   # the texts as scraped
        body = json.loads(json.dumps(jreg.snapshot()))
        store.update(rid, snapshot=body, healthz={"status": "ok"})
        jstore.update(rid, snapshot=body, healthz={"status": "ok"})
    assert render_prometheus(FleetMetricsView(local, store).snapshot()) \
        == jrender(JView(jlocal, jstore).snapshot())
    assert store.status() == jstore.status()
    rows = [{"id": r, "healthy": r != "replica-1"} for r in regs]
    assert json.dumps(healthz_rollup(rows, store.healthz())) == json.dumps(
        __import__("distributed_mnist_bnns_tpu.obs", fromlist=["x"])
        .healthz_rollup(rows, jstore.healthz()))


def test_slo_records_are_the_jax_monitors():
    """The same request and token stream into both monitors on one fake
    clock: every transition record, emitted event, gauge and counter
    series and the summary equal, as JSON bytes."""
    from distributed_mnist_bnns_tpu.obs import (
        MetricsRegistry as JRegistry,
    )
    from distributed_mnist_bnns_tpu.obs import SLOMonitor as JMonitor
    from distributed_mnist_bnns_tpu.obs import (
        default_fleet_slos as jdefault,
    )

    clock = FakeClock()
    sides = []
    for monitor, slos, reg in (
            (SLOMonitor, default_fleet_slos, MetricsRegistry()),
            (JMonitor, jdefault, JRegistry())):
        events = []
        sides.append((monitor(
            slos(request_p99_ms=300.0, fast_window_s=5.0,
                 slow_window_s=30.0),
            registry=reg, clock=clock,
            emit=lambda kind, _e=events, **f: _e.append({"kind": kind,
                                                         **f})),
            events, reg, []))
    rng = np.random.RandomState(3)
    for step in range(600):
        bad = 150 <= step < 300 and rng.rand() < 0.6
        latency = float(rng.exponential(120.0)) + (500.0 if bad else 0.0)
        token_ms = float(rng.exponential(20.0))
        for mon, _, _, transitions in sides:
            mon.observe_request(not bad, latency_ms=latency)
            mon.observe_token(inter_token_ms=token_ms)
            if step % 10 == 9:
                transitions.extend(mon.evaluate())
        clock.advance(0.05)
    (mine, ev, reg, tr), (theirs, jev, jreg, jtr) = sides
    assert tr and json.dumps(tr) == json.dumps(jtr)
    assert json.dumps(ev) == json.dumps(jev)
    assert json.dumps(mine.summary()) == json.dumps(theirs.summary())
    assert render_prometheus(reg.snapshot()) == __import__(
        "distributed_mnist_bnns_tpu.obs", fromlist=["x"]
    ).render_prometheus(jreg.snapshot())


def test_decision_timeline_and_fleet_summary_are_the_jax_readers(
        tmp_path, capsys):
    from distributed_mnist_bnns_tpu import obs as jobs
    from distributed_mnist_bnns_tpu.cli import main as jmain
    from distributed_mnist_bnns_tpu_torch.cli import main
    from distributed_mnist_bnns_tpu_torch.obs import read_events

    root = _fleet_log_tree(tmp_path)
    events = list(read_events(str(root / "events.jsonl")))
    rows = decision_timeline(events)
    assert json.dumps(rows) == json.dumps(jobs.decision_timeline(events))
    assert render_decision_timeline(rows) == jobs.render_decision_timeline(
        jobs.decision_timeline(events))
    mine, theirs = summarize_fleet(str(root)), jobs.summarize_fleet(
        str(root))
    assert json.dumps(mine["fleet"]) == json.dumps(theirs["fleet"])
    assert render_fleet_table(mine).splitlines()[1:] == (
        jobs.render_fleet_table(theirs).splitlines()[1:])
    for argv in (["fleet", "explain", str(root), "--json"],
                 ["fleet", "explain", str(root)]):
        assert main(argv) == 0
        got = capsys.readouterr().out
        assert jmain(argv) == 0
        assert got == capsys.readouterr().out, argv
    # a log's own summary names its framework's versions (the port's
    # manifest records torch_version); the fleet rollup is the same
    argv = ["telemetry", str(root), "--fleet", "--json"]
    assert main(argv) == 0
    got = json.loads(capsys.readouterr().out)
    assert jmain(argv) == 0
    assert json.dumps(got["fleet"]) == json.dumps(
        json.loads(capsys.readouterr().out)["fleet"])
