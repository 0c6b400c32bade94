"""The port's ``obs/`` against the JAX package's: the registry's snapshot
and Prometheus text byte for byte on the same operations, the event
schema and manifest, the run-log summary and its table on one log, the
build tracker and its spike fallback, heartbeats, ``StepTimer(metric=)``,
the sync-free step clock, and the trainer's telemetry on the CPU (a log
the port writes is read by the JAX ``summarize`` with the same steps,
examples, epochs and event kinds). CPU only, small."""

import json
import os

import numpy as np
import pytest

import distributed_mnist_bnns_tpu.obs as jobs
from distributed_mnist_bnns_tpu.obs import events as jevents
from distributed_mnist_bnns_tpu.obs import summary as jsummary

import distributed_mnist_bnns_tpu_torch.obs as pobs
from distributed_mnist_bnns_tpu_torch.obs import events as pevents


def _drive(reg):
    """One sequence of registry operations: labels, escapes, help text
    with a backslash and a newline, default and custom buckets, the
    overflow bucket, float and integral values."""
    c = reg.counter("serve_requests_total", "requests by final status")
    c.inc(status="ok")
    c.inc(3, status="ok")
    c.inc(0.5, status='shed "q"\\x\n', tier="batch")
    c.inc()
    g = reg.gauge("device_hbm_bytes_in_use", "live memory\\per card\nbytes")
    g.set(2 ** 33, device="0")
    g.set(1.25, device="1")
    h = reg.histogram("train_step_seconds", "per-step latency")
    for v in (1e-5, 3e-4, 0.002, 0.002, 0.7, 200.0):
        h.observe(v)
    h2 = reg.histogram("lm_prefill_ms", "", buckets=(0.5, 1.0, 2.5))
    for v in (0.1, 0.75, 0.75, 9.0):
        h2.observe(v, phase="prefill")
    reg.counter("empty_total", "never incremented")
    return c, g, h


def test_registry_snapshot_and_prometheus_text_are_jax_byte_for_byte():
    jr, pr = jobs.MetricsRegistry(), pobs.MetricsRegistry()
    jc, _, jh = _drive(jr)
    pc, _, ph = _drive(pr)
    assert pr.snapshot() == jr.snapshot()
    jtext = jobs.render_prometheus(jr.snapshot())
    ptext = pobs.render_prometheus(pr.snapshot())
    assert ptext.encode() == jtext.encode()
    assert 'le="+Inf"' in ptext and "\\n" in ptext
    for q in (1, 50, 95, 99, 100):
        assert ph.percentile(q) == jh.percentile(q)
    assert pc.total() == jc.total() == 5.5
    assert pobs.render_prometheus({}) == jobs.render_prometheus({}) == ""
    assert pobs.DEFAULT_TIME_BUCKETS == jobs.DEFAULT_TIME_BUCKETS
    with pytest.raises(ValueError):
        pr.gauge("serve_requests_total")


def test_event_kinds_and_envelope_are_the_jax_schema(tmp_path):
    assert pevents.EVENT_KINDS.keys() == jevents.EVENT_KINDS.keys()
    assert pevents.ENVELOPE_FIELDS == jevents.ENVELOPE_FIELDS
    assert pobs.SCHEMA_VERSION == jobs.SCHEMA_VERSION == 1
    assert pobs.MANIFEST_KIND == jobs.MANIFEST_KIND
    for path, mod in ((tmp_path / "p.jsonl", pobs), (tmp_path / "j.jsonl",
                                                      jobs)):
        with mod.EventLog(str(path)) as ev:
            ev.manifest(config={"model": "bnn-mlp-small", "batch": 32})
            ev.manifest(config={"model": "ignored"})
            ev.emit("step", step=np.int64(1), latency_s=np.float32(0.5),
                    loss=np.float64(0.25), arr=np.zeros((2, 3)))
            ev.error(ValueError("boom"), epoch=0)
    p, j = (mod.load_events(str(tmp_path / f"{k}.jsonl"))
            for k, mod in (("p", pobs), ("j", jobs)))
    assert [e["kind"] for e in p] == [e["kind"] for e in j] == [
        "run_manifest", "step", "error"]
    for a, b in zip(p[1:], j[1:]):
        assert {k: v for k, v in a.items() if k != "ts"} == \
            {k: v for k, v in b.items() if k != "ts"}
    # the manifest: equal but for devices and versions
    versions = {"jax_version", "torch_version", "cuda_version"}
    pm, jm = p[0], j[0]
    assert set(pm) - versions - {"ts"} == set(jm) - versions - {"ts"}
    for k in set(jm) - versions - {"ts", "topology", "pid"}:
        assert pm[k] == jm[k], k
    assert set(pm["topology"]) == set(jm["topology"])
    assert pm["topology"]["backend"] == "cpu"
    assert pm["topology"]["process_index"] == 0
    assert pm["topology"]["process_count"] == 1
    import torch

    assert pm["torch_version"] == torch.__version__


def _write_log(path, device_kind="cpu"):
    """A log of every kind the summary folds, written as raw JSON lines
    (neither package's writer), with an older run before the last
    manifest."""
    rows = [
        {"kind": "run_manifest", "config": {"model": "old"}},
        {"kind": "step", "latency_s": 9.0, "batch_size": 1, "n_steps": 1},
        {"kind": "run_manifest", "config": {"model": "bnn-mlp-small"},
         "topology": {"backend": "cuda", "device_kind": device_kind,
                      "device_count": 1}, "git_rev": "abc123"},
    ]
    for i in range(10):
        rows.append({"kind": "step", "step": i + 1,
                     "latency_s": 0.01 * (i + 1), "batch_size": 32,
                     "n_steps": 1 + (i % 3), "mfu": 0.25 + 0.01 * i,
                     "loss": 1.0 / (i + 1)})
    rows += [
        {"kind": "epoch", "epoch": 0, "recompiles_total": 3},
        {"kind": "eval", "epoch": 0, "test_acc": 97.5},
        {"kind": "checkpoint", "epoch": 0, "path": "ck", "best": True},
        {"kind": "error", "error_type": "ValueError", "error": "boom"},
        {"kind": "program_cost", "program": "train_step", "flops": 1e9,
         "bytes_accessed": 4e6, "source": "online"},
        {"kind": "program_cost", "program": "train_step", "flops": 1e9,
         "final": True, "dispatches": 10},
        {"kind": "profile_capture", "dir": "p", "duration_ms": 12.5,
         "total_bytes": 4096},
        {"kind": "metrics", "registry": {"program_dispatch_seconds": {
            "series": [{"labels": {"program": "train_step"}, "count": 4,
                        "sum": 0.01}]}}},
        {"kind": "run_end", "recompiles_total": 3, "wall_seconds": 1.5,
         "compile_seconds": 0.25},
    ]
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps({"v": 1, "ts": "2026-01-01T00:00:00Z",
                                **r}) + "\n")


def _no_versions(summary):
    out = dict(summary)
    out["run"] = {k: v for k, v in summary["run"].items()
                  if not k.endswith("_version")}
    return out


def test_summarize_and_table_equal_jax_on_one_log(tmp_path):
    path = str(tmp_path / "events.jsonl")
    _write_log(path)
    p, j = pobs.summarize(path), jobs.summarize(path)
    assert _no_versions(p) == _no_versions(j)
    assert p["steps"]["count"] == 19 and p["programs"]["train_step"][
        "dispatches"] == 4
    assert set(p["run"]) - set(j["run"]) == {"torch_version", "cuda_version"}
    pt, jt = pobs.render_table(p).splitlines(), \
        jobs.render_table(j).splitlines()
    assert len(pt) == len(jt)
    diff = [(a, b) for a, b in zip(pt, jt) if a != b]
    assert len(diff) == 1 and "torch / git" in diff[0][0] \
        and "jax / git" in diff[0][1]
    # on a card's log the port prices the programs with the card's peak,
    # where the JAX package (whose table holds TPUs) takes the nominal
    _write_log(path, device_kind="NVIDIA H100 80GB HBM3")
    p, j = pobs.summarize(path), jobs.summarize(path)
    assert p["programs"]["train_step"]["mfu"] == \
        round(1e9 / 0.0025 / 989.4e12, 6)
    assert j["programs"]["train_step"]["mfu"] == round(1e9 / 0.0025 / 1e11, 6)
    assert p["steps"] == j["steps"]


def test_summary_fields_are_jax_summary_fields(tmp_path):
    """Every key of the JAX summary (but the JAX version) is in the
    port's, on an empty log too."""
    path = str(tmp_path / "events.jsonl")
    open(path, "w").close()
    p, j = pobs.summarize(path), jsummary.summarize(path)
    assert _no_versions(p) == _no_versions(j)
    with pytest.raises(FileNotFoundError):
        pobs.summarize(str(tmp_path / "absent.jsonl"))


def test_recompile_tracker_counts_and_spike_fallback_match_jax():
    reg = pobs.MetricsRegistry()
    tracker = pobs.RecompileTracker(registry=reg).install()
    tracker.record("capture", 0.5)
    tracker.record("capture", 0.25)
    tracker.record("kernel_load", 0.01)
    assert tracker.count == 3 and tracker.kind_count("capture") == 2
    assert tracker.compile_seconds == pytest.approx(0.76)
    snap = reg.snapshot()
    assert set(snap) == {"jax_backend_compiles_total",
                         "jax_backend_compile_seconds"}
    assert not tracker.observe_step(100.0)   # installed: no guessing
    # not installed: the spike heuristic, step for step JAX's
    times = [0.01] * 10 + [0.5, 0.01, 0.011, 0.3, 0.01]
    p = pobs.RecompileTracker(registry=pobs.MetricsRegistry())
    j = jobs.RecompileTracker(registry=jobs.MetricsRegistry())
    assert [p.observe_step(t) for t in times] == \
        [j.observe_step(t) for t in times]
    assert p.count == j.count == 2
    assert pobs.get_tracker() is pobs.get_tracker()
    assert pobs.get_tracker().listener_available


def test_heartbeat_records_and_rotation(tmp_path):
    hb = pobs.Heartbeat(str(tmp_path), payload_fn=lambda: {"step": 7},
                        max_lines=2)
    for _ in range(6):
        rec = hb.beat()
    assert rec["kind"] == "heartbeat" and rec["step"] == 7
    assert rec["process_index"] == 0 and rec["beat"] == 6
    with open(hb.history_path) as f:
        assert len(f.readlines()) <= 4
    assert pobs.read_heartbeats(str(tmp_path))[0]["beat"] == 6
    hb.start()
    hb.stop()
    assert pobs.read_heartbeats(str(tmp_path))[0]["beat"] >= 7


def test_step_timer_feeds_the_registry():
    from distributed_mnist_bnns_tpu_torch.utils.profiling import StepTimer

    name = "test_torch_obs_timer_seconds"
    t = StepTimer(metric=name, phase="x")
    for _ in range(3):
        t.start()
        t.stop()
    hist = pobs.default_registry().histogram(name)
    assert hist.count(phase="x") == 3 and t.meter.count == 3


def test_step_clock_chains_dispatches_on_the_cpu():
    clock = pobs.StepClock("cpu")
    first = clock.start()
    clock.stop(first, "a")
    assert clock.start() is None          # chained to the previous end
    clock.stop(None, "b")
    got = list(clock.ready())
    assert [p for _, p in got] == ["a", "b"]
    assert all(s >= 0 for s, _ in got) and len(clock) == 0
    clock.restart()
    assert clock.start() is not None


def test_telemetry_record_step_and_disabled_mode(tmp_path):
    tel = pobs.Telemetry(str(tmp_path / "t"), heartbeat=False)
    jtel = jobs.Telemetry(str(tmp_path / "j"), heartbeat=False)
    payloads = []
    for t in (tel, jtel):
        payloads.append(t.record_step(
            0.004, batch_size=64, n_steps=8, step=8, step_flops=3.19e9,
            peak_flops=989.4e12, metrics={"loss": 0.5}))
        t.epoch(0, metrics={"train_loss": 0.5})
        t.close(epochs=1)
    assert payloads[0] == payloads[1]
    pe = pobs.load_events(str(tmp_path / "t" / "events.jsonl"))
    je = jobs.load_events(str(tmp_path / "j" / "events.jsonl"))
    assert [e["kind"] for e in pe] == [e["kind"] for e in je]
    ps, js = pe[0], je[0]
    assert {k: v for k, v in ps.items() if k != "ts"} == \
        {k: v for k, v in js.items() if k != "ts"}
    assert ps["mfu"] == round(3.19e9 / 0.004 / 989.4e12, 6)
    assert tel.registry.snapshot()["train_examples_total"] == \
        jtel.registry.snapshot()["train_examples_total"]
    off = pobs.Telemetry()
    off.record_step(0.01, batch_size=4)
    off.emit("step")
    off.close()
    assert off.events is None and off.steps.total() == 1


def test_trainer_log_reads_in_the_jax_summary(tmp_path):
    """The port's CPU trainer with telemetry: one step event a dispatch
    (captured-style chunks of 3 included), the run's kinds; the JAX
    ``summarize`` reads the log and agrees with the port's on steps,
    examples, epochs and event kinds."""
    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    data = load_mnist(None, synthetic_sizes=(320, 64))
    td = str(tmp_path / "tel")
    tr = Trainer(TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1}, epochs=2,
        batch_size=32, device="cpu", scan_steps=3, log_interval=2,
        telemetry_dir=td, trace=True, checkpoint_dir=str(tmp_path / "ck")))
    tr.fit(data)
    path = os.path.join(td, "events.jsonl")
    events = pobs.load_events(path)
    steps = [e for e in events if e["kind"] == "step"]
    # 10 batches an epoch: 3 chunks of 3 and one leftover, two epochs
    assert len(steps) == 8
    assert sum(e["n_steps"] for e in steps) == tr.step == 20
    assert all(e["latency_s"] > 0 and e["mfu"] > 0 for e in steps)
    assert any("loss" in e for e in steps)
    man = events[0]
    assert man["kind"] == "run_manifest" and man["step_flops"] > 0
    assert man["flops_method"] == "analytic_3x_dense_gemms"
    assert man["peak_precision"] == "nominal"
    p, j = pobs.summarize(path), jobs.summarize(path)
    for key in ("count", "examples"):
        assert p["steps"][key] == j["steps"][key]
    assert p["steps"]["examples"] == 20 * 32
    assert p["epochs"] == j["epochs"] == 2
    assert p["event_counts"] == j["event_counts"]
    assert {"run_manifest", "step", "epoch", "eval", "checkpoint", "span",
            "metrics", "run_end"} <= set(p["event_counts"])
    assert events[-1]["kind"] == "run_end"
    assert pobs.read_heartbeats(td)[0]["beat"] >= 1
    spans = pobs.load_spans(path)
    assert {s["span_kind"] for s in spans} >= {"step", "checkpoint"}


def test_a_profile_window_leaves_the_step_latency_tail_unchanged(
        tmp_path, monkeypatch):
    """A capture's start and stop (on a card: a synchronize, idle edges,
    the trace's export) fall between dispatches, and no step's latency
    carries them: the dispatch after either is timed from its own start.
    Here each moves the step clock on by ``PAUSE`` s (a clock of its
    own, so a loaded host cannot blur it)."""
    import time
    import types

    from distributed_mnist_bnns_tpu_torch.data import load_mnist
    from distributed_mnist_bnns_tpu_torch.obs import telemetry as ptel
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    PAUSE = 1000.0
    skew = [0.0]
    clock = types.SimpleNamespace(**{
        k: getattr(time, k) for k in dir(time) if not k.startswith("_")})
    clock.perf_counter = lambda: time.perf_counter() + skew[0]
    monkeypatch.setattr(ptel, "time", clock)
    td = str(tmp_path / "tel")
    tr = Trainer(TrainConfig(
        model="bnn-mlp-small", model_kwargs={"infl_ratio": 1}, epochs=1,
        batch_size=32, device="cpu", log_interval=100, telemetry_dir=td,
        profile_step_window="3:6"))
    prof = tr._profiler
    start, stop = prof.start, prof.stop

    def slow_start(artifact_dir):
        start(artifact_dir)
        skew[0] += PAUSE

    def slow_stop(**kw):
        skew[0] += PAUSE
        return stop(**kw)

    monkeypatch.setattr(prof, "start", slow_start)
    monkeypatch.setattr(prof, "stop", slow_stop)
    tr.fit(load_mnist(None, synthetic_sizes=(320, 64)))
    assert skew[0] == 2 * PAUSE
    events = pobs.load_events(os.path.join(td, "events.jsonl"))
    assert [e["kind"] for e in events].count("profile_capture") == 1
    steps = [e for e in events if e["kind"] == "step"]
    assert len(steps) == 10 == tr.telemetry.step_hist.count()
    assert max(e["latency_s"] for e in steps) < PAUSE, steps
    assert tr.telemetry.step_hist.percentile(100) < PAUSE


@pytest.mark.parametrize("hosts", [None, 2])
def test_comm_bytes_split_as_jax_splits_them(hosts):
    """``comm_bytes_total`` from the exchange's own byte counts: flat
    runs by {mode, phase}; two-level runs the in-host fp32 ring (level
    intra) apart from the 1-bit phases (level inter); and the bytes
    saved against fp32 a step."""
    from distributed_mnist_bnns_tpu_torch.ops.comm_compress import (
        make_hier_plan,
        make_plan,
    )
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    t = Trainer(TrainConfig(model="bnn-mlp-small",
                            model_kwargs={"infl_ratio": 1}, device="cpu"))
    n = sum(p.numel() for p in t.model.parameters())
    if hosts:
        t.hier_plan = make_hier_plan(n, hosts=hosts, local=2,
                                     mode="sign_ef", bucket_size=1024,
                                     chunks=4)
        t.comm_plan = t.hier_plan.inter
    else:
        t.comm_plan = make_plan(n, world=4, mode="sign_ef",
                                bucket_size=1024, chunks=4)
    t.world = 4
    for step in range(2):
        t.wire[("inter", "rs")] += 100
        t.wire[("inter", "ag")] += 30
        if hosts:
            t.wire[("intra", "rs")] += 7
            t.wire[("intra", "ag")] += 7
        t._record_comm(1)
    snap = t.telemetry.registry.snapshot()
    got = {tuple(sorted(s["labels"].items())): s["value"]
           for s in snap["comm_bytes_total"]["series"]}
    if hosts:
        want = {(("level", "intra"), ("mode", "fp32"), ("phase", "ring")): 28,
                (("level", "inter"), ("mode", "sign_ef"), ("phase", "rs")):
                    200,
                (("level", "inter"), ("mode", "sign_ef"), ("phase", "ag")):
                    60}
    else:
        want = {(("mode", "sign_ef"), ("phase", "rs")): 200,
                (("mode", "sign_ef"), ("phase", "ag")): 60}
    assert got == want
    saved = snap["comm_saved_bytes_total"]["series"][0]["value"]
    assert saved == 2 * t.comm_plan.saved_bytes_per_step > 0


def test_cli_train_and_eval_write_telemetry(tmp_path, capsys):
    """``cli train|eval --telemetry-dir --trace``: each command's log
    opens with its manifest and closes with ``run_end``; eval's holds
    its ``eval`` event; ``cli telemetry`` reads both."""
    from distributed_mnist_bnns_tpu_torch.cli import main

    common = ["--model", "bnn-mlp-small", "--infl-ratio", "1",
              "--synthetic-sizes", "256", "64", "--device", "cpu",
              "--batch-size", "32", "--checkpoint-dir", str(tmp_path / "ck"),
              "--trace"]
    assert main(["train", "--epochs", "1", "--telemetry-dir",
                 str(tmp_path / "t"), *common]) == 0
    assert main(["eval", "--telemetry-dir", str(tmp_path / "e"),
                 *common]) == 0
    capsys.readouterr()
    for d, kind, steps in (("t", "step", 8), ("e", "eval", 0)):
        events = pobs.load_events(str(tmp_path / d / "events.jsonl"))
        kinds = [e["kind"] for e in events]
        assert kinds[0] == "run_manifest" and kinds[-1] == "run_end"
        assert kind in kinds
        assert main(["telemetry", str(tmp_path / d), "--json"]) == 0
        assert json.loads(capsys.readouterr().out)["steps"]["count"] == steps
    assert main(["telemetry", str(tmp_path / "none")]) == 2
