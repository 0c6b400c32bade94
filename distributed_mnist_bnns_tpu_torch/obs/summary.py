"""Run-log summarization — the read side of the telemetry subsystem
(the JAX package's ``obs/summary.py``).

``summarize(path)`` folds a JSONL event log (obs/events.py schema) into
one plain dict; ``render_table`` formats it for humans (the ``cli
telemetry`` report). Both are exact: percentiles here come from the
per-step latencies recorded in the events, not the registry's bucketed
estimates. A log of either package reads the same, but for the
manifest's versions: the port records ``torch_version`` and
``cuda_version`` where the JAX package records ``jax_version``.

The fleet's read side: ``summarize_fleet(root)`` folds the router's log
and each replica's (``root/<rid>/``) into one summary
(``render_fleet_table``, the ``cli telemetry --fleet`` report), and
``decision_timeline`` joins the control plane's ``decision`` events with
the ``slo_alert`` transitions (``render_decision_timeline``, ``cli fleet
explain``).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from .events import MANIFEST_KIND, read_events
from .heartbeat import read_heartbeats
from .trace import percentile as _percentile


def summarize(path: str) -> Dict[str, Any]:
    """Fold an event log into a summary dict (see OBSERVABILITY.md for
    the schema). Raises FileNotFoundError for a missing log."""
    all_events = list(read_events(path))
    # A reused telemetry dir appends runs to one file; report the LATEST
    # run (everything from the last manifest on) so a re-run never has
    # its numbers attributed to an older run's config/git rev. A log
    # with no manifest (hand-built, tests) aggregates everything.
    # Rotation copies (``rotated_copy`` — obs/events re-emits the
    # manifest into each fresh segment so pruning can't lose it) are
    # DATA fallbacks only: they must never re-scope the run to the
    # segment they open.
    last_manifest = max(
        (i for i, e in enumerate(all_events)
         if e.get("kind") == MANIFEST_KIND
         and not e.get("rotated_copy")),
        default=None,
    )
    if last_manifest is not None:
        events_in_run = all_events[last_manifest:]
    else:
        events_in_run = all_events

    manifests: List[Dict] = []
    latencies: List[float] = []
    mfus: List[Dict] = []
    losses: List[float] = []
    steps_total = 0
    examples_total = 0
    latency_weighted_s = 0.0
    epochs: List[Dict] = []
    evals: List[Dict] = []
    checkpoints = 0
    errors: List[Dict] = []
    recompiles: Optional[int] = None
    compile_seconds: Optional[float] = None
    wall_seconds: Optional[float] = None
    kinds: Dict[str, int] = {}
    bench_sections: List[Dict] = []
    infer_runs: List[Dict] = []
    programs: Dict[str, Dict[str, Any]] = {}
    metrics_snapshot: Optional[Dict] = None
    profile_captures: List[Dict] = []

    def _program(name: Any) -> Dict[str, Any]:
        return programs.setdefault(
            str(name), {"compiles": 0, "aot": {}}
        )

    manifest_copies: List[Dict] = []

    for ev in events_in_run:
        kind = ev.get("kind", "?")
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == MANIFEST_KIND:
            if ev.get("rotated_copy"):
                manifest_copies.append(ev)
            else:
                manifests.append(ev)
        elif kind == "step":
            n = int(ev.get("n_steps", 1) or 1)
            lat = ev.get("latency_s")
            if isinstance(lat, (int, float)):
                latencies.append(float(lat))
                latency_weighted_s += float(lat) * n
                if isinstance(ev.get("mfu"), (int, float)):
                    mfus.append({"mfu": float(ev["mfu"]),
                                 "w": float(lat) * n})
            if isinstance(ev.get("loss"), (int, float)):
                losses.append(float(ev["loss"]))
            steps_total += n
            examples_total += n * int(ev.get("batch_size", 0) or 0)
        elif kind == "epoch":
            epochs.append(ev)
            if isinstance(ev.get("recompiles_total"), int):
                recompiles = ev["recompiles_total"]
        elif kind == "eval":
            evals.append(ev)
        elif kind == "checkpoint":
            checkpoints += 1
        elif kind == "error":
            errors.append(ev)
        elif kind == "run_end":
            if isinstance(ev.get("recompiles_total"), int):
                recompiles = ev["recompiles_total"]
            compile_seconds = ev.get("compile_seconds")
            wall_seconds = ev.get("wall_seconds")
        elif kind == "bench":
            bench_sections.append(ev)
        elif kind == "infer":
            infer_runs.append(ev)
        elif kind == "program_cost":
            # Per-program cost ledger rows (obs/costs): the latest row
            # describes the program (a reload overwrites); the
            # close-time snapshot rows (final=True) carry dispatch
            # stats + measured MFU and are NOT extra programs.
            row = _program(ev.get("program"))
            if not ev.get("final") and ev.get("source") != "aot_hit":
                # An AOT hit analyzes a stored executable — it is a
                # cost row, not a compile (the hit itself is counted
                # under the aot_hit event).
                row["compiles"] += 1
            for k in ("flops", "bytes_accessed", "hbm", "source",
                      "reason", "dispatches", "mean_dispatch_ms",
                      "mfu", "peak_precision"):
                if ev.get(k) is not None:
                    row[k] = ev[k]
        elif kind in ("aot_hit", "aot_miss", "aot_bank", "aot_fallback"):
            row = _program(ev.get("name"))
            aot = row["aot"]
            short = kind[len("aot_"):]
            aot[short] = aot.get(short, 0) + 1
        elif kind == "metrics":
            metrics_snapshot = ev.get("registry")
        elif kind == "profile_capture":
            profile_captures.append(ev)

    latencies.sort()
    if not manifests and manifest_copies:
        # The original segment was pruned by rotation: the earliest
        # surviving copy IS the run's manifest data.
        manifests = manifest_copies[:1]
    manifest = manifests[0] if manifests else {}
    summary: Dict[str, Any] = {
        "path": path,
        "schema_versions": sorted({
            m.get("v") for m in manifests
        }) if manifests else [],
        "manifest_count": len(manifests),
        "run": {
            "model": (manifest.get("config") or {}).get("model"),
            "started": manifest.get("ts"),
            "git_rev": manifest.get("git_rev"),
            "torch_version": manifest.get("torch_version"),
            "cuda_version": manifest.get("cuda_version"),
            "backend": (manifest.get("topology") or {}).get("backend"),
            "device_kind": (
                manifest.get("topology") or {}
            ).get("device_kind"),
            "device_count": (
                manifest.get("topology") or {}
            ).get("device_count"),
            "wall_seconds": wall_seconds,
        },
        "steps": {
            "count": steps_total,
            "examples": examples_total,
            "latency_s": {
                "p50": _percentile(latencies, 50),
                "p95": _percentile(latencies, 95),
                "p99": _percentile(latencies, 99),
                "min": latencies[0] if latencies else None,
                "max": latencies[-1] if latencies else None,
            },
            # Aggregates weight by recorded time so they telescope: on
            # async backends individual dispatch latencies are bimodal
            # (dispatch-only vs sync-drain), but their SUM is the loop's
            # wall time, making these ratios exact where a mean of
            # per-step ratios would be dominated by the tiny
            # dispatch-only entries.
            "examples_per_sec_mean": (
                examples_total / latency_weighted_s
                if latency_weighted_s > 0 else None
            ),
            "mfu_mean": (
                sum(m["mfu"] * m["w"] for m in mfus)
                / sum(m["w"] for m in mfus)
                if mfus and sum(m["w"] for m in mfus) > 0 else None
            ),
            "mfu_max": max((m["mfu"] for m in mfus), default=None),
            "final_loss": losses[-1] if losses else None,
        },
        "recompiles_total": recompiles,
        "compile_seconds": compile_seconds,
        "epochs": len(epochs),
        "evals": len(evals),
        "best_test_acc": max(
            (e.get("test_acc") for e in evals
             if isinstance(e.get("test_acc"), (int, float))),
            default=None,
        ),
        "checkpoints": checkpoints,
        "errors": [
            {"ts": e.get("ts"), "type": e.get("error_type"),
             "error": e.get("error")}
            for e in errors
        ],
        "event_counts": kinds,
    }
    if bench_sections:
        summary["bench_events"] = len(bench_sections)
    if infer_runs:
        summary["infer_events"] = len(infer_runs)
    if profile_captures:
        summary["profile_captures"] = [
            {"dir": c.get("dir"), "duration_ms": c.get("duration_ms"),
             "total_bytes": c.get("total_bytes")}
            for c in profile_captures
        ]
    if programs:
        # The run's device story from the events dir alone: join the
        # cost rows with the closing metrics snapshot's per-program
        # dispatch histogram for measured MFU (no live server needed).
        from .flops import NOMINAL_HOST_PEAK, chip_peak_bf16
        from .flops import mfu as _mfu

        kind_str = (
            manifest.get("topology") or {}
        ).get("device_kind") or ""
        peak = chip_peak_bf16(kind_str) or NOMINAL_HOST_PEAK
        hist = (metrics_snapshot or {}).get(
            "program_dispatch_seconds"
        ) or {}
        for series in hist.get("series", []):
            name = (series.get("labels") or {}).get("program")
            if name not in programs:
                continue
            row = programs[name]
            count = int(series.get("count", 0) or 0)
            if count:
                mean_s = float(series.get("sum", 0.0)) / count
                row["dispatches"] = count
                row["mean_dispatch_ms"] = round(mean_s * 1e3, 4)
                m = _mfu(row.get("flops"), mean_s, peak)
                if m is not None:
                    row["mfu"] = m
        summary["programs"] = programs
    heartbeats = read_heartbeats(os.path.dirname(path) or ".")
    if heartbeats:
        summary["heartbeats"] = {
            str(idx): {"ts": hb.get("ts"), "beat": hb.get("beat")}
            for idx, hb in sorted(heartbeats.items())
        }
    return summary


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    return f"{v * 1e3:.2f} ms" if v < 1.0 else f"{v:.3f} s"


def _fmt(v: Any) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_table(summary: Dict[str, Any]) -> str:
    """Human-readable run summary (the `telemetry` CLI's default)."""
    run = summary["run"]
    st = summary["steps"]
    lat = st["latency_s"]
    rows = [
        ("model", _fmt(run.get("model"))),
        ("started", _fmt(run.get("started"))),
        ("backend / device", f"{_fmt(run.get('backend'))} / "
                             f"{_fmt(run.get('device_kind'))} "
                             f"x{_fmt(run.get('device_count'))}"),
        ("torch / git", f"{_fmt(run.get('torch_version'))} / "
                        f"{_fmt((run.get('git_rev') or '')[:12] or None)}"),
        ("steps / examples", f"{st['count']} / {st['examples']}"),
        ("step latency p50", _fmt_s(lat["p50"])),
        ("step latency p95", _fmt_s(lat["p95"])),
        ("step latency p99", _fmt_s(lat["p99"])),
        ("examples/sec (mean)", _fmt(st["examples_per_sec_mean"])),
        ("MFU mean / max", f"{_fmt(st['mfu_mean'])} / "
                           f"{_fmt(st['mfu_max'])}"),
        ("final train loss", _fmt(st["final_loss"])),
        ("recompiles total", _fmt(summary.get("recompiles_total"))),
        ("epochs / evals", f"{summary['epochs']} / {summary['evals']}"),
        ("best test acc", _fmt(summary.get("best_test_acc"))),
        ("checkpoints", _fmt(summary.get("checkpoints"))),
        ("errors", str(len(summary.get("errors", [])))),
    ]
    if "heartbeats" in summary:
        beats = ", ".join(
            f"p{idx}@{hb.get('ts')}"
            for idx, hb in summary["heartbeats"].items()
        )
        rows.append(("last heartbeats", beats))
    width = max(len(k) for k, _ in rows)
    lines = [f"telemetry summary: {summary['path']}"]
    lines += [f"  {k.ljust(width)}  {v}" for k, v in rows]
    programs = summary.get("programs")
    if programs:
        # The device story: one line per program — rows, counted
        # flops, measured MFU — readable without a live server.
        lines.append("  programs:")
        for name, row in sorted(programs.items()):
            aot = row.get("aot") or {}
            aot_s = (
                f" aot {aot}" if aot else ""
            )
            lines.append(
                f"    {name:<20} compiles {row.get('compiles', 0)}  "
                f"flops {_fmt(row.get('flops'))}  "
                f"mfu {_fmt(row.get('mfu'))}  "
                f"dispatches {_fmt(row.get('dispatches'))}"
                f"{aot_s}"
            )
    for cap in summary.get("profile_captures", []):
        lines.append(
            f"  profile capture: {cap.get('dir')} "
            f"({cap.get('duration_ms')} ms, {cap.get('total_bytes')} B)"
        )
    for err in summary.get("errors", [])[:5]:
        lines.append(
            f"  ! {err.get('ts')} {err.get('type')}: {err.get('error')}"
        )
    return "\n".join(lines)


# -- fleet read side ---------------------------------------------------------


def summarize_fleet(root: str) -> Dict[str, Any]:
    """Fold a fleet telemetry tree — the router's events.jsonl at
    ``root`` plus each replica's under ``root/<rid>/`` — into one
    combined summary. Each log is read through :func:`summarize` (so
    rotated segments are spanned per log); replica subdirectories
    without an event log (e.g. ``staging/``) are skipped. Raises
    FileNotFoundError when the ROUTER log is missing — a fleet dir
    without its control-plane log is the wrong directory."""
    from .telemetry import EVENTS_FILE

    router_log = os.path.join(root, EVENTS_FILE)
    out: Dict[str, Any] = {
        "path": root,
        "router": summarize(router_log),
        "replicas": {},
    }
    for name in sorted(os.listdir(root)):
        sub = os.path.join(root, name, EVENTS_FILE)
        if os.path.isfile(sub):
            out["replicas"][name] = summarize(sub)
    combined: Dict[str, int] = dict(out["router"]["event_counts"])
    errors = len(out["router"].get("errors", []))
    for rep in out["replicas"].values():
        for k, v in rep["event_counts"].items():
            combined[k] = combined.get(k, 0) + v
        errors += len(rep.get("errors", []))
    out["fleet"] = {
        "replica_logs": len(out["replicas"]),
        "event_counts": combined,
        "events_total": sum(combined.values()),
        "decisions": combined.get("decision", 0),
        "slo_alerts": combined.get("slo_alert", 0),
        "errors_total": errors,
    }
    return out


def render_fleet_table(summary: Dict[str, Any]) -> str:
    """Human-readable fleet summary (`cli telemetry --fleet`): one line
    per process log plus the combined rollup."""

    def counts(ec: Dict[str, int]) -> str:
        top = sorted(ec.items(), key=lambda kv: (-kv[1], kv[0]))[:8]
        rest = len(ec) - len(top)
        s = "  ".join(f"{k} x{v}" for k, v in top)
        return s + (f"  (+{rest} kinds)" if rest > 0 else "")

    lines = [f"fleet telemetry: {summary['path']}"]
    names = ["router", "combined"] + sorted(summary["replicas"])
    width = max(len(n) for n in names)
    lines.append(
        f"  {'router'.ljust(width)}  "
        f"{counts(summary['router']['event_counts'])}"
    )
    for name in sorted(summary["replicas"]):
        rep = summary["replicas"][name]
        lines.append(
            f"  {name.ljust(width)}  {counts(rep['event_counts'])}"
        )
    fl = summary["fleet"]
    lines.append(
        f"  {'combined'.ljust(width)}  {fl['events_total']} event(s) "
        f"across {1 + fl['replica_logs']} log(s); "
        f"{fl['decisions']} decision(s), {fl['slo_alerts']} slo "
        f"alert(s), {fl['errors_total']} error(s)"
    )
    for err in summary["router"].get("errors", [])[:5]:
        lines.append(
            f"  ! router {err.get('ts')} {err.get('type')}: "
            f"{err.get('error')}"
        )
    return "\n".join(lines)


def decision_timeline(events) -> List[Dict[str, Any]]:
    """The control-plane audit trail: every ``decision`` event (router
    ejections/readmits/breaker transitions, supervisor scale/hold/
    respawn/retire, rollout gate verdicts, operator overrides) joined
    against the ``slo_alert`` open/close transitions, in log order.
    Accepts raw event dicts (from ``read_events`` or the in-memory
    fleet-harness capture)."""
    rows: List[Dict[str, Any]] = []
    for ev in events:
        kind = ev.get("kind")
        if kind == "decision":
            rows.append({
                "ts": ev.get("ts"),
                "actor": ev.get("actor") or "?",
                "action": ev.get("action") or "?",
                "replica": ev.get("replica"),
                "inputs": dict(ev.get("inputs") or {}),
            })
        elif kind == "slo_alert":
            rows.append({
                "ts": ev.get("ts"),
                "actor": "slo",
                "action": f"{ev.get('state', '?')} {ev.get('slo', '?')}",
                "replica": None,
                "inputs": {
                    k: ev[k] for k in (
                        "burn_fast", "burn_slow", "events_fast",
                        "budget_remaining", "severity",
                    ) if ev.get(k) is not None
                },
            })
    return rows


def render_decision_timeline(
    rows: List[Dict[str, Any]], *, title: Optional[str] = None,
) -> str:
    """The `cli fleet explain` rendering: one line per decision, its
    inputs inline, so "why did the fleet do that" reads top to
    bottom."""
    lines = [title or f"fleet decision timeline ({len(rows)} entries)"]
    if not rows:
        lines.append(
            "  (no decision/slo_alert events — pre-observability log, "
            "or nothing happened)"
        )
        return "\n".join(lines)
    for r in rows:
        ts = r.get("ts") or ""
        if isinstance(ts, str) and "T" in ts:
            ts = ts.split("T", 1)[1].rstrip("Z")[:12]
        who = f"[{r['actor']}]"
        target = f" {r['replica']}" if r.get("replica") else ""
        inputs = "  ".join(
            f"{k}={_fmt(v)}" for k, v in r["inputs"].items()
        )
        lines.append(
            f"  {str(ts):<13} {who:<12} {r['action']}{target}"
            + (f"  {inputs}" if inputs else "")
        )
    return "\n".join(lines)
