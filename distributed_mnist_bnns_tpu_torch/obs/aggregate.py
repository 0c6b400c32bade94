"""Fleet-wide metric aggregation: merge N registry snapshots into one.

The port's copy of the JAX package's ``obs/aggregate.py`` (pure host
code; the merged text is byte-equal to that module's on the same
snapshots). Every fleet process has its own registry and `/metrics`;
this module is the reduce step over them. A snapshot here is exactly what
:meth:`~.registry.MetricsRegistry.snapshot` renders — plain dicts, no
live instruments — so merging works identically over HTTP-scraped
replica bodies, in-process registries, and post-mortem `metrics`
events from a log.

Merge semantics (the contract OBSERVABILITY.md "Fleet observability"
documents and tests/test_torch_fleet_obs.py pins):

  * **counters** sum by label key — fleet `requests_total` is the sum
    of replica `requests_total`, per label set.
  * **gauges** cannot meaningfully sum alone (queue depths on two
    replicas are two facts, not one), so every source series survives
    with an added ``replica=<source>`` label, plus synthesized
    ``replica="fleet"`` series carrying ``agg="min"|"max"|"sum"`` per
    original label set — dashboards get both the per-replica fan-out
    and the fleet envelope.
  * **histograms** merge their cumulative ``le`` buckets EXACTLY:
    element-wise ``bucket_counts`` sums plus summed ``sum``/``count``
    and min/max of the exact extrema. This is only exact when every
    source used identical bucket boundaries (true for a fleet running
    one code version); a source with mismatched boundaries is dropped
    from that metric and recorded in ``FleetSnapshot.conflicts``
    rather than merged approximately — a silently-wrong p99 is worse
    than a missing replica.

Type conflicts (one source says counter, another histogram) keep the
first-seen type and record the rest as conflicts, same policy.

:class:`FleetMetricsStore` holds the latest scraped snapshot +
`/healthz` payload per replica (the router's scrape loop writes it),
and :class:`FleetMetricsView` fronts the store plus the router's own
local registry behind a single ``.snapshot()`` — the exact duck type
``serve/httpbase.py``'s ``_reply_metrics`` negotiates into JSON or
Prometheus text, so the fleet `/metrics` endpoint is one object swap.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

__all__ = [
    "FleetSnapshot",
    "FleetMetricsStore",
    "FleetMetricsView",
    "merge_snapshots",
    "healthz_rollup",
]


def _label_key(labels: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    """The registry's canonical series key (sorted string pairs)."""
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


class FleetSnapshot(dict):
    """A merged snapshot: a plain ``{name: metric}`` dict (renders
    through ``render_prometheus`` / JSON unchanged) plus a
    ``conflicts`` attribute listing every source×metric the merge had
    to drop (type or bucket-boundary mismatch)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.conflicts: List[str] = []


def merge_snapshots(
    sources: Mapping[str, Mapping[str, dict]],
    *,
    source_label: str = "replica",
) -> FleetSnapshot:
    """Merge ``{source_name: registry_snapshot}`` into one snapshot.

    Deterministic: sources are processed in sorted name order, so two
    scrapes of the same fleet state render byte-identical Prometheus
    text. Input snapshots are never mutated.
    """
    merged = FleetSnapshot()
    # name -> type/help/buckets resolved from the first source seen
    shapes: Dict[str, dict] = {}
    # counters: name -> {label_key: (labels, value)}
    counters: Dict[str, Dict[tuple, list]] = {}
    # gauges: name -> {orig_label_key: (labels, [per-source values])}
    gauge_rows: Dict[str, List[dict]] = {}
    gauge_aggs: Dict[str, Dict[tuple, list]] = {}
    # histograms: name -> {label_key: merged series row}
    hists: Dict[str, Dict[tuple, dict]] = {}

    for src in sorted(sources):
        snapshot = sources[src] or {}
        for name in sorted(snapshot):
            metric = snapshot[name]
            if not isinstance(metric, dict) or "type" not in metric:
                merged.conflicts.append(f"{src}/{name}: malformed metric")
                continue
            mtype = metric["type"]
            shape = shapes.get(name)
            if shape is None:
                shape = {
                    "type": mtype,
                    "help": metric.get("help", ""),
                    "buckets": list(metric.get("buckets") or []),
                }
                shapes[name] = shape
            elif shape["type"] != mtype:
                merged.conflicts.append(
                    f"{src}/{name}: type {mtype!r} != {shape['type']!r}"
                )
                continue
            series = metric.get("series") or []
            if mtype == "counter":
                rows = counters.setdefault(name, {})
                for s in series:
                    key = _label_key(s.get("labels") or {})
                    row = rows.get(key)
                    if row is None:
                        rows[key] = [dict(s.get("labels") or {}),
                                     float(s.get("value", 0.0))]
                    else:
                        row[1] += float(s.get("value", 0.0))
            elif mtype == "gauge":
                rows_out = gauge_rows.setdefault(name, [])
                aggs = gauge_aggs.setdefault(name, {})
                for s in series:
                    labels = dict(s.get("labels") or {})
                    value = float(s.get("value", 0.0))
                    rows_out.append({
                        "labels": {**labels, source_label: src},
                        "value": value,
                    })
                    agg = aggs.setdefault(_label_key(labels),
                                          [labels, []])
                    agg[1].append(value)
            elif mtype == "histogram":
                if list(metric.get("buckets") or []) != shape["buckets"]:
                    merged.conflicts.append(
                        f"{src}/{name}: bucket boundaries "
                        f"{metric.get('buckets')} != {shape['buckets']} "
                        "(dropped: cannot merge exactly)"
                    )
                    continue
                rows = hists.setdefault(name, {})
                n_counts = len(shape["buckets"]) + 1
                for s in series:
                    key = _label_key(s.get("labels") or {})
                    counts = list(s.get("bucket_counts") or [])
                    if len(counts) != n_counts:
                        merged.conflicts.append(
                            f"{src}/{name}: bucket_counts length "
                            f"{len(counts)} != {n_counts} (dropped)"
                        )
                        continue
                    row = rows.get(key)
                    if row is None:
                        rows[key] = {
                            "labels": dict(s.get("labels") or {}),
                            "count": int(s.get("count", 0)),
                            "sum": float(s.get("sum", 0.0)),
                            "min": s.get("min"),
                            "max": s.get("max"),
                            "bucket_counts": counts,
                        }
                    else:
                        row["count"] += int(s.get("count", 0))
                        row["sum"] += float(s.get("sum", 0.0))
                        for lo_hi, pick in (("min", min), ("max", max)):
                            v = s.get(lo_hi)
                            if v is not None:
                                row[lo_hi] = (
                                    v if row[lo_hi] is None
                                    else pick(row[lo_hi], v)
                                )
                        row["bucket_counts"] = [
                            a + b for a, b in zip(row["bucket_counts"],
                                                  counts)
                        ]
            else:
                merged.conflicts.append(
                    f"{src}/{name}: unknown type {mtype!r}"
                )

    for name, rows in counters.items():
        merged[name] = {
            "type": "counter",
            "help": shapes[name]["help"],
            "series": [{"labels": labels, "value": value}
                       for labels, value in rows.values()],
        }
    for name, rows_out in gauge_rows.items():
        fleet_rows = []
        for labels, values in gauge_aggs[name].values():
            for agg, value in (("min", min(values)), ("max", max(values)),
                               ("sum", sum(values))):
                fleet_rows.append({
                    "labels": {**labels, source_label: "fleet",
                               "agg": agg},
                    "value": value,
                })
        merged[name] = {
            "type": "gauge",
            "help": shapes[name]["help"],
            "series": rows_out + fleet_rows,
        }
    for name, rows in hists.items():
        merged[name] = {
            "type": "histogram",
            "help": shapes[name]["help"],
            "buckets": shapes[name]["buckets"],
            "series": list(rows.values()),
        }
    return merged


def healthz_rollup(
    replica_rows: List[Mapping[str, Any]],
    healthz: Mapping[str, Mapping[str, Any]],
) -> Dict[str, Any]:
    """Fold the router's per-replica rows plus the scraped `/healthz`
    payloads into the fleet rollup the fleet `/healthz` reports:
    healthy/total counts, the worst replica status, and the per-replica
    detail (router view + last scraped body side by side)."""
    order = {"ok": 0, "draining": 1, "unknown": 2, "failed": 3}
    worst = "ok" if replica_rows else "unknown"
    per_replica = []
    healthy = 0
    for row in replica_rows:
        rid = row.get("replica") or row.get("id")
        scraped = dict(healthz.get(rid) or {})
        status = scraped.get("status") or (
            "ok" if row.get("healthy") else "unknown"
        )
        if row.get("healthy"):
            healthy += 1
        else:
            status = scraped.get("status") or "failed"
            if status == "ok":      # router ejected it since the scrape
                status = "unknown"
        if order.get(status, 3) > order.get(worst, 0):
            worst = status
        per_replica.append({**row, "scraped": scraped or None,
                            "status": status})
    return {
        "replicas_total": len(replica_rows),
        "replicas_healthy": healthy,
        "status": worst if healthy else ("unknown" if not replica_rows
                                         else "failed"),
        "replicas": per_replica,
    }


class FleetMetricsStore:
    """Latest scraped snapshot + `/healthz` body per replica, written
    by the router's scrape loop and read by the fleet `/metrics` /
    `/healthz` endpoints. Thread-safe; ``clock`` injectable for
    tests."""

    def __init__(self, *, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._lock = threading.Lock()
        self._snapshots: Dict[str, dict] = {}
        self._healthz: Dict[str, dict] = {}
        self._scraped_at: Dict[str, float] = {}
        self._errors: Dict[str, str] = {}

    def update(self, rid: str, *, snapshot: Optional[dict] = None,
               healthz: Optional[dict] = None,
               error: Optional[str] = None) -> None:
        with self._lock:
            if error is not None:
                self._errors[rid] = error
                return
            self._errors.pop(rid, None)
            if snapshot is not None:
                self._snapshots[rid] = snapshot
            if healthz is not None:
                self._healthz[rid] = healthz
            self._scraped_at[rid] = self._clock()

    def discard(self, rid: str) -> None:
        """Forget a retired/dead replica — its counters would otherwise
        freeze into the fleet sums forever."""
        with self._lock:
            self._snapshots.pop(rid, None)
            self._healthz.pop(rid, None)
            self._scraped_at.pop(rid, None)
            self._errors.pop(rid, None)

    def snapshots(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._snapshots)

    def healthz(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._healthz)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            now = self._clock()
            return {
                "replicas_scraped": len(self._snapshots),
                "scrape_age_s": {
                    rid: round(now - t, 3)
                    for rid, t in self._scraped_at.items()
                },
                "scrape_errors": dict(self._errors),
            }


class FleetMetricsView:
    """``.snapshot()`` facade over (local control-plane registry) +
    (scraped replica snapshots): the object the fleet `/metrics` hands
    to ``_reply_metrics``, which then renders JSON or Prometheus via
    the existing content negotiation."""

    def __init__(self, local_registry: Any, store: FleetMetricsStore,
                 *, local_name: str = "router"):
        self._local = local_registry
        self._store = store
        self._local_name = local_name

    def snapshot(self) -> FleetSnapshot:
        sources = {self._local_name: self._local.snapshot()}
        sources.update(self._store.snapshots())
        return merge_snapshots(sources)
