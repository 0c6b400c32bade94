"""Metrics registry — counters, gauges and fixed-bucket histograms with
labeled series, behind one thread-safe snapshot API.

The port's copy of the JAX package's ``obs/registry.py`` (pure Python;
the same operations give the same snapshot and byte-identical
Prometheus text). The reference repo's only "metrics" are rank-0 prints
of AverageMeter deltas (mnist-dist2.py:109-150); here every layer
(trainer, servers, parallel backends) records into named series, and
one ``snapshot()`` renders the whole process state as plain dicts — the
data the JSONL event sink (obs/events.py) and the ``telemetry`` CLI
consume.

Threading: instruments are updated from the training loop, the heartbeat
thread and async checkpoint writers concurrently; every mutation holds
the owning registry's lock. Updates are O(1) host work (a float add
under a lock), cheap enough for per-step hot-loop use.
"""

from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Tuple

# Default latency buckets (seconds): 100us .. ~2min, roughly x2 spaced —
# wide enough for a CPU smoke step and a remote-tunnel dispatch alike.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing count, optionally split by labels."""

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, **labels: str) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels: str) -> float:
        with self._lock:
            return self._series.get(_label_key(labels), 0.0)

    def total(self) -> float:
        with self._lock:
            return sum(self._series.values())

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "type": "counter",
                "help": self.help,
                "series": [
                    {"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())
                ],
            }


class Gauge:
    """Last-written value (can go up or down), optionally labeled."""

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: Dict[Tuple, float] = {}

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._series[_label_key(labels)] = float(value)

    def value(self, **labels: str) -> Optional[float]:
        with self._lock:
            return self._series.get(_label_key(labels))

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "type": "gauge",
                "help": self.help,
                "series": [
                    {"labels": dict(k), "value": v}
                    for k, v in sorted(self._series.items())
                ],
            }


class _HistSeries:
    __slots__ = ("counts", "sum", "count", "min", "max")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1: overflow bucket
        self.sum = 0.0
        self.count = 0
        self.min = float("inf")
        self.max = float("-inf")


class Histogram:
    """Fixed-bucket histogram with percentile estimation.

    Buckets are upper bounds (le semantics); one implicit +inf overflow
    bucket catches the tail. ``percentile`` interpolates linearly inside
    the owning bucket — exact enough for p50/p95/p99 latency reporting
    (the buckets are ~x2 spaced, so the estimate is within ~2x and
    usually much closer; min/max are tracked exactly)."""

    def __init__(
        self, name: str, help: str, lock: threading.Lock,
        buckets: Iterable[float] = DEFAULT_TIME_BUCKETS,
    ):
        self.name = name
        self.help = help
        self._lock = lock
        self.buckets: List[float] = sorted(float(b) for b in buckets)
        if not self.buckets:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self._series: Dict[Tuple, _HistSeries] = {}

    def _get(self, labels: Dict[str, str]) -> _HistSeries:
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = _HistSeries(len(self.buckets))
        return s

    def observe(self, value: float, **labels: str) -> None:
        v = float(value)
        idx = bisect.bisect_left(self.buckets, v)
        with self._lock:
            s = self._get(labels)
            s.counts[idx] += 1
            s.sum += v
            s.count += 1
            s.min = min(s.min, v)
            s.max = max(s.max, v)

    def percentile(self, q: float, **labels: str) -> Optional[float]:
        """Estimated q-th percentile (q in [0, 100]) for a label set."""
        with self._lock:
            s = self._series.get(_label_key(labels))
            if s is None or s.count == 0:
                return None
            rank = q / 100.0 * s.count
            seen = 0
            for i, c in enumerate(s.counts):
                if c == 0:
                    continue
                if seen + c >= rank:
                    hi = (
                        self.buckets[i] if i < len(self.buckets) else s.max
                    )
                    lo = self.buckets[i - 1] if i > 0 else min(s.min, hi)
                    frac = (rank - seen) / c
                    return min(max(lo + (hi - lo) * frac, s.min), s.max)
                seen += c
            return s.max

    def mean(self, **labels: str) -> Optional[float]:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.sum / s.count if s is not None and s.count else None

    def count(self, **labels: str) -> int:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s.count if s is not None else 0

    def snapshot(self) -> Dict:
        with self._lock:
            series = []
            for k, s in sorted(self._series.items()):
                series.append({
                    "labels": dict(k),
                    "count": s.count,
                    "sum": s.sum,
                    "min": s.min if s.count else None,
                    "max": s.max if s.count else None,
                    "bucket_counts": list(s.counts),
                })
            return {
                "type": "histogram",
                "help": self.help,
                "buckets": list(self.buckets),
                "series": series,
            }


class MetricsRegistry:
    """Name -> instrument map. ``counter``/``gauge``/``histogram`` are
    get-or-create (repeat calls return the same instrument, so call
    sites don't need to coordinate); a name registered as one kind
    cannot be re-registered as another."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}

    def _get_or_create(self, name: str, cls, factory):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                # jg: disable=JG010 -- factories are this module's own instrument constructors (the counter/gauge/histogram lambdas below), never user code: they cannot re-enter the registry, and get-or-create must stay atomic so a name maps to ONE instrument
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, cls):
                raise ValueError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, not {cls.__name__}"
                )
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(
            name, Counter, lambda: Counter(name, help, self._lock)
        )

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(
            name, Gauge, lambda: Gauge(name, help, self._lock)
        )

    def histogram(
        self, name: str, help: str = "",
        buckets: Iterable[float] = DEFAULT_TIME_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            name, Histogram,
            lambda: Histogram(name, help, self._lock, buckets),
        )

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-dict view of every instrument (JSON-serializable)."""
        with self._lock:
            instruments = dict(self._instruments)
        return {name: inst.snapshot() for name, inst in
                sorted(instruments.items())}


def _prom_escape(value: str) -> str:
    """Label-VALUE escaping (backslash, quote, newline)."""
    return (
        str(value)
        .replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
    )


def _prom_escape_help(value: str) -> str:
    """HELP-line escaping — the exposition format escapes only
    backslash and newline here (quotes are label-value-only)."""
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_prom_escape(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _prom_num(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def render_prometheus(snapshot: Dict[str, Dict]) -> str:
    """Render a registry ``snapshot()`` in the Prometheus text
    exposition format (version 0.0.4) — the ``/metrics`` content both
    serving front ends return under ``Accept: text/plain``, so a stock
    Prometheus scraper can watch a replica fleet without a JSON
    adapter. Counters/gauges map directly; histograms emit cumulative
    ``_bucket{le=...}`` series (the snapshot's per-bucket counts summed
    left to right), ``_sum`` and ``_count``."""
    lines: List[str] = []
    for name, inst in sorted(snapshot.items()):
        kind = inst.get("type")
        if kind not in ("counter", "gauge", "histogram"):
            continue
        if inst.get("help"):
            lines.append(
                f"# HELP {name} {_prom_escape_help(inst['help'])}"
            )
        lines.append(f"# TYPE {name} {kind}")
        if kind in ("counter", "gauge"):
            for s in inst.get("series", []):
                lines.append(
                    f"{name}{_prom_labels(s.get('labels', {}))} "
                    f"{_prom_num(s['value'])}"
                )
            continue
        buckets = inst.get("buckets", [])
        for s in inst.get("series", []):
            labels = s.get("labels", {})
            cum = 0
            counts = s.get("bucket_counts", [])
            for le, c in zip(buckets, counts):
                cum += int(c)
                lines.append(
                    f"{name}_bucket"
                    f"{_prom_labels({**labels, 'le': repr(float(le))})} "
                    f"{cum}"
                )
            lines.append(
                f"{name}_bucket{_prom_labels({**labels, 'le': '+Inf'})} "
                f"{int(s.get('count', 0))}"
            )
            lines.append(
                f"{name}_sum{_prom_labels(labels)} "
                f"{_prom_num(s.get('sum', 0.0))}"
            )
            lines.append(
                f"{name}_count{_prom_labels(labels)} "
                f"{int(s.get('count', 0))}"
            )
    return "\n".join(lines) + ("\n" if lines else "")


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every layer records into by default.

    One registry per process keeps the ``telemetry`` CLI and the event
    sink's snapshots complete without plumbing a registry handle through
    every call site; tests that need isolation construct their own
    MetricsRegistry."""
    return _default_registry
