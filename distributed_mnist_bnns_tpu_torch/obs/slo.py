"""Declarative SLOs with multiwindow multi-burn-rate alerting (the port's
copy of the JAX package's ``obs/slo.py``; its records are byte-equal).

The Google SRE Workbook's production alerting shape over the repo's
own metrics plane: an :class:`SLOSpec` states an objective ("99% of
routed requests succeed", "99% of requests finish under 1500 ms") and
the monitor tracks the **burn rate** — the rate the error budget is
being consumed, as a multiple of the sustainable rate:

    burn = (bad fraction over window) / (1 - objective)

Burn 1.0 spends exactly the budget over the budget window; burn 14.4
exhausts a 30-day budget in 2 days — the classic page threshold. One
window can't alert well alone: a short window pages on blips, a long
window pages an hour late and stays red long after recovery. So each
spec evaluates TWO windows and an alert **opens** only when the fast
AND slow burn both exceed their thresholds (sustained, current), and
**closes** when the fast window drains below its threshold (recovery
is visible quickly, because the short window forgets quickly).

Everything is clock-injectable and pure-host: ``observe_*`` feeds
(timestamp, good?) pairs into per-second-ish ring buckets, and
``evaluate(now)`` — called from the router's probe loop, the fleet
harness, or a test driving a fake clock — computes burn rates, sets
the ``slo_burn_rate``/``slo_budget_remaining`` gauges, and emits
``slo_alert`` open/close events through whatever ``emit`` callable it
was given (a ``Telemetry.emit``, or a plain list appender in the
chaos harness). Nothing here imports torch or does I/O.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "SLOSpec",
    "SLOMonitor",
    "default_fleet_slos",
]

SLO_BURN_RATE = "slo_burn_rate"
SLO_BUDGET_REMAINING = "slo_budget_remaining"
SLO_ALERTS_TOTAL = "slo_alerts_total"


@dataclass(frozen=True)
class SLOSpec:
    """One objective plus its alerting windows.

    ``signal`` selects what an observation means:

      * ``availability`` — good = the request completed ok;
      * ``latency`` — good = the request completed ok AND under
        ``threshold_ms`` (a failed request burns latency budget too:
        users experience it as slow, not as fast-and-broken).

    ``stream`` routes observations: ``request`` specs consume
    :meth:`SLOMonitor.observe_request`, ``lm_token`` specs consume
    :meth:`SLOMonitor.observe_token` (LM inter-token latency).
    """

    name: str
    objective: float                      # good fraction, e.g. 0.999
    signal: str = "availability"          # availability | latency
    threshold_ms: Optional[float] = None  # latency signal only
    stream: str = "request"               # request | lm_token
    fast_window_s: float = 60.0
    slow_window_s: float = 300.0
    fast_burn: float = 14.4               # page thresholds (SRE WB)
    slow_burn: float = 6.0
    budget_window_s: float = 3600.0       # budget-remaining horizon
    min_events: int = 10                  # below this: no alerting

    def __post_init__(self):
        if not 0.0 < self.objective < 1.0:
            raise ValueError("objective must be in (0, 1)")
        if self.signal not in ("availability", "latency"):
            raise ValueError(f"unknown signal {self.signal!r}")
        if self.signal == "latency" and self.threshold_ms is None:
            raise ValueError("latency signal requires threshold_ms")
        if self.fast_window_s >= self.slow_window_s:
            raise ValueError("fast window must be shorter than slow")


def default_fleet_slos(
    *,
    availability_objective: float = 0.99,
    request_p99_ms: float = 1500.0,
    lm_inter_token_p99_ms: float = 250.0,
    fast_window_s: float = 60.0,
    slow_window_s: float = 300.0,
) -> Tuple[SLOSpec, ...]:
    """The three SLOs the fleet router tracks out of the box: routed
    availability, request latency p99 (as a threshold objective: 99%
    under the deadline-ish bound), and LM inter-token p99."""
    return (
        SLOSpec("availability", availability_objective,
                signal="availability",
                fast_window_s=fast_window_s, slow_window_s=slow_window_s),
        SLOSpec("request_p99", 0.99, signal="latency",
                threshold_ms=request_p99_ms,
                fast_window_s=fast_window_s, slow_window_s=slow_window_s),
        SLOSpec("lm_inter_token_p99", 0.99, signal="latency",
                threshold_ms=lm_inter_token_p99_ms, stream="lm_token",
                fast_window_s=fast_window_s, slow_window_s=slow_window_s),
    )


class _Track:
    """Ring of (bucket_start, good, total) for one spec. Bucket width
    adapts to the fast window so a 0.5 s chaos-probe window still gets
    ~30 evaluation points."""

    def __init__(self, spec: SLOSpec):
        self.spec = spec
        self.bucket_s = max(spec.fast_window_s / 30.0, 0.02)
        horizon = max(spec.slow_window_s, spec.budget_window_s)
        self.buckets: deque = deque(
            maxlen=int(horizon / self.bucket_s) + 2
        )
        self.state = "ok"                 # ok | open
        self.opens = 0
        self.closes = 0
        self.good_total = 0
        self.total = 0

    def observe(self, good: bool, now: float) -> None:
        start = now - (now % self.bucket_s)
        if not self.buckets or self.buckets[-1][0] != start:
            self.buckets.append([start, 0, 0])
        row = self.buckets[-1]
        row[1] += 1 if good else 0
        row[2] += 1
        self.good_total += 1 if good else 0
        self.total += 1

    def window(self, now: float, window_s: float) -> Tuple[int, int]:
        """(good, total) over [now - window_s, now]."""
        cutoff = now - window_s
        good = total = 0
        for start, g, t in reversed(self.buckets):
            if start + self.bucket_s < cutoff:
                break
            good += g
            total += t
        return good, total

    def burn(self, now: float, window_s: float) -> Tuple[float, int]:
        good, total = self.window(now, window_s)
        if total == 0:
            return 0.0, 0
        bad_frac = 1.0 - good / total
        return bad_frac / (1.0 - self.spec.objective), total


class SLOMonitor:
    """Evaluates a set of :class:`SLOSpec` over observed outcomes.

    Thread-safe (the router's dispatch threads observe while the probe
    loop evaluates). ``registry`` (optional) receives the burn-rate /
    budget gauges; ``emit(kind, **fields)`` (optional) receives
    ``slo_alert`` events; ``clock`` is injectable — unit tests drive
    open→close transitions deterministically with a fake clock.
    """

    def __init__(
        self,
        specs: Sequence[SLOSpec] = (),
        *,
        registry: Any = None,
        emit: Optional[Callable[..., Any]] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not specs:
            specs = default_fleet_slos()
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO names: {names}")
        self._clock = clock
        self._emit = emit
        self._lock = threading.Lock()
        self._tracks = {s.name: _Track(s) for s in specs}
        self._burn_gauge = self._budget_gauge = self._alerts_ctr = None
        if registry is not None:
            self._burn_gauge = registry.gauge(
                SLO_BURN_RATE,
                "SLO error-budget burn rate (1.0 = sustainable)",
            )
            self._budget_gauge = registry.gauge(
                SLO_BUDGET_REMAINING,
                "fraction of SLO error budget left over the budget window",
            )
            self._alerts_ctr = registry.counter(
                SLO_ALERTS_TOTAL, "SLO alert transitions"
            )

    @property
    def specs(self) -> Tuple[SLOSpec, ...]:
        return tuple(t.spec for t in self._tracks.values())

    # -- feeding ---------------------------------------------------------

    def observe_request(self, ok: bool, latency_ms: Optional[float] = None,
                        now: Optional[float] = None) -> None:
        """One routed request at its final status."""
        now = self._clock() if now is None else now
        with self._lock:
            for track in self._tracks.values():
                spec = track.spec
                if spec.stream != "request":
                    continue
                if spec.signal == "availability":
                    track.observe(bool(ok), now)
                else:
                    good = bool(ok) and latency_ms is not None \
                        and latency_ms <= spec.threshold_ms
                    track.observe(good, now)

    def observe_token(self, inter_token_ms: float,
                      now: Optional[float] = None) -> None:
        """One LM decode inter-token gap."""
        now = self._clock() if now is None else now
        with self._lock:
            for track in self._tracks.values():
                spec = track.spec
                if spec.stream != "lm_token":
                    continue
                track.observe(inter_token_ms <= spec.threshold_ms, now)

    # -- evaluating ------------------------------------------------------

    def evaluate(self, now: Optional[float] = None) -> List[dict]:
        """Recompute burn rates, update gauges, emit open/close
        transitions. Returns the transitions (possibly empty)."""
        now = self._clock() if now is None else now
        transitions: List[dict] = []
        with self._lock:
            for name, track in self._tracks.items():
                spec = track.spec
                burn_fast, n_fast = track.burn(now, spec.fast_window_s)
                burn_slow, n_slow = track.burn(now, spec.slow_window_s)
                _, n_budget = track.window(now, spec.budget_window_s)
                budget_burn, _ = track.burn(now, spec.budget_window_s)
                budget_remaining = 1.0 - budget_burn
                if self._burn_gauge is not None:
                    self._burn_gauge.set(round(burn_fast, 4),
                                         slo=name, window="fast")
                    self._burn_gauge.set(round(burn_slow, 4),
                                         slo=name, window="slow")
                    self._budget_gauge.set(round(budget_remaining, 4),
                                           slo=name)
                enough = n_fast >= spec.min_events
                fields = {
                    "slo": name,
                    "signal": spec.signal,
                    "objective": spec.objective,
                    "burn_fast": round(burn_fast, 4),
                    "burn_slow": round(burn_slow, 4),
                    "fast_window_s": spec.fast_window_s,
                    "slow_window_s": spec.slow_window_s,
                    "events_fast": n_fast,
                    "events_slow": n_slow,
                    "budget_remaining": round(budget_remaining, 4),
                    "severity": "page",
                }
                if (track.state == "ok" and enough
                        and burn_fast >= spec.fast_burn
                        and burn_slow >= spec.slow_burn):
                    track.state = "open"
                    track.opens += 1
                    transitions.append({**fields, "state": "open"})
                elif track.state == "open" and burn_fast < spec.fast_burn:
                    track.state = "ok"
                    track.closes += 1
                    transitions.append({**fields, "state": "close"})
        for tr in transitions:
            if self._alerts_ctr is not None:
                self._alerts_ctr.inc(slo=tr["slo"], state=tr["state"])
            if self._emit is not None:
                self._emit("slo_alert", **tr)
        return transitions

    # -- reading ---------------------------------------------------------

    def state(self, name: str) -> str:
        with self._lock:
            return self._tracks[name].state

    def open_alerts(self) -> List[str]:
        with self._lock:
            return [n for n, t in self._tracks.items()
                    if t.state == "open"]

    def summary(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Per-SLO compliance report — the fleet harness embeds this in
        its section, so a gate can score SLO compliance, not just raw
        availability."""
        now = self._clock() if now is None else now
        out: Dict[str, dict] = {}
        with self._lock:
            for name, track in self._tracks.items():
                spec = track.spec
                burn_fast, n_fast = track.burn(now, spec.fast_window_s)
                budget_burn, _ = track.burn(now, spec.budget_window_s)
                good_frac = (track.good_total / track.total
                             if track.total else None)
                out[name] = {
                    "signal": spec.signal,
                    "objective": spec.objective,
                    "events_total": track.total,
                    "good_fraction": (round(good_frac, 5)
                                      if good_frac is not None else None),
                    "burn_fast": round(burn_fast, 4),
                    "budget_remaining": round(1.0 - budget_burn, 4),
                    "state": track.state,
                    "alerts_opened": track.opens,
                    "alerts_closed": track.closes,
                    "compliant": (track.state == "ok"
                                  and (good_frac is None
                                       or good_frac >= spec.objective)),
                }
        return out
