"""Circuit breaker for a flaky dependency (the serving predictor call).

A framework-free copy of ``CircuitBreaker`` from the JAX package's
``resilience/policy.py``. The retry policy and failure classification
there belong to training and are not in this package yet.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

log = logging.getLogger(__name__)


class CircuitBreaker:
    """Closed → open → half-open failure fence around a flaky dependency.

    Retrying into a dependency that is *down* is worse than failing: every
    caller blocks for a full timeout, queues behind it collapse, and the
    dependency gets hammered exactly when it needs slack (Dean & Barroso,
    "The Tail at Scale"). The breaker converts that into fast-fail:

      closed     normal operation; ``failure_threshold`` CONSECUTIVE
                 ``record_failure`` calls trip it open (any success
                 resets the streak)
      open       ``allow()`` returns False — callers fail fast without
                 touching the dependency — until ``reset_timeout_s`` has
                 elapsed
      half-open  the first ``allow()`` after the timeout transitions here
                 and admits up to ``half_open_probes`` probe calls; all
                 probes succeeding closes the breaker, any probe failure
                 re-opens it (and restarts the timeout)

    Thread-safe: the serving engine, admission path and health endpoint
    read/write concurrently. ``clock`` is injectable for tests.
    ``on_transition(old, new, reason)`` fires outside the lock after any
    state change — the serving layer uses it to count transitions.

    Used by serve/ around the packed-predictor call (a stall past the
    stall budget counts as a failure, not only an exception).
    """

    def __init__(
        self,
        *,
        failure_threshold: int = 5,
        reset_timeout_s: float = 30.0,
        half_open_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str, str], None]] = None,
    ):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_probes = max(int(half_open_probes), 1)
        self._clock = clock
        self._on_transition = on_transition
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_issued = 0
        self._probe_successes = 0

    @property
    def state(self) -> str:
        """``"closed"`` | ``"open"`` | ``"half_open"`` (point-in-time;
        an elapsed open breaker still reads "open" until the next
        ``allow()`` issues the probe)."""
        with self._lock:
            return self._state

    def _set(self, new: str, reason: str):
        """Lock held. Returns the deferred transition callback."""
        old, self._state = self._state, new
        log.warning("circuit breaker %s -> %s (%s)", old, new, reason)
        cb = self._on_transition
        return (lambda: cb(old, new, reason)) if cb is not None else None

    def seconds_until_half_open(self) -> float:
        """Remaining open time before the next ``allow()`` may issue a
        half-open probe; 0.0 unless open with the timeout still
        running. The serving layer turns this into the ``Retry-After``
        hint on breaker-shed 503s — a client that retries sooner is
        guaranteed another fast-fail."""
        with self._lock:
            if self._state != "open":
                return 0.0
            remaining = self.reset_timeout_s - (
                self._clock() - self._opened_at
            )
            return max(remaining, 0.0)

    def admits(self) -> bool:
        """Read-only admission check: False only while open with the
        reset timeout still running. Unlike ``allow()`` this never
        consumes a half-open probe slot, so the admission path can
        fast-fail queued-up work without starving the probe that the
        worker's ``allow()`` must issue."""
        with self._lock:
            return not (
                self._state == "open"
                and self._clock() - self._opened_at < self.reset_timeout_s
            )

    def allow(self) -> bool:
        """May this call proceed? Performs the open → half-open
        transition once the reset timeout elapses; in half-open, admits
        at most ``half_open_probes`` calls."""
        notify = None
        with self._lock:
            if self._state == "closed":
                allowed = True
            elif self._state == "open":
                if self._clock() - self._opened_at >= self.reset_timeout_s:
                    notify = self._set("half_open", "reset timeout elapsed")
                    self._probes_issued = 1
                    self._probe_successes = 0
                    allowed = True
                else:
                    allowed = False
            else:  # half_open
                allowed = self._probes_issued < self.half_open_probes
                if allowed:
                    self._probes_issued += 1
        if notify is not None:
            notify()
        return allowed

    def record_success(self) -> None:
        notify = None
        with self._lock:
            if self._state == "closed":
                self._consecutive_failures = 0
            elif self._state == "half_open":
                self._probe_successes += 1
                if self._probe_successes >= self.half_open_probes:
                    notify = self._set(
                        "closed",
                        f"{self._probe_successes} probe(s) succeeded",
                    )
                    self._consecutive_failures = 0
        if notify is not None:
            notify()

    def record_failure(self, reason: str = "") -> None:
        notify = None
        with self._lock:
            if self._state == "half_open":
                notify = self._set(
                    "open", reason or "half-open probe failed"
                )
                self._opened_at = self._clock()
            elif self._state == "closed":
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.failure_threshold:
                    notify = self._set(
                        "open",
                        reason
                        or f"{self._consecutive_failures} consecutive "
                           "failures",
                    )
                    self._opened_at = self._clock()
            # already open: stay open; the timeout keeps its epoch so a
            # herd of late failures cannot push recovery out forever.
        if notify is not None:
            notify()
