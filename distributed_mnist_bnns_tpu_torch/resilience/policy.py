"""Retry policy for training, and a circuit breaker for serving.

A framework-free copy of the JAX package's ``resilience/policy.py``:

  * classification: a missing dataset fails the same way every time, so
    config and programming errors are fatal; IO, injected chaos faults
    (``resilience.chaos.ChaosFault``) and unknown runtime faults are
    transient; ``Preempted`` resumes without counting against the
    failure budget;
  * jittered exponential backoff (``base * factor ** n`` capped at
    ``max_backoff_s``, the top ``jitter`` fraction drawn at random from
    ``seed``), so restarting workers do not retry in lockstep;
  * ``run_with_policy`` rebuilds the trainer (which, with
    ``TrainConfig.resume``, restores the newest verified checkpoint
    generation) and runs again; every rebuild is a ``restart`` event
    (with the failed attempt's ``trainer_topology``) and a
    ``restarts_total{cause}`` count in the ``obs`` telemetry;
  * ``CircuitBreaker`` fences the serving predictor call.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Tuple, TypeVar

from .chaos import ChaosFault
from .preempt import Preempted

log = logging.getLogger(__name__)

T = TypeVar("T")

RESTARTS_TOTAL = "restarts_total"

# Exceptions that a restart cannot fix. KeyboardInterrupt and SystemExit
# are fatal too, and never wrapped.
DEFAULT_FATAL_TYPES: Tuple[type, ...] = (
    FileNotFoundError,
    NotADirectoryError,
    IsADirectoryError,
    PermissionError,
    ValueError,
    TypeError,
    AttributeError,
    KeyError,
    IndexError,
    ImportError,
    NotImplementedError,
    AssertionError,
)


class TrainingFailure(RuntimeError):
    """Training kept failing past the retry budget."""


def trainer_topology(trainer: Any) -> Tuple[int, dict]:
    """``(data-parallel world, {axis: size})`` of a trainer, recorded on
    restart, resume and remesh events and in checkpoint metas: a
    multihost rank's world is its host count (``{"host": hosts}``), a
    trainer in a process group its group's, ``(1, {})`` otherwise."""
    mh = getattr(trainer, "_mh", None)
    if mh:
        return int(mh["hosts"]), {"host": int(mh["hosts"])}
    if trainer is None or not getattr(trainer, "distributed", False):
        return 1, {}
    mesh = getattr(trainer, "mesh", None)
    if mesh is not None:
        return int(trainer.dp_n), dict(mesh.shape)
    return int(trainer.world), {"data": int(trainer.world)}


def classify_failure(exc: BaseException, *,
                     fatal_types: Tuple[type, ...] = DEFAULT_FATAL_TYPES,
                     transient_types: Tuple[type, ...] = ()) -> str:
    """``"preempt"``, ``"transient"`` or ``"fatal"``. ``transient_types``
    wins over ``fatal_types``; an unknown exception is transient."""
    if isinstance(exc, Preempted):
        return "preempt"
    if isinstance(exc, ChaosFault):
        return "transient"
    if transient_types and isinstance(exc, transient_types):
        return "transient"
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return "fatal"
    if isinstance(exc, fatal_types):
        return "fatal"
    return "transient"


@dataclass
class RetryPolicy:
    """Restart budget, backoff shape and classification overrides."""

    max_restarts: int = 2          # transient-failure budget
    max_preemptions: int = 64      # graceful-stop resumes (apart: a
                                   # preemption is routine, not a failure)
    base_backoff_s: float = 1.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 60.0
    jitter: float = 0.5            # top fraction of the delay randomized
    seed: Optional[int] = None     # None: nondeterministic jitter
    fatal_types: Tuple[type, ...] = DEFAULT_FATAL_TYPES
    transient_types: Tuple[type, ...] = ()
    _rng: random.Random = field(init=False, repr=False)

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)

    def classify(self, exc: BaseException) -> str:
        return classify_failure(exc, fatal_types=self.fatal_types,
                                transient_types=self.transient_types)

    def backoff(self, attempt: int) -> float:
        """The delay before retry ``attempt`` (from 1): capped exponential,
        uniform over its top ``jitter`` fraction."""
        raw = min(self.base_backoff_s * self.backoff_factor ** (attempt - 1),
                  self.max_backoff_s)
        if raw <= 0:
            return 0.0
        floor = raw * (1.0 - min(max(self.jitter, 0.0), 1.0))
        return floor + self._rng.random() * (raw - floor)


def _note_restart(telemetry: Any, *, cause: str, attempt: int,
                  error: BaseException, backoff_s: float,
                  trainer: Any = None) -> None:
    from ..obs import default_registry

    registry = (telemetry.registry if telemetry is not None
                else default_registry())
    registry.counter(RESTARTS_TOTAL, "resilient-loop trainer restarts"
                     ).inc(cause=cause)
    if telemetry is not None:
        world_size, mesh_shape = trainer_topology(trainer)
        telemetry.emit(
            "restart", cause=cause, attempt=attempt,
            error_type=type(error).__name__, error=str(error)[:500],
            backoff_s=round(backoff_s, 3), world_size=world_size,
            mesh_shape=mesh_shape)


def handle_preemption(e: Preempted, *, policy: RetryPolicy,
                      preemptions: int, telemetry: Any = None,
                      trainer: Any = None) -> int:
    """Count a preemption against ``max_preemptions`` (a ``restart``
    event of cause ``preemption``); returns the new count, raises
    ``TrainingFailure`` past the budget."""
    preemptions += 1
    if preemptions > policy.max_preemptions:
        raise TrainingFailure(f"preempted {preemptions} times; "
                              "giving up") from e
    _note_restart(telemetry, cause="preemption", attempt=preemptions,
                  error=e, backoff_s=0.0, trainer=trainer)
    log.warning("resuming after preemption %d/%d (%s)", preemptions,
                policy.max_preemptions, e)
    return preemptions


def handle_failure(e: BaseException, *, policy: RetryPolicy, failures: int,
                   telemetry: Any = None, trainer: Any = None,
                   sleep: Callable[[float], None] = time.sleep,
                   context: str = "") -> int:
    """Classify ``e``: re-raise a fatal one, count a transient one against
    ``max_restarts`` (``TrainingFailure`` past it; a ``restart`` event of
    cause ``transient``) and sleep its backoff. Returns the new failure
    count. Call it from the ``except`` block handling ``e``."""
    if policy.classify(e) == "fatal":
        log.error("fatal failure (%s: %s); not retrying",
                  type(e).__name__, e)
        raise e
    failures += 1
    if failures > policy.max_restarts:
        raise TrainingFailure(f"training failed {failures} times; "
                              "giving up") from e
    delay = policy.backoff(failures)
    _note_restart(telemetry, cause="transient", attempt=failures, error=e,
                  backoff_s=delay, trainer=trainer)
    log.warning("training attempt %d/%d failed (%s: %s); restarting from "
                "latest checkpoint%s in %.2fs", failures,
                policy.max_restarts, type(e).__name__, e, context, delay)
    sleep(delay)
    return failures


def run_with_policy(make_trainer: Callable[[], Any],
                    run: Callable[[Any], T], *,
                    policy: Optional[RetryPolicy] = None,
                    telemetry: Any = None,
                    sleep: Callable[[float], None] = time.sleep) -> T:
    """``run(make_trainer())`` under ``policy``: a transient failure
    rebuilds the trainer and runs again after a jittered backoff, up to
    ``max_restarts``; ``Preempted`` restarts at once and counts against
    ``max_preemptions`` only; a fatal failure re-raises. ``telemetry``:
    an ``obs.Telemetry`` for the ``restart`` events (one sharing the
    run's directory interleaves them with the trainers' events)."""
    policy = policy if policy is not None else RetryPolicy()
    failures = preemptions = 0
    while True:
        trainer = make_trainer()
        try:
            return run(trainer)
        except Preempted as e:
            preemptions = handle_preemption(
                e, policy=policy, preemptions=preemptions,
                telemetry=telemetry, trainer=trainer)
        except BaseException as e:
            failures = handle_failure(e, policy=policy, failures=failures,
                                      telemetry=telemetry, trainer=trainer,
                                      sleep=sleep)


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
