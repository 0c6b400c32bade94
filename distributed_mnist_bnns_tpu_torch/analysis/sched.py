"""Runtime half of the concurrency pack (the JAX package's
``analysis/sched.py``, line for line: the same seed gives the same
interleaving): instrumented locks that record lock→attribute access
traces, and a seeded cooperative scheduler that forces adversarial
interleavings.

The static rules (JG007-JG011, analysis/concurrency/rules.py) reason
about *possible* executions; this module pins down *actual* ones:

* :class:`TraceRecorder` + :class:`InstrumentedLock` /
  :class:`InstrumentedCondition` + :func:`watch_attrs` — wrap a class's
  locks and shared attributes in tests, run the real workload, and the
  recorder holds the per-thread trace of which locks were held at every
  attribute touch. :meth:`TraceRecorder.guarded_violations` then applies
  JG007's inference rule (an attribute written at least once under lock
  L is guarded by L) to the *observed* trace — corroborating or
  refuting a static finding with ground truth.

* :class:`CoopScheduler` — a seeded cooperative scheduler for
  deterministic race reproduction. Threads registered through
  :meth:`spawn` run ONE at a time; at every yield point (explicit
  ``sched.yield_point()`` calls patched into a mutant, plus the
  acquire/release/blocked edges of every instrumented lock bound to the
  scheduler) the seeded RNG picks which thread proceeds. A race that a
  stress test hits once a week becomes ``reproduces(seed=N)``: replay
  the same seed, get the same interleaving, every time. Lock
  acquisition under the scheduler is non-blocking-with-reschedule, so
  serializing the threads cannot deadlock on a held lock — the holder
  just gets scheduled until it releases.

Nothing here imports torch and nothing is armed in production code
paths: tests opt in by constructing the objects (see
tests/test_torch_concurrency.py, the two historical-race regressions).
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Set, Tuple

__all__ = [
    "AccessEvent",
    "CoopScheduler",
    "DeadlockError",
    "InstrumentedCondition",
    "InstrumentedLock",
    "TraceRecorder",
    "watch_attrs",
]


# --------------------------------------------------------------------------
# lock→attribute tracing
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AccessEvent:
    """One recorded event: a lock edge or an attribute touch."""

    thread: str
    kind: str                 # acquire | release | wait | notify | read | write
    name: str                 # lock name, or attribute name
    held: Tuple[str, ...]     # locks held by the thread at the event
    seq: int                  # global order


class TraceRecorder:
    """Collects :class:`AccessEvent` records from instrumented locks and
    watched attributes, with the per-thread held-lock set maintained
    here so a watched attribute access knows its lock context."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: List[AccessEvent] = []
        self._held = threading.local()

    # -- held-lock bookkeeping (called by the instrumented locks) -----------

    def _held_now(self) -> List[str]:
        held = getattr(self._held, "names", None)
        if held is None:
            held = self._held.names = []
        return held

    def record(self, kind: str, name: str) -> AccessEvent:
        held = self._held_now()
        with self._lock:
            ev = AccessEvent(
                thread=threading.current_thread().name,
                kind=kind, name=name, held=tuple(held),
                seq=len(self.events),
            )
            self.events.append(ev)
        if kind == "acquire":
            held.append(name)
        elif kind == "release":
            if name in held:
                held.remove(name)
        return ev

    # -- queries -------------------------------------------------------------

    def snapshot(self) -> List[AccessEvent]:
        """Point-in-time copy of the trace (queries must not iterate
        ``events`` while instrumented threads are still appending)."""
        with self._lock:
            return list(self.events)

    def accesses(self, attr: Optional[str] = None) -> List[AccessEvent]:
        return [
            e for e in self.snapshot()
            if e.kind in ("read", "write")
            and (attr is None or e.name == attr)
        ]

    def inferred_guards(self) -> Dict[str, Set[str]]:
        """JG007's inference applied to the observed trace: attribute ->
        locks that were held at EVERY write (an attribute never written,
        or written at least once lock-free, has no inferred guard)."""
        writes: Dict[str, List[AccessEvent]] = {}
        for e in self.snapshot():
            if e.kind == "write":
                writes.setdefault(e.name, []).append(e)
        out: Dict[str, Set[str]] = {}
        for attr, evs in writes.items():
            common = set(evs[0].held)
            for e in evs[1:]:
                common &= set(e.held)
            if common:
                out[attr] = common
        return out

    def guarded_violations(
        self, guards: Optional[Dict[str, Set[str]]] = None
    ) -> List[AccessEvent]:
        """Accesses that touched a guarded attribute without holding any
        of its guard locks. ``guards`` defaults to
        :meth:`inferred_guards` — pass the static JG007 guard map to
        corroborate a specific finding instead."""
        guards = self.inferred_guards() if guards is None else guards
        out = []
        for e in self.accesses():
            locks = guards.get(e.name)
            if locks and not (locks & set(e.held)):
                out.append(e)
        return out


def watch_attrs(
    obj: Any, attrs: Iterable[str], recorder: TraceRecorder
) -> Any:
    """Instrument ``obj`` so reads/writes of ``attrs`` are recorded with
    the accessing thread's held-lock set. Works by swapping in a
    dynamically-built subclass (zero new slots, so ``__slots__`` classes
    stay compatible); returns ``obj``."""
    watched = frozenset(attrs)
    cls = type(obj)

    def __getattribute__(self, name):  # noqa: N807
        if name in watched:
            recorder.record("read", name)
        return cls.__getattribute__(self, name)

    def __setattr__(self, name, value):  # noqa: N807
        if name in watched:
            recorder.record("write", name)
        cls.__setattr__(self, name, value)

    sub = type(
        f"Watched{cls.__name__}", (cls,),
        {
            "__slots__": (),
            "__getattribute__": __getattribute__,
            "__setattr__": __setattr__,
        },
    )
    obj.__class__ = sub
    return obj


# --------------------------------------------------------------------------
# seeded cooperative scheduler
# --------------------------------------------------------------------------


class DeadlockError(RuntimeError):
    """Every registered thread is blocked — the schedule wedged (e.g. a
    mutant deadlocked on a real, uninstrumented lock)."""


class CoopScheduler:
    """Seeded cooperative scheduler: registered threads run one at a
    time; at every yield point the seeded RNG picks who runs next.

    Usage::

        sched = CoopScheduler(seed=7)
        sched.spawn(writer_a)      # callables become managed threads
        sched.spawn(writer_b)
        sched.run()                # returns when every thread finished
                                   # (re-raises the first exception)

    Managed code calls ``sched.yield_point("tag")`` wherever an
    interleaving decision is interesting — between a check and an act,
    between two chunked writes. Unmanaged threads calling
    ``yield_point`` fall through instantly, so a yield point patched
    into library code is inert outside the harness.
    """

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._cond = threading.Condition()
        self._targets: List[Tuple[str, Callable[[], Any]]] = []
        self._threads: Dict[str, threading.Thread] = {}
        self._runnable: Set[str] = set()
        self._done: Set[str] = set()
        self._current: Optional[str] = None
        self._started = False
        self._errors: List[BaseException] = []
        self.schedule: List[str] = []      # decision log (for debugging)

    # -- setup ---------------------------------------------------------------

    def spawn(
        self, fn: Callable[[], Any], name: Optional[str] = None
    ) -> str:
        """Register ``fn`` as a managed thread (created at :meth:`run`).
        Returns the thread name."""
        if self._started:
            raise RuntimeError("spawn() after run()")
        name = name or f"coop-{len(self._targets)}"
        if any(n == name for n, _ in self._targets):
            raise ValueError(
                f"duplicate managed-thread name {name!r} — threads are "
                "keyed by name, a second spawn would silently replace "
                "the first"
            )
        self._targets.append((name, fn))
        return name

    def manages_current_thread(self) -> bool:
        """True iff the calling thread is one of this scheduler's
        managed threads (instrumented locks use this to decide between
        cooperative rescheduling and a real blocking acquire)."""
        return threading.current_thread().name in self._threads

    # -- managed-thread protocol --------------------------------------------

    def _trampoline(self, name: str, fn: Callable[[], Any]) -> None:
        try:
            self._wait_until_scheduled(name)
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised by run()
            with self._cond:
                self._errors.append(e)
        finally:
            with self._cond:
                self._done.add(name)
                self._runnable.discard(name)
                if self._current == name:
                    self._pick_next()
                self._cond.notify_all()

    def _wait_until_scheduled(self, name: str) -> None:
        with self._cond:
            while self._current != name:
                if name in self._done:
                    return
                self._cond.wait()

    def _pick_next(self) -> None:  # holds-lock: _cond
        """Choose the next runnable thread (or None); every caller
        already holds ``self._cond``."""
        candidates = sorted(self._runnable - self._done)
        if not candidates:
            self._current = None
            return
        self._current = self._rng.choice(candidates)
        self.schedule.append(self._current)

    def yield_point(self, tag: str = "") -> None:
        """A scheduling decision point. No-op on unmanaged threads."""
        if not self.manages_current_thread():
            return
        name = threading.current_thread().name
        with self._cond:
            self._runnable.add(name)
            self._pick_next()
            self._cond.notify_all()
            while self._current != name:
                self._cond.wait()

    # -- driver --------------------------------------------------------------

    def run(self, timeout: float = 30.0) -> List[str]:
        """Start every spawned thread, schedule until all finish.
        Returns the decision log; re-raises the first managed-thread
        exception; raises :class:`DeadlockError` on a wedged schedule."""
        self._started = True
        for name, fn in self._targets:
            t = threading.Thread(
                target=self._trampoline, args=(name, fn), name=name,
                daemon=True,
            )
            self._threads[name] = t
        with self._cond:
            self._runnable = {name for name, _ in self._targets}
            self._pick_next()
        for t in self._threads.values():
            t.start()
        # ONE deadline across all joins: a wedged schedule blocks every
        # managed thread, so per-thread timeouts would stack to
        # N x timeout before DeadlockError surfaces.
        deadline = time.monotonic() + timeout
        for t in self._threads.values():
            t.join(max(deadline - time.monotonic(), 0.0))
            if t.is_alive():
                with self._cond:
                    so_far = list(self.schedule)
                raise DeadlockError(
                    f"thread {t.name!r} still blocked after {timeout}s "
                    f"(schedule so far: {so_far})"
                )
        with self._cond:  # barrier: joins done, but be uniform anyway
            if self._errors:
                raise self._errors[0]
            return list(self.schedule)


# --------------------------------------------------------------------------
# instrumented locks
# --------------------------------------------------------------------------


class InstrumentedLock:
    """Drop-in ``threading.Lock`` replacement that records acquire /
    release into a :class:`TraceRecorder` and (optionally) cooperates
    with a :class:`CoopScheduler`: under a scheduler, acquisition is
    try-acquire-else-reschedule, so the one-thread-at-a-time discipline
    cannot deadlock on a lock the descheduled holder still owns."""

    def __init__(
        self, name: str = "lock", *,
        recorder: Optional[TraceRecorder] = None,
        scheduler: Optional[CoopScheduler] = None,
    ):
        self.name = name
        self._recorder = recorder
        self._scheduler = scheduler
        self._inner = threading.Lock()

    def _record(self, kind: str) -> None:
        if self._recorder is not None:
            self._recorder.record(kind, self.name)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        sched = self._scheduler
        if (
            sched is not None and blocking
            and sched.manages_current_thread()
        ):
            # Cooperative path (managed threads only — an unmanaged
            # thread would busy-spin here, yield_point being a no-op
            # for it). A timeout becomes a reschedule budget, so
            # acquire(timeout=...) can still return False.
            budget = (
                None if timeout is None or timeout < 0
                else max(int(timeout * 1000), 1)
            )
            while not self._inner.acquire(blocking=False):
                if budget is not None:
                    budget -= 1
                    if budget < 0:
                        return False
                sched.yield_point(f"blocked:{self.name}")
            self._record("acquire")
            return True
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._record("acquire")
        return ok

    def release(self) -> None:
        self._record("release")
        self._inner.release()
        if self._scheduler is not None:
            # A release is a natural preemption point: give waiters a
            # seeded chance to grab the lock before this thread re-runs.
            self._scheduler.yield_point(f"released:{self.name}")

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class InstrumentedCondition:
    """``threading.Condition`` wrapper with the same recording /
    cooperative-scheduling contract as :class:`InstrumentedLock`.
    ``wait`` under a scheduler is a bounded cooperative poll (release,
    reschedule, re-acquire, recheck) so a descheduled notifier can run.
    ``notify(n)`` grants wake exactly one waiter each (and persist if
    granted before the wait — the serialized scheduler would otherwise
    wedge on notify-then-wait orderings); ``notify_all`` wakes every
    current waiter via a generation bump."""

    def __init__(
        self, name: str = "cond", *,
        recorder: Optional[TraceRecorder] = None,
        scheduler: Optional[CoopScheduler] = None,
    ):
        self.name = name
        self._lock = InstrumentedLock(
            name, recorder=recorder, scheduler=scheduler
        )
        self._recorder = recorder
        self._scheduler = scheduler
        self._generation = 0   # bumped by notify_all: wakes every waiter
        self._wakeups = 0      # granted by notify(n): each wakes ONE

    def _record(self, kind: str) -> None:
        if self._recorder is not None:
            self._recorder.record(kind, self.name)

    def acquire(self, *args, **kwargs) -> bool:
        return self._lock.acquire(*args, **kwargs)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "InstrumentedCondition":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Caller must hold the condition (as with threading.Condition).
        Cooperative mode bounds an untimed wait at ~1000 reschedules —
        a test schedule that never notifies should fail fast as a
        deadlock, not hang CI. Real-thread mode polls at 1ms, so a
        timed wait's budget is timeout/1ms polls (≈ the requested wall
        time) and an untimed one is capped at ~60s — far beyond any
        sane test notify latency, but still bounded so a missed notify
        fails the test instead of hanging the suite."""
        self._record("wait")
        gen = self._generation
        if timeout is None:
            budget = 1000 if self._scheduler is not None else 60_000
        else:
            budget = max(int(timeout * 1000), 1)
        for _ in range(budget):
            self.release()
            if self._scheduler is not None:
                self._scheduler.yield_point(f"waiting:{self.name}")
            else:
                time.sleep(0.001)  # real threads: poll, don't spin
            self.acquire()
            if self._generation != gen:
                return True
            if self._wakeups > 0:   # claim ONE notify(n) grant
                self._wakeups -= 1
                return True
        return False

    def wait_for(
        self, predicate: Callable[[], bool],
        timeout: Optional[float] = None,
    ) -> bool:
        """threading.Condition.wait_for semantics: ONE overall deadline
        (a wake whose predicate is still false does NOT restart the
        clock), and an exhausted :meth:`wait` budget terminates an
        untimed wait_for too — the fail-fast bound wait() documents
        would otherwise be defeated by this loop re-entering it."""
        endtime = None
        waittime = timeout
        result = predicate()
        while not result:
            if waittime is not None:
                if endtime is None:
                    endtime = time.monotonic() + waittime
                else:
                    waittime = endtime - time.monotonic()
                    if waittime <= 0:
                        return predicate()
            if not self.wait(waittime):
                return predicate()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        """Wake up to ``n`` waiters (threading.Condition semantics: a
        grant is consumed by ONE waiter, surplus grants persist for the
        next wait — which is also how a notify-before-wait behaves
        under the serialized scheduler)."""
        self._record("notify")
        self._wakeups += n

    def notify_all(self) -> None:
        self._record("notify")
        self._generation += 1
