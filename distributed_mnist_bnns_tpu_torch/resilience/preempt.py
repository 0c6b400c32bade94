"""Graceful stop on SIGTERM/SIGINT.

A framework-free copy of the JAX package's ``resilience/preempt.py``: the
signal handler only sets a flag (``StopRequest``), and the serving loop or
the trainer polls it at a step boundary. The trainer then writes a
mid-epoch checkpoint and raises ``Preempted``, which ``cli train`` maps to
``PREEMPT_EXIT_CODE`` and ``run_with_policy`` resumes without counting it
as a failure.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading
from typing import Iterator, Optional, Tuple

log = logging.getLogger(__name__)

# EX_TEMPFAIL: "temporary failure, retrying later will succeed", the exit
# code a supervisor reads as "resume me" (1 is a crash, 0 done).
PREEMPT_EXIT_CODE = 75


class Preempted(RuntimeError):
    """Training stopped at a step boundary after a stop request; with a
    checkpoint dir the state is on disk and ``TrainConfig.resume``
    continues the run."""

    def __init__(self, epoch: int, step: int, reason: str = ""):
        super().__init__(f"preempted at epoch {epoch} step {step}"
                         + (f" ({reason})" if reason else ""))
        self.epoch = epoch
        self.step = step
        self.reason = reason
        self.exit_code = PREEMPT_EXIT_CODE


class StopRequest:
    """Thread-safe "stop at the next step boundary" flag.

    ``request()`` can be called from a signal handler or another thread;
    the serving loop only ever *polls* ``requested``, so the handler
    does no unsafe work. A second SIGINT while a stop is already pending
    escalates to ``KeyboardInterrupt`` (the usual "hit Ctrl-C twice to
    really die" contract)."""

    def __init__(self) -> None:
        self._event = threading.Event()
        self.reason: Optional[str] = None

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def request(self, reason: str = "stop requested") -> None:
        if not self._event.is_set():
            self.reason = reason
            log.warning(
                "graceful stop requested (%s): stopping at the next step "
                "boundary", reason,
            )
        self._event.set()

    def clear(self) -> None:
        self._event.clear()
        self.reason = None

    def _handler(self, signum, frame) -> None:
        name = signal.Signals(signum).name
        if self._event.is_set() and signum == signal.SIGINT:
            raise KeyboardInterrupt
        self.request(f"signal {name}")

    @contextlib.contextmanager
    def install(
        self, signals: Tuple[int, ...] = (signal.SIGTERM, signal.SIGINT)
    ) -> Iterator["StopRequest"]:
        """Install the graceful-stop handler for ``signals``, restoring
        the previous handlers on exit. Outside the main thread (where
        CPython forbids ``signal.signal``) this is a no-op: the flag
        still works via ``request()``."""
        previous = []
        try:
            for sig in signals:
                previous.append((sig, signal.signal(sig, self._handler)))
        except ValueError as e:  # not the main thread
            log.debug(
                "signal handlers not installed (%s); graceful stop "
                "remains reachable via StopRequest.request()", e,
            )
        try:
            yield self
        finally:
            for sig, old in previous:
                signal.signal(sig, old)
