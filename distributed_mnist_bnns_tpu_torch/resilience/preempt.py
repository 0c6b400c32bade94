"""Graceful stop on SIGTERM/SIGINT.

A framework-free copy of ``StopRequest`` from the JAX package's
``resilience/preempt.py``: the signal handler only sets a flag, and the
serving loop polls it and drains in normal (non-handler) context.
"""

from __future__ import annotations

import contextlib
import logging
import signal
import threading
from typing import Iterator, Optional, Tuple

log = logging.getLogger(__name__)


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
