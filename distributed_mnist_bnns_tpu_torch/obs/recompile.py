"""Recompilation tracking — make silent retrace storms a visible counter.

The port's counterpart of the JAX package's ``obs/recompile.py``, with
its counter names. The port has no jit cache; what it builds at run time
is reported here directly by the code that builds it:

  * ``kind="capture"``: each CUDA-graph capture of the train step
    (``train.capture.TrainScan``: one per ``(n, batch shape)``, and one
    again after every recapture — a capture on every chunk, the port's
    retrace storm, is a counter that keeps growing);
  * ``kind="kernel_build"`` / ``kind="kernel_load"``: each ``nvcc``
    build and each load of a kernel library (``ops._kernels``).

Fallback, as JAX's: when nothing reports (a tracker that was never
installed), ``observe_step`` applies a dispatch-time-spike heuristic —
a step that takes > ``spike_factor`` x the running median is counted as
a suspected recompile. Real counts are never mixed with guesses.
"""

from __future__ import annotations

import collections
import statistics
import threading
from typing import Optional

from .registry import MetricsRegistry, default_registry

COMPILES_TOTAL = "jax_backend_compiles_total"
COMPILE_SECONDS = "jax_backend_compile_seconds"


class RecompileTracker:
    """Counts the builds the port reports (see module docstring). One
    instance per process is enough — use ``get_tracker()``."""

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        spike_factor: float = 20.0,
        window: int = 64,
    ):
        self.registry = registry or default_registry()
        self._lock = threading.Lock()
        self._count = 0
        self._compile_seconds = 0.0
        self._installed = False
        self.listener_available = False
        self.spike_factor = spike_factor
        self._recent = collections.deque(maxlen=window)
        self._counter = self.registry.counter(
            COMPILES_TOTAL,
            "run-time builds observed (kind=capture: CUDA-graph captures; "
            "kernel_build / kernel_load: kernel libraries; "
            "suspected-from-latency-spike when kind=suspected)",
        )
        self._seconds = self.registry.counter(
            COMPILE_SECONDS, "cumulative run-time build seconds",
        )

    # -- direct reports (primary) --------------------------------------------

    def record(self, kind: str, seconds: float = 0.0) -> None:
        """One build of ``kind`` that took ``seconds``."""
        with self._lock:
            self._count += 1
            self._compile_seconds += float(seconds)
        self._counter.inc(kind=kind)
        self._seconds.inc(float(seconds))

    def install(self) -> "RecompileTracker":
        """Mark the direct reports as this tracker's source (idempotent):
        the spike fallback then stays off."""
        self._installed = True
        self.listener_available = True
        return self

    # -- dispatch-time-spike fallback ---------------------------------------

    def observe_step(self, step_seconds: float) -> bool:
        """Feed a measured step time. Only when the tracker is NOT
        installed, a spike above ``spike_factor`` x the running median
        counts as a suspected recompile. Returns True when a suspected
        recompile was recorded."""
        if self.listener_available:
            return False
        with self._lock:
            suspected = (
                len(self._recent) >= 8
                and step_seconds
                > self.spike_factor * statistics.median(self._recent)
            )
            self._recent.append(step_seconds)
            if suspected:
                self._count += 1
        if suspected:
            self._counter.inc(kind="suspected")
        return suspected

    # -- reads --------------------------------------------------------------

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def compile_seconds(self) -> float:
        with self._lock:
            return self._compile_seconds

    def kind_count(self, kind: str) -> int:
        """Builds of one ``kind`` so far."""
        return int(self._counter.value(kind=kind))

    def mark(self) -> int:
        """Snapshot the current count; subtract from a later ``count``
        to attribute builds to a region (warmup vs steady-state)."""
        return self.count


_tracker: Optional[RecompileTracker] = None
_tracker_lock = threading.Lock()


def get_tracker() -> RecompileTracker:
    """Process-wide tracker, installed on first use."""
    global _tracker
    with _tracker_lock:
        if _tracker is None:
            _tracker = RecompileTracker().install()
        return _tracker
