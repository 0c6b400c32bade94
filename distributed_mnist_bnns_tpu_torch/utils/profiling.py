"""Tracing and step timing, as the JAX package's ``utils/profiling.py``.

The reference times by hand (``time.time`` deltas through AverageMeter,
mnist-dist2.py:109-115,139-150); ``StepTimer`` keeps that pattern. The
device trace is ``torch.profiler``'s (CPU and CUDA activities), written
as a Chrome / TensorBoard trace directory; ``annotate`` names a region
in it with ``record_function``."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from .meters import AverageMeter


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """``with trace("tb_logs"): step(...)`` records a ``torch.profiler``
    trace of the block into ``log_dir`` (CUDA activity too when a card is
    there). No-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region inside a trace."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """Per-step host-clock timing into an ``AverageMeter``.

    ``stop()`` measures the dispatch only (the card may still run the
    step: the right default in a hot loop); ``stop(sync_on=device)``
    first waits for ``device`` (``torch.cuda.synchronize``), for the
    step's full latency. A CPU device has nothing to wait for.

    ``metric``: a metric name feeds every ``stop()`` into the obs
    registry's histogram of that name (``obs.default_registry()``, with
    ``labels``), so ad-hoc timers and the telemetry layer read from one
    store, percentiles included."""

    def __init__(self, metric: Optional[str] = None, **labels: str) -> None:
        self.meter = AverageMeter()
        self._t0: Optional[float] = None
        self._hist = None
        self._labels = labels
        if metric is not None:
            from ..obs import default_registry

            self._hist = default_registry().histogram(
                metric, "StepTimer wall-clock latency")

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            dev = torch.device(sync_on)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        now = time.perf_counter()
        dt = now - (self._t0 if self._t0 is not None else now)
        self.meter.update(dt)
        if self._hist is not None:
            self._hist.observe(dt, **self._labels)
        return dt

    @property
    def avg(self) -> float:
        return self.meter.avg

