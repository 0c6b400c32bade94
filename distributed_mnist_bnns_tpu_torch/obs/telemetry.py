"""Telemetry facade — one object bundling the metrics registry, the
JSONL event sink, the recompile tracker and the per-process heartbeat,
with the derived step metrics (examples/sec, latency percentiles, MFU)
computed in one place (the JAX package's ``obs/telemetry.py``).

The Trainer and both servers talk to this class; the older consumers
(AverageMeter timing, ResultsLog CSV rows) keep their outputs unchanged
and simply read alongside.

``StepClock`` times dispatches on the device's clock without a host
sync: the trainer's ``step`` events take their ``latency_s`` from it.

Disabled mode: ``Telemetry()`` with no run directory still maintains the
in-process metrics registry (cheap) but emits no files — call sites need
no ``if telemetry:`` guards.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Dict, Iterator, Optional, Tuple

from .events import EventLog
from .flops import device_memory_stats, device_peak_flops, mfu
from .heartbeat import Heartbeat
from .recompile import RecompileTracker, get_tracker
from .registry import MetricsRegistry
from .trace import Tracer

EVENTS_FILE = "events.jsonl"
ENV_TRACE = "JG_TRACE"
ENV_EVENTS_MAX_BYTES = "JG_EVENTS_MAX_BYTES"
EVENTS_ROTATED_TOTAL = "events_rotated_total"

STEP_SECONDS = "train_step_seconds"
EXAMPLES_TOTAL = "train_examples_total"
STEPS_TOTAL = "train_steps_total"


class Telemetry:
    """Per-run telemetry. ``run_dir=None`` disables all file outputs.

    The recompile tracker is a process-wide singleton by default
    (compiles are a process property, not a run property). The registry
    holding the run's OWN instruments (step histogram, step/example
    counters) is per-instance by default — a second Trainer in the same
    process must not report the first run's steps in its epoch events;
    the process-wide ``default_registry()`` keeps serving the layers
    whose metrics genuinely span runs (placement timing, decode
    counters, compiles)."""

    def __init__(
        self,
        run_dir: Optional[str] = None,
        *,
        registry: Optional[MetricsRegistry] = None,
        tracker: Optional[RecompileTracker] = None,
        heartbeat_interval_s: float = 30.0,
        heartbeat: bool = True,
        trace: Optional[bool] = None,
        events_max_bytes: Optional[int] = None,
    ):
        self.run_dir = run_dir
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracker = tracker if tracker is not None else get_tracker()
        self.events: Optional[EventLog] = None
        self.heartbeat: Optional[Heartbeat] = None
        self._t0 = time.time()
        self._last_step_payload: Dict[str, Any] = {}
        self.step_hist = self.registry.histogram(
            STEP_SECONDS, "per-optimizer-step wall latency"
        )
        self.examples = self.registry.counter(
            EXAMPLES_TOTAL, "training examples processed"
        )
        self.steps = self.registry.counter(
            STEPS_TOTAL, "optimizer steps run"
        )
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            # Size-bound the log for long-lived servers (events.py
            # "Rotation"): explicit ``events_max_bytes`` wins, else the
            # JG_EVENTS_MAX_BYTES env var, else unbounded (training
            # runs are epoch-bounded). Rotations are visible as the
            # events_rotated_total counter.
            if events_max_bytes is None:
                env_cap = os.environ.get(ENV_EVENTS_MAX_BYTES, "")
                events_max_bytes = int(env_cap) if env_cap.isdigit() \
                    else None
            self.events = EventLog(
                os.path.join(run_dir, EVENTS_FILE),
                max_bytes=events_max_bytes,
            )
            rotated_ctr = self.registry.counter(
                EVENTS_ROTATED_TOTAL,
                "event-log segment rotations (size-bounded servers)",
            )
            self.events.on_rotate = rotated_ctr.inc
            if heartbeat:
                self.heartbeat = Heartbeat(
                    run_dir,
                    interval_s=heartbeat_interval_s,
                    payload_fn=lambda: dict(self._last_step_payload),
                ).start()
        # Tracing (obs/trace, OBSERVABILITY.md "Tracing"): explicit
        # ``trace=`` wins; None defers to the JG_TRACE env var (how CI
        # arms tracing without touching call sites). A run without an
        # event sink has nowhere durable to put spans, so the tracer
        # stays disabled — near-zero cost at every instrumented site.
        if trace is None:
            trace = os.environ.get(ENV_TRACE, "") not in ("", "0")
        self.tracer = Tracer(
            sink=self.events,
            enabled=bool(trace) and self.events is not None,
            registry=self.registry,
        )

    @property
    def enabled(self) -> bool:
        return self.run_dir is not None

    # -- lifecycle events ---------------------------------------------------

    def manifest(
        self, config: Optional[Dict[str, Any]] = None, mesh: Any = None,
        *, device: Any = None, **extra: Any,
    ) -> None:
        if self.events is not None:
            self.events.manifest(config=config, mesh=mesh, device=device,
                                 **extra)

    def emit(self, kind: str, **fields: Any) -> None:
        if self.events is not None:
            self.events.emit(kind, **fields)

    def error(self, exc: BaseException, **fields: Any) -> None:
        self.registry.counter(
            "run_errors_total", "exceptions recorded by telemetry"
        ).inc(kind=type(exc).__name__)
        if self.events is not None:
            self.events.error(exc, **fields)

    def close(self, **final_fields: Any) -> None:
        if self.heartbeat is not None:
            self.heartbeat.stop()
            self.heartbeat = None
        # Staged spans land before the log seals (and before the final
        # metrics snapshot, which includes the trace drop counter).
        self.tracer.flush()
        if self.events is not None:
            # Cost-ledger final rows (obs/costs; armed runs only): the
            # ledger is process-wide — its dispatch times may live in
            # the process registry, not this run's — so the closing
            # snapshot re-emits each program's row WITH dispatches/
            # mean/measured-MFU, making the `cli telemetry` programs
            # section complete from the events dir alone.
            from .costs import get_ledger

            ledger = get_ledger()
            if ledger.enabled:
                for row in ledger.snapshot().values():
                    self.events.emit("program_cost", final=True, **row)
            # Final registry snapshot as ONE event: counters the run
            # accumulated (comm_bytes_total phases, shed/fault counts,
            # …) become post-mortem-readable from the event log alone,
            # without a live /metrics endpoint to scrape.
            self.events.emit("metrics", registry=self.registry.snapshot())
            self.events.emit(
                "run_end",
                wall_seconds=round(time.time() - self._t0, 3),
                recompiles_total=self.tracker.count,
                compile_seconds=round(self.tracker.compile_seconds, 3),
                **final_fields,
            )
            self.events.close()
            self.events = None

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.error(exc)
        self.close()

    # -- step-level derived metrics -----------------------------------------

    def record_step(
        self,
        latency_s: float,
        *,
        batch_size: int,
        n_steps: int = 1,
        step: Optional[int] = None,
        step_flops: Optional[float] = None,
        peak_flops: Optional[float] = None,
        n_devices: int = 1,
        metrics: Optional[Dict[str, float]] = None,
        emit_event: bool = True,
        **extra: Any,
    ) -> Dict[str, Any]:
        """Record one dispatch covering ``n_steps`` optimizer steps of
        ``batch_size`` examples each, ``latency_s`` being the amortized
        PER-STEP latency. Updates the histogram/counters, feeds the
        recompile fallback heuristic, and (when enabled) emits a ``step``
        event with the derived examples/sec and MFU."""
        self.step_hist.observe(latency_s)
        self.steps.inc(n_steps)
        self.examples.inc(n_steps * batch_size)
        self.tracker.observe_step(latency_s)
        examples_per_sec = (
            batch_size / latency_s if latency_s > 0 else None
        )
        payload: Dict[str, Any] = {
            "latency_s": round(latency_s, 6),
            "examples_per_sec": (
                round(examples_per_sec, 2) if examples_per_sec else None
            ),
            "n_steps": n_steps,
            "batch_size": batch_size,
        }
        if step is not None:
            payload["step"] = int(step)
        step_mfu = mfu(step_flops, latency_s, peak_flops, n_devices)
        if step_mfu is not None:
            payload["mfu"] = step_mfu
        if metrics:
            payload.update({
                k: round(float(v), 6) for k, v in metrics.items()
            })
        payload.update(extra)
        self._last_step_payload = {
            k: payload[k]
            for k in ("step", "latency_s", "examples_per_sec")
            if k in payload
        }
        if emit_event:
            self.emit("step", **payload)
        return payload

    # -- aggregates ---------------------------------------------------------

    def latency_percentiles(self) -> Dict[str, Optional[float]]:
        return {
            "p50": self.step_hist.percentile(50),
            "p95": self.step_hist.percentile(95),
            "p99": self.step_hist.percentile(99),
        }

    def epoch(
        self, epoch: int, metrics: Optional[Dict[str, float]] = None,
        **extra: Any,
    ) -> None:
        """Per-epoch aggregate event: latency percentiles so far, the
        cards' memory stats (``device_memory_stats``), and the build
        count (cumulative — a growing number across same-shape epochs is
        the retrace-storm signal)."""
        fields: Dict[str, Any] = {
            "epoch": int(epoch),
            "latency": {
                k: round(v, 6) if v is not None else None
                for k, v in self.latency_percentiles().items()
            },
            "steps_total": int(self.steps.total()),
            "examples_total": int(self.examples.total()),
            "recompiles_total": self.tracker.count,
        }
        mem = device_memory_stats()
        if mem is not None:
            fields["device_memory"] = mem
            for dev, stats in mem.items():
                if "bytes_in_use" in stats:
                    self.registry.gauge(
                        "device_hbm_bytes_in_use", "live HBM per device"
                    ).set(stats["bytes_in_use"], device=dev)
        if metrics:
            fields.update({
                k: round(float(v), 6) for k, v in metrics.items()
            })
        fields.update(extra)
        self.emit("epoch", **fields)

    def checkpoint(self, epoch: int, path: str, *, best: bool) -> None:
        self.registry.counter(
            "checkpoints_total", "checkpoint saves"
        ).inc()
        self.emit("checkpoint", epoch=int(epoch), path=path, best=best)


def peak_for_default_device(backend: str = "bf16"):
    """(peak FLOP/s, precision-label) of the current CUDA device (the
    nominal host peak without one) — the MFU denominator per card
    (``mfu`` multiplies by n_devices)."""
    import torch

    if torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    return device_peak_flops(device, backend)


class StepClock:
    """Dispatch latencies on the device's clock, read without a host sync.

    ``start()`` before a dispatch and ``stop(token, payload)`` after it.
    On a card each records a CUDA event on the current stream: a
    dispatch's latency is the time from the previous dispatch's
    completion event to its own (the first after ``restart``, from its
    own start event) — the per-dispatch wall latency, measured on the
    card. ``ready()`` yields ``(seconds, payload)`` for the dispatches
    whose completion event has fired (``Event.query``: no wait), in
    dispatch order; after the caller's own synchronize, for all of them.
    On the CPU the clock is ``time.perf_counter`` and every dispatch is
    ready at once."""

    def __init__(self, device: Any):
        import torch

        self.cuda = torch.device(device).type == "cuda"
        self._pending: "collections.deque" = collections.deque()
        self._last: Any = None

    def restart(self) -> None:
        """Time the next dispatch from its own start (after a gap: an
        epoch boundary, an evaluation)."""
        self._last = None

    def _mark(self) -> Any:
        if self.cuda:
            import torch

            event = torch.cuda.Event(enable_timing=True)
            event.record()
            return event
        return time.perf_counter()

    def start(self) -> Any:
        return self._mark() if self._last is None else None

    def stop(self, token: Any, payload: Any = None) -> None:
        end = self._mark()
        self._pending.append(
            (self._last if token is None else token, end, payload))
        self._last = end

    def ready(self) -> Iterator[Tuple[float, Any]]:
        while self._pending:
            begin, end, payload = self._pending[0]
            if self.cuda:
                if not end.query():
                    return
                seconds = begin.elapsed_time(end) / 1e3
            else:
                seconds = end - begin
            self._pending.popleft()
            yield seconds, payload

    def __len__(self) -> int:
        return len(self._pending)
