"""Serving data plane: requests, admission queue, micro-batching engine.

Counterpart of the JAX package's ``serve/core.py``, with its telemetry
(the registry's ``serve_*`` metrics, ``request`` and ``shed`` events,
per-request span trees: ``serve.request`` with its ``queue``,
``assemble``, ``batch`` / ``infer`` and ``respond`` phases), the cost
ledger's ``classifier_predict`` dispatch times (CUDA events) and the
``jg_step`` profiler region while a capture is live, and its chaos hook
before the predictor call (``resilience/chaos``: ``infer_slow`` stalls
the batch, ``infer_error`` fails it, and either trips the breaker), and
its recompile fence: a ``sanitizer`` (``analysis.guards.Sanitizer``) is
fed each delivered batch, and a ``RecompileFenceError`` ends the worker
(``fence_error`` set, ``submit`` sheds ``engine_failed``). As in the JAX
package, the server arms it, at budget 0 from the boot, only on a boot
from the AOT store (``aot/``). The Tail-at-Scale mechanics are the same:

  * every request carries a **deadline**; work whose deadline has
    passed is cancelled when the batcher pops it (never computed), and
    a waiter that gives up claims the request so the engine drops it —
    both sides race through ``Request.finish``, exactly one wins;
  * admission is a **bounded queue**: when it is full the request is
    rejected immediately (shed) instead of growing an unbounded backlog;
    it is SLO-tier aware (``interactive`` outranks ``batch``);
  * a **micro-batcher** coalesces queued requests up to the fixed batch
    size and pads the remainder, so the packed kernels only ever see one
    batch shape;
  * the predictor call sits behind a ``CircuitBreaker``: consecutive
    exceptions OR stalls past the stall budget trip it open, and while
    open the admission path fast-fails.
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..obs.costs import get_ledger
from ..analysis.guards import RecompileFenceError
from ..obs.profile import get_profiler, step_annotation
from ..obs.registry import MetricsRegistry
from ..obs.telemetry import StepClock
from ..obs.trace import NULL_SPAN, NULL_TRACER, TraceContext, next_request_id

log = logging.getLogger(__name__)

REQUESTS_TOTAL = "serve_requests_total"
SHED_TOTAL = "serve_shed_total"
BATCHES_TOTAL = "serve_batches_total"
BATCH_SECONDS = "serve_batch_seconds"
QUEUE_DEPTH = "serve_queue_depth"
BREAKER_TRANSITIONS_TOTAL = "serve_breaker_transitions_total"

# SLO tiers, highest priority first.
TIERS = ("interactive", "batch")
DEFAULT_TIER = TIERS[0]
_TIER_RANK = {t: i for i, t in enumerate(TIERS)}


def labeled(counter) -> Dict[str, float]:
    """A registry counter's series as ``{"k=v,...": value}`` (the
    /healthz view of request, shed and transition counts)."""
    return {
        ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items())):
            s["value"]
        for s in counter.snapshot()["series"]
    }


class Request:
    """One admitted prediction request.

    The handler thread waits on ``event``; the engine fills the result.
    ``finish`` is claim-once: the first caller (engine delivering, or a
    deadline-expired waiter abandoning) wins, the loser's call returns
    False and must not touch the payload.
    """

    __slots__ = (
        "id", "images", "n", "deadline", "enqueued_at", "event",
        "status", "log_probs", "error", "span", "tier", "_lock", "_done",
    )

    def __init__(self, images: np.ndarray, deadline: float,
                 tier: str = DEFAULT_TIER):
        # run-scoped (obs/trace): the join key of request events and
        # span trees, unique across replicas and restarts
        self.id = next_request_id()
        self.images = images
        self.n = int(images.shape[0])
        self.deadline = deadline
        self.tier = tier
        self.enqueued_at = time.monotonic()
        self.event = threading.Event()
        self.status: Optional[str] = None
        self.log_probs: Optional[np.ndarray] = None
        self.error = ""
        self.span = NULL_SPAN      # root trace span, set at admission
        self._lock = threading.Lock()
        self._done = False

    def finish(
        self, status: str, *,
        log_probs: Optional[np.ndarray] = None, error: str = "",
    ) -> bool:
        """Resolve the request; returns False if already resolved."""
        with self._lock:
            if self._done:
                return False
            self._done = True
            self.status = status
            self.log_probs = log_probs
            self.error = error
        self.event.set()
        return True

    def expired(self, now: Optional[float] = None) -> bool:
        return (time.monotonic() if now is None else now) >= self.deadline


class AdmissionQueue:
    """Bounded, SLO-tier-aware queue with a blocking batch pop.

    ``try_put`` never blocks — a full queue is the caller's signal to
    shed. ``put_or_displace`` additionally lets a higher-tier request
    displace the newest queued lower-tier one when the queue is full.
    ``pop_batch`` blocks for the first request (bounded by ``timeout``),
    then lingers briefly to coalesce more, popping requests in
    tier-priority order (FIFO within a tier) while their examples fit
    ``max_examples``.
    """

    def __init__(self, maxsize: int):
        self.maxsize = int(maxsize)
        self._items: deque[Request] = deque()
        self._cond = threading.Condition()

    def __len__(self) -> int:
        with self._cond:
            return len(self._items)

    def try_put(self, req: Request) -> bool:
        with self._cond:
            if len(self._items) >= self.maxsize:
                return False
            self._items.append(req)
            self._cond.notify()
            return True

    def put_or_displace(
        self, req: Request
    ) -> "tuple[bool, Optional[Request]]":
        """``(admitted, displaced)``. A full queue admits ``req`` by
        evicting the NEWEST queued request of a strictly lower tier; the
        victim is returned for the caller to resolve as shed. No
        lower-tier victim -> ``(False, None)``."""
        with self._cond:
            if len(self._items) < self.maxsize:
                self._items.append(req)
                self._cond.notify()
                return True, None
            rank = _TIER_RANK.get(req.tier, 0)
            for i in range(len(self._items) - 1, -1, -1):
                victim = self._items[i]
                if _TIER_RANK.get(victim.tier, 0) > rank:
                    del self._items[i]
                    self._items.append(req)
                    self._cond.notify()
                    return True, victim
            return False, None

    def _best_index_locked(self) -> int:  # holds-lock: _cond
        """Index of the pop head: oldest request of the highest queued
        tier (lock held, queue non-empty)."""
        best, best_rank = 0, None
        for i, r in enumerate(self._items):
            rank = _TIER_RANK.get(r.tier, 0)
            if best_rank is None or rank < best_rank:
                best, best_rank = i, rank
                if rank == 0:
                    break
        return best

    def wake(self) -> None:
        """Unblock a pending ``pop_batch`` (drain/stop path)."""
        with self._cond:
            self._cond.notify_all()

    def pop_batch(
        self, max_examples: int, *,
        linger_s: float = 0.0, timeout: float = 0.1,
        claim: Optional[Callable[[], None]] = None,
    ) -> List[Request]:
        """Up to ``max_examples`` worth of requests; ``[]`` on timeout.

        ``claim`` runs under the queue lock before a non-empty batch is
        returned: the engine marks itself busy there, so a drain watcher
        can never observe "queue empty AND worker idle" while a popped
        batch is still unprocessed.
        """
        with self._cond:
            if not self._items:
                self._cond.wait(timeout)
                if not self._items:
                    return []
            if linger_s > 0:
                deadline = time.monotonic() + linger_s
                while True:
                    have = sum(r.n for r in self._items)
                    remaining = deadline - time.monotonic()
                    if have >= max_examples or remaining <= 0:
                        break
                    self._cond.wait(remaining)
            out: List[Request] = []
            total = 0
            while self._items:
                i = self._best_index_locked()
                req = self._items[i]
                if total + req.n > max_examples:
                    break
                del self._items[i]
                out.append(req)
                total += req.n
            if out and claim is not None:
                # jg: disable=JG010 -- holding the lock IS the point (the drain-race fix): claim flips the engine's busy flag under the queue lock so "queue empty AND worker idle" is never observable with a popped batch pending; it sets one bool and never re-enters the queue
                claim()
            return out


def _to_numpy(out: Any) -> np.ndarray:
    if torch.is_tensor(out):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class ServeEngine:
    """Single-worker micro-batching inference engine.

    ``predict_fn`` is the predictor from ``infer.load_packed``; it is
    only ever called from the worker thread, always at ``batch_size``
    examples (padded), so the kernels see one shape for the whole run,
    and ``swap_predictor`` (hot reload) is a plain attribute write
    observed at the next batch. ``device`` is the predictor's (the
    ledger's dispatch times are CUDA events there).
    """

    def __init__(
        self,
        predict_fn: Callable,
        *,
        batch_size: int,
        queue: AdmissionQueue,
        breaker: Any,
        telemetry: Any = None,
        device: Any = None,
        stall_timeout_s: float = 1.0,
        linger_s: float = 0.002,
        chaos: Any = None,
        sanitizer: Any = None,
    ):
        self.predict_fn = predict_fn
        self.chaos = chaos
        # the recompile fence (None: unfenced); fed after each delivery
        self.sanitizer = sanitizer
        self.fence_error: Optional[str] = None
        self.batch_size = int(batch_size)
        self.queue = queue
        self.breaker = breaker
        self.telemetry = telemetry
        self.device = device
        self.stall_timeout_s = float(stall_timeout_s)
        self.linger_s = float(linger_s)
        # Spans ride the telemetry's tracer; without one the shared
        # NULL_TRACER keeps every instrumentation site one attribute
        # check. The ledger and the profiler are off by default: one
        # attribute check each on the hot path.
        self.tracer = getattr(telemetry, "tracer", None) or NULL_TRACER
        self._ledger = get_ledger()
        self._profiler = get_profiler()
        self._clock = StepClock(device if device is not None else "cpu")
        self.batch_seq = 0
        self.draining = False
        self._stop = threading.Event()
        self._busy = False
        self._thread: Optional[threading.Thread] = None
        reg = (telemetry.registry if telemetry is not None
               else MetricsRegistry())
        self.requests_ctr = reg.counter(
            REQUESTS_TOTAL, "serving requests by final status"
        )
        self.shed_ctr = reg.counter(
            SHED_TOTAL, "admission rejections by reason"
        )
        self.batches_ctr = reg.counter(
            BATCHES_TOTAL, "predictor micro-batches dispatched"
        )
        self.batch_hist = reg.histogram(
            BATCH_SECONDS, "predictor call latency per micro-batch"
        )
        self.depth_gauge = reg.gauge(
            QUEUE_DEPTH, "admission queue depth at batch pop"
        )

    # -- admission (handler threads) ----------------------------------------

    def submit(
        self, images: np.ndarray, deadline: float,
        ctx: Optional[TraceContext] = None, tier: str = DEFAULT_TIER,
    ):
        """Admit or shed. Returns a :class:`Request`, or a shed-reason
        string (``draining`` | ``engine_failed`` | ``breaker_open`` |
        ``queue_full``).
        ``ctx`` is an adopted ``x-jg-trace`` context: the request's root
        span joins the client's trace; None mints a fresh trace."""
        if self.draining or self._stop.is_set():
            return self._shed("draining", ctx=ctx, tier=tier)
        if self.fence_error is not None:
            # the fence ended the worker: a queued request would wait
            # out its deadline (the LM engine's engine_failed contract)
            return self._shed("engine_failed", ctx=ctx, tier=tier)
        if not self.breaker.admits():
            return self._shed("breaker_open", ctx=ctx, tier=tier)
        req = Request(images, deadline, tier=tier)
        req.span = self.tracer.start(
            "serve.request", kind="request", ctx=ctx, fresh=True,
            id=req.id, n=req.n, tier=tier,
        )
        admitted, victim = self.queue.put_or_displace(req)
        if victim is not None:
            self._displace(victim)
        if not admitted:
            req.span.end("shed", reason="queue_full")
            return self._shed("queue_full", spanned=True, tier=tier)
        return req

    def _displace(self, victim: Request) -> None:
        """Resolve a queue-displaced lower-tier request as a shed
        (reason ``displaced``)."""
        if victim.finish(
            "shed", error="displaced by a higher-tier admission"
        ):
            self.shed_ctr.inc(reason="displaced", tier=victim.tier)
            self.requests_ctr.inc(status="shed")
            victim.span.end("shed", reason="displaced")
            if self.telemetry is not None:
                self.telemetry.emit(
                    "shed", reason="displaced", tier=victim.tier,
                    id=victim.id, queue_depth=len(self.queue),
                )

    def _shed(
        self, reason: str, *, ctx: Optional[TraceContext] = None,
        spanned: bool = False, tier: str = DEFAULT_TIER,
    ) -> str:
        self.shed_ctr.inc(reason=reason, tier=tier)
        self.requests_ctr.inc(status="shed")
        if not spanned and self.tracer.enabled:
            # sheds are (zero-length) spans too, joinable to the
            # client's trace
            now = time.monotonic()
            self.tracer.record(
                "serve.request", kind="request", t0=now, t1=now,
                ctx=ctx, fresh=True, status="shed", reason=reason,
                tier=tier,
            )
        if self.telemetry is not None:
            self.telemetry.emit(
                "shed", reason=reason, tier=tier,
                queue_depth=len(self.queue),
            )
        return reason

    # -- worker -------------------------------------------------------------

    def start(self) -> "ServeEngine":
        self._thread = threading.Thread(
            target=self._run, name="serve-engine", daemon=True
        )
        self._thread.start()
        return self

    def _claim_busy(self) -> None:
        self._busy = True

    def _run(self) -> None:
        while True:
            reqs = self.queue.pop_batch(
                self.batch_size, linger_s=self.linger_s, timeout=0.1,
                claim=self._claim_busy,
            )
            if not reqs:
                if self._stop.is_set() and not len(self.queue):
                    return
                continue
            try:
                self._process(reqs)
            except RecompileFenceError as e:
                # the batch was delivered before the check: fail the
                # engine loudly (healthz "failed", submit sheds)
                self.fence_error = str(e)
                log.error("serve-engine recompile fence tripped: %s", e)
                return
            except Exception:
                # The worker must outlive ANY per-batch failure (e.g. a
                # full disk erroring the telemetry write): a dead worker
                # is a silent total outage behind a green healthz. The
                # batch's unresolved requests 504 at their deadlines.
                log.exception(
                    "serve-engine batch %d processing failed; worker "
                    "continues", self.batch_seq,
                )
            finally:
                self._busy = False

    def _process(self, reqs: List[Request]) -> None:
        self.batch_seq += 1
        self.depth_gauge.set(len(self.queue))
        now = time.monotonic()
        # queue wait ends at the pop
        waits = {r.id: now - r.enqueued_at for r in reqs}
        live = []
        for r in reqs:
            if r.expired(now):
                self._finish(r, "deadline",
                             error="deadline exceeded in queue",
                             queue_s=waits[r.id])
            else:
                live.append(r)
        if not live:
            return
        if not self.breaker.allow():
            for r in live:
                self._finish(
                    r, "breaker_open", error="circuit breaker open",
                    queue_s=waits[r.id],
                )
            return
        t0 = time.perf_counter()
        # Trace marks (monotonic, the span timebase): pop -> assembled ->
        # dispatch done; the children are banked after delivery.
        m_pop = m_asm = now
        timed = self._ledger.enabled
        try:
            x = np.concatenate([r.images for r in live], axis=0)
            pad = self.batch_size - x.shape[0]
            if pad:
                x = np.concatenate(
                    [x, np.zeros((pad, *x.shape[1:]), x.dtype)], axis=0
                )
            m_asm = time.monotonic()
            with self.tracer.start(
                "serve.batch", kind="batch",
                batch_seq=self.batch_seq, n=sum(r.n for r in live),
            ) as bspan:
                # a chaos fault fired here parents its span to this batch
                # (resilience/chaos): a stall counts toward dt, an error
                # fails the batch and trips the breaker like a backend's
                if self.chaos is not None and self.chaos.active:
                    self.chaos.on_infer(step=self.batch_seq)
                # while a capture is live, the dispatch runs in a jg_step
                # region carrying the batch's trace id (obs/profile)
                with (step_annotation("classifier_predict",
                                      bspan.trace_id
                                      or self.tracer.run_trace)
                      if self._profiler.active
                      else contextlib.nullcontext()):
                    if timed:
                        self._clock.restart()
                        token = self._clock.start()
                    lp = self.predict_fn(x)
                    if timed:
                        self._clock.stop(token)
                out = _to_numpy(lp)
        except Exception as e:  # any backend error must trip, not crash
            dt = time.perf_counter() - t0
            m_end = time.monotonic()
            self.breaker.record_failure(f"{type(e).__name__}: {e}")
            log.warning(
                "serve batch %d failed after %.3fs (%s: %s)",
                self.batch_seq, dt, type(e).__name__, e,
            )
            for r in live:
                self._trace_phases(r, m_pop, m_asm, m_end)
                self._finish(
                    r, "error",
                    error=f"backend failure: {type(e).__name__}: {e}",
                    infer_s=dt, queue_s=waits[r.id],
                )
            return
        dt = time.perf_counter() - t0
        m_end = time.monotonic()
        self.batches_ctr.inc()
        self.batch_hist.observe(dt)
        if timed:
            # the predictor's device time (its results were read above)
            for seconds, _ in self._clock.ready():
                self._ledger.observe("classifier_predict", seconds)
        if dt > self.stall_timeout_s:
            # The call *returned*, but so late that the backend must be
            # presumed unhealthy.
            self.breaker.record_failure(
                f"stall: batch took {dt:.3f}s > {self.stall_timeout_s}s"
            )
        else:
            self.breaker.record_success()
        offset = 0
        for r in live:
            rows = out[offset:offset + r.n]
            offset += r.n
            self._trace_phases(r, m_pop, m_asm, m_end)
            self._finish(r, "ok", log_probs=rows, infer_s=dt,
                         queue_s=waits[r.id])
        if self.sanitizer is not None:
            # after delivery: a trip never strands this batch's clients
            self.sanitizer.after_step(step=self.batch_seq)

    def _trace_phases(
        self, req: Request, pop_m: float, asm_m: float, end_m: float,
    ) -> None:
        """Bank the request's dispatch-phase child spans (assemble,
        infer) under its root; the queue child and the root's end live
        in ``_finish``."""
        if not self.tracer.enabled or req.span is NULL_SPAN:
            return
        rec = self.tracer.record
        if asm_m > pop_m:
            rec("serve.assemble", kind="assemble", parent=req.span,
                t0=pop_m, t1=asm_m)
        if end_m > asm_m:
            rec("serve.infer", kind="infer", parent=req.span,
                t0=asm_m, t1=end_m, batch_seq=self.batch_seq)

    def _finish(self, req: Request, status: str, *,
                log_probs: Optional[np.ndarray] = None, error: str = "",
                infer_s: Optional[float] = None,
                queue_s: Optional[float] = None) -> None:
        """Resolve ``req`` and emit its single ``request`` event. A
        failed claim means the waiter already abandoned it at its
        deadline — count that, not the late result."""
        if not req.finish(status, log_probs=log_probs, error=error):
            status = "deadline"
        self.requests_ctr.inc(status=status)
        if queue_s is None:
            queue_s = time.monotonic() - req.enqueued_at
        if self.tracer.enabled and req.span is not NULL_SPAN:
            self.tracer.record(
                "serve.queue", kind="queue", parent=req.span,
                t0=req.enqueued_at, t1=req.enqueued_at + queue_s,
            )
            # claim-once: a deadline waiter that ended the root wins
            req.span.end(status, batch_seq=self.batch_seq)
        if self.telemetry is not None:
            fields: Dict[str, Any] = {
                "id": req.id,
                "status": status,
                "n": req.n,
                "batch_seq": self.batch_seq,
                "queue_ms": round(queue_s * 1e3, 3),
            }
            if infer_s is not None:
                fields["infer_ms"] = round(infer_s * 1e3, 3)
            if error:
                fields["error"] = error[:500]
            self.telemetry.emit("request", **fields)

    # -- lifecycle ----------------------------------------------------------

    def swap_predictor(self, predict_fn: Callable) -> None:
        """Atomic hot swap; callers warm the new predictor first so
        serving never stalls on a kernel load."""
        self.predict_fn = predict_fn

    def begin_drain(self) -> None:
        self.draining = True

    def drain(self, timeout: float = 30.0) -> bool:
        """Flush: wait for the queue to empty and the in-flight batch
        to resolve. Returns False on timeout (callers still stop)."""
        self.begin_drain()
        deadline = time.monotonic() + timeout
        while len(self.queue) or self._busy:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return True

    def stop(self) -> None:
        self._stop.set()
        self.queue.wake()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
