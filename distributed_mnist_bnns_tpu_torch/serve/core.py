"""Serving data plane: requests, admission queue, micro-batching engine.

Counterpart of the JAX package's ``serve/core.py``, without its hooks
into tracing, cost ledger, device profiling, recompile fences and chaos
(those wait for the port's observability slice). The Tail-at-Scale
mechanics are the same:

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

import itertools
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

# SLO tiers, highest priority first.
TIERS = ("interactive", "batch")
DEFAULT_TIER = TIERS[0]
_TIER_RANK = {t: i for i, t in enumerate(TIERS)}

_request_ids = itertools.count(1)


class Counter:
    """Thread-safe counter with optional labels."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: Dict[tuple, int] = {}

    def inc(self, n: int = 1, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            self._series[key] = self._series.get(key, 0) + n

    def total(self) -> int:
        with self._lock:
            return sum(self._series.values())

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                ",".join(f"{k}={v}" for k, v in key): n
                for key, n in self._series.items()
            }


class Gauge:
    """Thread-safe last-value gauge."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Request:
    """One admitted prediction request.

    The handler thread waits on ``event``; the engine fills the result.
    ``finish`` is claim-once: the first caller (engine delivering, or a
    deadline-expired waiter abandoning) wins, the loser's call returns
    False and must not touch the payload.
    """

    __slots__ = (
        "id", "images", "n", "deadline", "enqueued_at", "event",
        "status", "log_probs", "error", "tier", "_lock", "_done",
    )

    def __init__(self, images: np.ndarray, deadline: float,
                 tier: str = DEFAULT_TIER):
        self.id = next(_request_ids)
        self.images = images
        self.n = int(images.shape[0])
        self.deadline = deadline
        self.tier = tier
        self.enqueued_at = time.monotonic()
        self.event = threading.Event()
        self.status: Optional[str] = None
        self.log_probs: Optional[np.ndarray] = None
        self.error = ""
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

    def _best_index_locked(self) -> int:
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
    examples (padded), so the kernels see one shape for the whole run.
    """

    def __init__(
        self,
        predict_fn: Callable,
        *,
        batch_size: int,
        queue: AdmissionQueue,
        breaker: Any,
        stall_timeout_s: float = 1.0,
        linger_s: float = 0.002,
    ):
        self.predict_fn = predict_fn
        self.batch_size = int(batch_size)
        self.queue = queue
        self.breaker = breaker
        self.stall_timeout_s = float(stall_timeout_s)
        self.linger_s = float(linger_s)
        self.batch_seq = 0
        self.draining = False
        self._stop = threading.Event()
        self._busy = False
        self._thread: Optional[threading.Thread] = None
        self.requests_ctr = Counter()   # by final status
        self.shed_ctr = Counter()       # by reason and tier
        self.batches_ctr = Counter()

    # -- admission (handler threads) ----------------------------------------

    def submit(self, images: np.ndarray, deadline: float,
               tier: str = DEFAULT_TIER):
        """Admit or shed. Returns a :class:`Request`, or a shed-reason
        string (``draining`` | ``breaker_open`` | ``queue_full``)."""
        if self.draining or self._stop.is_set():
            return self._shed("draining", tier)
        if not self.breaker.admits():
            return self._shed("breaker_open", tier)
        req = Request(images, deadline, tier=tier)
        admitted, victim = self.queue.put_or_displace(req)
        if victim is not None and victim.finish(
            "shed", error="displaced by a higher-tier admission"
        ):
            self.shed_ctr.inc(reason="displaced", tier=victim.tier)
            self.requests_ctr.inc(status="shed")
        if not admitted:
            return self._shed("queue_full", tier)
        return req

    def _shed(self, reason: str, tier: str) -> str:
        self.shed_ctr.inc(reason=reason, tier=tier)
        self.requests_ctr.inc(status="shed")
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
            except Exception:
                # The worker must outlive ANY per-batch failure: a dead
                # worker is a silent total outage behind a green healthz.
                # The batch's unresolved requests 504 at their deadlines.
                log.exception(
                    "serve-engine batch %d processing failed; worker "
                    "continues", self.batch_seq,
                )
            finally:
                self._busy = False

    def _process(self, reqs: List[Request]) -> None:
        self.batch_seq += 1
        now = time.monotonic()
        live = []
        for r in reqs:
            if r.expired(now):
                self._finish(r, "deadline", error="deadline exceeded in queue")
            else:
                live.append(r)
        if not live:
            return
        if not self.breaker.allow():
            for r in live:
                self._finish(r, "breaker_open", error="circuit breaker open")
            return
        t0 = time.perf_counter()
        try:
            x = np.concatenate([r.images for r in live], axis=0)
            pad = self.batch_size - x.shape[0]
            if pad:
                x = np.concatenate(
                    [x, np.zeros((pad, *x.shape[1:]), x.dtype)], axis=0
                )
            out = _to_numpy(self.predict_fn(x))
        except Exception as e:  # any backend error must trip, not crash
            dt = time.perf_counter() - t0
            self.breaker.record_failure(f"{type(e).__name__}: {e}")
            log.warning(
                "serve batch %d failed after %.3fs (%s: %s)",
                self.batch_seq, dt, type(e).__name__, e,
            )
            for r in live:
                self._finish(
                    r, "error",
                    error=f"backend failure: {type(e).__name__}: {e}",
                )
            return
        dt = time.perf_counter() - t0
        self.batches_ctr.inc()
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
            self._finish(r, "ok", log_probs=rows)

    def _finish(self, req: Request, status: str, *,
                log_probs: Optional[np.ndarray] = None,
                error: str = "") -> None:
        """Resolve ``req``. A failed claim means the waiter already
        abandoned it at its deadline — count that, not the late result."""
        if not req.finish(status, log_probs=log_probs, error=error):
            status = "deadline"
        self.requests_ctr.inc(status=status)

    # -- lifecycle ----------------------------------------------------------

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
