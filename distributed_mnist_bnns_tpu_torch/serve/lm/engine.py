"""Continuous-batching LM engine: iteration-level scheduling over a paged
KV cache.

Counterpart of the JAX package's ``serve/lm/engine.py``, without its hooks
into the recompile fence, cost ledger, device profiling, tracing, chaos,
the prefix cache and speculative decoding (later slices of the port).
Every decode iteration runs ALL active batch slots through one call of
the paged decoder; between iterations the scheduler admits queued
requests into freed slots, so sequences join and leave the batch
mid-generation while the call's shapes never change (fixed slot count,
fixed page-table width).

KV memory is block-paged (``ops/paged_kv.py``): a request's pages are
allocated at admission and returned the moment it finishes, errors, is
cancelled or misses its deadline. Admission follows ``serve/core.py``: a
bounded queue (shed ``queue_full`` past it), deadlines enforced while
queued (never prefilled) and mid-stream (evicted between iterations),
and drain (stop admitting, finish what is streaming). Sampling is
host-side numpy, so the decoder's calls carry no sampling state.
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np

from ...ops.paged_kv import PageAllocator, pages_needed
from ..core import Counter, Gauge

log = logging.getLogger(__name__)

TOKENS_TOTAL = "lm_tokens_total"
REQUESTS_TOTAL = "lm_requests_total"
SHED_TOTAL = "lm_shed_total"
ACTIVE_STREAMS = "lm_active_streams"
PAGE_OCCUPANCY = "lm_page_occupancy"

_request_ids = itertools.count(1)


class _PrefillDispatchError(RuntimeError):
    """A prefill call failed after it may have written into the pools,
    unlike a host-side failure after it (sampling), which leaves them
    intact. The recovery differs: pools-lost recovery evicts every
    active stream."""


class LMRequest:
    """One admitted generation request and its token stream.

    The engine pushes ``{"kind": "token", ...}`` dicts followed by one
    ``{"kind": "done", "status": ...}`` into ``events``; the transport
    drains it. ``cancelled`` is the consumer's back-signal (client gone,
    queued-deadline 504): the scheduler sees it between iterations and
    frees the pages.
    """

    __slots__ = (
        "id", "prompt", "max_new_tokens", "deadline", "temperature",
        "seed", "rng", "enqueued_at", "events", "cancelled", "status",
        "tokens", "slot", "n_emitted",
    )

    def __init__(
        self, prompt: np.ndarray, max_new_tokens: int, deadline: float,
        temperature: float = 0.0, seed: int = 0,
    ):
        self.id = next(_request_ids)
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = float(deadline)
        self.temperature = float(temperature)
        self.seed = int(seed)
        # Built here so an invalid seed raises on the submitter's thread,
        # not inside the scheduler's admission path.
        self.rng = (
            np.random.default_rng(self.seed)
            if self.temperature > 0 else None
        )
        self.enqueued_at = time.monotonic()
        self.events: "queue.Queue[Dict[str, Any]]" = queue.Queue()
        self.cancelled = False
        self.status: Optional[str] = None
        self.tokens: List[int] = []
        self.slot: Optional[int] = None
        self.n_emitted = 0

    def expired(self, now: Optional[float] = None) -> bool:
        return (time.monotonic() if now is None else now) >= self.deadline


class _Slot:
    """Host-side state of one batch slot (the device state lives in the
    pools and the engine's position/table arrays)."""

    __slots__ = ("req", "pages", "total_len", "rng", "admitted_at")

    def __init__(self, req: LMRequest, pages: List[int], total_len: int,
                 admitted_at: float):
        self.req = req
        self.pages = pages
        self.total_len = total_len          # prompt + clamped max_new
        self.rng = req.rng
        self.admitted_at = admitted_at


class LMEngine:
    """Single-worker continuous-batching engine over a
    :class:`~...infer_transformer.PagedLMDecoder`.

    ``submit`` returns an :class:`LMRequest` (stream from its ``events``
    queue) or a shed-reason string (``queue_full`` | ``draining`` |
    ``engine_failed``), the admission contract of ``serve.core``.
    """

    def __init__(self, decoder, *, queue_depth: int = 16):
        self.decoder = decoder
        self.queue_depth = int(queue_depth)
        self.allocator = PageAllocator(decoder.num_pages)
        self.max_len = int(decoder.max_len)
        s, p = int(decoder.slots), int(decoder.max_pages)
        self._page_tables = np.zeros((s, p), np.int32)
        self._positions = np.zeros(s, np.int32)
        self._tokens = np.zeros(s, np.int32)
        self._slots: List[Optional[_Slot]] = [None] * s
        self._pools = None
        self._queue: deque[LMRequest] = deque()
        self._cond = threading.Condition()
        self._stop = threading.Event()
        self.draining = False
        self._closed = False           # set by the final queue drain
        self.batch_seq = 0             # decode iterations dispatched
        self._thread: Optional[threading.Thread] = None
        self.tokens_ctr = Counter()    # TOKENS_TOTAL, by phase
        self.requests_ctr = Counter()  # REQUESTS_TOTAL, by final status
        self.shed_ctr = Counter()      # SHED_TOTAL, by reason
        self.active_gauge = Gauge()    # ACTIVE_STREAMS
        self.occupancy_gauge = Gauge() # PAGE_OCCUPANCY
        # host-clock times of the latest admissions' prefills and of the
        # latest decode iterations (each ends in a device sync)
        self.prefill_ms: deque[float] = deque(maxlen=1024)
        self.iter_ms: deque[float] = deque(maxlen=1024)

    # -- introspection ------------------------------------------------------

    @property
    def active_streams(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    @property
    def queue_len(self) -> int:
        with self._cond:
            return len(self._queue)

    def metrics(self) -> Dict[str, Any]:
        """Counter and gauge snapshot under their metric names."""
        return {
            TOKENS_TOTAL: self.tokens_ctr.snapshot(),
            REQUESTS_TOTAL: self.requests_ctr.snapshot(),
            SHED_TOTAL: self.shed_ctr.snapshot(),
            ACTIVE_STREAMS: self.active_gauge.value,
            PAGE_OCCUPANCY: self.occupancy_gauge.value,
        }

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "LMEngine":
        """Run one prefill and one decode against the null page (the
        kernels are built and loaded before the first request), then
        start the scheduler."""
        dec = self.decoder
        pools = dec.init_pools()
        pools, lp = dec.prefill(
            pools, np.zeros(dec.prefill_chunk, np.int32),
            np.zeros(dec.max_pages, np.int32), 0, 0,
        )
        pools, lp = dec.decode(
            pools, self._tokens, self._page_tables, self._positions
        )
        lp.cpu()
        self._pools = pools
        log.info("lm engine warm: kernels=%s", bool(dec.kernels))
        self._thread = threading.Thread(
            target=self._run, name="lm-engine", daemon=True
        )
        self._thread.start()
        return self

    def begin_drain(self) -> None:
        self.draining = True

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, wait for queued and streaming work to finish.
        Returns False on timeout (callers still stop)."""
        self.begin_drain()
        deadline = time.monotonic() + timeout
        while self.queue_len or self.active_streams:
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        return True

    def stop(self) -> None:
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    # -- admission (transport threads) --------------------------------------

    def submit(
        self, prompt, max_new_tokens: int, deadline: float, *,
        temperature: float = 0.0, seed: int = 0,
    ):
        """Admit or shed. Returns an :class:`LMRequest` or a shed-reason
        string. Validation of the prompt against ``max_len`` is the
        transport's job (it owns the 4xx replies)."""
        if self.draining or self._stop.is_set():
            return self._shed("draining")
        if self._thread is not None and not self._thread.is_alive():
            return self._shed("engine_failed")
        req = LMRequest(prompt, max_new_tokens, deadline,
                        temperature=temperature, seed=seed)
        with self._cond:
            if self._closed:
                # the scheduler drained the queue for the last time
                # between the checks above and here
                reason = "engine_failed"
            elif len(self._queue) >= self.queue_depth:
                reason = "queue_full"
            else:
                self._queue.append(req)
                self._cond.notify()
                return req
        return self._shed(reason)

    def _shed(self, reason: str) -> str:
        self.shed_ctr.inc(reason=reason)
        self.requests_ctr.inc(status="shed")
        return reason

    # -- scheduler ----------------------------------------------------------

    def _run(self) -> None:
        while True:
            try:
                if self._stop.is_set():
                    self._cancel_all("engine stopped")
                    return
                self._admit_ready()
                if self.active_streams == 0:
                    with self._cond:
                        if not self._queue and not self._stop.is_set():
                            self._cond.wait(0.02)
                    continue
                if self._stop.is_set():
                    self._cancel_all("engine stopped")
                    return
                self._decode_once()
            except Exception:
                log.exception(
                    "lm-engine iteration %d failed; scheduler continues",
                    self.batch_seq,
                )
                time.sleep(0.01)

    def _free_slot_index(self) -> Optional[int]:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return None

    def _purge_dead_queued(self) -> None:
        """Drop expired and cancelled entries from the queue even while
        every slot is busy, so they stop holding queue places."""
        with self._cond:
            dead = [r for r in self._queue if r.expired() or r.cancelled]
            if not dead:
                return
            kept = [r for r in self._queue
                    if not (r.expired() or r.cancelled)]
            self._queue.clear()
            self._queue.extend(kept)
        for req in dead:
            if req.expired():
                self._finish(req, "deadline", "deadline exceeded in queue")
            else:
                self._finish(req, "cancelled", "cancelled while queued")

    def _admit_ready(self) -> None:
        """Pop queued requests into free slots while pages allow; runs
        between decode iterations."""
        self._purge_dead_queued()
        while True:
            slot = self._free_slot_index()
            if slot is None:
                return
            with self._cond:
                if not self._queue:
                    return
                req = self._queue.popleft()
            if req.expired():
                self._finish(req, "deadline", "deadline exceeded in queue")
                continue
            if req.cancelled:
                self._finish(req, "cancelled", "cancelled while queued")
                continue
            total = min(len(req.prompt) + req.max_new_tokens, self.max_len)
            need = pages_needed(total, self.decoder.page_size)
            if need > self.allocator.capacity:
                self._finish(
                    req, "error",
                    f"request needs {need} pages, pool holds "
                    f"{self.allocator.capacity}",
                )
                continue
            pages = self.allocator.alloc(need)
            if pages is None:
                # not enough KV memory: back to the head of the queue;
                # running sequences free pages as they finish
                with self._cond:
                    self._queue.appendleft(req)
                return
            try:
                self._prefill_into_slot(req, slot, pages, total)
            except Exception as e:
                log.exception("lm-engine prefill for request %s failed",
                              req.id)
                cause = e.__cause__ if e.__cause__ is not None else e
                detail = f"prefill failure: {type(cause).__name__}: {cause}"
                st = self._slots[slot]
                if st is not None and st.req is req:
                    self._evict(slot, "error", detail)   # frees the pages
                elif req.status is None:
                    self.allocator.free(pages)
                    self._finish(req, "error", detail)
                if isinstance(e, _PrefillDispatchError):
                    self._dispatch_failure(cause)

    def _prefill_into_slot(
        self, req: LMRequest, slot: int, pages: List[int], total: int
    ) -> None:
        dec = self.decoder
        admitted_at = time.monotonic()
        t0 = time.perf_counter()
        table = np.zeros(dec.max_pages, np.int32)
        table[: len(pages)] = pages
        plen = len(req.prompt)
        chunk = dec.prefill_chunk
        padded = -(-plen // chunk) * chunk
        prompt = np.zeros(padded, np.int32)
        prompt[:plen] = req.prompt
        try:
            for start in range(0, padded, chunk):
                self._pools, clp = dec.prefill(
                    self._pools, prompt[start:start + chunk], table,
                    start, plen,
                )
            lp_host = clp.cpu().numpy()   # the sync: a device error shows here
        except Exception as e:
            raise _PrefillDispatchError(
                f"prefill dispatch for request {req.id}"
            ) from e
        self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
        self.tokens_ctr.inc(plen, phase="prefill")
        st = _Slot(req, pages, total, admitted_at)
        # The prompt's last position predicts position plen.
        first = self._sample_token(req, lp_host[plen - 1 - (padded - chunk)],
                                   st.rng)
        self._slots[slot] = st
        req.slot = slot
        self._page_tables[slot] = table
        self._positions[slot] = plen       # next decode writes position plen
        self._tokens[slot] = first
        self.active_gauge.set(self.active_streams)
        self.occupancy_gauge.set(self.allocator.occupancy())
        self._emit_token(req, first)
        self._maybe_finish(slot)

    def _sample_token(self, req: LMRequest, lp: np.ndarray, rng) -> int:
        """Greedy at temperature 0, else categorical from the request's
        own host RNG."""
        if req.temperature > 0 and rng is not None:
            logits = lp / req.temperature
            logits = logits - logits.max()
            p = np.exp(logits)
            p /= p.sum()
            return int(rng.choice(len(p), p=p))
        return int(np.argmax(lp))

    def _emit_token(self, req: LMRequest, token: int) -> None:
        req.n_emitted += 1
        req.tokens.append(int(token))
        self.tokens_ctr.inc(phase="decode")
        req.events.put({
            "kind": "token", "i": req.n_emitted - 1, "token": int(token),
        })

    def _decode_once(self) -> None:
        """One iteration for every active slot."""
        self.batch_seq += 1
        self._expire_active()
        if self.active_streams == 0:
            return
        t0 = time.perf_counter()
        try:
            self._pools, lp = self.decoder.decode(
                self._pools, self._tokens, self._page_tables,
                self._positions,
            )
            lp_host = lp.cpu().numpy()         # per-iteration sync point
        except Exception as e:
            self._dispatch_failure(e)
            return
        self.iter_ms.append((time.perf_counter() - t0) * 1e3)
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            nxt = self._sample_token(st.req, lp_host[slot], st.rng)
            self._positions[slot] += 1
            self._tokens[slot] = nxt
            self._emit_token(st.req, nxt)
            self._maybe_finish(slot)

    def _dispatch_failure(self, e: Exception) -> None:
        """A decoder call failed part way: the pools may hold partial
        writes, so every active stream fails here, and the engine goes
        on serving new requests on fresh pools."""
        log.error(
            "lm-engine dispatch failed at iteration %d (%s: %s): failing "
            "%d active stream(s), rebuilding the pools", self.batch_seq,
            type(e).__name__, e, self.active_streams,
        )
        self._evict_all(
            "error",
            f"decode dispatch failed, KV state lost ({type(e).__name__}: {e})",
        )
        self._pools = self.decoder.init_pools()

    def _expire_active(self) -> None:
        now = time.monotonic()
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            if st.req.cancelled:
                self._evict(slot, "cancelled", "client went away")
            elif st.req.expired(now):
                self._evict(slot, "deadline", "deadline exceeded mid-stream")

    def _maybe_finish(self, slot: int) -> None:
        st = self._slots[slot]
        if st is None:
            return
        req = st.req
        if req.n_emitted >= req.max_new_tokens:
            self._evict(slot, "ok", "")
        elif len(req.prompt) + req.n_emitted >= st.total_len:
            self._evict(slot, "ok", "max_len reached")

    # -- eviction / completion ----------------------------------------------

    def _evict(self, slot: int, status: str, detail: str) -> None:
        st = self._slots[slot]
        if st is None:
            return
        self._slots[slot] = None
        self._page_tables[slot] = 0
        self._positions[slot] = 0
        self._tokens[slot] = 0
        self.allocator.free(st.pages)
        st.req.slot = None
        self._finish(st.req, status, detail)
        self.active_gauge.set(self.active_streams)
        self.occupancy_gauge.set(self.allocator.occupancy())

    def _evict_all(self, status: str, detail: str) -> None:
        for slot, st in enumerate(self._slots):
            if st is not None:
                self._evict(slot, status, detail)

    def _cancel_all(self, detail: str) -> None:
        # Close admission under the queue lock first: a racing submit()
        # either lands before this (and is drained below) or sheds.
        with self._cond:
            self._closed = True
        self._evict_all("cancelled", detail)
        while True:
            with self._cond:
                if not self._queue:
                    return
                req = self._queue.popleft()
            self._finish(req, "cancelled", detail)

    def _finish(self, req: LMRequest, status: str, detail: str) -> None:
        req.status = status
        self.requests_ctr.inc(status=status)
        req.events.put({
            "kind": "done", "status": status, "n": req.n_emitted,
            "id": req.id, **({"detail": detail} if detail else {}),
        })
