"""Continuous-batching LM engine: iteration-level scheduling over a paged
KV cache.

Counterpart of the JAX package's ``serve/lm/engine.py``, with its
telemetry: the registry's ``lm_*`` metrics; the ``lm_warmup``,
``lm_admit``, ``lm_prefix_hit``, ``lm_evict``, ``lm_decode`` and
``lm_spec_round`` (every ``decode_event_every`` iterations) and
``lm_decode_error`` events; each stream's span tree (``lm.request`` with
``lm.queue``, ``lm.page_alloc``, ``lm.prefill`` and ``lm.decode``, one
``lm.decode_iter`` span an iteration, with ``lm.draft`` and
``lm.verify`` in a speculative one); the cost ledger's ``lm_prefill``,
``lm_decode`` and ``lm_verify`` rows (the warm-up calls) and dispatch
times (CUDA events); the ``jg_step`` profiler region while a capture is
live; the chaos hook before each decode iteration (``resilience/chaos``,
``infer_error`` / ``infer_slow``). Without its recompile fence (PyTorch
compiles nothing per shape).

``prefix_cache=True`` shares prompt prefixes copy-on-write
(``prefix_cache.PrefixCache``): admission forks the longest cached
full-page prefix and prefills only the suffix, eviction publishes the
sequence's full pages back, and a dispatch failure drops the index.
A decoder with a ``verify`` call (``make_paged_lm_decoder(spec_k=K)``)
arms self-speculative decoding: each round drafts ``K - 1`` tokens
through ``decode``, scores the window in one ``verify`` call and accepts
on the host the longest draft prefix the verifier agrees with, emitting
``a + 1`` tokens a slot; a round with any sampling slot runs plain.
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

import contextlib
import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ...obs.costs import get_ledger
from ...obs.profile import get_profiler, step_annotation
from ...obs.recompile import get_tracker
from ...obs.registry import MetricsRegistry
from ...obs.telemetry import StepClock
from ...obs.trace import NULL_SPAN, NULL_TRACER, TraceContext, next_request_id
from ...ops.paged_kv import PageAllocator, pages_needed
from ..core import labeled
from .prefix_cache import PrefixCache

log = logging.getLogger(__name__)

TOKENS_TOTAL = "lm_tokens_total"
PAGE_OCCUPANCY = "lm_page_occupancy"
ACTIVE_STREAMS = "lm_active_streams"
PREFILL_MS = "lm_prefill_ms"
DECODE_ITERATION_SECONDS = "lm_decode_iteration_seconds"
REQUESTS_TOTAL = "lm_requests_total"
SHED_TOTAL = "lm_shed_total"
DECODE_ERRORS_TOTAL = "lm_decode_errors_total"
PREFIX_HITS_TOTAL = "lm_prefix_cache_hits_total"
SPEC_TOKENS_TOTAL = "lm_spec_tokens_total"

# Final statuses whose KV contents can be trusted at eviction, so that
# its pages may enter the prefix index. "error" evictions never publish:
# the pools may have been rebuilt under them.
_PUBLISHABLE_STATUSES = ("ok", "deadline", "cancelled")

# Millisecond buckets for the prefill histogram (the default registry
# buckets are seconds-scaled; prefill is a handful of chunk calls).
_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0,
)


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
        "tokens", "slot", "n_emitted", "span",
    )

    def __init__(
        self, prompt: np.ndarray, max_new_tokens: int, deadline: float,
        temperature: float = 0.0, seed: int = 0,
    ):
        self.id = next_request_id()   # run-scoped: the event/span join key
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
        self.span = NULL_SPAN      # root trace span, set at admission

    def expired(self, now: Optional[float] = None) -> bool:
        return (time.monotonic() if now is None else now) >= self.deadline


class _Slot:
    """Host-side state of one batch slot (the device state lives in the
    pools and the engine's position/table arrays)."""

    __slots__ = ("req", "pages", "total_len", "rng", "admitted_at",
                 "decode_span")

    def __init__(self, req: LMRequest, pages: List[int], total_len: int,
                 admitted_at: float):
        self.req = req
        self.pages = pages
        self.total_len = total_len          # prompt + clamped max_new
        self.rng = req.rng
        self.admitted_at = admitted_at      # queue pop, before prefill
        self.decode_span = NULL_SPAN        # the stream's decode window


class LMEngine:
    """Single-worker continuous-batching engine over a
    :class:`~...infer_transformer.PagedLMDecoder`.

    ``submit`` returns an :class:`LMRequest` (stream from its ``events``
    queue) or a shed-reason string (``queue_full`` | ``draining`` |
    ``engine_failed``), the admission contract of ``serve.core``.
    Metrics go to the telemetry's registry (an engine of its own without
    one); ``device`` is the decoder's (the ledger's CUDA events).

    ``chaos`` (a ``resilience.ChaosController``) fires its serving rules
    before each decode iteration's dispatch (``on_infer(step=batch_seq)``):
    an injected error there touches no pool, so the iteration is retried,
    up to ``max_consecutive_failures`` in a row, past which every active
    stream fails (the JAX engine's fence).

    ``prefix_cache`` arms the copy-on-write prefix index; a decoder with
    a ``verify`` call arms speculative rounds (module docstring).
    """

    def __init__(self, decoder, *, queue_depth: int = 16,
                 telemetry: Any = None, device: Any = None,
                 decode_event_every: int = 50, chaos: Any = None,
                 max_consecutive_failures: int = 4,
                 prefix_cache: bool = False):
        self.decoder = decoder
        self.chaos = chaos
        self.max_consecutive_failures = int(max_consecutive_failures)
        self._consecutive_failures = 0
        self.telemetry = telemetry
        self.device = device
        self.decode_event_every = max(int(decode_event_every), 1)
        self.queue_depth = int(queue_depth)
        self.allocator = PageAllocator(decoder.num_pages)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(self.allocator, decoder.page_size)
            if prefix_cache else None
        )
        self.spec_k = (int(decoder.spec_k)
                       if getattr(decoder, "verify", None) is not None else 0)
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
        self._tracker = get_tracker()
        self._compile_baseline: Optional[int] = None
        # off by default: one attribute check each a dispatch
        self._ledger = get_ledger()
        self._profiler = get_profiler()
        self._clock = StepClock(device if device is not None else "cpu")
        self.pool_reserved_bytes = 0   # set once the pools exist
        self.page_bytes = 0
        self.tracer = getattr(telemetry, "tracer", None) or NULL_TRACER
        reg = (telemetry.registry if telemetry is not None
               else MetricsRegistry())
        self.registry = reg
        self.tokens_ctr = reg.counter(
            TOKENS_TOTAL, "LM tokens processed (phase=prefill|decode)"
        )
        self.occupancy_gauge = reg.gauge(
            PAGE_OCCUPANCY, "fraction of KV pages in use"
        )
        self.active_gauge = reg.gauge(
            ACTIVE_STREAMS, "generation streams holding a batch slot"
        )
        self.prefill_hist = reg.histogram(
            PREFILL_MS, "admission prefill wall time (ms)",
            buckets=_MS_BUCKETS,
        )
        self.iter_hist = reg.histogram(
            DECODE_ITERATION_SECONDS,
            "decode iteration wall time (= inter-token latency while "
            "the batch is stable)",
        )
        self.requests_ctr = reg.counter(
            REQUESTS_TOTAL, "LM requests by final status"
        )
        self.shed_ctr = reg.counter(
            SHED_TOTAL, "LM admission rejections by reason"
        )
        self.errors_ctr = reg.counter(
            DECODE_ERRORS_TOTAL, "decode dispatch failures"
        )
        self.prefix_hits_ctr = reg.counter(
            PREFIX_HITS_TOTAL,
            "prefix-cache admission lookups (result=hit|miss)",
        )
        self.spec_tokens_ctr = reg.counter(
            SPEC_TOKENS_TOTAL,
            "draft tokens by verify outcome (outcome=accepted|rejected)",
        )
        self._spec_drafted = 0         # drafts proposed, lifetime
        self._spec_accepted = 0        # drafts accepted, lifetime
        self._spec_rounds = 0          # verify calls, lifetime
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

    @property
    def recompiles_post_warmup(self) -> Optional[int]:
        """Builds (kernel loads, captures) since the warm-up ended."""
        if self._compile_baseline is None:
            return None
        return self._tracker.count - self._compile_baseline

    @property
    def spec_acceptance_rate(self) -> Optional[float]:
        """Accepted / drafted over the engine's lifetime (None until a
        speculative round drafted anything)."""
        if self._spec_drafted == 0:
            return None
        return self._spec_accepted / self._spec_drafted

    @property
    def spec_rounds(self) -> int:
        """Speculative rounds run (one ``verify`` call each)."""
        return self._spec_rounds

    def metrics(self) -> Dict[str, Any]:
        """Counter and gauge view under their metric names (counters as
        ``{"k=v": value}``)."""
        return {
            TOKENS_TOTAL: labeled(self.tokens_ctr),
            REQUESTS_TOTAL: labeled(self.requests_ctr),
            SHED_TOTAL: labeled(self.shed_ctr),
            PREFIX_HITS_TOTAL: labeled(self.prefix_hits_ctr),
            SPEC_TOKENS_TOTAL: labeled(self.spec_tokens_ctr),
            ACTIVE_STREAMS: self.active_gauge.value() or 0.0,
            PAGE_OCCUPANCY: self.occupancy_gauge.value() or 0.0,
        }

    def prefix_cache_stats(self) -> Optional[Dict[str, Any]]:
        """Entry count and shared-page occupancy for ``/healthz``, or
        None when the cache is off."""
        if self.prefix_cache is None:
            return None
        stats = self.prefix_cache.stats()
        stats["page_occupancy"] = round(
            stats["pages"] / max(self.allocator.capacity, 1), 4
        )
        return stats

    def kv_pool_stats(self) -> Dict[str, Any]:
        """The paged pool's memory: its fixed reservation against the
        bytes its in-use pages pin (a page leak becomes a number); also
        sets the ``kv_pool_*_bytes`` gauges."""
        in_use = self.allocator.used_count()
        stats = {
            "reserved_bytes": self.pool_reserved_bytes,
            "page_bytes": self.page_bytes,
            "pages_in_use": in_use,
            "in_use_bytes": in_use * self.page_bytes,
        }
        self.registry.gauge(
            "kv_pool_reserved_bytes", "paged KV pool reservation"
        ).set(stats["reserved_bytes"])
        self.registry.gauge(
            "kv_pool_in_use_bytes",
            "bytes pinned by in-use KV pages (pages_in_use x page_bytes)",
        ).set(stats["in_use_bytes"])
        return stats

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "LMEngine":
        """Run one prefill, one decode and, with speculative decoding, one
        verify against the null page (the kernels are built and loaded
        before the first request; with the cost ledger armed they are the
        ``lm_prefill``, ``lm_decode`` and ``lm_verify`` rows' runs), pin
        the build baseline, start the scheduler."""
        dec = self.decoder
        pools = dec.init_pools()
        measure, tel = self._ledger.measure, self.telemetry
        pools, lp = measure(
            "lm_prefill", dec.prefill, pools,
            np.zeros(dec.prefill_chunk, np.int32),
            np.zeros(dec.max_pages, np.int32), 0, 0,
            device=self.device, telemetry=tel,
        )
        pools, lp = measure(
            "lm_decode", dec.decode, pools, self._tokens,
            self._page_tables, self._positions,
            device=self.device, telemetry=tel,
        )
        if self.spec_k:
            pools, lp = measure(
                "lm_verify", dec.verify, pools,
                np.zeros((dec.slots, self.spec_k), np.int32),
                self._page_tables, self._positions,
                device=self.device, telemetry=tel,
            )
        lp.cpu()
        self._pools = pools
        self.pool_reserved_bytes = int(sum(
            int(k.nbytes) + int(v.nbytes) for k, v in pools))
        self.page_bytes = self.pool_reserved_bytes // max(dec.num_pages, 1)
        self._compile_baseline = self._tracker.mark()
        kernels = bool(dec.kernels)
        programs = 3 if self.spec_k else 2
        if tel is not None:
            tel.emit("lm_warmup", programs=programs, kernels=kernels,
                     spec_k=self.spec_k)
        log.info("lm engine warm: %d programs, kernels=%s", programs,
                 kernels)
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
        if self.prefix_cache is not None:
            # every cache-held reference goes back, so pages_in_use
            # drains to 0 (a live fork keeps its own reference)
            self.prefix_cache.clear()
            self.occupancy_gauge.set(self.allocator.occupancy())

    # -- admission (transport threads) --------------------------------------

    def submit(
        self, prompt, max_new_tokens: int, deadline: float, *,
        temperature: float = 0.0, seed: int = 0,
        ctx: Optional[TraceContext] = None,
    ):
        """Admit or shed. Returns an :class:`LMRequest` or a shed-reason
        string. Validation of the prompt against ``max_len`` is the
        transport's job (it owns the 4xx replies). ``ctx`` is an adopted
        ``x-jg-trace`` context: the stream's span tree joins the
        client's trace."""
        if self.draining or self._stop.is_set():
            return self._shed("draining", ctx=ctx)
        if self._thread is not None and not self._thread.is_alive():
            return self._shed("engine_failed", ctx=ctx)
        req = LMRequest(prompt, max_new_tokens, deadline,
                        temperature=temperature, seed=seed)
        req.span = self.tracer.start(
            "lm.request", kind="request", ctx=ctx, fresh=True,
            id=req.id, prompt_tokens=int(req.prompt.shape[0]),
            max_new_tokens=req.max_new_tokens,
        )
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
        req.span.end("shed", reason=reason)
        return self._shed(reason, spanned=True)

    def _shed(
        self, reason: str, *, ctx: Optional[TraceContext] = None,
        spanned: bool = False,
    ) -> str:
        self.shed_ctr.inc(reason=reason)
        self.requests_ctr.inc(status="shed")
        if not spanned and self.tracer.enabled:
            now = time.monotonic()
            self.tracer.record(
                "lm.request", kind="request", t0=now, t1=now,
                ctx=ctx, fresh=True, status="shed", reason=reason,
            )
        if self.telemetry is not None:
            self.telemetry.emit(
                "shed", reason=reason, queue_depth=self.queue_len,
                engine="lm",
            )
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
                self._finish_unslotted(req, "deadline",
                                       "deadline exceeded in queue")
            else:
                self._finish_unslotted(req, "cancelled",
                                       "cancelled while queued")

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
                self._finish_unslotted(req, "deadline",
                                       "deadline exceeded in queue")
                continue
            if req.cancelled:
                self._finish_unslotted(req, "cancelled",
                                       "cancelled while queued")
                continue
            total = min(len(req.prompt) + req.max_new_tokens, self.max_len)
            need_total = pages_needed(total, self.decoder.page_size)
            if need_total > self.allocator.capacity:
                self._finish_unslotted(
                    req, "error",
                    f"request needs {need_total} pages, pool holds "
                    f"{self.allocator.capacity}",
                )
                continue
            alloc_t0 = time.monotonic()
            cached_tokens, forked = 0, []
            if self.prefix_cache is not None:
                # the longest cached full-page prefix, capped so that at
                # least one prompt token prefills (admission samples the
                # first token from the suffix's log-probs)
                cached_tokens, forked = self.prefix_cache.lookup(
                    req.prompt, len(req.prompt) - 1)
            need = need_total - len(forked)
            pages = self.allocator.alloc(need)
            if pages is None and self.prefix_cache is not None:
                # pool pressure: drop LRU cache-only entries and retry
                if self.prefix_cache.evict(
                        need - self.allocator.free_count()) > 0:
                    pages = self.allocator.alloc(need)
            if pages is None:
                # not enough KV memory: back to the head of the queue
                # (with the forked references: the next try forks again);
                # running sequences free pages as they finish
                if forked:
                    self.allocator.free(forked)
                with self._cond:
                    self._queue.appendleft(req)
                return
            if self.prefix_cache is not None:
                # counted for admissions that proceed only: a requeue
                # looks up again on every scheduler pass
                self.prefix_cache.note_result(bool(forked))
                self.prefix_hits_ctr.inc(result="hit" if forked else "miss")
            pages = forked + pages     # table order: the prefix first
            if self.tracer.enabled:
                # queue wait ends when the scheduler takes the request up
                # (= alloc start); sequential children, no overlap
                self.tracer.record(
                    "lm.queue", kind="queue", parent=req.span,
                    t0=req.enqueued_at, t1=alloc_t0,
                )
                self.tracer.record(
                    "lm.page_alloc", kind="page_alloc", parent=req.span,
                    t0=alloc_t0, t1=time.monotonic(), pages=len(pages),
                    need=need, forked=len(forked),
                )
            try:
                self._prefill_into_slot(req, slot, pages, total,
                                        cached_tokens)
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
                    self._finish_unslotted(req, "error", detail)
                if isinstance(e, _PrefillDispatchError):
                    self._dispatch_failure(cause)

    def _prefill_into_slot(
        self, req: LMRequest, slot: int, pages: List[int], total: int,
        cached_tokens: int = 0,
    ) -> None:
        """Prefill the prompt past its ``cached_tokens`` (a prefix-cache
        hit: their K/V sit in the forked pages, page-aligned) in
        ``prefill_chunk`` calls that attend through the shared pages,
        then take the slot and emit the first token."""
        dec = self.decoder
        admitted_at = time.monotonic()
        t0 = time.perf_counter()
        table = np.zeros(dec.max_pages, np.int32)
        table[: len(pages)] = pages
        plen = len(req.prompt)
        suffix = plen - cached_tokens      # >= 1: the lookup is capped
        chunk = dec.prefill_chunk
        padded = -(-suffix // chunk) * chunk
        prompt = np.zeros(padded, np.int32)
        prompt[:suffix] = req.prompt[cached_tokens:]
        timed = self._ledger.enabled
        try:
            with (step_annotation("lm_prefill",
                                  req.span.trace_id or self.tracer.run_trace)
                  if self._profiler.active else contextlib.nullcontext()):
                if timed:
                    self._clock.restart()
                    token = self._clock.start()
                for off in range(0, padded, chunk):
                    self._pools, clp = dec.prefill(
                        self._pools, prompt[off:off + chunk], table,
                        cached_tokens + off, plen,
                    )
                if timed:
                    self._clock.stop(token)
            lp_host = clp.cpu().numpy()   # the sync: a device error shows here
        except Exception as e:
            raise _PrefillDispatchError(
                f"prefill dispatch for request {req.id}"
            ) from e
        prefill_ms = (time.perf_counter() - t0) * 1e3
        self.prefill_ms.append(prefill_ms)
        self.prefill_hist.observe(prefill_ms)
        if timed:
            for seconds, _ in self._clock.ready():
                self._ledger.observe("lm_prefill", seconds, n=padded // chunk)
        # the tokens prefilled: a hit's skipped prefix does not count
        self.tokens_ctr.inc(suffix, phase="prefill")
        st = _Slot(req, pages, total, admitted_at)
        if self.tracer.enabled:
            self.tracer.record(
                "lm.prefill", kind="prefill", parent=req.span,
                t0=admitted_at, t1=admitted_at + prefill_ms / 1e3,
                prompt_tokens=plen, chunks=padded // chunk, slot=slot,
                cached_tokens=cached_tokens,
            )
            # the decode window: first token out of prefill -> evict
            st.decode_span = self.tracer.start(
                "lm.decode", kind="decode", parent=req.span, slot=slot,
            )
        # The prompt's last position predicts position plen.
        first = self._sample_token(
            req, lp_host[plen - 1 - (cached_tokens + padded - chunk)], st.rng)
        self._slots[slot] = st
        req.slot = slot
        self._page_tables[slot] = table
        self._positions[slot] = plen       # next decode writes position plen
        self._tokens[slot] = first
        self.active_gauge.set(self.active_streams)
        self.occupancy_gauge.set(self.allocator.occupancy())
        if self.telemetry is not None:
            self.telemetry.emit(
                "lm_admit",
                id=req.id, slot=slot, prompt_tokens=plen,
                prefill_tokens=suffix, cached_tokens=cached_tokens,
                max_new_tokens=req.max_new_tokens, pages=len(pages),
                iteration=self.batch_seq,
                queue_ms=round((admitted_at - req.enqueued_at) * 1e3, 3),
                prefill_ms=round(prefill_ms, 3),
                page_occupancy=round(self.allocator.occupancy(), 4),
            )
            if cached_tokens:
                self.telemetry.emit(
                    "lm_prefix_hit",
                    id=req.id, slot=slot, prompt_tokens=plen,
                    cached_tokens=cached_tokens,
                    pages_forked=pages_needed(cached_tokens, dec.page_size),
                    prefill_tokens=suffix,
                    prefill_ms=round(prefill_ms, 3),
                )
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
        """One iteration for every active slot, in one ``lm.decode_iter``
        span: a speculative round when every active slot is greedy
        (acceptance is an argmax identity, and a sampling slot's RNG must
        draw once per emitted token), else a plain one."""
        self.batch_seq += 1
        self._expire_active()
        if self.active_streams == 0:
            return
        if self.spec_k and all(st is None or st.rng is None
                               for st in self._slots):
            self._spec_round()
        else:
            self._plain_round()

    def _chaos_before_dispatch(self, iter_span) -> bool:
        """Fire the chaos hook before a round's first dispatch; False
        (the round is retried) when it raised. Nothing touched a pool."""
        if self.chaos is None or not self.chaos.active:
            return True
        try:
            self.chaos.on_infer(step=self.batch_seq)
        except Exception as e:
            iter_span.end("error", error=type(e).__name__)
            self._record_predispatch_failure(e)
            return False
        return True

    def _plain_round(self) -> None:
        iter_span = self.tracer.start(
            "lm.decode_iter", kind="decode_iter",
            iteration=self.batch_seq, active=self.active_streams,
        )
        timed = self._ledger.enabled
        with iter_span:
            if not self._chaos_before_dispatch(iter_span):
                return
            t0 = time.perf_counter()
            try:
                with (step_annotation(
                        "lm_decode",
                        iter_span.trace_id or self.tracer.run_trace)
                        if self._profiler.active
                        else contextlib.nullcontext()):
                    if timed:
                        self._clock.restart()
                        token = self._clock.start()
                    self._pools, lp = self.decoder.decode(
                        self._pools, self._tokens, self._page_tables,
                        self._positions,
                    )
                    if timed:
                        self._clock.stop(token)
                lp_host = lp.cpu().numpy()     # per-iteration sync point
            except Exception as e:
                iter_span.end("error", error=type(e).__name__)
                self._dispatch_failure(e)
                return
            dt = time.perf_counter() - t0
            iter_span.end("ok", iter_ms=round(dt * 1e3, 3))
        self._consecutive_failures = 0
        self.iter_ms.append(dt * 1e3)
        self.iter_hist.observe(dt)
        if timed:
            for seconds, _ in self._clock.ready():
                self._ledger.observe("lm_decode", seconds)
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            nxt = self._sample_token(st.req, lp_host[slot], st.rng)
            self._positions[slot] += 1
            self._tokens[slot] = nxt
            self._emit_token(st.req, nxt)
            self._maybe_finish(slot)
        if (self.batch_seq % self.decode_event_every == 0
                and self.telemetry is not None):
            self.telemetry.emit(
                "lm_decode",
                iteration=self.batch_seq,
                active=self.active_streams,
                queue_depth=self.queue_len,
                iter_ms=round(dt * 1e3, 3),
                page_occupancy=round(self.allocator.occupancy(), 4),
                recompiles_post_warmup=self.recompiles_post_warmup,
            )

    def _spec_round(self) -> None:
        """One self-speculative round for every active (greedy) slot:
        ``spec_k - 1`` drafts through ``decode``, one ``verify`` call
        over the window, acceptance on the host. Each slot emits the
        accepted drafts and the verifier's correction (or, when all were
        accepted, its next token): every emitted token is a verifier
        argmax, so the tokens equal the ``spec_k == 1`` engine's. The
        call shapes never depend on how many drafts a round accepts."""
        dec, k_win = self.decoder, self.spec_k
        iter_span = self.tracer.start(
            "lm.decode_iter", kind="decode_iter",
            iteration=self.batch_seq, active=self.active_streams,
            spec_k=k_win,
        )
        timed = self._ledger.enabled
        with iter_span:
            if not self._chaos_before_dispatch(iter_span):
                return
            t0 = time.perf_counter()
            try:
                with (step_annotation(
                        "lm_spec_round",
                        iter_span.trace_id or self.tracer.run_trace)
                        if self._profiler.active
                        else contextlib.nullcontext()):
                    if timed:
                        self._clock.restart()
                        token = self._clock.start()
                    # the drafts stay on the device and advance local
                    # positions: the engine's arrays move only with what
                    # the host accepts
                    draft_t0 = time.monotonic()
                    window = [torch.from_numpy(self._tokens.copy())]
                    d_positions = self._positions.copy()
                    for _ in range(1, k_win):
                        self._pools, lp = dec.decode(
                            self._pools, window[-1], self._page_tables,
                            d_positions,
                        )
                        window.append(lp.argmax(dim=-1))
                        d_positions = d_positions + 1
                    device = window[-1].device
                    window = torch.stack([w.to(device) for w in window], 1)
                    draft_t1 = time.monotonic()
                    if timed and k_win > 1:
                        self._clock.stop(token, "lm_decode")
                        token = self._clock.start()
                    # one call scores every window position and writes
                    # the verifier's K/V over the drafts'
                    self._pools, vlp = dec.verify(
                        self._pools, window, self._page_tables,
                        self._positions,
                    )
                    if timed:
                        self._clock.stop(token, "lm_verify")
                greedy = vlp.argmax(dim=-1).cpu().numpy()   # (S, K): sync
                window = window.cpu().numpy()
                verify_t1 = time.monotonic()
            except Exception as e:
                iter_span.end("error", error=type(e).__name__)
                self._dispatch_failure(e)
                return
            dt = time.perf_counter() - t0
            if self.tracer.enabled:
                self.tracer.record(
                    "lm.draft", kind="draft", parent=iter_span,
                    t0=draft_t0, t1=draft_t1, drafts=k_win - 1,
                )
                self.tracer.record(
                    "lm.verify", kind="verify", parent=iter_span,
                    t0=draft_t1, t1=verify_t1, window=k_win,
                )
            iter_span.end("ok", iter_ms=round(dt * 1e3, 3))
        self._consecutive_failures = 0
        self.iter_ms.append(dt * 1e3)
        self.iter_hist.observe(dt)
        if timed:
            for seconds, name in self._clock.ready():
                self._ledger.observe(
                    name, seconds, n=k_win - 1 if name == "lm_decode" else 1)
        round_accepted = round_drafted = 0
        for slot, st in enumerate(self._slots):
            if st is None:
                continue
            # window[a + 1] (a draft) against greedy[a] (the verifier's
            # choice after window[a])
            a = 0
            while a < k_win - 1 and window[slot, a + 1] == greedy[slot, a]:
                a += 1
            round_drafted += k_win - 1
            round_accepted += a
            self._positions[slot] += a + 1
            self._tokens[slot] = int(greedy[slot, a])
            for tok in [*window[slot, 1:a + 1], greedy[slot, a]]:
                self._emit_token(st.req, int(tok))
                self._maybe_finish(slot)
                if self._slots[slot] is None:
                    break                  # finished inside the window
        self._spec_rounds += 1
        self._spec_drafted += round_drafted
        self._spec_accepted += round_accepted
        if round_accepted:
            self.spec_tokens_ctr.inc(round_accepted, outcome="accepted")
        if round_drafted - round_accepted:
            self.spec_tokens_ctr.inc(round_drafted - round_accepted,
                                     outcome="rejected")
        if (self.batch_seq % self.decode_event_every == 0
                and self.telemetry is not None):
            rate = self.spec_acceptance_rate
            self.telemetry.emit(
                "lm_spec_round",
                iteration=self.batch_seq,
                active=self.active_streams,
                spec_k=k_win,
                accepted=round_accepted,
                drafted=round_drafted,
                acceptance_rate=(round(rate, 4) if rate is not None
                                 else None),
                iter_ms=round(dt * 1e3, 3),
                page_occupancy=round(self.allocator.occupancy(), 4),
                recompiles_post_warmup=self.recompiles_post_warmup,
            )

    def _record_predispatch_failure(self, e: Exception) -> None:
        """A fault before the dispatch (chaos ``infer_error``): counted and
        retried; ``max_consecutive_failures`` in a row fail every active
        stream, as a wedged backend must."""
        self._consecutive_failures += 1
        self.errors_ctr.inc(kind=type(e).__name__)
        log.warning("lm-engine decode iteration %d failed (%s: %s): "
                    "attempt %d/%d", self.batch_seq, type(e).__name__, e,
                    self._consecutive_failures,
                    self.max_consecutive_failures)
        if self.telemetry is not None:
            self.telemetry.emit(
                "lm_decode_error", iteration=self.batch_seq,
                error=f"{type(e).__name__}: {e}"[:500],
                consecutive=self._consecutive_failures)
        if self._consecutive_failures >= self.max_consecutive_failures:
            self._evict_all(
                "error",
                f"{self._consecutive_failures} consecutive decode failures "
                f"(last: {type(e).__name__}: {e})")
            self._consecutive_failures = 0

    def _dispatch_failure(self, e: Exception) -> None:
        """A decoder call failed part way: the pools may hold partial
        writes, so every active stream fails here, and the engine goes
        on serving new requests on fresh pools."""
        self.errors_ctr.inc(kind=type(e).__name__)
        if self.telemetry is not None:
            self.telemetry.emit(
                "lm_decode_error", iteration=self.batch_seq,
                error=f"{type(e).__name__}: {e}"[:500],
                fatal_to_streams=True,
            )
        log.error(
            "lm-engine dispatch failed at iteration %d (%s: %s): failing "
            "%d active stream(s), rebuilding the pools", self.batch_seq,
            type(e).__name__, e, self.active_streams,
        )
        self._evict_all(
            "error",
            f"decode dispatch failed, KV state lost ({type(e).__name__}: {e})",
        )
        if self.prefix_cache is not None:
            # fresh pools make every cached page's contents garbage
            # (the error evictions above published nothing)
            dropped = self.prefix_cache.clear()
            if dropped:
                log.warning("prefix cache invalidated after a dispatch "
                            "failure (%d entries dropped)", dropped)
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
        req = st.req
        published = 0
        if (self.prefix_cache is not None
                and status in _PUBLISHABLE_STATUSES and req.n_emitted >= 1):
            # publish instead of free: the written K/V (the prompt and
            # every emitted token but the pending last one) enters the
            # index; full pages move their reference to the cache,
            # duplicates and the partial tail are released
            written = len(req.prompt) + req.n_emitted - 1
            seq = np.concatenate([
                req.prompt, np.asarray(req.tokens[:req.n_emitted - 1],
                                       np.int32)])[:written]
            published = self.prefix_cache.insert(seq, st.pages)
        else:
            self.allocator.free(st.pages)
        req.slot = None
        st.decode_span.end(status, tokens=req.n_emitted,
                           iteration=self.batch_seq)
        self._finish(req, status, detail, slot=slot,
                     pages_freed=len(st.pages), pages_published=published,
                     wall_ms=round(
                         (time.monotonic() - st.admitted_at) * 1e3, 3))
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
            self._finish_unslotted(req, "cancelled", detail)

    def _finish_unslotted(
        self, req: LMRequest, status: str, detail: str
    ) -> None:
        """A request that never took a slot: its whole life was queue
        wait, and its span tree says so."""
        if self.tracer.enabled and req.span is not NULL_SPAN:
            self.tracer.record(
                "lm.queue", kind="queue", parent=req.span,
                t0=req.enqueued_at, t1=time.monotonic(),
            )
        self._finish(req, status, detail, slot=None, pages_freed=0,
                     wall_ms=round(
                         (time.monotonic() - req.enqueued_at) * 1e3, 3))

    def _finish(
        self, req: LMRequest, status: str, detail: str, *,
        slot: Optional[int], pages_freed: int, wall_ms: float,
        pages_published: int = 0,
    ) -> None:
        req.status = status
        self.requests_ctr.inc(status=status)
        req.span.end(status, tokens_emitted=req.n_emitted,
                     iteration=self.batch_seq)
        if self.telemetry is not None:
            fields: Dict[str, Any] = {
                "id": req.id, "status": status, "slot": slot,
                "tokens_emitted": req.n_emitted,
                "pages_freed": pages_freed, "wall_ms": wall_ms,
                "iteration": self.batch_seq,
            }
            if pages_published:
                fields["pages_published"] = pages_published
            if detail:
                fields["detail"] = detail[:500]
            try:
                self.telemetry.emit("lm_evict", **fields)
            except Exception:
                # the client's terminal event below is owed regardless
                log.exception("lm_evict emit failed (telemetry only)")
        req.events.put({
            "kind": "done", "status": status, "n": req.n_emitted,
            "id": req.id, **({"detail": detail} if detail else {}),
        })
