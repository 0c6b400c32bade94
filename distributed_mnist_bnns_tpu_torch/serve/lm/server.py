"""Streaming HTTP front end for the continuous-batching LM engine.

Counterpart of the JAX package's ``serve/lm/server.py``: ``cli serve --lm
--artifact PATH`` serves an ``export_packed`` LM artifact on a ``device``
(default ``"cuda"``), streaming tokens as they are decoded over chunked
transfer encoding, one JSON object per line (ndjson).

  POST /generate      {"prompt": [ints] | "text": str,
                       "max_new_tokens": int, "deadline_ms": float,
                       "temperature": float, "seed": int}
                      -> 200 + ndjson stream:
                           {"i": 0, "token": 17}
                           {"i": 1, "token": 3}
                           ...
                           {"done": true, "status": "ok", "n": N, "id": ...}
                      503 shed (queue_full/draining/engine_failed) |
                      504 deadline before the first token |
                      400 bad input | 413 prompt too long
                      A deadline that lands MID-stream cannot change the
                      already-sent 200: the stream ends with
                      {"done": true, "status": "deadline"} instead.
                      ``"text"`` is tokenized as its UTF-8 bytes mod vocab.
  GET  /healthz       status (ok|draining|failed: the engine's recompile
                      fence tripped, its fence_error), the AOT boot's
                      status (aot), active_streams,
                      queue_depth, page occupancy,
                      the engine's counters, the KV pool's bytes (+
                      the prefix cache's entries and shared-page
                      occupancy, the speculative window and acceptance
                      rate, per-program costs and the cards' memory with
                      --costs)
  GET  /metrics       the obs registry (with the process's kernel
                      launches, ``kernel_launches_total{kernel}``): JSON,
                      or Prometheus text under ``Accept: text/plain``
  POST /admin/profile {"duration_ms": N} — an on-demand torch.profiler
                      capture, off the serving path; 409 while another
                      capture runs

``prefix_cache`` shares prompt prefixes copy-on-write over the paged
pool; ``spec_decode = K`` arms self-speculative decoding with a K-token
verify window (``serve/lm/engine.py``).

With ``telemetry_dir`` the server writes the JAX package's events
(``run_manifest``, ``lm_warmup``, ``lm_admit``, ``lm_prefix_hit``,
``lm_evict``, ``lm_decode``, ``lm_spec_round``, ``lm_decode_error``,
``shed``, ``drain``,
``program_cost``, ``profile_capture``, ``metrics``, ``run_end``);
``trace`` adds each stream's span tree, rooted under the client's
``x-jg-trace`` header when it sends one (echoed in the reply).

Lifecycle: SIGTERM stops admission (shed ``draining``), lets the active
streams run out within the drain budget, emits ``drain`` and exits 0.

With ``aot`` the boot consults the AOT store (``aot/``): a hit installs
the decoder's banked kernel libraries (K1, K7, K8; the verify program's
too with ``spec_decode``) with no ``nvcc``, and the engine's budget-0
fence counts from the boot mark, taken before the artifact loads, not
from the end of the warm-up; a miss builds and re-banks them.
"""

from __future__ import annotations

import json
import logging
import math
import queue
import threading
import time
from dataclasses import dataclass
from http.server import ThreadingHTTPServer
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ...infer import load_frozen, resolve_device
from ...obs import Telemetry
from ...obs.costs import arm_ledger
from ...obs.profile import default_capture_dir
from ...obs.trace import TRACE_HEADER, format_header, parse_header
from ...resilience.preempt import StopRequest
from ..httpbase import JsonHandler
from .engine import LMEngine, LMRequest

log = logging.getLogger(__name__)

# Slack granted past a deadline before the waiter gives up on the first
# token (the role of server.py's _WAIT_SLACK_S).
_WAIT_SLACK_S = 0.05

_SHED_HTTP = {"queue_full": 503, "draining": 503, "engine_failed": 503}


@dataclass
class LMServeConfig:
    """Engine geometry and robustness budgets (CLI flags mirror these)."""

    artifact: str
    device: str = "cuda"
    host: str = "127.0.0.1"
    port: int = 8000                    # 0 = ephemeral (tests)
    slots: int = 4                      # decode batch width
    page_size: int = 16                 # tokens per KV page
    num_pages: Optional[int] = None     # None: slots*max_pages + null
    prefill_chunk: int = 16             # prompt positions per prefill call
    max_len: Optional[int] = None       # None: the artifact's window
    queue_depth: int = 16               # admission bound
    default_deadline_ms: float = 30000.0
    default_max_new_tokens: int = 64
    max_prompt_tokens: Optional[int] = None   # None: max_len - 1
    drain_timeout_s: float = 30.0
    telemetry_dir: Optional[str] = None  # JSONL events here (obs/)
    trace: Optional[bool] = None        # per-stream span trees in the
                                        # event log; None: the JG_TRACE
                                        # env var; needs telemetry_dir
    costs: Optional[bool] = None        # the per-program cost ledger
                                        # (obs/costs); None: JG_COSTS
    events_max_bytes: Optional[int] = None  # size-rotate events.jsonl
    chaos: Optional[str] = None         # serving fault injection
                                        # (resilience/chaos; None:
                                        # JG_CHAOS)
    seed: int = 0                       # the chaos rules' draws
    prefix_cache: bool = False          # COW prompt-prefix sharing
    spec_decode: int = 0                # speculative window K (0: off)
    aot: bool = False                   # consult the AOT store (aot/):
                                        # hit = the banked libraries, no
                                        # nvcc, fence budget 0 from the
                                        # boot; miss = build + re-bank
    aot_dir: Optional[str] = None       # store root (JG_TORCH_AOT_STORE
                                        # / <repo>/.torch_aot default)


class LMServer:
    """Owns the engine, the streaming HTTP front end and the drain."""

    def __init__(self, config: LMServeConfig):
        self.config = config
        self.telemetry = Telemetry(
            config.telemetry_dir, heartbeat=False, trace=config.trace,
            events_max_bytes=config.events_max_bytes,
        )
        self._ledger = arm_ledger(config.costs)
        from ...resilience.chaos import ChaosController

        self.chaos = ChaosController.from_config(
            config.chaos, seed=config.seed, telemetry=self.telemetry)
        self.stop_request = StopRequest()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._started_at = time.time()
        self.engine: Optional[LMEngine] = None
        self.artifact_info: Dict[str, Any] = {}
        self.aot_status: Optional[str] = None
        self.aot_meta: Dict[str, Any] = {}     # the boot's AOT load
        self.vocab = 0

    def start(self) -> Tuple[str, int]:
        """Load the artifact, build the paged decoder, warm and start the
        engine and the HTTP front end. Returns the bound (host, port)."""
        from ...analysis.guards import fenced_build_count
        from ...infer_transformer import make_paged_lm_decoder

        cfg = self.config
        device = resolve_device(cfg.device)
        # the boot mark BEFORE the artifact loads: after a hit, the fence
        # holds zero builds from here
        boot_mark = fenced_build_count()
        deferred = None
        if cfg.aot:
            from ...aot import load_paged_lm_decoder_aot
            from ...aot.store import AotStore, DeferredEvents

            # the store's events wait for the manifest below
            deferred = DeferredEvents()
            decoder, info, aot_meta = load_paged_lm_decoder_aot(
                cfg.artifact, slots=cfg.slots, page_size=cfg.page_size,
                num_pages=cfg.num_pages, prefill_chunk=cfg.prefill_chunk,
                max_len=cfg.max_len, spec_k=cfg.spec_decode, device=device,
                store=AotStore(cfg.aot_dir, telemetry=deferred,
                               registry=self.telemetry.registry),
            )
            self.artifact_info = info
            self.aot_meta = aot_meta
            self.aot_status = aot_meta["status"]
        else:
            frozen = load_frozen(cfg.artifact)
            if frozen.get("kind") != "lm":
                raise ValueError(
                    f"{cfg.artifact} is not a packed LM artifact")
            self.artifact_info = dict(frozen.get("info", {}))
            decoder = make_paged_lm_decoder(
                frozen, slots=cfg.slots, page_size=cfg.page_size,
                num_pages=cfg.num_pages, prefill_chunk=cfg.prefill_chunk,
                max_len=cfg.max_len, spec_k=cfg.spec_decode, device=device,
            )
            self.aot_status = "disabled"
        self.vocab = decoder.vocab
        # the manifest opens the log, before the engine's warm-up events
        self.telemetry.manifest(
            config={
                "artifact": cfg.artifact,
                "engine": "lm",
                "slots": cfg.slots,
                "page_size": cfg.page_size,
                "num_pages": decoder.num_pages,
                "prefill_chunk": cfg.prefill_chunk,
                "max_len": decoder.max_len,
                "queue_depth": cfg.queue_depth,
                "default_deadline_ms": cfg.default_deadline_ms,
                "kernels": bool(decoder.kernels),
                "chaos": self.chaos.spec or None,
                "prefix_cache": cfg.prefix_cache,
                "spec_decode": cfg.spec_decode,
                "aot": self.aot_status,
            },
            device=device, artifact_info=self.artifact_info,
        )
        if deferred is not None:
            deferred.flush(self.telemetry)
        self.engine = LMEngine(
            decoder, queue_depth=cfg.queue_depth, telemetry=self.telemetry,
            device=device, chaos=self.chaos if self.chaos.active else None,
            prefix_cache=cfg.prefix_cache,
            boot_fence_baseline=(boot_mark if self.aot_status == "hit"
                                 else None),
        ).start()
        server = self

        class Handler(_LMHandler):
            srv = server

        self._httpd = ThreadingHTTPServer((cfg.host, cfg.port), Handler)
        self._httpd.daemon_threads = True
        host, port = self._httpd.server_address[:2]
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, name="lm-serve-http",
            daemon=True,
        )
        self._http_thread.start()
        log.info(
            "lm-serving %s on %s:%d, device %s: %d slots, %d pages x %d "
            "tokens, max_len %d", cfg.artifact, host, port, device,
            cfg.slots, decoder.num_pages, cfg.page_size, decoder.max_len,
        )
        return host, port

    def health(self) -> Dict[str, Any]:
        eng = self.engine
        if eng.fence_error is not None:
            status = "failed"          # load balancers must route away
        elif eng.draining:
            status = "draining"
        else:
            status = "ok"
        health = {
            "status": status,
            "engine": "lm",
            "device": self.config.device,
            "slots": eng.decoder.slots,
            "active_streams": eng.active_streams,
            "queue_depth": eng.queue_len,
            "pages_in_use": eng.allocator.used_count(),
            "page_occupancy": round(eng.allocator.occupancy(), 4),
            "max_len": eng.max_len,
            "kernels": bool(eng.decoder.kernels),
            "iterations_total": eng.batch_seq,
            "recompiles_post_warmup": eng.recompiles_post_warmup,
            "fence_error": eng.fence_error,
            "aot": self.aot_status,
            "fence_budget": 0 if eng._sanitizer is not None else None,
            "metrics": eng.metrics(),
            "kv_pool": eng.kv_pool_stats(),
            "uptime_s": round(time.time() - self._started_at, 3),
        }
        cache_stats = eng.prefix_cache_stats()
        if cache_stats is not None:
            # how much of pages_in_use is the cache's (reclaimable under
            # pressure), not live streams'
            health["prefix_cache_entries"] = cache_stats["entries"]
            health["shared_page_occupancy"] = cache_stats["page_occupancy"]
        if eng.spec_k:
            rate = eng.spec_acceptance_rate
            health["spec_k"] = eng.spec_k
            health["spec_acceptance_rate"] = (
                round(rate, 4) if rate is not None else None)
        if self._ledger.enabled:
            from ...obs import device_memory_stats

            health["programs"] = self._ledger.snapshot()
            mem = device_memory_stats(live_fallback=True)
            if mem is not None:
                health["device_memory"] = mem
        return health

    def profile_dir_default(self) -> Optional[str]:
        """The /admin/profile artifact dir without a ``dir`` in the body:
        ``<telemetry_dir>/profile``."""
        return default_capture_dir(self.config.telemetry_dir)

    def request_stop(self, reason: str = "stop requested") -> None:
        self.stop_request.request(reason)

    def drain_and_stop(self) -> Dict[str, Any]:
        if self.engine is None:
            raise RuntimeError("drain_and_stop before start")
        t0 = time.monotonic()
        queued = self.engine.queue_len
        streaming = self.engine.active_streams
        self.engine.begin_drain()
        flushed = self.engine.drain(timeout=self.config.drain_timeout_s)
        self.engine.stop()
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        stats = {
            "reason": self.stop_request.reason or "stop requested",
            "queued_at_drain": queued,
            "streaming_at_drain": streaming,
            "flushed": flushed,
            "requests_total": int(self.engine.requests_ctr.total()),
            "shed_total": int(self.engine.shed_ctr.total()),
            "iterations_total": self.engine.batch_seq,
            "recompiles_post_warmup": self.engine.recompiles_post_warmup,
            # after stop() the prefix cache is clear: every page is back
            "pages_in_use": self.engine.allocator.used_count(),
            "prefix_cache_entries": (
                self.engine.prefix_cache.entries
                if self.engine.prefix_cache is not None else None
            ),
            "wall_s": round(time.monotonic() - t0, 3),
        }
        if self.engine.spec_k:
            rate = self.engine.spec_acceptance_rate
            stats["spec_acceptance_rate"] = (
                round(rate, 4) if rate is not None else None)
        self.telemetry.emit("drain", engine="lm", **stats)
        self.telemetry.close()
        log.info("lm server drained and stopped: %s", stats)
        return stats

    def run(self) -> int:
        """CLI entry: serve until SIGTERM/SIGINT, drain, exit 0. The
        handlers install before ``start()``, so a SIGTERM during the
        warm-up also drains."""
        with self.stop_request.install():
            self.start()
            while not self.stop_request.requested:
                time.sleep(0.05)
        self.drain_and_stop()
        return 0


class _LMHandler(JsonHandler):
    """Streaming per-connection handler; ``srv`` bound by subclassing."""

    srv: LMServer
    logger = log

    def _max_body_bytes(self) -> int:
        return 1 << 22                # 4 MiB: prompts are token lists

    # -- chunked ndjson streaming --------------------------------------------

    def _start_stream(
        self, headers: Optional[Dict[str, str]] = None
    ) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()

    def _write_line(self, obj: Dict[str, Any]) -> None:
        data = json.dumps(obj).encode() + b"\n"
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _end_stream(self) -> None:
        self.wfile.write(b"0\r\n\r\n")
        self.wfile.flush()

    # -- routes --------------------------------------------------------------

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/healthz":
            self._reply(200, self.srv.health())
        elif self.path == "/metrics":
            from ...ops._kernels import export_launches

            # the process's kernel launches, read from outside (a fleet)
            export_launches(self.srv.telemetry.registry)
            self._reply_metrics(self.srv.telemetry.registry)
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        if self.path == "/generate":
            self._generate()
        elif self.path == "/admin/profile":
            # this handler thread sleeps through the capture while the
            # scheduler keeps decoding
            self._admin_profile(
                self.srv.telemetry, self.srv.profile_dir_default()
            )
        else:
            self._reply(404, {"error": f"no route {self.path}"})

    def _parse_prompt(self, body: Dict[str, Any]) -> Optional[np.ndarray]:
        if "text" in body and "prompt" not in body:
            if not isinstance(body["text"], str) or not body["text"]:
                self._reply(400, {"error": "text must be a non-empty "
                                           "string"})
                return None
            raw = body["text"].encode("utf-8")
            return np.asarray([b % self.srv.vocab for b in raw], np.int32)
        try:
            prompt = np.asarray(body["prompt"], np.int32)
        except (KeyError, TypeError, ValueError, OverflowError) as e:
            self._reply(400, {"error": f"bad prompt payload: {e}"})
            return None
        if prompt.ndim != 1 or prompt.shape[0] < 1:
            self._reply(400, {
                "error": f"prompt must be a non-empty 1-D token list, "
                         f"got shape {list(prompt.shape)}",
            })
            return None
        if ((prompt < 0) | (prompt >= self.srv.vocab)).any():
            self._reply(400, {
                "error": f"prompt tokens outside [0, {self.srv.vocab})",
            })
            return None
        return prompt

    def _generate(self) -> None:
        body = self._read_json()
        if body is None:
            return
        engine = self.srv.engine
        prompt = self._parse_prompt(body)
        if prompt is None:
            return
        cfg = self.srv.config
        max_prompt = (
            cfg.max_prompt_tokens
            if cfg.max_prompt_tokens is not None else engine.max_len - 1
        )
        if prompt.shape[0] > max_prompt:
            self._reply(413, {
                "error": f"prompt of {prompt.shape[0]} tokens exceeds "
                         f"the {max_prompt}-token limit",
            })
            return
        try:
            max_new = int(body.get(
                "max_new_tokens", cfg.default_max_new_tokens
            ))
            temperature = float(body.get("temperature", 0.0))
            seed = int(body.get("seed", 0))
            deadline_ms = float(body.get(
                "deadline_ms", cfg.default_deadline_ms
            ))
        except (TypeError, ValueError) as e:
            self._reply(400, {"error": f"bad generation knob: {e}"})
            return
        if max_new < 1:
            self._reply(400, {
                "error": f"max_new_tokens must be >= 1, got {max_new}",
            })
            return
        if not (temperature >= 0):   # also catches NaN
            self._reply(400, {
                "error": f"temperature must be >= 0, got {temperature}",
            })
            return
        if seed < 0:
            self._reply(400, {"error": f"seed must be >= 0, got {seed}"})
            return
        if not (math.isfinite(deadline_ms) and deadline_ms > 0):
            self._reply(400, {
                "error": f"deadline_ms must be a positive finite "
                         f"number, got {body.get('deadline_ms')!r}",
            })
            return
        deadline = time.monotonic() + deadline_ms / 1e3
        # x-jg-trace: the client mints, this server adopts
        ctx = parse_header(self.headers.get(TRACE_HEADER))
        req = engine.submit(prompt, max_new, deadline,
                            temperature=temperature, seed=seed, ctx=ctx)
        if isinstance(req, str):       # shed reason
            self._reply(_SHED_HTTP[req], {"error": "shed", "reason": req},
                        headers={"Retry-After": "0.100"})
            return
        self._stream_reply(req, deadline)

    def _trace_headers(self, req: LMRequest) -> Optional[Dict[str, str]]:
        ctx = req.span.context
        return {TRACE_HEADER: format_header(ctx)} if ctx else None

    def _stream_reply(self, req: LMRequest, deadline: float) -> None:
        """Wait for the first event (bounded by the deadline: a request
        still queued then gets a 504 and never takes pages), then stream
        until ``done``."""
        try:
            ev = req.events.get(
                timeout=max(deadline - time.monotonic() + _WAIT_SLACK_S, 0.0)
            )
        except queue.Empty:
            req.cancelled = True       # the scheduler drops it on sight
            self._reply(504, {"error": "deadline exceeded", "id": req.id},
                        headers=self._trace_headers(req))
            return
        if ev["kind"] == "done" and not req.tokens:
            code = {"deadline": 504, "error": 502}.get(ev["status"], 502)
            self._reply(code, {
                "error": ev.get("detail") or ev["status"], "id": req.id,
            }, headers=self._trace_headers(req))
            return
        try:
            self._start_stream(self._trace_headers(req))
            while True:
                if ev["kind"] == "done":
                    self._write_line({
                        "done": True, "status": ev["status"],
                        "n": ev["n"], "id": ev["id"],
                    })
                    break
                self._write_line({"i": ev["i"], "token": ev["token"]})
                try:
                    # The engine evicts and sends done(deadline) at
                    # expiry; the +1 s covers an eviction in flight. Only
                    # a wedged engine runs this timer out.
                    ev = req.events.get(
                        timeout=max(deadline - time.monotonic(), 0.0) + 1.0
                    )
                except queue.Empty:
                    req.cancelled = True
                    self._write_line({
                        "done": True, "status": "error", "n": req.n_emitted,
                        "id": req.id, "detail": "stream stalled",
                    })
                    break
            self._end_stream()
        except (BrokenPipeError, ConnectionError, OSError):
            # client went away mid-stream: the pages free next iteration
            req.cancelled = True
            self.close_connection = True
