"""Per-request distributed tracing — span trees over the event log.

The port's copy of the JAX package's ``obs/trace.py`` (pure Python: on
the same spans it gives the same outputs).

The obs/ layer so far answers "how fast is a step" (histograms,
percentiles); this module answers "where did THIS request's 600 ms go".
A :class:`Span` is one named monotonic-clock interval with structured
attributes; spans form trees via ``trace_id``/``span_id``/``parent``
links, and completed spans are written into the run's existing
``events.jsonl`` as ``span`` events — one schema, one file, one reader
(`cli trace` renders Chrome-trace JSON for Perfetto and a p99
tail-attribution report from the same log the request events live in).

Design constraints (all load-bearing for the serving hot path):

  * **near-zero cost when disabled** — every entry point starts with one
    attribute check and returns a shared no-op span; nothing allocates;
  * **thread-safe** — spans start on HTTP handler threads, end on the
    engine worker / LM scheduler thread, and race waiter-vs-engine at
    deadlines; ``Span.end`` is claim-once (first caller wins), mirroring
    ``Request.finish``;
  * **bounded buffer, explicit drops** — completed spans stage in a
    bounded in-memory buffer and flush to the sink in batches; a full
    buffer DROPS (counted in ``trace_spans_dropped_total`` and
    ``Tracer.dropped``) rather than growing without bound;
  * **no span I/O under held locks**: the buffer
    lock guards only list ops; all sink writes happen after release.

Trace context propagates across processes via the ``x-jg-trace`` HTTP
header — ``<trace_id>-<span_id>``, both lowercase hex. **Clients mint
it, servers adopt it**: a server that receives the header roots its
request span under the client's span (same trace id), so a future
multi-replica router inherits cross-process causality for free; a
malformed or absent header falls back to a fresh trace, never an error.

Request ids: :func:`next_request_id` is the run-scoped id source both
serving engines share — an ``<8-hex run nonce>-<monotonic counter>``
string, so ids cannot collide across replicas nor repeat across
restarts (a bare process-local ``itertools.count()`` did both, which
breaks joining ``request``/``lm_evict`` events to their span trees in a
multi-replica log merge).

The span event schema and the `cli trace` usage are the JAX
package's (OBSERVABILITY.md "Tracing").
"""

from __future__ import annotations

import itertools
import re
import secrets
import threading
import time
from typing import Any, Dict, Iterable, List, NamedTuple, Optional

from .events import read_events

TRACE_HEADER = "x-jg-trace"
SPANS_DROPPED_TOTAL = "trace_spans_dropped_total"

_HEADER_RE = re.compile(r"^([0-9a-f]{8,32})-([0-9a-f]{8,32})$")


def _tid() -> int:
    """OS thread id where available (small, matches what a profiler
    shows); the Python ident is the fallback."""
    try:
        return threading.get_native_id()
    except AttributeError:  # pragma: no cover
        return threading.get_ident()


class TraceContext(NamedTuple):
    """The propagatable half of a span: what a client puts on the wire
    and a server adopts."""

    trace_id: str
    span_id: str


def mint_context() -> TraceContext:
    """A fresh (trace, span) pair — what a client mints before its
    first outbound request."""
    return TraceContext(secrets.token_hex(8), secrets.token_hex(8))


def format_header(ctx: TraceContext) -> str:
    return f"{ctx.trace_id}-{ctx.span_id}"


def parse_header(value: Optional[str]) -> Optional[TraceContext]:
    """Parse an ``x-jg-trace`` header; None for absent/malformed input —
    a bad trace header must degrade to an untraced-by-the-client
    request, never a 400 (tracing is observability, not validation)."""
    if not value:
        return None
    m = _HEADER_RE.match(value.strip().lower())
    if not m:
        return None
    return TraceContext(m.group(1), m.group(2))


# -- run-scoped request ids --------------------------------------------------


class RequestIdSource:
    """Run-nonce-prefixed monotonic request ids (``"3fa9c1d2-17"``).

    ``itertools.count.__next__`` is atomic under the GIL, so one source
    serves every handler thread without a lock."""

    def __init__(self, nonce: Optional[str] = None):
        self.nonce = nonce or secrets.token_hex(4)
        self._counter = itertools.count()

    def next(self) -> str:
        return f"{self.nonce}-{next(self._counter)}"


_default_ids = RequestIdSource()


def next_request_id() -> str:
    """The process-wide id source both serving engines draw from."""
    return _default_ids.next()


# -- spans -------------------------------------------------------------------


class _NullSpan:
    """Shared no-op span: the disabled-tracing fast path. Supports the
    full Span surface so call sites need no ``if enabled`` guards."""

    __slots__ = ()
    trace_id = ""
    span_id = ""

    @property
    def context(self) -> Optional[TraceContext]:
        return None

    def end(self, status: str = "ok", **attrs: Any) -> bool:
        return False

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NULL_SPAN = _NullSpan()


class Span:
    """One live interval. Created by :meth:`Tracer.start`; ``end`` is
    claim-once (the waiter-vs-engine deadline race calls it from both
    sides — exactly one record is written). Usable as a context manager:
    ``with tracer.start(...):`` additionally makes the span the
    thread-local *current* span, so nested spans (and chaos fault
    points) parent to it automatically."""

    __slots__ = (
        "tracer", "name", "span_kind", "trace_id", "span_id",
        "parent_id", "t0", "tid", "attrs", "_lock", "_ended", "_entered",
    )

    def __init__(
        self, tracer: "Tracer", name: str, span_kind: str,
        trace_id: str, parent_id: Optional[str],
        attrs: Dict[str, Any],
    ):
        self.tracer = tracer
        self.name = name
        self.span_kind = span_kind
        self.trace_id = trace_id
        self.span_id = secrets.token_hex(8)
        self.parent_id = parent_id
        self.t0 = time.monotonic()
        self.tid = _tid()
        self.attrs = attrs
        self._lock = threading.Lock()
        self._ended = False
        self._entered = False

    @property
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def end(self, status: str = "ok", **attrs: Any) -> bool:
        """Close the span; the first caller wins and returns True. The
        record is built and enqueued AFTER the claim lock is released —
        no I/O, no allocation of consequence inside the critical
        section."""
        with self._lock:
            if self._ended:
                return False
            self._ended = True
        t1 = time.monotonic()
        if attrs:
            self.attrs = {**self.attrs, **attrs}
        self.tracer._enqueue(_record(
            self.trace_id, self.span_id, self.parent_id, self.name,
            self.span_kind, self.t0, t1, status, self.tid, self.attrs,
        ))
        return True

    def __enter__(self) -> "Span":
        self._entered = True
        self.tracer._push(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.tracer._pop(self)
        self.end("error" if exc is not None else "ok")


def _record(
    trace_id: str, span_id: str, parent_id: Optional[str], name: str,
    span_kind: str, t0: float, t1: float, status: str, tid: int,
    attrs: Dict[str, Any],
) -> Dict[str, Any]:
    rec: Dict[str, Any] = {
        "trace": trace_id,
        "span": span_id,
        "parent": parent_id,
        "name": name,
        "span_kind": span_kind,
        "t0_ms": round(t0 * 1e3, 3),
        "dur_ms": round(max(t1 - t0, 0.0) * 1e3, 3),
        "status": status,
        "tid": tid,
    }
    if attrs:
        rec["attrs"] = attrs
    return rec


class Tracer:
    """Span factory + bounded staging buffer in front of the event sink.

    ``sink`` is anything with ``emit(kind, **fields)`` (the run's
    :class:`~.events.EventLog` / :class:`~.telemetry.Telemetry`); None
    keeps completed spans in the buffer for :meth:`drain` (tests,
    in-process consumers). Completed spans flush to the sink in batches
    of ``flush_every``; the buffer never exceeds ``capacity`` — beyond
    it spans are dropped and counted, because a tracer that can stall
    or OOM the serving engine is worse than a gap in the trace."""

    def __init__(
        self,
        sink: Any = None,
        *,
        enabled: bool = True,
        capacity: int = 8192,
        flush_every: int = 32,
        registry: Any = None,
    ):
        self.enabled = bool(enabled)
        self.run_trace = secrets.token_hex(8)
        self._sink = sink
        self._capacity = int(capacity)
        self._flush_every = max(int(flush_every), 1)
        self._lock = threading.Lock()
        self._spans: List[Dict[str, Any]] = []   # guarded-by: _lock
        self._dropped = 0                        # guarded-by: _lock
        self._local = threading.local()
        self._drop_ctr = None
        if registry is not None:
            self._drop_ctr = registry.counter(
                SPANS_DROPPED_TOTAL,
                "completed spans dropped on a full trace buffer",
            )

    # -- current-span stack (thread-local) -----------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()

    def current(self) -> Optional[Span]:
        """This thread's innermost ``with``-entered span (chaos fault
        points parent their spans to it)."""
        if not self.enabled:
            return None
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    # -- span creation -------------------------------------------------------

    def _resolve(
        self, ctx: Optional[TraceContext], parent: Any, fresh: bool,
    ) -> tuple:
        """(trace_id, parent_id) from the caller's intent: an adopted
        wire context wins, then an explicit parent span/context, then
        the thread-local current span, then a fresh trace (request
        roots) or the tracer's run trace (engine/trainer internals)."""
        if ctx is not None:
            return ctx.trace_id, ctx.span_id
        if parent is not None and not isinstance(parent, _NullSpan):
            # Span and TraceContext both expose trace_id/span_id.
            return parent.trace_id, parent.span_id
        cur = self.current()
        if cur is not None:
            return cur.trace_id, cur.span_id
        if fresh:
            return secrets.token_hex(8), None
        return self.run_trace, None

    def start(
        self, name: str, *, kind: str = "span",
        ctx: Optional[TraceContext] = None, parent: Any = None,
        fresh: bool = False, **attrs: Any,
    ):
        """A live span handle (end it explicitly, or use as a context
        manager). ``ctx``: adopt a wire context (server side of the
        header contract). ``parent``: an explicit Span/TraceContext —
        the cross-thread parenting path. ``fresh=True`` mints a new
        trace when no context applies (one trace per request)."""
        if not self.enabled:
            return NULL_SPAN
        trace_id, parent_id = self._resolve(ctx, parent, fresh)
        return Span(self, name, kind, trace_id, parent_id, attrs)

    def record(
        self, name: str, *, kind: str = "span",
        t0: float, t1: Optional[float] = None,
        ctx: Optional[TraceContext] = None, parent: Any = None,
        fresh: bool = False, status: str = "ok", **attrs: Any,
    ) -> Optional[str]:
        """Record a completed span retrospectively from explicit
        monotonic timestamps — the hot-path-friendly form: the engine
        measures with plain floats and banks the spans after delivery.
        Returns the span id (for chaining parents), or None when
        disabled."""
        if not self.enabled:
            return None
        trace_id, parent_id = self._resolve(ctx, parent, fresh)
        span_id = secrets.token_hex(8)
        self._enqueue(_record(
            trace_id, span_id, parent_id, name, kind, t0,
            t0 if t1 is None else t1, status, _tid(), attrs,
        ))
        return span_id

    # -- buffer / sink -------------------------------------------------------

    @property
    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def _enqueue(self, rec: Dict[str, Any]) -> None:
        if not self.enabled:
            return
        dropped = False
        with self._lock:
            if len(self._spans) >= self._capacity:
                self._dropped += 1
                dropped = True
            else:
                self._spans.append(rec)
            pending = len(self._spans)
        if dropped:
            if self._drop_ctr is not None:
                self._drop_ctr.inc()
            return
        if self._sink is not None and pending >= self._flush_every:
            self.flush()

    def flush(self) -> None:
        """Drain the staged spans to the sink — called on batch
        boundaries and by ``Telemetry.close()`` so a sealed log carries
        every completed span. All emits happen outside the buffer
        lock."""
        if self._sink is None:
            return
        while True:
            with self._lock:
                if not self._spans:
                    return
                batch = self._spans
                self._spans = []
            for rec in batch:
                self._sink.emit("span", **rec)

    def drain(self) -> List[Dict[str, Any]]:
        """Pop and return the staged records (sink-less tracers /
        tests)."""
        with self._lock:
            batch = self._spans
            self._spans = []
        return batch


#: Shared disabled tracer — what call sites fall back to when no
#: telemetry is attached, so instrumentation never needs None checks.
NULL_TRACER = Tracer(sink=None, enabled=False)


# -- reading a traced run ----------------------------------------------------


def load_spans(path: str) -> List[Dict[str, Any]]:
    """The ``span`` events of an events.jsonl, in file order."""
    return [e for e in read_events(path) if e.get("kind") == "span"]


def children_index(
    spans: Iterable[Dict[str, Any]]
) -> Dict[tuple, List[Dict[str, Any]]]:
    """(trace, parent span id) -> child spans. Parent links only bind
    within one trace — a span id is only unique per trace."""
    idx: Dict[tuple, List[Dict[str, Any]]] = {}
    for s in spans:
        if s.get("parent"):
            idx.setdefault((s.get("trace"), s["parent"]), []).append(s)
    return idx


def request_roots(
    spans: Iterable[Dict[str, Any]], kind: str = "request"
) -> List[Dict[str, Any]]:
    return [s for s in spans if s.get("span_kind") == kind]


def unresolved_parents(spans: List[Dict[str, Any]]) -> List[str]:
    """Span ids whose parent does not exist in the same trace — broken
    tree links. Request roots are exempt: their parent may legitimately
    live in the CLIENT's process (the adopted ``x-jg-trace`` span)."""
    by_trace: Dict[Any, set] = {}
    for s in spans:
        by_trace.setdefault(s.get("trace"), set()).add(s.get("span"))
    broken = []
    for s in spans:
        if not s.get("parent") or s.get("span_kind") == "request":
            continue
        if s["parent"] not in by_trace.get(s.get("trace"), set()):
            broken.append(s.get("span"))
    return broken


def percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile over an ASCENDING-sorted list;
    None on empty input. The one exact-percentile helper shared by the
    run-log summary, the tail-attribution report and the serving
    saturation harness — the p99 the perf gate bands and the p99 the
    trace report shows must come from the same arithmetic."""
    if not sorted_vals:
        return None
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q / 100.0 * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def _self_times(
    span: Dict[str, Any],
    kids_idx: Dict[tuple, List[Dict[str, Any]]],
    out: Dict[str, float],
    _depth: int = 0,
) -> None:
    """Critical-path accounting for a sequentially-composed tree: each
    span contributes its SELF time (duration minus children, clipped at
    zero) under its kind; the root's own self time is the unattributed
    remainder (handler hop, response write)."""
    if _depth > 64:          # defensive: a cyclic parent link must not recurse forever
        return
    dur = float(span.get("dur_ms") or 0.0)
    kid_sum = 0.0
    for kid in kids_idx.get((span.get("trace"), span.get("span")), ()):
        kid_sum += min(float(kid.get("dur_ms") or 0.0), dur)
        _self_times(kid, kids_idx, out, _depth + 1)
    kind = span.get("span_kind") or "span"
    out[kind] = out.get(kind, 0.0) + max(dur - kid_sum, 0.0)


def tail_attribution(
    spans: List[Dict[str, Any]], *, pct: float = 99.0,
) -> Dict[str, Any]:
    """Break down where the slow tail's time went.

    Takes the request-root spans at or above the ``pct`` latency
    percentile and attributes each one's duration to span kinds by
    critical-path self time (``queue`` vs ``prefill`` vs ``decode`` vs
    ``infer`` vs ``stall`` ...; the root's own self time shows up under
    ``request`` = unattributed). The aggregate answers "is the p99
    queue-dominated or a slow dispatch" in one number per kind."""
    roots = request_roots(spans)
    durs = sorted(float(r.get("dur_ms") or 0.0) for r in roots)
    cutoff = percentile(durs, pct)
    report: Dict[str, Any] = {
        "n_requests": len(roots),
        "pct": pct,
        "cutoff_ms": cutoff,
        "p50_ms": percentile(durs, 50.0),
        "p99_ms": percentile(durs, 99.0),
        "tail": [],
        "aggregate_ms": {},
        "dominant": None,
    }
    if not roots:
        return report
    kids_idx = children_index(spans)
    tail = sorted(
        (r for r in roots if float(r.get("dur_ms") or 0.0) >= cutoff),
        key=lambda r: float(r.get("dur_ms") or 0.0), reverse=True,
    )
    agg: Dict[str, float] = {}
    for root in tail:
        breakdown: Dict[str, float] = {}
        _self_times(root, kids_idx, breakdown)
        for k, v in breakdown.items():
            agg[k] = agg.get(k, 0.0) + v
        dominant = max(breakdown, key=breakdown.get) if breakdown else None
        report["tail"].append({
            "id": (root.get("attrs") or {}).get("id"),
            "trace": root.get("trace"),
            "status": root.get("status"),
            "dur_ms": root.get("dur_ms"),
            "breakdown_ms": {
                k: round(v, 3) for k, v in sorted(
                    breakdown.items(), key=lambda kv: -kv[1]
                )
            },
            "dominant": dominant,
        })
    report["aggregate_ms"] = {
        k: round(v, 3)
        for k, v in sorted(agg.items(), key=lambda kv: -kv[1])
    }
    if agg:
        report["dominant"] = max(agg, key=agg.get)
    return report


def stitch_spans(
    groups: Dict[str, List[Dict[str, Any]]], *,
    source_attr: str = "process",
) -> Dict[str, Any]:
    """Join span logs from N fleet process dirs into one tree per hop
    chain — the multi-directory half of the ``x-jg-trace`` contract.

    ``groups`` maps a process name (the telemetry dir basename: the
    router dir plus one dir per replica rid) to its loaded spans. The
    router's ``fleet.dispatch`` span carries ``attrs.replica`` — the
    rid it dispatched to — and the replica's ``serve.request`` root
    shares the forwarded trace id, so the join key is
    ``(trace_id, replica)``: each replica-side request root is
    re-parented UNDER its dispatch span (overriding whatever parent
    the wire context gave it — with a traced client the replica root
    natively parents to the CLIENT's span and is a sibling of the
    router's ``fleet.request``, which is correct causality but useless
    for attribution) and demoted from ``span_kind="request"`` to
    ``"replica_request"`` so :func:`tail_attribution` keeps exactly one
    root per request and the breakdown splits router self time
    (``request`` + ``dispatch`` = router queueing/hop) from replica
    time (``queue``/``assemble``/``infer``/``respond`` +
    ``replica_request`` = replica-side unattributed).

    Span clocks are per-process monotonic, so each joined replica
    subtree is time-shifted to start at its dispatch span's ``t0_ms``
    — after stitching all spans share the ROUTER's clock lane (exact
    within a process, aligned-at-dispatch across the hop).

    Retries: a trace with N dispatch attempts to the same replica
    consumes dispatches in ``t0_ms`` order against that replica's
    request roots in ``t0_ms`` order. Every input span is copied (the
    caller's lists are never mutated) and tagged with
    ``attrs[source_attr] = <group name>``.

    Returns ``{"spans", "joined", "replica_roots", "unjoined"}``.
    """
    tagged: Dict[str, List[Dict[str, Any]]] = {}
    for gname, spans in groups.items():
        rows = []
        for s in spans:
            c = dict(s)
            c["attrs"] = {**(s.get("attrs") or {}), source_attr: gname}
            rows.append(c)
        tagged[gname] = rows

    # (trace, replica rid) -> dispatch spans, oldest first
    disp_idx: Dict[tuple, List[Dict[str, Any]]] = {}
    router_groups = set()
    for gname, rows in tagged.items():
        for s in rows:
            if s.get("span_kind") == "dispatch":
                router_groups.add(gname)
                rep = (s.get("attrs") or {}).get("replica")
                disp_idx.setdefault((s.get("trace"), rep), []).append(s)
    for lst in disp_idx.values():
        lst.sort(key=lambda s: float(s.get("t0_ms") or 0.0))

    joined = 0
    replica_roots = 0
    unjoined: List[str] = []
    for gname, rows in tagged.items():
        if gname in router_groups:
            continue
        kids_idx = children_index(rows)
        roots = sorted(
            (s for s in rows if s.get("span_kind") == "request"),
            key=lambda s: float(s.get("t0_ms") or 0.0),
        )
        for root in roots:
            replica_roots += 1
            lst = disp_idx.get((root.get("trace"), gname))
            if not lst:
                # dir name != rid: fall back to the trace id alone when
                # it is unambiguous (exactly one unconsumed dispatch)
                cands = [
                    (key, l) for key, l in disp_idx.items()
                    if key[0] == root.get("trace") and l
                    and key[1] not in tagged
                ]
                lst = cands[0][1] if len(cands) == 1 else None
            if not lst:
                unjoined.append(root.get("span"))
                continue
            dispatch = lst.pop(0)
            offset = (float(dispatch.get("t0_ms") or 0.0)
                      - float(root.get("t0_ms") or 0.0))
            stack, seen = [root], set()
            while stack:
                s = stack.pop()
                if id(s) in seen:
                    continue
                seen.add(id(s))
                s["t0_ms"] = round(
                    float(s.get("t0_ms") or 0.0) + offset, 3
                )
                stack.extend(
                    kids_idx.get((s.get("trace"), s.get("span")), ())
                )
            root["parent"] = dispatch.get("span")
            root["span_kind"] = "replica_request"
            joined += 1

    all_spans = [s for rows in tagged.values() for s in rows]
    all_spans.sort(key=lambda s: float(s.get("t0_ms") or 0.0))
    return {
        "spans": all_spans,
        "joined": joined,
        "replica_roots": replica_roots,
        "unjoined": unjoined,
    }


def span_kind_totals(spans: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Per-kind span counts + total duration — the fallback report for
    logs with no request roots (a traced TRAINING run: step/checkpoint/
    restore/remesh spans)."""
    out: Dict[str, Dict[str, float]] = {}
    for s in spans:
        k = s.get("span_kind") or "span"
        row = out.setdefault(k, {"count": 0, "total_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += float(s.get("dur_ms") or 0.0)
    return {
        k: {"count": int(v["count"]), "total_ms": round(v["total_ms"], 3)}
        for k, v in sorted(out.items(), key=lambda kv: -kv[1]["total_ms"])
    }


def render_attribution(report: Dict[str, Any]) -> str:
    """Human-readable tail-attribution table (the `cli trace`
    default)."""
    lines = [
        f"trace tail attribution: p{report['pct']:g} over "
        f"{report['n_requests']} request(s)",
        f"  latency p50 {_fmt_ms(report['p50_ms'])}   "
        f"p99 {_fmt_ms(report['p99_ms'])}   "
        f"cutoff {_fmt_ms(report['cutoff_ms'])}",
    ]
    total = sum(report["aggregate_ms"].values()) or 1.0
    for kind, ms in report["aggregate_ms"].items():
        label = "(unattributed)" if kind == "request" else kind
        lines.append(
            f"  {label:<16} {ms:>10.3f} ms  {100.0 * ms / total:5.1f}%"
        )
    if report["dominant"]:
        lines.append(f"  dominant kind: {report['dominant']}")
    for row in report["tail"][:10]:
        lines.append(
            f"  tail request {row['id']} ({row['status']}, "
            f"{_fmt_ms(row['dur_ms'])}): dominant {row['dominant']} — "
            + ", ".join(
                f"{k}={v:.1f}ms" for k, v in row["breakdown_ms"].items()
            )
        )
    return "\n".join(lines)


def _fmt_ms(v: Optional[float]) -> str:
    return "-" if v is None else f"{v:.1f}ms"


# -- Chrome trace-event export (Perfetto / chrome://tracing) -----------------


def to_chrome_trace(
    spans: List[Dict[str, Any]], *, pid: int = 0,
    process_name: Optional[str] = None,
) -> Dict[str, Any]:
    """Render span events as Chrome trace-event JSON — the object
    format (``{"traceEvents": [...]}``), complete ("X") events with
    microsecond ``ts``/``dur``, loadable in Perfetto / chrome://tracing
    as-is. Timestamps are the process monotonic clock; spans from one
    process align exactly, cross-process traces align per-lane (each
    pid keeps its own zero)."""
    events: List[Dict[str, Any]] = []
    if process_name:
        events.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": process_name},
        })
    for s in spans:
        args: Dict[str, Any] = {
            "trace": s.get("trace"),
            "span": s.get("span"),
            "parent": s.get("parent"),
            "status": s.get("status"),
        }
        args.update(s.get("attrs") or {})
        events.append({
            "name": s.get("name", "?"),
            "cat": s.get("span_kind", "span"),
            "ph": "X",
            "ts": round(float(s.get("t0_ms") or 0.0) * 1e3, 1),
            "dur": max(round(float(s.get("dur_ms") or 0.0) * 1e3, 1), 0.0),
            "pid": pid,
            "tid": int(s.get("tid") or 0),
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}
