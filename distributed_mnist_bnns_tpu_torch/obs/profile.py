"""On-demand device profiling — ``torch.profiler`` captures at run time
(the JAX package's ``obs/profile.py``).

  * ``POST /admin/profile {"duration_ms": N}`` on both serving front
    ends captures a live window off-path (the handler thread sleeps
    through the capture; serving traffic never blocks on it) and
    returns the artifact directory and byte sizes;
  * ``cli train --profile-steps A:B`` captures a step window mid-run;
  * while a capture is armed, the serving and training dispatch sites
    wrap their device calls in a ``torch.profiler.record_function``
    region named ``STEP_MARKER`` (``jg_step``), with a nested region
    ``jg_trace:<trace id>`` carrying the run's ``x-jg-trace`` id, so the
    device profile and the host span trees (obs/trace) of the same
    window join on id;
  * ``cli profile DIR`` summarizes a capture (top ops by total time,
    the kernels on the card's streams, the package's kernels launched
    inside ``jg_step`` regions) from its Chrome trace, stdlib-only.

A capture records CPU activity and, with a card, CUDA activity (CUPTI:
every kernel on the card, those of CUDA-graph replays and of other
threads included), and is written as ``<host>_<pid>_<ms>.pt.trace.json.gz``
into the artifact directory. One capture at a time per process (a
``torch.profiler`` session is process-wide); a second concurrent
request gets :class:`ProfileBusyError` (HTTP 409). Disabled cost:
instrumented dispatch sites check one attribute (``profiler.active``).
"""

from __future__ import annotations

import bisect
import gzip
import json
import logging
import os
import re
import socket
import threading
import time
from typing import Any, Dict, List, Optional

log = logging.getLogger(__name__)

PROFILE_CAPTURES_TOTAL = "profile_captures_total"

MAX_CAPTURE_MS = 60_000.0

# Idle time at each edge of a capture with a card. The profiler keeps a
# kernel only when its start and end, converted from the card's clock to
# the host's, fall inside the window, and in about one capture in four
# the converted times run ahead of their own launch calls, by up to
# 4.5 ms on an H100 (scripts/torch_profile_edges.py): without the idle
# edge, kernels launched in a window's first milliseconds fall out.
EDGE_S = 0.25
# The first kernels after that idle edge can still go unrecorded (on an
# H100, a window's first 2 launches with CUPTI kept up; 70 launches,
# 5.6 ms, with it torn down): a capture opens with this many tiny
# kernels, each after a short pause, so that the caller's first kernels
# are not the capture's first.
PRIMER_LAUNCHES = 128

# torch.profiler tears CUPTI down when a session ends, and the next
# session brings it back up lazily: in a process that holds CUDA graphs
# (train/capture.py), that session's device trace can start late or
# not at all (torch.profiler itself keeps CUPTI up while torch.compile's graphs are
# in use). The package's processes keep it up between sessions; set
# TEARDOWN_CUPTI=1 to tear it down.
os.environ.setdefault("TEARDOWN_CUPTI", "0")

# The region name every annotated dispatch carries — one grep key for
# the join between host spans and device profiles; the nested
# TRACE_PREFIX region names the trace id.
STEP_MARKER = "jg_step"
TRACE_PREFIX = "jg_trace:"


class ProfileBusyError(RuntimeError):
    """A capture is already in progress (one per process)."""


class ProfileManager:
    """Owns the process's single capture slot.

    ``capture`` is the blocking duration-window form (the /admin
    endpoint); ``start``/``stop`` are the step-window form (the trainer
    drives them at step boundaries). Both emit a ``profile_capture``
    event (artifact dir, file count, bytes) and increment
    ``profile_captures_total`` when telemetry is attached at the
    call."""

    def __init__(self, registry: Any = None):
        self._lock = threading.Lock()
        self.active = False           # the hot paths' one-attribute check
        self._dir: Optional[str] = None
        self._prof: Any = None
        self._t0 = 0.0
        if registry is None:
            from .registry import default_registry

            registry = default_registry()
        self._captures_ctr = registry.counter(
            PROFILE_CAPTURES_TOTAL,
            "on-demand device-profile captures completed",
        )

    # -- step-window form (trainer) ------------------------------------------

    def start(self, artifact_dir: str) -> None:
        """Begin a capture into ``artifact_dir``. Raises
        :class:`ProfileBusyError` when one is already running."""
        if not self._lock.acquire(blocking=False):
            raise ProfileBusyError(
                "a profile capture is already in progress "
                "(one per process)"
            )
        try:
            import torch

            os.makedirs(artifact_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            cuda = torch.cuda.is_available()
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            # The device trace starts late: a capture opened and recorded
            # at once can miss the window's first kernels. The schedule's
            # warm-up turns tracing on first (its events are dropped);
            # the step into the active phase opens the window.
            prof = torch.profiler.profile(
                activities=acts, schedule=torch.profiler.schedule(
                    wait=0, warmup=1, active=1, repeat=1))
            prof.start()
            if cuda:
                torch.cuda.synchronize()
                torch.ones(1, device="cuda").add_(1.0)
                torch.cuda.synchronize()
            prof.step()
            if cuda:
                time.sleep(EDGE_S)
                primer = torch.zeros(1, device="cuda")
                for _ in range(PRIMER_LAUNCHES):
                    primer.add_(1.0)
                    time.sleep(5e-5)
                torch.cuda.synchronize()
        except BaseException:
            self._lock.release()
            raise
        self._prof = prof
        self._dir = artifact_dir
        self._t0 = time.monotonic()
        self.active = True

    def stop(self, telemetry: Any = None) -> Dict[str, Any]:
        """End the capture (after the card finished the window's work, so
        its kernels are in it) and write its Chrome trace; returns the
        artifact summary (dir, files, total bytes, wall duration) and
        emits ``profile_capture``."""
        if not self.active:
            raise RuntimeError("no profile capture in progress")
        import torch

        artifact_dir = self._dir or "."
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
                time.sleep(EDGE_S)
            self._prof.stop()
            path = os.path.join(
                artifact_dir,
                f"{socket.gethostname()}_{os.getpid()}_"
                f"{int(time.time() * 1e3)}.pt.trace.json.gz")
            self._prof.export_chrome_trace(path)
        finally:
            # The capture slot frees even if the dump failed — a wedged
            # profiler must not permanently 409 the endpoint.
            self.active = False
            self._dir = None
            self._prof = None
            self._lock.release()
        dur_ms = round((time.monotonic() - self._t0) * 1e3, 1)
        files = capture_files(artifact_dir)
        summary = {
            "dir": artifact_dir,
            "trace_json": path,
            "duration_ms": dur_ms,
            "files": len(files),
            "total_bytes": sum(f["bytes"] for f in files),
        }
        self._captures_ctr.inc()
        if telemetry is not None:
            try:
                telemetry.emit(
                    "profile_capture", **summary,
                    file_list=[f["path"] for f in files][:20],
                )
            except Exception:
                log.debug("profile_capture emit failed", exc_info=True)
        log.info("profile capture: %s", summary)
        return summary

    # -- duration-window form (/admin/profile) -------------------------------

    def capture(
        self, duration_ms: float, *, artifact_dir: str,
        telemetry: Any = None,
    ) -> Dict[str, Any]:
        """Blocking duration-window capture. The caller's thread (an
        HTTP handler — off the serving path by construction) sleeps
        through the window. Duration is clamped to ``MAX_CAPTURE_MS``."""
        duration_ms = float(duration_ms)
        if not duration_ms > 0:
            raise ValueError(
                f"duration_ms must be > 0, got {duration_ms}"
            )
        duration_ms = min(duration_ms, MAX_CAPTURE_MS)
        self.start(artifact_dir)
        try:
            time.sleep(duration_ms / 1e3)
        finally:
            summary = self.stop(telemetry=telemetry)
        return summary


_profiler: Optional[ProfileManager] = None
_profiler_lock = threading.Lock()


def get_profiler() -> ProfileManager:
    """Process-wide manager — the capture slot is a process property."""
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            _profiler = ProfileManager()
        return _profiler


def step_annotation(program: str, trace_id: str):
    """The ``jg_step`` region (and its nested ``jg_trace:<id>``) a
    dispatch runs in while a capture is live."""
    import contextlib

    import torch

    stack = contextlib.ExitStack()
    stack.enter_context(torch.profiler.record_function(STEP_MARKER))
    stack.enter_context(torch.profiler.record_function(
        f"{TRACE_PREFIX}{trace_id}/{program}"))
    return stack


def default_capture_dir(telemetry_dir: Optional[str]) -> Optional[str]:
    """``<telemetry_dir>/profile`` — THE default artifact location,
    shared by both serving front ends' /admin/profile and the trainer's
    ``--profile-steps`` window (None without a telemetry dir; callers
    then require an explicit dir)."""
    if not telemetry_dir:
        return None
    return os.path.join(telemetry_dir, "profile")


# -- reading a capture (cli profile) -----------------------------------------


def capture_files(artifact_dir: str) -> List[Dict[str, Any]]:
    """Every file under a capture directory with its size — the
    /admin/profile response body."""
    out: List[Dict[str, Any]] = []
    for root, _, files in os.walk(artifact_dir):
        for name in files:
            p = os.path.join(root, name)
            try:
                out.append({
                    "path": os.path.relpath(p, artifact_dir),
                    "bytes": os.path.getsize(p),
                })
            except OSError:
                continue
    out.sort(key=lambda f: f["path"])
    return out


def find_trace_json(artifact_dir: str) -> Optional[str]:
    """Newest ``*.trace.json.gz`` under a capture dir."""
    best: Optional[str] = None
    best_mtime = -1.0
    for root, _, files in os.walk(artifact_dir):
        for name in files:
            if not name.endswith(".trace.json.gz"):
                continue
            p = os.path.join(root, name)
            try:
                m = os.path.getmtime(p)
            except OSError:
                continue
            if m > best_mtime:
                best, best_mtime = p, m
    return best


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """The Chrome-trace events of one ``*.trace.json.gz``."""
    with gzip.open(path, "rt", encoding="utf-8", errors="replace") as f:
        data = json.load(f)
    return list(data.get("traceEvents", []))


# Demangled kernel names of the package's CUDA kernels -> their launch
# counter names (ops._kernels.LAUNCHES); K1–K3 are one template whose
# first argument is the epilogue.
_KERNEL_NAMES = (
    (re.compile(r"xnor_gemm_kernel<\(?(?:\w+\))?0\b"), "xnor"),
    (re.compile(r"xnor_gemm_kernel<\(?(?:\w+\))?1\b"), "xnor_sign"),
    (re.compile(r"xnor_gemm_kernel<\(?(?:\w+\))?2\b"), "xnor_affine"),
    (re.compile(r"\bxnor_unpack_kernel\b"), "xnor_unpack"),
    (re.compile(r"\bpaged_attn_kernel\b"), "paged_attn"),
    (re.compile(r"\bflash_fwd_kernel\b"), "flash_fwd"),
    (re.compile(r"\bflash_bwd_dq_kernel\b"), "flash_bwd_dq"),
    (re.compile(r"\bflash_bwd_dkv_kernel\b"), "flash_bwd_dkv"),
)


def port_kernel(name: str) -> Optional[str]:
    """The launch-counter name of a kernel event's name, or None for a
    kernel that is not one of the package's."""
    for pattern, kernel in _KERNEL_NAMES:
        if pattern.search(name):
            return kernel
    return None


def summarize_capture(
    artifact_dir: str, *, top: int = 15,
) -> Dict[str, Any]:
    """Fold a capture into a terminal-readable summary: top ops by total
    duration (python frames left out), the compile split, the
    ``jg_step`` regions and their trace ids (the JAX package's fields);
    and from the card's streams (``cat: "kernel"`` events) the top
    kernels, the package's kernels by launch-counter name, and those of
    them launched inside a ``jg_step`` region (a kernel's launch — its
    ``cuda_runtime`` event of the same correlation id, a graph launch
    for a replayed graph's kernels — lies in a region of its thread).
    Approximate by design: nested events over-count parents."""
    trace_path = find_trace_json(artifact_dir)
    if trace_path is None:
        raise FileNotFoundError(
            f"no *.trace.json.gz under {artifact_dir} — is this a "
            "torch.profiler capture directory?"
        )
    events = load_trace_events(trace_path)
    ops: Dict[str, List[float]] = {}
    kernels: Dict[str, List[float]] = {}
    compile_us = 0.0
    total_us = 0.0
    trace_ids = set()
    steps = 0
    regions: Dict[Any, List[tuple]] = {}
    launches: Dict[Any, tuple] = {}
    device_kernels: List[Dict[str, Any]] = []
    for e in events:
        if e.get("ph") != "X":
            continue
        name = str(e.get("name", "?"))
        cat = str(e.get("cat", ""))
        dur = float(e.get("dur", 0.0) or 0.0)
        args = e.get("args") or {}
        if cat == "user_annotation":
            if name == STEP_MARKER:
                steps += 1
                ts = float(e.get("ts", 0.0))
                regions.setdefault(e.get("tid"), []).append((ts, ts + dur))
            elif name.startswith(TRACE_PREFIX):
                trace_ids.add(name[len(TRACE_PREFIX):].split("/", 1)[0])
        if cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"),
                                             float(e.get("ts", 0.0)))
        if cat == "kernel":
            device_kernels.append(e)
            row = kernels.setdefault(name, [0.0, 0.0])
            row[0] += 1
            row[1] += dur
        total_us += dur
        if "compile" in name.lower():
            compile_us += dur
        if name.startswith("$") or cat == "python_function":
            continue
        row = ops.setdefault(name, [0.0, 0.0])
        row[0] += 1
        row[1] += dur
    for spans in regions.values():
        spans.sort()
    port: Dict[str, int] = {}
    in_steps: Dict[str, int] = {}
    for e in device_kernels:
        kernel = port_kernel(str(e.get("name", "")))
        if kernel is None:
            continue
        port[kernel] = port.get(kernel, 0) + 1
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is None:
            continue
        spans = regions.get(launch[0], [])
        i = bisect.bisect_right(spans, (launch[1], float("inf"))) - 1
        if i >= 0 and spans[i][0] <= launch[1] <= spans[i][1]:
            in_steps[kernel] = in_steps.get(kernel, 0) + 1

    def _top(table: Dict[str, List[float]]) -> List[Dict[str, Any]]:
        rows = sorted(table.items(), key=lambda kv: -kv[1][1])[:top]
        return [{"name": name, "count": int(c),
                 "total_ms": round(us / 1e3, 3)} for name, (c, us) in rows]

    return {
        "dir": artifact_dir,
        "trace_json": trace_path,
        "events": len(events),
        "annotated_steps": steps,
        "trace_ids": sorted(trace_ids),
        "compile_ms": round(compile_us / 1e3, 3),
        "other_ms": round(max(total_us - compile_us, 0.0) / 1e3, 3),
        "top_ops": _top(ops),
        "top_kernels": _top(kernels),
        "kernel_launches": dict(sorted(port.items())),
        "kernel_launches_in_steps": dict(sorted(in_steps.items())),
    }


def render_capture_summary(summary: Dict[str, Any]) -> str:
    """Human-readable capture summary (the ``cli profile`` default)."""
    lines = [
        f"profile capture: {summary['dir']}",
        f"  events {summary['events']}   annotated steps "
        f"{summary['annotated_steps']}   compile {summary['compile_ms']}"
        f" ms   other {summary['other_ms']} ms",
    ]
    if summary["trace_ids"]:
        lines.append(
            "  joinable trace ids: " + ", ".join(summary["trace_ids"][:8])
        )
    if summary.get("kernel_launches"):
        lines.append("  package kernels (in jg_step regions): " + ", ".join(
            f"{k} x{n} ({summary['kernel_launches_in_steps'].get(k, 0)})"
            for k, n in summary["kernel_launches"].items()))
    lines.append("  top ops by total time (approximate, nested):")
    for op in summary["top_ops"]:
        lines.append(
            f"    {op['total_ms']:>12.3f} ms  x{op['count']:<6} "
            f"{op['name'][:80]}"
        )
    if summary.get("top_kernels"):
        lines.append("  top kernels on the card:")
        for op in summary["top_kernels"]:
            lines.append(
                f"    {op['total_ms']:>12.3f} ms  x{op['count']:<6} "
                f"{op['name'][:80]}"
            )
    return "\n".join(lines)
