"""Structured JSONL run events — one append-only file per run.

The port's counterpart of the JAX package's ``obs/events.py``: the same
schema (``SCHEMA_VERSION``, the ``EVENT_KINDS`` registry, the envelope),
size rotation and readers. Every record is one JSON object per line
with three envelope fields: ``v`` (schema version), ``kind`` (event
type) and ``ts`` (UTC ISO-8601). The first record of a run is the
``run_manifest`` — config, device and process topology, the torch and
CUDA versions and the git rev — so a log file is self-describing.

Writes happen only on the primary process (rank 0 of the
``torch.distributed`` group, or the only process) unless
``primary_only=False``. Heartbeats bypass that rule (every process
writes its own file) so a stalled rank is diagnosable after the fact.

Rotation: ``EventLog(max_bytes=...)`` renames the live file to
``events.jsonl.<seq>`` (ascending = older) at a flush boundary once it
passed ``max_bytes``, reopens it fresh with a marked copy of the
manifest, and keeps the newest ``keep_segments`` segments.
``read_events`` (and so ``cli trace``, ``cli telemetry``,
``summarize``) reads across the surviving segments in order.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

from ..utils.logging_utils import is_primary_host

SCHEMA_VERSION = 1
MANIFEST_KIND = "run_manifest"

#: Envelope fields every record carries; a payload key with one of these
#: names would silently clobber the envelope.
ENVELOPE_FIELDS = ("v", "kind", "ts")

#: The canonical kind registry (schema v1): every event kind any writer
#: emits, with a one-line description — the JAX package's, kind for kind
#: (a log of either package reads with the other's tools). Kept as a
#: plain dict literal.
EVENT_KINDS: Dict[str, str] = {
    "run_manifest": "config, devices, mesh, versions, git rev (once)",
    "step": "step index, latency, examples/sec, mfu, loss/acc",
    "epoch": "per-epoch aggregates + device memory stats",
    "eval": "test metrics",
    "checkpoint": "epoch, path, best flag",
    "bench": "a bench.py section result (same envelope as training)",
    "infer": "packed-serving run summary",
    "error": "exception type/message before a crash propagates",
    "heartbeat": "liveness records (written per process, obs/heartbeat)",
    "fault_injected": "a resilience/chaos fault fired (kind, point, step)",
    "graceful_stop": "preemption honored at a step boundary",
    "resume": "a run restored checkpoint state before training",
    "rollback": "restore skipped corrupt generation(s) (resilience)",
    "restart": "the retry loop rebuilt the trainer (cause, attempt)",
    "membership_change": "elastic data-parallel membership change",
    "remesh": "elastic mesh rebuild + state re-placement at a new world",
    "comm_compress": "the run's 1-bit gradient-exchange plan (PERF.md)",
    "metrics": "final registry snapshot at run close, before run_end",
    "run_end": "run outcome summary — the log's closing record",
    "sanitizer_trip": "a runtime fence (recompile/transfer/nan) fired",
    "request": "one served prediction request's final status (serve/)",
    "shed": "admission rejected a request (serve/)",
    "breaker_open": "the serving circuit breaker tripped open",
    "breaker_close": "it closed again after half-open probes",
    "drain": "SIGTERM graceful drain completed (serve/)",
    "reload": "hot artifact swap on the running server (serve/)",
    "export": "cli export wrote a packed artifact (path, size info)",
    "lm_admit": "a generation request took a batch slot (serve/lm/)",
    "lm_evict": "a generation request left its slot or died queued",
    "lm_decode": "periodic decode-iteration snapshot (serve/lm/)",
    "lm_decode_error": "a decode dispatch failed and was retried",
    "lm_prefix_hit": "admission forked a cached prompt prefix COW",
    "lm_spec_round": "periodic speculative-decode round snapshot",
    "lm_warmup": "the LM engine finished warmup (programs, kernels)",
    "aot_hit": "a boot installed a stored AOT executable (no compile)",
    "aot_miss": "AOT store had no entry; online compile + re-bank",
    "aot_bank": "an executable was serialized into the AOT store",
    "aot_fallback": "corrupt/incompatible AOT entry quarantined",
    "span": "one completed tracing span (obs/trace, `cli trace`)",
    "program_cost": "one program's cost row (obs/costs)",
    "profile_capture": "an on-demand torch.profiler capture completed",
    "fleet_dispatch": "router routed (or failed) one fleet request",
    "replica_health": "a replica health probe changed state (fleet)",
    "replica_spawn": "the supervisor started a replica process",
    "replica_exit": "a replica process exited (cause, respawn plan)",
    "autoscale": "the supervisor changed the replica target (fleet)",
    "rollout": "one rolling-deploy phase (ship/start/trip/...)",
    "decision": "one control-plane decision with its inputs (fleet)",
    "slo_alert": "a multiwindow burn-rate alert transitioned (obs/slo)",
    "multihost_init": "cluster bootstrap outcome (attempts, classified)",
    "host_membership": "host-level elastic membership change (multihost)",
}


def utc_now(epoch_s: Optional[float] = None) -> str:
    return time.strftime(
        "%Y-%m-%dT%H:%M:%SZ",
        time.gmtime(epoch_s) if epoch_s is not None else time.gmtime(),
    )


def git_rev(cwd: Optional[str] = None) -> Optional[str]:
    """Current git commit of the source tree, or None outside a repo."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5,
        )
        rev = out.stdout.strip()
        return rev if out.returncode == 0 and rev else None
    except (OSError, subprocess.SubprocessError):
        return None


def _jsonable(value: Any) -> Any:
    """Best-effort conversion to JSON-serializable builtins (numpy and
    torch scalars -> float/int, arrays -> their shape and dtype)."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if hasattr(value, "item") and getattr(value, "ndim", None) == 0:
        return value.item()
    if hasattr(value, "shape"):
        return {"shape": list(value.shape), "dtype": str(value.dtype)}
    return str(value)


def _rank_world() -> tuple:
    """(rank, world) of the ``torch.distributed`` process group, or
    (0, 1) outside one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def device_topology(device: Any = None) -> Dict[str, Any]:
    """Device and process topology as manifest data: the run's device
    (``device``; None: the current card, else the CPU), the card's name
    and count, and this process's rank and world."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    rank, world = _rank_world()
    if device.type == "cuda":
        count = torch.cuda.device_count()
        kind = torch.cuda.get_device_name(device)
    else:
        count, kind = 1, "cpu"
    return {
        "backend": device.type,
        "device_count": count,
        "local_device_count": count,
        "device_kind": kind,
        "process_index": rank,
        "process_count": world,
    }


class EventLog:
    """Append-only JSONL sink for one run.

    ``emit`` is a no-op on non-primary processes (see module
    docstring), so call sites need no rank guards. Flush policy: the high-rate kinds —
    ``step`` (one per hot-loop dispatch), ``request`` (one per served
    request, written from the serving engine's single worker thread)
    ``lm_admit``/``lm_evict`` (one per generation stream, written
    from the LM scheduler thread between decode iterations) and
    ``span`` (several per traced request, batch-flushed by the tracer's
    own staging buffer first) — are
    buffered (a flushed syscall per record would serialize file I/O
    against the hot path) and flushed every ``flush_every`` records;
    every other kind — manifest, epoch, error, shed, breaker
    transitions, drain, run_end — flushes immediately, so a crashed run
    loses at most the last few high-rate lines, never the milestone
    records."""

    BUFFERED_KINDS = ("step", "request", "lm_admit", "lm_evict",
                      "lm_prefix_hit", "span")

    def __init__(
        self, path: str, *, primary_only: bool = True,
        flush_every: int = 32,
        max_bytes: Optional[int] = None,
        keep_segments: int = 4,
    ):
        self.path = path
        self._active = is_primary_host() or not primary_only
        self._fh = None
        self._manifest_written = False
        self._flush_every = max(int(flush_every), 1)
        self._unflushed = 0
        # Size-based rotation (module docstring): None = unbounded
        # (training runs are epoch-bounded; only long-lived servers
        # need the cap). Rotation happens on flush boundaries only, so
        # a segment can overshoot by at most one flush batch.
        self._max_bytes = int(max_bytes) if max_bytes else None
        self._keep_segments = max(int(keep_segments), 1)
        self.rotations = 0             # guarded-by: _lock
        self.on_rotate = None          # owner's counter hook
        self._size = 0                 # guarded-by: _lock
        self._manifest_record = None   # re-emitted into fresh segments
        # One log is written from many threads (trainer + heartbeat +
        # async checkpointer; the serving engine worker + HTTP handler
        # threads + drain): TextIOWrapper writes are not thread-safe,
        # and an interleaved partial line silently vanishes in
        # read_events.
        self._lock = threading.Lock()
        if self._active:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")
            try:
                self._size = os.path.getsize(path)
            except OSError:
                self._size = 0

    @property
    def active(self) -> bool:
        return self._active

    def emit(self, kind: str, **fields: Any) -> None:
        # jg: disable=JG007 -- lock-free fast path; the None check is re-done under the lock below, this read only skips the json encode and never acts on the handle
        if not self._active or self._fh is None:
            return
        record = {"v": SCHEMA_VERSION, "kind": kind, "ts": utc_now()}
        record.update({k: _jsonable(v) for k, v in fields.items()})
        if kind == MANIFEST_KIND and not record.get("rotated_copy"):
            # Keep the run-scoping record survivable: rotation prunes
            # old segments, so each fresh segment re-opens with a
            # marked copy of the manifest (see _rotate_locked).
            self._manifest_record = record
        line = json.dumps(record) + "\n"
        rotated = False
        with self._lock:
            if self._fh is None:  # closed concurrently
                return
            # jg: disable=JG009 -- serializing THIS write is the lock's whole job (interleaved TextIOWrapper writes mangle lines); the json encode already ran outside it
            self._fh.write(line)
            self._size += len(line)
            self._unflushed += 1
            if (kind not in self.BUFFERED_KINDS
                    or self._unflushed >= self._flush_every):
                # jg: disable=JG009 -- same critical section: the flush must pair with the write it flushes; the buffered-kind policy bounds how often hot paths hit it
                self._fh.flush()
                self._unflushed = 0
                if (self._max_bytes is not None
                        and self._size >= self._max_bytes):
                    self._rotate_locked()
                    rotated = True
        if rotated and self.on_rotate is not None:
            try:
                self.on_rotate()
            # jg: disable=JG005 -- a rotation-counter hook must never fail the write that triggered it
            except Exception:
                pass

    def _rotate_locked(self) -> None:  # holds-lock: _lock
        """Rename the live file to the next ``.<seq>`` segment, prune
        segments beyond ``keep_segments``, reopen fresh. Caller holds
        ``_lock`` (the handle swap must be atomic w.r.t. writers)."""
        self._fh.close()
        self._fh = None
        seqs = [s for _, s in _segments(self.path)]
        nxt = (max(seqs) + 1) if seqs else 1
        try:
            os.replace(self.path, f"{self.path}.{nxt}")
        except OSError:
            pass  # rename raced an external mover: just reopen
        for seg_path, seq in _segments(self.path):
            if seq <= nxt - self._keep_segments:
                try:
                    os.remove(seg_path)
                except OSError:
                    pass
        # jg: disable=JG009 -- the reopen must happen under the same lock every writer serializes on (a writer observing _fh=None mid-rotation would drop its record); rotation is a rare flush-boundary event, not the per-record path
        self._fh = open(self.path, "a")
        self._size = 0
        if self._manifest_record is not None:
            # The run-scoping record must survive segment pruning:
            # every fresh segment opens with a MARKED manifest copy
            # (readers use it as data only — ``rotated_copy`` keeps it
            # from re-scoping the run in summarize()).
            line = json.dumps(
                {**self._manifest_record, "rotated_copy": True}
            ) + "\n"
            # jg: disable=JG009 -- same critical section as the reopen above: the copy must land before any writer's next record, and rotation only runs at rare flush boundaries
            self._fh.write(line)
            self._size = len(line)
        self.rotations += 1

    def manifest(
        self, config: Optional[Dict[str, Any]] = None,
        mesh: Any = None, *, device: Any = None, **extra: Any,
    ) -> None:
        """Emit the run manifest (once; later calls are ignored so
        resume/retry paths can call unconditionally). ``device`` is the
        run's (``device_topology``)."""
        if self._manifest_written:
            return
        self._manifest_written = True
        mesh_info = None
        if mesh is not None:
            try:
                mesh_info = {
                    "axis_names": list(mesh.axis_names),
                    "shape": {
                        str(k): int(v) for k, v in dict(mesh.shape).items()
                    },
                }
            except (AttributeError, TypeError, ValueError):
                mesh_info = str(mesh)
        import torch

        self.emit(
            MANIFEST_KIND,
            config=config or {},
            topology=device_topology(device),
            mesh=mesh_info,
            torch_version=torch.__version__,
            cuda_version=torch.version.cuda,
            python_version=sys.version.split()[0],
            hostname=socket.gethostname(),
            pid=os.getpid(),
            git_rev=git_rev(),
            argv=list(sys.argv),
            **extra,
        )

    def error(self, exc: BaseException, **fields: Any) -> None:
        self.emit(
            "error",
            error_type=type(exc).__name__,
            error=str(exc)[:2000],
            **fields,
        )

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _segments(path: str) -> List[tuple]:
    """Rotated segments of ``path`` as ascending ``(seg_path, seq)``
    pairs (``events.jsonl.1`` is older than ``.2``; the live file is
    not included)."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path) + "."
    out = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for name in names:
        if not name.startswith(base):
            continue
        suffix = name[len(base):]
        if suffix.isdigit():
            out.append((os.path.join(d, name), int(suffix)))
    out.sort(key=lambda t: t[1])
    return out


def read_events(path: str) -> Iterator[Dict[str, Any]]:
    """Stream a JSONL event log — rotated segments first (oldest to
    newest), then the live file, so readers (`cli trace`/`telemetry`,
    ``summarize``) see one continuous stream across rotation.
    Malformed lines (a crash mid-write) are skipped rather than
    poisoning the whole read."""
    paths = [p for p, _ in _segments(path)] + [path]
    for p in paths:
        try:
            f = open(p)
        except OSError:
            if p == path and not _segments(path):
                raise  # no log at all: keep the historical contract
            continue
        with f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue


def load_events(path: str) -> List[Dict[str, Any]]:
    return list(read_events(path))
