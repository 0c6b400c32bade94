"""Per-process heartbeats — each process periodically writes a small
liveness record so a stalled rank is diagnosable after the fact (the
JAX package's ``obs/heartbeat.py``; the process index is the
``torch.distributed`` rank).

Two artifacts per process, under the run's telemetry directory:

  heartbeat_p<idx>.json    latest-state file, atomically replaced each
                           beat (a monitor reads ONE file per host and
                           compares ``ts`` against the wall clock)
  heartbeat_p<idx>.jsonl   bounded history (schema-v1 ``heartbeat``
                           events) — the post-mortem trail; rotated in
                           place once it exceeds ``max_lines`` records,
                           keeping the newest half.

Unlike every other event stream, heartbeats are written by EVERY
process, not just the primary — a primary-only heartbeat cannot tell you
which non-primary host stalled. The writer is a daemon thread so a hung
device dispatch on the main thread does not stop the beats; the payload
callback runs host-side only (never touches device state)."""

from __future__ import annotations

import json
import os
import threading
from typing import Callable, Dict, Optional

from .events import SCHEMA_VERSION, utc_now


def _process_index() -> int:
    """This process's rank in the ``torch.distributed`` group (0 outside
    one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Heartbeat:
    """Background heartbeat writer; use as a context manager or call
    ``start()``/``stop()``. ``payload_fn`` supplies extra fields per
    beat (e.g. the trainer's current step counter)."""

    def __init__(
        self,
        directory: str,
        *,
        interval_s: float = 30.0,
        payload_fn: Optional[Callable[[], Dict]] = None,
        max_lines: int = 512,
    ):
        self.directory = directory
        self.interval_s = interval_s
        self.payload_fn = payload_fn
        self.max_lines = max(int(max_lines), 2)
        self.process_index = _process_index()
        base = os.path.join(
            directory, f"heartbeat_p{self.process_index}"
        )
        self.state_path = base + ".json"
        self.history_path = base + ".jsonl"
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._beats = 0

    # -- single beat (also usable synchronously, e.g. from tests) -----------

    def beat(self) -> Dict:
        self._beats += 1
        record = {
            "v": SCHEMA_VERSION,
            "kind": "heartbeat",
            "ts": utc_now(),
            "process_index": self.process_index,
            "pid": os.getpid(),
            "beat": self._beats,
        }
        if self.payload_fn is not None:
            try:
                record.update(self.payload_fn())
            except Exception as e:  # a payload bug must not kill liveness
                record["payload_error"] = repr(e)[:200]
        os.makedirs(self.directory, exist_ok=True)
        tmp = self.state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(record, f)
        os.replace(tmp, self.state_path)
        with open(self.history_path, "a") as f:
            f.write(json.dumps(record) + "\n")
        self._maybe_rotate()
        return record

    def _maybe_rotate(self) -> None:
        """Bound the history file: once past 2x max_lines, keep the
        newest max_lines (atomic rewrite — a reader never sees a
        truncated file)."""
        try:
            with open(self.history_path) as f:
                lines = f.readlines()
        except OSError:
            return
        if len(lines) <= 2 * self.max_lines:
            return
        tmp = self.history_path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(lines[-self.max_lines:])
        os.replace(tmp, self.history_path)

    # -- background thread --------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.beat()
            # jg: disable=JG005 -- an IO hiccup must not kill liveness
            except Exception:
                pass
            self._stop.wait(self.interval_s)

    def start(self) -> "Heartbeat":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-heartbeat", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, final_beat: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if final_beat:
            try:
                self.beat()
            # jg: disable=JG005 -- best-effort last beat during teardown
            except Exception:
                pass

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def read_heartbeats(directory: str) -> Dict[int, Dict]:
    """Latest heartbeat per process index from a telemetry directory —
    the monitor/post-mortem read path."""
    out: Dict[int, Dict] = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        if not (name.startswith("heartbeat_p") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                rec = json.load(f)
            out[int(rec.get("process_index", -1))] = rec
        except (OSError, ValueError, TypeError):
            continue  # truncated/corrupt beat file: skip, don't poison
    return out
