"""Per-program cost ledger — what one program *costs* (the JAX package's
``obs/costs.py``).

obs/flops.py answers "what SHOULD a step cost" analytically; this module
banks what one run of each program did, one row per program name:

  * ``flops``: counted with ``torch.utils.flop_counter.FlopCounterMode``
    over one run of the program (its matmuls and convolutions, the
    backward's included). The hand-written kernels launch through
    ``ctypes`` and are not aten ops: a packed path's K1–K8 products are
    not in the count;
  * ``bytes_accessed``: the bytes every aten op of that run read and
    wrote (its tensor operands and results, views excluded) — the
    parameters and activations the program moves;
  * ``hbm``: the arguments' and outputs' bytes and the peak the run
    added to the allocator (``torch.cuda.max_memory_allocated`` around
    it), or for a captured program the graph's pool;

plus the dispatch times the hot paths feed (``observe``, from CUDA
events on a card: ``telemetry.StepClock``), so **measured MFU per
program** (flops ÷ mean dispatch time ÷ the card's peak) is derivable
live (/healthz) and
post-hoc from an events dir alone (``cli telemetry``'s programs, via the
``program_cost`` events and the closing ``metrics`` snapshot's
``program_dispatch_seconds`` histogram).

The programs: ``train_step`` (the eager train step, its first dispatch),
``train_scan_<n>`` (each ``TrainScan`` graph of n steps, counted while
it is captured), ``classifier_predict`` (the frozen predictor's batch,
its warm-up call), ``lm_prefill`` and ``lm_decode`` (the LM engine's
warm-up calls).

Reconciliation invariant (the JAX package's): the train step's counted
flops and the analytic ``train_step_flops`` agree within a factor of 4
either way on the dense backends.

Cost discipline, as JAX's: **off by default** — every hot-path feed and
every program-site hook starts with one attribute check on ``enabled``;
arming is ``JG_COSTS=1`` or the serving ``--costs`` flag. Measuring runs
the program the caller was going to run anyway (its first dispatch, its
capture, its warm-up), never an extra one.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

log = logging.getLogger(__name__)

ENV_COSTS = "JG_COSTS"

PROGRAM_COMPILES_TOTAL = "program_compiles_total"
PROGRAM_DISPATCH_SECONDS = "program_dispatch_seconds"
PROGRAM_FLOPS = "program_flops"

# Dispatch-latency buckets (seconds): decode iterations sit in the
# 100us-10ms range, train steps up to seconds.
_DISPATCH_BUCKETS = (
    1e-5, 2.5e-5, 5e-5, 1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3,
    1e-2, 2.5e-2, 5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _nbytes(tree: Any) -> int:
    import torch
    from torch.utils._pytree import tree_leaves

    return sum(int(t.numel()) * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _bytes_mode():
    """A dispatch mode summing the bytes of every aten op's tensor
    operands and results (view ops move nothing and are skipped)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _BytesMode(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not getattr(func, "is_view", False):
                self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            return out

    return _BytesMode()


@contextlib.contextmanager
def counting(device: Any = None) -> Iterator[Dict[str, Any]]:
    """Count the flops and bytes of the aten ops run inside the block,
    and on a card the peak memory it added; the row is filled when the
    block exits."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    cuda = device is not None and torch.device(device).type == "cuda"
    row: Dict[str, Any] = {}
    if cuda:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    flops = FlopCounterMode(display=False)
    nbytes = _bytes_mode()
    with flops, nbytes:
        yield row
    row["flops"] = float(flops.get_total_flops())
    row["bytes_accessed"] = float(nbytes.bytes)
    if cuda:
        row["hbm"] = {"peak_bytes": int(
            torch.cuda.max_memory_allocated(device) - base)}


def extract_costs(fn, *args: Any, device: Any = None,
                  **kwargs: Any) -> Tuple[Dict[str, Any], Any]:
    """Run ``fn(*args, **kwargs)`` once under ``counting`` and return
    (the cost row, fn's result). The row also holds the arguments' and
    results' bytes under ``hbm``."""
    with counting(device) as row:
        out = fn(*args, **kwargs)
    hbm = dict(row.get("hbm") or {})
    hbm["argument_bytes"] = _nbytes((args, kwargs))
    hbm["output_bytes"] = _nbytes(out)
    hbm.setdefault("peak_bytes", hbm["argument_bytes"] + hbm["output_bytes"])
    row["hbm"] = hbm
    return row, out


class CostLedger:
    """Process-wide per-program cost + dispatch-time accounting.

    ``measure`` runs a program once under ``extract_costs`` and banks its
    row; ``record`` banks a row measured elsewhere (a captured graph's);
    a later row for the same name overwrites (the ledger describes the
    program as it runs now). ``observe`` feeds measured dispatch seconds
    from the hot paths; ``snapshot`` joins both into per-program
    measured MFU."""

    def __init__(
        self, registry: Any = None, *, enabled: Optional[bool] = None,
    ):
        if enabled is None:
            enabled = os.environ.get(ENV_COSTS, "") not in ("", "0")
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        self._programs: Dict[str, Dict[str, Any]] = {}
        self._times: Dict[str, Dict[str, float]] = {}
        if registry is None:
            from .registry import default_registry

            registry = default_registry()
        self._registry = registry
        self._compiles_ctr = registry.counter(
            PROGRAM_COMPILES_TOTAL,
            "cost-counted programs (program, source labels)",
        )
        # Created on the first ARMED observe: a disabled ledger
        # registers nothing.
        self._dispatch_hist = None

    # -- program-site hooks --------------------------------------------------

    def record(
        self,
        name: str,
        row: Dict[str, Any],
        *,
        telemetry: Any = None,
        source: str = "online",
        **extra: Any,
    ) -> Optional[Dict[str, Any]]:
        """Bank ``row`` (flops, bytes_accessed, hbm) under ``name``; emit
        one ``program_cost`` event when ``telemetry`` is attached. No-op
        (one attribute check) when disabled."""
        if not self.enabled:
            return None
        row = {"program": name, "source": source, **row, **extra}
        with self._lock:
            self._programs[name] = row
        self._compiles_ctr.inc(program=name, source=source)
        if row.get("flops"):
            self._registry.gauge(
                PROGRAM_FLOPS, "counted flops per dispatch"
            ).set(row["flops"], program=name)
        if telemetry is not None:
            try:
                telemetry.emit("program_cost", **row)
            except Exception:  # telemetry is best-effort here
                log.debug("program_cost emit failed", exc_info=True)
        return row

    def measure(self, name: str, fn, *args: Any, device: Any = None,
                telemetry: Any = None, source: str = "online",
                extra: Optional[Dict[str, Any]] = None,
                **kwargs: Any) -> Any:
        """``fn(*args, **kwargs)``; when armed, run under
        ``extract_costs`` and its row banked under ``name``."""
        if not self.enabled:
            return fn(*args, **kwargs)
        row, out = extract_costs(fn, *args, device=device, **kwargs)
        self.record(name, row, telemetry=telemetry, source=source,
                    **(extra or {}))
        return out

    # -- hot-path dispatch-time feed -----------------------------------------

    def observe(self, name: str, seconds: float, n: int = 1) -> None:
        """Feed ``n`` dispatches of ``name`` totalling ``seconds``.
        Call sites guard with ``if ledger.enabled`` so the disabled
        cost is exactly one attribute check."""
        if not self.enabled:
            return
        n = max(int(n), 1)
        with self._lock:
            t = self._times.setdefault(name, {"n": 0.0, "s": 0.0})
            t["n"] += n
            t["s"] += float(seconds)
        hist = self._dispatch_hist
        if hist is None:
            hist = self._dispatch_hist = self._registry.histogram(
                PROGRAM_DISPATCH_SECONDS,
                "measured dispatch latency per cost-counted program",
                buckets=_DISPATCH_BUCKETS,
            )
        # One observation PER DISPATCH, so the series count and sum agree
        # with the tally /healthz reports.
        per = float(seconds) / n
        for _ in range(n):
            hist.observe(per, program=name)

    # -- reads ---------------------------------------------------------------

    def costs(self, name: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._programs.get(name)
            return dict(row) if row else None

    def measured_mfu(self, name: str) -> Optional[float]:
        """flops-per-dispatch ÷ mean dispatch seconds ÷ the card's peak —
        None until both a cost row and a dispatch observation exist."""
        with self._lock:
            row = self._programs.get(name)
            t = self._times.get(name)
        if not row or not row.get("flops") or not t or not t["n"]:
            return None
        from .flops import mfu
        from .telemetry import peak_for_default_device

        peak, _ = peak_for_default_device()
        return mfu(row["flops"], t["s"] / t["n"], peak)

    def snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-program view for /healthz: costs + dispatch count/mean +
        measured MFU."""
        with self._lock:
            programs = {k: dict(v) for k, v in self._programs.items()}
            times = {k: dict(v) for k, v in self._times.items()}
        from .flops import mfu
        from .telemetry import peak_for_default_device

        peak, precision = peak_for_default_device()
        for name, row in programs.items():
            t = times.get(name)
            if t and t["n"]:
                mean_s = t["s"] / t["n"]
                row["dispatches"] = int(t["n"])
                row["mean_dispatch_ms"] = round(mean_s * 1e3, 4)
                m = mfu(row.get("flops"), mean_s, peak)
                if m is not None:
                    row["mfu"] = m
                    row["peak_precision"] = precision
        return programs


_ledger: Optional[CostLedger] = None
_ledger_lock = threading.Lock()


def get_ledger() -> CostLedger:
    """The process-wide ledger every program site and hot path feeds."""
    global _ledger
    with _ledger_lock:
        if _ledger is None:
            _ledger = CostLedger()
        return _ledger


def arm_ledger(flag: Optional[bool]) -> CostLedger:
    """The process ledger with an explicit-flag override — the arming
    precedence both serving front ends share: an explicit
    ``--costs``/``--no-costs`` wins; None keeps the JG_COSTS env default
    the ledger was constructed with."""
    ledger = get_ledger()
    if flag is not None:
        ledger.enabled = bool(flag)
    return ledger
