"""Runtime sanitizers: silent performance and correctness rot made into
hard, attributed errors. Opt-in (a run pays nothing by default).

The port's counterpart of the JAX package's ``analysis/guards.py``, with
its names, its environment variables and its event. Three fences,
composed by ``SanitizerConfig`` or ``JG_SANITIZE``:

* **recompile fence**: ``obs/recompile`` counts what the port builds at
  run time. The fence marks a baseline once the step has warmed up and
  raises ``RecompileFenceError`` when the builds after it exceed a
  budget. It counts the CUDA-graph captures (``kind="capture"``: a
  recapture on every chunk is the port's retrace storm) and the kernel
  builds (``kind="kernel_build"``); never a library load, and never the
  tracker's latency-spike guesses.
* **transfer guard**: torch never moves a host array to the card on its
  own (an op on tensors of two devices raises), so the JAX guard's
  ``transfer_guard("disallow")`` has no switch to flip here. Its torch
  analogue checks what reaches the fenced dispatch:
  ``guard_transfers(*inputs, device=)`` raises ``TransferGuardError`` on
  a numpy array, or on a tensor off ``device``, and passes tensors that
  are already placed. Placement itself belongs outside the guard.
* **NaN fence**: every ``nan_check_every`` steps (a dispatch that
  crosses the stride, so scan chunks are checked too) the step's loss and
  metrics are checked for NaN/inf; a trip emits a ``sanitizer_trip``
  event before raising ``NaNFenceError``.

Every trip increments ``sanitizer_trips_total{kind}`` and, with a
telemetry sink, emits ``sanitizer_trip`` before raising, so a fenced
failure reads from the event log alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
from typing import Any, Iterator, Mapping, Optional

import numpy as np
import torch

TRIPS_TOTAL = "sanitizer_trips_total"

_ENV_ENABLE = "JG_SANITIZE"          # e.g. "recompile,transfer,nan"
_ENV_BUDGET = "JG_RECOMPILE_BUDGET"  # int, post-warmup build budget
_ENV_NAN_EVERY = "JG_NAN_EVERY"      # int, NaN-fence stride

#: the recompile tracker's kinds the fence counts (obs/recompile)
FENCED_KINDS = ("capture", "kernel_build")


def fenced_build_count() -> int:
    """The process's fenced builds so far (``FENCED_KINDS``): a boot mark
    that a budget-0 fence pins before the AOT store's libraries load."""
    from ..obs import get_tracker

    tracker = get_tracker()
    return sum(tracker.kind_count(k) for k in FENCED_KINDS)


class SanitizerError(RuntimeError):
    """Base class for sanitizer trips."""


class RecompileFenceError(SanitizerError):
    pass


class NaNFenceError(SanitizerError):
    pass


class TransferGuardError(SanitizerError):
    pass


@dataclasses.dataclass
class SanitizerConfig:
    recompile_fence: bool = False
    recompile_budget: int = 16  # post-warmup builds allowed per run
    warmup_steps: int = 3       # builds before this step are free
    transfer_guard: bool = False
    nan_fence: bool = False
    nan_check_every: int = 50

    @property
    def enabled(self) -> bool:
        return self.recompile_fence or self.transfer_guard or self.nan_fence

    @classmethod
    def from_spec(
        cls,
        spec: Optional[str],
        *,
        recompile_budget: Optional[int] = None,
        nan_check_every: Optional[int] = None,
    ) -> "SanitizerConfig":
        """Parse a comma list like ``"recompile,transfer,nan"`` (empty or
        None: every fence off)."""
        cfg = cls()
        for item in (spec or "").split(","):
            item = item.strip().lower()
            if not item:
                continue
            if item in ("recompile", "recompiles", "recompile_fence"):
                cfg.recompile_fence = True
            elif item in ("transfer", "transfers", "transfer_guard"):
                cfg.transfer_guard = True
            elif item in ("nan", "nans", "nan_fence"):
                cfg.nan_fence = True
            else:
                raise ValueError(
                    f"unknown sanitizer {item!r} "
                    "(have: recompile, transfer, nan)"
                )
        if recompile_budget is not None:
            cfg.recompile_budget = int(recompile_budget)
        if nan_check_every is not None:
            cfg.nan_check_every = max(int(nan_check_every), 1)
        return cfg

    @classmethod
    def from_env(cls, env: Mapping[str, str] = os.environ
                 ) -> "SanitizerConfig":
        """``JG_SANITIZE=recompile`` arms the fence for every Trainer in
        the process without touching call sites."""
        return cls.from_spec(
            env.get(_ENV_ENABLE),
            recompile_budget=(
                int(env[_ENV_BUDGET]) if env.get(_ENV_BUDGET) else None
            ),
            nan_check_every=(
                int(env[_ENV_NAN_EVERY]) if env.get(_ENV_NAN_EVERY) else None
            ),
        )


class Sanitizer:
    """Per-run guard state. One instance goes through a training run (the
    Trainer builds its own from ``TrainConfig.sanitize``, else from
    ``SanitizerConfig.from_env()``) or a server's life (the LM engine
    arms its recompile fence at budget 0)."""

    def __init__(
        self,
        config: Optional[SanitizerConfig] = None,
        *,
        telemetry: Any = None,
        registry: Any = None,
    ):
        self.config = config or SanitizerConfig()
        self.telemetry = telemetry
        if registry is None:
            from ..obs import default_registry

            registry = default_registry()
        self._trips = registry.counter(
            TRIPS_TOTAL, "sanitizer fence trips (kind=recompile|transfer|nan)"
        )
        self._tracker = None
        self._baseline: Optional[int] = None
        self._steps = 0
        if self.config.recompile_fence:
            from ..obs import get_tracker

            self._tracker = get_tracker()

    @property
    def active(self) -> bool:
        return self.config.enabled

    def build_count(self) -> int:
        """The fenced builds so far: CUDA-graph captures and kernel
        builds (``FENCED_KINDS``); 0 without the recompile fence."""
        if self._tracker is None:
            return 0
        return fenced_build_count()

    # -- transfer guard -----------------------------------------------------

    @contextlib.contextmanager
    def guard_transfers(self, *inputs: Any,
                        device: Any = None) -> Iterator[None]:
        """While enabled, raise ``TransferGuardError`` if any of
        ``inputs`` is a numpy array (it would be copied to the card
        inside the dispatch) or a tensor off ``device``; else a no-op.
        Wrap only the dispatch, with its placed inputs: placement and
        host reads of the results belong outside."""
        if self.config.transfer_guard:
            want = None if device is None else torch.device(device)
            for i, x in enumerate(inputs):
                if isinstance(x, np.ndarray):
                    where = "a numpy array"
                elif (torch.is_tensor(x) and want is not None
                      and not _same_device(x.device, want)):
                    where = f"a tensor on {x.device}"
                else:
                    continue
                self._trip("transfer", TransferGuardError(
                    f"Disallowed host-to-device transfer: input {i} of the "
                    f"fenced dispatch is {where}, not a tensor on {want}; "
                    "place it before the dispatch"), input=i)
        yield

    # -- step-driven fences (recompile + NaN) --------------------------------

    def pin_baseline(self, count: int) -> None:
        """Pin the recompile-fence baseline to an explicit
        ``build_count()`` instead of letting ``after_step`` mark it after
        ``warmup_steps``: a server that has warmed up pins it, so that
        every later build counts against the budget."""
        self._baseline = int(count)

    def after_step(
        self,
        step: Optional[int] = None,
        metrics: Any = None,
        *,
        n_steps: int = 1,
    ) -> None:
        """Feed one finished dispatch of ``n_steps`` optimizer steps (a
        captured chunk advances by its size). ``step`` defaults to an
        internal counter; ``metrics`` is the step's metrics (tensors on
        the card are fine: they are read only on the NaN stride)."""
        n_steps = max(int(n_steps), 1)
        self._steps += n_steps
        step = self._steps if step is None else int(step)
        cfg = self.config
        if cfg.recompile_fence and self._tracker is not None:
            if self._baseline is None:
                if step >= cfg.warmup_steps:
                    self._baseline = self.build_count()
            else:
                excess = self.build_count() - self._baseline
                if excess > cfg.recompile_budget:
                    self._trip(
                        "recompile",
                        RecompileFenceError(
                            f"{excess} run-time builds (CUDA-graph "
                            f"captures, kernel builds) after warmup (step "
                            f"{step}) exceed the budget of "
                            f"{cfg.recompile_budget}: a shape or option "
                            "leak is recapturing the hot path (see "
                            "obs/recompile)"
                        ),
                        step=step,
                        excess=excess,
                        budget=cfg.recompile_budget,
                    )
        # "did this dispatch cross a check boundary", not divisibility: a
        # chunk of S steps would otherwise check only on multiples of
        # lcm(S, stride), possibly never
        if (
            cfg.nan_fence
            and metrics is not None
            and step % max(cfg.nan_check_every, 1) < n_steps
        ):
            self.check_finite(metrics, step=step)

    def check_finite(self, tree: Any, *, step: Optional[int] = None) -> None:
        """Raise ``NaNFenceError`` if any float leaf of ``tree`` (tensors,
        arrays, numbers, in dicts, lists and tuples) holds a NaN or inf.
        A tensor on the card is read back: call it on the stride."""
        if not self.config.nan_fence:
            return
        bad = [path or "<value>" for path, leaf in _named_leaves(tree)
               if not _finite(leaf)]
        if bad:
            self._trip(
                "nan",
                NaNFenceError(
                    f"non-finite value(s) at step {step}: "
                    f"{', '.join(bad[:8])}"
                    + (" …" if len(bad) > 8 else "")
                    + " — loss/grads went NaN/inf (check LR, loss scale, "
                    "binarization clamp)"
                ),
                step=step,
                leaves=bad[:8],
            )

    # -- shared trip path ----------------------------------------------------

    def _trip(self, kind: str, error: SanitizerError, **fields: Any) -> None:
        self._trips.inc(kind=kind)
        if self.telemetry is not None:
            try:
                self.telemetry.emit(
                    "sanitizer_trip", fence=kind,
                    error=str(error)[:500], **fields,
                )
            except (AttributeError, OSError, TypeError, ValueError):
                pass  # the trip error itself must still propagate
        raise error


def _same_device(have: torch.device, want: torch.device) -> bool:
    if have.type != want.type:
        return False
    return want.index is None or have.index == want.index


def _finite(leaf: Any) -> bool:
    """False only for a float leaf holding a NaN or inf."""
    if torch.is_tensor(leaf):
        if not leaf.is_floating_point():
            return True
        return bool(torch.isfinite(leaf).all())
    if isinstance(leaf, (float, np.floating)):
        return math.isfinite(leaf)
    if isinstance(leaf, np.ndarray) and np.issubdtype(leaf.dtype,
                                                      np.inexact):
        return bool(np.isfinite(leaf).all())
    return True


def _named_leaves(tree: Any, prefix: str = "") -> Iterator[tuple]:
    """(dotted path, leaf) pairs of plain dict/list metrics."""
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree
