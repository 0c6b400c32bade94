"""Activation recomputation for the train step (``TrainConfig.remat``).

``checkpoint(fn, *args)`` is ``torch.utils.checkpoint.checkpoint(fn,
*args, use_reentrant=False)``, the counterpart of the JAX step's
``jax.checkpoint``: the forward keeps no activations and the backward
runs it again. JAX's recompute is a pure function of the step's keys and
state; PyTorch's re-runs module code, and two things of that code must
not happen twice:

- **Random draws.** The checkpoint saves and restores only the default
  generators, and reading a CUDA generator's state while a CUDA graph is
  captured raises. The port's train-time draws (dropout masks, the
  stochastic signs' noise) come from the model's own generator
  (``models.layers.SeededTrainRNG``), so a recompute would draw new ones
  and give other gradients, silently. Every train-time draw goes through
  ``rand``: inside a checkpoint the forward records what it drew and the
  recompute takes the same tensors back in order, drawing nothing, so
  the generator ends where the plain step leaves it. The recorded noise
  lives until the backward, as the saved masks of a plain step do.
- **Running statistics.** The recompute runs BatchNorm's forward again.
  ``recomputing()`` is True then, and ``models.layers.BatchNorm`` moves
  its running statistics only on the first forward, once a step (a
  microbatch under ``grad_accum``), as the plain step does.
- **Collectives.** A BatchNorm over a data-parallel group all-reduces
  its batch sums in the forward; the recompute takes the forward's sums
  back (``once``) instead of issuing the collective again, so a step
  with ``remat`` runs the same collectives as one without.

So the step with ``remat`` is bitwise the step without it: same masks,
same recomputed activations, same statistics and generator state.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Optional

import torch
import torch.utils.checkpoint

_local = threading.local()   # the tape of the checkpoint being run, if any


class _Tape:
    """The draws of one checkpointed forward. ``record()`` and
    ``replay()`` are reusable context managers: a backward through a
    retained graph may recompute more than once, each time from the
    first draw."""

    def __init__(self):
        self.draws: List[torch.Tensor] = []
        self.replaying = False
        self.next = 0
        self._prev: List[Optional["_Tape"]] = []

    def _scope(self, replaying: bool):
        tape = self

        class Scope:
            def __enter__(self):
                tape.replaying, tape.next = replaying, 0
                tape._prev.append(getattr(_local, "tape", None))
                _local.tape = tape

            def __exit__(self, *exc):
                _local.tape = tape._prev.pop()
                return False

        return Scope()

    def take(self, draw: Callable[[], torch.Tensor]) -> torch.Tensor:
        if not self.replaying:
            self.draws.append(draw())
            return self.draws[-1]
        if self.next >= len(self.draws):
            raise RuntimeError("the recompute drew more than the forward did")
        self.next += 1
        return self.draws[self.next - 1]


def once(fn: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``fn()`` in a forward; inside a checkpoint's recompute the tensor
    the forward's call gave, ``fn`` not called again (a draw, a
    collective)."""
    tape = getattr(_local, "tape", None)
    return fn() if tape is None else tape.take(fn)


def rand(shape, *, generator: torch.Generator,
         dtype: Optional[torch.dtype] = None,
         device: Optional[torch.device] = None) -> torch.Tensor:
    """``torch.rand`` on ``generator``: every train-time draw of the
    models goes through here, so that a checkpoint's recompute gets back
    what its forward drew."""
    return once(lambda: torch.rand(shape, generator=generator, dtype=dtype,
                                   device=device))


def recomputing() -> bool:
    """True while a checkpoint's backward recomputes its forward."""
    tape = getattr(_local, "tape", None)
    return tape is not None and tape.replaying


def checkpoint(fn: Callable, *args):
    """``fn(*args)`` through ``torch.utils.checkpoint.checkpoint``
    (non-reentrant), its draws taped and its recompute marked."""
    def contexts():
        tape = _Tape()
        return tape._scope(False), tape._scope(True)

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=contexts)
