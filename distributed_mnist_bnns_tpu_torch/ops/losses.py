"""Loss functions: cross entropy, hinge and squared ("sqrt") hinge.

Counterpart of the JAX package's ``ops/losses.py``. ``make_loss`` returns
a ``Loss``: called on a batch it gives the batch loss the train step
minimises, and ``per_example`` gives one loss per row, the value the
JAX eval step gets by applying the batch loss to each row alone, so
masked eval sums stay exact.

  ce          mean softmax cross entropy over integer labels; takes
              logits or log-probs alike (the reference's MLP ends in
              log_softmax and is trained with CrossEntropyLoss on top,
              a double log-softmax that is harmless: log_softmax is
              shift invariant and idempotent). ``label_smoothing`` mixes
              the one-hot target as optax's ``smooth_labels`` does,
              ``(1 - a) * onehot + a / C``.
  hinge       mean(max(0, 1 - output * target)) over ±1-coded targets.
  sqrt_hinge  sum((1 - output * target)_+^2) / B with the reference's
              handwritten backward ``-2 * t * err / B * g``.
"""

from __future__ import annotations

from typing import Callable

import torch

LOSSES = ("ce", "hinge", "sqrt_hinge")


def _hinge_err(output: torch.Tensor, target_pm1: torch.Tensor) -> torch.Tensor:
    # torch.maximum splits the gradient at a tie as jnp.maximum does;
    # clamp(min=0) would pass all of it.
    return torch.maximum(torch.zeros_like(output), 1.0 - output * target_pm1)


def hinge_loss(output: torch.Tensor, target_pm1: torch.Tensor) -> torch.Tensor:
    """Margin-1 hinge: mean(max(0, 1 - output * target)), ±1 targets."""
    return _hinge_err(output, target_pm1).mean()


class _SqrtHinge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, output: torch.Tensor, target_pm1: torch.Tensor):
        err = torch.clamp(1.0 - output * target_pm1, min=0.0)
        batch = output.shape[0] if output.dim() > 0 else 1
        ctx.save_for_backward(err, target_pm1)
        ctx.batch = batch
        return (err * err).sum() / batch

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        err, target_pm1 = ctx.saved_tensors
        return -2.0 * target_pm1 * err / ctx.batch * g, None


def sqrt_hinge_loss(output: torch.Tensor,
                    target_pm1: torch.Tensor) -> torch.Tensor:
    """Squared hinge: sum((1 - y t)_+^2) / B, with the reference's
    handwritten gradient -2 t err / B (the JAX package's custom_vjp)."""
    return _SqrtHinge.apply(output, target_pm1)


def _ce_per_example(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's ``softmax_cross_entropy_with_integer_labels``:
    logsumexp(logits) - logits[label], one value per row."""
    label_logits = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy over integer labels (logits or
    log-probs)."""
    return _ce_per_example(logits, labels).mean()


def _one_hot(labels: torch.Tensor, num_classes: int,
             like: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.one_hot(labels.long(), num_classes).to(like.dtype)


class Loss:
    """A batch loss ``loss(outputs, labels) -> scalar`` with its
    per-example form ``loss.per_example(outputs, labels) -> (B,)``."""

    def __init__(self, name: str, batch: Callable, per_example: Callable):
        self.name = name
        self._batch = batch
        self.per_example = per_example

    def __call__(self, outputs: torch.Tensor,
                 labels: torch.Tensor) -> torch.Tensor:
        return self._batch(outputs, labels)

    def __repr__(self) -> str:
        return f"Loss({self.name!r})"


def make_loss(name: str, num_classes: int = 10,
              label_smoothing: float = 0.0) -> Loss:
    """The trainer's loss registry: ``ce`` (with optional label
    smoothing), ``hinge`` and ``sqrt_hinge`` (integer labels one-hot
    coded to ±1 targets)."""
    if label_smoothing and name != "ce":
        raise ValueError("label_smoothing only applies to the 'ce' loss")
    if name == "ce":
        if not label_smoothing:
            return Loss(name, cross_entropy_loss, _ce_per_example)
        if not 0.0 < label_smoothing < 1.0:
            raise ValueError(
                f"label_smoothing must be in (0, 1), got {label_smoothing}"
            )

        def smoothed_per_example(logits, labels):
            onehot = _one_hot(labels, num_classes, logits)
            target = (1.0 - label_smoothing) * onehot + (
                label_smoothing / num_classes)
            logp = torch.log_softmax(logits, dim=-1)
            return -(target * logp).sum(dim=-1)

        return Loss(name, lambda o, y: smoothed_per_example(o, y).mean(),
                    smoothed_per_example)
    if name in ("hinge", "sqrt_hinge"):
        def target(outputs, labels):
            return 2.0 * _one_hot(labels, num_classes, outputs) - 1.0

        if name == "hinge":
            return Loss(
                name, lambda o, y: hinge_loss(o, target(o, y)),
                lambda o, y: _hinge_err(o, target(o, y)).mean(dim=-1))

        def sq_per_example(outputs, labels):
            err = torch.clamp(1.0 - outputs * target(outputs, labels), min=0.0)
            return (err * err).sum(dim=-1)

        return Loss(name, lambda o, y: sqrt_hinge_loss(o, target(o, y)),
                    sq_per_example)
    raise ValueError(f"unknown loss {name!r}; available: {', '.join(LOSSES)}")
