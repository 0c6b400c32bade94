"""The projection half of BNN training: ``clamp_latent``.

Counterpart of the JAX package's ``train/trainer.py::clamp_latent``. Its
``make_step_body`` and ``Trainer`` come with the MLP training slice; the
LM's step (fwd, ``lm_loss``, bwd, Adam, clamp) is
``examples/lm_demo.py::train_step``.
"""

from __future__ import annotations

from typing import Iterable

import torch


def clamp_latent(params: Iterable[torch.Tensor]) -> None:
    """Clamp binarized-layer latents to [-1, 1] (mnist-dist2.py:135-137),
    e.g. ``clamp_latent(latent_clamp_mask(model).values())``.

    The JAX version is pure and returns new params; the port clamps the
    given tensors in place, under ``torch.no_grad()``."""
    with torch.no_grad():
        for p in params:
            p.clamp_(-1.0, 1.0)
