"""Device-side image augmentation inside the train step: the per-sample
random crop of the zero-padded image and the horizontal flip
(torchvision's ``RandomCrop(padding=4)`` + ``RandomHorizontalFlip``).

Counterpart of the JAX package's ``ops/augment.py``
(``random_crop_flip``), in two parts:

  draw_crop_flip(b, generator)   the draws: per sample a crop offset
                                 ``oy``, ``ox`` in [0, 2 * pad] and a
                                 flip coin, from a ``torch.Generator``
                                 on the images' device
  crop_flip(images, oy, ox, flip)
                                 the apply: one gather from the padded
                                 images, on the device, no host sync
                                 (a CUDA graph captures it)

``crop_flip`` on JAX's own draws is bitwise JAX's ``random_crop_flip``
(a gather moves values, it computes none). The draws come from torch's
generator, not JAX's PRNG, so the crops themselves differ from JAX's
for the same seed, as the dropout masks do.
"""

from __future__ import annotations

from typing import Tuple

import torch

PAD = 4


def draw_crop_flip(b: int, generator: torch.Generator, *, pad: int = PAD
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(oy, ox, flip) for ``b`` samples on the generator's device: int64
    offsets uniform on [0, 2 * pad], then a bool coin of probability 1/2,
    drawn in that order (as JAX splits its key into ky, kx, kf)."""
    device = generator.device
    oy = torch.randint(0, 2 * pad + 1, (b,), generator=generator,
                       device=device)
    ox = torch.randint(0, 2 * pad + 1, (b,), generator=generator,
                       device=device)
    flip = torch.rand(b, generator=generator, device=device) < 0.5
    return oy, ox, flip


def crop_flip(images: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
              flip: torch.Tensor, *, pad: int = PAD) -> torch.Tensor:
    """(B, H, W, C) images, each zero-padded by ``pad`` on both spatial
    axes, cropped back to (H, W) at (oy, ox) and mirrored along W where
    ``flip``: the same shape and dtype."""
    if images.dim() != 4:
        raise ValueError(f"crop_flip wants (B, H, W, C) images, got "
                         f"{tuple(images.shape)}")
    b, h, w, _ = images.shape
    padded = torch.nn.functional.pad(images, (0, 0, pad, pad, pad, pad))
    dev = images.device
    rows = oy.to(dev)[:, None] + torch.arange(h, device=dev)
    j = torch.arange(w, device=dev)
    cols = ox.to(dev)[:, None] + torch.where(flip.to(dev)[:, None],
                                             w - 1 - j, j)
    batch = torch.arange(b, device=dev)[:, None, None]
    return padded[batch, rows[:, :, None], cols[:, None, :]]


def random_crop_flip(images: torch.Tensor, generator: torch.Generator, *,
                     pad: int = PAD) -> torch.Tensor:
    """``crop_flip`` on fresh draws from ``generator`` (the JAX
    ``random_crop_flip`` with a generator for the key)."""
    oy, ox, flip = draw_crop_flip(images.shape[0], generator, pad=pad)
    return crop_flip(images, oy, ox, flip, pad=pad)
