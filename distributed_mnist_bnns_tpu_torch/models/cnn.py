"""The reference's deeper fp32 ``CNN`` (``mnist-cnn server.py:7-52``).

Counterpart of the JAX package's ``models/cnn.py`` (``DeepCNN``):

  3 conv blocks 1->32->64->128 (3x3, SAME, ReLU, MaxPool 2x2; the 3rd
  pool pads by 1 with -inf, so 28 -> 14 -> 7 -> 4) -> flatten (h, w, c)
  -> Linear 2048->625 (Xavier uniform) -> ReLU -> Dropout(0.5) ->
  Linear 625->10 (Xavier uniform), both fp32.

``dtype=torch.bfloat16`` runs the conv blocks in bf16 (flax's
``dtype``); the dense layers stay fp32, as in the JAX model. Dropout is
flax's, drawn from the model's own generator (``SeededTrainRNG``).
Submodules map to the flax names as conv1..conv3 <-> Conv_0..2, fc1 <->
Dense_0 and head <-> Dense_1. It returns logits.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import (
    Conv,
    Dropout,
    SeededTrainRNG,
    dense,
    flatten_nhwc,
    nhwc_input,
)


class DeepCNN(SeededTrainRNG, nn.Module):
    def __init__(self, num_classes: int = 10, dropout_rate: float = 0.5, *,
                 dtype: Optional[torch.dtype] = None, rng_seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.rng_seed = rng_seed
        self._train_gen: Optional[torch.Generator] = None
        self.conv1 = Conv(1, 32, dtype=dtype, generator=generator)
        self.conv2 = Conv(32, 64, dtype=dtype, generator=generator)
        self.conv3 = Conv(64, 128, dtype=dtype, generator=generator)
        self.fc1 = dense(4 * 4 * 128, 625, init="xavier", generator=generator)
        self.dropout = Dropout(dropout_rate)
        self.head = dense(625, num_classes, init="xavier",
                          generator=generator)

    def flax_names(self):
        return [("conv1", "Conv_0", "conv"), ("conv2", "Conv_1", "conv"),
                ("conv3", "Conv_2", "conv"), ("fc1", "Dense_0", "dense"),
                ("head", "Dense_1", "dense")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_input(x).to(self.dtype or torch.float32)
        pool = nn.functional.max_pool2d
        x = pool(torch.relu(self.conv1(x)), 2, 2)
        x = pool(torch.relu(self.conv2(x)), 2, 2)
        # MaxPool2d(2, 2, padding=1): -inf padding, 7 -> 4
        x = pool(torch.relu(self.conv3(x)), 2, 2, padding=1)
        x = torch.relu(self.fc1(flatten_nhwc(x).to(torch.float32)))
        gen = self.train_generator(x.device) if self.training else None
        return self.head(self.dropout(x, gen))
