"""The source paper's fp32 ``ConvNet`` (``mnist-dist.py:31-51``, also
``mnist.py`` and ``mnist-mixed.py``).

Counterpart of the JAX package's ``models/convnet.py``:

  Conv(1->16, 5x5, pad 2) -> BN -> ReLU -> MaxPool(2)
  Conv(16->32, 5x5, pad 2) -> BN -> ReLU -> MaxPool(2)
  Linear(7*7*32 -> 10), fp32, on the maps flattened in (h, w, c) order

``dtype=torch.bfloat16`` is flax's ``dtype=bfloat16`` (the JAX
package's AMP, ``TrainConfig.precision="bf16"``): the input, the convs
and the BatchNorms' outputs in bf16 over fp32 parameters (the BatchNorm
statistics in fp32, as flax's), the head in fp32. It returns logits, as
the JAX model does. Submodules map to the flax names as conv1, conv2
<-> Conv_0, Conv_1, bn1, bn2 <-> BatchNorm_0, BatchNorm_1 and head <->
Dense_0 (``flax_names``). The model draws nothing itself; its
generator (``SeededTrainRNG``, seeded by ``rng_seed``) gives the train
step's crops under ``augment``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .layers import (
    BatchNorm,
    Conv,
    SeededTrainRNG,
    dense,
    flatten_nhwc,
    nhwc_input,
)


def _bn(c: int, dtype: Optional[torch.dtype]) -> BatchNorm:
    bn = BatchNorm(c, eps=1e-5, momentum=0.1)
    bn.dtype = dtype
    return bn


class ConvNet(SeededTrainRNG, nn.Module):
    def __init__(self, num_classes: int = 10, *,
                 dtype: Optional[torch.dtype] = None, rng_seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.rng_seed = rng_seed
        self.dtype = dtype
        self.conv1 = Conv(1, 16, (5, 5), padding=2, dtype=dtype,
                          generator=generator)
        self.bn1 = _bn(16, dtype)
        self.conv2 = Conv(16, 32, (5, 5), padding=2, dtype=dtype,
                          generator=generator)
        self.bn2 = _bn(32, dtype)
        self.head = dense(7 * 7 * 32, num_classes, generator=generator)

    def flax_names(self):
        return [("conv1", "Conv_0", "conv"), ("bn1", "BatchNorm_0", "bn"),
                ("conv2", "Conv_1", "conv"), ("bn2", "BatchNorm_1", "bn"),
                ("head", "Dense_0", "dense")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_input(x).to(self.dtype or torch.float32)
        for conv, bn in ((self.conv1, self.bn1), (self.conv2, self.bn2)):
            x = nn.functional.max_pool2d(torch.relu(bn(conv(x))), 2, 2)
        return self.head(flatten_nhwc(x).to(torch.float32))
