"""The binarized CNN (``bnn-cnn``, BASELINE.json's "MNIST BinarizeConv2d
CNN"; the reference defines ``BinarizeConv2d``,
``models/binarized_modules.py:87-107``).

Counterpart of the JAX package's ``models/bnn_cnn.py``
(``BinarizedCNN``):

  BinarizedConv(1->w1, 3x3, raw pixels) -> BN -> Hardtanh -> MaxPool(2)
  BinarizedConv(w1->w2, 3x3) -> BN -> Hardtanh -> MaxPool(2)
  flatten (h, w, c) -> BinarizedDense(7*7*w2 -> hidden) -> BN ->
  Hardtanh -> fp32 Linear -> log_softmax

at widths (64, 128) and hidden 1024 by default. The first conv takes raw
pixels (``binarize_input=False``: "xla" under the ±1 backends). On
xnor and pallas_xnor the second conv is an im2col patch GEMM (K1 on
pallas_xnor, M = B * 14 * 14, K = 9 * w1) and the dense layer K1 at K =
49 * w2. With ``stochastic`` the activations entering the second conv
and the dense layer are binarized stochastically in train mode, from
the model's own generator. Submodules map to the flax names as conv1,
conv2 <-> BinarizedConv_0, 1, bn1..bn3 <-> BatchNorm_0..2, fc <->
BinarizedDense_0 and head <-> Dense_0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import (
    BatchNorm,
    BinarizedConv,
    BinarizedDense,
    SeededTrainRNG,
    dense,
    flatten_nhwc,
    hard_tanh,
    nhwc_input,
)


class BinarizedCNN(SeededTrainRNG, nn.Module):
    def __init__(self, num_classes: int = 10,
                 widths: Sequence[int] = (64, 128), hidden: int = 1024, *,
                 backend: str = "bf16", ste: str = "identity",
                 stochastic: bool = False, rng_seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        w1, w2 = widths
        self.num_classes = num_classes
        self.widths = (w1, w2)
        self.hidden = hidden
        self.stochastic = stochastic
        self.rng_seed = rng_seed
        self._train_gen: Optional[torch.Generator] = None
        common = dict(ste=ste, backend=backend, generator=generator)
        self.conv1 = BinarizedConv(1, w1, (3, 3), binarize_input=False,
                                   **common)
        self.bn1 = BatchNorm(w1, eps=1e-5, momentum=0.1)
        self.conv2 = BinarizedConv(w1, w2, (3, 3), stochastic=stochastic,
                                   **common)
        self.bn2 = BatchNorm(w2, eps=1e-5, momentum=0.1)
        self.fc = BinarizedDense(7 * 7 * w2, hidden, stochastic=stochastic,
                                 **common)
        self.bn3 = BatchNorm(hidden, eps=1e-5, momentum=0.1)
        self.head = dense(hidden, num_classes, generator=generator)

    def flax_names(self):
        return [("conv1", "BinarizedConv_0", "conv"),
                ("bn1", "BatchNorm_0", "bn"),
                ("conv2", "BinarizedConv_1", "conv"),
                ("bn2", "BatchNorm_1", "bn"),
                ("fc", "BinarizedDense_0", "dense"),
                ("bn3", "BatchNorm_2", "bn"),
                ("head", "Dense_0", "dense")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_input(x)
        gen = self.train_generator(x.device) if self.training else None
        pool = nn.functional.max_pool2d
        x = pool(hard_tanh(self.bn1(self.conv1(x))), 2, 2)    # 28 -> 14
        x = pool(hard_tanh(self.bn2(self.conv2(x, gen))), 2, 2)  # -> 7
        x = hard_tanh(self.bn3(self.fc(flatten_nhwc(x), gen)))
        return nn.functional.log_softmax(self.head(x), dim=-1)
