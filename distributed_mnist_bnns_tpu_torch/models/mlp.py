"""BNN MLP family, the source paper's flagship model.

Counterpart of the JAX package's ``models/mlp.py`` (``BnnMLP``,
``bnn_mlp_large``, ``bnn_mlp_small``, ``fp32_mlp_large``): 784 ->
BinarizedDense h1 -> BN -> Hardtanh -> BinarizedDense h2 -> BN ->
Hardtanh -> BinarizedDense h3 -> Dropout -> BN -> Hardtanh -> fp32
Linear -> log_softmax. ``binarized=False`` (``fp32-mlp-large``) puts
flax's fp32 ``nn.Dense`` in place of each BinarizedDense and keeps the
rest.

Kept as the reference has it:
  * dropout sits *before* the third BatchNorm;
  * the first BinarizedDense consumes raw pixels un-binarized;
  * BatchNorm eps is 1e-5 and torch momentum 0.1 (flax momentum 0.9);
    eval mode uses the running statistics;
  * the activation is flax's ``hard_tanh`` (gradient 1 at exactly +-1);
  * train mode is flax's ``nn.BatchNorm`` (``BatchNorm`` below): the
    fast variance ``max(0, mean(x^2) - mean(x)^2)``, and the running
    variance updated with that biased batch variance;
  * dropout is flax's ``nn.Dropout`` (``layers.Dropout``): keep with
    probability 1 - rate, divide the kept units by 1 - rate.

Train-mode randomness (the dropout mask, and with ``stochastic`` the
signs of the activations entering layers 2 and 3) comes from the model's
own generator, ``train_generator(device)``: a ``torch.Generator`` on the
input's device seeded with ``rng_seed``, so two models of one seed drop
the same units. Eval mode draws nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import (
    BatchNorm,
    BinarizedDense,
    Dropout,
    SeededTrainRNG,
    dense,
    hard_tanh,
)


class BnnMLP(SeededTrainRNG, nn.Module):
    """Binarized MLP with fp32 first-layer input and fp32 head.

    Submodules map to the flax names as fc1..fc3 <-> BinarizedDense_0..2,
    bn1..bn3 <-> BatchNorm_0..2 and head <-> Dense_0; with
    ``binarized=False``, fc1..fc3 <-> Dense_0..2 and head <-> Dense_3
    (``flax_names``)."""

    def __init__(
        self,
        hidden: Sequence[int] = (3072, 1536, 768),
        num_classes: int = 10,
        dropout_rate: float = 0.3,
        *,
        in_features: int = 784,
        backend: str = "bf16",
        ste: str = "identity",
        stochastic: bool = False,
        rng_seed: int = 0,
        binarized: bool = True,
        generator: Optional[torch.Generator] = None,
    ):
        """``backend``: the binarized layers' GEMM backend.
        ``stochastic``: stochastic signs into layers 2 and 3 in train
        mode. ``rng_seed``: seeds the train-time generator.
        ``generator``: the CPU generator the initial weights are drawn
        from."""
        super().__init__()
        h1, h2, h3 = hidden
        self.hidden = (h1, h2, h3)
        self.num_classes = num_classes
        self.rng_seed = rng_seed
        self.binarized = binarized
        self._train_gen: Optional[torch.Generator] = None

        def fc(i, o, first=False):
            if not binarized:
                return dense(i, o, generator=generator)
            return BinarizedDense(
                i, o, binarize_input=not first, ste=ste, backend=backend,
                stochastic=stochastic and not first, generator=generator,
            )

        def bn(c):
            return BatchNorm(c, eps=1e-5, momentum=0.1)

        self.fc1 = fc(in_features, h1, first=True)
        self.bn1 = bn(h1)
        self.fc2 = fc(h1, h2)
        self.bn2 = bn(h2)
        self.fc3 = fc(h2, h3)
        self.dropout = Dropout(dropout_rate)
        self.bn3 = bn(h3)
        self.head = dense(h3, num_classes, generator=generator)

    def flax_names(self):
        """(submodule, flax module, kind) of every parametrised layer."""
        fc = "BinarizedDense" if self.binarized else "Dense"
        return ([(f"fc{i + 1}", f"{fc}_{i}", "dense") for i in range(3)]
                + [(f"bn{i + 1}", f"BatchNorm_{i}", "bn") for i in range(3)]
                + [("head", "Dense_0" if self.binarized else "Dense_3",
                    "dense")])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        gen = self.train_generator(x.device) if self.training else None
        draws = (gen,) if self.binarized else ()   # an fp32 fc draws none
        x = hard_tanh(self.bn1(self.fc1(x)))
        x = hard_tanh(self.bn2(self.fc2(x, *draws)))
        x = self.fc3(x, *draws)
        x = self.dropout(x, gen)  # reference order: dropout THEN bn3
        x = hard_tanh(self.bn3(x))
        return nn.functional.log_softmax(self.head(x), dim=-1)


def bnn_mlp_large(infl_ratio: int = 3, **kw) -> BnnMLP:
    """784 -> 1024r -> 512r -> 256r -> 10 (r=3: 3072, 1536, 768)."""
    return BnnMLP(
        hidden=(1024 * infl_ratio, 512 * infl_ratio, 256 * infl_ratio), **kw
    )


def bnn_mlp_small(infl_ratio: int = 3, **kw) -> BnnMLP:
    """784 -> 64r -> 64r -> 64r -> 10."""
    w = 64 * infl_ratio
    return BnnMLP(hidden=(w, w, w), **kw)


def fp32_mlp_large(infl_ratio: int = 3, **kw) -> BnnMLP:
    """The flagship's topology with binarization removed (fp32 Dense)."""
    return BnnMLP(
        hidden=(1024 * infl_ratio, 512 * infl_ratio, 256 * infl_ratio),
        binarized=False, **kw,
    )
