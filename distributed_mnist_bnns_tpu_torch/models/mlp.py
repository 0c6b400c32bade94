"""BNN MLP family, the source paper's flagship model.

Counterpart of the JAX package's ``models/mlp.py`` (``BnnMLP``,
``bnn_mlp_large``, ``bnn_mlp_small``): 784 -> BinarizedDense h1 -> BN ->
Hardtanh -> BinarizedDense h2 -> BN -> Hardtanh -> BinarizedDense h3 ->
Dropout -> BN -> Hardtanh -> fp32 Linear -> log_softmax.

Kept as the reference has it:
  * dropout sits *before* the third BatchNorm;
  * the first BinarizedDense consumes raw pixels un-binarized;
  * BatchNorm eps is 1e-5 and torch momentum 0.1 (flax momentum 0.9);
    eval mode uses the running statistics;
  * the activation is flax's ``hard_tanh`` (gradient 1 at exactly +-1);
  * train mode is flax's ``nn.BatchNorm`` (``BatchNorm`` below): the
    fast variance ``max(0, mean(x^2) - mean(x)^2)``, and the running
    variance updated with that biased batch variance.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import BinarizedDense, hard_tanh


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (same state-dict keys) whose train mode is
    flax's ``nn.BatchNorm`` (``normalization._compute_stats`` and
    ``_normalize``, ``use_fast_variance=True``): the batch's mean and
    ``var = max(0, mean(x^2) - mean(x)^2)`` normalise as ``(x - mean) *
    (rsqrt(var + eps) * weight) + bias``, and the running statistics move
    by ``momentum`` towards the mean and the biased ``var`` (flax's
    momentum is the old value's weight, ``1 - momentum`` here). Eval mode
    is ``nn.BatchNorm1d``'s, on the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean(dim=0)
        var = torch.clamp((x * x).mean(dim=0) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self.momentum * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class BnnMLP(nn.Module):
    """Binarized MLP with fp32 first-layer input and fp32 head.

    Submodules map to the flax names as fc1..fc3 <-> BinarizedDense_0..2,
    bn1..bn3 <-> BatchNorm_0..2 and head <-> Dense_0."""

    def __init__(
        self,
        hidden: Sequence[int] = (3072, 1536, 768),
        num_classes: int = 10,
        dropout_rate: float = 0.3,
        *,
        in_features: int = 784,
        backend: str = "bf16",
        ste: str = "identity",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        h1, h2, h3 = hidden
        self.hidden = (h1, h2, h3)
        self.num_classes = num_classes

        def dense(i, o, first=False):
            return BinarizedDense(
                i, o, binarize_input=not first, ste=ste, backend=backend,
                generator=generator,
            )

        def bn(c):
            return BatchNorm(c, eps=1e-5, momentum=0.1)

        self.fc1 = dense(in_features, h1, first=True)
        self.bn1 = bn(h1)
        self.fc2 = dense(h1, h2)
        self.bn2 = bn(h2)
        self.fc3 = dense(h2, h3)
        self.dropout = nn.Dropout(dropout_rate)
        self.bn3 = bn(h3)
        self.head = nn.Linear(h3, num_classes)
        # flax Dense init: lecun-normal kernel (a normal truncated at two
        # standard deviations, rescaled to variance 1/fan_in), zero bias
        std = (1.0 / h3) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(
            self.head.weight, std=std, a=-2 * std, b=2 * std,
            generator=generator,
        )
        nn.init.zeros_(self.head.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = hard_tanh(self.bn1(self.fc1(x)))
        x = hard_tanh(self.bn2(self.fc2(x)))
        x = self.fc3(x)
        x = self.dropout(x)  # reference order: dropout THEN bn3
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
