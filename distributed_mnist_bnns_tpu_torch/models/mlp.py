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
import torch.distributed as dist
from torch import nn

from ..ops.comm_compress import all_reduce_sum
from .layers import BinarizedDense, Dropout, SeededTrainRNG, hard_tanh


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group; its backward sums the cotangent over
    the group, since every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce_sum(g, ctx.group), None


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (same state-dict keys) whose train mode is
    flax's ``nn.BatchNorm`` (``normalization._compute_stats`` and
    ``_normalize``, ``use_fast_variance=True``): the batch's mean and
    ``var = max(0, mean(x^2) - mean(x)^2)`` normalise as ``(x - mean) *
    (rsqrt(var + eps) * weight) + bias``, and the running statistics move
    by ``momentum`` towards the mean and the biased ``var`` (flax's
    momentum is the old value's weight, ``1 - momentum`` here). Eval mode
    is ``nn.BatchNorm1d``'s, on the running statistics.

    With a ``group`` (a ``torch.distributed`` process group, set on the
    module), the batch is the global one, as flax's BatchNorm sees it
    under the JAX package's GSPMD data parallelism: ``sum x`` and ``sum
    x^2`` are summed over the group (gradient included) before the fast
    variance. ``nn.SyncBatchNorm`` would not do: it takes ``E[(x -
    mean)^2]`` and keeps an unbiased running variance."""

    group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        if self.group is None:
            mean = x.mean(dim=0)
            mean_sq = (x * x).mean(dim=0)
        else:
            c = x.shape[1]
            sums = _AllReduceSum.apply(
                torch.cat([x.sum(dim=0), (x * x).sum(dim=0)]), self.group)
            n = x.shape[0] * dist.get_world_size(self.group)
            mean, mean_sq = sums[:c] / n, sums[c:] / n
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self.momentum * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class BnnMLP(SeededTrainRNG, nn.Module):
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
        stochastic: bool = False,
        rng_seed: int = 0,
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
        self._train_gen: Optional[torch.Generator] = None

        def dense(i, o, first=False):
            return BinarizedDense(
                i, o, binarize_input=not first, ste=ste, backend=backend,
                stochastic=stochastic and not first, generator=generator,
            )

        def bn(c):
            return BatchNorm(c, eps=1e-5, momentum=0.1)

        self.fc1 = dense(in_features, h1, first=True)
        self.bn1 = bn(h1)
        self.fc2 = dense(h1, h2)
        self.bn2 = bn(h2)
        self.fc3 = dense(h2, h3)
        self.dropout = Dropout(dropout_rate)
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
        gen = self.train_generator(x.device) if self.training else None
        x = hard_tanh(self.bn1(self.fc1(x)))
        x = hard_tanh(self.bn2(self.fc2(x, gen)))
        x = self.fc3(x, gen)
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
