"""Binarized Mixture-of-Experts MLP (the JAX package's ``models/moe.py``).

A flagship-style binarized MLP whose middle layer is a top-k routed
bank of binarized experts, ``sign(x) @ sign(W_e) + b_e``, trained with
the Switch Transformer's load-balancing auxiliary loss:

    784 -> BinarizedDense(hidden, raw pixels) -> BN -> hardtanh
        -> softmax(router) -> topk_dispatch -> BinarizedExperts
        -> BN -> hardtanh -> BinarizedDense(num_classes) -> log_softmax

  * the router is an fp32 ``nn.Linear`` (flax ``router``), outside any
    Binarized* layer: ``latent_clamp_mask`` leaves it unclamped;
  * the experts' stacked latents ``w`` (E, D, Do) and ``b`` (E, Do) keep
    the JAX layout (the expert axis first, the dim expert parallelism
    shards) and are clamped as binarized latents;
  * capacity is ``max(1, ceil(capacity_factor * T * k / E))`` for the
    T rows the router sees;
  * in train mode the forward records ``aux_loss = aux_coef *
    load_balance_loss(gates)`` (the JAX sow), which the train step adds
    to the loss (``train.trainer.forward_backward``);
  * each expert's product is ``ops.xnor_gemm.binary_matmul`` on the
    model's backend (K1 on "pallas_xnor"). The JAX experts run on the
    package's default backend ("bf16"); every backend is exact on ±1
    operands, so the products agree.

Under the JAX package's GSPMD data parallelism the router sees the
global batch. With the data group set on ``bn1``
(``parallel.set_batchnorm_group``: the group whose global batch its
statistics cover), a train-mode forward routes that global batch:
the (T, E) gates are all-gathered in rank order, every rank builds the
global dispatch, the experts' slot inputs are summed over the group
(each slot holds one token, so the sum is exact) and each rank combines
its own rows. Both collectives are differentiable (their backward sums
the cotangent over the group) and run once a step under an activation
checkpoint (``ops.remat.once``). Eval routes the rows it is given.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from ..ops import remat
from ..ops.binarize import binarize_ste
from ..ops.comm_compress import all_gather, all_reduce_sum
from ..ops.routing import load_balance_loss, topk_dispatch
from ..ops.xnor_gemm import BACKENDS, binary_matmul
from .layers import (
    BatchNorm,
    BinarizedDense,
    SeededTrainRNG,
    _AllReduceSum,
    dense,
    hard_tanh,
)


class _AllGatherRows(torch.autograd.Function):
    """The group's rows, in rank order (T_local, ...) -> (W T_local, ...);
    its backward sums the cotangent over the group and keeps this rank's
    rows. A recompute takes the forward's rows back."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = remat.once(
            lambda: all_gather(x, group).reshape(-1, *x.shape[1:]))
        return out.clone() if remat.recomputing() else out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        g = all_reduce_sum(g, ctx.group)
        world, rank = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return g.reshape(world, -1, *g.shape[1:])[rank], None


def capacity_for(tokens: int, num_experts: int, k: int,
                 capacity_factor: float) -> int:
    """An expert's slots for ``tokens`` routed rows (the JAX rule)."""
    return max(1, math.ceil(capacity_factor * tokens * k / num_experts))


class BinarizedExperts(nn.Module):
    """A routed bank of binarized FFN experts: stacked latents ``w`` (E, D,
    Do), uniform in ±D^-0.5, and ``b`` (E, Do), zero. ``forward(x,
    dispatch, combine)`` gathers the slots' inputs, binarizes them (an
    empty slot's 0 gives +1; its combine weight is 0), runs one ±1
    product per expert and combines."""

    def __init__(self, num_experts: int, in_features: int, features: int, *,
                 backend: str = "bf16",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (have {BACKENDS})")
        self.backend = backend
        scale = in_features ** -0.5
        w = torch.empty(num_experts, in_features, features)
        w.uniform_(-scale, scale, generator=generator)
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(torch.zeros(num_experts, features))

    def expert_outputs(self, xb: torch.Tensor) -> torch.Tensor:
        """(E_held, C, D) ±1 slot inputs -> (E_held, C, Do), one product
        per expert this module holds."""
        return torch.stack([
            binary_matmul(xb[e], binarize_ste(self.w[e]).t(), self.backend)
            + self.b[e] for e in range(self.w.shape[0])])

    def forward(self, x: torch.Tensor, dispatch: torch.Tensor,
                combine: torch.Tensor, group=None) -> torch.Tensor:
        ex_in = torch.einsum("tec,td->ecd", dispatch, x)
        if group is not None:   # every slot filled over the data group
            ex_in = _AllReduceSum.apply(ex_in, group)
        ex_out = self.expert_outputs(binarize_ste(ex_in))
        return torch.einsum("tec,ecd->td", combine, ex_out)


class BnnMoEMLP(SeededTrainRNG, nn.Module):
    """Binarized MLP with a top-k MoE middle layer. Submodules map to the
    flax names as fc1 <-> BinarizedDense_0, bn1 <-> BatchNorm_0, router
    <-> router, experts <-> BinarizedExperts_0, bn2 <-> BatchNorm_1,
    head <-> BinarizedDense_1 (``flax_names``). It draws nothing itself;
    its generator (``rng_seed``) gives the train step's crops under
    ``augment``."""

    def __init__(
        self, hidden: int = 512, num_experts: int = 8,
        expert_features: int = 512, num_classes: int = 10,
        router_k: int = 2, capacity_factor: float = 1.25,
        aux_coef: float = 0.01, *, in_features: int = 784,
        backend: str = "bf16", ste: str = "identity", rng_seed: int = 0,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.rng_seed = rng_seed
        self.hidden = hidden
        self.num_experts = num_experts
        self.expert_features = expert_features
        self.num_classes = num_classes
        self.router_k = router_k
        self.capacity_factor = capacity_factor
        self.aux_coef = aux_coef
        self.fc1 = BinarizedDense(in_features, hidden, binarize_input=False,
                                  ste=ste, backend=backend,
                                  generator=generator)
        self.bn1 = BatchNorm(hidden, eps=1e-5, momentum=0.1)
        self.router = dense(hidden, num_experts, generator=generator)
        self.experts = BinarizedExperts(num_experts, hidden, expert_features,
                                        backend=backend, generator=generator)
        self.bn2 = BatchNorm(expert_features, eps=1e-5, momentum=0.1)
        self.head = BinarizedDense(expert_features, num_classes, ste=ste,
                                   backend=backend, generator=generator)
        self.aux_loss: Optional[torch.Tensor] = None

    def flax_names(self):
        """(submodule, flax module, kind) of every parametrised layer."""
        return [("fc1", "BinarizedDense_0", "dense"),
                ("bn1", "BatchNorm_0", "bn"),
                ("router", "router", "dense"),
                ("experts", "BinarizedExperts_0", "experts"),
                ("bn2", "BatchNorm_1", "bn"),
                ("head", "BinarizedDense_1", "dense")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1)
        x = hard_tanh(self.bn1(self.fc1(x)))
        gates = torch.softmax(self.router(x), dim=-1)
        group = self.bn1.group   # the data group, as BatchNorm's
        if (not self.training or group is None
                or dist.get_world_size(group) == 1):
            group = None
        if group is not None:   # GSPMD: route the global batch
            gates = _AllGatherRows.apply(gates, group)
        t = gates.shape[0]
        dispatch, combine = topk_dispatch(
            gates, capacity_for(t, self.num_experts, self.router_k,
                                self.capacity_factor), self.router_k)
        if group is not None:   # this rank's rows
            rows = x.shape[0]
            lo = dist.get_rank(group) * rows
            dispatch, combine = dispatch[lo:lo + rows], combine[lo:lo + rows]
        self.aux_loss = (self.aux_coef * load_balance_loss(gates)
                         if self.training else None)
        y = self.experts(x, dispatch, combine, group)
        x = hard_tanh(self.bn2(y))
        return torch.log_softmax(self.head(x), dim=-1)


def bnn_moe_mlp(**kw) -> BnnMoEMLP:
    return BnnMoEMLP(**kw)
