"""Expert parallelism: Mixture-of-Experts dispatch over a process group
(the JAX package's ``parallel/expert_parallel.py``).

GShard's formulation with the tokens and the experts both sharded over
the group: each rank routes its own tokens into capacity-bounded slots
(per-shard routing and capacity), gathers the (E, C, D) slot inputs,
and two all-to-alls carry them to the experts' owners and the results
back:

    dispatch (T, E, C) @ tokens (T, D) -> (E, C, D)
    all_to_all: each owner holds (E_local, n*C, D), source-major
    one binarized product per local expert
    all_to_all back -> (E, C, D_out); combine (T, E, C) -> (T, D_out)

The exchange is an ``autograd.Function`` whose backward is the same
all-to-all of the cotangent (``torch.distributed`` collectives are not
differentiable). ``moe_reference`` is the dense one-process oracle with
the same per-shard routing, token drops included.

The routing functions live in ``ops.routing`` and are re-exported here.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch
import torch.distributed as dist

from ..ops.binarize import binarize_ste
from ..ops.comm_compress import all_to_all
from ..ops.routing import load_balance_loss, top1_dispatch, topk_dispatch
from ..ops.xnor_gemm import binary_matmul

__all__ = [
    "top1_dispatch",
    "topk_dispatch",
    "load_balance_loss",
    "binarized_expert",
    "init_expert_params",
    "moe_reference",
    "make_expert_parallel_moe",
]


def binarized_expert(params: Dict[str, torch.Tensor], x: torch.Tensor,
                     backend: str = "bf16") -> torch.Tensor:
    """One BNN expert, sign(x) @ sign(W) + b: ``params`` {"w": (D, D_out)
    fp32 latent, "b": (D_out,)}, x (S, D). The ±1 product runs on
    ``backend`` (``binary_matmul``; JAX's default is "bf16")."""
    y = binary_matmul(binarize_ste(x), binarize_ste(params["w"]).t(),
                      backend)
    return y + params["b"]


def init_expert_params(generator: torch.Generator, num_experts: int,
                       d_in: int, d_out: int) -> Dict[str, torch.Tensor]:
    """Stacked per-expert latents, the expert axis first: ``w`` (E, D_in,
    D_out) uniform in ±D_in^-0.5, ``b`` (E, D_out) zero."""
    scale = d_in ** -0.5
    w = torch.empty(num_experts, d_in, d_out)
    w.uniform_(-scale, scale, generator=generator)
    return {"w": w, "b": torch.zeros(num_experts, d_out)}


def _route(x_s: torch.Tensor, gate_w: torch.Tensor, capacity: int, k: int):
    gates = torch.softmax(x_s @ gate_w, dim=-1)
    if k == 1:
        return top1_dispatch(gates, capacity)
    return topk_dispatch(gates, capacity, k)


def _experts(expert_fn: Callable, params: Dict[str, torch.Tensor],
             ex_in: torch.Tensor) -> torch.Tensor:
    """expert_fn over the leading (expert) dim of ``params`` and
    ``ex_in`` (E, S, D) -> (E, S, D_out)."""
    return torch.stack([
        expert_fn({key: v[e] for key, v in params.items()}, ex_in[e])
        for e in range(ex_in.shape[0])])


def moe_reference(expert_params: Dict[str, torch.Tensor],
                  gate_w: torch.Tensor, x: torch.Tensor, *, capacity: int,
                  expert_fn: Callable = binarized_expert, n_shards: int = 1,
                  k: int = 1) -> torch.Tensor:
    """The dense one-process MoE with per-shard routing: the T tokens of
    ``x`` (T, D) are ``n_shards`` shards, each routed alone with
    ``capacity`` slots an expert, as the expert-parallel path routes
    them (drops included). ``k=1``: top-1 with the raw gate; ``k>=2``:
    GShard top-k with renormalized weights."""
    t, d = x.shape
    if t % n_shards:
        raise ValueError(f"{t} tokens in {n_shards} shards")
    xs = x.reshape(n_shards, t // n_shards, d)
    routes = [_route(x_s, gate_w, capacity, k) for x_s in xs]
    dispatch = torch.stack([r[0] for r in routes])       # (S, Tl, E, C)
    combine = torch.stack([r[1] for r in routes])
    ex_in = torch.einsum("stec,std->escd", dispatch, xs)  # (E, S, C, D)
    e = ex_in.shape[0]
    ex_out = _experts(expert_fn, expert_params,
                      ex_in.reshape(e, n_shards * capacity, d))
    ex_out = ex_out.reshape(e, n_shards, capacity, -1)
    out = torch.einsum("stec,escd->std", combine, ex_out)
    return out.reshape(t, -1)


class _AllToAll(torch.autograd.Function):
    """``ops.comm_compress.all_to_all`` of a (world, ...) tensor (row j to
    rank j); the backward sends each cotangent row back where its row
    came from, which is the same exchange."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_to_all(g, ctx.group), None


def make_expert_parallel_moe(group=None, *, capacity: int,
                             expert_fn: Callable = binarized_expert,
                             k: int = 1) -> Callable:
    """The expert-parallel MoE over ``group`` (None: the world), the JAX
    ``make_expert_parallel_moe`` with one rank a device.

    ``moe(expert_params, gate_w, x) -> (T / n, D_out)``: ``expert_params``
    are the stacked (E, ...) params and ``x`` the (T, D) tokens, as the
    JAX function takes them; this rank keeps its experts (the leading
    dim's rank-th 1/n) and its tokens (rows ``[r T/n, (r+1) T/n)``) and
    returns its tokens' outputs, the rank-th rows of the JAX result.
    Gradients flow to the slices it keeps (the other ranks' experts and
    tokens get zeros here: sum the gradients over the group for the
    whole). The group size must divide both E and T."""

    def moe(expert_params: Dict[str, Any], gate_w: torch.Tensor,
            x: torch.Tensor) -> torch.Tensor:
        n = dist.get_world_size(group)
        r = dist.get_rank(group)
        e = next(iter(expert_params.values())).shape[0]
        t = x.shape[0]
        if e % n or t % n:
            raise ValueError(
                f"the expert group of size {n} must divide both the "
                f"expert count ({e}) and the token count ({t})")
        el, tl = e // n, t // n
        params = {key: v[r * el:(r + 1) * el]
                  for key, v in expert_params.items()}
        x_local = x[r * tl:(r + 1) * tl]
        dispatch, combine = _route(x_local, gate_w, capacity, k)
        ex_in = torch.einsum("tec,td->ecd", dispatch, x_local)  # (E, C, D)
        # expert groups to their owners: (n, El, C, D) -> from every source
        ex_in = _AllToAll.apply(ex_in.reshape(n, el, capacity, -1), group)
        ex_in = ex_in.transpose(0, 1).reshape(el, n * capacity, -1)
        ex_out = _experts(expert_fn, params, ex_in)       # (El, n*C, Do)
        ex_out = ex_out.reshape(el, n, capacity, -1).transpose(0, 1)
        ex_out = _AllToAll.apply(ex_out.contiguous(), group)   # by owner
        return torch.einsum("tec,ecd->td", combine,
                            ex_out.reshape(e, capacity, -1))

    return moe
