"""MoE routing: the dispatch and combine tensors, and the router's
load-balancing objective (the JAX package's ``ops/routing.py``).

Static shapes only (one-hot, cumsum, products; no ``nonzero``, boolean
indexing or host sync), so a step that routes captures into a CUDA
graph. ``torch.argmax`` returns the first maximal index, as
``jnp.argmax`` does, so ties break the same way.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: a compare against ``arange(n)`` (no range check,
    so nothing syncs with the host)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def top1_dispatch(gates: torch.Tensor, capacity: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-1 routing with capacity-bounded one-hot dispatch. gates: (T, E)
    router probabilities. Returns (dispatch, combine), both (T, E, C):
    dispatch is the 0/1 token->slot assignment (tokens past ``capacity``
    of an expert are dropped, in token order); combine is dispatch
    scaled by the chosen expert's gate."""
    _, e = gates.shape
    onehot = _one_hot(gates.argmax(dim=-1), e, gates.dtype)       # (T, E)
    pos = torch.cumsum(onehot, dim=0) * onehot   # 1-based arrival
    keep = (pos > 0) & (pos <= capacity)
    slot = torch.where(keep, pos - 1, 0).long()
    dispatch = (keep.to(gates.dtype)[..., None]
                * _one_hot(slot, capacity, gates.dtype))          # (T, E, C)
    gate_val = torch.sum(gates * onehot, dim=-1)
    return dispatch, gate_val[:, None, None] * dispatch


def topk_dispatch(gates: torch.Tensor, capacity: int, k: int = 2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard top-k routing with capacity bounds. Each token goes to its
    k highest-gate experts, weighted by the chosen gates renormalized
    over its k choices (``/ (sum + 1e-9)``). Slots fill choice-major
    (everyone's first choice before anyone's second), each choice in
    token order; a choice past ``capacity`` is dropped. Returns
    (dispatch, combine), both (T, E, C)."""
    t, e = gates.shape
    if k < 1 or k > e:
        raise ValueError(f"top-k needs 1 <= k <= {e}, got {k}")
    remaining = gates
    chosen = []
    for _ in range(k):
        onehot = _one_hot(remaining.argmax(dim=-1), e, gates.dtype)
        chosen.append((torch.sum(gates * onehot, dim=-1), onehot))
        remaining = remaining - onehot * 2.0   # probs <= 1: never again
    denom = sum(gv for gv, _ in chosen) + 1e-9
    counts = gates.new_zeros(e)              # kept slots used per expert
    dispatch = gates.new_zeros(t, e, capacity)
    combine = gates.new_zeros(t, e, capacity)
    for gv, onehot in chosen:
        pos = torch.cumsum(onehot, dim=0) * onehot + counts[None, :] * onehot
        keep = (pos > 0) & (pos <= capacity)
        slot = torch.where(keep, pos - 1, 0).long()
        d_j = (keep.to(gates.dtype)[..., None]
               * _one_hot(slot, capacity, gates.dtype))
        dispatch = dispatch + d_j
        combine = combine + (gv / denom)[:, None, None] * d_j
        counts = counts + torch.sum(keep.to(gates.dtype) * onehot, dim=0)
    return dispatch, combine


def load_balance_loss(gates: torch.Tensor) -> torch.Tensor:
    """The Switch Transformer's auxiliary loss ``E * sum_e f_e * p_e``:
    f_e the fraction of tokens whose top-1 choice is expert e, p_e the
    mean router probability of e. 1 at perfect balance, E when routing
    collapses; differentiable through p (f is piecewise constant)."""
    _, e = gates.shape
    f = _one_hot(gates.argmax(dim=-1), e, gates.dtype).mean(dim=0)
    p = gates.mean(dim=0)
    return e * torch.sum(f * p)
