"""FSDP / ZeRO: parameters and optimizer state sharded over the ranks
(the JAX package's ``parallel/fsdp.py``).

The JAX package pins a ``PartitionSpec`` on every leaf (``fsdp_spec``:
the largest axis that divides by the world) and lets GSPMD build the
ZeRO-3 schedule. Here the schedule is written out with explicit
collectives over a ``torch.distributed`` group:

- every rank holds the ``fsdp_spec`` shard of every parameter (the JAX
  leaf's axis, mapped to the port tensor's dim: the same rows of the
  same leaf as the JAX device of that rank) and the optimizer runs on
  those shards, so its state is sharded too; a leaf no axis of which
  divides stays whole on every rank (small biases), as JAX replicates
  it;
- the gradients of the full parameters are reduce-scattered to the
  shards as a mean (each rank's gradient divided by the world, then
  summed: the order of DDP's default hook), the replicated leaves'
  all-reduced in the same order;
- after the update (and the latent clamp, on the shards) the shards are
  all-gathered back into the model's full parameters, which the next
  forward and backward read, evaluation and checkpoints too.

The optimizer's norms over a whole leaf or the whole tree (global-norm
clipping; LARS's and LAMB's trust ratios) see the leaf, not the shard:
``FsdpShards.sq_norms`` all-reduces the shards' partial sums of squares
(a replicated leaf counts once).

Collectives add their bytes to a ``WireBytes`` counter: the
reduce-scatter (N-1)/N of its input, the all-gather the other ranks'
parts of its output, a replicated leaf's all-reduce as a ring; in all
``CommPlan(mode="fp32", layout="fsdp")``'s bytes a step.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..interop import JaxFlatOrder, port_dim, to_flax_layout
from ..ops.comm_compress import WireBytes, _count
from ..ops.losses import cross_entropy_loss


def fsdp_spec(shape: Sequence[int], n_shards: int) -> Optional[int]:
    """The axis of a leaf of ``shape`` (its JAX layout) that ``n_shards``
    ranks shard: the largest axis that divides by ``n_shards`` (the first
    of equal ones), or None (replicated: no axis divides, or a scalar).
    JAX's ``fsdp_spec`` puts ``"data"`` at that axis of a
    ``PartitionSpec``."""
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % n_shards == 0 and shape[i] >= n_shards:
            return i
    return None


def _flax_shapes(model: torch.nn.Module) -> Dict[torch.nn.Parameter,
                                                 Tuple[int, ...]]:
    kinds = JaxFlatOrder(model).kinds()
    return {p: tuple(to_flax_layout(torch.empty(p.shape, device="meta"),
                                    kinds[p]).shape)
            for p in model.parameters()}


def fsdp_memory_fraction(model: torch.nn.Module, n_shards: int) -> float:
    """The fraction of the parameters' elements each rank holds under
    FSDP (1/N in the limit; more when small leaves stay replicated), as
    the JAX ``fsdp_memory_fraction``."""
    total = local = 0
    for shape in _flax_shapes(model).values():
        size = 1
        for s in shape:
            size *= s
        total += size
        local += (size if fsdp_spec(shape, n_shards) is None
                  else size // n_shards)
    return local / max(total, 1)


class FsdpShards:
    """This rank's shards of ``model``'s parameters over ``group`` (the
    default group when None), in ``model.parameters()`` order.

    ``tensors`` are the shards (the optimizer's parameters); ``dims``
    each one's sharded dim of the port tensor (None: a replicated
    leaf). ``reduce_grads`` fills every shard's ``.grad`` from the full
    parameters' gradients; ``gather`` writes the shards back into the
    full parameters."""

    def __init__(self, model: torch.nn.Module, group=None,
                 wire: Optional[WireBytes] = None):
        self.group = dist.group.WORLD if group is None else group
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.wire = WireBytes() if wire is None else wire
        shapes = _flax_shapes(model)
        kinds = JaxFlatOrder(model).kinds()
        self.params: List[torch.nn.Parameter] = list(model.parameters())
        self.dims: List[Optional[int]] = []
        for p in self.params:
            axis = fsdp_spec(shapes[p], self.world)
            self.dims.append(None if axis is None
                             else port_dim(kinds[p], p.dim(), axis))
        self._dim = dict(zip(self.params, self.dims))
        self.tensors: List[torch.Tensor] = [
            self.slice_leaf(p, p) for p in self.params]
        self._shard_of = dict(zip(self.params, self.tensors))
        self._sharded = {id(s) for s, d in zip(self.tensors, self.dims)
                         if d is not None}

    # -- layout ----------------------------------------------------------

    def shard_of(self, p: torch.Tensor) -> torch.Tensor:
        """The shard of full parameter ``p``."""
        return self._shard_of[p]

    def slice_leaf(self, p: torch.Tensor, full: torch.Tensor
                   ) -> torch.Tensor:
        """This rank's shard of ``full``, a tensor shaped like parameter
        ``p`` (a new contiguous tensor; the whole of it when ``p`` is
        replicated)."""
        dim = self._dim[p]
        if dim is None:
            return full.detach().clone()
        k = full.shape[dim] // self.world
        return full.detach().narrow(dim, self.rank * k, k).contiguous()

    def gather_leaf(self, p: torch.Tensor, shard: torch.Tensor
                    ) -> torch.Tensor:
        """The full tensor of the shards of ``shard`` (shaped like ``p``'s
        shard) over the group: collective for a sharded leaf; a
        replicated leaf's own copy."""
        dim = self._dim[p]
        if dim is None:
            return shard.detach().clone()
        moved = shard.detach().movedim(dim, 0).contiguous()
        out = moved.new_empty((self.world * moved.shape[0],
                               *moved.shape[1:]))
        dist.all_gather_into_tensor(out, moved, group=self.group)
        return out.movedim(0, dim).contiguous()

    # -- the step's collectives -------------------------------------------

    def _parts(self):
        sharded = [(p, d, s) for p, d, s in zip(self.params, self.dims,
                                                self.tensors)
                   if d is not None]
        whole = [(p, s) for p, d, s in zip(self.params, self.dims,
                                           self.tensors) if d is None]
        return sharded, whole

    def reduce_grads(self) -> None:
        """Every shard's ``.grad``: the mean over the group of the full
        parameters' gradients, this rank's part of it (a parameter with
        no gradient gives its shard none)."""
        sharded, whole = self._parts()
        world = self.world
        sharded = [(p, d, s) for p, d, s in sharded if p.grad is not None]
        whole = [(p, s) for p, s in whole if p.grad is not None]
        if sharded:
            rows = torch.cat([p.grad.movedim(d, 0).reshape(world, -1)
                              for p, d, _ in sharded], dim=1).div_(world)
            out = rows.new_empty(rows.shape[1])
            dist.reduce_scatter_tensor(out, rows.reshape(-1),
                                       group=self.group)
            _count(self.wire, "inter", "rs",
                   (world - 1) * rows.nbytes // world)
            pieces = out.split([s.numel() for _, _, s in sharded])
            for (p, d, s), piece in zip(sharded, pieces):
                moved = s.movedim(d, 0).shape
                s.grad = piece.view(moved).movedim(0, d).contiguous()
        if whole:
            flat = torch.cat([p.grad.reshape(-1)
                              for p, _ in whole]).div_(world)
            dist.all_reduce(flat, group=self.group)
            rs = (world - 1) * flat.nbytes // world
            _count(self.wire, "inter", "rs", rs)
            _count(self.wire, "inter", "ag",
                   2 * (world - 1) * flat.nbytes // world - rs)
            for (p, s), piece in zip(whole, flat.split(
                    [s.numel() for _, s in whole])):
                s.grad = piece.view_as(s)

    @torch.no_grad()
    def gather(self) -> None:
        """The shards, all-gathered into the model's full parameters (one
        collective); each replicated leaf is copied from its own."""
        sharded, whole = self._parts()
        world = self.world
        if sharded:
            flat = torch.cat([s.movedim(d, 0).reshape(-1)
                              for _, d, s in sharded])
            out = flat.new_empty(world * flat.numel())
            dist.all_gather_into_tensor(out, flat, group=self.group)
            _count(self.wire, "inter", "ag", (world - 1) * flat.nbytes)
            rows = out.view(world, -1)
            pieces = rows.split([s.numel() for _, _, s in sharded], dim=1)
            for (p, d, s), piece in zip(sharded, pieces):
                moved = s.movedim(d, 0).shape
                p.copy_(piece.reshape(world * moved[0], *moved[1:])
                        .movedim(0, d))
        for p, s in whole:
            p.copy_(s)

    @torch.no_grad()
    def load_full(self) -> None:
        """Re-cut every shard from the model's full parameters (after a
        restore wrote them)."""
        for p, s in zip(self.params, self.tensors):
            s.copy_(self.slice_leaf(p, p))

    # -- norms over whole leaves ------------------------------------------

    def sq_norms(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[torch.Tensor]:
        """The sums of squares of whole leaves: for each ``(shard, t)``,
        ``t`` shaped like ``shard``, the sum over the group for a sharded
        leaf (one all-reduce for all of them), the local sum for a
        replicated one."""
        sums = [torch.sum(t * t) for _, t in pairs]
        idx = [i for i, (s, _) in enumerate(pairs) if id(s) in self._sharded]
        if idx:
            part = torch.stack([sums[i] for i in idx])
            dist.all_reduce(part, group=self.group)
            for i, v in zip(idx, part.unbind()):
                sums[i] = v
        return sums


def make_fsdp_train_step(clamp_mask: Dict[str, torch.Tensor],
                         model: torch.nn.Module, shards: FsdpShards, *,
                         loss_fn: Callable = cross_entropy_loss,
                         grad_accum: int = 1, remat: bool = False,
                         augment: bool = False) -> Callable:
    """The JAX ``make_fsdp_train_step`` over ``shards`` (the ZeRO-3
    schedule, see the module docstring): ``step(model, optimizer, images,
    labels, scalars=None) -> (loss, accuracy)`` on this rank's rows, the
    optimizer built over ``shards.tensors`` (``Trainer`` with
    ``dp_mode="fsdp"``). BatchNorm normalises over the global batch, as
    GSPMD's step does; ``grad_accum`` and ``remat`` are the single-device
    body's; ``augment`` crops the global batch, as the GSPMD step's
    (``train.trainer.augment_batch``)."""
    from ..train.trainer import (
        augment_batch,
        check_step_options,
        forward_backward,
    )
    from .data_parallel import _mean_metrics, set_batchnorm_group

    check_step_options(grad_accum)

    group = shards.group
    if shards.world > 1:
        set_batchnorm_group(model, group)
    latents = [shards.shard_of(p) for p in clamp_mask.values()]

    def fsdp_step(m: torch.nn.Module, optimizer, images: torch.Tensor,
                  labels: torch.Tensor,
                  scalars: Optional[torch.Tensor] = None):
        from ..train.trainer import clamp_latent

        if m is not model:
            raise ValueError("the FSDP step was built for another model")
        m.train()
        if augment:
            images = augment_batch(m, images, group=group,
                                   microbatches=grad_accum)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = forward_backward(m, images, labels, loss_fn=loss_fn,
                                     grad_accum=grad_accum, remat=remat)
        shards.reduce_grads()
        optimizer.step(scalars=scalars)
        clamp_latent(latents)
        shards.gather()
        return _mean_metrics(loss, acc, group)

    return fsdp_step
