"""Data parallelism: the torch counterpart of the JAX package's
``parallel/data_parallel.py`` (DistributedDataParallel +
DistributedSampler of the reference, ``mnist-dist2.py:93,100-102``).

Each rank is a process; every function here runs in every rank of the
group, in the same order. The steps keep the single-device step's call,
``step(model, optimizer, images, labels) -> (loss, accuracy)``, on this
rank's rows of the global batch (``shard_batch``), and return the loss
and accuracy averaged over the ranks (0-d tensors, no host sync).

  make_dp_train_step            the JAX GSPMD step: BatchNorm over the
                                global batch, gradients reduced by DDP
  make_shardmap_dp_train_step   the JAX shard_map step: per-rank
                                BatchNorm, one fp32 all-reduce mean of
                                the gradients, running statistics averaged
  make_compressed_dp_train_step,
  make_compressed_hier_train_step
                                per-rank BatchNorm, no gradient collective
                                in the step: the optimizer's
                                ``sign_compress`` transform is the
                                reduction (flat, or in-host fp32 then 1-bit
                                across hosts); running statistics averaged

Each step's collectives add their bytes to the ``WireBytes`` counter it
is given (the compressed steps count through their transform).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.layers import BatchNorm
from ..ops.comm_compress import (
    WireBytes,
    all_reduce_mean,
    all_reduce_sum,
    broadcast,
)
from ..ops.losses import cross_entropy_loss
from ..train.trainer import clamp_latent


def replicate(model: torch.nn.Module, group=None) -> None:
    """Broadcast every parameter and buffer from the group's first rank,
    then raise on every rank if any rank held other values: the ranks
    must build the same seeded state (the reference's implicit DDP
    contract, ``mnist-dist2.py:85-93``)."""
    differ = 0
    with torch.no_grad():
        for t in model.state_dict().values():
            src = broadcast(t, group)
            differ += int(not torch.equal(src, t))
            t.copy_(src)
    device = next(model.parameters()).device
    if all_reduce_sum(torch.tensor([float(differ)], device=device),
                      group).item():
        raise ValueError("ranks built different initial states: build "
                         "every rank's model from the same seed")


def shard_batch(x, group=None):
    """This rank's rows ``[r B/W, (r+1) B/W)`` of the global batch ``x``
    (a tensor or array; the JAX ``P("data")`` split: contiguous, not
    ``data.shard_indices``' rank-strided one)."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if len(x) % world:
        raise ValueError(f"batch of {len(x)} not divisible by "
                         f"data_parallel={world}")
    per = len(x) // world
    return x[rank * per:(rank + 1) * per]


def set_batchnorm_group(model: torch.nn.Module, group) -> None:
    """Normalise every ``models.layers.BatchNorm`` of ``model`` over the
    global batch of ``group`` (None: each rank's own rows)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def average_batch_stats(model: torch.nn.Module, group) -> None:
    """Replace every BatchNorm's running statistics by their mean over
    the group (``pmean(batch_stats)``)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.copy_(all_reduce_mean(m.running_mean, group))
                m.running_var.copy_(all_reduce_mean(m.running_var, group))


def _metrics(outs: torch.Tensor, labels: torch.Tensor, loss: torch.Tensor,
             group):
    """(loss, accuracy in percent), each averaged over the group."""
    outs = outs.detach()
    acc = (outs.argmax(-1) == labels).to(outs.dtype).mean() * 100.0
    m = all_reduce_mean(torch.stack([loss.detach(), acc]), group)
    return m[0], m[1]


def _counting_allreduce_hook(state, bucket):
    """DDP's default all-reduce hook, its bytes counted: (N-1)/N of the
    bucket in each ring phase."""
    from torch.distributed.algorithms.ddp_comm_hooks import default_hooks

    group, wire = state
    world = dist.get_world_size(group)
    nbytes = bucket.buffer().nbytes
    rs = (world - 1) * nbytes // world
    wire[("inter", "rs")] += rs
    wire[("inter", "ag")] += 2 * (world - 1) * nbytes // world - rs
    return default_hooks.allreduce_hook(group, bucket)


def make_dp_train_step(clamp_mask: Dict[str, torch.Tensor],
                       model: torch.nn.Module, *, group=None,
                       loss_fn: Callable = cross_entropy_loss,
                       wire: Optional[WireBytes] = None) -> Callable:
    """The JAX GSPMD step (``make_dp_train_step``, :107): ``model``'s
    BatchNorms normalise over the global batch, and DDP (buffers not
    broadcast: the running statistics come out equal on every rank)
    averages the gradients of each rank's local mean loss. The
    BatchNorm's all-reduce sums its cotangent over the ranks, so the
    average is the gradient of the global batch's mean loss.

    ``model`` is wrapped once here; ``step`` must be given the same
    module."""
    from torch.nn.parallel import DistributedDataParallel

    group = dist.group.WORLD if group is None else group
    set_batchnorm_group(model, group)
    device = next(model.parameters()).device
    # Buffers stay each rank's: the global-batch statistics make them
    # equal.
    ddp = DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        process_group=group, broadcast_buffers=False)
    ddp.register_comm_hook((group, WireBytes() if wire is None else wire),
                           _counting_allreduce_hook)
    latents = list(clamp_mask.values())

    def dp_step(m: torch.nn.Module, optimizer: torch.optim.Optimizer,
                images: torch.Tensor, labels: torch.Tensor):
        if m is not ddp.module:
            raise ValueError("the DP step was built for another model")
        m.train()
        optimizer.zero_grad(set_to_none=True)
        outs = ddp(images)
        loss = loss_fn(outs, labels)
        loss.backward()
        optimizer.step()
        clamp_latent(latents)
        return _metrics(outs, labels, loss, group)

    return dp_step


def make_shardmap_dp_train_step(clamp_mask: Dict[str, torch.Tensor], *,
                                group=None,
                                loss_fn: Callable = cross_entropy_loss,
                                wire: Optional[WireBytes] = None
                                ) -> Callable:
    """The JAX shard_map step (``make_shardmap_dp_train_step``, :137):
    BatchNorm over each rank's rows, the gradients laid end to end and
    averaged in one fp32 all-reduce (DDP's all-reduce made visible), the
    running statistics averaged after the step."""
    group = dist.group.WORLD if group is None else group
    latents = list(clamp_mask.values())

    def shardmap_step(model: torch.nn.Module,
                      optimizer: torch.optim.Optimizer,
                      images: torch.Tensor, labels: torch.Tensor):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        outs = model(images)
        loss = loss_fn(outs, labels)
        loss.backward()
        params = [p for p in model.parameters() if p.grad is not None]
        flat = all_reduce_mean(torch.cat([p.grad.reshape(-1)
                                          for p in params]), group, wire)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p.grad))
        metrics = _metrics(outs, labels, loss, group)
        average_batch_stats(model, group)
        optimizer.step()
        clamp_latent(latents)
        return metrics

    return shardmap_step


def make_compressed_dp_train_step(clamp_mask: Dict[str, torch.Tensor], *,
                                  group=None,
                                  loss_fn: Callable = cross_entropy_loss
                                  ) -> Callable:
    """The JAX compressed step (``make_compressed_dp_train_step``,
    :274): the single-device step body on each rank's rows, with no
    DDP wrapper and no gradient all-reduce: the optimizer's
    ``sign_compress`` transform runs the 1-bit exchange, and it is the
    reduction. Metrics and running statistics take the plain fp32 mean
    over ``group``."""
    group = dist.group.WORLD if group is None else group
    latents = list(clamp_mask.values())

    def compressed_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        images: torch.Tensor, labels: torch.Tensor):
        if getattr(optimizer, "grad_transform", None) is None:
            raise ValueError("the compressed step needs an optimizer with "
                             "a sign_compress grad_transform")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        outs = model(images)
        loss = loss_fn(outs, labels)
        loss.backward()
        optimizer.step()
        clamp_latent(latents)
        metrics = _metrics(outs, labels, loss, group)
        average_batch_stats(model, group)
        return metrics

    return compressed_step


def make_compressed_hier_train_step(clamp_mask: Dict[str, torch.Tensor], *,
                                    group=None,
                                    loss_fn: Callable = cross_entropy_loss
                                    ) -> Callable:
    """The JAX two-level step (``make_compressed_hier_train_step``,
    :313): as ``make_compressed_dp_train_step`` over every rank of
    ``group`` (hosts x local), the optimizer's transform built with the
    in-host ``local_group`` (fp32 mean first) and the inter-host
    ``group``. The step itself holds no gradient collective."""
    return make_compressed_dp_train_step(clamp_mask, group=group,
                                         loss_fn=loss_fn)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s train-mode generator, drawn from
    ``(seed, rank)`` (JAX folds the axis index into the dropout key)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
