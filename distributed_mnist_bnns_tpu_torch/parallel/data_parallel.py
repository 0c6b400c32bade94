"""Data parallelism: the torch counterpart of the JAX package's
``parallel/data_parallel.py`` (DistributedDataParallel +
DistributedSampler of the reference, ``mnist-dist2.py:93,100-102``).

Each rank is a process; every function here runs in every rank of the
group, in the same order. The steps keep the single-device step's call,
``step(model, optimizer, images, labels) -> (loss, accuracy)``, on this
rank's rows of the global batch (``shard_batch``), and return the loss
and accuracy averaged over the ranks (0-d tensors, no host sync). Each
takes ``scalars`` (the optimizer's row of a captured step), and
``grad_accum``, ``remat`` and ``augment`` as the single-device step body
does (the GSPMD steps crop the global batch, the others each rank's
rows).

  make_dp_train_step            the JAX GSPMD step: BatchNorm over the
                                global batch, gradients averaged in
                                DDP's order (``all_reduce_grads``)
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
  make_compressed_fsdp_train_step
                                the compressed step over the 1-bit FSDP
                                exchange (``train.optim.SignCompressFsdp``)
  parallel.fsdp.make_fsdp_train_step
                                fp32 FSDP (ZeRO-3, explicit collectives)

Every collective of a step runs in every rank in the same order and
none depends on the data, so a step captures into a CUDA graph over
NCCL (``train.capture.TrainScan``).

Each step's collectives add their bytes to the ``WireBytes`` counter it
is given (the compressed steps count through their transform).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.layers import BatchNorm
from ..ops.comm_compress import (
    WireBytes,
    _count,
    all_reduce_mean,
    all_reduce_sum,
    broadcast,
)
from ..ops.losses import cross_entropy_loss


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


def shard_batch(x, group=None, *, microbatches: int = 1, dim: int = 0):
    """This rank's rows ``[r B/W, (r+1) B/W)`` of the global batch ``x``
    along ``dim`` (a tensor or array; the JAX ``P("data")`` split:
    contiguous, not ``data.shard_indices``' rank-strided one).

    ``microbatches=N``: the batch is N microbatches of B/N rows, and this
    rank takes its rows of each in turn, so that splitting its rows in N
    gives its share of every global microbatch (a GSPMD step's
    ``grad_accum``, whose BatchNorm sees the global microbatch)."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    n = x.shape[dim]
    if n % (world * microbatches):
        raise ValueError(f"batch of {n} not divisible by "
                         f"data_parallel={world}"
                         + (f" x grad_accum={microbatches}"
                            if microbatches > 1 else ""))
    per = n // (world * microbatches)
    head = x.shape[:dim]
    rows = x.reshape(*head, microbatches, world, per, *x.shape[dim + 1:])
    index = (slice(None),) * (dim + 1) + (rank,)
    return rows[index].reshape(*head, microbatches * per,
                               *x.shape[dim + 1:])


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


def _mean_metrics(loss: torch.Tensor, acc: torch.Tensor, group):
    """(loss, accuracy), each averaged over the group."""
    m = all_reduce_mean(torch.stack([loss, acc]), group)
    return m[0], m[1]


def all_reduce_grads(params: List[torch.Tensor], group,
                     wire: Optional[WireBytes] = None) -> None:
    """Replace every gradient of ``params`` by its mean over the group,
    in DDP's default hook's order (each rank's gradients divided by the
    world, then one all-reduce sum of them laid end to end); counted as
    a ring all-reduce of that buffer."""
    params = [p for p in params if p.grad is not None]
    world = dist.get_world_size(group)
    flat = torch.cat([p.grad.reshape(-1) for p in params]).div_(world)
    dist.all_reduce(flat, group=group)
    rs = (world - 1) * flat.nbytes // world
    _count(wire, "inter", "rs", rs)
    _count(wire, "inter", "ag", 2 * (world - 1) * flat.nbytes // world - rs)
    with torch.no_grad():
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p.grad))


def make_dp_train_step(clamp_mask: Dict[str, torch.Tensor],
                       model: torch.nn.Module, *, group=None,
                       loss_fn: Callable = cross_entropy_loss,
                       wire: Optional[WireBytes] = None,
                       grad_accum: int = 1, remat: bool = False,
                       augment: bool = False) -> Callable:
    """The JAX GSPMD step (``make_dp_train_step``, :107): ``model``'s
    BatchNorms normalise over the global batch (at world 1 the global
    batch is this rank's), and each rank's gradients of its local mean
    loss are averaged in DDP's order (``all_reduce_grads``: the
    reduction of DistributedDataParallel written out, so that the step
    is the same eager or captured in a CUDA graph). The BatchNorm's
    all-reduce sums its cotangent over the ranks, so the average is the
    gradient of the global batch's mean loss; the running statistics
    come out equal on every rank.

    ``grad_accum`` and ``remat`` are the single-device body's
    (``train.trainer.forward_backward``); under ``grad_accum`` each
    microbatch is a slice of the global batch, so this rank's rows are
    ``shard_batch(..., microbatches=grad_accum)``'s. ``augment``: the
    crops of the global batch, as the JAX GSPMD body draws them, every
    rank from its alike-seeded ``augment_generator`` keeping its rows
    (``train.trainer.augment_batch``)."""
    from ..train.trainer import (
        augment_batch,
        check_step_options,
        clamp_latent,
        forward_backward,
    )

    check_step_options(grad_accum)
    group = dist.group.WORLD if group is None else group
    if dist.get_world_size(group) > 1:
        set_batchnorm_group(model, group)
    latents = list(clamp_mask.values())

    def dp_step(m: torch.nn.Module, optimizer: torch.optim.Optimizer,
                images: torch.Tensor, labels: torch.Tensor,
                scalars: Optional[torch.Tensor] = None):
        if m is not model:
            raise ValueError("the DP step was built for another model")
        m.train()
        if augment:
            images = augment_batch(m, images, group=group,
                                   microbatches=grad_accum)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = forward_backward(m, images, labels, loss_fn=loss_fn,
                                     grad_accum=grad_accum, remat=remat)
        all_reduce_grads(list(m.parameters()), group, wire)
        optimizer.step(scalars=scalars)
        clamp_latent(latents)
        return _mean_metrics(loss, acc, group)

    return dp_step


def make_shardmap_dp_train_step(clamp_mask: Dict[str, torch.Tensor], *,
                                group=None,
                                loss_fn: Callable = cross_entropy_loss,
                                wire: Optional[WireBytes] = None,
                                grad_accum: int = 1, remat: bool = False,
                                augment: bool = False) -> Callable:
    """The JAX shard_map step (``make_shardmap_dp_train_step``, :137):
    BatchNorm over each rank's rows, the gradients laid end to end and
    averaged in one fp32 all-reduce (summed, then divided), the
    running statistics averaged after the step. ``grad_accum`` splits
    this rank's rows; ``remat`` as the single-device body's;
    ``augment`` crops this rank's rows from its own generator."""
    from ..train.trainer import (
        augment_batch,
        check_step_options,
        clamp_latent,
        forward_backward,
    )

    check_step_options(grad_accum)
    group = dist.group.WORLD if group is None else group
    latents = list(clamp_mask.values())

    def shardmap_step(model: torch.nn.Module,
                      optimizer: torch.optim.Optimizer,
                      images: torch.Tensor, labels: torch.Tensor,
                      scalars: Optional[torch.Tensor] = None):
        model.train()
        if augment:
            images = augment_batch(model, images)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = forward_backward(model, images, labels, loss_fn=loss_fn,
                                     grad_accum=grad_accum, remat=remat)
        params = [p for p in model.parameters() if p.grad is not None]
        flat = all_reduce_mean(torch.cat([p.grad.reshape(-1)
                                          for p in params]), group, wire)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p.grad))
        metrics = _mean_metrics(loss, acc, group)
        average_batch_stats(model, group)
        optimizer.step(scalars=scalars)
        clamp_latent(latents)
        return metrics

    return shardmap_step


def make_compressed_dp_train_step(clamp_mask: Dict[str, torch.Tensor], *,
                                  group=None,
                                  loss_fn: Callable = cross_entropy_loss,
                                  grad_accum: int = 1, remat: bool = False,
                                  augment: bool = False) -> Callable:
    """The JAX compressed step (``make_compressed_dp_train_step``,
    :274): the single-device step body on each rank's rows, with no
    gradient all-reduce: the optimizer's ``sign_compress`` transform
    runs the 1-bit exchange, and it is the reduction. Metrics and
    running statistics take the plain fp32 mean over ``group``.
    ``grad_accum`` splits this rank's rows (the JAX body runs inside the
    shard_map); ``remat`` as the single-device body's. ``augment`` crops
    this rank's rows from its own generator, as the JAX body inside the
    shard_map draws its shard's from the key folded with the axis index.

    The same step runs the compressed FSDP exchange
    (``make_compressed_fsdp_train_step``): only the optimizer differs."""
    from ..train.trainer import (
        augment_batch,
        check_step_options,
        clamp_latent,
        forward_backward,
    )

    check_step_options(grad_accum)
    group = dist.group.WORLD if group is None else group
    latents = list(clamp_mask.values())

    def compressed_step(model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer,
                        images: torch.Tensor, labels: torch.Tensor,
                        scalars: Optional[torch.Tensor] = None):
        if optimizer.comm_transform() is None:
            raise ValueError("the compressed step needs an optimizer with "
                             "a sign_compress grad_transform or a "
                             "sign_compress_fsdp exchange")
        model.train()
        if augment:
            images = augment_batch(model, images)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = forward_backward(model, images, labels, loss_fn=loss_fn,
                                     grad_accum=grad_accum, remat=remat)
        optimizer.step(scalars=scalars)
        clamp_latent(latents)
        metrics = _mean_metrics(loss, acc, group)
        average_batch_stats(model, group)
        return metrics

    return compressed_step


def make_compressed_hier_train_step(clamp_mask: Dict[str, torch.Tensor], *,
                                    group=None,
                                    loss_fn: Callable = cross_entropy_loss,
                                    grad_accum: int = 1, remat: bool = False,
                                    augment: bool = False) -> Callable:
    """The JAX two-level step (``make_compressed_hier_train_step``,
    :313): as ``make_compressed_dp_train_step`` over every rank of
    ``group`` (hosts x local), the optimizer's transform built with the
    in-host ``local_group`` (fp32 mean first) and the inter-host
    ``group``. The step itself holds no gradient collective."""
    return make_compressed_dp_train_step(clamp_mask, group=group,
                                         loss_fn=loss_fn,
                                         grad_accum=grad_accum, remat=remat,
                                         augment=augment)


def make_compressed_fsdp_train_step(clamp_mask: Dict[str, torch.Tensor], *,
                                    group=None,
                                    loss_fn: Callable = cross_entropy_loss,
                                    grad_accum: int = 1, remat: bool = False,
                                    augment: bool = False) -> Callable:
    """The JAX compressed FSDP step (``make_compressed_fsdp_train_step``,
    :397): the compressed step's shape; the ZeRO part lives in the
    optimizer (``train.optim.SignCompressFsdp``: the 1-bit
    reduce-scatter to segment owners, the base optimizer on the owner's
    segment and moment rows, the 1-bit all-gather of the update)."""
    return make_compressed_dp_train_step(clamp_mask, group=group,
                                         loss_fn=loss_fn,
                                         grad_accum=grad_accum, remat=remat,
                                         augment=augment)


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s train-mode generator, drawn from
    ``(seed, rank)`` (JAX folds the axis index into the dropout key)."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])
