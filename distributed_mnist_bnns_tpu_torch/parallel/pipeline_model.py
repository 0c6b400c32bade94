"""Pipeline-parallel transformer models: the model-level layer over
``parallel.pipeline``'s GPipe schedule (the JAX package's
``parallel/pipeline_model.py``).

Stage ``s`` of ``n_stages`` holds blocks ``[s * depth / n_stages, (s+1)
* depth / n_stages)`` of a ``BinarizedLM`` or ``BinarizedTransformer``
(the ViT) and only those (``PipelinedModel``, built from the full model:
each stage's block parameters, and the optimizer moments built over
them, live only on that stage's ranks). The embedding and the head stay
replicated outside the pipeline, as in JAX: every pipe rank embeds the
batch (only stage 0's enters the pipeline) and runs the head and the
loss on the pipeline's replicated output. After the backward,
``sync_grads`` sums the embedding side's gradients over the pipe group
(they exist on stage 0 only; the other ranks' embeddings would never
move); the head's are equal on every pipe rank already.

The batch is padded to a multiple of ``n_micro`` (a trailing eval batch)
and the padding sliced off. In train mode with dropout each step draws
its seed from the model's own CPU generator (``train_generator``, seeded
with the model's ``rng_seed``), and each (stage, microbatch) cell draws
from ``pipeline.cell_generator`` of it: a stage's blocks draw in turn
from the cell's generator. The draws differ from the sequential model's
stream (so does JAX's from flax's); the contract is schedule invariance.

Parameter layout: a pipelined checkpoint holds JAX's ``{"blocks":
stage-major stacked block params (depth, ...), "rest": everything
else}``; ``split_block_params`` / ``merge_block_params`` convert nested
dicts between that and the sequential layout, and ``PipelinedModel`` is
the ``interop.Layout`` that gathers the stacked blocks from the stages
(and cuts them back on a restore).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from ..interop import Layout, _paths, from_flax_layout, to_flax_layout
from ..models.transformer import BinarizedLM, BinarizedTransformer
from ..ops import remat
from ..ops.comm_compress import WireBytes, _count
from ..ops.losses import cross_entropy_loss
from .mesh import Mesh, comm_span
from .pipeline import Schedule, cell_generator, run_pipeline

_BLOCK = "TransformerBlock_"


def _stack(leaves):
    if torch.is_tensor(leaves[0]):
        return torch.stack(leaves)
    return np.stack([np.asarray(v) for v in leaves])


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def split_block_params(params: Dict) -> Tuple[Any, Dict, List[str]]:
    """Sequential params -> (stacked blocks, rest, block names): the
    stacked tree's leaves get a leading ``depth`` axis in block order;
    ``rest`` holds the embeddings, the final norm and the head."""
    names = sorted((k for k in params if k.startswith(_BLOCK)),
                   key=lambda k: int(k.rsplit("_", 1)[1]))
    if not names:
        raise ValueError("params contain no TransformerBlock_* submodules")
    stacked = _tree_map(lambda *xs: _stack(xs), *(params[n] for n in names))
    rest = {k: v for k, v in params.items() if k not in set(names)}
    return stacked, rest, names


def merge_block_params(stacked: Any, rest: Dict, names: List[str]) -> Dict:
    """Inverse of ``split_block_params``."""
    out = dict(rest)
    for i, n in enumerate(names):
        out[n] = _tree_map(lambda x, i=i: x[i], stacked)
    return out


def pipeline_params(params: Dict) -> Dict:
    """Sequential params -> the pipelined layout {"blocks", "rest"}."""
    stacked, rest, _ = split_block_params(params)
    return {"blocks": stacked, "rest": rest}


def sequential_params(pipelined: Dict, depth: int) -> Dict:
    """The pipelined layout -> sequential params."""
    names = [f"{_BLOCK}{i}" for i in range(depth)]
    return merge_block_params(pipelined["blocks"], pipelined["rest"], names)


class _Stage(nn.Module):
    """This stage's blocks, applied in turn (dropout from ``gen``)."""

    def __init__(self, blocks):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, gen=None):
        for blk in self.blocks:
            x = blk(x, gen)
        return x


class PipelinedModel(Layout, nn.Module):
    """``model`` (a ``BinarizedLM`` or ``BinarizedTransformer``) with its
    block stack run as a GPipe pipeline over ``mesh``'s ``axis``: this
    rank keeps the embedding, the head and its stage's blocks (the
    others are dropped). ``forward(x[, seed])`` is the model's forward;
    in train mode with dropout the step's seed is drawn from
    ``train_generator`` unless given. ``n_micro=0`` is one microbatch a
    stage. ``batch_axis``: DP x PP, ``x`` this data row's rows (the row
    seeds its cells first). ``stage_remat``: each cell checkpointed.
    ``wire`` counts the pipe group's bytes."""

    def __init__(self, model: nn.Module, mesh: Mesh, *, axis: str = "pipe",
                 n_micro: int = 0, batch_axis: Optional[str] = None,
                 stage_remat: bool = False,
                 wire: Optional[WireBytes] = None):
        nn.Module.__init__(self)
        if not isinstance(model, (BinarizedTransformer, BinarizedLM)):
            raise ValueError(
                "pipeline parallelism supports the transformer families "
                f"(BinarizedTransformer / BinarizedLM), got "
                f"{type(model).__name__}")
        n_stages = mesh.size(axis)
        depth = model.depth
        if depth % n_stages:
            raise ValueError(f"model depth {depth} not divisible by "
                             f"pipeline stages {n_stages}")
        self.sched = Schedule(mesh, axis=axis, n_micro=n_micro,
                              batch_axis=batch_axis, wire=wire)
        self.n_micro = self.sched.n_micro
        self.per_stage = depth // n_stages
        self.first = self.sched.stage * self.per_stage
        self.depth = depth
        self.stage_remat = stage_remat
        self.wire = wire
        self.needs_rng = any(blk.drop.rate > 0 for blk in model.blocks)
        local = list(model.blocks)[self.first:self.first + self.per_stage]
        model.blocks = nn.ModuleList()
        self.model = model
        self.stage = _Stage(local)
        self.num_classes = getattr(model, "num_classes", None)
        self._seed_gen = torch.Generator().manual_seed(model.rng_seed)
        self._block_names = [n for n, _ in self.stage.named_parameters()]

    # -- the forward --------------------------------------------------------

    def train_generator(self, device=None) -> torch.Generator:
        """The CPU generator the steps' seeds are drawn from (its state is
        the checkpointed train-time generator of a pipelined run)."""
        return self._seed_gen

    def _run(self, seed: Optional[int]) -> Callable:
        sched = self.sched

        def cell(leaves, inp, m):
            gen = (None if seed is None else cell_generator(
                seed, m, sched.stage, inp.device, sched.row))
            return functional_call(
                self.stage, dict(zip(self._block_names, leaves)),
                (inp, gen))

        def run(leaves, inp, m):
            if self.stage_remat and torch.is_grad_enabled():
                return remat.checkpoint(lambda i: cell(leaves, i, m), inp)
            return cell(leaves, inp, m)

        return run

    def forward(self, x: torch.Tensor,
                seed: Optional[int] = None) -> torch.Tensor:
        b = x.shape[0]
        pad = (-b) % self.n_micro
        if pad:
            x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])
        h = self.model.embed_tokens(x)
        if self.training and self.needs_rng and seed is None:
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self._seed_gen))
        if not (self.training and self.needs_rng):
            seed = None
        y = run_pipeline(self.sched, self._run(seed), h,
                         list(self.stage.parameters()))
        return self.model.head_out(y)[:b]

    def _pre_params(self) -> List[nn.Parameter]:
        """The parameters upstream of the pipeline (the embeddings)."""
        m = self.model
        first = (m.tok_embed if isinstance(m, BinarizedLM)
                 else m.patch_embed)
        return list(first.parameters()) + [m.pos_embed]

    def sync_grads(self) -> None:
        """Sum the embedding side's gradients over the pipe group (only
        stage 0's are not zero), so every pipe rank's copy moves alike."""
        params = [p for p in self._pre_params() if p.grad is not None]
        n = self.sched.n_stages
        if n == 1 or not params:
            return
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        with comm_span("pipe", flat):
            dist.all_reduce(flat, group=self.sched.group)
        _count(self.wire, "pipe", "grad", 2 * (n - 1) * flat.nbytes // n)
        with torch.no_grad():
            for p, g in zip(params, flat.split([p.numel() for p in params])):
                p.grad.copy_(g.view_as(p.grad))

    # -- the flax layout (interop.Layout) ----------------------------------

    def leaves(self, coll: str):
        """``("rest", ...)`` leaves of the embedding and head, then
        ``("blocks", ...)`` leaves, each the list of this stage's blocks'
        tensors (stacked over the whole depth by ``full``)."""
        if coll != "params":
            return
        for path, name, _, kind in _paths(self.model, "params"):
            yield ("rest", *path), [self.model.get_parameter(name)], kind
        blocks = list(self.stage.blocks)
        for path, name, _, kind in _paths(blocks[0], "params"):
            yield (("blocks", *path),
                   [b.get_parameter(name) for b in blocks], kind)

    def full(self, tensors, values, kind):
        if not self._is_block(tensors[0]):
            return Layout.full(self, tensors, values, kind)
        if values is None:
            shape = to_flax_layout(torch.empty(tensors[0].shape,
                                               device="meta"), kind).shape
            return torch.empty((self.depth, *shape),
                               dtype=tensors[0].dtype, device="meta")
        local = torch.stack([to_flax_layout(v, kind) for v in values])
        n = self.sched.n_stages
        if n == 1:
            return local
        out = local.new_empty((n * local.shape[0], *local.shape[1:]))
        dist.all_gather_into_tensor(out, local.contiguous(),
                                    group=self.sched.group)
        return out

    def split(self, tensors, full, kind):
        if not self._is_block(tensors[0]):
            return Layout.split(self, tensors, full, kind)
        rows = full[self.first:self.first + self.per_stage]
        return [from_flax_layout(r, kind) for r in rows]

    def bn_counters(self):
        return []

    def flax_params(self) -> Dict[str, Any]:
        """The pipelined params tree ``{"blocks", "rest"}``, full leaves
        in flax's layout (the blocks gathered from the stages:
        collective)."""
        from ..interop import _layout_tree

        return _layout_tree(self, "params", torch.Tensor.detach)

    def _is_block(self, t: torch.Tensor) -> bool:
        return any(t is p for p in self.stage.parameters())


def make_pipelined_apply(model: nn.Module, mesh: Mesh, depth: int, *,
                         axis: str = "pipe", n_micro: int = 0,
                         batch_axis: Optional[str] = None,
                         stage_remat: bool = False,
                         wire: Optional[WireBytes] = None) -> Callable:
    """The JAX ``make_pipelined_apply``: ``apply_fn(x, train=False,
    seed=None)`` running ``model``'s block stack pipelined over
    ``axis`` (``PipelinedModel``, as ``apply_fn.module``; ``model`` keeps
    only this stage's blocks afterwards). A train call of a model with
    dropout needs the step's ``seed`` (JAX's ``rngs``)."""
    if getattr(model, "depth", depth) != depth:
        raise ValueError(f"depth {depth} is not the model's "
                         f"{model.depth}")
    pm = PipelinedModel(model, mesh, axis=axis, n_micro=n_micro,
                        batch_axis=batch_axis, stage_remat=stage_remat,
                        wire=wire)

    def apply_fn(x: torch.Tensor, train: bool = False,
                 seed: Optional[int] = None) -> torch.Tensor:
        if train and pm.needs_rng and seed is None:
            raise ValueError("pipelined train step with dropout needs the "
                             "step's seed (JAX: rngs={'dropout': key})")
        pm.train(train)
        return pm(x, seed)

    apply_fn.module = pm
    return apply_fn


def place_pipelined_state(model: nn.Module, mesh: Mesh,
                          **kw) -> PipelinedModel:
    """``model`` as this rank's stage of a pipeline over ``mesh``
    (``PipelinedModel``): an optimizer built over its parameters keeps
    this stage's block moments only, as JAX's placement shards them
    stage-major over the pipe axis."""
    return PipelinedModel(model, mesh, **kw)


def make_pp_train_step(clamp_mask: Dict[str, torch.Tensor],
                       model: PipelinedModel, data_group=None, *,
                       loss_fn: Callable = cross_entropy_loss,
                       wire: Optional[WireBytes] = None,
                       grad_accum: int = 1) -> Callable:
    """The pipelined train step (the JAX step body over the pipelined
    apply): ``step(model, optimizer, images, labels, scalars=None) ->
    (loss, accuracy)`` on this data row's rows. Forward and backward run
    the pipeline; the embedding's gradients are summed over the pipe
    group (``sync_grads``), every gradient averaged over the data group
    in DDP's order, the optimizer (over this stage's parameters and the
    replicated rest) steps and the latents are clamped. ``grad_accum``
    is the single-device body's (each microbatch a pipelined forward)."""
    from ..train.trainer import (
        check_step_options,
        clamp_latent,
        forward_backward,
    )
    from .data_parallel import _mean_metrics, all_reduce_grads

    check_step_options(grad_accum)
    dp = 1 if data_group is None else dist.get_world_size(data_group)
    latents = list(clamp_mask.values())

    def pp_step(m: nn.Module, optimizer, images: torch.Tensor,
                labels: torch.Tensor,
                scalars: Optional[torch.Tensor] = None):
        if m is not model:
            raise ValueError("the pipelined step was built for another "
                             "model")
        m.train()
        optimizer.zero_grad(set_to_none=True)
        loss, acc = forward_backward(m, images, labels, loss_fn=loss_fn,
                                     grad_accum=grad_accum)
        m.sync_grads()
        if dp > 1:
            all_reduce_grads(list(m.parameters()), data_group, wire)
        optimizer.step(scalars=scalars)
        clamp_latent(latents)
        return (_mean_metrics(loss, acc, data_group) if dp > 1
                else (loss, acc))

    return pp_step
