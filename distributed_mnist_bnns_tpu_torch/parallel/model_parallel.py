"""Model parallelism: Megatron tensor parallelism over a 'model' axis of
ranks (the JAX package's ``parallel/model_parallel.py``).

The reference's model parallelism places whole layers on two devices
(``Net(dev0, dev1)``, mnist-distributed-BNNS2.py:32-46,193-213). The JAX
package generalises it to Megatron column/row pairs, declared per flax
module path (``tp_rules_by_path`` and the tables below) and placed by
GSPMD, which inserts the collectives:

  fc1 kernel (784, H1)   -> P(None, 'model')   column-parallel
  fc2 kernel (H1, H2)    -> P('model', None)   row-parallel (psum output)
  fc3 kernel (H2, H3)    -> P(None, 'model')   column-parallel
  head kernel (H3, 10)   -> P('model', None)   row-parallel

Here each rank of the model group is a process holding its shard, and
the collectives are written out as Megatron's two operators
(``copy_to_model``: identity forward, all-reduce of the cotangent in
backward; ``reduce_from_model``: all-reduce forward, identity backward).
``TpShards`` cuts a model's full parameters into this rank's shards by
the table (matched on the flax module path of each leaf, the model's
``flax_names``), puts the column and row forms of the layers in their
place, gathers shards back into full arrays (checkpoints) and gives the
optimizer whole-leaf norms. ``make_tp_train_step`` is the step.

The forward of the binarized MLP on a rank: fc1 (column, its raw-pixel
input replicated) gives this rank's features; BatchNorm_0 normalises
them; fc2 (row) binarizes them and multiplies by its rows of W2, a
partial integer sum that the model group all-reduces (exact: an fp32
sum of +-1 products is exact for K <= 2^24, so the sharded forward is
bitwise the unsharded one) before the bias is added once; BatchNorm_1 is
replicated; fc3 (column) takes the replicated activation (its input
gradient is partial on each rank: ``copy_to_model`` all-reduces it in
backward, or BatchNorm_1 and fc2's bias would learn from one shard);
dropout draws the full-width mask from the model's generator and keeps
this rank's columns; the fp32 head is row-parallel (its partial sums
reassociate: a tolerance, not bitwise). With ``scale=True`` (XNOR-Net's
alpha = mean |W_latent| over the input dim) a row-parallel layer sums
|W| over its shard, the model group all-reduces the sums
(``reduce_from_model``: forward all-reduce, backward identity) and they
are divided by the full input width; the all-reduced +-1 product is
multiplied by alpha, then the bias added once (the integer sums stay
bitwise, alpha's fp32 sum runs in another order than the unsharded
mean's).

The ViT family (``BNN_VIT_TP_TABLE``): in each block, q, k and v are
column-parallel (this rank holds ``num_heads / tp`` heads, and the
attention core, K4-K6 under ``attention="flash"``, runs on them), the
output projection is row-parallel; the MLP's first dense is column-
and its second row-parallel. The LayerNorms, the patch embedding,
``pos_embed`` and the head are replicated. Each block's residual
stream is replicated, so its dropout masks are drawn full-width from
the data row's generator on every model rank (the unsharded model's). A step carries two forward
all-reduces and one backward all-reduce over the model group; the data
group carries the gradients (``data_parallel.all_reduce_grads``).
Replicated leaves (BatchNorm_1, the row biases) get the same gradient on
every model rank and stay bitwise equal there.

The k-bit QNN (``QNN_MLP_TP_TABLE``) has the flagship's layout under
QuantizedDense names, with the same two operators; its row-parallel
fp32 partial products are exact sums of quantized values, but a column
shard of the first layer sums raw pixels in another order, which can
move a value across a rounding boundary of the next quantizer. The MoE
(``BNN_MOE_TP_TABLE``) shards the stacked expert bank on its leading
dim (``ShardedExperts``): each rank computes its E/tp experts' slot
outputs from the replicated dispatch and its share of the combine, the
model group sums the shares, and the replicated input and combine
weights take ``copy_to_model``; the router, the dense layers and the
BatchNorms are replicated.
"""

from __future__ import annotations

import fnmatch
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..interop import _LEAVES, _nest, flax_params, port_dim
from ..ops import remat
from ..ops.binarize import (
    binarize_ste,
    binarize_stoch,
    quantize,
    quantize_stoch,
)
from ..ops.comm_compress import WireBytes, _count
from ..ops.losses import cross_entropy_loss
from ..ops.xnor_gemm import binary_matmul
from ..models.layers import BatchNorm, BinarizedDense, Dropout, QuantizedDense
from ..models.moe import BinarizedExperts
from .mesh import Mesh, P, comm_span

# Megatron-style roles a module can play in a TP layout:
#   col     - column-parallel GEMM: kernel P(None, axis), bias P(axis)
#   row     - row-parallel GEMM: kernel P(axis, None), bias P(None)
#             (the partial sums all-reduced, the bias added once)
#   feat    - feature-wise layer (BatchNorm) whose features follow a
#             column-parallel producer: all P(axis)
#   repl    - replicated: all P()
#   expert_stack - stacked per-expert params (E, ...): leading dim
#             sharded (expert parallelism)
_ROLES = ("col", "row", "feat", "repl", "expert_stack")


def _flat(tree: Any, prefix: Tuple[str, ...] = ()):
    """(path, leaf) of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _path_match(mod_path: str, pattern: str) -> bool:
    # Segment-wise: '*' must not cross '/', or a newly nested module
    # whose leaf name collides with a pattern would be sharded silently.
    segs, pats = mod_path.split("/"), pattern.split("/")
    return len(segs) == len(pats) and all(
        fnmatch.fnmatch(s, p) for s, p in zip(segs, pats))


def _role_of(mod_path: str, table: Dict[str, str]) -> Optional[str]:
    return next((r for pat, r in table.items()
                 if _path_match(mod_path, pat)), None)


def tp_rules_by_path(params: Any, table: Dict[str, str],
                     axis: str = "model", *, strict: bool = True) -> Any:
    """A tree of ``PartitionSpec`` shaped like ``params`` (a nested dict
    of the flax params: arrays, shapes or anything else as leaves) from
    an explicit {module-path-pattern: role} table. Patterns are fnmatch
    globs over the '/'-joined module path (leaf name excluded), matched
    segment by segment, first match wins in table order. An unmatched
    module raises ``KeyError`` (``strict=False``: replicated)."""
    for role in table.values():
        if role not in _ROLES:
            raise ValueError(f"unknown TP role {role!r} (have {_ROLES})")

    def spec_for(path: Tuple[str, ...]) -> P:
        mod_path = "/".join(path[:-1])
        kind = path[-1] if path else ""
        role = _role_of(mod_path, table)
        if role is None:
            if strict:
                raise KeyError(
                    f"no TP rule matches module path {mod_path!r} "
                    "(pass strict=False to replicate unmatched modules)")
            return P()
        if role == "col":
            return P(None, axis) if kind == "kernel" else P(axis)
        if role == "row":
            return P(axis, None) if kind == "kernel" else P(None)
        if role in ("feat", "expert_stack"):
            return P(axis)
        return P()

    return _nest((path, spec_for(path)) for path, _ in _flat(params))


# The flagship BnnMLP's layout (mnist-dist2.py:46-76 topology): fc1/fc3
# column-parallel, fc2 and the fp32 head row-parallel; each BatchNorm
# follows its producing GEMM's output sharding.
BNN_MLP_TP_TABLE: Dict[str, str] = {
    "BinarizedDense_0": "col",
    "BatchNorm_0": "feat",
    "BinarizedDense_1": "row",
    "BatchNorm_1": "repl",
    "BinarizedDense_2": "col",
    "BatchNorm_2": "feat",
    "Dense_0": "row",
}

# The k-bit QNN twin has the same topology under QuantizedDense names.
QNN_MLP_TP_TABLE: Dict[str, str] = {
    "QuantizedDense_0": "col",
    "BatchNorm_0": "feat",
    "QuantizedDense_1": "row",
    "BatchNorm_1": "repl",
    "QuantizedDense_2": "col",
    "BatchNorm_2": "feat",
    "Dense_0": "row",
}

# Binarized ViT/LM blocks: Megatron attention (q/k/v column-parallel over
# heads, out-projection row-parallel) and MLP (up column, down row).
# Embeddings, LayerNorms, pos embeds and the fp32 head are replicated.
BNN_VIT_TP_TABLE: Dict[str, str] = {
    "TransformerBlock_*/BinarizedSelfAttention_0/BinarizedDense_0": "col",
    "TransformerBlock_*/BinarizedSelfAttention_0/BinarizedDense_1": "col",
    "TransformerBlock_*/BinarizedSelfAttention_0/BinarizedDense_2": "col",
    "TransformerBlock_*/BinarizedSelfAttention_0/BinarizedDense_3": "row",
    "TransformerBlock_*/BinarizedDense_0": "col",
    "TransformerBlock_*/BinarizedDense_1": "row",
    "TransformerBlock_*/ln_*": "repl",
    "BinarizedDense_0": "repl",   # patch embedding
    "tok_embed": "repl",
    "ln_head": "repl",
    "head": "repl",
    "": "repl",                   # top-level raw params (pos_embed)
}

# The MoE family: expert parallelism through the same mesh axis.
BNN_MOE_TP_TABLE: Dict[str, str] = {
    "BinarizedExperts_0": "expert_stack",   # leading dim = experts
    "BinarizedDense_0": "repl",
    "BinarizedDense_1": "repl",
    "BatchNorm_0": "repl",
    "BatchNorm_1": "repl",
    "router": "repl",
}


def tp_table_for(model_name: str) -> Dict[str, str]:
    """The rule table of a registry model family."""
    if model_name.startswith("qnn"):
        return QNN_MLP_TP_TABLE
    if model_name.startswith("bnn-mlp"):
        return BNN_MLP_TP_TABLE
    if "vit" in model_name:
        return BNN_VIT_TP_TABLE
    if "moe" in model_name:
        return BNN_MOE_TP_TABLE
    # fp32-mlp-large deliberately not matched: its all-Dense topology
    # (Dense_0..3) would collide with the head rule and mis-shard.
    raise ValueError(
        f"no TP rule table for model {model_name!r} "
        "(have: the BNN-MLP/QNN, ViT and MoE families)")


def tp_rules_for(model_name: str, params: Any, axis: str = "model") -> Any:
    """The TP layout for a registry model family, by path-name table;
    ``params`` is the flax params tree (``interop.flax_params``)."""
    return tp_rules_by_path(params, tp_table_for(model_name), axis)


def bnn_mlp_tp_rules(params: Any, axis: str = "model") -> Any:
    """PartitionSpec tree for a BnnMLP params tree (BNN_MLP_TP_TABLE)."""
    return tp_rules_by_path(params, BNN_MLP_TP_TABLE, axis)


# -- Megatron's two operators -------------------------------------------------


def _ring_bytes(t: torch.Tensor, n: int) -> int:
    """A ring all-reduce's bytes out of each rank: 2 (n-1)/n of it."""
    return 2 * (n - 1) * t.nbytes // n


def _all_reduce(x: torch.Tensor, group, wire: Optional[WireBytes],
                phase: str) -> torch.Tensor:
    out = x.contiguous().clone()
    n = dist.get_world_size(group)
    if n > 1:
        with comm_span("model", out):
            dist.all_reduce(out, group=group)
        _count(wire, "model", phase, _ring_bytes(out, n))
    return out


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the cotangent all-reduced over the model group
    in backward (a replicated input feeding a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group, wire):
        ctx.group, ctx.wire = group, wire
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.wire, "bwd"), None, None


class _ReduceFromModel(torch.autograd.Function):
    """The all-reduce over the model group forward (a row-parallel
    layer's partial sums); identity backward. An activation checkpoint's
    recompute takes the forward's sum back (``ops.remat.once``)."""

    @staticmethod
    def forward(ctx, x, group, wire):
        out = remat.once(lambda: _all_reduce(x, group, wire, "fwd"))
        return out.clone() if remat.recomputing() else out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_model(x: torch.Tensor, group, wire=None) -> torch.Tensor:
    return _CopyToModel.apply(x, group, wire)


def reduce_from_model(x: torch.Tensor, group, wire=None) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group, wire)


# -- the column and row forms ---------------------------------------------------


class TpContext:
    """This rank's place in the model group: ``group``, its size ``tp``
    and index ``rank``, and the ``WireBytes`` its collectives add to."""

    def __init__(self, group, wire: Optional[WireBytes] = None):
        self.group = group
        self.tp = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.wire = wire

    def cut(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous 1/tp of ``t`` along ``dim``."""
        n = t.shape[dim]
        if n % self.tp:
            raise ValueError(f"dim {dim} of size {n} is not divisible by "
                             f"tensor_parallel={self.tp}")
        k = n // self.tp
        return t.detach().narrow(dim, self.rank * k, k).contiguous()


def _param(t: torch.Tensor, like: nn.Parameter) -> nn.Parameter:
    return nn.Parameter(t.clone(), requires_grad=like.requires_grad)


class ColumnBinarizedDense(BinarizedDense):
    """A ``BinarizedDense`` holding this rank's output features (weight
    rows and bias of the column shard); its input is replicated."""

    def __init__(self, full: BinarizedDense, ctx: TpContext):
        nn.Module.__init__(self)
        self.__dict__.update({k: v for k, v in full.__dict__.items()
                              if not k.startswith("_")})
        self.ctx = ctx
        self.full_out = full.out_features
        self.out_features = full.out_features // ctx.tp
        self.weight = _param(ctx.cut(full.weight, 0), full.weight)
        self.bias = (None if full.bias is None
                     else _param(ctx.cut(full.bias, 0), full.bias))

    def forward(self, x, generator=None):
        return super().forward(
            copy_to_model(x, self.ctx.group, self.ctx.wire), generator)


class RowBinarizedDense(BinarizedDense):
    """A ``BinarizedDense`` holding this rank's input features (weight
    columns); its input is this rank's features of a column-parallel
    output. The partial product is all-reduced, multiplied by alpha under
    ``scale`` (the shards' |W| sums all-reduced, over the full input
    width), then the (replicated) bias added once. Stochastic signs draw
    the full-width noise and keep
    this rank's columns, so every rank's signs are the unsharded
    layer's."""

    def __init__(self, full: BinarizedDense, ctx: TpContext):
        nn.Module.__init__(self)
        self.__dict__.update({k: v for k, v in full.__dict__.items()
                              if not k.startswith("_")})
        self.ctx = ctx
        self.full_in = full.in_features
        self.in_features = full.in_features // ctx.tp
        self.weight = _param(ctx.cut(full.weight, 1), full.weight)
        self.bias = (None if full.bias is None
                     else _param(full.bias.detach(), full.bias))

    def forward(self, x, generator=None):
        if self.binarize_input:
            if self.stochastic and generator is not None:
                lo = self.ctx.rank * self.in_features
                shape = (*x.shape[:-1], self.full_in)
                noise = remat.rand(shape, generator=generator,
                                   dtype=x.dtype, device=x.device)
                x = binarize_stoch(x, noise[..., lo:lo + self.in_features],
                                   self.ste)
            else:
                x = binarize_ste(x, self.ste)
        wb = binarize_ste(self.weight, self.ste)
        lead = x.shape[:-1]
        y = binary_matmul(x.reshape(-1, x.shape[-1]), wb,
                          self.gemm_backend())
        y = reduce_from_model(y, self.ctx.group, self.ctx.wire)
        y = y.reshape(*lead, self.out_features)
        if self.scale:
            # alpha over the full input dim: the shards' |W| sums summed
            sums = reduce_from_model(self.weight.abs().sum(dim=1),
                                     self.ctx.group, self.ctx.wire)
            y = y * (sums / self.full_in)
        return y if self.bias is None else y + self.bias


class ColumnQuantizedDense(QuantizedDense):
    """A ``QuantizedDense`` holding this rank's output features; its input
    is replicated (quantized, stochastically too, the same on every
    rank)."""

    def __init__(self, full: QuantizedDense, ctx: TpContext):
        nn.Module.__init__(self)
        self.__dict__.update({k: v for k, v in full.__dict__.items()
                              if not k.startswith("_")})
        self.ctx = ctx
        self.out_features = full.out_features // ctx.tp
        self.weight = _param(ctx.cut(full.weight, 0), full.weight)
        self.bias = (None if full.bias is None
                     else _param(ctx.cut(full.bias, 0), full.bias))

    def forward(self, x, generator=None):
        return super().forward(
            copy_to_model(x, self.ctx.group, self.ctx.wire), generator)


class RowQuantizedDense(QuantizedDense):
    """A ``QuantizedDense`` holding this rank's input features: its input
    quantized (stochastic rounding draws the full-width noise and keeps
    this rank's columns), the fp32 partial product all-reduced (sums in
    another order than the unsharded product's), then the replicated
    bias added once."""

    def __init__(self, full: QuantizedDense, ctx: TpContext):
        nn.Module.__init__(self)
        self.__dict__.update({k: v for k, v in full.__dict__.items()
                              if not k.startswith("_")})
        self.ctx = ctx
        self.full_in = full.in_features
        self.in_features = full.in_features // ctx.tp
        self.weight = _param(ctx.cut(full.weight, 1), full.weight)
        self.bias = (None if full.bias is None
                     else _param(full.bias.detach(), full.bias))

    def forward(self, x, generator=None):
        if self.quant_input and self.stochastic and generator is not None:
            lo = self.ctx.rank * self.in_features
            noise = remat.rand((*x.shape[:-1], self.full_in),
                               generator=generator, dtype=x.dtype,
                               device=x.device) - 0.5
            x = quantize_stoch(x, noise[..., lo:lo + self.in_features],
                               self.num_bits)
        else:
            x = self.quantize_input(x)
        y = x @ quantize(self.weight, self.num_bits).t()
        y = reduce_from_model(y, self.ctx.group, self.ctx.wire)
        return y if self.bias is None else y + self.bias


class ShardedExperts(BinarizedExperts):
    """The expert_stack role: this rank's ``E / tp`` experts of a
    ``BinarizedExperts`` (their ``w`` and ``b`` rows). From the
    replicated dispatch it computes its experts' slot outputs and their
    share of the combine; the model group sums the shares
    (``reduce_from_model``). The input and the combine weights are
    replicated and feed only this rank's experts here, so their
    cotangents are all-reduced in backward (``copy_to_model``), or the
    router and the first layer would learn from one rank's experts."""

    def __init__(self, full: BinarizedExperts, ctx: TpContext):
        nn.Module.__init__(self)
        self.__dict__.update({k: v for k, v in full.__dict__.items()
                              if not k.startswith("_")})
        self.ctx = ctx
        self.w = _param(ctx.cut(full.w, 0), full.w)
        self.b = _param(ctx.cut(full.b, 0), full.b)
        self.lo = ctx.rank * self.w.shape[0]

    def forward(self, x, dispatch, combine, group=None):
        held = slice(self.lo, self.lo + self.w.shape[0])
        x = copy_to_model(x, self.ctx.group, self.ctx.wire)
        combine = copy_to_model(combine, self.ctx.group, self.ctx.wire)
        y = super().forward(x, dispatch[:, held], combine[:, held], group)
        return reduce_from_model(y, self.ctx.group, self.ctx.wire)


class ColumnLinear(nn.Linear):
    """flax ``Dense`` (``nn.Linear``) holding this rank's output
    features; its input is replicated."""

    def __init__(self, full: nn.Linear, ctx: TpContext):
        nn.Module.__init__(self)
        self.ctx = ctx
        self.in_features = full.in_features
        self.out_features = full.out_features // ctx.tp
        self.weight = _param(ctx.cut(full.weight, 0), full.weight)
        self.bias = _param(ctx.cut(full.bias, 0), full.bias)

    def forward(self, x):
        return super().forward(copy_to_model(x, self.ctx.group,
                                             self.ctx.wire))


class RowLinear(nn.Linear):
    """flax ``Dense`` holding this rank's input features: the partial
    product all-reduced (fp32 sums in another order than the unsharded
    product's), then the replicated bias added once."""

    def __init__(self, full: nn.Linear, ctx: TpContext):
        nn.Module.__init__(self)
        self.ctx = ctx
        self.in_features = full.in_features // ctx.tp
        self.out_features = full.out_features
        self.weight = _param(ctx.cut(full.weight, 1), full.weight)
        self.bias = _param(full.bias.detach(), full.bias)

    def forward(self, x):
        y = nn.functional.linear(x, self.weight)
        return reduce_from_model(y, self.ctx.group, self.ctx.wire) + self.bias


def _feature_batchnorm(full: BatchNorm, ctx: TpContext) -> BatchNorm:
    """A ``BatchNorm`` over this rank's features of ``full`` (parameters
    and running statistics cut along the feature dim)."""
    bn = BatchNorm(full.num_features // ctx.tp, eps=full.eps,
                   momentum=full.momentum)
    bn.dtype, bn.group = full.dtype, full.group
    with torch.no_grad():
        for name in ("weight", "bias"):
            getattr(bn, name).copy_(ctx.cut(getattr(full, name), 0))
        for name in ("running_mean", "running_var"):
            getattr(bn, name).copy_(ctx.cut(getattr(full, name), 0))
        bn.num_batches_tracked.copy_(full.num_batches_tracked)
    return bn.to(full.weight.device)


class ShardedDropout(Dropout):
    """Dropout on this rank's columns of a column-parallel activation:
    the full-width mask is drawn from the model's generator (every rank
    of the model group draws the same) and this rank's columns kept, so
    the units dropped are the unsharded model's."""

    def __init__(self, rate: float, ctx: TpContext):
        super().__init__(rate)
        self.ctx = ctx

    def forward(self, x, generator=None):
        if not self.training or self.rate in (0.0, 1.0):
            return super().forward(x, generator)
        if generator is None:
            raise ValueError("train-mode dropout needs an explicit generator")
        keep_prob = 1.0 - self.rate
        k = x.shape[-1]
        full = remat.rand((*x.shape[:-1], k * self.ctx.tp),
                          generator=generator, device=x.device)
        keep = full[..., self.ctx.rank * k:(self.ctx.rank + 1) * k] < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))


# -- the shards -----------------------------------------------------------------


def _check_tp_model(model: nn.Module, model_name: str, tp: int) -> None:
    from ..models.mlp import BnnMLP, QnnMLP
    from ..models.moe import BnnMoEMLP
    from ..models.transformer import BinarizedTransformer

    table = tp_table_for(model_name)
    if table is BNN_VIT_TP_TABLE:
        if not isinstance(model, BinarizedTransformer):
            raise ValueError(f"no TP rule table for model {model_name!r}")
        if model.num_heads % tp:
            raise ValueError(
                f"num_heads {model.num_heads} not divisible by "
                f"tensor_parallel={tp}: each rank holds num_heads/tp "
                "heads of every attention")
        return
    if table is BNN_MOE_TP_TABLE:
        if not isinstance(model, BnnMoEMLP):
            raise ValueError(f"no TP rule table for model {model_name!r}")
        if model.num_experts % tp:
            raise ValueError(
                f"num_experts {model.num_experts} not divisible by "
                f"tensor_parallel={tp}: each rank holds num_experts/tp "
                "experts")
        return
    if table is QNN_MLP_TP_TABLE:
        if not isinstance(model, QnnMLP):
            raise ValueError(f"no TP rule table for model {model_name!r}")
        return
    if not (isinstance(model, BnnMLP) and model.binarized):
        raise ValueError(f"no TP rule table for model {model_name!r}")


class TpShards:
    """This rank's shards of ``model`` over the mesh's ``axis`` group,
    cut by the family's table (``tp_rules_for`` on the model's flax
    tree): each matched module of ``model`` is replaced in place by its
    column, row or feature form holding this rank's shard; replicated
    modules stay. The model's parameters are then the shards, and the
    optimizer runs on them (its state sharded too; JAX keeps the moments
    replicated, which gives the same update of each element).

    ``dims`` maps each parameter and buffer to the dim of the port
    tensor it is sharded along (None: replicated). ``gather_leaf`` and
    ``slice_leaf`` convert between a shard and the full tensor (the
    checkpoint's flax arrays, gathered over the model group);
    ``sq_norms`` gives whole-leaf sums of squares (global-norm clipping,
    LARS/LAMB trust ratios), as ``parallel.fsdp.FsdpShards`` does."""

    def __init__(self, model: nn.Module, model_name: str, mesh: Mesh, *,
                 axis: str = "model", data_axis: Optional[str] = "data",
                 wire: Optional[WireBytes] = None):
        self.mesh = mesh
        self.ctx = TpContext(mesh.group(axis), wire)
        _check_tp_model(model, model_name, self.ctx.tp)
        self.group = self.ctx.group
        self.tp, self.rank = self.ctx.tp, self.ctx.rank
        self.data_group = (mesh.group(data_axis) if data_axis
                           and data_axis in mesh.axis_names else None)
        table = tp_table_for(model_name)
        specs = dict(_flat(tp_rules_by_path(flax_params(model), table,
                                            axis)))
        dims: Dict[str, Optional[int]] = {}
        for sub, flax_name, kind in model.flax_names():
            if kind == "param":   # a raw parameter (pos_embed): replicated
                dims[sub] = None
                continue
            role = _role_of(flax_name, table)
            full = model.get_submodule(sub)
            part = self._part(full, role)
            if part is not full:
                parent, _, attr = sub.rpartition(".")
                setattr(model.get_submodule(parent) if parent else model,
                        attr, part)
            for port, coll, leaf in _LEAVES[kind]:
                spec = specs.get((*flax_name.split("/"), leaf), P())
                axis_i = next((i for i, a in enumerate(spec) if a == axis),
                              None)
                if coll == "batch_stats":   # follow the feature shards
                    axis_i = 0 if role == "feat" else None
                shape_nd = getattr(part, port).dim()
                dims[f"{sub}.{port}"] = (
                    None if axis_i is None
                    else port_dim(kind, shape_nd, axis_i))
        if isinstance(getattr(model, "dropout", None), Dropout):
            model.dropout = ShardedDropout(model.dropout.rate, self.ctx)
        named = dict(model.named_parameters())
        named.update(model.named_buffers())
        self.dims = {named[n]: d for n, d in dims.items()}
        self._sharded = {id(t) for t, d in self.dims.items()
                         if d is not None}

    def _part(self, full: nn.Module, role: Optional[str]) -> nn.Module:
        if role == "col":
            if isinstance(full, BinarizedDense):
                return ColumnBinarizedDense(full, self.ctx)
            if isinstance(full, QuantizedDense):
                return ColumnQuantizedDense(full, self.ctx)
            return ColumnLinear(full, self.ctx)
        if role == "row":
            if isinstance(full, BinarizedDense):
                return RowBinarizedDense(full, self.ctx)
            if isinstance(full, QuantizedDense):
                return RowQuantizedDense(full, self.ctx)
            return RowLinear(full, self.ctx)
        if role == "feat":
            return _feature_batchnorm(full, self.ctx)
        if role == "expert_stack":
            return ShardedExperts(full, self.ctx)
        return full

    # -- the optimizer's whole-leaf norms -----------------------------------

    def sq_norms(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                 ) -> List[torch.Tensor]:
        """Whole-leaf sums of squares: for each ``(param, t)``, the sum
        over the model group for a sharded leaf (one all-reduce), the
        local sum for a replicated one."""
        sums = [torch.sum(t * t) for _, t in pairs]
        idx = [i for i, (p, _) in enumerate(pairs) if id(p) in self._sharded]
        if idx and self.tp > 1:
            part = torch.stack([sums[i] for i in idx])
            dist.all_reduce(part, group=self.group)
            for i, v in zip(idx, part.unbind()):
                sums[i] = v
        return sums

    # -- full leaves ---------------------------------------------------------

    def full_shape(self, p: torch.Tensor) -> Tuple[int, ...]:
        dim = self.dims.get(p)
        shape = list(p.shape)
        if dim is not None:
            shape[dim] *= self.tp
        return tuple(shape)

    def gather_leaf(self, p: torch.Tensor, shard: torch.Tensor
                    ) -> torch.Tensor:
        """The full tensor of ``shard`` (shaped like ``p``): all-gathered
        over the model group for a sharded leaf (collective), a copy of a
        replicated one."""
        dim = self.dims.get(p)
        if dim is None or self.tp == 1:
            return shard.detach().clone()
        moved = shard.detach().movedim(dim, 0).contiguous()
        out = moved.new_empty((self.tp * moved.shape[0], *moved.shape[1:]))
        dist.all_gather_into_tensor(out, moved, group=self.group)
        return out.movedim(0, dim).contiguous()

    def slice_leaf(self, p: torch.Tensor, full: torch.Tensor
                   ) -> torch.Tensor:
        """This rank's part of ``full`` (shaped like the full leaf of
        ``p``)."""
        dim = self.dims.get(p)
        if dim is None:
            return full.detach().clone()
        return self.ctx.cut(full, dim)


def tp_wire_plan(model: nn.Module, *, tp: int, dp: int,
                 batch: int) -> Dict[str, int]:
    """Bytes out of each rank a step of the TP binarized MLP (``model``
    unsharded), counted as ring all-reduces (2 (n-1)/n of the buffer):
    ``model`` - fc2's and the head's fp32 outputs forward and fc3's input
    gradient backward over this data rank's ``batch / dp`` rows;
    ``data`` - this rank's fp32 gradient shards (``all_reduce_grads``)."""
    rows = batch // dp
    h1, h2, h3 = model.hidden
    fwd = rows * (h2 + model.num_classes) * 4
    bwd = rows * h2 * 4
    local = 0
    for name, p in model.named_parameters():
        n = p.numel()
        if name.startswith(("fc1.", "fc3.", "bn1.", "bn3.")) or (
                name in ("fc2.weight", "head.weight")):
            n //= tp
        local += n
    return {"model": 2 * (tp - 1) * (fwd + bwd) // tp if tp > 1 else 0,
            "model_fwd": 2 * (tp - 1) * fwd // tp,
            "model_bwd": 2 * (tp - 1) * bwd // tp,
            "data": 2 * (dp - 1) * local * 4 // dp if dp > 1 else 0}


def make_tp_train_step(clamp_mask: Dict[str, torch.Tensor],
                       model: nn.Module, shards: TpShards, *,
                       loss_fn: Callable = cross_entropy_loss,
                       wire: Optional[WireBytes] = None,
                       grad_accum: int = 1, remat: bool = False
                       ) -> Callable:
    """The JAX ``make_tp_train_step`` over ``shards``: ``step(model,
    optimizer, images, labels, scalars=None) -> (loss, accuracy)`` on
    this data rank's rows (the same rows on every rank of its model
    group). The forward and backward run the TP layers' collectives;
    the gradients of the shards are averaged over the data group in
    DDP's order; the optimizer (over the shards) steps and the latents
    are clamped. BatchNorm normalises over the data group's global
    batch, as the GSPMD step does. ``grad_accum`` and ``remat`` are the
    single-device body's."""
    from ..train.trainer import (
        check_step_options,
        clamp_latent,
        forward_backward,
    )
    from .data_parallel import _mean_metrics, all_reduce_grads

    check_step_options(grad_accum)
    data = shards.data_group
    dp = 1 if data is None else dist.get_world_size(data)
    latents = list(clamp_mask.values())

    def tp_step(m: nn.Module, optimizer, images: torch.Tensor,
                labels: torch.Tensor,
                scalars: Optional[torch.Tensor] = None):
        if m is not model:
            raise ValueError("the TP step was built for another model")
        m.train()
        optimizer.zero_grad(set_to_none=True)
        loss, acc = forward_backward(m, images, labels, loss_fn=loss_fn,
                                     grad_accum=grad_accum, remat=remat)
        if dp > 1:
            all_reduce_grads(list(m.parameters()), data, wire)
        optimizer.step(scalars=scalars)
        clamp_latent(latents)
        return _mean_metrics(loss, acc, data) if dp > 1 else (loss, acc)

    return tp_step
