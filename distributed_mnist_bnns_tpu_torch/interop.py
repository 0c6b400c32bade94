"""Carry weights and frozen artifacts across from the JAX package.

The JAX package's trees arrive as numpy arrays (``np.asarray`` of every
leaf, or an ``.npz`` of the flattened tree), so nothing here imports JAX.

  params_from_jax(variables)  {"params", "batch_stats"} -> the port's
                              model of that family (BnnMLP, binarized or
                              fp32; QnnMLP; BnnMoEMLP; ConvNet, DeepCNN,
                              BinarizedCNN; XnorResNet; the ViT)
  params_to_jax(model)        the inverse (numpy leaves)
  frozen_from_jax(frozen)     JAX ``infer._freeze_tensors`` dict -> the
                              port's frozen artifact (same keys)
  frozen_to_jax(frozen)       the inverse: numpy leaves, as the JAX
                              ``export_packed`` serializes them
  lm_params_from_jax(params)  a JAX BinarizedLM's params -> the port's
                              BinarizedLM
  frozen_lm_from_jax(frozen)  JAX ``infer_transformer._freeze_lm_tensors``
                              dict -> the port's frozen LM artifact
  JaxFlatOrder(model)         a model's parameters in the order and
                              layout ``jax.flatten_util.ravel_pytree``
                              gives the flax params
  train_state_to_jax(trainer) the trainer's state as the flax state dict
                              of the JAX ``TrainState`` (a checkpoint)
  train_state_from_jax(sd, t) the inverse, into a trainer

Each model's ``flax_names()`` maps its submodules to flax's module names
(e.g. BinarizedDense_0..2 -> fc1..fc3, BatchNorm_0..2 -> bn1..bn3,
Dense_0 -> head for the MLP, the names the JAX ``infer.py`` reads), each
of a kind: "dense" (flax (in, out) kernel, the port's (out, in)
weight), "conv" (flax HWIO, the port's OIHW), "bn" (scale/bias ->
weight/bias, mean/var -> the running statistics) or "experts" (the
MoE's stacked ``w`` (E, D, Do) and ``b`` (E, Do), the same layout on
both sides). The QNN's QuantizedDense_0..2 map to fc1..fc3; the MoE's
router is a "dense" ``router``. For the LM:
tok_embed/embedding -> tok_embed, pos_embed, TransformerBlock_i ->
blocks.i (ln_attn/ln_mlp scale -> weight; BinarizedSelfAttention_0/
BinarizedDense_0..3, or Dense_0..3 for fp32 attention, -> attn.q, k, v,
out; BinarizedDense_0/1 -> mlp1/mlp2), ln_head and head. An XnorResNet's
Conv_0 -> stem, XnorBasicBlock_i / XnorBottleneckBlock_i -> blocks.i
(BatchNorm_j -> bn_j, BinarizedConv_j -> conv_j, the block's fp32
shortcut Conv_0 -> shortcut), BatchNorm_0 -> bn, Dense_0 -> head; the
stem and shortcut kernels have no bias, on either side.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch

from .models.mlp import BnnMLP
from .models.transformer import BinarizedLM


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def to_flax_layout(t: torch.Tensor, kind: str) -> torch.Tensor:
    """A port weight in flax's layout: an (out, in) dense weight as the
    (in, out) kernel, an OIHW conv weight as the HWIO kernel; anything
    else as it is."""
    if kind == "dense" and t.dim() == 2:
        return t.t()
    if kind == "conv" and t.dim() == 4:
        return t.permute(2, 3, 1, 0)
    return t


def port_dim(kind: Optional[str], ndim: int, axis: int) -> int:
    """The port tensor's dim that is axis ``axis`` of its flax layout
    (``to_flax_layout``)."""
    if kind == "dense" and ndim == 2:
        return 1 - axis
    if kind == "conv" and ndim == 4:
        return (2, 3, 1, 0)[axis]
    return axis


def from_flax_layout(a, kind: str) -> torch.Tensor:
    """The inverse of ``to_flax_layout`` for a flax kernel."""
    t = a if torch.is_tensor(a) else _t(a)
    if kind == "dense" and t.dim() == 2:
        return t.t()
    if kind == "conv" and t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    return t


# (port parameter or buffer, flax collection, flax leaf) of each kind;
# "param" is a raw parameter (the port's submodule name is the tensor,
# the flax module path its leaf: ``pos_embed``)
_LEAVES = {
    "dense": (("weight", "params", "kernel"), ("bias", "params", "bias")),
    "conv": (("weight", "params", "kernel"), ("bias", "params", "bias")),
    "bn": (("weight", "params", "scale"), ("bias", "params", "bias"),
           ("running_mean", "batch_stats", "mean"),
           ("running_var", "batch_stats", "var")),
    "ln": (("weight", "params", "scale"), ("bias", "params", "bias")),
    "embed": (("weight", "params", "embedding"),),
    "param": (("", "params", ""),),
    "experts": (("w", "params", "w"), ("b", "params", "b")),
}


def _paths(model: torch.nn.Module, collection: Optional[str] = None):
    """(flax path, port name, collection, kind) of every leaf of
    ``model.flax_names()`` (of ``collection`` only, when given). A flax
    module path may be nested ('TransformerBlock_0/ln_attn'). A leaf the
    port module does not hold (the bias of a conv without one) is not in
    the flax tree either."""
    for sub, flax_name, kind in model.flax_names():
        mod = model.get_submodule(sub) if kind != "param" else None
        for port, coll, leaf in _LEAVES[kind]:
            if mod is not None and getattr(mod, port, None) is None:
                continue
            if collection is None or coll == collection:
                path = tuple(flax_name.split("/")) + ((leaf,) if leaf
                                                      else ())
                yield path, f"{sub}.{port}" if port else sub, coll, kind


def _get(tree: Mapping[str, Any], path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def _nest(pairs) -> Dict[str, Any]:
    """A sorted nested dict of (path, leaf) pairs, as a jitted step
    returns flax's trees."""
    out: Dict[str, Any] = {}
    for path, leaf in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return _sorted(out)


def _tensor(model: torch.nn.Module, name: str, coll: str) -> torch.Tensor:
    return (model.get_parameter(name) if coll == "params"
            else model.get_buffer(name))


def flax_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The flax params tree of ``model`` with each leaf's flax shape (a
    tuple) as its value: the tree the JAX package's rule tables
    (``parallel.model_parallel``) and layouts are written over."""
    return _nest((path, tuple(to_flax_layout(torch.empty(
        _tensor(model, name, coll).shape, device="meta"), kind).shape))
        for path, name, coll, kind in _paths(model, "params"))


def _model_from_tree(p, **model_kw) -> torch.nn.Module:
    """A model of the family and widths of a JAX model's params:
    BnnMoEMLP (BinarizedExperts_0; ``router_k``, ``capacity_factor`` and
    ``aux_coef`` are not in the tree: pass them), QnnMLP
    (QuantizedDense_0..2; ``num_bits`` likewise), BinarizedCNN
    (BinarizedConv_0, 1), DeepCNN (Conv_0..2), ConvNet (Conv_0, 1) or
    BnnMLP, binarized (BinarizedDense_0..2, Dense_0) or fp32
    (Dense_0..3)."""
    from .models import BinarizedCNN, ConvNet, DeepCNN

    def shape(name):
        return np.asarray(p[name]["kernel"]).shape

    if "BinarizedExperts_0" in p:
        from .models import BnnMoEMLP

        e, d, do = np.asarray(p["BinarizedExperts_0"]["w"]).shape
        fan_in, hidden = shape("BinarizedDense_0")
        return BnnMoEMLP(hidden=hidden, num_experts=e, expert_features=do,
                         num_classes=shape("BinarizedDense_1")[1],
                         in_features=fan_in, **model_kw)
    if "QuantizedDense_0" in p:
        from .models import QnnMLP

        kernels = [shape(f"QuantizedDense_{i}") for i in range(3)]
        return QnnMLP(hidden=tuple(k[1] for k in kernels),
                      num_classes=shape("Dense_0")[1],
                      in_features=kernels[0][0], **model_kw)
    if "TransformerBlock_0" in p and "pos_embed" in p and (
            "tok_embed" not in p):
        from .models import BinarizedTransformer

        binarized = "BinarizedDense_0" in p
        fan_in, embed = shape("BinarizedDense_0" if binarized else "Dense_0")
        tokens = np.asarray(p["pos_embed"]).shape[1]
        side = int(round(tokens ** 0.5))
        blk = p["TransformerBlock_0"]
        mlp = blk["BinarizedDense_0" if "BinarizedDense_0" in blk
                  else "Dense_0"]
        attn_bin = "BinarizedDense_0" in blk["BinarizedSelfAttention_0"]
        model_kw.setdefault("image_size", 28)
        patch = model_kw["image_size"] // side
        return BinarizedTransformer(
            num_classes=shape("head")[1], patch_size=patch,
            embed_dim=embed,
            depth=sum(1 for k in p if k.startswith("TransformerBlock_")),
            mlp_ratio=np.asarray(mlp["kernel"]).shape[1] // embed,
            binarized=binarized, binarized_attention=attn_bin,
            in_channels=fan_in // (patch * patch), **model_kw)
    resnet = [k for k in p if k.startswith(("XnorBasicBlock_",
                                            "XnorBottleneckBlock_"))]
    if resnet:
        return _resnet_from_tree(p, resnet, **model_kw)
    if "BinarizedConv_0" in p:
        return BinarizedCNN(
            num_classes=shape("Dense_0")[1],
            widths=(shape("BinarizedConv_0")[3],
                    shape("BinarizedConv_1")[3]),
            hidden=shape("BinarizedDense_0")[1], **model_kw)
    if "Conv_2" in p:
        return DeepCNN(num_classes=shape("Dense_1")[1], **model_kw)
    if "Conv_0" in p:
        return ConvNet(num_classes=shape("Dense_0")[1], **model_kw)
    binarized = "BinarizedDense_0" in p
    fc = "BinarizedDense" if binarized else "Dense"
    kernels = [shape(f"{fc}_{i}") for i in range(3)]
    return BnnMLP(
        hidden=tuple(k[1] for k in kernels),
        num_classes=shape("Dense_0" if binarized else "Dense_3")[1],
        in_features=kernels[0][0], binarized=binarized, **model_kw,
    )


def _resnet_from_tree(p, blocks, **model_kw) -> torch.nn.Module:
    """An XnorResNet of a JAX tree's blocks: the stage sizes from where
    the width doubles, the stem from its kernel (3x3: CIFAR's, 7x7:
    ImageNet's), binarized unless its blocks hold fp32 ``Conv_0``
    twins."""
    from .models import XnorResNet

    bottleneck = blocks[0].startswith("XnorBottleneck")
    name = blocks[0].rsplit("_", 1)[0]
    binarized = "BinarizedConv_0" in p[f"{name}_0"]
    # the block's width: conv0's out channels (conv1's in a bottleneck,
    # whose conv2 expands by 4)
    conv = ("BinarizedConv" if binarized else "Conv") + (
        "_1" if bottleneck else "_0")
    widths = [np.asarray(p[f"{name}_{i}"][conv]["kernel"]).shape[3]
              for i in range(len(blocks))]
    stages = []
    for i, w in enumerate(widths):
        if i and w == widths[i - 1]:
            stages[-1] += 1
        else:
            stages.append(1)
    kh, _, cin, stem = np.asarray(p["Conv_0"]["kernel"]).shape
    return XnorResNet(stage_sizes=tuple(stages), bottleneck=bottleneck,
                      num_classes=np.asarray(p["Dense_0"]["kernel"]).shape[1],
                      stem_features=stem, cifar_stem=kh == 3,
                      in_channels=cin, binarized=binarized, **model_kw)


def params_from_jax(
    variables: Dict[str, Any], model: Optional[torch.nn.Module] = None,
    **model_kw
) -> torch.nn.Module:
    """Load a JAX model's ``{"params", "batch_stats"}`` (numpy leaves)
    into ``model`` (any model with ``flax_names``: the MLPs, ``ConvNet``,
    ``DeepCNN``, ``BinarizedCNN``), or into a new model of the tree's
    family and widths built with ``model_kw``. Kernels change layout (HWIO ->
    OIHW, (in, out) -> (out, in)); a dense layer after a flatten takes
    the kernel as it is, since the port flattens in flax's (h, w, c)
    order. Returns the model in eval mode."""
    p, s = variables["params"], variables.get("batch_stats", {})
    if model is None:
        model = _model_from_tree(p, **model_kw)
    state = {}
    for path, name, coll, kind in _paths(model):
        state[name] = from_flax_layout(
            _get(p if coll == "params" else s, path), kind)
    for sub, _, kind in model.flax_names():
        if kind == "bn":
            state[f"{sub}.num_batches_tracked"] = torch.tensor(0)
    model.load_state_dict(state, strict=True)
    return model.eval()


def params_to_jax(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of ``params_from_jax``: ``model``'s ``{"params",
    "batch_stats"}`` in flax's layout and names, numpy leaves in sorted
    order, as the JAX model's ``apply`` takes them."""
    layout = Layout(model)
    return {coll: frozen_to_jax(_layout_tree(layout, coll,
                                             torch.Tensor.detach))
            for coll in ("params", "batch_stats")}


def lm_params_from_jax(
    params: Dict[str, Any], model: Optional[BinarizedLM] = None, **model_kw
) -> BinarizedLM:
    """Load a JAX BinarizedLM's ``params`` tree (numpy leaves) into
    ``model``, or into a new BinarizedLM of the tree's widths built with
    ``model_kw`` (``num_heads``, ``scale``, ``mlp_ratio`` are not in the
    tree: pass them). Returns the model in eval mode."""
    depth = sum(1 for key in params if key.startswith("TransformerBlock_"))
    attn0 = params["TransformerBlock_0"]["BinarizedSelfAttention_0"]
    fp32_attn = "Dense_0" in attn0
    if model is None:
        vocab, embed = np.asarray(params["tok_embed"]["embedding"]).shape
        hidden = np.asarray(
            params["TransformerBlock_0"]["BinarizedDense_0"]["kernel"]
        ).shape[1]
        model_kw.setdefault("mlp_ratio", hidden // embed)
        model = BinarizedLM(
            vocab=vocab, max_len=np.asarray(params["pos_embed"]).shape[1],
            embed_dim=embed, depth=depth,
            binarized_attention=not fp32_attn, **model_kw,
        )
    state = {
        "tok_embed.weight": _t(params["tok_embed"]["embedding"]),
        "pos_embed": _t(params["pos_embed"]),
        "ln_head.weight": _t(params["ln_head"]["scale"]),
        "ln_head.bias": _t(params["ln_head"]["bias"]),
        "head.weight": _t(np.asarray(params["head"]["kernel"]).T),
        "head.bias": _t(params["head"]["bias"]),
    }
    attn_name = "Dense" if fp32_attn else "BinarizedDense"
    for i in range(depth):
        bp = params[f"TransformerBlock_{i}"]
        pre = f"blocks.{i}."
        for ln in ("ln_attn", "ln_mlp"):
            state[pre + ln + ".weight"] = _t(bp[ln]["scale"])
            state[pre + ln + ".bias"] = _t(bp[ln]["bias"])
        layers = [
            (f"attn.{name}", bp["BinarizedSelfAttention_0"][f"{attn_name}_{j}"])
            for j, name in enumerate(("q", "k", "v", "out"))
        ] + [("mlp1", bp["BinarizedDense_0"]), ("mlp2", bp["BinarizedDense_1"])]
        for name, p in layers:
            state[pre + name + ".weight"] = _t(np.asarray(p["kernel"]).T)
            state[pre + name + ".bias"] = _t(p["bias"])
    model.load_state_dict(state, strict=True)
    return model.eval()


def frozen_lm_from_jax(frozen: Dict[str, Any]) -> Dict[str, Any]:
    """The port's frozen LM artifact from the dict the JAX package's
    ``infer_transformer._freeze_lm_tensors`` returns (numpy leaves):
    the same keys and layouts, as tensors."""
    if frozen.get("kind") != "lm":
        raise ValueError(f"not a frozen LM: kind {frozen.get('kind')!r}")
    return frozen_from_jax(frozen)


def frozen_from_jax(frozen: Dict[str, Any]) -> Dict[str, Any]:
    """The port's frozen artifact from the dict the JAX package's
    ``infer._freeze_tensors`` returns (numpy leaves; ints, strings and
    the ``info`` dict pass through). Array dtypes are kept: int32 packed
    words stay int32, an int8 first layer stays int8."""
    if isinstance(frozen, dict):
        return {k: (dict(v) if k == "info" else frozen_from_jax(v))
                for k, v in frozen.items()}
    if isinstance(frozen, (list, tuple)):
        return [frozen_from_jax(v) for v in frozen]
    if isinstance(frozen, np.ndarray):
        return torch.from_numpy(frozen.copy())
    return frozen


def frozen_to_jax(frozen: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of ``frozen_from_jax``: tensors as numpy arrays (the
    ``info`` dict, ints, strings and floats as they are)."""
    if isinstance(frozen, dict):
        return {k: (dict(v) if k == "info" else frozen_to_jax(v))
                for k, v in frozen.items()}
    if isinstance(frozen, (list, tuple)):
        return [frozen_to_jax(v) for v in frozen]
    if torch.is_tensor(frozen):
        return frozen.detach().cpu().numpy()
    return frozen


def variables_from_npz(path: str) -> Dict[str, Any]:
    """Unflatten an ``.npz`` whose keys are '/'-joined tree paths
    (``params/BinarizedDense_0/kernel``, ``batch_stats/BatchNorm_0/mean``)
    into the nested variables dict ``params_from_jax`` takes."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = tree
            *parents, leaf = key.split("/")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = data[key]
    return tree


class JaxFlatOrder:
    """A model's parameters as ``jax.flatten_util.ravel_pytree`` lays out
    the JAX model's params: leaves in sorted path order (for bnn-cnn
    ``BatchNorm_0..2``, ``BinarizedConv_0..1``, ``BinarizedDense_0``,
    ``Dense_0``; ``bias`` before ``kernel`` / ``scale`` in each), each
    kernel in flax's layout (``to_flax_layout``: dense (in, out), conv
    HWIO). Any model with ``flax_names`` (every registered model).

    ``entries`` lists ``(flax path, parameter, relaid)`` in that order,
    ``relaid`` True where the flax leaf has another layout (a kernel).
    ``flatten`` lays tensors shaped like the parameters (their
    gradients, or by default the parameters themselves) end to end in
    one fp32 vector; ``unflatten`` cuts such a vector back into tensors
    shaped like the parameters, keyed by parameter."""

    def __init__(self, model: torch.nn.Module):
        names = dict(model.named_parameters())
        if not hasattr(model, "flax_names"):
            raise ValueError(f"JaxFlatOrder needs a model with flax_names, "
                             f"not a {type(model).__name__}")
        # sorted paths, as ravel_pytree orders a tree of sorted dicts
        # ('/' sorts below every character of a module name)
        entries = sorted(("/".join(path), name, kind) for path, name, _, kind
                         in _paths(model, "params"))
        if {e[1] for e in entries} != set(names):
            raise ValueError("JaxFlatOrder: flax_names does not cover the "
                             f"parameters {sorted(names)}")
        relaid = [path.endswith("/kernel") and kind in ("dense", "conv")
                  for path, _, kind in entries]
        self.entries = [(path, names[name], r)
                        for (path, name, _), r in zip(entries, relaid)]
        self._kinds = [kind if r else None
                       for (_, _, kind), r in zip(entries, relaid)]
        self.n_params = sum(p.numel() for _, p, _ in self.entries)

    def kinds(self) -> Dict[torch.nn.Parameter, Optional[str]]:
        """Each parameter's layout kind ("dense", "conv"; None for a
        leaf that keeps the port's layout)."""
        return {p: kind for (_, p, _), kind in zip(self.entries,
                                                    self._kinds)}

    def flatten(self, tensors: Optional[Mapping[torch.nn.Parameter,
                                                torch.Tensor]] = None
                ) -> torch.Tensor:
        parts = []
        for (_, p, _), kind in zip(self.entries, self._kinds):
            t = p.detach() if tensors is None else tensors[p]
            parts.append(to_flax_layout(t, kind).reshape(-1))
        return torch.cat(parts).to(torch.float32)

    def unflatten(self, flat: torch.Tensor
                  ) -> Dict[torch.nn.Parameter, torch.Tensor]:
        out, start = {}, 0
        for (_, p, _), kind in zip(self.entries, self._kinds):
            n = p.numel()
            shape = to_flax_layout(torch.empty(p.shape, device="meta"),
                                   kind).shape
            out[p] = from_flax_layout(flat[start:start + n].reshape(shape),
                                      kind)
            start += n
        return out


# -- the train state in flax's layout ------------------------------------------

# Each optimizer's optax state under ``inject_hyperparams`` (the stages of
# its chain, in order): a tuple of names is one stage's state, in the
# order of its fields ("count" an int32 scalar, any other name a tree
# shaped like the params); a dict is a stage whose state is that (empty)
# dict. ``asgd`` is the JAX package's own {inner, avg, count}.
_OPT_STAGES = {
    "sgd": (("trace",), ()),
    "adam": (("count", "mu", "nu"), ()),
    "adamax": (("count", "mu", "nu"), ()),
    "adagrad": (("sum_of_squares",), ()),
    "adadelta": ((), ("e_g", "e_x"), ()),
    "rprop": (("step_sizes", "prev_updates"), ()),
    "rmsprop": (("nu",), (), ("trace",)),
    "lars": ({"inner_state": {}}, {"inner_state": {}}, (), ("trace",)),
    "lamb": (("count", "mu", "nu"), (), (), ()),
}


def _sorted(tree: Dict[str, Any]) -> Dict[str, Any]:
    """A dict and its sub-dicts in sorted key order, as a jitted step
    returns flax's trees."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


class Layout:
    """How a trainer's tensors make the flax tree: ``leaves(coll)`` gives
    ``(flax path, port tensors, kind)``, ``full`` the flax leaf of those
    tensors' values (of meta tensors of its shape when ``values`` is
    None), ``split`` the port tensors' values of a flax leaf. This
    default is one port tensor per flax leaf; a tensor-parallel run's
    (``TpLayout``) and a pipelined model's
    (``parallel.pipeline_model.PipelinedModel``) gather and cut."""

    def __init__(self, model: torch.nn.Module):
        self.model = model

    def leaves(self, coll: str):
        for path, name, c, kind in _paths(self.model, coll):
            yield path, [_tensor(self.model, name, c)], kind

    def full(self, tensors, values, kind):
        t = tensors[0]
        v = (torch.empty(t.shape, dtype=t.dtype, device="meta")
             if values is None else values[0])
        return to_flax_layout(v, kind)

    def split(self, tensors, full, kind):
        return [from_flax_layout(full, kind)]

    def bn_counters(self):
        """Every BatchNorm's ``num_batches_tracked``."""
        return [m.num_batches_tracked for m in self.model.modules()
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)]


class TpLayout(Layout):
    """A tensor-parallel model's layout: each leaf gathered over the
    model group from the shards (``parallel.model_parallel.TpShards``,
    collective) and cut back into this rank's shard."""

    def __init__(self, model: torch.nn.Module, shards):
        super().__init__(model)
        self.shards = shards

    def full(self, tensors, values, kind):
        t = tensors[0]
        if values is None:
            return to_flax_layout(torch.empty(
                self.shards.full_shape(t), dtype=t.dtype, device="meta"),
                kind)
        return to_flax_layout(self.shards.gather_leaf(t, values[0]), kind)

    def split(self, tensors, full, kind):
        return [self.shards.slice_leaf(tensors[0],
                                       from_flax_layout(full, kind))]


def _layout(trainer) -> Layout:
    return getattr(trainer, "layout", None) or Layout(trainer.model)


def _layout_tree(layout: Layout, coll: str, value,
                 values: bool = True) -> Dict[str, Any]:
    """The sorted flax tree of ``coll``: each leaf ``layout.full`` of
    ``value(t)`` over its port tensors (collective where the layout
    gathers); meta leaves of the full shapes when not ``values``."""
    return _nest((path, layout.full(
        tensors, [value(t) for t in tensors] if values else None, kind))
        for path, tensors, kind in layout.leaves(coll))


def _i32(n: int) -> np.ndarray:
    return np.asarray(n, np.int32)


def _opt_name(optimizer) -> str:
    from .train.optim import OPTIMIZER_REGISTRY

    for name, cls in OPTIMIZER_REGISTRY.items():
        if type(optimizer) is cls:
            return name
    raise ValueError(f"no flax layout for {type(optimizer).__name__}")


def _hyperparam_names(name: str):
    """The numeric hyperparameters ``inject_hyperparams`` holds: the
    constructor's arguments in order, but for the boolean ones."""
    import inspect

    from .train.optim import OPTIMIZER_REGISTRY

    sig = inspect.signature(OPTIMIZER_REGISTRY[name].__init__)
    return [k for k, p in sig.parameters.items()
            if k not in ("self", "params", "clip_grad_norm")
            and not isinstance(p.default, bool)]


def _optax_base_state(name: str, tree, count) -> Dict[str, Any]:
    """The base optimizer's optax state: ``tree(key)`` makes the
    params-shaped tree of state ``key``, ``count(key)`` an int32
    counter."""
    if name == "asgd":
        return {"inner": {"0": {}, "1": {}}, "avg": tree("avg"),
                "count": count("count")}
    out = {}
    for i, stage in enumerate(_OPT_STAGES[name]):
        if isinstance(stage, dict):
            out[str(i)] = dict(stage)
        else:
            out[str(i)] = {k: count(k) if k == "count" else tree(k)
                           for k in stage}
    return out


def _own_params(opt) -> List[torch.Tensor]:
    """The optimizer's own parameters: the model's, or its FSDP shards,
    or the compressed FSDP exchange's segment."""
    return [p for group in opt.param_groups for p in group["params"]]


def _base_state(trainer, opt, name: str, values: bool) -> Dict[str, Any]:
    """The base optimizer's state in optax's layout: over the flax params
    (full leaves: an FSDP run gathers its shards, a tensor-parallel or
    pipelined run its model group's or stages', collective), or, under
    the compressed FSDP exchange, over its ``(workers, seg)`` segment
    rows (collective in a data-parallel run)."""
    state = opt.state
    first = _own_params(opt)[0]

    def count(key):
        return _i32(state[first][key])

    if opt.fsdp_compress is not None:
        seg, workers = first, opt.fsdp_compress.plan.world
        if not values:
            return _optax_base_state(name, lambda key: torch.empty(
                (workers, seg.numel()), device="meta"), count)
        return _optax_base_state(
            name, lambda key: trainer.gather_rows(state[seg][key]), count)
    fsdp = opt.fsdp

    def get(p, key):
        if fsdp is None:
            return state[p][key].detach()
        return fsdp.gather_leaf(p, state[fsdp.shard_of(p)][key])

    layout = _layout(trainer)
    return _optax_base_state(
        name, lambda key: _layout_tree(layout, "params",
                                       lambda p: get(p, key), values),
        count)


def train_state_to_jax(trainer, *, values: bool = True) -> Dict[str, Any]:
    """The trainer's state as the flax state dict of the JAX ``TrainState``:
    ``{step, params, batch_stats, opt_state}``, every dict in sorted key
    order and every stage state in its fields' order, as after a jitted
    JAX step (so ``utils.msgpack.to_bytes`` of it is the bytes of the
    JAX ``to_bytes``). Kernels in flax's layout; scalars as 0-d int32 /
    float32 arrays. ``opt_state`` is optax's ``inject_hyperparams`` state
    (``count``, ``hyperparams``, ``hyperparams_states``, ``inner_state``)
    with the chain's stages ``[clip_by_global_norm, sign_compress, base]``
    where present, the error feedback as ``(workers, ...)`` rows (one a
    host when hierarchical; collective in a data-parallel run).

    ``values=False`` gives the template: the same tree with the
    params-shaped leaves as meta tensors of their shapes and no
    collective."""
    opt = trainer.optimizer
    name = _opt_name(opt)
    layout = _layout(trainer)
    group = opt.param_groups[0]
    hyper = _sorted({k: np.asarray(group[k], np.float32)
                     for k in _hyperparam_names(name)})
    base = _base_state(trainer, opt, name, values)
    rows = trainer.ef_rows(template=not values)
    stages = []
    if opt.clip_grad_norm is not None:
        stages.append({})
    if opt.grad_transform is not None:
        stages.append(rows)
    if opt.fsdp_compress is not None:
        stages.append({**rows, "inner": base})
    else:
        stages.append(base)
    inner = (stages[0] if len(stages) == 1
             else {str(i): st for i, st in enumerate(stages)})
    return {
        "step": _i32(trainer.step),
        "params": _layout_tree(layout, "params", torch.Tensor.detach,
                               values),
        "batch_stats": _layout_tree(layout, "batch_stats",
                                    torch.Tensor.detach, values),
        "opt_state": {"count": _i32(opt.steps), "hyperparams": hyper,
                      "hyperparams_states": {}, "inner_state": inner},
    }


def _to_tensor(a) -> torch.Tensor:
    """A decoded leaf as a tensor that owns its memory."""
    if torch.is_tensor(a):
        return a.clone()
    return torch.from_numpy(np.array(a))


def train_state_from_jax(state: Dict[str, Any], trainer) -> None:
    """Load a flax ``TrainState`` state dict (``train_state_to_jax``'s
    layout, numpy leaves; e.g. ``utils.checkpoint.load_checkpoint``'s)
    into the trainer: the parameters and running statistics in place,
    the step, and the optimizer's state, hyperparameters and this
    worker's row of the error feedback. The tree must have the
    trainer's structure (``utils.checkpoint`` checks it against
    ``train_state_to_jax(trainer, values=False)``)."""
    opt = trainer.optimizer
    name = _opt_name(opt)
    layout = _layout(trainer)
    with torch.no_grad():
        for coll in ("params", "batch_stats"):
            for path, tensors, kind in layout.leaves(coll):
                srcs = layout.split(
                    tensors, _to_tensor(_get(state[coll], path)), kind)
                for t, src in zip(tensors, srcs):
                    t.copy_(src.to(t.dtype))
        trainer.step = int(np.asarray(state["step"]))
        # flax keeps no batch count: every train step counted one batch
        for counter in layout.bn_counters():
            counter.fill_(trainer.step)
    os_ = state["opt_state"]
    opt.steps = int(np.asarray(os_["count"]))
    for k, v in os_["hyperparams"].items():
        for group in opt.param_groups:
            group[k] = float(np.asarray(v))
    inner = os_["inner_state"]
    idx = 0
    if opt.clip_grad_norm is not None:
        idx += 1
    if opt.grad_transform is not None:
        trainer.load_ef_rows(inner[str(idx)])
        idx += 1
    base = inner[str(idx)] if idx else inner
    fsdp, seg_tx = opt.fsdp, opt.fsdp_compress
    if seg_tx is not None:
        trainer.load_ef_rows({k: base[k] for k in ("ef_residual",
                                                   "ef_residual2")})
        base = base["inner"]
        seg_tx.refresh_segment()
    elif fsdp is not None:
        fsdp.load_full()

    def put(key, tree):
        if seg_tx is not None:
            seg = _own_params(opt)[0]
            row = _to_tensor(np.asarray(tree)[trainer._ef_row])
            opt.state[seg][key] = row.to(seg.device, seg.dtype).contiguous()
            return
        for path, tensors, kind in layout.leaves("params"):
            srcs = layout.split(tensors, _to_tensor(_get(tree, path)), kind)
            for p, src in zip(tensors, srcs):
                if fsdp is not None:
                    src, p = fsdp.slice_leaf(p, src), fsdp.shard_of(p)
                opt.state[p][key] = src.to(p.device, p.dtype).contiguous()

    def put_count(key, v):
        for p in _own_params(opt):
            opt.state[p][key] = int(np.asarray(v))

    if name == "asgd":
        put("avg", base["avg"])
        put_count("count", base["count"])
        return
    for i, stage in enumerate(_OPT_STAGES[name]):
        if isinstance(stage, dict):
            continue
        for k in stage:
            (put_count if k == "count" else put)(k, base[str(i)][k])
