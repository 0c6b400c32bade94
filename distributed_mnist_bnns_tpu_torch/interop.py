"""Carry weights and frozen artifacts across from the JAX package.

The JAX package's trees arrive as numpy arrays (``np.asarray`` of every
leaf, or an ``.npz`` of the flattened tree), so nothing here imports JAX.

  params_from_jax(variables)  {"params", "batch_stats"} -> the port's
                              model of that family (BnnMLP, binarized or
                              fp32; ConvNet, DeepCNN, BinarizedCNN)
  frozen_from_jax(frozen)     JAX ``infer._freeze_tensors`` dict -> the
                              port's frozen artifact (same keys)
  lm_params_from_jax(params)  a JAX BinarizedLM's params -> the port's
                              BinarizedLM
  frozen_lm_from_jax(frozen)  JAX ``infer_transformer._freeze_lm_tensors``
                              dict -> the port's frozen LM artifact
  JaxFlatOrder(model)         a model's parameters in the order and
                              layout ``jax.flatten_util.ravel_pytree``
                              gives the flax params

Each model's ``flax_names()`` maps its submodules to flax's module names
(e.g. BinarizedDense_0..2 -> fc1..fc3, BatchNorm_0..2 -> bn1..bn3,
Dense_0 -> head for the MLP, the names the JAX ``infer.py`` reads), each
of a kind: "dense" (flax (in, out) kernel, the port's (out, in)
weight), "conv" (flax HWIO, the port's OIHW) or "bn" (scale/bias ->
weight/bias, mean/var -> the running statistics). For the LM:
tok_embed/embedding -> tok_embed, pos_embed, TransformerBlock_i ->
blocks.i (ln_attn/ln_mlp scale -> weight; BinarizedSelfAttention_0/
BinarizedDense_0..3, or Dense_0..3 for fp32 attention, -> attn.q, k, v,
out; BinarizedDense_0/1 -> mlp1/mlp2), ln_head and head.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

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


def from_flax_layout(a, kind: str) -> torch.Tensor:
    """The inverse of ``to_flax_layout`` for a flax kernel."""
    t = a if torch.is_tensor(a) else _t(a)
    if kind == "dense" and t.dim() == 2:
        return t.t()
    if kind == "conv" and t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    return t


# (port parameter or buffer, flax collection, flax leaf) of each kind
_LEAVES = {
    "dense": (("weight", "params", "kernel"), ("bias", "params", "bias")),
    "conv": (("weight", "params", "kernel"), ("bias", "params", "bias")),
    "bn": (("weight", "params", "scale"), ("bias", "params", "bias"),
           ("running_mean", "batch_stats", "mean"),
           ("running_var", "batch_stats", "var")),
}


def _model_from_tree(p, **model_kw) -> torch.nn.Module:
    """A model of the family and widths of a JAX model's params:
    BinarizedCNN (BinarizedConv_0, 1), DeepCNN (Conv_0..2), ConvNet
    (Conv_0, 1) or BnnMLP, binarized (BinarizedDense_0..2, Dense_0) or
    fp32 (Dense_0..3)."""
    from .models import BinarizedCNN, ConvNet, DeepCNN

    def shape(name):
        return np.asarray(p[name]["kernel"]).shape

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
    for sub, flax_name, kind in model.flax_names():
        for port, coll, leaf in _LEAVES[kind]:
            tree = p if coll == "params" else s
            state[f"{sub}.{port}"] = from_flax_layout(
                tree[flax_name][leaf], kind)
        if kind == "bn":
            state[f"{sub}.num_batches_tracked"] = torch.tensor(0)
    model.load_state_dict(state, strict=True)
    return model.eval()


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
        entries = []
        for sub, flax_name, kind in model.flax_names():
            for port, coll, leaf in _LEAVES[kind]:
                if coll == "params":
                    entries.append(((flax_name, leaf), f"{sub}.{port}", kind))
        if {e[1] for e in entries} != set(names):
            raise ValueError("JaxFlatOrder: flax_names does not cover the "
                             f"parameters {sorted(names)}")
        entries.sort()
        self.entries = [("/".join(path), names[name], path[1] == "kernel")
                        for path, name, _ in entries]
        self._kinds = [kind if path[1] == "kernel" else None
                       for path, _, kind in entries]
        self.n_params = sum(p.numel() for _, p, _ in self.entries)

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
