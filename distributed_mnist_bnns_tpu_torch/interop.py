"""Carry weights and frozen artifacts across from the JAX package.

The JAX package's trees arrive as numpy arrays (``np.asarray`` of every
leaf, or an ``.npz`` of the flattened tree), so nothing here imports JAX.

  params_from_jax(variables)  {"params", "batch_stats"} -> the port's BnnMLP
  frozen_from_jax(frozen)     JAX ``infer._freeze_tensors`` dict -> the
                              port's frozen artifact (same keys)
  lm_params_from_jax(params)  a JAX BinarizedLM's params -> the port's
                              BinarizedLM
  frozen_lm_from_jax(frozen)  JAX ``infer_transformer._freeze_lm_tensors``
                              dict -> the port's frozen LM artifact
  JaxFlatOrder(model)         a BnnMLP's parameters in the order and
                              layout ``jax.flatten_util.ravel_pytree``
                              gives the flax params

Flax names map as BinarizedDense_0..2 -> fc1..fc3, BatchNorm_0..2 ->
bn1..bn3 (scale/bias -> weight/bias, mean/var -> running stats) and
Dense_0 -> head, the names the JAX ``infer.py`` reads. For the LM:
tok_embed/embedding -> tok_embed, pos_embed, TransformerBlock_i ->
blocks.i (ln_attn/ln_mlp scale -> weight; BinarizedSelfAttention_0/
BinarizedDense_0..3, or Dense_0..3 for fp32 attention, -> attn.q, k, v,
out; BinarizedDense_0/1 -> mlp1/mlp2), ln_head and head. Flax kernels are
(in, out); the port's weights are (out, in), as ``nn.Linear``'s.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .models.mlp import BnnMLP
from .models.transformer import BinarizedLM

_DENSE = ("BinarizedDense_0", "BinarizedDense_1", "BinarizedDense_2")
_FCS = ("fc1", "fc2", "fc3")
_BNS = (("BatchNorm_0", "bn1"), ("BatchNorm_1", "bn2"), ("BatchNorm_2", "bn3"))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(
    variables: Dict[str, Any], model: Optional[BnnMLP] = None, **model_kw
) -> BnnMLP:
    """Load a JAX BnnMLP's ``{"params", "batch_stats"}`` (numpy leaves)
    into ``model``, or into a new BnnMLP of the tree's widths built with
    ``model_kw``. Returns the model in eval mode."""
    p, s = variables["params"], variables["batch_stats"]
    kernels = [np.asarray(p[name]["kernel"]) for name in _DENSE]
    head = np.asarray(p["Dense_0"]["kernel"])
    if model is None:
        model = BnnMLP(
            hidden=tuple(k.shape[1] for k in kernels),
            num_classes=head.shape[1],
            in_features=kernels[0].shape[0],
            **model_kw,
        )
    state = {}
    for name, fc, kern in zip(_DENSE, _FCS, kernels):
        state[f"{fc}.weight"] = _t(kern.T)
        state[f"{fc}.bias"] = _t(p[name]["bias"])
    for flax_name, bn in _BNS:
        state[f"{bn}.weight"] = _t(p[flax_name]["scale"])
        state[f"{bn}.bias"] = _t(p[flax_name]["bias"])
        state[f"{bn}.running_mean"] = _t(s[flax_name]["mean"])
        state[f"{bn}.running_var"] = _t(s[flax_name]["var"])
        state[f"{bn}.num_batches_tracked"] = torch.tensor(0)
    state["head.weight"] = _t(head.T)
    state["head.bias"] = _t(p["Dense_0"]["bias"])
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
    """A BnnMLP's parameters as ``jax.flatten_util.ravel_pytree`` lays out
    the JAX model's params: leaves in sorted path order (``BatchNorm_0..2``,
    ``BinarizedDense_0..2``, ``Dense_0``; ``bias`` before ``kernel`` /
    ``scale`` in each), each kernel in flax's (in, out) layout, so the
    port's (out, in) weights are transposed.

    ``entries`` lists ``(flax path, parameter, transposed)`` in that
    order. ``flatten`` lays tensors shaped like the parameters (their
    gradients, or by default the parameters themselves) end to end in
    one fp32 vector; ``unflatten`` cuts such a vector back into tensors
    shaped like the parameters, keyed by parameter."""

    def __init__(self, model: BnnMLP):
        names = dict(model.named_parameters())
        entries: List[Tuple[Tuple[str, str], str, bool]] = []
        for flax_name, bn in _BNS:
            entries.append(((flax_name, "bias"), f"{bn}.bias", False))
            entries.append(((flax_name, "scale"), f"{bn}.weight", False))
        for flax_name, fc in zip(_DENSE + ("Dense_0",), _FCS + ("head",)):
            entries.append(((flax_name, "bias"), f"{fc}.bias", False))
            entries.append(((flax_name, "kernel"), f"{fc}.weight", True))
        if {e[1] for e in entries} != set(names):
            raise ValueError("JaxFlatOrder covers the BnnMLP's parameters "
                             f"only, not {sorted(names)}")
        self.entries = [("/".join(path), names[name], tr)
                        for path, name, tr in sorted(entries)]
        self.n_params = sum(p.numel() for _, p, _ in self.entries)

    def flatten(self, tensors: Optional[Mapping[torch.nn.Parameter,
                                                torch.Tensor]] = None
                ) -> torch.Tensor:
        parts = []
        for _, p, tr in self.entries:
            t = p.detach() if tensors is None else tensors[p]
            parts.append((t.t() if tr else t).reshape(-1))
        return torch.cat(parts).to(torch.float32)

    def unflatten(self, flat: torch.Tensor
                  ) -> Dict[torch.nn.Parameter, torch.Tensor]:
        out, start = {}, 0
        for _, p, tr in self.entries:
            n = p.numel()
            chunk = flat[start:start + n]
            out[p] = (chunk.reshape(p.shape[1], p.shape[0]).t() if tr
                      else chunk.reshape(p.shape))
            start += n
        return out
