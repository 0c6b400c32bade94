"""Frozen-model inference for the binarized MLP: the packed-bitplane
serving path. ``export_packed`` and ``load_packed`` also take the
binarized CNN (``family="bnn-cnn"``, ``infer_conv``) and the binarized
LM (``family="bnn-transformer"``, ``kind="lm"``, ``infer_transformer``),
dispatched on the family as the JAX ``_freeze_any`` / ``_build_any``.

Counterpart of the JAX package's ``infer.py`` for the ``bnn-mlp`` family.
Once training ends the fp32 latent weights are dead weight: serving needs
only the ±1 weights, which pack to 1 bit per parameter
(``ops.prepack_weights``), and the hidden GEMMs run on the XNOR-popcount
kernels. At eval time ``binarize(hardtanh(BN(y)))`` folds into a
per-channel threshold compare, because hardtanh keeps the sign and
binarize is the sign:

    sign(BN(y)) = sign(g) * sign(y - theta),  theta = mu - b*sqrt(var+eps)/g

so the middle layer emits the next layer's ±1 activations straight from
its GEMM (K2, ``xnor_matmul_packed_sign``), and only the last packed
layer computes the real BN affine + hardtanh for the fp32 head (K3,
``xnor_matmul_packed_affine``). The folding math is the JAX package's,
line for line, including g < 0, g == 0 and >= ties.

The artifact is the port's own format: ``torch.save`` of plain tensors,
ints, strings and floats under the same keys as the JAX package's frozen
dict. Entry points take a ``device``, default ``"cuda"``; with no CUDA
device they raise unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

from .models.mlp import BnnMLP
from .ops.binarize import binarize_ste
from .ops.xnor_gemm import (
    prepack_weights,
    xnor_matmul_packed_affine,
    xnor_matmul_packed_sign,
)

_BN_EPS = 1e-5  # matches BnnMLP's BatchNorm epsilon

FAMILY = "bnn-mlp"


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``. A
    CUDA device without a card raises; there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev


def _sqrt_f32(v: torch.Tensor) -> torch.Tensor:
    """Correctly rounded fp32 square root, as numpy's and XLA's: taken in
    float64 and rounded to fp32, which is exact for a square root
    (53 >= 2 * 24 + 2 bits). PyTorch's vectorised CPU ``sqrt`` is one ulp
    off on some fp32 inputs, which would move a threshold by one ulp."""
    return torch.sqrt(v.to(torch.float32).double()).to(torch.float32)


def _bn_sign_epilogue(
    bn_params: Dict, bn_stats: Dict
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``binarize(hardtanh(BN(y)))`` as an (a, t) threshold encoding:
    out = where(a*y >= t, +1, -1) with a=+1/t=theta (g>0: y >= theta),
    a=-1/t=-theta (g<0: y <= theta), a=0/t=-c (g==0: the constant sign
    of the BN bias; 0 >= -c picks c). theta = mu - b*sqrt(var+eps)/g."""
    g = bn_params["scale"]
    b = bn_params["bias"]
    mu = bn_stats["mean"]
    s = _sqrt_f32(bn_stats["var"] + _BN_EPS)
    theta = mu - b * s / torch.where(g == 0.0, 1.0, g)
    a = torch.sign(g)
    c = torch.where(b >= 0.0, 1.0, -1.0)
    t = torch.where(g > 0.0, theta, torch.where(g < 0.0, -theta, -c))
    return a.to(torch.float32), t.to(torch.float32)


def _bn_affine_params(
    bn_params: Dict, bn_stats: Dict
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-time BN as per-channel (a, c): BN(y) = a*y + c."""
    g = bn_params["scale"]
    b = bn_params["bias"]
    mu = bn_stats["mean"]
    s = _sqrt_f32(bn_stats["var"] + _BN_EPS)
    return g / s, b - g * mu / s


def _bn_dict(bn: torch.nn.BatchNorm1d) -> Dict[str, Dict[str, torch.Tensor]]:
    return {
        "params": {"scale": bn.weight.detach(), "bias": bn.bias.detach()},
        "stats": {"mean": bn.running_mean.detach(),
                  "var": bn.running_var.detach()},
    }


@torch.no_grad()
def _freeze_tensors(model: BnnMLP) -> Dict[str, Any]:
    """The frozen artifact from a BnnMLP's weights: ±1 first-layer
    weights (in, out), packed hidden bitplanes, raw BN params/stats
    (thresholds are rebuilt at load), fp32 head (in, out). Keys and
    layouts are the JAX package's ``_freeze_tensors``."""
    if not isinstance(model, BnnMLP):
        raise ValueError(f"freeze_bnn_mlp needs a BnnMLP, got {type(model)}")
    if not model.binarized:
        raise ValueError("freeze_bnn_mlp requires a binarized BnnMLP")
    layers = []
    for fc in (model.fc2, model.fc3):
        wp, k, n = prepack_weights(binarize_ste(fc.weight).t())
        layers.append({"wp": wp, "k": k, "n": n, "bias": fc.bias.detach()})
    frozen = {
        "family": FAMILY,
        "w1": binarize_ste(model.fc1.weight).t().contiguous(),
        "b1": model.fc1.bias.detach(),
        "bn0": _bn_dict(model.bn1),
        "layers": layers,
        "bn1": _bn_dict(model.bn2),
        "bn2": _bn_dict(model.bn3),
        "head_w": model.head.weight.detach().t().contiguous(),
        "head_b": model.head.bias.detach(),
    }
    latent_bytes = sum(
        fc.weight.numel() * 4 for fc in (model.fc1, model.fc2, model.fc3)
    )
    packed_bytes = frozen["w1"].numel() * 4 + sum(
        l["wp"].numel() * 4 for l in layers
    )
    frozen["info"] = {
        "family": FAMILY,
        "latent_fp32_weight_bytes": latent_bytes,
        "frozen_weight_bytes": packed_bytes,
        "compression": round(latent_bytes / packed_bytes, 2),
        "packed_layers": ["BinarizedDense_1", "BinarizedDense_2"],
    }
    return frozen


def _on(d: Dict, device: torch.device) -> Dict:
    return {k: v.to(device=device, dtype=torch.float32) for k, v in d.items()}


class FrozenMLP:
    """Packed predictor: ``predictor(images) -> log-probs`` (a tensor on
    the predictor's device) for (B, ...) images, numpy or torch."""

    def __init__(self, frozen: Dict[str, Any], device: torch.device):
        if frozen.get("family", FAMILY) != FAMILY:
            raise ValueError(
                f"unknown packed-artifact family {frozen.get('family')!r}"
            )
        self.device = device
        self.w1 = frozen["w1"].to(device=device, dtype=torch.float32)
        self.b1 = frozen["b1"].to(device=device, dtype=torch.float32)
        bn0 = frozen["bn0"]
        self.a1, self.t1 = _bn_sign_epilogue(
            _on(bn0["params"], device), _on(bn0["stats"], device)
        )
        self.packed = [
            (l["wp"].to(device).contiguous(), int(l["k"]), int(l["n"]),
             l["bias"].to(device=device, dtype=torch.float32))
            for l in frozen["layers"]
        ]
        bn1, bn2 = frozen["bn1"], frozen["bn2"]
        self.a_mid, self.t_mid = _bn_sign_epilogue(
            _on(bn1["params"], device), _on(bn1["stats"], device)
        )
        self.a_fin, self.c_fin = _bn_affine_params(
            _on(bn2["params"], device), _on(bn2["stats"], device)
        )
        self.wh = frozen["head_w"].to(device=device, dtype=torch.float32)
        self.bh = frozen["head_b"].to(device=device, dtype=torch.float32)

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        x = images.to(device=self.device, dtype=torch.float32)
        x = x.reshape(x.shape[0], -1)
        y = x @ self.w1 + self.b1
        bits = torch.where(self.a1 * y >= self.t1, 1.0, -1.0)
        wp, k, n, b2 = self.packed[0]
        bits = xnor_matmul_packed_sign(
            bits, wp, k, n, self.a_mid, self.t_mid, b2
        )
        wp, k, n, b3 = self.packed[1]
        h = xnor_matmul_packed_affine(bits, wp, k, n, self.a_fin, self.c_fin, b3)
        return torch.log_softmax(h @ self.wh + self.bh, dim=-1)


def _build_apply(frozen: Dict[str, Any], device) -> FrozenMLP:
    """Packed predictor from a frozen artifact (in memory or from disk).

    TF32 is switched off for fp32 matrix products and convolutions: the
    first layer and the head are fp32 GEMMs, and TF32 would round their
    inputs to 10 mantissa bits, which the JAX reference does not do."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return FrozenMLP(frozen, dev)


def freeze_bnn_mlp(
    model: BnnMLP, *, device="cuda"
) -> Tuple[FrozenMLP, Dict[str, Any]]:
    """Freeze a binarized BnnMLP into a packed predictor on ``device``.

    The predictor computes what ``model.eval()(images)`` computes (up to
    measure-zero threshold ties), with hidden weights stored as packed
    bitplanes and BN/hardtanh/binarize folded into thresholds. ``info``
    reports the packed weight footprint against the fp32 latents."""
    frozen = _freeze_tensors(model)
    return _build_apply(frozen, device), frozen["info"]


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree


def _freeze_any(model) -> Dict[str, Any]:
    """The frozen dict of any freezable model (the JAX ``_freeze_any``):
    a binarized BnnMLP, a BinarizedCNN or a BinarizedLM."""
    from .infer_conv import BinarizedCNN, _freeze_cnn_tensors
    from .infer_transformer import BinarizedLM, _freeze_lm_tensors

    if isinstance(model, BnnMLP):
        return _freeze_tensors(model)
    if isinstance(model, BinarizedCNN):
        return _freeze_cnn_tensors(model)
    if isinstance(model, BinarizedLM):
        return _freeze_lm_tensors(model)
    raise ValueError(f"no packed freeze for {type(model).__name__} "
                     "(freezable: BnnMLP, BinarizedCNN, BinarizedLM)")


def _build_any(frozen: Dict[str, Any], device: torch.device):
    """The predictor of a frozen dict, by its family (the JAX
    ``_build_any``)."""
    family = frozen.get("family", FAMILY)
    if family == FAMILY:
        return _build_apply(frozen, device)
    if family == "bnn-cnn":
        from .infer_conv import FrozenCNN

        return FrozenCNN(frozen, device)
    if family == "bnn-transformer":
        from .infer_transformer import _build_transformer_apply

        return _build_transformer_apply(frozen, device)
    raise ValueError(f"unknown packed-artifact family {family!r}")


def export_packed(model, path: str) -> Dict[str, Any]:
    """Write the frozen artifact of a binarized BnnMLP, a BinarizedCNN
    or a BinarizedLM to ``path`` (``torch.save`` of plain tensors). The ±1
    first layer (the MLP's ``w1``, the CNN's ``conv1_w``) goes as int8
    (4x smaller); the predictor casts it back to fp32. Returns the
    size-info dict."""
    frozen = _to_cpu(_freeze_any(model))
    for key in ("w1", "conv1_w"):
        if key in frozen:
            frozen[key] = frozen[key].to(torch.int8)
    torch.save(frozen, path)
    return frozen["info"]


def load_frozen(path: str) -> Dict[str, Any]:
    """The frozen dict of an ``export_packed`` artifact, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_packed(path: str, *, device="cuda"):
    """Restore an ``export_packed`` artifact into a predictor on
    ``device`` (None: "cuda"; raises without a card): a FrozenMLP for a
    ``bnn-mlp`` artifact, a ``FrozenCNN`` for a ``bnn-cnn`` one (flat
    (B, 784) or (B, 28, 28, 1) input), the LM's full-window ``FrozenLM``
    for a ``bnn-transformer`` one. Returns (predictor, info)."""
    dev = resolve_device(device)
    frozen = load_frozen(path)
    return _build_any(frozen, dev), dict(frozen["info"])
