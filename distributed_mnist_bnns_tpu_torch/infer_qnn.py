"""Integer serving for the k-bit QNN family (the JAX package's
``infer_qnn.py``).

``quantize`` maps every value onto the signed 2^(b-1) grid, so for
num_bits <= 8 a quantized weight is an int8 integer (w_int = w_q *
2^(b-1), exact) and a hidden layer becomes

    y = (x_int @ w_int) / 2^(2(b-1)) + bias

with an int8 x int8 -> int32 GEMM (``ops.xnor_gemm.int8_matmul``:
cuBLASLt's ``torch._int_mm`` on a card). Its sums are exact integers:
|sum| <= K * 128^2 reaches 5.03e7 at K = 3,072, above the 2^24 that an
fp32 GEMM of the same values would hold exactly, so no fp32 product
stands in for it. The JAX package runs XLA's int8 dot here; neither
side has a hand-written kernel on this path.

BatchNorm between layers is the eval-time affine (rounded once, as the
fused multiply-add XLA makes of ``a * y + c``), then hardtanh and the
live model's ``quantize``, lifted to its exact integer. The first layer
takes fp32 pixels against ``w_int / 2^(b-1)`` and the head is the fp32
``Dense``. The artifact is the JAX package's ``qnn-mlp`` dict: int8
``w_int`` (in, out) per layer, fp32 biases, raw BN moments, the head.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .infer import _bn_affine_params, _bn_dict, _on, resolve_device
from .models.layers import hard_tanh
from .models.mlp import QnnMLP
from .ops.binarize import quantize
from .ops.xnor_gemm import _fma_f32, int8_matmul

FAMILY = "qnn-mlp"


def _w_int(weight: torch.Tensor, num_bits: int) -> torch.Tensor:
    """The quantized (out, in) weight's exact integers as the JAX (in,
    out) int8 kernel."""
    scale = 2.0 ** (num_bits - 1)
    return torch.round(quantize(weight.detach().t(), num_bits) * scale
                       ).to(torch.int8).contiguous()


@torch.no_grad()
def _freeze_qnn_tensors(model: QnnMLP) -> Dict[str, Any]:
    """The frozen dict of a QnnMLP (the JAX ``_freeze_qnn_tensors``)."""
    if model.num_bits > 8:
        raise ValueError(
            f"int8 serving covers num_bits <= 8, got {model.num_bits}")
    if model.stochastic:
        raise ValueError("stochastic rounding is a train-time feature; "
                         "freeze the deterministic eval path")
    fcs = (model.fc1, model.fc2, model.fc3)
    frozen: Dict[str, Any] = {
        "family": FAMILY,
        "num_bits": model.num_bits,
        "layers": [{"w_int": _w_int(fc.weight, model.num_bits),
                    "bias": fc.bias.detach()} for fc in fcs],
        "bns": [_bn_dict(bn) for bn in (model.bn1, model.bn2, model.bn3)],
        "head_w": model.head.weight.detach().t().contiguous(),
        "head_b": model.head.bias.detach(),
    }
    latent = sum(fc.weight.numel() for fc in fcs) * 4
    int8_bytes = sum(l["w_int"].numel() for l in frozen["layers"])
    frozen["info"] = {
        "family": FAMILY,
        "latent_fp32_weight_bytes": latent,
        "frozen_weight_bytes": int8_bytes,
        "compression": round(latent / int8_bytes, 2),
        "packed_layers": [f"QuantizedDense_{i}" for i in range(3)],
    }
    return frozen


class FrozenQNN:
    """The int8 predictor: ``predictor(images) -> log-probs`` (a tensor on
    the predictor's device) for (B, ...) images, numpy or torch."""

    def __init__(self, frozen: Dict[str, Any], device: torch.device):
        if frozen.get("family") != FAMILY:
            raise ValueError(
                f"not a {FAMILY} artifact: {frozen.get('family')!r}")
        self.device = device
        self.num_bits = int(frozen["num_bits"])
        self.scale = 2.0 ** (self.num_bits - 1)
        first, *hidden = frozen["layers"]
        self.w0 = first["w_int"].to(device=device, dtype=torch.float32)
        self.b0 = first["bias"].to(device=device, dtype=torch.float32)
        # (N, K) int8: ``int8_matmul``'s column-major right operand
        self.hidden = [
            (l["w_int"].to(device=device, dtype=torch.int8).t().contiguous(),
             l["bias"].to(device=device, dtype=torch.float32))
            for l in hidden]
        self.bns = [_bn_affine_params(_on(b["params"], device),
                                      _on(b["stats"], device))
                    for b in frozen["bns"]]
        self.wh = frozen["head_w"].to(device=device, dtype=torch.float32)
        self.bh = frozen["head_b"].to(device=device, dtype=torch.float32)

    def int_inputs(self, y: torch.Tensor, bn: int) -> torch.Tensor:
        """BN ``bn``'s affine, hardtanh and ``quantize`` of ``y``, as the
        int8 integers the next GEMM takes."""
        a, c = self.bns[bn]
        h = hard_tanh(_fma_f32(a, y, c))
        return (quantize(h, self.num_bits) * self.scale).to(torch.int8)

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        x = images.to(device=self.device, dtype=torch.float32)
        x = x.reshape(x.shape[0], -1)
        y = (x @ self.w0) / self.scale + self.b0
        for i, (wt, b) in enumerate(self.hidden):
            acc = int8_matmul(self.int_inputs(y, i), wt)
            y = acc.to(torch.float32) / (self.scale * self.scale) + b
        a, c = self.bns[2]
        h = hard_tanh(_fma_f32(a, y, c))
        return torch.log_softmax(h @ self.wh + self.bh, dim=-1)


def _build_qnn_apply(frozen: Dict[str, Any], device) -> FrozenQNN:
    """The int8 predictor of a frozen dict, TF32 off (the first layer and
    the head are fp32 GEMMs)."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    return FrozenQNN(frozen, dev)


def freeze_qnn_mlp(model: QnnMLP, *, device="cuda"
                   ) -> Tuple[FrozenQNN, Dict[str, Any]]:
    """Freeze a QnnMLP into the int8 predictor on ``device``; it computes
    what ``model.eval()(images)`` does, up to fp32 summation order (the
    hidden GEMMs accumulate exactly in int32)."""
    frozen = _freeze_qnn_tensors(model)
    return _build_qnn_apply(frozen, device), frozen["info"]
