"""Packed-bitplane serving of the binarized CNN (``bnn-cnn``).

Counterpart of the ``bnn-cnn`` half of the JAX package's
``infer_conv.py`` (the xnor-resnet half is not ported yet). After
training, the fp32 latents are dead weight: the hidden conv and the
dense layer pack to 1 bit per weight and run on K1
(``xnor_matmul_packed``), twice a batch:

  * conv2 as a patch GEMM: ``im2col`` (the training layer's lowering)
    then K1 on the pre-packed (cin*kh*kw, F) bitplanes (M = B*14*14,
    K = 9*w1), plus the SAME-padding correction and the bias. Zero
    border taps pack as -1; the correction (``conv_padding_correction``,
    the training layer's helper) is rebuilt at load from the shipped
    (kh, kw, F) per-tap channel sums for the artifact's resolution;
  * the dense layer on the flattened (h, w, c) bits (K = 49*w2), then
    its eval BatchNorm as the affine ``a * y + c`` and the clip, as the
    JAX package computes it (no fused epilogue).

Between them ``binarize(hardtanh(BN(y)))`` folds to the per-channel
threshold compare of ``infer._bn_sign_epilogue``, and max-pooling
commutes with it, so pooled hidden activations are ±1 end to end. The
first conv (raw pixels times the ±1 kernel) and the head stay fp32, as
in the live model; the convs run without TF32
(``ops.xnor_gemm.conv_precision``).

The artifact keeps the JAX package's keys and layouts: the ±1 first
kernel HWIO (int8 on disk), packed K-major words, ``tap_sums`` (kh, kw,
F), raw BN moments, the head (in, out). It is resolution-specific (the
padding correction bakes in Ho x Wo): the predictor checks the input's.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .models.bnn_cnn import BinarizedCNN
from .models.layers import BinarizedConv, BinarizedDense
from .ops.binarize import binarize_ste
from .ops.xnor_gemm import (
    conv2d,
    conv_padding_correction,
    conv_patch_weight,
    im2col,
    prepack_weights,
    xnor_matmul_packed,
)

FAMILY = "bnn-cnn"
# the (H, W, C) the model's dense layer is sized for (7 * 7 * w2 inputs)
INPUT_SHAPE = (28, 28, 1)


def _out_hw(hw, strides):
    """SAME-padding output resolution."""
    return tuple(-(-d // s) for d, s in zip(hw, strides))


@torch.no_grad()
def _freeze_conv(weight: torch.Tensor, bias: torch.Tensor, in_hw,
                 strides) -> Dict[str, Any]:
    """One hidden BinarizedConv: its (F, cin, kh, kw) latent weight as
    packed bitplanes of the (cin*kh*kw, F) patch matrix, plus the (kh,
    kw, F) per-tap channel sums the padding correction is rebuilt from."""
    f, _, kh, kw = weight.shape
    wb = binarize_ste(weight)
    wp, k, n = prepack_weights(conv_patch_weight(wb).t())
    return {
        "wp": wp, "k": int(k), "n": int(n), "bias": bias.detach(),
        "kh": int(kh), "kw": int(kw), "strides": list(strides),
        "in_hw": list(in_hw), "tap_sums": wb.sum(dim=1).permute(1, 2, 0),
    }


@torch.no_grad()
def _freeze_cnn_tensors(model: BinarizedCNN) -> Dict[str, Any]:
    """The frozen artifact of a BinarizedCNN (the JAX
    ``_freeze_cnn_tensors``: the same keys and layouts)."""
    from .infer import _bn_dict

    if not isinstance(model, BinarizedCNN):
        raise ValueError(f"freeze_bnn_cnn needs a BinarizedCNN, got "
                         f"{type(model).__name__}")
    layers = [m for m in model.modules()
              if isinstance(m, (BinarizedConv, BinarizedDense))]
    if model.stochastic or any(m.stochastic for m in layers):
        raise ValueError("stochastic binarization is train-time; freeze "
                         "the deterministic eval path")
    if any(m.scale for m in layers):
        raise ValueError("XNOR-Net alpha scaling (scale=True) is not folded "
                         "by the packed freeze; freeze an unscaled model")
    h, w, _ = INPUT_SHAPE
    hw1 = _out_hw((h, w), (1, 1))
    hw_pool1 = (hw1[0] // 2, hw1[1] // 2)
    frozen = {
        "family": FAMILY,
        "arch": {"input_shape": list(INPUT_SHAPE)},
        # fp32 first layer: raw pixels x the ±1 kernel (HWIO, as JAX's)
        "conv1_w": binarize_ste(model.conv1.weight).permute(2, 3, 1, 0)
        .contiguous(),
        "conv1_b": model.conv1.bias.detach(),
        "bn0": _bn_dict(model.bn1),
        "conv2": _freeze_conv(model.conv2.weight, model.conv2.bias,
                              hw_pool1, (1, 1)),
        "bn1": _bn_dict(model.bn2),
        "bn2": _bn_dict(model.bn3),
        "head_w": model.head.weight.detach().t().contiguous(),
        "head_b": model.head.bias.detach(),
    }
    wp, k, n = prepack_weights(binarize_ste(model.fc.weight).t())
    frozen["dense"] = {"wp": wp, "k": int(k), "n": int(n),
                       "bias": model.fc.bias.detach()}
    latent = sum(m.weight.numel() * 4
                 for m in (model.conv1, model.conv2, model.fc))
    packed = (frozen["conv1_w"].numel() + frozen["conv2"]["wp"].numel()
              + wp.numel()) * 4
    frozen["info"] = {
        "family": FAMILY,
        "latent_fp32_weight_bytes": latent,
        "frozen_weight_bytes": packed,
        "compression": round(latent / packed, 2),
        "packed_layers": ["BinarizedConv_1", "BinarizedDense_0"],
    }
    return frozen


def _maxpool_bits_nhwc(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 VALID max-pool of (B, H, W, C) ±1 maps (any +1 wins)."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


class FrozenCNN:
    """Packed ``bnn-cnn`` predictor: ``predictor(images) -> log-probs``
    for (B, H*W*C) flat or (B, H, W, C) images, numpy or torch."""

    def __init__(self, frozen: Dict[str, Any], device: torch.device):
        from .infer import _bn_affine_params, _bn_sign_epilogue, _on

        if frozen.get("family") != FAMILY:
            raise ValueError(f"not a {FAMILY} artifact: family "
                             f"{frozen.get('family')!r}")

        def f32(t):
            return t.to(device=device, dtype=torch.float32)

        def per_channel(fn, bn):
            return fn(_on(bn["params"], device), _on(bn["stats"], device))

        self.device = device
        self.ishape = tuple(int(d) for d in frozen["arch"]["input_shape"])
        self.w1 = f32(frozen["conv1_w"]).permute(3, 2, 0, 1).contiguous()
        self.b1 = f32(frozen["conv1_b"])
        self.a0, self.t0 = per_channel(_bn_sign_epilogue, frozen["bn0"])
        c2 = frozen["conv2"]
        strides = tuple(int(s) for s in c2["strides"])
        self.c2 = (c2["wp"].to(device).contiguous(), int(c2["k"]),
                   int(c2["n"]), (int(c2["kh"]), int(c2["kw"])), strides)
        self.c2_in_hw = tuple(int(d) for d in c2["in_hw"])
        # conv2's padding correction at the artifact's resolution
        self.c2_corr = conv_padding_correction(
            f32(c2["tap_sums"]), self.c2_in_hw, strides, "SAME")
        self.c2_bias = f32(c2["bias"])
        self.a1, self.t1 = per_channel(_bn_sign_epilogue, frozen["bn1"])
        d = frozen["dense"]
        self.dense = (d["wp"].to(device).contiguous(), int(d["k"]),
                      int(d["n"]), f32(d["bias"]))
        self.a2, self.c_aff = per_channel(_bn_affine_params, frozen["bn2"])
        self.wh = f32(frozen["head_w"])
        self.bh = f32(frozen["head_b"])

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        x = images.to(device=self.device, dtype=torch.float32)
        if x.dim() == 2:
            x = x.reshape(x.shape[0], *self.ishape)
        elif tuple(x.shape[1:]) != self.ishape:
            raise ValueError(
                f"frozen cnn expects {self.ishape} inputs, got "
                f"{tuple(x.shape[1:])} (the packed convs bake in this "
                "resolution; re-freeze for a different input size)")
        y = conv2d(x.permute(0, 3, 1, 2), self.w1) + self.b1[:, None, None]
        bits = torch.where(self.a0[:, None, None] * y
                           >= self.t0[:, None, None], 1.0, -1.0)
        bits = torch.nn.functional.max_pool2d(bits, 2, 2)
        wp, k, n, kernel, strides = self.c2
        if tuple(bits.shape[2:]) != self.c2_in_hw:
            raise ValueError(
                f"frozen conv was packed for {self.c2_in_hw} inputs, got "
                f"{tuple(bits.shape[2:])} (the padding correction is "
                "resolution-specific; re-freeze for this input size)")
        patches = im2col(bits, kernel, strides, "SAME")
        b, ho, wo, _ = patches.shape
        y = xnor_matmul_packed(patches.reshape(-1, k), wp, k, n).reshape(
            b, ho, wo, n) + self.c2_corr + self.c2_bias
        bits = _maxpool_bits_nhwc(torch.where(self.a1 * y >= self.t1,
                                              1.0, -1.0))
        dwp, dk, dn, db = self.dense
        y = xnor_matmul_packed(bits.reshape(b, -1), dwp, dk, dn) + db
        h = torch.clamp(self.a2 * y + self.c_aff, -1.0, 1.0)
        return torch.log_softmax(h @ self.wh + self.bh, dim=-1)


def freeze_bnn_cnn(model: BinarizedCNN, *, device="cuda") -> Tuple[FrozenCNN, Dict[str, Any]]:
    """Freeze a trained BinarizedCNN into a packed predictor on
    ``device`` (None: "cuda"; raises without a card). It computes what
    ``model.eval()(images)`` computes, up to threshold ties of the fp32
    first conv; ``info`` reports the packed footprint."""
    from .infer import resolve_device

    frozen = _freeze_cnn_tensors(model)
    return FrozenCNN(frozen, resolve_device(device)), frozen["info"]
