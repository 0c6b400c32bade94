"""Packed-bitplane serving of the binarized conv families: the binarized
CNN (``bnn-cnn``, ``FrozenCNN``) and the XNOR-ResNets (``xnor-resnet``,
``FrozenResNet``).

Counterpart of the JAX package's ``infer_conv.py``. After training, the
fp32 latents are dead weight: the hidden conv and the dense layer of
bnn-cnn pack to 1 bit per weight and run on K1 (``xnor_matmul_packed``),
twice a batch:

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

An XNOR-ResNet (basic blocks and the CIFAR stem, or bottlenecks and the
ImageNet stem) freezes block by block: each BN -> sign -> BinarizedConv
pair becomes the threshold compare and the packed conv, a 3x3 or
strided conv as ``im2col`` + K1 + the padding correction (from SAME at
its stride) + bias. A bottleneck's interior 1x1/stride-1 conv0 has no
padding taps and its patches are its input, so its GEMM takes the next
BN's threshold in its epilogue: K2 (``xnor_matmul_packed_sign``) emits
conv1's ±1 input directly (``_resnet_block_pairs``, JAX's fusion gate).
The residual stream (channels last, as JAX's), the stem (and the
ImageNet stem's 3x3/2 SAME max-pool), the projection shortcuts and the
final BN affine + relu + mean + head stay fp32, the convs in
``conv_precision``. A served resnet18 batch launches K1 16 times, a
resnet50 batch K1 32 times and K2 16 times. ``scale=True`` (XNOR-Net
alpha) is not folded and is refused, as JAX refuses it.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .models.bnn_cnn import BinarizedCNN
from .models.layers import BinarizedConv, BinarizedDense
from .models.resnet import XnorResNet, max_pool_same
from .ops.binarize import binarize_ste
from .ops.xnor_gemm import (
    conv2d,
    conv_padding_correction,
    conv_patch_weight,
    im2col,
    prepack_weights,
    xnor_matmul_packed,
    xnor_matmul_packed_sign,
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


# ---------------------------------------------------------------------------
# xnor-resnet (basic and bottleneck blocks, CIFAR or ImageNet stem)

RESNET = "xnor-resnet"


def _hwio(conv) -> torch.Tensor:
    """An OIHW conv weight as flax's HWIO kernel."""
    return conv.weight.detach().permute(2, 3, 1, 0).contiguous()


@torch.no_grad()
def _freeze_resnet_tensors(model: XnorResNet, input_shape) -> Dict[str, Any]:
    """The frozen artifact of an XnorResNet at ``input_shape`` (H, W, C)
    (the JAX ``_freeze_resnet_tensors``: the same keys, layouts and key
    order). Per block, each BN -> sign -> conv pair: the BN's raw moments
    and the packed conv at its input resolution; the fp32 stem and
    shortcut kernels (HWIO), the final BN and the head."""
    from .infer import _bn_dict

    if not isinstance(model, XnorResNet):
        raise ValueError(f"freeze_xnor_resnet needs an XnorResNet, got "
                         f"{type(model).__name__}")
    if model.scale:
        raise ValueError(
            "XNOR-Net alpha scaling (scale=True) rescales each conv's "
            "output by mean|W_latent| before bias: the packed freeze does "
            "not fold it and would serve wrong logits; freeze an unscaled "
            "model")
    if not model.binarized:
        raise ValueError("freeze_xnor_resnet needs a binarized XnorResNet "
                         "(the fp32 twin has no packed form)")
    h, w, _ = (int(d) for d in input_shape)
    block_name = ("XnorBottleneckBlock_{}" if model.bottleneck
                  else "XnorBasicBlock_{}")
    hw = (h, w) if model.cifar_stem else _out_hw(_out_hw((h, w), (2, 2)),
                                                 (2, 2))
    blocks, latent, packed_bytes = [], 0, 0
    for blk in model.blocks:
        s = blk.strides
        out_hw = _out_hw(hw, (s, s))
        # (conv strides, conv input hw) of each BN -> sign -> conv pair
        if model.bottleneck:
            plan = [((1, 1), hw), ((s, s), hw), ((1, 1), out_hw)]
        else:
            plan = [((s, s), hw), ((1, 1), out_hw)]
        convs = []
        for ci, (cs, c_hw) in enumerate(plan):
            conv = getattr(blk, f"conv{ci}")
            convs.append({
                "bn": _bn_dict(getattr(blk, f"bn{ci}")),
                "conv": _freeze_conv(conv.weight, conv.bias, c_hw, cs),
            })
            latent += conv.weight.numel() * 4
            packed_bytes += convs[-1]["conv"]["wp"].numel() * 4
        frozen_blk = {"convs": convs, "strides": s}
        if blk.shortcut is not None:
            frozen_blk["shortcut_w"] = _hwio(blk.shortcut)
        blocks.append(frozen_blk)
        hw = out_hw
    n = len(model.blocks)
    frozen = {
        "family": RESNET,
        "arch": {"input_shape": [h, w, int(input_shape[2])],
                 "stage_sizes": list(model.stage_sizes),
                 "cifar_stem": bool(model.cifar_stem)},
        "stem_w": _hwio(model.stem),
        "blocks": blocks,
        "bn_final": _bn_dict(model.bn),
        "head_w": model.head.weight.detach().t().contiguous(),
        "head_b": model.head.bias.detach(),
    }
    n_convs = 3 if model.bottleneck else 2
    frozen["info"] = {
        "family": RESNET,
        "latent_fp32_weight_bytes": latent,
        "frozen_weight_bytes": packed_bytes,
        "compression": round(latent / max(packed_bytes, 1), 2),
        "packed_layers": [f"{block_name.format(i)}/BinarizedConv_{j}"
                          for i in range(n) for j in range(n_convs)],
    }
    return frozen


class _PackedConv:
    """One frozen hidden conv on (B, H, W, C) ±1 bits: ``im2col`` + K1 +
    the padding correction at its resolution + bias (the JAX
    ``_packed_conv_fn``)."""

    def __init__(self, layer: Dict[str, Any], device: torch.device):
        self.wp = layer["wp"].to(device).contiguous()
        self.k, self.n = int(layer["k"]), int(layer["n"])
        self.kernel = (int(layer["kh"]), int(layer["kw"]))
        self.strides = tuple(int(s) for s in layer["strides"])
        self.in_hw = tuple(int(d) for d in layer["in_hw"])
        self.bias = layer["bias"].to(device=device, dtype=torch.float32)
        self.corr = conv_padding_correction(
            layer["tap_sums"].to(device=device, dtype=torch.float32),
            self.in_hw, self.strides, "SAME")

    def check(self, bits: torch.Tensor) -> None:
        if tuple(bits.shape[1:3]) != self.in_hw:
            raise ValueError(
                f"frozen conv was packed for {self.in_hw} inputs, got "
                f"{tuple(bits.shape[1:3])} (the padding correction is "
                "resolution-specific; re-freeze for this input size)")

    def __call__(self, bits: torch.Tensor) -> torch.Tensor:
        self.check(bits)
        patches = im2col(bits.permute(0, 3, 1, 2), self.kernel,
                         self.strides, "SAME")
        b, ho, wo, _ = patches.shape
        y = xnor_matmul_packed(patches.reshape(-1, self.k), self.wp, self.k,
                               self.n).reshape(b, ho, wo, self.n)
        return y + self.corr + self.bias


class _PackedConv1x1Sign(_PackedConv):
    """A 1x1/stride-1 frozen conv fused with the next BN's threshold: its
    patches are its input and its padding correction is 0, so K2 takes
    the bits as they are and emits the next pair's ±1 input (the JAX
    ``_packed_conv1x1_sign_fn``)."""

    def __init__(self, layer, avec, tvec, device):
        super().__init__(layer, device)
        self.avec, self.tvec = avec, tvec

    def __call__(self, bits: torch.Tensor) -> torch.Tensor:
        self.check(bits)
        b, h, w, _ = bits.shape
        return xnor_matmul_packed_sign(
            bits.reshape(-1, self.k), self.wp, self.k, self.n, self.avec,
            self.tvec, self.bias).reshape(b, h, w, self.n)


def _resnet_block_pairs(convs: list, device: torch.device) -> list:
    """One block's (sign, conv) pairs (the JAX ``_resnet_block_pairs``):
    ``sign`` the (a, t) threshold of the pair's BN, or None where the
    previous conv already emitted the bits. A 1x1/stride-1 conv followed
    by another pair fuses that pair's threshold (``_PackedConv1x1Sign``,
    K2): a bottleneck's conv0; a basic block has no 1x1."""
    from .infer import _bn_sign_epilogue, _on

    def threshold(bn):
        return _bn_sign_epilogue(_on(bn["params"], device),
                                 _on(bn["stats"], device))

    pairs, skip_sign = [], False
    for idx, c in enumerate(convs):
        sign = None if skip_sign else threshold(c["bn"])
        skip_sign = False
        layer = c["conv"]
        if (idx + 1 < len(convs) and int(layer["kh"]) == 1
                and int(layer["kw"]) == 1
                and tuple(int(x) for x in layer["strides"]) == (1, 1)):
            a, t = threshold(convs[idx + 1]["bn"])
            pairs.append((sign, _PackedConv1x1Sign(layer, a, t, device)))
            skip_sign = True
        else:
            pairs.append((sign, _PackedConv(layer, device)))
    return pairs


def _fp32_conv_nhwc(x: torch.Tensor, w: torch.Tensor, strides
                    ) -> torch.Tensor:
    """An fp32 SAME conv of (B, H, W, C) maps with an OIHW kernel, in
    ``conv_precision``; (B, Ho, Wo, F) out."""
    return conv2d(x.permute(0, 3, 1, 2), w, strides).permute(0, 2, 3, 1)


class FrozenResNet:
    """Packed ``xnor-resnet`` predictor: ``predictor(images) -> logits``
    (raw, as the live model's) for (B, H, W, C) images at the artifact's
    resolution, numpy or torch."""

    def __init__(self, frozen: Dict[str, Any], device: torch.device):
        from .infer import _bn_affine_params, _on

        if frozen.get("family") != RESNET:
            raise ValueError(f"not a {RESNET} artifact: family "
                             f"{frozen.get('family')!r}")
        arch = frozen["arch"]
        self.device = device
        self.ishape = tuple(int(d) for d in arch["input_shape"])
        self.cifar_stem = bool(arch["cifar_stem"])

        def oihw(hwio):
            return hwio.to(device=device, dtype=torch.float32).permute(
                3, 2, 0, 1).contiguous()

        self.stem_w = oihw(frozen["stem_w"])
        self.stem_strides = (1, 1) if self.cifar_stem else (2, 2)
        self.blocks = []
        for blk in frozen["blocks"]:
            if "convs" not in blk:
                raise ValueError(
                    "stale xnor-resnet artifact schema (pre-bottleneck "
                    "per-block layout); re-export the checkpoint")
            s = int(blk["strides"])
            self.blocks.append((
                _resnet_block_pairs(blk["convs"], device),
                (oihw(blk["shortcut_w"]), (s, s)) if "shortcut_w" in blk
                else None))
        bn = frozen["bn_final"]
        self.a_fin, self.c_fin = _bn_affine_params(
            _on(bn["params"], device), _on(bn["stats"], device))
        self.wh = frozen["head_w"].to(device=device, dtype=torch.float32)
        self.bh = frozen["head_b"].to(device=device, dtype=torch.float32)

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        if not torch.is_tensor(images):
            images = torch.from_numpy(np.asarray(images, np.float32))
        x = images.to(device=self.device, dtype=torch.float32)
        if tuple(x.shape[1:]) != self.ishape:
            raise ValueError(f"frozen resnet expects {self.ishape} inputs, "
                             f"got {tuple(x.shape[1:])}")
        x = _fp32_conv_nhwc(x, self.stem_w, self.stem_strides)
        if not self.cifar_stem:   # the ImageNet stem's 3x3/2 SAME max-pool
            x = max_pool_same(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        for pairs, shortcut in self.blocks:
            y = x
            for sign, conv in pairs:
                if sign is not None:
                    a, t = sign
                    y = torch.where(a * y >= t, 1.0, -1.0)
                y = conv(y)
            x = y + (x if shortcut is None else _fp32_conv_nhwc(x, *shortcut))
        x = torch.relu(self.a_fin * x + self.c_fin).mean(dim=(1, 2))
        return x @ self.wh + self.bh


def freeze_xnor_resnet(model: XnorResNet, *, input_shape=(32, 32, 3),
                       device="cuda") -> Tuple[FrozenResNet, Dict[str, Any]]:
    """Freeze a trained XnorResNet (basic blocks and the CIFAR stem, or
    bottlenecks and the ImageNet stem) for ``input_shape`` (the training
    resolution: (224, 224, 3) for resnet50 on ImageNet) into a packed
    predictor on ``device`` (None: "cuda"; raises without a card). It
    computes the live model's eval logits up to threshold ties of the
    fp32 residual stream."""
    from .infer import resolve_device

    frozen = _freeze_resnet_tensors(model, input_shape)
    return FrozenResNet(frozen, resolve_device(device)), frozen["info"]
