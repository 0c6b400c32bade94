"""The XNOR-ResNet family (``xnor-resnet18`` on CIFAR-10,
``xnor-resnet50`` on ImageNet, and ``fp32-resnet18``, the binarization
gap's denominator).

Counterpart of the JAX package's ``models/resnet.py``, on NCHW maps as
the port's other conv models (the input is NHWC, as the loaders give
it). XNOR-Net's conventions: the stem conv and the classifier stay
fp32, every other conv is a ``BinarizedConv`` (±1 weights and
activations over fp32 latents, straight-through gradients), each after
its own BatchNorm (pre-activation blocks):

  XnorBasicBlock       BN -> BinConv 3x3/s -> BN -> BinConv 3x3, plus
                       the input (or its fp32 1x1/s projection without
                       bias when the stride or the width changes)
  XnorBottleneckBlock  BN -> BinConv 1x1 -> BN -> BinConv 3x3/s -> BN ->
                       BinConv 1x1 (x4 wide), the same shortcut rule
  XnorResNet           fp32 stem (3x3/1 for CIFAR; 7x7/2 and a 3x3/2
                       SAME max-pool for ImageNet), stages of blocks at
                       widths stem * 2^stage (stride 2 at each stage's
                       first block but the first stage's), BN -> relu ->
                       mean over (H, W) -> fp32 Dense

BatchNorm is flax's (momentum 0.9 there, 0.1 here; eps 1e-5).
``binarized=False`` swaps every BinarizedConv for an fp32 ``Conv`` with
bias (the same topology). The convs take ``backend``, ``ste`` and
``scale`` as ``BinarizedConv`` does; on xnor and pallas_xnor each is an
im2col patch GEMM (K1 on pallas_xnor) plus the padding correction.

Submodules map to flax's names (``flax_names``): stem <-> Conv_0,
blocks.i <-> XnorBasicBlock_i / XnorBottleneckBlock_i (bn0..bn2 <->
BatchNorm_0..2, conv0..conv2 <-> BinarizedConv_0..2 or, in the fp32
twin, Conv_0..2, shortcut <-> the next Conv_j), bn <-> BatchNorm_0 and
head <-> Dense_0. The crops of ``--augment`` draw from the model's own
generator (``SeededTrainRNG``); the model draws nothing else.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..ops.xnor_gemm import same_padding
from .layers import (
    BatchNorm,
    BinarizedConv,
    Conv,
    SeededTrainRNG,
    dense,
    nhwc_input,
)


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-5, momentum=0.1)


class _Block(nn.Module):
    """What both block types share: the twin-conv switch (one definition
    of which arguments each side gets, handed to ``_layers``), the
    shortcut rule and the forward over the bn_i -> conv_i pairs."""

    expansion = 1

    def __init__(self, in_channels: int, features: int, strides: int, *,
                 backend: str, ste: str, scale: bool, binarized: bool,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.binarized = binarized
        self.strides = strides
        self.n_convs = 0

        def conv(cin: int, f: int, kernel, s: int = 1) -> nn.Module:
            self.n_convs += 1
            if not binarized:
                return Conv(cin, f, kernel, strides=(s, s),
                            generator=generator)
            return BinarizedConv(cin, f, kernel, strides=(s, s),
                                 backend=backend, ste=ste, scale=scale,
                                 generator=generator)

        self._layers(in_channels, features, conv)
        out_ch = features * self.expansion
        self.shortcut = None
        if in_channels != out_ch or strides != 1:
            self.shortcut = Conv(in_channels, out_ch, (1, 1),
                                 strides=(strides, strides), use_bias=False,
                                 generator=generator)

    def flax_names(self, prefix: str, flax: str):
        conv = "BinarizedConv" if self.binarized else "Conv"
        names = []
        for i in range(self.n_convs):
            names += [(f"{prefix}.bn{i}", f"{flax}/BatchNorm_{i}", "bn"),
                      (f"{prefix}.conv{i}", f"{flax}/{conv}_{i}", "conv")]
        if self.shortcut is not None:
            j = 0 if self.binarized else self.n_convs
            names.append((f"{prefix}.shortcut", f"{flax}/Conv_{j}", "conv"))
        return names

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x
        for i in range(self.n_convs):
            y = getattr(self, f"conv{i}")(getattr(self, f"bn{i}")(y))
        return y + (x if self.shortcut is None else self.shortcut(x))


class XnorBasicBlock(_Block):
    """Pre-activation basic block: BN -> conv 3x3/s -> BN -> conv 3x3."""

    def _layers(self, cin: int, features: int, conv) -> None:
        self.bn0 = _bn(cin)
        self.conv0 = conv(cin, features, (3, 3), self.strides)
        self.bn1 = _bn(features)
        self.conv1 = conv(features, features, (3, 3))


class XnorBottleneckBlock(_Block):
    """Pre-activation bottleneck: 1x1 -> 3x3/s -> 1x1 (x4 expand)."""

    expansion = 4

    def _layers(self, cin: int, features: int, conv) -> None:
        self.bn0 = _bn(cin)
        self.conv0 = conv(cin, features, (1, 1))
        self.bn1 = _bn(features)
        self.conv1 = conv(features, features, (3, 3), self.strides)
        self.bn2 = _bn(features)
        self.conv2 = conv(features, features * 4, (1, 1))


def max_pool_same(x: torch.Tensor, window: int = 3, stride: int = 2
                  ) -> torch.Tensor:
    """XLA's ``reduce_window(max, SAME)`` of NCHW maps: -inf padding with
    the odd pixel of an uneven total on the high side (``F.max_pool2d``'s
    own padding is symmetric, one window off at even sizes)."""
    (t, b), (l, r) = same_padding(x.shape[2:], (window, window),
                                  (stride, stride))
    x = nn.functional.pad(x, (l, r, t, b), value=float("-inf"))
    return nn.functional.max_pool2d(x, window, stride)


class XnorResNet(SeededTrainRNG, nn.Module):
    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 bottleneck: bool = False, num_classes: int = 10,
                 stem_features: int = 64, cifar_stem: bool = True, *,
                 in_channels: int = 3, backend: str = "bf16",
                 ste: str = "identity", scale: bool = False,
                 binarized: bool = True, rng_seed: int = 0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stage_sizes = tuple(stage_sizes)
        self.bottleneck = bottleneck
        self.num_classes = num_classes
        self.stem_features = stem_features
        self.cifar_stem = cifar_stem
        self.scale = scale
        self.binarized = binarized
        self.rng_seed = rng_seed
        self._train_gen: Optional[torch.Generator] = None
        if cifar_stem:
            self.stem = Conv(in_channels, stem_features, (3, 3),
                             use_bias=False, generator=generator)
        else:
            self.stem = Conv(in_channels, stem_features, (7, 7),
                             strides=(2, 2), use_bias=False,
                             generator=generator)
        block = XnorBottleneckBlock if bottleneck else XnorBasicBlock
        blocks, cin = [], stem_features
        for stage, n_blocks in enumerate(self.stage_sizes):
            features = stem_features * 2 ** stage
            for b in range(n_blocks):
                strides = 2 if stage > 0 and b == 0 else 1
                blocks.append(block(cin, features, strides, backend=backend,
                                    ste=ste, scale=scale,
                                    binarized=binarized,
                                    generator=generator))
                cin = features * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.bn = _bn(cin)
        self.head = dense(cin, num_classes, generator=generator)

    def flax_names(self):
        block = ("XnorBottleneckBlock" if self.bottleneck
                 else "XnorBasicBlock")
        names = [("stem", "Conv_0", "conv")]
        for i, blk in enumerate(self.blocks):
            names += blk.flax_names(f"blocks.{i}", f"{block}_{i}")
        return names + [("bn", "BatchNorm_0", "bn"),
                        ("head", "Dense_0", "dense")]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem(nhwc_input(x).to(torch.float32))
        if not self.cifar_stem:
            x = max_pool_same(x)
        for blk in self.blocks:
            x = blk(x)
        x = torch.relu(self.bn(x)).mean(dim=(2, 3))
        return self.head(x)


def xnor_resnet18(**kw) -> XnorResNet:
    return XnorResNet(stage_sizes=(2, 2, 2, 2), bottleneck=False, **kw)


def xnor_resnet50(**kw) -> XnorResNet:
    return XnorResNet(stage_sizes=(3, 4, 6, 3), bottleneck=True,
                      cifar_stem=False, **kw)


def fp32_resnet18(**kw) -> XnorResNet:
    """xnor_resnet18 without binarization: the conv family's fp32 twin."""
    kw.setdefault("binarized", False)
    return xnor_resnet18(**kw)
