"""Binarized PyTorch layers with fp32 latent ("master") parameters.

Counterpart of the JAX package's ``models/layers.py`` (``BinarizedDense``
and ``BinarizedConv``), plus ``hard_tanh``, the activation the binarized
families use, flax's ``nn.Dropout`` on an explicit generator
(``Dropout``, ``SeededTrainRNG``), flax's ``nn.BatchNorm`` over the
batch (and space) of 2-D and 4-D inputs (``BatchNorm``), and flax's
``nn.Conv`` (``Conv``) and initializers for the fp32 conv families.
The fp32 latent weight is the only stored weight; its ±1 view is
re-derived on every forward with ``binarize_ste``. Inputs are binarized
before the GEMM unless ``binarize_input`` is False (first layers fed raw
pixels); with ``stochastic`` they are binarized stochastically (the
reference's ``quant_mode="stoch"``) whenever the forward is given a
generator, as the JAX layer is whenever a "binarize" rng is threaded.
With ``scale`` the ±1 GEMM is rescaled by the XNOR-Net per-output
alpha = mean(|W_latent|) over the input axis, recomputed from the
latents every forward. The fp32 bias is added last.

The weight is stored (out_features, in_features), as ``nn.Linear`` does;
the JAX kernel is (in, out) (``interop.params_from_jax`` transposes).
Conv layers take NCHW maps and store OIHW weights, as ``nn.Conv2d``;
flax's are NHWC and HWIO.
The ±1 product is ``ops.xnor_gemm.binary_matmul``, whose backward keeps
the cotangent in fp32 on every backend.
Parameters are made on the CPU from the given ``torch.Generator``; move
the module with ``.to(device)``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist
from torch import nn

from ..ops.binarize import STEMode, binarize, binarize_ste
from ..ops.comm_compress import all_reduce_sum
from ..ops.xnor_gemm import (
    BACKENDS,
    binary_conv2d,
    binary_matmul,
    conv2d,
    conv_pads,
    conv_padding_correction,
    conv_patch_weight,
    im2col,
)


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.hard_tanh``: clamp to [-1, 1], gradient 1 on [-1, 1]
    including both ends (``torch.nn.functional.hardtanh`` gives 0 at
    exactly +-1, which a pre-activation can reach: an integer ±1 sum
    plus a bias)."""
    return torch.clamp(x, -1.0, 1.0)


class Dropout(nn.Module):
    """flax's ``nn.Dropout`` with an explicit generator: in train mode
    ``where(u < 1 - rate, x / (1 - rate), 0)`` for u ~ U[0, 1) drawn from
    the given generator; the identity in eval mode or at rate 0."""

    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate must be in [0, 1], got {rate}")
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("train-mode dropout needs an explicit generator")
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=generator,
                          device=x.device) < keep_prob
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class SeededTrainRNG:
    """The train-mode generator of a model whose ``rng_seed`` seeds its
    draws (dropout masks, stochastic signs): ``train_generator(device)``
    is a ``torch.Generator`` on ``device``, made from ``rng_seed`` at the
    first draw there, then advanced by every draw. Two models of one
    seed draw the same; torch's global RNG is never touched."""

    rng_seed: int = 0
    _train_gen: Optional[torch.Generator] = None

    def train_generator(self, device: torch.device) -> torch.Generator:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self._train_gen is None or self._train_gen.device != device:
            self._train_gen = torch.Generator(device=device).manual_seed(
                self.rng_seed)
        return self._train_gen


def _layer_backend(backend: str, binarize_input: bool) -> str:
    """The JAX ``_layer_backend``: the int8, xnor and pallas_xnor
    products assume ±1 operands, so a layer fed raw activations runs
    "xla" under them, the reference's fp32 first layer. "bf16" stays:
    exact on ±1, a deliberate rounding of raw inputs otherwise."""
    if not binarize_input and backend in ("int8", "xnor", "pallas_xnor"):
        return "xla"
    return backend


def _binarize_input(x, stochastic, ste, generator):
    if stochastic and generator is not None:
        return binarize(x, "stoch", ste=ste, generator=generator)
    return binarize_ste(x, ste)


class BinarizedDense(nn.Module):
    """y = binarize(x) @ binarize(W_latent).T (* alpha) + b_fp32."""

    def __init__(
        self, in_features: int, out_features: int, *,
        binarize_input: bool = True, use_bias: bool = True,
        ste: STEMode = "identity", backend: str = "bf16",
        scale: bool = False, stochastic: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (have {BACKENDS})")
        self.in_features = in_features
        self.out_features = out_features
        self.binarize_input = binarize_input
        self.ste = ste
        self.backend = backend
        self.scale = scale
        self.stochastic = stochastic
        # LeCun-uniform latent init kept inside [-1, 1], as the JAX
        # package's _latent_init (bound = min(1, 1/sqrt(fan_in))).
        bound = min(1.0, 1.0 / in_features ** 0.5)
        w = torch.empty(out_features, in_features)
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = (
            nn.Parameter(torch.zeros(out_features))
            if use_bias else None
        )

    def gemm_backend(self) -> str:
        """This layer's backend (the JAX ``_layer_backend``)."""
        return _layer_backend(self.backend, self.binarize_input)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: draws the stochastic signs of a ``stochastic``
        layer (on x's device); without one the signs are deterministic."""
        if self.binarize_input:
            x = _binarize_input(x, self.stochastic, self.ste, generator)
        wb = binarize_ste(self.weight, self.ste)
        lead = x.shape[:-1]
        y = binary_matmul(x.reshape(-1, x.shape[-1]), wb,
                          self.gemm_backend())
        y = y.reshape(*lead, self.out_features)
        if self.scale:
            y = y * self.weight.abs().mean(dim=1)
        if self.bias is not None:
            y = y + self.bias
        return y


class BinarizedConv(nn.Module):
    """y = conv(binarize(x), binarize(W_latent)) (* alpha) + b_fp32 on
    NCHW maps, the JAX ``BinarizedConv`` (flax's NHWC in the reference).

    The dense backends (xla, bf16, int8) run ``binary_conv2d``. xnor and
    pallas_xnor run ``im2col``, the ±1 patch GEMM ``binary_matmul`` (K1
    on pallas_xnor) and, where the padding adds zero taps (which pack as
    -1), ``conv_padding_correction`` of the kernel's tap sums, detached
    as JAX's ``stop_gradient``: the GEMM's fp32 backward already
    differentiates the exact {-1, 0, +1} patches."""

    def __init__(
        self, in_channels: int, features: int,
        kernel_size: Sequence[int] = (3, 3), *,
        strides: Sequence[int] = (1, 1),
        padding: Union[str, int, Sequence] = "SAME",
        binarize_input: bool = True, use_bias: bool = True,
        ste: STEMode = "identity", backend: str = "bf16",
        scale: bool = False, stochastic: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r} (have {BACKENDS})")
        kh, kw = kernel_size
        self.in_channels = in_channels
        self.features = features
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.binarize_input = binarize_input
        self.ste = ste
        self.backend = backend
        self.scale = scale
        self.stochastic = stochastic
        # the JAX _latent_init: U(-b, b), b = min(1, 1/sqrt(kh*kw*cin))
        bound = min(1.0, 1.0 / (kh * kw * in_channels) ** 0.5)
        w = torch.empty(features, in_channels, kh, kw)
        w.uniform_(-bound, bound, generator=generator)
        self.weight = nn.Parameter(w)
        self.bias = (nn.Parameter(torch.zeros(features))
                     if use_bias else None)

    def gemm_backend(self) -> str:
        return _layer_backend(self.backend, self.binarize_input)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (N, C, H, W). ``generator``: draws the stochastic signs of
        a ``stochastic`` layer; without one the signs are deterministic."""
        if self.binarize_input:
            x = _binarize_input(x, self.stochastic, self.ste, generator)
        wb = binarize_ste(self.weight, self.ste)
        backend = self.gemm_backend()
        if backend in ("xnor", "pallas_xnor"):
            patches = im2col(x, self.kernel_size, self.strides, self.padding)
            n, ho, wo, k = patches.shape
            y = binary_matmul(patches.reshape(-1, k), conv_patch_weight(wb),
                              backend).reshape(n, ho, wo, self.features)
            pads = conv_pads(self.padding, x.shape[2:], self.kernel_size,
                             self.strides)
            if any(p for pair in pads for p in pair):
                y = y + conv_padding_correction(
                    wb.detach().sum(dim=1).permute(1, 2, 0), x.shape[2:],
                    self.strides, self.padding)
            y = y.permute(0, 3, 1, 2)
        else:
            y = binary_conv2d(x, wb, self.strides, self.padding, backend)
        if self.scale:
            y = y * self.weight.abs().mean(dim=(1, 2, 3))[:, None, None]
        if self.bias is not None:
            y = y + self.bias[:, None, None]
        return y


class _AllReduceSum(torch.autograd.Function):
    """The sum over a process group; its backward sums the cotangent over
    the group, since every rank's output depends on every rank's input."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_reduce_sum(g, ctx.group), None


class BatchNorm(nn.BatchNorm1d):
    """``nn.BatchNorm1d`` (same state-dict keys) whose train mode is
    flax's ``nn.BatchNorm`` (``normalization._compute_stats`` and
    ``_normalize``, ``use_fast_variance=True``) over every axis but the
    channel axis 1: (N,) of a (N, C) input, (N, H, W) of a (N, C, H, W)
    one. The batch's mean and ``var = max(0, mean(x^2) - mean(x)^2)``
    normalise as ``(x - mean) * (rsqrt(var + eps) * weight) + bias``,
    and the running statistics move by ``momentum`` towards the mean and
    the biased ``var`` (flax's momentum is the old value's weight,
    ``1 - momentum`` here). Eval mode normalises with the running
    statistics.

    As flax's, the statistics and the normalisation are fp32 whatever the
    input's dtype, and the result is cast to ``dtype`` (None: the
    input's): flax's ``nn.BatchNorm(dtype=bfloat16)``.

    With a ``group`` (a ``torch.distributed`` process group, set on the
    module), the batch is the global one, as flax's BatchNorm sees it
    under the JAX package's GSPMD data parallelism: ``sum x`` and ``sum
    x^2`` are summed over the group (gradient included) before the fast
    variance. ``nn.SyncBatchNorm`` would not do: it takes ``E[(x -
    mean)^2]`` and keeps an unbiased running variance."""

    group = None
    dtype: Optional[torch.dtype] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out_dtype = self.dtype or x.dtype
        x = x.to(torch.float32)
        if not self.training:
            return nn.functional.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, self.eps).to(out_dtype)
        dims = [0] + list(range(2, x.dim()))
        c = x.shape[1]
        if self.group is None:
            mean = x.mean(dim=dims)
            mean_sq = (x * x).mean(dim=dims)
        else:
            sums = _AllReduceSum.apply(
                torch.cat([x.sum(dim=dims), (x * x).sum(dim=dims)]),
                self.group)
            n = x.numel() // c * dist.get_world_size(self.group)
            mean, mean_sq = sums[:c] / n, sums[c:] / n
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(1.0 - self.momentum).add_(
                self.momentum * mean)
            self.running_var.mul_(1.0 - self.momentum).add_(
                self.momentum * var)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, c) + (1,) * (x.dim() - 2)
        return ((x - mean.reshape(shape)) * mul.reshape(shape)
                + self.bias.reshape(shape)).to(out_dtype)


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """flax's default kernel init: a normal truncated at two standard
    deviations, rescaled to variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


def xavier_uniform_(w: torch.Tensor, fan_in: int, fan_out: int,
                    generator: Optional[torch.Generator] = None) -> None:
    """flax's ``xavier_uniform``: U(-b, b), b = sqrt(6 / (fan_in +
    fan_out))."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        w.uniform_(-bound, bound, generator=generator)


def dense(in_features: int, out_features: int, *, init: str = "lecun",
          generator: Optional[torch.Generator] = None) -> nn.Linear:
    """flax's ``nn.Dense`` as an ``nn.Linear``: the (out, in) weight
    drawn by ``init`` ("lecun": flax's default; "xavier":
    ``xavier_uniform``), a zero bias."""
    lin = nn.Linear(in_features, out_features)
    if init == "lecun":
        lecun_normal_(lin.weight, in_features, generator)
    elif init == "xavier":
        xavier_uniform_(lin.weight, in_features, out_features, generator)
    else:
        raise ValueError(f"unknown init {init!r} (have lecun, xavier)")
    nn.init.zeros_(lin.bias)
    return lin


class Conv(nn.Module):
    """flax's ``nn.Conv(features, kernel_size, padding, dtype)`` on NCHW
    maps: input, kernel and bias cast to ``dtype`` (None: fp32), the conv
    in that dtype (``ops.xnor_gemm.conv2d``: cuDNN without TF32,
    deterministic), then the bias added. The kernel is flax's
    lecun-normal over kh * kw * cin, the bias zero."""

    def __init__(self, in_channels: int, features: int,
                 kernel_size: Sequence[int] = (3, 3), *,
                 padding: Union[str, int, Sequence] = "SAME",
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kh, kw = kernel_size
        self.padding = padding
        self.dtype = dtype
        w = torch.empty(features, in_channels, kh, kw)
        lecun_normal_(w, kh * kw * in_channels, generator)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.float32
        y = conv2d(x.to(dt), self.weight.to(dt), (1, 1), self.padding)
        return y + self.bias.to(dt)[:, None, None]


def nhwc_input(x: torch.Tensor) -> torch.Tensor:
    """A conv model's input as NCHW: (B, 784) flat 28 x 28 images (the
    MLP's layout; the JAX models reshape them so) or (B, H, W, C) NHWC
    ones (the data loaders' and the JAX models' layout)."""
    if x.dim() == 2:
        x = x.reshape(x.shape[0], 28, 28, 1)
    if x.dim() != 4:
        raise ValueError(f"want (B, 784) or (B, H, W, C) images, got "
                         f"{tuple(x.shape)}")
    return x.permute(0, 3, 1, 2)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, H*W*C) in flax's (h, w, c) order, so a dense
    layer after it takes the JAX kernel as it is."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
