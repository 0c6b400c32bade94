"""Binarized PyTorch layers with fp32 latent ("master") parameters.

Counterpart of the JAX package's ``models/layers.py`` (``BinarizedDense``
only), plus ``hard_tanh``, the activation both model families use, and
flax's ``nn.Dropout`` on an explicit generator (``Dropout``,
``SeededTrainRNG``), which both families draw from.
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
The ±1 product is ``ops.xnor_gemm.binary_matmul``, whose backward keeps
the cotangent in fp32 on every backend.
Parameters are made on the CPU from the given ``torch.Generator``; move
the module with ``.to(device)``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.binarize import STEMode, binarize, binarize_ste
from ..ops.xnor_gemm import BACKENDS, binary_matmul


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
        """This layer's backend (the JAX ``_layer_backend``): the int8,
        xnor and pallas_xnor products assume ±1 operands, so a layer fed
        raw activations runs "xla" under them, the reference's fp32 first
        layer. "bf16" stays: exact on ±1, a deliberate rounding of raw
        inputs otherwise."""
        if not self.binarize_input and self.backend in ("int8", "xnor",
                                                        "pallas_xnor"):
            return "xla"
        return self.backend

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator``: draws the stochastic signs of a ``stochastic``
        layer (on x's device); without one the signs are deterministic."""
        if self.binarize_input:
            if self.stochastic and generator is not None:
                x = binarize(x, "stoch", ste=self.ste, generator=generator)
            else:
                x = binarize_ste(x, self.ste)
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
