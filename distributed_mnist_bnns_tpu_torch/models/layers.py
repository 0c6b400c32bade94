"""Binarized PyTorch layers with fp32 latent ("master") parameters.

Counterpart of the JAX package's ``models/layers.py`` (``BinarizedDense``
only), plus ``hard_tanh``, the activation both model families use.
The fp32 latent weight is the only stored weight; its ±1 view is
re-derived on every forward with ``binarize_ste``. Inputs are binarized
before the GEMM unless ``binarize_input`` is False (first layers fed raw
pixels). With ``scale`` the ±1 GEMM is rescaled by the XNOR-Net
per-output alpha = mean(|W_latent|) over the input axis, recomputed from
the latents every forward. The fp32 bias is added last.

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

from ..ops.binarize import STEMode, binarize_ste
from ..ops.xnor_gemm import BACKENDS, binary_matmul


def hard_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.hard_tanh``: clamp to [-1, 1], gradient 1 on [-1, 1]
    including both ends (``torch.nn.functional.hardtanh`` gives 0 at
    exactly +-1, which a pre-activation can reach: an integer ±1 sum
    plus a bias)."""
    return torch.clamp(x, -1.0, 1.0)


class BinarizedDense(nn.Module):
    """y = binarize(x) @ binarize(W_latent).T (* alpha) + b_fp32."""

    def __init__(
        self, in_features: int, out_features: int, *,
        binarize_input: bool = True, use_bias: bool = True,
        ste: STEMode = "identity", backend: str = "bf16",
        scale: bool = False,
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.binarize_input:
            x = binarize_ste(x, self.ste)
        wb = binarize_ste(self.weight, self.ste)
        lead = x.shape[:-1]
        y = binary_matmul(x.reshape(-1, x.shape[-1]), wb, self.backend)
        y = y.reshape(*lead, self.out_features)
        if self.scale:
            y = y * self.weight.abs().mean(dim=1)
        if self.bias is not None:
            y = y + self.bias
        return y
