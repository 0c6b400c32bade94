"""Binarization / quantization with straight-through-estimator (STE)
gradients, as ``torch.autograd.Function``s.

Counterpart of the JAX package's ``ops/binarize.py``. ``sign(0)`` maps to
+1 here, as there: strict ±1 outputs are what the bitplane XNOR-popcount
GEMM needs to be exact. ``torch.sign`` maps 0 to 0, so it is not used.

The stochastic binarize/quantize paths belong to training and are not
in this package yet.
"""

from __future__ import annotations

from typing import Literal

import torch

from .bitpack import TINY

STEMode = Literal["identity", "hardtanh"]


def _sign_pm1(x: torch.Tensor) -> torch.Tensor:
    """sign() with outputs in {-1, +1} (0 -> +1), dtype preserved. A
    subnormal x reads as 0 (so -1e-40 -> +1), as XLA reads it on the CPU;
    NaN -> -1."""
    return torch.where(x > -TINY, torch.ones_like(x), -torch.ones_like(x))


class _BinarizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, ste: str) -> torch.Tensor:
        ctx.ste = ste
        if ste == "hardtanh":
            ctx.save_for_backward(x)
        return _sign_pm1(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        if ctx.ste == "hardtanh":
            (x,) = ctx.saved_tensors
            g = g * (x.abs() <= 1.0).to(g.dtype)
        return g, None


def binarize_ste(x: torch.Tensor, ste: STEMode = "identity") -> torch.Tensor:
    """Deterministic sign binarization with an STE gradient.

    ste="identity": backward is the identity.
    ste="hardtanh": backward masks gradients where |x| > 1.
    """
    if ste not in ("identity", "hardtanh"):
        raise ValueError(f"unknown STE mode {ste!r}")
    return _BinarizeSTE.apply(x, ste)


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, num_bits: int) -> torch.Tensor:
        scale = 2.0 ** (num_bits - 1)
        xc = torch.clamp(x * scale, -scale, scale - 1)
        return torch.round(xc) / scale

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


def quantize(x: torch.Tensor, num_bits: int = 8) -> torch.Tensor:
    """Deterministic k-bit fixed-point quantization with an identity-STE
    gradient: clamp to the signed 2^(b-1) grid, scale-round-rescale
    (round half to even, as ``jnp.round``)."""
    return _QuantizeSTE.apply(x, num_bits)
