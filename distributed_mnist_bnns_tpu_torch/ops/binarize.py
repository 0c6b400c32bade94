"""Binarization / quantization with straight-through-estimator (STE)
gradients, as ``torch.autograd.Function``s.

Counterpart of the JAX package's ``ops/binarize.py``. ``sign(0)`` maps to
+1 here, as there: strict ±1 outputs are what the bitplane XNOR-popcount
GEMM needs to be exact. ``torch.sign`` maps 0 to 0, so it is not used.

The stochastic paths (the reference's ``quant_mode="stoch"``) draw
U(-0.5, 0.5) noise from an explicit ``torch.Generator`` on the input's
device: ``binarize(x, "stoch", generator=g)`` and ``quantize(x, bits,
quant_mode="stoch", generator=g)``. ``binarize_stoch`` and
``quantize_stoch`` take the noise as a tensor instead, so that a test can
feed the JAX package's noise and compare bitwise. Their forward is the
noisy rounding and their gradient the deterministic path's STE.
"""

from __future__ import annotations

from typing import Literal, Optional

import torch

from . import remat
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


def _uniform_noise(x: torch.Tensor,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """U(-0.5, 0.5) noise of x's shape, dtype and device."""
    if generator is None:
        raise ValueError("a stochastic path needs an explicit generator")
    return remat.rand(x.shape, generator=generator, dtype=x.dtype,
                      device=x.device) - 0.5


def binarize_stoch(x: torch.Tensor, noise: torch.Tensor,
                   ste: STEMode = "identity") -> torch.Tensor:
    """Stochastic ±1 from given U(-0.5, 0.5) noise: shift x to [0, 1] by
    (x + 1) / 2, add the noise, clamp to [0, 1], round half to even, map
    back to ±1. Gradient: the STE of ``binarize_ste``."""
    det = binarize_ste(x, ste)
    probs = torch.clamp((x + 1.0) / 2.0 + noise, 0.0, 1.0)
    stoch = torch.round(probs) * 2.0 - 1.0
    return det + (stoch - det).detach()


def binarize(x: torch.Tensor, quant_mode: str = "det", *,
             ste: STEMode = "identity",
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Binarize to ±1: ``det`` is ``binarize_ste``; ``stoch`` draws its
    noise from ``generator`` (required) and runs ``binarize_stoch``."""
    if quant_mode == "det":
        return binarize_ste(x, ste)
    if quant_mode != "stoch":
        raise ValueError(f"unknown quant_mode {quant_mode!r}")
    return binarize_stoch(x, _uniform_noise(x, generator), ste)


def quantize_stoch(x: torch.Tensor, noise: torch.Tensor,
                   num_bits: int = 8) -> torch.Tensor:
    """Stochastic k-bit quantization from given U(-0.5, 0.5) noise:
    round(clip(x * 2^(b-1) + noise)) / 2^(b-1), with the identity STE."""
    scale = 2.0 ** (num_bits - 1)
    det = _QuantizeSTE.apply(x, num_bits)
    stoch = torch.round(torch.clamp(x * scale + noise, -scale, scale - 1)) / scale
    return det + (stoch - det).detach()


def quantize(x: torch.Tensor, num_bits: int = 8, *, quant_mode: str = "det",
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """k-bit fixed-point quantization with an identity-STE gradient.
    ``det``: clamp to the signed 2^(b-1) grid, scale-round-rescale (round
    half to even, as ``jnp.round``). ``stoch``: ``quantize_stoch`` with
    noise drawn from ``generator`` (required)."""
    if quant_mode == "det":
        return _QuantizeSTE.apply(x, num_bits)
    if quant_mode != "stoch":
        raise ValueError(f"unknown quant_mode {quant_mode!r}")
    return quantize_stoch(x, _uniform_noise(x, generator), num_bits)
