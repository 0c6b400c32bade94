"""Bitplane packing of ±1 tensors into int32 words.

The storage format of the XNOR-popcount GEMM (``ops/xnor_gemm.py``).
Convention, shared bit for bit with the JAX package's ``ops/bitpack.py``:
words are LSB-first int32, bit = 1 ⟺ x > 0, so bit 31 set makes the
word negative. A subnormal x counts as 0, as XLA reads it on the CPU:
bit = 1 ⟺ x >= 2^-126 (``TINY``).
For two packed words a, b covering 32 positions:

    mismatches = popcount(a XOR b)
    dot        = matches - mismatches = 32 - 2 * mismatches

so a full K-length ±1 dot product is ``K - 2 * sum_w popcount(a_w ^ b_w)``.
Zero-padding *both* operands' tail words adds equal bits (matches only),
so the formula stays exact with the unpadded K.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
#: The smallest normal fp32 value, 2^-126: x > 0 with subnormals read as 0
#: is x >= TINY.
TINY = float(np.finfo(np.float32).tiny)


def packed_dim(k: int, multiple: int = 1) -> int:
    """Number of int32 words needed to pack k bits, rounded up to `multiple`."""
    words = -(-k // WORD_BITS)
    return -(-words // multiple) * multiple


def _shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int64, device=device)


def pack_bits(x: torch.Tensor, pad_words_to: int = 1) -> torch.Tensor:
    """Pack ±1 values along the last axis into int32 bitplanes.

    x: (..., K) tensor of ±1 (any dtype; > 0 is treated as +1, a
    subnormal as 0), on any device. Returns (..., packed_dim(K,
    pad_words_to)) int32 on the same device. Words are summed in int64
    and values >= 2^31 are mapped down by 2^32 before the cast, so bit 31
    wraps to a negative int32 exactly as the JAX package's uint32 -> int32
    cast does.
    """
    k = x.shape[-1]
    kw = packed_dim(k, pad_words_to)
    pad = kw * WORD_BITS - k
    bits = (x >= TINY).to(torch.int64)
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], kw, WORD_BITS)
    words = (bits << _shifts(x.device)).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def unpack_bits(
    words: torch.Tensor, k: int, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Inverse of pack_bits: (..., KW) int32 -> (..., k) ±1 tensor."""
    w64 = words.to(torch.int64) & 0xFFFFFFFF
    bits = (w64[..., None] >> _shifts(words.device)) & 1
    flat = bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)
    return (flat.to(dtype) * 2 - 1)[..., :k]


def pack_bits_np(x: np.ndarray, pad_words_to: int = 1) -> np.ndarray:
    """NumPy host-side variant of pack_bits, as the JAX package's: x > 0
    as NumPy compares, so a subnormal x counts as positive here."""
    k = x.shape[-1]
    kw = packed_dim(k, pad_words_to)
    pad = kw * WORD_BITS - k
    bits = (x > 0).astype(np.uint32)
    if pad:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, pad)])
    bits = bits.reshape(*bits.shape[:-1], kw, WORD_BITS)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    words = np.sum(bits << shifts, axis=-1, dtype=np.uint64).astype(np.uint32)
    return words.view(np.int32)
