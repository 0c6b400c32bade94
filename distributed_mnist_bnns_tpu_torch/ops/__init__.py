from .binarize import binarize_ste, quantize
from .bitpack import pack_bits, pack_bits_np, packed_dim, unpack_bits
from .xnor_gemm import (
    prepack_weights,
    xnor_matmul_fused_unpack,
    xnor_matmul_packed,
    xnor_matmul_packed_affine,
    xnor_matmul_packed_sign,
)

__all__ = [
    "binarize_ste",
    "quantize",
    "pack_bits",
    "pack_bits_np",
    "packed_dim",
    "unpack_bits",
    "prepack_weights",
    "xnor_matmul_fused_unpack",
    "xnor_matmul_packed",
    "xnor_matmul_packed_affine",
    "xnor_matmul_packed_sign",
]
