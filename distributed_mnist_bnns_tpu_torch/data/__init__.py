from .common import ImageClassData, normalize_u8, synthetic_blobs
from .mnist import load_idx, load_mnist

__all__ = [
    "ImageClassData",
    "load_idx",
    "load_mnist",
    "normalize_u8",
    "synthetic_blobs",
]
