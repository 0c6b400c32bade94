from .common import ImageClassData, normalize_u8, synthetic_blobs
from .mnist import batch_iterator, load_idx, load_mnist, shard_indices

__all__ = [
    "ImageClassData",
    "batch_iterator",
    "load_idx",
    "load_mnist",
    "normalize_u8",
    "shard_indices",
    "synthetic_blobs",
]
