"""Shared dataset container and helpers, copied from the JAX package's
``data/common.py`` (framework-free numpy)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ImageClassData:
    """Train/test images as normalized float32 NHWC, int32 labels."""

    train_images: np.ndarray
    train_labels: np.ndarray
    test_images: np.ndarray
    test_labels: np.ndarray
    source: str = ""        # e.g. "mnist" | "t10k-split" | "synthetic"
    name: str = "mnist"     # dataset family
    n_classes: int = 10     # label-space size

    @property
    def input_shape(self):
        return tuple(self.train_images.shape[1:])


def normalize_u8(
    images_u8: np.ndarray,
    norm: str,
    *,
    stats_name: str,
    mean,
    std,
) -> np.ndarray:
    """uint8 images -> float32 in [0,1], then normalized.

    ``norm`` is the dataset's own stats name (e.g. "mnist"), "half"
    ((x-0.5)/0.5), or "none"."""
    x = images_u8.astype(np.float32) / 255.0
    if norm == stats_name:
        x = (x - mean) / std
    elif norm == "half":
        x = (x - 0.5) / 0.5
    elif norm != "none":
        raise ValueError(
            f"unknown norm {norm!r} (have: {stats_name!r}, 'half', 'none')"
        )
    return x


def synthetic_blobs(
    image_shape, n_train: int, n_test: int, seed: int, n_classes: int = 10
):
    """Class-conditional blobs: each class gets a fixed random template;
    samples are template + noise. Returns uint8
    (train_x, train_y, test_x, test_y), equal to the JAX package's for the
    same arguments."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(n_classes, *image_shape).astype(np.float32)

    def make(n):
        labels = rng.randint(0, n_classes, size=n).astype(np.int32)
        imgs = templates[labels] + 0.3 * rng.randn(n, *image_shape).astype(
            np.float32
        )
        return (np.clip(imgs, 0.0, 1.0) * 255).astype(np.uint8), labels

    tr_x, tr_y = make(n_train)
    te_x, te_y = make(n_test)
    return tr_x, tr_y, te_x, te_y
