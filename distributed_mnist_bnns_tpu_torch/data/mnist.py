"""MNIST loading: idx parsing, normalization, synthetic fallback.

Counterpart of the JAX package's ``data/mnist.py`` (``load_idx``,
``load_mnist``, ``shard_indices``, ``batch_iterator``). idx ubyte files
(optionally gzipped) are parsed in pure Python/numpy; the native C++
decoder and batch gather are not part of this package yet. The batch
order is the JAX package's: the same seed and epoch give the same
batches in the same order.
"""

from __future__ import annotations

import gzip
import logging
import os
import struct
from typing import Iterator, Optional, Tuple

import numpy as np

from .common import ImageClassData, normalize_u8, synthetic_blobs

log = logging.getLogger(__name__)

MNIST_MEAN = 0.1307
MNIST_STD = 0.3081

_DEFAULT_DIRS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "data", "MNIST", "raw"),
    "./data/MNIST/raw",
)


def load_idx(path: str) -> np.ndarray:
    """Parse an idx ubyte file (magic 0x0801 labels / 0x0803 images), gz ok."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        if (magic >> 8) != 0x08 or ndim not in (1, 3):
            raise ValueError(f"{path}: bad idx magic {magic:#x}")
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)


def _find_file(data_dir: str, stem: str) -> Optional[str]:
    for suffix in ("", ".gz"):
        p = os.path.join(data_dir, stem + suffix)
        if os.path.exists(p):
            return p
    return None


def _normalize(images_u8: np.ndarray, norm: str) -> np.ndarray:
    x = normalize_u8(
        images_u8, norm, stats_name="mnist", mean=MNIST_MEAN, std=MNIST_STD
    )
    return x[..., None]  # NHWC with 1 channel


def load_mnist(
    data_dir: Optional[str] = None,
    *,
    norm: str = "mnist",
    synthetic_ok: bool = True,
    synthetic_sizes: Tuple[int, int] = (60000, 10000),
    seed: int = 0,
) -> ImageClassData:
    """Load MNIST with graceful degradation.

    Resolution order:
      1. full train + t10k idx files under ``data_dir`` (or the first
         default dir that has them);
      2. t10k only -> deterministic 9k/1k train/test split of the 10k set;
      3. synthetic class-conditional data (if ``synthetic_ok``).
    """
    dirs = [data_dir] if data_dir else list(_DEFAULT_DIRS)
    for d in dirs:
        if not os.path.isdir(d):
            continue
        tr_x_p = _find_file(d, "train-images-idx3-ubyte")
        tr_y_p = _find_file(d, "train-labels-idx1-ubyte")
        te_x_p = _find_file(d, "t10k-images-idx3-ubyte")
        te_y_p = _find_file(d, "t10k-labels-idx1-ubyte")
        if te_x_p and te_y_p:
            te_x, te_y = load_idx(te_x_p), load_idx(te_y_p).astype(np.int32)
            if tr_x_p and tr_y_p:
                tr_x = load_idx(tr_x_p)
                tr_y = load_idx(tr_y_p).astype(np.int32)
                return ImageClassData(
                    _normalize(tr_x, norm), tr_y,
                    _normalize(te_x, norm), te_y, source="mnist",
                )
            log.warning(
                "train images missing under %s; splitting t10k 9k/1k", d
            )
            perm = np.random.RandomState(seed).permutation(len(te_x))
            tr_idx, te_idx = perm[:9000], perm[9000:]
            return ImageClassData(
                _normalize(te_x[tr_idx], norm), te_y[tr_idx],
                _normalize(te_x[te_idx], norm), te_y[te_idx],
                source="t10k-split",
            )
    if not synthetic_ok:
        raise FileNotFoundError(f"no MNIST idx files found in {dirs}")
    log.warning("no MNIST idx files found; using synthetic data")
    tr_x, tr_y, te_x, te_y = synthetic_blobs((28, 28), *synthetic_sizes, seed=seed)
    return ImageClassData(
        _normalize(tr_x, norm), tr_y, _normalize(te_x, norm), te_y,
        source="synthetic",
    )


def shard_indices(
    n: int, *, epoch: int, seed: int, host_id: int = 0, num_hosts: int = 1,
    shuffle: bool = True,
) -> np.ndarray:
    """DistributedSampler-equivalent index shard: the permutation of
    ``RandomState(seed + epoch)``, padded by wraparound to a multiple of
    ``num_hosts``, rank-strided so every host gets the same count."""
    if shuffle:
        idx = np.random.RandomState(seed + epoch).permutation(n)
    else:
        idx = np.arange(n)
    total = -(-n // num_hosts) * num_hosts
    if total > n:
        idx = np.concatenate([idx, idx[: total - n]])
    return idx[host_id::num_hosts]


def batch_iterator(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    *,
    epoch: int = 0,
    seed: int = 0,
    host_id: int = 0,
    num_hosts: int = 1,
    shuffle: bool = True,
    drop_last: bool = True,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Batches of ``shard_indices``' order as numpy arrays; with
    ``drop_last`` every batch has ``batch_size`` rows."""
    idx = shard_indices(
        len(images), epoch=epoch, seed=seed, host_id=host_id,
        num_hosts=num_hosts, shuffle=shuffle,
    )
    n_full = len(idx) // batch_size
    for b in range(n_full):
        sel = idx[b * batch_size:(b + 1) * batch_size]
        yield images[sel], labels[sel]
    if not drop_last and len(idx) % batch_size:
        sel = idx[n_full * batch_size:]
        yield images[sel], labels[sel]
