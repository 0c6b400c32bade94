"""CIFAR-10 loading: both on-disk layouts, per-channel normalization,
synthetic fallback.

Counterpart of the JAX package's ``data/cifar.py`` (``load_cifar10``),
framework-free numpy. Either layout is found under the data dir:

  * ``cifar-10-batches-bin/`` (preferred): data_batch_1..5.bin and
    test_batch.bin, records of 1 label byte + 3072 image bytes;
  * ``cifar-10-batches-py/``: the python pickle batches (a dict with
    b"data" (N, 3072) uint8 rows and b"labels"). ``pickle.load`` runs
    code from a hostile file: point ``data_dir`` only at batches from the
    official CIFAR distribution.

Rows are CHW (1024 red, 1024 green, 1024 blue bytes) and come out as
(N, 32, 32, 3) HWC images, normalized with CIFAR-10's train-split mean
and std. The binary layout goes through the native decoder
(``native.cifar_bin_decode_native``, the CHW -> HWC transpose fused into
the read) when the library is built, else the numpy reader (the same
arrays), as in the JAX package.
Without files, ``synthetic_blobs`` at (32, 32, 3), equal to the JAX
package's for the same seed.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Tuple

import numpy as np

from .common import ImageClassData, normalize_u8, synthetic_blobs

log = logging.getLogger(__name__)

CIFAR10_MEAN = np.array([0.4914, 0.4822, 0.4465], np.float32)
CIFAR10_STD = np.array([0.2470, 0.2435, 0.2616], np.float32)

_DEFAULT_DIRS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "data"),
    "./data",
)


def _normalize(images_u8: np.ndarray, norm: str) -> np.ndarray:
    """(N, 32, 32, 3) uint8 -> normalized float32 NHWC."""
    return normalize_u8(
        images_u8, norm, stats_name="cifar", mean=CIFAR10_MEAN, std=CIFAR10_STD
    )


def _rows_to_nhwc(rows: np.ndarray) -> np.ndarray:
    """(N, 3072) uint8 CHW rows -> (N, 32, 32, 3) uint8 NHWC."""
    return rows.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)


def _load_py_batches(d: str) -> Tuple[np.ndarray, ...] | None:
    names = [f"data_batch_{i}" for i in range(1, 6)]
    if not all(os.path.exists(os.path.join(d, n))
               for n in names + ["test_batch"]):
        return None

    def load(name):
        with open(os.path.join(d, name), "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        return batch[b"data"], np.asarray(batch[b"labels"], np.int32)

    xs, ys = zip(*(load(n) for n in names))
    te_x, te_y = load("test_batch")
    return (_rows_to_nhwc(np.concatenate(xs)), np.concatenate(ys),
            _rows_to_nhwc(te_x), te_y)


def _load_bin_batches(d: str) -> Tuple[np.ndarray, ...] | None:
    names = [f"data_batch_{i}.bin" for i in range(1, 6)]
    if not all(os.path.exists(os.path.join(d, n))
               for n in names + ["test_batch.bin"]):
        return None

    def load(name):
        path = os.path.join(d, name)
        size = os.path.getsize(path)
        if size == 0 or size % 3073:
            return None  # truncated or corrupt: the layout counts as absent
        from .. import native

        try:
            decoded = native.cifar_bin_decode_native(path, size // 3073)
        except ValueError as e:
            log.debug("native cifar decode failed (%s); numpy reader", e)
            decoded = None
        if decoded is not None:
            return decoded
        rec = np.fromfile(path, np.uint8).reshape(-1, 3073)
        return _rows_to_nhwc(rec[:, 1:]), rec[:, 0].astype(np.int32)

    loaded = [load(n) for n in names + ["test_batch.bin"]]
    if any(b is None for b in loaded):
        return None
    xs, ys = zip(*loaded[:-1])
    te_x, te_y = loaded[-1]
    return np.concatenate(xs), np.concatenate(ys), te_x, te_y


def load_cifar10(
    data_dir: str | None = None,
    *,
    norm: str = "cifar",
    synthetic_ok: bool = True,
    synthetic_sizes: Tuple[int, int] = (50000, 10000),
    seed: int = 0,
) -> ImageClassData:
    """Load CIFAR-10 from the binary or pickle layout under ``data_dir``
    (or the default dirs), either the parent dir or the batches dir
    itself; synthetic data when neither is found."""
    roots = [data_dir] if data_dir else list(_DEFAULT_DIRS)
    for root in roots:
        if root is None or not os.path.isdir(root):
            continue
        for sub, loader in (
            ("cifar-10-batches-bin", _load_bin_batches),
            ("cifar-10-batches-py", _load_py_batches),
            ("", _load_bin_batches),
            ("", _load_py_batches),
        ):
            d = os.path.join(root, sub) if sub else root
            if not os.path.isdir(d):
                continue
            loaded = loader(d)
            if loaded is not None:
                tr_x, tr_y, te_x, te_y = loaded
                return ImageClassData(
                    _normalize(tr_x, norm), tr_y,
                    _normalize(te_x, norm), te_y,
                    source="cifar10", name="cifar10",
                )
    if not synthetic_ok:
        raise FileNotFoundError(f"no CIFAR-10 batches found in {roots}")
    log.warning("no CIFAR-10 batches found; using synthetic data")
    tr_x, tr_y, te_x, te_y = synthetic_blobs((32, 32, 3), *synthetic_sizes,
                                             seed=seed)
    return ImageClassData(
        _normalize(tr_x, norm), tr_y, _normalize(te_x, norm), te_y,
        source="synthetic", name="cifar10",
    )
