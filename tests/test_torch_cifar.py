"""The port's CIFAR-10 loader (``data/cifar.py``, ``load_dataset``)
against the JAX package's on the same files: both on-disk layouts (the
python pickle batches and the binary records) written here from a numpy
seed, the CHW -> HWC rows, the normalizations, the synthetic fallback.
Every array is held equal to the JAX loader's (numpy in both)."""

import os
import pickle

import numpy as np
import pytest

from distributed_mnist_bnns_tpu.data import load_cifar10 as jload
from distributed_mnist_bnns_tpu.data import load_dataset as jload_dataset
from distributed_mnist_bnns_tpu_torch.data import (
    CIFAR10_MEAN,
    CIFAR10_STD,
    load_cifar10,
    load_dataset,
)
from distributed_mnist_bnns_tpu_torch.data.cifar import _rows_to_nhwc

NAMES = [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]


def _rows(rng, n):
    return rng.randint(0, 256, size=(n, 3072), dtype=np.uint8)


def _write_py(root, n=3, seed=0):
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    rng = np.random.RandomState(seed)
    for name in NAMES:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": _rows(rng, n),
                         b"labels": list(rng.randint(0, 10, n))}, f)
    return d


def _write_bin(root, n=3, seed=0):
    d = os.path.join(root, "cifar-10-batches-bin")
    os.makedirs(d)
    rng = np.random.RandomState(seed)
    for name in NAMES:
        rec = np.concatenate([rng.randint(0, 10, (n, 1)).astype(np.uint8),
                              _rows(rng, n)], axis=1)
        rec.tofile(os.path.join(d, name + ".bin"))
    return d


def _assert_same(got, want):
    for k in ("train_images", "train_labels", "test_images", "test_labels"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert (got.source, got.name, got.n_classes) == (
        want.source, want.name, want.n_classes)


@pytest.mark.parametrize("norm", ["cifar", "half", "none"])
@pytest.mark.parametrize("writer", [_write_py, _write_bin],
                         ids=["py", "bin"])
def test_layouts_equal_the_jax_loader(tmp_path, writer, norm):
    writer(str(tmp_path))
    got = load_cifar10(str(tmp_path), norm=norm)
    _assert_same(got, jload(str(tmp_path), norm=norm))
    assert got.source == "cifar10"
    assert got.train_images.shape == (15, 32, 32, 3)
    assert got.test_images.shape == (3, 32, 32, 3)


def test_the_batches_dir_itself_and_bin_preferred(tmp_path):
    """The batches dir may be given itself; with both layouts present the
    binary one is read (pickle runs a hostile file's code)."""
    d = _write_py(str(tmp_path), seed=1)
    _assert_same(load_cifar10(d), jload(d))
    _write_bin(str(tmp_path), seed=2)
    got = load_cifar10(str(tmp_path))
    _assert_same(got, jload(str(tmp_path)))
    binary = load_cifar10(os.path.join(str(tmp_path), "cifar-10-batches-bin"))
    _assert_same(got, binary)


def test_chw_rows_become_hwc_pixels():
    rng = np.random.RandomState(3)
    rows = _rows(rng, 4)
    img = _rows_to_nhwc(rows)
    assert img.shape == (4, 32, 32, 3)
    for b, c, y, x in ((0, 0, 0, 0), (1, 2, 31, 5), (3, 1, 7, 30)):
        assert img[b, y, x, c] == rows[b, c * 1024 + y * 32 + x]


def test_normalization_statistics(tmp_path):
    _write_bin(str(tmp_path))
    raw = load_cifar10(str(tmp_path), norm="none").train_images
    stats = load_cifar10(str(tmp_path)).train_images
    np.testing.assert_array_equal(stats, (raw - CIFAR10_MEAN) / CIFAR10_STD)
    with pytest.raises(ValueError, match="unknown norm"):
        load_cifar10(str(tmp_path), norm="mnist")


def test_truncated_records_fall_back(tmp_path):
    """A binary file that is not a whole number of records makes the
    layout absent: without another layout, the synthetic fallback, and
    without that, FileNotFoundError, as in JAX."""
    d = _write_bin(str(tmp_path))
    with open(os.path.join(d, "test_batch.bin"), "ab") as f:
        f.write(b"\x00")
    got = load_cifar10(str(tmp_path), synthetic_sizes=(8, 4))
    _assert_same(got, jload(str(tmp_path), synthetic_sizes=(8, 4)))
    assert got.source == "synthetic"
    with pytest.raises(FileNotFoundError):
        load_cifar10(str(tmp_path), synthetic_ok=False)


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_fallback_equals_jax(tmp_path, seed):
    missing = str(tmp_path / "none")
    got = load_cifar10(missing, synthetic_sizes=(12, 6), seed=seed)
    _assert_same(got, jload(missing, synthetic_sizes=(12, 6), seed=seed))
    assert got.input_shape == (32, 32, 3) and got.name == "cifar10"


@pytest.mark.parametrize("name", ["cifar10", "cifar", "mnist"])
def test_load_dataset_dispatch(tmp_path, name):
    missing = str(tmp_path / "none")
    got = load_dataset(name, missing, synthetic_sizes=(8, 4))
    _assert_same(got, jload_dataset(name, missing, synthetic_sizes=(8, 4)))
    with pytest.raises(ValueError, match="unknown dataset"):
        load_dataset("svhn", missing)
