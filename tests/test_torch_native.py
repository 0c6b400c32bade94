"""The port's native data runtime (``native/``: its own copies of
``idx_loader.cpp`` and ``batch_pool.cpp``) against the JAX package's
library on the same files: idx images and labels, normalized floats,
packed bits, CIFAR-10 binary records and the BatchPool's batches in
order, all bitwise; the loaders and the trainer's ``native_loader`` on
top of it. The library builds with ``g++`` into the port's ``_build/``
directory under a hash of its sources and flags, never beside them.
"""

import os
import struct

import numpy as np
import pytest

from distributed_mnist_bnns_tpu import native as jnative
from distributed_mnist_bnns_tpu.data import batch_iterator as jbatch_iterator
from distributed_mnist_bnns_tpu.data.cifar import load_cifar10 as jcifar
from distributed_mnist_bnns_tpu.data.mnist import load_idx as jload_idx
from distributed_mnist_bnns_tpu.ops.bitpack import pack_bits_np
from distributed_mnist_bnns_tpu_torch import native
from distributed_mnist_bnns_tpu_torch.data import (
    batch_iterator,
    load_cifar10,
    load_idx,
    native_batch_iterator,
)


@pytest.fixture(autouse=True)
def _both_libraries():
    """Both libraries built (decided at test time, not at import)."""
    if not (native.available() and jnative.available()):
        pytest.skip("g++ unavailable: no native library to compare")


def _idx(path, data):
    with open(path, "wb") as f:
        f.write(struct.pack(">I", 0x00000800 | data.ndim))
        f.write(struct.pack(f">{data.ndim}I", *data.shape))
        f.write(data.tobytes())
    return str(path)


@pytest.mark.parametrize("shape", [(3, 4, 5), (7,), (2, 28, 28)])
def test_idx_is_the_jax_librarys(tmp_path, shape):
    data = np.random.RandomState(sum(shape)).randint(
        0, 256, shape).astype(np.uint8)
    path = _idx(tmp_path / "mini-idx-ubyte", data)
    got = native.load_idx_native(path)
    assert got.dtype == np.uint8 and got.shape == shape
    assert got.tobytes() == jnative.load_idx_native(path).tobytes()
    assert got.tobytes() == data.tobytes()
    # the loader takes the native path, and equals the JAX loader's
    assert load_idx(path).tobytes() == jload_idx(path).tobytes()


def test_bad_idx_raises_and_the_loader_names_it(tmp_path):
    path = tmp_path / "bad-idx-ubyte"
    path.write_bytes(b"\x00\x00\x09\x01\x00\x00\x00\x02ab")
    with pytest.raises(ValueError, match="bad idx file"):
        native.load_idx_native(str(path))
    with pytest.raises(ValueError, match="bad idx magic"):
        load_idx(str(path))
    assert native.load_idx_native(str(path) + ".gz") is None


@pytest.mark.parametrize("mean,std", [(0.1307, 0.3081), (0.5, 0.5),
                                      (0.0, 1.0)])
def test_normalize_is_the_jax_librarys(mean, std):
    u8 = np.random.RandomState(0).randint(0, 256, (7, 28, 28),
                                          dtype=np.uint8)
    got = native.normalize_native(u8, mean, std)
    want = jnative.normalize_native(u8, mean, std)
    assert got.dtype == np.float32 and got.shape == u8.shape
    assert got.tobytes() == want.tobytes()
    np.testing.assert_allclose(
        got, (u8.astype(np.float32) / 255.0 - mean) / std, atol=1e-6)


@pytest.mark.parametrize("rows,k", [(13, 131), (1, 32), (4, 1), (3, 64)])
def test_pack_bits_is_the_jax_librarys(rows, k):
    x = np.sign(np.random.RandomState(k).randn(rows, k)).astype(np.float32)
    x[x == 0] = 1
    got = native.pack_bits_native(x)
    assert got.tobytes() == jnative.pack_bits_native(x).tobytes()
    assert got.tobytes() == pack_bits_np(x).tobytes()


def _cifar_records(path, n, seed):
    rng = np.random.RandomState(seed)
    rec = np.concatenate([rng.randint(0, 10, (n, 1)),
                          rng.randint(0, 256, (n, 3072))],
                         axis=1).astype(np.uint8)
    rec.tofile(path)
    return rec


def test_cifar_records_are_the_jax_librarys(tmp_path):
    rec = _cifar_records(tmp_path / "data_batch_1.bin", 6, 7)
    images, labels = native.cifar_bin_decode_native(
        str(tmp_path / "data_batch_1.bin"), 6)
    j_images, j_labels = jnative.cifar_bin_decode_native(
        str(tmp_path / "data_batch_1.bin"), 6)
    assert images.tobytes() == j_images.tobytes()
    assert labels.dtype == np.int32 and labels.tobytes() == j_labels.tobytes()
    assert images.tobytes() == rec[:, 1:].reshape(-1, 3, 32, 32).transpose(
        0, 2, 3, 1).tobytes()
    with pytest.raises(ValueError, match="decode failed"):
        native.cifar_bin_decode_native(str(tmp_path / "data_batch_1.bin"), 7)


def test_cifar_loader_takes_the_native_path(tmp_path, monkeypatch):
    """The binary layout through the native decoder: the same dataset
    as the JAX loader's, and as the port's numpy reader's."""
    d = tmp_path / "cifar-10-batches-bin"
    d.mkdir()
    for i, name in enumerate([f"data_batch_{i}.bin" for i in range(1, 6)]
                             + ["test_batch.bin"]):
        _cifar_records(d / name, 3, i)
    calls = []
    decode = native.cifar_bin_decode_native
    monkeypatch.setattr(native, "cifar_bin_decode_native",
                        lambda *a: calls.append(a) or decode(*a))
    got = load_cifar10(str(tmp_path))
    assert len(calls) == 6 and got.source == "cifar10"
    want = jcifar(str(tmp_path))
    for k in ("train_images", "train_labels", "test_images", "test_labels"):
        assert getattr(got, k).tobytes() == getattr(want, k).tobytes(), k
    monkeypatch.setattr(native, "cifar_bin_decode_native",
                        lambda *a: None)
    numpy_read = load_cifar10(str(tmp_path))
    assert numpy_read.train_images.tobytes() == got.train_images.tobytes()


def _data(n=500, shape=(5, 5, 1), seed=0):
    rng = np.random.RandomState(seed)
    return (rng.rand(n, *shape).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


@pytest.mark.parametrize("threads,slots", [(3, 2), (1, 1), (4, 8)])
def test_pool_batches_are_the_jax_pools_in_order(threads, slots):
    images, labels = _data()
    idx = np.random.RandomState(1).permutation(500).astype(np.int64)
    with native.BatchPool.create(images, labels, idx, 64,
                                 n_threads=threads, n_slots=slots) as pool:
        got = list(pool)
    with jnative.BatchPool.create(images, labels, idx, 64,
                                  n_threads=threads, n_slots=slots) as pool:
        want = list(pool)
    assert len(got) == len(want) == 500 // 64
    for b, ((im, lb), (jim, jlb)) in enumerate(zip(got, want)):
        sel = idx[b * 64:(b + 1) * 64]
        assert im.tobytes() == jim.tobytes() == images[sel].tobytes()
        assert lb.tobytes() == jlb.tobytes() == labels[sel].tobytes()


def test_pool_early_close_and_bad_indices():
    images, labels = _data()
    pool = native.BatchPool.create(images, labels,
                                   np.arange(500, dtype=np.int64), 32,
                                   n_threads=2, n_slots=2)
    it = iter(pool)
    next(it)          # one batch, then abandoned mid-stream
    pool.close()      # joins the workers: must not hang or crash
    assert list(it) == []
    with pytest.raises(IndexError):
        native.BatchPool.create(images[:10], labels[:10],
                                np.array([0, 99], dtype=np.int64), 2)


@pytest.mark.parametrize("kw", [dict(epoch=2, seed=5, host_id=1,
                                     num_hosts=2),
                                dict(epoch=0, seed=3)])
def test_native_iterator_is_the_numpy_and_jax_iterators(kw):
    images, labels = _data(n=300)
    want = list(jbatch_iterator(images, labels, 32, **kw))
    for got in (list(native_batch_iterator(images, labels, 32, **kw)),
                list(batch_iterator(images, labels, 32, **kw))):
        assert len(got) == len(want)
        for (gi, gl), (wi, wl) in zip(got, want):
            assert gi.tobytes() == wi.tobytes()
            assert gl.tobytes() == wl.tobytes()


def test_native_iterator_falls_back(monkeypatch):
    monkeypatch.setattr(native.BatchPool, "create",
                        classmethod(lambda *a, **k: None))
    images, labels = _data(n=100)
    want = list(batch_iterator(images, labels, 16, epoch=0, seed=3))
    got = list(native_batch_iterator(images, labels, 16, epoch=0, seed=3))
    assert [g[0].tobytes() for g in got] == [w[0].tobytes() for w in want]


def test_library_builds_from_the_ports_sources_into_its_build_dir(
        tmp_path, monkeypatch):
    """With an empty build directory the library is built there under
    the hash of the port's sources; nothing lands beside them, and
    ``DMB_TPU_NO_NATIVE=1`` turns every entry into the numpy paths."""
    from distributed_mnist_bnns_tpu_torch.ops import _kernels

    src_dir = os.path.dirname(native.__file__)
    before = sorted(os.listdir(src_dir))
    assert native.lib_path().startswith(_kernels.BUILD_DIR + os.sep)
    name = os.path.basename(native.lib_path())
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert native.available()
    assert os.listdir(tmp_path) == [name]
    x = np.where(np.arange(70) % 3, 1.0, -1.0).astype(np.float32)[None]
    assert native.pack_bits_native(x).tobytes() == pack_bits_np(x).tobytes()
    monkeypatch.setenv("DMB_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(_kernels, "BUILD_DIR", str(tmp_path / "x"))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    assert not native.available()
    assert native.pack_bits_native(x) is None
    assert native.BatchPool.create(*_data(n=8), np.arange(8), 4) is None
    assert not (tmp_path / "x").exists()
    assert sorted(os.listdir(src_dir)) == before


@pytest.mark.parametrize("scan_steps", [1, 3])
def test_trainer_native_loader_is_the_numpy_loaders_trajectory(scan_steps):
    """``native_loader=True`` reproduces the numpy loader's batches and
    so its training trajectory bitwise, per step and under
    ``scan_steps``."""
    import torch

    from distributed_mnist_bnns_tpu_torch.data import ImageClassData
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    rng = np.random.RandomState(0)
    data = ImageClassData(rng.rand(96, 28, 28, 1).astype(np.float32),
                          rng.randint(0, 10, 96).astype(np.int32),
                          rng.rand(16, 28, 28, 1).astype(np.float32),
                          rng.randint(0, 10, 16).astype(np.int32))

    def run(native_loader):
        t = Trainer(TrainConfig(
            model="bnn-mlp-small", model_kwargs={"infl_ratio": 1},
            batch_size=16, epochs=1, seed=4, backend="xla", device="cpu",
            native_loader=native_loader, scan_steps=scan_steps))
        t.train_epoch(data, 0)
        return t

    t_np, t_nat = run(False), run(True)
    assert t_np.step == t_nat.step == 6
    for (k, a), b in zip(t_np.model.state_dict().items(),
                         t_nat.model.state_dict().values()):
        assert torch.equal(a, b), k
