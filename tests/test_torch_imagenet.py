"""The port's ImageNet loader (``data/imagenet.py``) against the JAX
package's on the same files: tiny PNG and JPEG images written here with
PIL from a numpy seed, in the folder layout and in per-class tars. The
decoded arrays, the class-balanced caps, the train split's wnid label
space, the streaming batches and their host shards, and the synthetic
fallback are held equal to the JAX loader's; ``Trainer.fit_stream``
sees the batches JAX's ``fit_stream`` sees, in the same order, and
trains as ``fit`` on the same images in memory, bitwise."""

import io
import os
import tarfile

import numpy as np
import pytest
import torch
from PIL import Image

from distributed_mnist_bnns_tpu.data import imagenet as jim
from distributed_mnist_bnns_tpu_torch.data import ImageClassData, imagenet as tim
from distributed_mnist_bnns_tpu_torch.data import shard_indices

WNIDS = ["n01440764", "n01443537", "n01484850"]
SIZE = 16


def _image_bytes(rng, fmt):
    h, w = rng.randint(12, 40, 2)
    im = Image.fromarray(rng.randint(0, 256, (h, w, 3), np.uint8))
    buf = io.BytesIO()
    im.save(buf, format=fmt)
    return buf.getvalue()


def _write(root, layout, seed=0, val_extra=True):
    """train/ with 5 images a class (the last class 3), val/ with 2 a
    class plus, with ``val_extra``, a class train does not have."""
    rng = np.random.RandomState(seed)
    for split, n in (("train", 5), ("val", 2)):
        d = os.path.join(root, split)
        os.makedirs(d)
        wnids = WNIDS + (["n09999999"] if split == "val" and val_extra
                         else [])
        for ci, wnid in enumerate(wnids):
            count = 3 if (split == "train" and ci == 2) else n
            files = [(f"{wnid}_{i}.{'png' if i % 2 else 'JPEG'}",
                      _image_bytes(rng, "PNG" if i % 2 else "JPEG"))
                     for i in range(count)]
            if layout == "folder" or split == "val":
                os.makedirs(os.path.join(d, wnid))
                for name, data in files:
                    with open(os.path.join(d, wnid, name), "wb") as f:
                        f.write(data)
            else:
                with tarfile.open(os.path.join(d, wnid + ".tar"), "w") as tf:
                    for name, data in files:
                        info = tarfile.TarInfo(name)
                        info.size = len(data)
                        tf.addfile(info, io.BytesIO(data))
    return root


def _same(got, want):
    for k in ("train_images", "train_labels", "test_images", "test_labels"):
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    assert (got.source, got.n_classes) == (want.source, want.n_classes)


@pytest.mark.parametrize("layout", ["folder", "tar"])
def test_load_imagenet_equals_jax(tmp_path, layout):
    root = _write(str(tmp_path), layout)
    kw = dict(image_size=SIZE, max_train=7, max_test=4, workers=2)
    got = tim.load_imagenet(root, **kw)
    _same(got, jim.load_imagenet(root, **kw))
    assert got.train_images.shape == (7, SIZE, SIZE, 3)
    assert got.source == "imagenet" and got.n_classes == 3
    # the cap is class-balanced: 7 of 3 classes -> 3, 2, 2 in some order
    assert sorted(np.bincount(got.train_labels, minlength=3)) == [2, 2, 3]


def test_val_split_keeps_the_train_label_space(tmp_path):
    """val's extra wnid is dropped and val labels index train's wnids."""
    root = _write(str(tmp_path), "folder")
    train = tim.open_imagenet_stream(root, "train", image_size=SIZE)
    val = tim.open_imagenet_stream(root, "val", image_size=SIZE,
                                   wnids=train.index.wnids)
    jtrain = jim.open_imagenet_stream(root, "train", image_size=SIZE)
    jval = jim.open_imagenet_stream(root, "val", image_size=SIZE,
                                    wnids=jtrain.index.wnids)
    assert val.index.wnids == WNIDS == list(jval.index.wnids)
    assert [s for s, _ in val.index.items] == [s for s, _ in jval.index.items]
    np.testing.assert_array_equal(val.index.labels(), jval.index.labels())
    assert len(val) == 6 and sorted(set(val.index.labels())) == [0, 1, 2]


def test_no_val_split_holds_out_a_tenth(tmp_path):
    root = _write(str(tmp_path), "folder")
    import shutil

    shutil.rmtree(os.path.join(root, "val"))
    kw = dict(image_size=SIZE, max_train=None, workers=2)
    got = tim.load_imagenet(root, **kw)
    _same(got, jim.load_imagenet(root, **kw))
    assert len(got.test_labels) == 1 and len(got.train_labels) == 12


@pytest.mark.parametrize("layout", ["folder", "tar"])
def test_stream_batches_equal_jax(tmp_path, layout):
    root = _write(str(tmp_path), layout)
    s = tim.open_imagenet_stream(root, "train", image_size=SIZE, workers=3)
    j = jim.open_imagenet_stream(root, "train", image_size=SIZE, workers=3)
    assert len(s) == len(j) == 13
    for kw in (dict(epoch=0, seed=0), dict(epoch=1, seed=4, host_id=1,
                                           num_hosts=2, drop_last=False)):
        got = list(s.batches(4, **kw))
        want = list(j.batches(4, **kw))
        assert len(got) == len(want) > 0
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)
    x, y = s.materialize(5, seed=2)
    jx, jy = j.materialize(5, seed=2)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


def test_host_shards_partition_the_epoch():
    n, hosts = 13, 3
    shards = [shard_indices(n, epoch=2, seed=1, host_id=h, num_hosts=hosts)
              for h in range(hosts)]
    assert len({len(sh) for sh in shards}) == 1     # padded alike
    assert set(np.concatenate(shards)) == set(range(n))
    for h in range(hosts):
        np.testing.assert_array_equal(
            shards[h], jim.shard_indices(n, epoch=2, seed=1, host_id=h,
                                         num_hosts=hosts))


def test_balanced_subset_equals_jax():
    labels = np.random.RandomState(0).randint(0, 5, 40).astype(np.int32)
    for n in (3, 5, 11, 40, 50):
        got = tim._balanced_subset(labels, n, np.random.RandomState(7))
        want = jim._balanced_subset(labels, n, np.random.RandomState(7))
        np.testing.assert_array_equal(got, want)
        counts = np.bincount(labels[got], minlength=5)
        assert counts.max() - counts.min() <= max(
            0, np.bincount(labels).max() - np.bincount(labels).min()) + 1


@pytest.mark.parametrize("size,classes", [(24, 1000), (13, 7)])
def test_synthetic_equals_jax(tmp_path, size, classes):
    missing = str(tmp_path / "none")
    kw = dict(image_size=size, synthetic_sizes=(6, 3),
              synthetic_classes=classes, seed=3)
    got = tim.load_imagenet(missing, **kw)
    _same(got, jim.load_imagenet(missing, **kw))
    assert got.input_shape == (size, size, 3) and got.n_classes == classes
    with pytest.raises(FileNotFoundError):
        tim.load_imagenet(missing, synthetic_ok=False)


def test_unreadable_tar_is_left_out(tmp_path):
    root = _write(str(tmp_path), "tar")
    with open(os.path.join(root, "train", "n00000001.tar"), "wb") as f:
        f.write(b"not a tar")
    s = tim.open_imagenet_stream(root, "train", image_size=SIZE)
    assert s.index.wnids == WNIDS


def test_fit_stream_sees_jax_batches_and_trains_as_fit(tmp_path):
    """``Trainer.fit_stream`` over a folder: the batches reach the step
    in the JAX ``fit_stream``'s order with the same pixels and labels
    (the JAX step replaced by a recorder: its training parity is held in
    ``test_torch_resnet.py``), and the run equals ``fit`` over the same
    images in memory, bitwise (the same seeded order); ``eval_data`` is
    evaluated."""
    import jax.numpy as jnp

    from distributed_mnist_bnns_tpu.train import TrainConfig as JConfig
    from distributed_mnist_bnns_tpu.train import Trainer as JTrainer
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer

    root = _write(str(tmp_path), "folder")
    stream = tim.open_imagenet_stream(root, "train", image_size=SIZE,
                                      workers=2)
    jstream = jim.open_imagenet_stream(root, "train", image_size=SIZE,
                                       workers=2)
    kw = dict(model="xnor-resnet18", batch_size=4, epochs=2, seed=3,
              optimizer="sgd", learning_rate=0.01, backend="xla",
              model_kwargs={"stem_features": 4, "num_classes": 3},
              log_interval=1)
    jt = JTrainer(JConfig(**kw), input_shape=(SIZE, SIZE, 3))
    jseen = []

    def jstep(state, images, labels, rng):
        jseen.append((np.asarray(images), np.asarray(labels)))
        return state, {"loss": jnp.zeros(()), "accuracy": jnp.zeros(())}

    jt.train_step = jstep
    jt.fit_stream(jstream)
    t = Trainer(TrainConfig(**kw, device="cpu"), input_shape=(SIZE, SIZE, 3))
    seen, step = [], t.train_step

    def recorded(model, optimizer, images, labels):
        seen.append((images.numpy().copy(), labels.numpy().copy()))
        return step(model, optimizer, images, labels)

    t.train_step = recorded
    x, y = stream.materialize(None)
    eval_data = ImageClassData(x[:1], y[:1], x, y, n_classes=3)
    hist = t.fit_stream(stream, eval_data=eval_data)
    assert len(seen) == len(jseen) == 6 and len(hist) == 2
    for (gx, gy), (wx, wy) in zip(seen, jseen):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert "test_acc" in hist[-1] and np.isfinite(hist[-1]["train_loss"])
    mem = Trainer(TrainConfig(**kw, device="cpu"), input_shape=(SIZE, SIZE, 3))
    mem.fit(ImageClassData(x, y, x, y, n_classes=3), eval_every=0)
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, mem.model.state_dict()[k]), k
