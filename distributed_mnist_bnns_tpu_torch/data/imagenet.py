"""ImageNet-1k loading: an in-memory class-balanced subset, a streaming
split, and a synthetic fallback.

Counterpart of the JAX package's ``data/imagenet.py``, framework-free
(numpy, PIL imported inside ``_decode_u8`` only, and the standard
library's tarfile and threads):

  * ``load_imagenet`` returns the ``ImageClassData`` every pipeline
    returns, capped at ``max_train`` / ``max_test`` class-balanced
    images (``_balanced_subset``), or ImageNet-shaped synthetic data
    (``synthetic_imagenet``) where no layout is on disk;
  * ``open_imagenet_stream`` -> ``ImageNetStream`` decodes each batch on
    worker threads (``batches``), this host's share of the epoch from
    ``shard_indices``: the whole-dataset path (``Trainer.fit_stream``).

The host decodes deterministically (resize the shorter side to
256/224 of the size, bilinear, centre crop); the random crop and flip
run on the device inside the train step (``ops.augment``).

Layouts (found under the data dir, or its ``imagenet/``):
``train/<wnid>/*.JPEG`` and ``val/<wnid>/*.JPEG`` folders, or
per-class ``train/<wnid>.tar`` archives. A val split is indexed against
the train split's wnids, so a label means the same class in both.
"""

from __future__ import annotations

import io
import logging
import os
import tarfile
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .common import ImageClassData, normalize_u8
from .mnist import shard_indices

log = logging.getLogger(__name__)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_DEFAULT_DIRS = (
    os.path.join(os.path.dirname(__file__), "..", "..", "data"),
    "./data",
)
_IMG_EXTS = (".jpeg", ".jpg", ".png")


def _normalize(images_u8: np.ndarray, norm: str) -> np.ndarray:
    """(N, H, W, 3) uint8 -> normalized float32 NHWC."""
    return normalize_u8(images_u8, norm, stats_name="imagenet",
                        mean=IMAGENET_MEAN, std=IMAGENET_STD)


def _decode_u8(data: bytes, image_size: int) -> np.ndarray:
    """JPEG/PNG bytes -> (image_size, image_size, 3) uint8: the shorter
    side resized to round(image_size * 256 / 224) (bilinear), then the
    centre ``image_size`` square."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB")
        short = round(image_size * 256 / 224)
        w, h = im.size
        if w <= h:
            w, h = short, max(1, round(h * short / w))
        else:
            w, h = max(1, round(w * short / h)), short
        im = im.resize((w, h), Image.BILINEAR)
        left = (w - image_size) // 2
        top = (h - image_size) // 2
        im = im.crop((left, top, left + image_size, top + image_size))
        return np.asarray(im, np.uint8)


class _TarCache:
    """Each worker thread's open ``TarFile`` handles (a TarFile is not
    thread-safe), kept open across members."""

    def __init__(self):
        self._local = threading.local()

    def member_bytes(self, tar_path: str, member: str) -> bytes:
        handles = getattr(self._local, "handles", None)
        if handles is None:
            handles = self._local.handles = {}
        tf = handles.get(tar_path)
        if tf is None:
            tf = handles[tar_path] = tarfile.open(tar_path, "r")
        f = tf.extractfile(member)
        if f is None:
            raise FileNotFoundError(f"{member} not in {tar_path}")
        with f:
            return f.read()


@dataclass
class ImageNetIndex:
    """A split's items: (source, label) pairs, the source a file path or
    a (tar path, member name) pair; label i is ``wnids[i]``."""

    items: List[Tuple]
    wnids: Sequence[str]
    split: str

    @property
    def n_classes(self) -> int:
        return len(self.wnids)

    def labels(self) -> np.ndarray:
        return np.asarray([lb for _, lb in self.items], np.int32)


def _tar_members(tar_path: str) -> Optional[List[str]]:
    try:
        with tarfile.open(tar_path, "r") as tf:
            return sorted(m.name for m in tf.getmembers()
                          if m.isfile() and m.name.lower().endswith(_IMG_EXTS))
    except tarfile.TarError:
        log.warning("skipping unreadable tar %s", tar_path)
        return None


def _index_split(split_dir: str, wnids: Optional[Sequence[str]] = None,
                 workers: int = 8) -> Optional[ImageNetIndex]:
    """Index one split dir in either layout; None if absent or empty.
    With ``wnids`` (the train split's label space), classes outside it
    are dropped with a warning."""
    if not os.path.isdir(split_dir):
        return None
    entries = sorted(os.listdir(split_dir))
    wnid_dirs = [e for e in entries
                 if os.path.isdir(os.path.join(split_dir, e))]
    wnid_tars = [e for e in entries if e.endswith(".tar")]
    per_class: dict = {}
    if wnid_dirs:
        for wnid in wnid_dirs:
            d = os.path.join(split_dir, wnid)
            per_class[wnid] = [os.path.join(d, name)
                               for name in sorted(os.listdir(d))
                               if name.lower().endswith(_IMG_EXTS)]
    elif wnid_tars:
        # the archives' headers are scanned in parallel
        paths = [os.path.join(split_dir, t) for t in wnid_tars]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            scanned = list(pool.map(_tar_members, paths))
        for tar_name, tar_path, members in zip(wnid_tars, paths, scanned):
            if members is None:
                continue   # unreadable: the class is left out
            per_class[tar_name[:-len(".tar")]] = [(tar_path, m)
                                                  for m in members]
    else:
        return None
    if wnids is None:
        wnids = sorted(per_class)
    mapping = {w: i for i, w in enumerate(wnids)}
    dropped = sorted(set(per_class) - set(mapping))
    if dropped:
        log.warning("%s: dropping %d wnid(s) absent from the train label "
                    "space (e.g. %s)", split_dir, len(dropped), dropped[:3])
    items: List[Tuple] = []
    for wnid in sorted(per_class):
        if wnid in mapping:
            items.extend((src, mapping[wnid]) for src in per_class[wnid])
    if not items:
        return None
    return ImageNetIndex(items=items, wnids=list(wnids),
                         split=os.path.basename(split_dir))


def _find_split_dir(data_dir: Optional[str], split: str) -> Optional[str]:
    roots = [data_dir] if data_dir else list(_DEFAULT_DIRS)
    for root in roots:
        if root is None or not os.path.isdir(root):
            continue
        for sub in (os.path.join("imagenet", split), split):
            d = os.path.join(root, sub)
            if os.path.isdir(d):
                return d
    return None


@dataclass
class ImageNetStream:
    """A streaming split: each batch decoded on worker threads; no more
    than a batch of decoded images is held at once."""

    index: ImageNetIndex
    image_size: int = 224
    norm: str = "imagenet"
    workers: int = 8
    _tars: _TarCache = field(default_factory=_TarCache, repr=False)

    def __len__(self) -> int:
        return len(self.index.items)

    @property
    def n_classes(self) -> int:
        return self.index.n_classes

    def _decode_item(self, i: int) -> np.ndarray:
        src, _ = self.index.items[i]
        if isinstance(src, tuple):
            data = self._tars.member_bytes(*src)
        else:
            with open(src, "rb") as f:
                data = f.read()
        return _decode_u8(data, self.image_size)

    def decode_indices(self, idx: Sequence[int]) -> np.ndarray:
        """The items ``idx`` as normalized float32 NHWC."""
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            imgs = list(pool.map(self._decode_item, idx))
        return _normalize(np.stack(imgs), self.norm)

    def batches(self, batch_size: int, *, epoch: int = 0, seed: int = 0,
                host_id: int = 0, num_hosts: int = 1, shuffle: bool = True,
                drop_last: bool = True):
        """Yield (images, labels) batches of this host's share of the
        epoch (``shard_indices``' order)."""
        labels = self.index.labels()
        idx = shard_indices(len(self), epoch=epoch, seed=seed,
                            host_id=host_id, num_hosts=num_hosts,
                            shuffle=shuffle)
        n_full = len(idx) // batch_size
        stop = n_full * batch_size if drop_last else len(idx)
        pool = ThreadPoolExecutor(max_workers=self.workers)
        try:
            for start in range(0, stop, batch_size):
                chunk = idx[start:start + batch_size]
                imgs = list(pool.map(self._decode_item, chunk))
                yield _normalize(np.stack(imgs), self.norm), labels[chunk]
        finally:
            pool.shutdown(wait=False)

    def materialize(self, max_images: Optional[int], *, seed: int = 0
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """A class-balanced subset of ``max_images`` (all with None)
        decoded into memory: (normalized images, int32 labels)."""
        labels = self.index.labels()
        if max_images is None or max_images >= len(self):
            take = np.arange(len(self))
        else:
            take = _balanced_subset(labels, max_images,
                                    np.random.RandomState(seed))
        return self.decode_indices(take), labels[take]


def _balanced_subset(labels: np.ndarray, n: int,
                     rng: np.random.RandomState) -> np.ndarray:
    """``n`` indices taken round-robin over the classes (each class in a
    random order), so a small cap still covers every class."""
    order = rng.permutation(len(labels))
    by_class: dict = {}
    for i in order:
        by_class.setdefault(int(labels[i]), []).append(i)
    out: List[int] = []
    queues = list(by_class.values())
    while len(out) < n and queues:
        queues = [q for q in queues if q]
        for q in queues:
            if len(out) >= n:
                break
            out.append(q.pop())
    return np.asarray(out, np.int64)


def open_imagenet_stream(data_dir: Optional[str] = None, split: str = "train",
                         *, image_size: int = 224, norm: str = "imagenet",
                         workers: int = 8,
                         wnids: Optional[Sequence[str]] = None
                         ) -> Optional[ImageNetStream]:
    """A streaming view of an on-disk split, or None. Pass the train
    stream's ``index.wnids`` as ``wnids`` for the val split."""
    d = _find_split_dir(data_dir, split)
    index = _index_split(d, wnids=wnids, workers=workers) if d else None
    if index is None:
        return None
    return ImageNetStream(index=index, image_size=image_size, norm=norm,
                          workers=workers)


def synthetic_imagenet(image_shape: Tuple[int, int, int], n_train: int,
                       n_test: int, seed: int, n_classes: int = 1000
                       ) -> Tuple[np.ndarray, ...]:
    """ImageNet-shaped class-conditional uint8 data: an 8x8x3 coarse
    pattern a class, nearest-upsampled, plus pixel noise (memory
    O(samples), not a full-size template a class). Equal to the JAX
    package's for the same arguments."""
    h, w, c = image_shape
    rng = np.random.RandomState(seed)
    coarse = rng.randint(0, 256, size=(n_classes, 8, 8, c), dtype=np.int16)

    def make(n: int):
        labels = rng.randint(0, n_classes, size=n).astype(np.int32)
        t = coarse[labels]
        t = np.repeat(np.repeat(t, -(-h // 8), 1), -(-w // 8), 2)[:, :h, :w]
        noise = rng.randint(-32, 33, size=t.shape, dtype=np.int16)
        return np.clip(t + noise, 0, 255).astype(np.uint8), labels

    tr_x, tr_y = make(n_train)
    te_x, te_y = make(n_test)
    return tr_x, tr_y, te_x, te_y


def load_imagenet(
    data_dir: Optional[str] = None,
    *,
    norm: str = "imagenet",
    image_size: int = 224,
    max_train: Optional[int] = 4096,
    max_test: Optional[int] = 1024,
    synthetic_ok: bool = True,
    synthetic_sizes: Tuple[int, int] = (1024, 256),
    synthetic_classes: int = 1000,
    seed: int = 0,
    workers: int = 8,
) -> ImageClassData:
    """An in-memory ImageNet subset (class-balanced caps on real data; a
    tenth of the train subset held out when there is no val split), or
    ImageNet-shaped synthetic data where no layout is on disk."""
    train = open_imagenet_stream(data_dir, "train", image_size=image_size,
                                 norm=norm, workers=workers)
    if train is not None:
        val = open_imagenet_stream(data_dir, "val", image_size=image_size,
                                   norm=norm, workers=workers,
                                   wnids=train.index.wnids)
        tr_x, tr_y = train.materialize(max_train, seed=seed)
        if val is not None:
            te_x, te_y = val.materialize(max_test, seed=seed)
        else:
            n_hold = max(1, len(tr_y) // 10)
            te_x, te_y = tr_x[:n_hold], tr_y[:n_hold]
            tr_x, tr_y = tr_x[n_hold:], tr_y[n_hold:]
        return ImageClassData(tr_x, tr_y, te_x, te_y, source="imagenet",
                              name="imagenet", n_classes=train.n_classes)
    if not synthetic_ok:
        raise FileNotFoundError(
            "no ImageNet layout (train/<wnid>/ dirs or <wnid>.tar files) "
            f"found under {data_dir or _DEFAULT_DIRS}")
    log.warning("no ImageNet layout found; using synthetic data")
    tr_x, tr_y, te_x, te_y = synthetic_imagenet(
        (image_size, image_size, 3), *synthetic_sizes, seed=seed,
        n_classes=synthetic_classes)
    return ImageClassData(
        _normalize(tr_x, norm), tr_y, _normalize(te_x, norm), te_y,
        source="synthetic", name="imagenet", n_classes=synthetic_classes,
    )
