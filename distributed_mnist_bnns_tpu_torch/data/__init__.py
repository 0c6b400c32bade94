from .cifar import CIFAR10_MEAN, CIFAR10_STD, load_cifar10
from .common import ImageClassData, normalize_u8, synthetic_blobs
from .imagenet import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ImageNetStream,
    load_imagenet,
    open_imagenet_stream,
)
from .mnist import (
    MNIST_MEAN,
    MNIST_STD,
    batch_iterator,
    load_idx,
    load_mnist,
    native_batch_iterator,
    shard_indices,
)

#: each dataset's own ``--norm`` statistics
DATASET_NORM = {"mnist": "mnist", "cifar10": "cifar", "cifar": "cifar",
                "imagenet": "imagenet"}


def load_dataset(name: str, data_dir=None, **kwargs) -> ImageClassData:
    """The dataset ``name`` ("mnist" | "cifar10" | "cifar" |
    "imagenet") through its loader, as the JAX ``load_dataset``."""
    if name == "mnist":
        return load_mnist(data_dir, **kwargs)
    if name in ("cifar10", "cifar"):
        return load_cifar10(data_dir, **kwargs)
    if name == "imagenet":
        return load_imagenet(data_dir, **kwargs)
    raise ValueError(
        f"unknown dataset {name!r} (have: mnist, cifar10, imagenet)")


__all__ = [
    "CIFAR10_MEAN",
    "CIFAR10_STD",
    "DATASET_NORM",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "ImageClassData",
    "ImageNetStream",
    "MNIST_MEAN",
    "MNIST_STD",
    "batch_iterator",
    "load_cifar10",
    "load_dataset",
    "load_idx",
    "load_imagenet",
    "load_mnist",
    "native_batch_iterator",
    "normalize_u8",
    "open_imagenet_stream",
    "shard_indices",
    "synthetic_blobs",
]
