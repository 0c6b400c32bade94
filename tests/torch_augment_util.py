"""The rank side of ``tests/test_torch_augment.py``'s data-parallel
cases: run in gloo ranks on the CPU by ``parallel.spawn``; imports only
torch, numpy and the port (never JAX)."""

import numpy as np
import torch
import torch.distributed as dist

from distributed_mnist_bnns_tpu_torch.data import ImageClassData
from distributed_mnist_bnns_tpu_torch.models import get_model
from distributed_mnist_bnns_tpu_torch.parallel import rank_seed, shard_batch
from distributed_mnist_bnns_tpu_torch.train import TrainConfig, Trainer
from distributed_mnist_bnns_tpu_torch.train.trainer import augment_batch

MODEL_KW = {"stem_features": 4}


def augment_rank(rank, world, device, images, labels, seed):
    """This rank's crops of its rows of ``images``: drawn over the global
    batch from one shared seed (the GSPMD step's), and from the rank's own
    generator (the compressed steps'); then, for each exchange, the
    trainer's own choice of generator and one augmented step."""
    group = dist.group.WORLD
    local = shard_batch(torch.from_numpy(images), group)
    model = get_model("xnor-resnet18", rng_seed=rank_seed(seed, rank),
                      **MODEL_KW)
    per_shard = augment_batch(model, local)
    model.augment_seed = seed
    global_ = augment_batch(model, local, group=group)
    out = {"global": global_.numpy(), "per_shard": per_shard.numpy()}
    data = ImageClassData(images, labels, images, labels)
    for gc in ("none", "sign_ef"):
        t = Trainer(TrainConfig(
            model="xnor-resnet18", model_kwargs=dict(MODEL_KW),
            batch_size=len(images), epochs=1, optimizer="sgd",
            learning_rate=0.01, seed=seed - 1, backend="xla",
            augment=True, data_parallel=world, grad_compress=gc,
            compress_bucket_size=256, device="cpu", log_interval=1),
            input_shape=images.shape[1:])
        row = t.train_epoch(data, 0)
        out[gc] = {"augment_seed": t.model.augment_seed,
                   "rng_seed": t.model.rng_seed,
                   "loss": row["train_loss"]}
    return out
