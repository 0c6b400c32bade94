"""The rank side of ``tests/test_torch_elastic.py``: the elastic
factory and run that ``resilience.run_elastic`` pickles into its gloo
ranks, and the reference runs. Imports only torch and the port (never
JAX)."""

import numpy as np

from distributed_mnist_bnns_tpu_torch.resilience import Preempted


def data():
    from distributed_mnist_bnns_tpu_torch.data.common import ImageClassData

    rng = np.random.RandomState(0)
    return ImageClassData(
        train_images=rng.rand(256, 28, 28, 1).astype(np.float32),
        train_labels=rng.randint(0, 10, 256).astype(np.int32),
        test_images=rng.rand(64, 28, 28, 1).astype(np.float32),
        test_labels=rng.randint(0, 10, 64).astype(np.int32))


def config(**kw):
    from distributed_mnist_bnns_tpu_torch.train import TrainConfig

    cfg = dict(model="bnn-mlp-small",
               model_kwargs={"infl_ratio": 1, "dropout_rate": 0.0},
               backend="xla", optimizer="adam", learning_rate=0.003,
               batch_size=32, epochs=1, seed=0, device="cpu",
               log_interval=1, handle_preemption=False,
               grad_compress="sign_ef", elastic=True)
    cfg.update(kw)
    return TrainConfig(**cfg)


def make_trainer(kw, world):
    """``run_elastic``'s factory: the launch world, or ``world`` ranks
    resuming."""
    from distributed_mnist_bnns_tpu_torch.train import Trainer

    import torch.distributed as dist

    if world is None:
        return Trainer(config(data_parallel=dist.get_world_size(), **kw))
    return Trainer(config(data_parallel=world, resume=True, **kw))


def fit(trainer):
    trainer.fit(data(), eval_every=0)
    return {"step": trainer.step, "world": trainer.world}


def reference_rank(rank, world, device, kw):
    """A fresh trainer of ``world`` ranks over ``kw`` (resuming when the
    directory holds a checkpoint), fitted until done or preempted."""
    from distributed_mnist_bnns_tpu_torch.train import Trainer

    t = Trainer(config(data_parallel=world, resume=True, **kw))
    try:
        t.fit(data(), eval_every=0)
        return {"step": t.step, "preempted": False}
    except Preempted:
        return {"step": t.step, "preempted": True}
