"""The three distributed demos (the JAX package's ``examples/demos.py``):
the reference's tutorial trio in mnist-distributed-BNNS2.py (run by its
__main__, :258-260) on synthetic inputs.

  demo_basic          (ref :216-233)  DDP wrap + one fwd/bwd/step
                      -> the port's data-parallel step over the ranks.
  demo_checkpoint     (ref :152-191)  rank-0 save, barrier, load, train
                      -> ``Trainer.save_checkpoint`` (one writer and a
                      barrier, utils/checkpoint.py), a load back into
                      the trainer, one data-parallel step.
  demo_model_parallel (ref :193-213)  Net(dev0, dev1) layer placement
                      -> the tensor-parallel step over a 'model' axis of
                      2 ranks (with the rest of the world as 'data').

Each demo runs in every rank of a process group (``parallel.spawn``;
gloo on the CPU, or ranks sharing one card), or alone in one process,
and returns the step's loss, the global batch's. ``variables`` (a JAX
model's ``{"params", "batch_stats"}`` as numpy) and ``batch`` ((x, y)
numpy) replace the toy state and batch drawn from ``seed``.

Run: python -m distributed_mnist_bnns_tpu_torch.examples.demos [--world N]
[--device cpu]
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def toy_batch(n: int = 64, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(x (n, 784) normal, y (n,) labels in [0, 10)) from ``seed``."""
    rng = np.random.RandomState(seed + 1)
    return (rng.randn(n, 784).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


def _trainer(seed: int, device, model_kwargs: Optional[Dict[str, Any]],
             **cfg: Any):
    from ..train import TrainConfig, Trainer

    return Trainer(TrainConfig(
        model="bnn-mlp-small", model_kwargs=dict(model_kwargs or {}),
        backend="xla", optimizer="adam", learning_rate=0.01, seed=seed,
        device=device or "cpu", log_interval=1000,
        handle_preemption=False, **cfg))


def _load(trainer, variables: Optional[Dict[str, Any]]) -> None:
    """The JAX variables into the trainer's own state tree (a
    tensor-parallel trainer cuts its shards)."""
    if variables is None:
        return
    from ..interop import train_state_from_jax, train_state_to_jax

    state = _host(train_state_to_jax(trainer))
    state["params"] = variables["params"]
    if variables.get("batch_stats"):
        state["batch_stats"] = variables["batch_stats"]
    train_state_from_jax(state, trainer)


def _host(tree):
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy().copy()
    return tree


def _step(trainer, batch) -> float:
    """One step of the trainer's step on this rank's rows of ``batch``."""
    x, y = batch
    xb = torch.from_numpy(np.ascontiguousarray(trainer._shard(x)))
    yb = torch.from_numpy(np.ascontiguousarray(
        trainer._shard(y)).astype(np.int64))
    loss, _ = trainer.train_step(trainer.model, trainer.optimizer,
                                 xb.to(trainer.device), yb.to(trainer.device))
    return float(loss)


def demo_basic(seed: int = 0, *, variables=None, batch=None, device=None,
               model_kwargs=None) -> float:
    """One data-parallel train step on synthetic data (ref demo_basic)."""
    trainer = _trainer(seed, device, model_kwargs, data_parallel=_world())
    _load(trainer, variables)
    loss = _step(trainer, batch or toy_batch(seed=seed))
    log.info("demo_basic: loss=%.4f over %d ranks", loss, _world())
    return loss


def demo_checkpoint(ckpt_dir: Optional[str] = None, seed: int = 0, *,
                    variables=None, batch=None, device=None,
                    model_kwargs=None) -> float:
    """Save (one writer and a barrier), restore, then train a step: the
    DDP-correct checkpoint pattern (ref demo_checkpoint). Every rank
    gets ``ckpt_dir`` (None: rank 0's temporary directory)."""
    from ..interop import train_state_from_jax, train_state_to_jax
    from ..utils.checkpoint import load_checkpoint

    trainer = _trainer(seed, device, model_kwargs, data_parallel=_world())
    _load(trainer, variables)
    with tempfile.TemporaryDirectory() as tmp:
        path = ckpt_dir or tmp
        if ckpt_dir is None and dist.is_initialized():
            box = [tmp]
            dist.broadcast_object_list(box, src=0)
            path = box[0]
        ck = os.path.join(path, "ck")
        trainer.save_checkpoint(ck, epoch=0)
        restored = load_checkpoint(
            train_state_to_jax(trainer, values=False), ck)
        train_state_from_jax(_host(restored), trainer)
        loss = _step(trainer, batch or toy_batch(seed=seed))
        if dist.is_initialized():
            dist.barrier()   # rank 0's directory outlives every read
    log.info("demo_checkpoint: post-restore loss=%.4f", loss)
    return loss


def demo_model_parallel(seed: int = 0, *, variables=None, batch=None,
                        device=None, model_kwargs=None) -> float:
    """A train step with the parameters sharded over a 'model' axis of 2
    ranks (the declarative Net(dev0, dev1); ref demo_model_parallel).
    One rank, or an odd world, runs the step unsharded, as JAX's demo
    does on one device."""
    world = _world()
    model_par = 2 if world % 2 == 0 else 1
    cfg: Dict[str, Any] = {}
    if model_par > 1:
        cfg = dict(tensor_parallel=model_par,
                   data_parallel=world // model_par)
    elif world > 1:
        cfg = dict(data_parallel=world)
    trainer = _trainer(seed, device, model_kwargs, **cfg)
    _load(trainer, variables)
    loss = _step(trainer, batch or toy_batch(32, seed=seed))
    log.info("demo_model_parallel: loss=%.4f (model %d x data %d)", loss,
             model_par, world // model_par)
    return loss


def run_all(rank: int = 0, world: int = 1, device=None, seed: int = 0,
            variables=None, batches=None,
            model_kwargs=None) -> Dict[str, float]:
    """The three demos in one rank (a ``parallel.spawn`` target):
    {name: loss}. ``batches``: (the basic and checkpoint demos' batch,
    the model-parallel demo's)."""
    b64, b32 = batches or (None, None)
    kw = dict(seed=seed, variables=variables, device=device,
              model_kwargs=model_kwargs)
    return {"demo_basic": demo_basic(batch=b64, **kw),
            "demo_checkpoint": demo_checkpoint(batch=b64, **kw),
            "demo_model_parallel": demo_model_parallel(batch=b32, **kw)}


def main(argv=None) -> Dict[str, float]:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--world", type=int, default=2,
                   help="gloo ranks (parallel.spawn)")
    p.add_argument("--device", default="cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from ..parallel import spawn

    losses = spawn(run_all, args.world, backend="gloo",
                   device=args.device)[0]
    print(losses)
    return losses


if __name__ == "__main__":
    main()
