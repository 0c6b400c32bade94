"""The MLP trainer: the STE latent-clamp step, eval, the epoch loop,
learning-rate schedules and checkpoints.

Counterpart of the JAX package's ``train/trainer.py`` for one process on
one device (``make_step_body``, ``make_eval_step``, ``TrainConfig``,
``Trainer``). The reference's BNN "STE dance" (restore the fp32 latents,
step the optimizer, clamp them to [-1, 1]) is, as there: gradients of
the fp32 latents through the models' straight-through binarize, the
optimizer's update on the latents, then ``clamp_latent`` on the
binarized layers' weights and biases.

Kept from the JAX trainer: the data order (numpy's ``RandomState(seed +
epoch)`` permutation, ``data.batch_iterator``, whole batches only), the
per-epoch learning rate (regime base, linear warmup, then the x0.1 every
``lr_decay_epochs`` step decay or cosine annealing), sticky regimes (an
optimizer class switch rebuilds the optimizer with fresh moments; other
hyperparameters are retuned in place; the learning rate is written
last), host syncs only at ``log_interval`` (the train loss and accuracy
of an epoch average the logged steps), and the eval sums ``loss_sum``,
``correct1``, ``correct5`` and ``count``, top-1 taken as JAX's
``argsort(...)[:, ::-1]`` takes it (the last of tied maxima; the train
step's accuracy takes the first, as ``jnp.argmax`` does).

Randomness is explicit: the weights come from ``torch.Generator()
.manual_seed(seed)``, the dropout masks and stochastic signs from the
model's own generator on the trainer's device (seeded with ``seed + 1``,
a stream apart from the init's), the data order from numpy.

The device goes through ``infer.resolve_device``: "cuda" unless the
caller asks for the CPU, and no card raises. The step's fp32 products
(the first layer on "xla", the head, the backward pair) are fp32
products under PyTorch's default ``allow_tf32 = False``, which the
trainer leaves as it finds it.

Checkpoints are the port's own: ``torch.save`` of the model's and the
optimizer's state dicts with the epoch, step and best accuracy, as
``latest.pt`` after every epoch and ``best.pt`` when the test accuracy
improves, readable with ``torch.load(..., weights_only=True)``.

Data parallelism (``data_parallel``, the JAX ``_setup_grad_compress``
and ``_setup_data_parallel``): the trainer runs in every rank of a
``torch.distributed`` process group (``parallel.spawn``, ``cli train
--dp``), each rank on its rows of the same global batch. Uncompressed,
it is the JAX GSPMD step (global-batch BatchNorm, DDP); with
``grad_compress`` the optimizer carries the 1-bit exchange
(``train.optim.SignCompress``), flat or, with ``dp_hosts``, after an
fp32 in-host mean. Rank 0 logs and writes checkpoints; the error
feedback rows of every rank are gathered into them in JAX's ``(world,
padded)`` / ``(world, seg)`` layout (``(hosts, ...)`` when
hierarchical) and handed back by ``restore`` at the same world.
``evaluate`` runs on rank 0 and its result is broadcast. Each rank's
dropout generator is seeded from ``(seed + 1, rank)``.
"""

from __future__ import annotations

import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data import batch_iterator
from ..infer import resolve_device
from ..models import get_model, latent_clamp_mask
from ..ops.comm_compress import (
    WireBytes,
    all_gather,
    all_reduce_sum,
    broadcast,
    make_hier_plan,
    make_plan,
    tree_size,
)
from ..ops.losses import Loss, cross_entropy_loss, make_loss
from .optim import (
    RegimeSchedule,
    SignCompress,
    make_optimizer,
    regime_hp_kwargs,
)

log = logging.getLogger(__name__)

LATEST, BEST = "latest.pt", "best.pt"


def clamp_latent(params: Iterable[torch.Tensor]) -> None:
    """Clamp binarized-layer latents to [-1, 1] (mnist-dist2.py:135-137),
    e.g. ``clamp_latent(latent_clamp_mask(model).values())``.

    The JAX version is pure and returns new params; the port clamps the
    given tensors in place, under ``torch.no_grad()``."""
    with torch.no_grad():
        for p in params:
            p.clamp_(-1.0, 1.0)


def make_step_body(clamp_mask: Dict[str, torch.Tensor], *,
                   loss_fn: Callable = cross_entropy_loss) -> Callable:
    """The train step: forward in train mode -> loss -> backward ->
    optimizer step -> ``clamp_latent`` on ``clamp_mask``'s tensors
    (``models.latent_clamp_mask``).

    ``step(model, optimizer, images, labels) -> (loss, accuracy)``, both
    0-d tensors on the model's device (accuracy in percent): nothing
    syncs with the host."""
    latents = list(clamp_mask.values())

    def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   images: torch.Tensor, labels: torch.Tensor):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        outs = model(images)
        loss = loss_fn(outs, labels)
        loss.backward()
        optimizer.step()
        clamp_latent(latents)
        outs = outs.detach()
        acc = (outs.argmax(-1) == labels).to(outs.dtype).mean() * 100.0
        return loss.detach(), acc

    return train_step


def make_eval_step(loss_fn: Loss) -> Callable:
    """The eval step: ``eval_step(model, images, labels, valid=None) ->
    {"loss_sum", "correct1", "correct5", "count"}`` as 0-d tensors, in
    eval mode, summed over the rows ``valid`` marks (all by default), so
    batches add up exactly."""

    def eval_step(model: torch.nn.Module, images: torch.Tensor,
                  labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None):
        model.eval()
        with torch.no_grad():
            outs = model(images)
            if valid is None:
                valid = torch.ones_like(labels, dtype=torch.bool)
            per_example = loss_fn.per_example(outs, labels)
            order = torch.argsort(outs, dim=-1, stable=True).flip(-1)
            top5 = order[:, :5]
            hit5 = (top5 == labels[:, None]).any(-1)
            return {
                "loss_sum": (per_example * valid.to(per_example.dtype)).sum(),
                "correct1": ((top5[:, 0] == labels) & valid).sum(),
                "correct5": (hit5 & valid).sum(),
                "count": valid.sum(),
            }

    return eval_step


@dataclass
class TrainConfig:
    """The training run: the JAX ``TrainConfig``'s fields that the port
    implements, with their defaults, and ``device``."""

    model: str = "bnn-mlp-large"
    model_kwargs: Dict[str, Any] = field(default_factory=dict)
    epochs: int = 5
    batch_size: int = 64
    optimizer: str = "adam"
    learning_rate: float = 0.01
    lr_decay_epochs: int = 40      # x0.1 every N epochs (mnist-dist2.py:126)
    lr_decay_factor: float = 0.1
    lr_schedule: str = "step"      # "step" | "cosine"
    warmup_epochs: int = 0         # linear warmup before either schedule
    regime: Optional[Dict[int, Dict[str, Any]]] = None
    clip_grad_norm: Optional[float] = None  # global-norm clipping
    seed: int = 42
    log_interval: int = 100
    loss: str = "ce"
    label_smoothing: float = 0.0   # ce only
    backend: Optional[str] = None  # GEMM backend of the binarized layers
                                   # (None: "bf16")
    checkpoint_dir: Optional[str] = None
    device: Optional[str] = None   # None: "cuda" (raises without a card)
    data_parallel: Optional[object] = None  # None | "auto" | int ranks
    dp_mode: str = "gspmd"         # "gspmd" (replicated state); "fsdp"
                                   # is not ported
    grad_compress: str = "none"    # 1-bit gradient exchange: "sign"
                                   # (majority-vote signSGD) | "sign_ef"
                                   # (error feedback, residuals in the
                                   # optimizer state)
    compress_bucket_size: int = 1024  # elements per fp32 scale bucket
                                   # (multiple of 32)
    compress_chunks: int = 4       # groups of buckets; they only split
                                   # the (blocking) collective calls
    dp_hosts: Optional[int] = None  # >1: two-level exchange, the world
                                   # as (hosts x local): fp32 mean in a
                                   # host, 1-bit across hosts. Requires
                                   # grad_compress != none


class Trainer:
    """One model and one optimizer on one device; with
    ``data_parallel``, one rank of the process group."""

    def __init__(self, config: TrainConfig):
        self.config = config
        if config.dp_mode not in ("gspmd", "fsdp"):
            raise ValueError(f"unknown dp_mode {config.dp_mode!r} "
                             "(have: gspmd, fsdp)")
        if config.dp_mode == "fsdp":
            raise NotImplementedError(
                "dp_mode='fsdp' is not ported yet (ROADMAP.md queue 1 "
                "item 3: parallel/fsdp.py, sign_compress_fsdp)")
        self.device = resolve_device(config.device)
        self.world, self.rank = self._resolve_world()
        mk = dict(config.model_kwargs)
        mk.setdefault("backend", config.backend or "bf16")
        if self.world > 1:
            from ..parallel import rank_seed

            mk.setdefault("rng_seed", rank_seed(config.seed + 1, self.rank))
        mk.setdefault("rng_seed", config.seed + 1)
        self.model = get_model(
            config.model, generator=torch.Generator().manual_seed(config.seed),
            **mk,
        ).to(self.device)
        self.clamp_mask = latent_clamp_mask(self.model)
        self.regime = RegimeSchedule(config.regime)
        self.wire = WireBytes()   # bytes this rank's collectives moved
        self._setup_grad_compress()
        self._setup_data_parallel()
        self.optimizer_name = config.optimizer
        self.optimizer = self._build_tx(config.optimizer,
                                        config.learning_rate)
        self._loss_fn = make_loss(
            config.loss, num_classes=self.model.num_classes,
            label_smoothing=config.label_smoothing,
        )
        self.train_step = self._make_train_step()
        self.eval_step = make_eval_step(self._loss_fn)
        self.step = 0
        self.epoch = 0
        self.best_acc = 0.0
        self.loss_history: List[float] = []  # every synced (logged) loss

    def _resolve_world(self):
        """(world, rank): the process group's when ``data_parallel`` is
        set in a rank of one; 1 rank otherwise."""
        dp = self.config.data_parallel
        if not dp:
            return 1, 0
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if dp != "auto" and int(dp) != world:
                raise ValueError(f"data_parallel={dp}, but the process "
                                 f"group holds {world} ranks")
            return world, dist.get_rank()
        n = ((torch.cuda.device_count() if self.device.type == "cuda" else 1)
             if dp == "auto" else int(dp))
        if n > 1:
            raise ValueError(
                f"data_parallel={dp} needs {n} ranks: build the trainer in "
                "every rank of parallel.spawn (cli train --dp does)")
        return 1, 0

    def _setup_grad_compress(self) -> None:
        """The 1-bit exchange's plan and groups (JAX
        ``_setup_grad_compress``); the exchange itself lives in the
        optimizer (``_build_tx``)."""
        cfg = self.config
        self.comm_plan = None
        self.hier_plan = None
        self._compress_group = None
        self._local_group = None
        self._ef_row = 0      # this rank's row of the checkpointed EF
        if cfg.grad_compress == "none":
            if cfg.dp_hosts:
                raise ValueError(
                    "dp_hosts (hierarchical exchange) requires "
                    "grad_compress='sign' or 'sign_ef': the two-level "
                    "topology exists to put the 1-bit phase on the "
                    "inter-host link")
            return
        if cfg.grad_compress not in ("sign", "sign_ef"):
            raise ValueError(f"unknown grad_compress {cfg.grad_compress!r} "
                             "(have: none, sign, sign_ef)")
        world = self.world
        n_params = tree_size(self.model.parameters())
        if world <= 1:
            log.warning(
                "grad_compress=%r with data_parallel<=1: gradients are "
                "sign-quantized locally but there is no exchange to "
                "compress (pass --dp auto for the wire savings)",
                cfg.grad_compress)
        if cfg.dp_hosts:
            from ..parallel import make_groups

            hosts = int(cfg.dp_hosts)
            if hosts < 1 or world % hosts:
                raise ValueError(f"dp_hosts={hosts} must divide the DP "
                                 f"world ({world} devices)")
            if hosts == 1 and world > 1:
                raise ValueError(
                    "dp_hosts=1 with data_parallel>1 has no inter-host "
                    "axis to compress over: drop dp_hosts for the flat "
                    "exchange")
            self.hier_plan = make_hier_plan(
                n_params, hosts=hosts, local=world // hosts,
                mode=cfg.grad_compress, bucket_size=cfg.compress_bucket_size,
                chunks=cfg.compress_chunks)
            self.comm_plan = self.hier_plan.inter
            if world > 1:
                groups = make_groups(hosts)
                self._compress_group = groups.inter
                self._local_group = groups.local
                self._ef_row = groups.host
            return
        self.comm_plan = make_plan(
            n_params, world=world, mode=cfg.grad_compress,
            bucket_size=cfg.compress_bucket_size, chunks=cfg.compress_chunks)
        if world > 1:
            self._compress_group = dist.group.WORLD
            self._ef_row = self.rank

    def _setup_data_parallel(self) -> None:
        """Check the global batch, make sure every rank starts from the
        same state, and size the fp32 plan of an uncompressed run (JAX
        ``_setup_data_parallel``)."""
        cfg = self.config
        if self.world <= 1:
            return
        from ..parallel import replicate

        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible "
                             f"by data_parallel={self.world}")
        replicate(self.model)
        if cfg.grad_compress == "none":
            self.comm_plan = make_plan(
                tree_size(self.model.parameters()), world=self.world,
                mode="fp32", bucket_size=cfg.compress_bucket_size)
        if self.rank == 0:
            log.info("data-parallel (%s%s) over %d ranks", cfg.dp_mode,
                     f", grad_compress={cfg.grad_compress}"
                     if cfg.grad_compress != "none" else "", self.world)

    def _make_train_step(self) -> Callable:
        if self.world <= 1:
            return make_step_body(self.clamp_mask, loss_fn=self._loss_fn)
        from ..parallel import (
            make_compressed_dp_train_step,
            make_compressed_hier_train_step,
            make_dp_train_step,
        )

        if self.config.grad_compress == "none":
            return make_dp_train_step(self.clamp_mask, self.model,
                                      loss_fn=self._loss_fn, wire=self.wire)
        if self.hier_plan is not None:
            return make_compressed_hier_train_step(self.clamp_mask,
                                                   loss_fn=self._loss_fn)
        return make_compressed_dp_train_step(self.clamp_mask,
                                             loss_fn=self._loss_fn)

    def _build_tx(self, name: str, learning_rate: float, **kwargs: Any):
        """make_optimizer with this run's 1-bit exchange chained in: the
        one constructor of ``__init__`` and of a regime's optimizer
        switch, which so keeps the exchange (with fresh error feedback,
        as fresh moments)."""
        transform = None
        if self.config.grad_compress != "none":
            from ..interop import JaxFlatOrder

            plan = self.comm_plan
            transform = SignCompress(
                mode=plan.mode, order=JaxFlatOrder(self.model),
                world=plan.world, group=self._compress_group,
                local_group=self._local_group,
                bucket_size=plan.bucket_size, chunks=plan.chunks,
                wire=self.wire)
        return make_optimizer(name, self.model.parameters(), learning_rate,
                              clip_grad_norm=self.config.clip_grad_norm,
                              grad_transform=transform, **kwargs)

    def comm_bytes(self, phase: Optional[str] = None,
                   level: Optional[str] = None) -> int:
        """Bytes this rank's gradient exchange put on the wire so far, as
        its collectives measured them: ``phase`` "rs" or "ag" (None:
        both); in a hierarchical run ``level`` "intra" (the in-host fp32
        all-reduce) or "inter" (the 1-bit exchange; None: both)."""
        return self.wire.bytes(phase=phase, level=level)

    def _lr_for_epoch(self, epoch: int) -> float:
        """Epoch learning rate: regime base -> optional linear warmup ->
        "step" decay (x factor every ``lr_decay_epochs``, per epoch) or
        cosine annealing to 0 over the configured epochs."""
        cfg = self.config
        base = self.regime.config_at(epoch).get(
            "learning_rate", cfg.learning_rate)
        if epoch < cfg.warmup_epochs:
            return base * (epoch + 1) / (cfg.warmup_epochs + 1)
        if cfg.lr_schedule == "cosine":
            span = max(cfg.epochs - cfg.warmup_epochs, 1)
            t = min((epoch - cfg.warmup_epochs) / span, 1.0)
            return base * 0.5 * (1.0 + float(np.cos(np.pi * t)))
        if cfg.lr_schedule != "step":
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} "
                             "(have: step, cosine)")
        decays = epoch // max(cfg.lr_decay_epochs, 1)
        return base * (cfg.lr_decay_factor ** decays)

    def _apply_epoch_regime(self, epoch: int) -> None:
        """An optimizer class switch rebuilds it with fresh state and the
        regime's hyperparameters; then the regime's hyperparameters are
        written in place, the learning rate last."""
        cfg = self.regime.config_at(epoch)
        if self.regime.optimizer_changed(epoch):
            name = cfg["optimizer"]
            self.optimizer = self._build_tx(
                name, cfg.get("learning_rate", self.config.learning_rate),
                **regime_hp_kwargs(name, cfg),
            )
            self.optimizer_name = name
        self.regime.apply_hyperparams(self.optimizer, epoch)
        lr = self._lr_for_epoch(epoch)
        for group in self.optimizer.param_groups:
            group["learning_rate"] = lr

    def _to_device(self, images: np.ndarray, labels: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        y = torch.from_numpy(np.asarray(labels).astype(np.int64))
        if self.device.type == "cuda":
            x, y = x.pin_memory(), y.pin_memory()
        return (x.to(self.device, non_blocking=True),
                y.to(self.device, non_blocking=True))

    def train_epoch(self, data, epoch: int) -> Dict[str, float]:
        """One epoch over ``data.train_images`` in the seeded order of
        ``batch_iterator``. Returns the mean of the logged steps' loss
        and accuracy, the epoch's time and the mean time per batch."""
        cfg = self.config
        self._apply_epoch_regime(epoch)
        self.epoch = epoch
        from ..parallel import shard_batch   # parallel imports this module

        every = max(cfg.log_interval, 1)
        losses, accs = [], []
        t_epoch = time.perf_counter()
        seen = 0
        for images, labels in batch_iterator(
            data.train_images, data.train_labels, cfg.batch_size,
            epoch=epoch, seed=cfg.seed,
        ):
            if self.world > 1:
                images, labels = shard_batch(images), shard_batch(labels)
            x, y = self._to_device(images, labels)
            loss, acc = self.train_step(self.model, self.optimizer, x, y)
            seen += 1
            self.step += 1
            if seen == 1 or seen % every == 0:
                loss_f, acc_f = float(loss), float(acc)   # host sync
                losses.append(loss_f)
                accs.append(acc_f)
                self.loss_history.append(loss_f)
                if self.rank == 0:
                    log.info("epoch %d step %d loss %.4f acc %.2f%%", epoch,
                             seen, loss_f, acc_f)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        epoch_time = time.perf_counter() - t_epoch
        return {
            "train_loss": float(np.mean(losses)) if losses else math.nan,
            "train_acc": float(np.mean(accs)) if accs else math.nan,
            "epoch_time_s": epoch_time,
            "batch_time_s": epoch_time / max(seen, 1),
            "steps": seen,
        }

    def evaluate(self, data,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        """``test_loss``, ``test_acc`` and ``test_acc_top5`` (percent) over
        ``data.test_images``, every row counted once; one host sync. In
        a data-parallel run rank 0 evaluates and broadcasts the result."""
        if self.world <= 1:
            return self._evaluate(data, batch_size)
        keys = ("test_loss", "test_acc", "test_acc_top5")
        vals = torch.zeros(len(keys), dtype=torch.float64, device=self.device)
        if self.rank == 0:
            res = self._evaluate(data, batch_size)
            vals = torch.tensor([res[k] for k in keys], dtype=torch.float64,
                                device=self.device)
        vals = broadcast(vals).tolist()
        return dict(zip(keys, vals))

    def _evaluate(self, data,
                  batch_size: Optional[int] = None) -> Dict[str, float]:
        bs = batch_size or self.config.batch_size
        totals: Dict[str, torch.Tensor] = {}
        for images, labels in batch_iterator(
            data.test_images, data.test_labels, bs, shuffle=False,
            drop_last=False,
        ):
            x, y = self._to_device(images, labels)
            out = self.eval_step(self.model, x, y)
            for k, v in out.items():
                v = v.to(torch.float64)
                totals[k] = v if k not in totals else totals[k] + v
        t = {k: float(v) for k, v in totals.items()}
        n = max(t.get("count", 0.0), 1.0)
        return {
            "test_loss": t.get("loss_sum", 0.0) / n,
            "test_acc": t.get("correct1", 0.0) / n * 100.0,
            "test_acc_top5": t.get("correct5", 0.0) / n * 100.0,
        }

    def fit(self, data, eval_every: int = 1) -> List[Dict[str, float]]:
        """``config.epochs`` epochs, each evaluated when ``eval_every``
        divides its number (0: never), ``best_acc`` kept, and
        checkpointed when ``checkpoint_dir`` is set. Returns one row per
        epoch."""
        history = []
        for epoch in range(self.config.epochs):
            row: Dict[str, float] = {"epoch": epoch}
            row.update(self.train_epoch(data, epoch))
            if eval_every and (epoch + 1) % eval_every == 0:
                row.update(self.evaluate(data))
            history.append(row)
            acc = row.get("test_acc", 0.0)
            is_best = acc > self.best_acc
            self.best_acc = max(self.best_acc, acc)
            if self.config.checkpoint_dir:
                self.save_checkpoint(self.config.checkpoint_dir,
                                     is_best=is_best)
            if self.rank == 0:
                log.info("epoch %d done: %s", epoch,
                         {k: round(v, 4) for k, v in row.items()
                          if k != "epoch"})
        return history

    def _optimizer_state(self) -> Dict[str, Any]:
        """The optimizer's state dict with the error feedback of every
        rank as JAX lays it out, one row per worker (per host when
        hierarchical); collective in a data-parallel run."""
        sd = self.optimizer.state_dict()
        rows = sd.get("grad_transform")
        if rows:
            if self.world > 1:
                local = self.hier_plan.local if self.hier_plan else 1
                rows = {k: all_gather(v, dist.group.WORLD)[::local]
                        for k, v in rows.items()}
            else:
                rows = {k: v[None] for k, v in rows.items()}
            sd["grad_transform"] = rows
        return sd

    def save_checkpoint(self, ckpt_dir: str, *, is_best: bool = False) -> str:
        """Write ``latest.pt`` (and ``best.pt`` when ``is_best``) under
        ``ckpt_dir``; returns the latest path. In a data-parallel run
        every rank calls it and rank 0 writes."""
        payload = {
            "model": self.config.model,
            "state_dict": self.model.state_dict(),
            "optimizer_name": self.optimizer_name,
            "optimizer": self._optimizer_state(),
            "epoch": self.epoch,
            "step": self.step,
            "best_acc": self.best_acc,
        }
        paths = [os.path.join(ckpt_dir, LATEST)]
        if is_best:
            paths.append(os.path.join(ckpt_dir, BEST))
        if self.rank == 0:
            os.makedirs(ckpt_dir, exist_ok=True)
            for path in paths:
                tmp = path + ".tmp"
                torch.save(payload, tmp)
                os.replace(tmp, path)
        if self.world > 1:   # no rank reads before rank 0 has written
            all_reduce_sum(torch.zeros(1, device=self.device),
                           dist.group.WORLD)
        return paths[0]

    def restore(self, ckpt_dir: str, *, best: bool = False) -> Dict[str, Any]:
        """Load ``latest.pt`` (or ``best.pt``) into the model and, when the
        optimizer class matches, the optimizer; returns the payload."""
        payload = load_checkpoint(ckpt_dir, best=best,
                                  model=self.config.model)
        self.model.load_state_dict(payload["state_dict"])
        if payload["optimizer_name"] == self.optimizer_name:
            opt = dict(payload["optimizer"])
            rows = opt.get("grad_transform")
            if rows:
                world = self.comm_plan.world
                got = {tuple(v.shape)[0] for v in rows.values()}
                if got != {world}:
                    raise ValueError(
                        f"the checkpoint's error feedback holds {got} rows, "
                        f"this run exchanges over {world} workers")
                opt["grad_transform"] = {k: v[self._ef_row]
                                         for k, v in rows.items()}
            self.optimizer.load_state_dict(opt)
        self.epoch, self.step = payload["epoch"], payload["step"]
        self.best_acc = payload["best_acc"]
        return payload


def load_checkpoint(ckpt_dir: str, *, best: bool = False,
                    model: Optional[str] = None) -> Dict[str, Any]:
    """The ``latest.pt`` (``best``: ``best.pt``) checkpoint under
    ``ckpt_dir`` that ``Trainer.save_checkpoint`` wrote, on the CPU;
    with ``model``, it must hold that model."""
    path = os.path.join(ckpt_dir, BEST if best else LATEST)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if model is not None and payload["model"] != model:
        raise ValueError(f"{path} holds a {payload['model']!r}, not a "
                         f"{model!r}")
    return payload
