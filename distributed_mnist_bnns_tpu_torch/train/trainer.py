"""The trainer of the MLP and conv families: the STE latent-clamp step,
eval, the epoch loop, learning-rate schedules and checkpoints.

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
.manual_seed(seed)``, the dropout masks, stochastic signs and
``augment``'s crops and flips (``ops.augment``, before the forward) from
the model's own generator on the trainer's device (seeded with ``seed +
1``, a stream apart from the init's), the data order from numpy.
``fit_stream`` trains on a streaming dataset (``data.ImageNetStream``)
in the same seeded order.

The device goes through ``infer.resolve_device``: "cuda" unless the
caller asks for the CPU, and no card raises. The step's fp32 products
(the first layer on "xla", the head, the backward pair) are fp32
products under PyTorch's default ``allow_tf32 = False``, which the
trainer leaves as it finds it; the convs choose their own flags, fp32
without TF32 and deterministic, forward and backward
(``ops.xnor_gemm.conv_precision``).

``precision="bf16"`` is the JAX trainer's (the reference's Apex O2,
``mnist-mixed.py:70``): ``dtype=torch.bfloat16`` for the models that
take a dtype (the conv families' convs and BatchNorms in bf16 over fp32
parameters, the heads fp32); a model that takes no dtype (the binarized
ones, whose products are bf16 already on the default backend, and
``fp32-mlp-large``) is built without it, as the JAX ``_build_model``
drops a knob the constructor rejects.

Checkpoints are the JAX package's (``utils.checkpoint``): the msgpack of
the flax ``TrainState`` state dict (``interop.train_state_to_jax``:
step, params, batch stats, optax's optimizer state) with a sha256 digest
and a generation ledger in ``checkpoint_meta.json``, written after every
epoch (``model_best.msgpack`` when the test accuracy improves,
``checkpoint_epoch_<N>.msgpack`` with ``save_all_epochs``), from a host
copy on a thread with ``async_checkpoint``. A JAX checkpoint resumes here
and a port checkpoint in the JAX ``Trainer``. The meta also holds the
best accuracy, the world size and, under ``torch_rng_state``, every
rank's train-time generator (dropout masks, stochastic signs), so that a
resumed run draws what the uninterrupted one would have; a JAX meta's
``rng_key`` is a JAX PRNG key and is not read.

Resume and graceful stop (the JAX ``try_resume`` and ``_graceful_stop``):
with ``resume`` the newest verified generation is restored (rolling back
past corrupt ones; when all are corrupt the run starts fresh, with a
logged error), and the run continues at the meta's position: inside an
epoch (``epoch_in_progress``, ``batch_in_epoch``: the first batches of
the seeded order are skipped) or at the next one. With
``handle_preemption`` SIGTERM and SIGINT set ``stop``; the loop checks
it before each dispatch, writes a mid-epoch checkpoint and raises
``resilience.Preempted`` (``cli train`` exits 75). In a data-parallel
run each rank is a process of its own (the JAX package's multi-process
case, not its one-process mesh), and a signal may reach one rank only:
a rank stopping alone would leave the others waiting in the next
collective. So there the stop waits for the epoch boundary, where one
all-reduce of the flag (a tensor on the rank's device) decides for all,
and the per-epoch checkpoint is the resume point. A stop at the last
epoch's boundary finishes the run instead.

Dispatch (the JAX ``scan_steps`` and ``device_data``, ``train.capture``):
with ``scan_steps = S > 1`` the epoch's batches go S at a time through
``make_train_scan``, on a card one CUDA graph of S steps captured once
and replayed (the epoch's leftover batches one step a dispatch); the
host keeps the step count, the optimizer's counters, the log cadence and
the stop poll, each advanced by S a dispatch, and each dispatch's time
is spread over its steps. With ``device_data`` the dataset is uploaded
once, each epoch gathers its rows on the device and runs as replays of
S (or ``DEVICE_DATA_CHUNK``) steps with one host sync, and evaluation
sums float32 totals on the device; a resumed part of an epoch streams,
and a stop waits for the epoch boundary. Every mode is bitwise the
per-step path. ``grad_accum`` and ``remat`` are the JAX step body's
(``forward_backward``), which also adds every auxiliary loss the model
recorded (the MoE's load-balancing term) to the loss it logs. All four run under data parallelism too: the
data-parallel step is captured with its collectives (NCCL) inside the
graph, and ``device_data`` gives each rank its columns of the epoch's
index matrix (FSDP over more than one rank streams, as JAX's does).

Timing (``timing_csv_prefix``): each batch's host dispatch time, with no
per-batch sync (a sync per step would slow a host-bound step), and each
epoch's time, which ends in ``torch.cuda.synchronize``, as
``<prefix>_batch_time.csv`` and ``<prefix>_epoch_time.csv``
(mnist-dist2.py:112-115,139-155). ``results_path``: one ``ResultsLog``
row per epoch, as a CSV and an HTML plot.

Data parallelism (``data_parallel``, the JAX ``_setup_grad_compress``
and ``_setup_data_parallel``): the trainer runs in every rank of a
``torch.distributed`` process group (``parallel.spawn``, ``cli train
--dp``; world 1 included), each rank on its rows of the same global
batch. Uncompressed, it is the JAX GSPMD step (global-batch BatchNorm,
the gradients averaged in DDP's order); with ``grad_compress`` the
optimizer carries the 1-bit exchange (``train.optim.SignCompress``),
flat or, with ``dp_hosts``, after an fp32 in-host mean. ``dp_mode=
"fsdp"`` shards the parameters and the optimizer state
(``parallel.fsdp``), or with ``grad_compress`` wraps the optimizer in
the 1-bit ZeRO exchange (``SignCompressFsdp``). Rank 0 logs and writes
checkpoints; the error feedback rows of every rank are gathered into
them in JAX's ``(world, padded)`` / ``(world, seg)`` layout (``(hosts,
...)`` when hierarchical), an FSDP run's full leaves and segment rows
too, and handed back by ``restore``; at another world with
``elastic``, re-placed first (``parallel.remesh``). ``evaluate`` runs
on rank 0 and its result is broadcast. Each rank's dropout generator is
seeded from ``(seed + 1, rank)``; the GSPMD and fp32 FSDP steps draw
``augment``'s crops of the global batch from one generator seeded ``seed
+ 1`` on every rank (``augment_batch``), the compressed steps each
rank's from its own.

Model parallelism (the JAX ``_setup_tensor_parallel`` and
``_setup_pipeline_parallel``, with their errors): ``tensor_parallel``
cuts the bnn-mlp model into each rank's Megatron shards over a (data x
model) mesh (``parallel.model_parallel.TpShards``; the optimizer runs on
the shards), ``pipeline_parallel`` keeps a transformer's embedding, head
and this stage's blocks over a (data x pipe) mesh
(``parallel.pipeline_model.PipelinedModel``; ``remat`` checkpoints each
stage). Every rank of a data row draws from the row's generator, and
every rank evaluates (the forward is collective). Checkpoints keep the
JAX layouts: the flax tree's full arrays under TP, the pipelined
``{"blocks", "rest"}`` tree under PP (``interop.Layout``), written by
rank 0 and cut back on a restore. ``scan_steps`` and ``device_data``
run under either: on a card the TP, PP and (data, model) steps are
captured with their collectives and point-to-point transfers inside
(NCCL; ``check_capturable`` refuses gloo), on the CPU the chunk runs
eagerly. A pipelined model that draws dropout takes its step's seed on
the host and refuses capture.

Resilience (the JAX ``resilience/`` hooks): ``chaos`` (or ``JG_CHAOS``)
arms a ``resilience.ChaosController``, fired before each dispatch
(``on_step`` with the global step), after each checkpoint write
(``on_checkpoint_written``) and wired to the stop flag (``preempt``);
a resume marks the rules the restored position already passed. Its
``worker_*`` rules need ``elastic`` (``resilience.run_elastic``), its
``host_*`` rules the multihost runtime. Under the ``JG_MH_*``
environment (``parallel.detect_multihost``, set by
``resilience.run_elastic_multihost``) the trainer is one host of a
multihost world: a single-process trainer on the full batch whose
1-bit exchange runs over the ``parallel.hostcomm`` TCP collective
(``HostSignCompress``), with JAX's refusals (no in-process data
parallelism, ``gspmd`` only, ``elastic`` beyond one host, ``sign`` /
``sign_ef`` only); a lost host vacates without saving, ``host_restore``
saves and vacates, the error feedback rows are gathered over the
channel at each checkpoint, the epoch-boundary stop is agreed over it,
and a captured dispatch raises (a socket cannot be recorded in a CUDA
graph).

Telemetry (the JAX ``_setup_telemetry`` and ``_record_step``, ``obs``):
``telemetry_dir`` writes the run's JSONL events (the manifest with the
analytic step FLOPs and the card's peak, one ``step`` event a dispatch
with examples/s, MFU and, at log boundaries, loss and accuracy, then
``epoch`` with the cards' memory, ``eval``, ``checkpoint``, ``resume``,
``rollback``, ``graceful_stop``, ``error``, ``metrics`` and ``run_end``)
and per-rank heartbeats; without it the registry still counts steps and
examples and keeps the step-latency histogram (from the host's dispatch
time). A step event's ``latency_s`` is the device's: the time between
the CUDA completion events of consecutive dispatches (an epoch's first,
and the first after a profile capture starts or stops, from its own
start event: the capture's time is no step's), read once ``Event.query``
says they fired or after the epoch's closing synchronize
(``obs.StepClock``), so telemetry adds no host sync to the step loop;
a chunk of S captured steps is one event of ``n_steps = S`` with the
latency amortized. ``trace`` adds
``train.step``, ``train.checkpoint`` and ``train.restore`` spans;
``comm_bytes_total{mode, phase[, level]}`` counts what the exchange's
collectives put on the wire (``wire``), split as JAX splits it.
``profile_dir`` captures the first epoch's ``profile_steps`` steps with
``torch.profiler``, ``profile_step_window="A:B"`` the cumulative steps A
to B (into ``profile_dir`` or ``<telemetry_dir>/profile``), each
dispatch inside a ``jg_step`` region (``obs.profile``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import math
import os
import signal
import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data import batch_iterator, shard_indices
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
from ..resilience import Preempted, StopRequest
from ..utils.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruptionError,
    CheckpointTemplateMismatch,
    CheckpointWorldMismatch,
    latest_exists,
    load_checkpoint_resilient,
    read_meta,
    save_checkpoint,
    shape_mismatches,
)
from ..utils.checkpoint import load_checkpoint as _load_tree
from ..utils.logging_utils import is_primary_host
from ..utils.meters import AverageMeter
from ..utils.results import ResultsLog
from ..obs.profile import step_annotation
from ..ops.remat import checkpoint as remat_checkpoint
from .capture import TrainScan, pinned
from .optim import (
    RegimeSchedule,
    SignCompress,
    SignCompressFsdp,
    check_elementwise,
    make_optimizer,
    regime_hp_kwargs,
)

log = logging.getLogger(__name__)

# Steps a dispatch of the device-resident epoch when scan_steps is 1: one
# graph of 64 steps and one of the remainder (15 dispatches for the
# 937 steps of a 60,000-example epoch at batch 64).
DEVICE_DATA_CHUNK = 64

RNG_META_KEY = "torch_rng_state"   # the port's key in checkpoint_meta.json

# Host-collective tags of the out-of-step collectives (the channel checks
# that every rank issues the same sequence; the values name them in a
# divergence message), the JAX trainer's.
_MH_SYNC_TAG = 0x5EF0   # checkpoint-boundary EF-row allgather
_MH_STOP_TAG = 0x570B   # epoch-boundary stop agreement


def clamp_latent(params: Iterable[torch.Tensor]) -> None:
    """Clamp binarized-layer latents to [-1, 1] (mnist-dist2.py:135-137),
    e.g. ``clamp_latent(latent_clamp_mask(model).values())``.

    The JAX version is pure and returns new params; the port clamps the
    given tensors in place, under ``torch.no_grad()``."""
    with torch.no_grad():
        for p in params:
            p.clamp_(-1.0, 1.0)


_OPTIONAL_KNOBS = ("dtype", "backend", "stochastic", "scale",
                   "dropout_rate", "rng_seed")


def build_model(name: str, mk: Dict[str, Any]) -> torch.nn.Module:
    """``get_model(name, **mk)``, dropping each optional knob (dtype,
    backend, stochastic, scale, dropout_rate, rng_seed) that the
    constructor rejects, as the JAX trainer's ``_build_model`` does:
    ``fp32-mlp-large`` under bf16 stays fp32, ``convnet`` takes no
    backend."""
    mk = dict(mk)
    while True:
        try:
            return get_model(name, **mk)
        except TypeError as e:
            bad = next((k for k in _OPTIONAL_KNOBS
                        if k in mk and f"keyword argument '{k}'" in str(e)),
                       None)
            if bad is None:
                raise
            mk.pop(bad)
            if bad != "rng_seed":
                log.warning("model %r does not take %r; ignored", name, bad)


def recorded_aux_loss(model: torch.nn.Module) -> Optional[torch.Tensor]:
    """The sum of the auxiliary losses the model's modules recorded in
    their last forward (a tensor ``aux_loss`` attribute, set by a
    train-mode forward: ``models.moe.BnnMoEMLP``), or None."""
    terms = [m.aux_loss for m in model.modules()
             if torch.is_tensor(getattr(m, "aux_loss", None))]
    return sum(terms[1:], terms[0]) if terms else None


def forward_backward(model: torch.nn.Module, images: torch.Tensor,
                     labels: torch.Tensor, *,
                     loss_fn: Callable = cross_entropy_loss,
                     grad_accum: int = 1, remat: bool = False):
    """The step's forward in train mode and backward into the
    parameters' ``.grad`` (which the caller has cleared): ``(loss,
    accuracy)`` of these rows, 0-d tensors (accuracy in percent).

    ``grad_accum=N`` (the JAX body's): the rows are split into N
    microbatches run one after another; the gradients are their mean,
    each microbatch moves the BatchNorm statistics once (as a torch
    accumulation loop does), and the loss and accuracy are the
    microbatch means. ``remat``: each forward is an activation
    checkpoint (``ops.remat.checkpoint``; bitwise the plain step).

    Every auxiliary loss the model recorded in the forward
    (``recorded_aux_loss``: the MoE's load-balancing term, already
    scaled by the model) joins the loss, as the JAX body adds each sown
    ``*aux_loss``; the loss returned includes it. Under ``remat`` the
    checkpoint returns the term with the output, so the recompute's
    record is never read."""
    def forward(x):
        outs = model(x)
        return outs, recorded_aux_loss(model)

    def loss_and_acc(x, y):
        outs, aux = remat_checkpoint(forward, x) if remat else forward(x)
        loss = loss_fn(outs, y)
        if aux is not None:
            loss = loss + aux
        loss.backward()
        outs = outs.detach()
        acc = (outs.argmax(-1) == y).to(outs.dtype).mean() * 100.0
        return loss.detach(), acc

    if grad_accum == 1:
        return loss_and_acc(images, labels)
    metrics = [loss_and_acc(x, y) for x, y in zip(
        images.reshape(grad_accum, -1, *images.shape[1:]),
        labels.reshape(grad_accum, -1))]
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(grad_accum)
    loss, acc = (torch.stack(m).mean() for m in zip(*metrics))
    return loss, acc


def augment_batch(model: torch.nn.Module, images: torch.Tensor, *,
                  group=None, microbatches: int = 1) -> torch.Tensor:
    """The train step's random crop and flip of ``images`` (``ops.augment``,
    the JAX body's ``random_crop_flip`` on the key it splits off the step
    key), drawn from the model's ``augment_generator``. With a process
    ``group`` the draws are the global batch's (the world's rows, as the
    JAX GSPMD step draws them over its global batch), and this rank keeps
    its own rows of them (``shard_batch``, with the step's
    ``microbatches``): every rank's generator must then be seeded alike."""
    from ..ops.augment import crop_flip, draw_crop_flip, random_crop_flip

    gen_fn = getattr(model, "augment_generator", None)
    if gen_fn is None:
        raise ValueError(f"augment draws its crops from the model's own "
                         f"generator; {type(model).__name__} has none")
    gen = gen_fn(images.device)
    if group is None:
        return random_crop_flip(images, gen)
    from ..parallel import shard_batch   # parallel imports this module

    world = dist.get_world_size(group)
    draws = draw_crop_flip(images.shape[0] * world, gen)
    return crop_flip(images, *(shard_batch(t, group,
                                           microbatches=microbatches)
                               for t in draws))


def make_step_body(clamp_mask: Dict[str, torch.Tensor], *,
                   loss_fn: Callable = cross_entropy_loss,
                   grad_accum: int = 1, remat: bool = False,
                   augment: bool = False) -> Callable:
    """The train step: forward in train mode -> loss -> backward ->
    optimizer step -> ``clamp_latent`` on ``clamp_mask``'s tensors
    (``models.latent_clamp_mask``).

    ``step(model, optimizer, images, labels, scalars=None) -> (loss,
    accuracy)``, both 0-d tensors on the model's device (accuracy in
    percent): nothing syncs with the host. ``scalars``: the step's row
    of the optimizer's scalars, on the device (a captured step's; None:
    the optimizer makes its own and advances its counters).
    ``grad_accum`` and ``remat``: ``forward_backward``'s. ``augment``:
    the device-side random crop and flip of the images first
    (``augment_batch``), drawn from the model's generator."""
    check_step_options(grad_accum)
    latents = list(clamp_mask.values())

    def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                   images: torch.Tensor, labels: torch.Tensor,
                   scalars: Optional[torch.Tensor] = None):
        model.train()
        if augment:
            images = augment_batch(model, images)
        optimizer.zero_grad(set_to_none=True)
        loss, acc = forward_backward(model, images, labels, loss_fn=loss_fn,
                                     grad_accum=grad_accum, remat=remat)
        optimizer.step(scalars=scalars)
        clamp_latent(latents)
        return loss, acc

    return train_step


def check_step_options(grad_accum: int) -> None:
    """The step options that no train step takes."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")


def make_train_scan(clamp_mask: Dict[str, torch.Tensor], *,
                    loss_fn: Callable = cross_entropy_loss,
                    grad_accum: int = 1, remat: bool = False,
                    augment: bool = False, step: Optional[Callable] = None,
                    wire: Optional[WireBytes] = None,
                    groups=()) -> TrainScan:
    """Multi-step dispatch (the JAX ``make_train_scan``): ``scan(model,
    optimizer, images (S, B, ...), labels (S, B)) -> (loss, accuracy)``,
    S steps of ``make_step_body`` (or of ``step``, a data-parallel step
    over ``groups`` whose collectives count into ``wire``, on this
    rank's rows) and the means of their metrics. On a CUDA device the S
    steps are captured once as a CUDA graph and replayed
    (``train.capture.TrainScan``; the collectives inside, over NCCL);
    on the CPU they run eagerly, the plain version. ``scan.run`` gives
    the per-step metrics."""
    body = step or make_step_body(clamp_mask, loss_fn=loss_fn,
                                  grad_accum=grad_accum, remat=remat,
                                  augment=augment)

    def chunk(model, optimizer, images, labels, scalars):
        metrics = [body(model, optimizer, images[i], labels[i], scalars[i])
                   for i in range(images.shape[0])]
        losses, accs = zip(*metrics)
        return torch.stack(losses), torch.stack(accs)

    return TrainScan(chunk, wire=wire, groups=groups)


def make_train_epoch_fn(clamp_mask: Dict[str, torch.Tensor], *,
                        loss_fn: Callable = cross_entropy_loss,
                        grad_accum: int = 1, remat: bool = False,
                        augment: bool = False,
                        chunk: int = DEVICE_DATA_CHUNK,
                        scan: Optional[TrainScan] = None) -> Callable:
    """The device-resident epoch (the JAX ``make_train_epoch_fn``):
    ``epoch_fn(model, optimizer, images_all, labels_all, idx) -> (loss,
    accuracy, dispatches)`` over the ``(n_batches, B)`` index matrix
    ``idx`` into the dataset on the device. The epoch's rows are gathered
    once (as the JAX epoch hoists its gather), then run as dispatches of
    ``chunk`` steps through ``scan`` (``make_train_scan``'s; captured
    graphs on a card) reading contiguous slices, the last one shorter.
    No batch crosses from the host and nothing syncs; the metrics are
    the means over every step of the epoch."""
    scan = scan or make_train_scan(clamp_mask, loss_fn=loss_fn,
                                   grad_accum=grad_accum, remat=remat,
                                   augment=augment)

    def epoch_fn(model, optimizer, images_all, labels_all, idx):
        im_seq = images_all[idx]
        lb_seq = labels_all[idx]
        n = idx.shape[0]
        losses = torch.empty(n, dtype=torch.float32, device=idx.device)
        accs = torch.empty_like(losses)
        dispatches = 0
        for s in range(0, n, chunk):
            lo, ac = scan.run(model, optimizer, im_seq[s:s + chunk],
                              lb_seq[s:s + chunk])
            losses[s:s + chunk].copy_(lo)
            accs[s:s + chunk].copy_(ac)
            dispatches += 1
        return losses.mean(), accs.mean(), dispatches

    return epoch_fn


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


def make_eval_epoch_fn(loss_fn: Loss) -> Callable:
    """Evaluation over a test set on the device (the JAX
    ``make_eval_epoch_fn``): ``f(model, images_all, labels_all, idx,
    valid) -> totals`` gathers the ``(n_chunks, B)`` rows of ``idx`` once
    and sums ``make_eval_step``'s masked aggregates chunk by chunk in
    float32 on the device, as the JAX scan sums them; ``valid`` masks the
    last chunk's padding. Nothing syncs."""
    eval_step = make_eval_step(loss_fn)
    keys = ("loss_sum", "correct1", "correct5", "count")

    def eval_epoch(model, images_all, labels_all, idx, valid):
        im_seq, lb_seq = images_all[idx], labels_all[idx]
        totals = {k: torch.zeros((), dtype=torch.float32, device=idx.device)
                  for k in keys}
        for c in range(idx.shape[0]):
            out = eval_step(model, im_seq[c], lb_seq[c], valid[c])
            totals = {k: totals[k] + out[k].to(torch.float32) for k in keys}
        return totals

    return eval_epoch


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
    precision: str = "fp32"        # "bf16": bf16 compute, fp32 masters
                                   # (mnist-mixed.py:70)
    checkpoint_dir: Optional[str] = None
    save_all_epochs: bool = False  # keep checkpoint_epoch_N copies
    async_checkpoint: bool = False  # write checkpoints on a thread
    checkpoint_keep: int = 3       # generations kept for rollback
    resume: bool = False           # restore the newest checkpoint first
    handle_preemption: bool = True  # SIGTERM/SIGINT -> graceful stop,
                                   # mid-epoch checkpoint, Preempted
    results_path: Optional[str] = None  # ResultsLog CSV (+ HTML plot)
    timing_csv_prefix: Optional[str] = None  # per-batch / epoch CSVs
    device: Optional[str] = None   # None: "cuda" (raises without a card)
    data_parallel: Optional[object] = None  # None | "auto" | int ranks
    dp_mode: str = "gspmd"         # "gspmd" (replicated state) | "fsdp"
                                   # (parameters and optimizer state
                                   # sharded: parallel/fsdp.py; with
                                   # grad_compress the 1-bit ZeRO
                                   # exchange, SignCompressFsdp)
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
    remat: bool = False            # activation checkpoint of the forward
    grad_accum: int = 1            # >1: N sequential microbatches a step
    augment: bool = False          # device-side random crop + flip of each
                                   # batch inside the step (ops/augment)
    scan_steps: int = 1            # >1: S steps a dispatch (a CUDA graph
                                   # on a card; make_train_scan)
    device_data: bool = False      # the dataset on the device, each epoch
                                   # one gather and graph replays of
                                   # scan_steps (or DEVICE_DATA_CHUNK)
                                   # steps (make_train_epoch_fn)
    elastic: bool = False          # resume a checkpoint of another DP
                                   # world: its (world, ...) 1-bit
                                   # exchange rows are re-placed
                                   # (parallel/remesh.py); the elastic
                                   # supervisor (resilience.run_elastic,
                                   # cli train --elastic) and the chaos
                                   # membership faults need it
    chaos: Optional[str] = None    # fault-injection spec (resilience/
                                   # chaos); None: the JG_CHAOS env var
    pipeline_parallel: int = 1     # >1: GPipe the transformer block stack
                                   # over N ranks (parallel/pipeline_model)
    pp_microbatches: int = 0       # microbatches per pipelined step
                                   # (0 = one per stage)
    pp_remat: bool = False         # checkpoint each pipeline stage
    tensor_parallel: int = 1       # >1: Megatron TP over a 'model' axis of
                                   # ranks (parallel/model_parallel); with
                                   # data_parallel a (data x model) mesh
    profile_dir: Optional[str] = None  # torch.profiler capture of the first
                                   # trained epoch's profile_steps steps
    profile_steps: int = 5
    profile_step_window: Optional[str] = None  # "A:B": capture from
                                   # cumulative step A to B (obs/profile)
                                   # into profile_dir, or <telemetry_dir>/
                                   # profile; supersedes profile_steps
    telemetry_dir: Optional[str] = None  # JSONL events, heartbeats (obs/);
                                   # None: the registry only, no files
    trace: Optional[bool] = None   # train.step / checkpoint / restore spans
                                   # in the event log (obs/trace); None: the
                                   # JG_TRACE env var; needs telemetry_dir


def _dataset_ref(data):
    """A weak reference to ``data`` (a strong one where it takes none):
    the device copies are reused for this dataset object only."""
    try:
        return weakref.ref(data)
    except TypeError:
        return lambda: data


class Trainer:
    """One model and one optimizer on one device; with
    ``data_parallel``, one rank of the process group."""

    def __init__(self, config: TrainConfig, input_shape=(28, 28, 1)):
        self.config = config
        if config.dp_mode not in ("gspmd", "fsdp"):
            raise ValueError(f"unknown dp_mode {config.dp_mode!r} "
                             "(have: gspmd, fsdp)")
        if config.elastic:
            # TP and PP shard over non-data axes (no world fold), and the
            # device-resident epoch has no step boundary to stop at
            bad = [need for cond, need in (
                (config.tensor_parallel > 1, "tensor_parallel=1"),
                (config.pipeline_parallel > 1, "pipeline_parallel=1"),
                (config.device_data, "device_data=False")) if cond]
            if bad:
                raise ValueError("elastic=True requires " + ", ".join(bad)
                                 + " (RESILIENCE.md 'Elastic membership')")
            if not config.checkpoint_dir:
                raise ValueError(
                    "elastic=True requires checkpoint_dir: the remesh "
                    "re-places state from checkpoint generations "
                    "(RESILIENCE.md 'Elastic membership')")
        self.device = resolve_device(config.device)
        self.distributed = False   # in a process group (_resolve_world)
        self.mesh = None           # TP / PP: the rank mesh
        self.dp_rank = 0           # this rank's data row
        self._data_group = None    # the gradient all-reduce's group
        self.tp = None             # TP: this rank's TpShards
        self.fsdp = None           # fp32 FSDP: this rank's FsdpShards
        self.layout = None         # TP / PP: the flax layout (interop)
        self.mp = ("tp" if config.tensor_parallel > 1 else "pp"
                   if config.pipeline_parallel > 1 else None)
        self.world, self.rank = self._resolve_world()
        if self.mp is None:
            self.dp_n, self.dp_rank = self.world, self.rank
        self._check_dispatch()
        mk = dict(config.model_kwargs)
        if config.backend is not None:
            mk.setdefault("backend", config.backend)
        if config.precision == "bf16":
            mk.setdefault("dtype", torch.bfloat16)
        elif config.precision != "fp32":
            raise ValueError(f"unknown precision {config.precision!r} "
                             "(have: fp32, bf16)")
        if self.dp_n > 1:
            # the data row's: model and pipe ranks of a row draw alike
            from ..parallel import rank_seed

            mk.setdefault("rng_seed", rank_seed(config.seed + 1,
                                                self.dp_rank))
        mk.setdefault("rng_seed", config.seed + 1)
        self._model_kwargs = dict(mk)   # the unsharded model's (FLOPs)
        mk["generator"] = torch.Generator().manual_seed(config.seed)
        self.model = build_model(config.model, mk).to(self.device)
        if config.augment and self.mp is not None:
            raise ValueError("augment runs in the single-device and data-"
                             "parallel steps (the JAX package's TP and PP "
                             "steps take none); set tensor_parallel=1 and "
                             "pipeline_parallel=1")
        if (config.augment and self.dp_n > 1
                and config.grad_compress == "none"):
            # the GSPMD and fp32 FSDP steps draw the global batch's crops:
            # every rank from one seed (augment_batch keeps its rows)
            self.model.augment_seed = config.seed + 1
        self.regime = RegimeSchedule(config.regime)
        self.wire = WireBytes()   # bytes this rank's collectives moved
        self._setup_grad_compress()
        if config.pipeline_parallel > 1:
            self._setup_pipeline_parallel()
        elif config.tensor_parallel > 1:
            self._setup_tensor_parallel()
        else:
            self._setup_data_parallel()
        self.clamp_mask = latent_clamp_mask(self.model)
        self.optimizer_name = config.optimizer
        self.optimizer = self._build_tx(config.optimizer,
                                        config.learning_rate)
        self._loss_fn = make_loss(
            config.loss, num_classes=self.model.num_classes,
            label_smoothing=config.label_smoothing,
        )
        self.train_step = self._make_train_step()
        self.eval_step = make_eval_step(self._loss_fn)
        self._train_scan: Optional[TrainScan] = None  # scan_steps, device_data
        self._epoch_fn: Optional[Callable] = None
        self._eval_epoch_fn = make_eval_epoch_fn(self._loss_fn)
        self._device_train = None   # (dataset ref, images, labels)
        self._device_test = None
        self.step = 0
        self.epoch = 0
        self.best_acc = 0.0
        self.loss_history: List[float] = []  # every synced (logged) loss
        self.results = ResultsLog(config.results_path or "results.csv")
        self.batch_meter = AverageMeter()
        self.stop = StopRequest()
        self._checkpointer = (AsyncCheckpointer() if config.async_checkpoint
                              else None)
        self._setup_telemetry(input_shape)
        self._setup_chaos()

    def _setup_chaos(self) -> None:
        """The run's ``ChaosController`` (the JAX trainer's): a ``preempt``
        fault requests the graceful stop; membership rules need
        ``elastic``, host rules the multihost runtime, or they raise
        here."""
        from ..resilience.chaos import (
            HOST_KINDS,
            MEMBERSHIP_KINDS,
            ChaosController,
        )

        cfg = self.config
        self.chaos = ChaosController.from_config(
            cfg.chaos, seed=cfg.seed, telemetry=self.telemetry)
        # every rank fires the same rule at the same step, so a rank of a
        # process group may stop there with the others (multihost ranks
        # agree at the epoch boundary, as JAX's)
        self.chaos.on_preempt = lambda reason: self.stop.request(
            reason, lockstep=self.host_channel is None)
        if not cfg.elastic:
            member = [r.kind for r in self.chaos.rules
                      if r.kind in MEMBERSHIP_KINDS]
            if member:
                raise ValueError(
                    f"chaos {member[0]!r} requires elastic=True "
                    "(--elastic): membership faults drive the elastic "
                    "supervisor's mesh shrink/grow — without it the "
                    "fault would fire into nothing (RESILIENCE.md "
                    "'Elastic membership')")
        host_rules = [r.kind for r in self.chaos.rules
                      if r.kind in HOST_KINDS]
        if host_rules and self.host_channel is None:
            raise ValueError(
                f"chaos {host_rules[0]!r} requires the multihost "
                "elastic runtime (JG_MH_* env via resilience."
                "multihost.run_elastic_multihost): host faults "
                "SIGKILL/regrow real rank processes — without it the "
                "fault would fire into nothing (RESILIENCE.md "
                "'Multi-host elastic membership')")
        if self.host_channel is not None:
            self.chaos.on_host_membership = self._on_host_membership

    # -- telemetry (obs/) ----------------------------------------------------

    def _setup_telemetry(self, input_shape) -> None:
        """The run's ``obs.Telemetry`` (event sink and heartbeats under
        ``telemetry_dir``, registry-only without), the analytic step
        FLOPs and the card's peak for MFU, the manifest, the 1-bit
        plan's ``comm_compress`` record, the profile window (the JAX
        ``_setup_telemetry``)."""
        import dataclasses

        from ..obs import (
            StepClock, Telemetry, device_peak_flops, get_ledger,
            get_profiler, train_step_flops,
        )

        cfg = self.config
        self.telemetry = Telemetry(cfg.telemetry_dir, trace=cfg.trace)
        self._clock = StepClock(self.device) if cfg.telemetry_dir else None
        self._ledger = get_ledger()
        self._profiler = get_profiler()
        self._global_batch = cfg.batch_size   # every rank's rows together
        self._wire_seen: Dict[tuple, int] = {}
        # The conv and transformer families' FLOPs come from a forward
        # at batch 1 on the CPU: paid only when files were asked for. A
        # sharded model's FLOPs are its unsharded twin's.
        model = self.model
        if self.mp is not None and cfg.telemetry_dir:
            model = build_model(cfg.model, dict(
                self._model_kwargs, generator=torch.Generator()))
        self._step_flops, self._flops_method = (
            train_step_flops(cfg.model, model, self._global_batch,
                             input_shape=input_shape
                             if cfg.telemetry_dir else None)
            if self.mp is None or cfg.telemetry_dir
            else (None, "unavailable"))
        self._peak_flops, self._peak_precision = device_peak_flops(
            self.device, "int8" if cfg.backend == "int8" else "bf16")
        if self.telemetry.enabled:
            self.telemetry.manifest(
                config=dataclasses.asdict(cfg), mesh=self.mesh,
                device=self.device, step_flops=self._step_flops,
                flops_method=self._flops_method,
                peak_flops=self._peak_flops,
                peak_precision=self._peak_precision, world=self.world,
            )
        if self.comm_plan is not None and self.comm_plan.mode != "fp32":
            p = self.comm_plan
            extra = {}
            if self.hier_plan is not None:
                h = self.hier_plan
                extra = dict(
                    hosts=h.hosts, local=h.local,
                    intra_bytes_per_step=h.intra_bytes_per_step,
                    inter_bytes_per_step=h.inter_bytes_per_step,
                    flat_fp32_bytes_per_step=h.flat_fp32_bytes_per_step,
                    inter_ratio_vs_flat_fp32=h.inter_ratio_vs_flat_fp32,
                )
            self.telemetry.emit(
                "comm_compress",
                mode=p.mode, layout=p.layout, world=p.world,
                n_params=p.n_params, bucket_size=p.bucket_size,
                buckets=p.world * p.nb, chunks=p.chunks,
                wire_bytes_per_step=p.wire_bytes_per_step,
                wire_bytes_rs=p.wire_bytes_rs,
                wire_bytes_ag=p.wire_bytes_ag,
                fp32_bytes_per_step=p.fp32_bytes_per_step,
                wire_ratio=p.wire_ratio, **extra,
            )
        self._profiled = False   # the first-epoch profile_dir capture
        self._profile_window = self._parse_profile_window(
            cfg.profile_step_window)
        if self._profile_window is not None:
            self._profile_artifact_dir()   # fail at init, not mid-run
        self._profile_window_started = False

    @staticmethod
    def _parse_profile_window(spec: Optional[str]):
        if spec is None:
            return None
        try:
            a, b = (int(v) for v in str(spec).split(":"))
        except ValueError:
            raise ValueError(
                f"profile_step_window must be 'A:B' integer steps, got "
                f"{spec!r}") from None
        if not 0 <= a < b:
            raise ValueError(
                f"profile_step_window needs 0 <= A < B, got {spec!r}")
        return a, b

    def _profile_artifact_dir(self) -> str:
        cfg = self.config
        if cfg.profile_dir:
            return cfg.profile_dir
        from ..obs.profile import default_capture_dir

        d = default_capture_dir(cfg.telemetry_dir)
        if d is None:
            raise ValueError("--profile-steps needs --profile-dir or "
                             "--telemetry-dir for the capture artifacts")
        return d

    def _drive_profile_window(self, *, before_dispatch: bool) -> None:
        """Start the ``profile_step_window`` capture before the dispatch
        that reaches step A, stop it after the one that reaches B (the
        JAX ``_drive_profile_window``)."""
        from ..obs.profile import ProfileBusyError

        a, b = self._profile_window
        if before_dispatch:
            if not self._profile_window_started and self.step >= a:
                try:
                    self._profiler.start(self._profile_artifact_dir())
                except ProfileBusyError:
                    log.warning("profile window %s skipped: a capture is "
                                "already running",
                                self.config.profile_step_window)
                    self._profile_window = None
                    return
                self._profile_window_started = True
                self._restart_clock()
        elif self._profile_window_started and self.step >= b:
            self._stop_profile_window()

    def _stop_profile_window(self) -> None:
        self._profile_window_started = False
        self._profile_window = None
        self._profiler.stop(telemetry=self.telemetry)
        self._restart_clock()

    def _restart_clock(self) -> None:
        """Time the next dispatch from its own start: a capture's start
        and stop (a synchronize, idle edges, the trace's export) are no
        step's latency."""
        if self._clock is not None:
            self._clock.restart()

    def _record_step(self, per_step_s: float, n: int, seen: int,
                     metrics: Optional[Dict[str, float]] = None,
                     program: str = "train_step") -> None:
        """Step-level derived telemetry: examples/s, the latency
        histogram, MFU — one ``step`` event per dispatch (n > 1: a
        chunk, its latency amortized) — and the cost ledger's dispatch
        time of ``program``."""
        self.telemetry.record_step(
            per_step_s, batch_size=self._global_batch, n_steps=n,
            step=seen, step_flops=self._step_flops,
            peak_flops=self._peak_flops, n_devices=self.world,
            metrics=metrics,
        )
        if self._ledger.enabled:
            self._ledger.observe(program, per_step_s * n)

    def _record_comm(self, n: int) -> None:
        """``comm_bytes_total`` from what the exchange's collectives
        counted since the last dispatch (of ``n`` steps) (``wire``; a replay adds its
        graph's recorded bytes), split as JAX splits it: flat
        {mode, phase}; hierarchical the in-host fp32 ring (level intra)
        and the 1-bit phases (level inter)."""
        p = self.comm_plan
        if self.host_channel is not None:
            # the channel's framed TCP bytes since the last dispatch, all
            # inter-host (the JAX trainer's count)
            ch = self.host_channel
            total = ch.bytes_sent + ch.bytes_received
            delta, self._host_bytes_seen = (total - self._host_bytes_seen,
                                            total)
            if delta > 0:
                self.telemetry.registry.counter(
                    "comm_bytes_total",
                    "gradient-exchange bytes on the wire per worker "
                    "(labels: mode, phase=rs|ag; hierarchical runs add "
                    "level=intra|inter)",
                ).inc(delta, mode=p.mode, phase="xchg", level="inter")
            return
        if p is None or self.world <= 1:
            return
        reg = self.telemetry.registry
        comm = reg.counter(
            "comm_bytes_total",
            "gradient-exchange bytes on the wire per worker (labels: "
            "mode, phase=rs|ag; hierarchical runs add level=intra|inter)",
        )
        for (level, phase), total in list(self.wire.items()):
            delta = total - self._wire_seen.get((level, phase), 0)
            if delta <= 0:
                continue
            self._wire_seen[(level, phase)] = total
            if self.hier_plan is None:
                comm.inc(delta, mode=p.mode, phase=phase)
            elif level == "intra":
                comm.inc(delta, mode="fp32", phase="ring", level="intra")
            else:
                comm.inc(delta, mode=p.mode, phase=phase, level="inter")
        if p.saved_bytes_per_step:
            reg.counter(
                "comm_saved_bytes_total",
                "wire bytes saved vs the fp32 exchange",
            ).inc(p.saved_bytes_per_step * n)

    def _drain_clock(self) -> None:
        """Record every dispatch whose completion event has fired."""
        for seconds, d in self._clock.ready():
            self._record_step(seconds / d["n"], d["n"], d["step"],
                              d["metrics"], d["program"])

    def _resolve_world(self):
        """(world, rank): the process group's when ``data_parallel``,
        ``tensor_parallel`` or ``pipeline_parallel`` is set in a rank of
        one (``distributed``: the data-parallel step runs, at world 1
        too); 1 rank otherwise. Sets ``dp_n``, the data-parallel width
        (the world, or under TP / PP the ranks of the 'data' axis)."""
        cfg = self.config
        dp = cfg.data_parallel
        self.dp_n = 1
        if cfg.tensor_parallel > 1 or cfg.pipeline_parallel > 1:
            return self._resolve_mp_world()
        if not dp:
            return 1, 0
        if dist.is_available() and dist.is_initialized():
            world = dist.get_world_size()
            if dp != "auto" and int(dp) != world:
                raise ValueError(f"data_parallel={dp}, but the process "
                                 f"group holds {world} ranks")
            self.distributed = True
            return world, dist.get_rank()
        n = ((torch.cuda.device_count() if self.device.type == "cuda" else 1)
             if dp == "auto" else int(dp))
        if n > 1:
            raise ValueError(
                f"data_parallel={dp} needs {n} ranks: build the trainer in "
                "every rank of parallel.spawn (cli train --dp does)")
        return 1, 0

    def _resolve_mp_world(self):
        """The world of a TP or PP run (the JAX ``_setup_tensor_parallel``
        and ``_setup_pipeline_parallel`` checks of the devices): every
        rank of the process group is a cell of the (data x model) or
        (data x pipe) mesh."""
        cfg = self.config
        tp, pp = int(cfg.tensor_parallel), int(cfg.pipeline_parallel)
        if pp > 1 and tp > 1:
            raise ValueError("pipeline_parallel does not compose with "
                             "tensor_parallel yet; pick one")
        inner = tp * pp
        what = (f"tensor_parallel={tp}" if tp > 1
                else f"pipeline_parallel={pp}")
        if not (dist.is_available() and dist.is_initialized()):
            raise ValueError(
                f"{what} needs {inner} ranks: build the trainer in every "
                "rank of parallel.spawn (cli train --tp / --pp does)")
        world = dist.get_world_size()
        dp = cfg.data_parallel
        dp_n = world // inner if dp == "auto" else (int(dp) if dp else 1)
        if tp > 1:
            if cfg.dp_mode != "gspmd":
                raise ValueError(
                    "tensor_parallel composes with dp_mode='gspmd' only")
            if dp_n < 1:
                raise ValueError(f"tensor_parallel={tp} exceeds the {world} "
                                 "available devices")
            if cfg.batch_size % max(dp_n, 1):
                raise ValueError(f"batch_size {cfg.batch_size} not divisible "
                                 f"by data_parallel={dp_n}")
        else:
            if dp_n > 1 and cfg.dp_mode != "gspmd":
                raise ValueError(
                    "pipeline_parallel composes with dp_mode='gspmd' only")
            if world < pp * dp_n:
                raise ValueError(
                    f"pipeline_parallel={pp} x data_parallel={dp_n} needs "
                    f"{pp * dp_n} devices, have {world}")
        if dp_n * inner != world:
            raise ValueError(
                f"data_parallel={dp_n} x {what} needs {dp_n * inner} ranks, "
                f"but the process group holds {world}")
        self.dp_n = dp_n
        self.dp_rank = dist.get_rank() // inner
        self.distributed = True
        return world, dist.get_rank()

    def _check_dispatch(self) -> None:
        """The JAX ``grad_accum`` divisibility rule, and the JAX rule that
        the 1-bit exchange does not run in the device-resident epoch."""
        cfg = self.config
        if cfg.grad_accum < 1 or cfg.batch_size % cfg.grad_accum:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                             f"grad_accum={cfg.grad_accum}")
        if cfg.grad_compress != "none":
            bad = [need for cond, need in (
                (cfg.tensor_parallel > 1, "tensor_parallel=1"),
                (cfg.pipeline_parallel > 1, "pipeline_parallel=1"),
                (cfg.device_data, "device_data=False")) if cond]
            if bad:
                raise ValueError(f"grad_compress={cfg.grad_compress!r} "
                                 "requires " + ", ".join(bad))

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
        self._mh = None       # the supervisor's {rank, hosts, port, store}
        self.host_channel = None   # parallel.hostcomm's TCP collective
        self._host_bytes_seen = 0
        from ..parallel.distributed import detect_multihost

        mh = detect_multihost()
        if cfg.grad_compress == "none":
            if mh is not None:
                raise ValueError(
                    "multihost elastic runtime (JG_MH_* env) requires "
                    "grad_compress='sign' or 'sign_ef': the host-side "
                    "compressed exchange IS the inter-host transport "
                    "(RESILIENCE.md 'Multi-host elastic membership')")
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
        if mh is not None:
            self._setup_multihost(mh)
            return
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
            if cfg.dp_mode != "gspmd":
                raise ValueError(
                    "dp_hosts composes with dp_mode='gspmd' only: the "
                    "hierarchical exchange keeps the optimizer replicated "
                    "(per-host EF rows sharded over the host axis)")
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
            bucket_size=cfg.compress_bucket_size, chunks=cfg.compress_chunks,
            layout="fsdp" if cfg.dp_mode == "fsdp" else "dp")
        if world > 1:
            self._compress_group = dist.group.WORLD
            self._ef_row = self.rank

    def _setup_multihost(self, mh: Dict[str, Any]) -> None:
        """Join the multihost elastic world (the JAX ``_setup_multihost``):
        this process is one host of ``mh["hosts"]``, a single-process
        trainer whose inter-host exchange is the TCP collective
        (``parallel.hostcomm``). ``start()`` blocks until the world has
        formed, or fails within the channel's timeout (``JG_MH_TIMEOUT``
        seconds, 60 by default)."""
        cfg = self.config
        if cfg.data_parallel not in (None, 1) or cfg.dp_hosts not in (
                None, 1):
            raise ValueError(
                "multihost elastic runtime (JG_MH_* env) does not "
                "compose with in-process data_parallel/dp_hosts: each "
                "rank is one host of the world, the exchange runs over "
                "the host collective (parallel/hostcomm)")
        if cfg.dp_mode == "fsdp":
            raise ValueError(
                "multihost elastic runtime composes with "
                "dp_mode='gspmd' only: the host exchange keeps the "
                "optimizer replicated (per-host EF rows)")
        if mh["hosts"] > 1 and not cfg.elastic:
            raise ValueError(
                "multihost runtime with JG_MH_HOSTS>1 requires "
                "elastic=True (--elastic): host loss vacates via the "
                "preempt path and the supervisor re-places state "
                "through checkpoint generations (RESILIENCE.md "
                "'Multi-host elastic membership')")
        from ..parallel.hostcomm import HostChannel

        self.comm_plan = make_plan(
            tree_size(self.model.parameters()), world=mh["hosts"],
            mode=cfg.grad_compress, bucket_size=cfg.compress_bucket_size,
            chunks=cfg.compress_chunks)
        self._mh = dict(mh)
        self._ef_row = mh["rank"]
        self.host_channel = HostChannel(
            mh["rank"], mh["hosts"], int(mh["port"] or 0),
            timeout_s=float(os.environ.get("JG_MH_TIMEOUT", "60")))
        self.host_channel.start()

    def _setup_data_parallel(self) -> None:
        """Check the global batch, make sure every rank starts from the
        same state, shard it under fp32 FSDP, and size the fp32 plan of
        an uncompressed run (JAX ``_setup_data_parallel``)."""
        cfg = self.config
        self.fsdp = None
        if not self.distributed:
            if cfg.dp_mode != "gspmd":
                log.warning("dp_mode=%r has no effect with "
                            "data_parallel<=1 (pass --dp auto or an "
                            "integer > 1)", cfg.dp_mode)
            return
        from ..parallel import replicate

        if cfg.batch_size % self.world:
            raise ValueError(f"batch_size {cfg.batch_size} not divisible "
                             f"by data_parallel={self.world}")
        if self.world > 1:
            replicate(self.model)
        if cfg.grad_compress == "none":
            if cfg.dp_mode == "fsdp":
                from ..parallel.fsdp import FsdpShards

                self.fsdp = FsdpShards(self.model, wire=self.wire)
            self.comm_plan = make_plan(
                tree_size(self.model.parameters()), world=self.world,
                mode="fp32", bucket_size=cfg.compress_bucket_size,
                layout="fsdp" if cfg.dp_mode == "fsdp" else "dp")
        if self.rank == 0:
            log.info("data-parallel (%s%s) over %d ranks", cfg.dp_mode,
                     f", grad_compress={cfg.grad_compress}"
                     if cfg.grad_compress != "none" else "", self.world)

    def _setup_tensor_parallel(self) -> None:
        """Megatron tensor parallelism over a (data x model) mesh (the JAX
        ``_setup_tensor_parallel``): every rank holds the same seeded
        model, then its shards by the family's rule table
        (``parallel.model_parallel.TpShards``); BatchNorm normalises over
        the data group's global batch."""
        from ..parallel import (
            TpShards,
            make_mesh,
            replicate,
            set_batchnorm_group,
        )
        from ..interop import TpLayout

        cfg = self.config
        tp = int(cfg.tensor_parallel)
        replicate(self.model)
        self.mesh = make_mesh(data=self.dp_n, model=tp)
        self._data_group = self.mesh.group("data")
        self.tp = TpShards(self.model, cfg.model, self.mesh, wire=self.wire)
        self.layout = TpLayout(self.model, self.tp)
        if self.dp_n > 1:
            set_batchnorm_group(self.model, self._data_group)
        if self.rank == 0:
            log.info("tensor-parallel over (data=%d x model=%d) devices",
                     self.dp_n, tp)

    def _setup_pipeline_parallel(self) -> None:
        """The GPipe pipelined model over a (data x pipe) mesh (the JAX
        ``_setup_pipeline_parallel``): this rank keeps its stage's blocks
        (``parallel.pipeline_model.PipelinedModel``), so the optimizer
        built over it holds its stage's moments only."""
        from ..parallel import PipelinedModel, Mesh, replicate

        cfg = self.config
        pp = int(cfg.pipeline_parallel)
        if getattr(self.model, "depth", None) is None:
            raise ValueError(f"model {cfg.model!r} has no block stack to "
                             "pipeline (transformer families only)")
        n_micro = cfg.pp_microbatches or pp
        if self.dp_n > 1 and cfg.batch_size % (self.dp_n * n_micro):
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by "
                f"data_parallel={self.dp_n} x microbatches={n_micro}")
        replicate(self.model)
        self.mesh = Mesh((self.dp_n, pp), ("data", "pipe"))
        self._data_group = self.mesh.group("data")
        self.model = PipelinedModel(
            self.model, self.mesh, n_micro=n_micro,
            batch_axis="data" if self.dp_n > 1 else None,
            stage_remat=cfg.pp_remat or cfg.remat, wire=self.wire)
        self.layout = self.model
        if self.rank == 0:
            log.info("pipeline-parallel over %d stages (depth %d), "
                     "data_parallel=%d", pp, self.model.depth, self.dp_n)

    def _global_bn(self) -> bool:
        """Does the step normalise over the global batch (the GSPMD and
        fp32 FSDP steps), so that ``grad_accum``'s microbatches are
        slices of the global batch?"""
        return self.distributed and self.config.grad_compress == "none"

    def _shard(self, x, dim: int = 0):
        """This rank's rows of a global batch along ``dim``."""
        if not self.distributed:
            return x
        from ..parallel import shard_batch   # parallel imports this module

        return shard_batch(x, self._data_group,
                           microbatches=(self.config.grad_accum
                                         if self._global_bn() else 1),
                           dim=dim)

    def _set_tp_step(self) -> Callable:
        """The TP step over the trainer's shards (its optimizer comes per
        call: a regime's optimizer switch keeps the sharding, as the JAX
        ``_set_tp_step`` rebuilds it to)."""
        from ..parallel import make_tp_train_step

        cfg = self.config
        return make_tp_train_step(
            self.clamp_mask, self.model, self.tp, loss_fn=self._loss_fn,
            wire=self.wire, grad_accum=cfg.grad_accum, remat=cfg.remat)

    def _set_pp_step(self) -> Callable:
        """The pipelined step (the JAX ``_set_pp_step``): the step body
        over the pipelined model, the embedding's gradients summed over
        the pipe group, then averaged over the data group. ``remat`` is
        the stages' checkpoint (the pipelined forward's sends and
        receives are not run twice)."""
        from ..parallel import make_pp_train_step

        cfg = self.config
        return make_pp_train_step(
            self.clamp_mask, self.model, self._data_group,
            loss_fn=self._loss_fn, wire=self.wire,
            grad_accum=cfg.grad_accum)

    def _make_train_step(self) -> Callable:
        cfg = self.config
        kw = dict(loss_fn=self._loss_fn, grad_accum=cfg.grad_accum,
                  remat=cfg.remat, augment=cfg.augment)
        if self.mp == "tp":
            return self._set_tp_step()
        if self.mp == "pp":
            return self._set_pp_step()
        if not self.distributed:
            return make_step_body(self.clamp_mask, **kw)
        from ..parallel import (
            make_compressed_dp_train_step,
            make_compressed_fsdp_train_step,
            make_compressed_hier_train_step,
            make_dp_train_step,
        )

        if self.fsdp is not None:
            from ..parallel.fsdp import make_fsdp_train_step

            return make_fsdp_train_step(self.clamp_mask, self.model,
                                        self.fsdp, **kw)
        if cfg.grad_compress == "none":
            return make_dp_train_step(self.clamp_mask, self.model,
                                      wire=self.wire, **kw)
        if self.hier_plan is not None:
            return make_compressed_hier_train_step(self.clamp_mask, **kw)
        if cfg.dp_mode == "fsdp":
            return make_compressed_fsdp_train_step(self.clamp_mask, **kw)
        return make_compressed_dp_train_step(self.clamp_mask, **kw)

    def _build_tx(self, name: str, learning_rate: float, **kwargs: Any):
        """make_optimizer with this run's 1-bit exchange chained in (or,
        under FSDP, wrapped around it), or over this rank's FSDP shards:
        the one constructor of ``__init__`` and of a regime's optimizer
        switch, which so keeps the exchange (with fresh error feedback,
        as fresh moments) and the sharding."""
        cfg = self.config
        plan = self.comm_plan
        params = list(self.model.parameters())
        exchange: Dict[str, Any] = {}
        if cfg.grad_compress != "none":
            from ..interop import JaxFlatOrder

            common = dict(mode=plan.mode, order=JaxFlatOrder(self.model),
                          world=plan.world, group=self._compress_group,
                          bucket_size=plan.bucket_size, chunks=plan.chunks,
                          wire=self.wire)
            if self.host_channel is not None:
                # a regime's optimizer switch rebuilds it with a fresh
                # tag counter: every rank switches at the same epoch
                from ..parallel.hostcomm import HostSignCompress

                exchange["grad_transform"] = HostSignCompress(
                    mode=plan.mode, order=common["order"],
                    channel=self.host_channel, bucket_size=plan.bucket_size,
                    chunks=plan.chunks)
            elif cfg.dp_mode == "fsdp":
                check_elementwise(name)
                exchange["fsdp_compress"] = SignCompressFsdp(**common)
            else:
                exchange["grad_transform"] = SignCompress(
                    local_group=self._local_group, **common)
        return make_optimizer(name, params, learning_rate,
                              clip_grad_norm=cfg.clip_grad_norm,
                              fsdp=self.fsdp, tp=self.tp, **exchange,
                              **kwargs)

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
            self._drop_graphs()   # they hold the old optimizer's state
        self.regime.apply_hyperparams(self.optimizer, epoch)
        lr = self._lr_for_epoch(epoch)
        for group in self.optimizer.param_groups:
            group["learning_rate"] = lr

    def _to_device(self, images: np.ndarray, labels: np.ndarray):
        return (pinned(images, np.float32, self.device).to(
                    self.device, non_blocking=True),
                pinned(labels, np.int64, self.device).to(
                    self.device, non_blocking=True))

    def _drop_graphs(self) -> None:
        """Forget the captured steps (a new optimizer, restored state)."""
        self._train_scan = None
        self._epoch_fn = None

    def _get_train_scan(self) -> TrainScan:
        """The multi-step dispatch of this run's step: under data
        parallelism its collectives go into the graph."""
        if self._train_scan is None:
            self._train_scan = make_train_scan(
                self.clamp_mask, step=self.train_step, wire=self.wire,
                groups=(dist.group.WORLD,) if self.distributed else ())
            self._train_scan.telemetry = self.telemetry
            self._train_scan.refuse = self._capture_refusal()
        return self._train_scan

    def _capture_refusal(self) -> Optional[str]:
        """Why this run's step cannot be captured in a CUDA graph (None:
        it can): a host socket cannot be recorded, and a pipelined model
        that draws dropout takes each step's seed on the host."""
        if self.host_channel is not None:
            return ("a captured dispatch (scan_steps, device_data) cannot "
                    "record the multihost exchange: it runs over host TCP "
                    "sockets (parallel.hostcomm), which a CUDA graph does "
                    "not capture; set scan_steps=1")
        if self.mp == "pp" and getattr(self.model, "needs_rng", False):
            return ("a captured dispatch (scan_steps, device_data) of a "
                    "pipelined model with dropout would replay one step's "
                    "seed (drawn on the host each step): set dropout=0, or "
                    "scan_steps=1 and device_data=False")
        return None

    def _device_data_active(self) -> bool:
        """device_data runs on one card and under GSPMD data parallelism
        (the dataset on every rank's card, each rank its columns of the
        epoch's index matrix); FSDP over more than one rank keeps the
        streaming path, as the JAX ``_device_data_active`` does."""
        if not self.config.device_data:
            return False
        if self.world > 1 and self.config.dp_mode != "gspmd":
            log.warning("device_data needs dp_mode='gspmd' (multi-process "
                        "additionally needs the DP mesh); falling back to "
                        "the streaming path")
            return False
        return True

    def _get_epoch_fn(self) -> Callable:
        if self._epoch_fn is None:
            s = int(self.config.scan_steps)
            self._epoch_fn = make_train_epoch_fn(
                self.clamp_mask, scan=self._get_train_scan(),
                chunk=s if s > 1 else DEVICE_DATA_CHUNK)
        return self._epoch_fn

    @staticmethod
    def _scan_chunks(it, scan_steps: int):
        """Group a batch iterator into (images, labels, n) items (the JAX
        ``_scan_chunks``): full S-batch stacks, then any leftover batches
        one at a time (n = 1)."""
        buf: list = []
        for batch in it:
            buf.append(batch)
            if len(buf) == scan_steps:
                yield (np.stack([b[0] for b in buf]),
                       np.stack([b[1] for b in buf]), scan_steps)
                buf.clear()
        for images, labels in buf:
            yield images, labels, 1

    def train_epoch(self, data, epoch: int, start_batch: int = 0, *,
                    batches=None) -> Dict[str, float]:
        """One epoch over ``data.train_images`` in the seeded order of
        ``batch_iterator``, from batch ``start_batch`` on (the resume of a
        stopped epoch). Returns the train loss and accuracy (the logged
        dispatches' means, each weighted by its examples), the epoch's
        time, its mean time per batch and the mean host dispatch time of
        a batch.

        ``scan_steps = S > 1``: S batches a dispatch of the captured step
        (``make_train_scan``), the leftover ones a 1-step dispatch each;
        logging, the stop poll and the timing CSVs work per dispatch, a
        dispatch's time spread over its steps. ``device_data``: the
        whole epoch on the device (``_train_epoch_device``), but for a
        resumed part of an epoch, which streams as JAX's does.
        ``batches``: the epoch's (images, labels) batches from elsewhere
        (a streaming dataset's: ``fit_stream``), in place of ``data``'s."""
        cfg = self.config
        self._apply_epoch_regime(epoch)
        self.epoch = epoch
        if batches is None and not start_batch and (
                self._device_data_active()):
            return self._train_epoch_device(data, epoch)
        if start_batch:
            log.info("resuming epoch %d mid-epoch at batch %d", epoch,
                     start_batch)
        it = batches if batches is not None else batch_iterator(
            data.train_images, data.train_labels, cfg.batch_size,
            epoch=epoch, seed=cfg.seed)
        if start_batch:
            it = itertools.islice(it, start_batch, None)
        scan_steps = max(int(cfg.scan_steps), 1)
        items = (self._scan_chunks(it, scan_steps) if scan_steps > 1
                 else ((im, lb, 1) for im, lb in it))
        every = max(cfg.log_interval, 1)
        losses, accs = AverageMeter(), AverageMeter()
        batch_times: List[float] = []
        self.batch_meter.reset()
        clock, tracer = self._clock, self.telemetry.tracer
        if clock is not None:
            clock.restart()
        # The first epoch run (a resume may skip epoch 0) is captured for
        # profile_steps steps; a profile_step_window supersedes it.
        profiling = bool(cfg.profile_dir and not self._profiled
                         and cfg.profile_step_window is None)
        if profiling:
            self._profiled = True
            self._profiler.start(cfg.profile_dir)
        t_epoch = time.perf_counter()
        seen = start_batch
        dispatches = 0
        try:
            for images, labels, n in items:
                # a lost host world: the last step consumed a zeroed
                # exchange, so vacate before anything else (no save)
                self._check_host_lost(epoch)
                if self.chaos.active:
                    self.chaos.on_step(step=self.step, epoch=epoch)
                # A rank of a data-parallel run (or a multihost rank)
                # never stops alone: it waits for the epoch boundary
                # (_stop_boundary), unless every rank requested the same
                # stop at this step (a lockstep chaos stop).
                if self.stop.requested and (
                        (self.world <= 1 and self.host_channel is None)
                        or self.stop.lockstep):
                    self._graceful_stop(epoch, batches_done=seen)
                if self._profile_window is not None:
                    self._drive_profile_window(before_dispatch=True)
                m0 = time.monotonic() if tracer.enabled else 0.0
                t0 = time.perf_counter()
                token = clock.start() if clock is not None else None
                program = "train_step" if scan_steps == 1 else f"train_scan_{n}"
                with (step_annotation(program, tracer.run_trace)
                      if self._profiler.active else contextlib.nullcontext()):
                    if scan_steps > 1:
                        if n == 1:   # a leftover batch: a 1-step dispatch
                            images, labels = images[None], labels[None]
                        loss, acc = self._get_train_scan()(
                            self.model, self.optimizer,
                            pinned(self._shard(images, 1), np.float32,
                                   self.device),
                            pinned(self._shard(labels, 1), np.int64,
                                   self.device))
                    else:
                        x, y = self._to_device(self._shard(images),
                                               self._shard(labels))
                        if self._ledger.enabled and (
                                self._ledger.costs(program) is None):
                            loss, acc = self._ledger.measure(
                                program, self.train_step, self.model,
                                self.optimizer, x, y, device=self.device,
                                telemetry=self.telemetry,
                                extra={"model": cfg.model})
                        else:
                            loss, acc = self.train_step(
                                self.model, self.optimizer, x, y)
                payload = {"n": n, "step": self.step + n, "metrics": None,
                           "program": program}
                if clock is not None:
                    clock.stop(token, payload)
                dispatches += 1
                first = seen == start_batch
                seen += n
                self.step += n
                if first or seen % every < n:
                    loss_f, acc_f = float(loss), float(acc)   # host sync
                    payload["metrics"] = {"loss": loss_f,
                                          "accuracy": acc_f}
                    losses.update(loss_f, n * cfg.batch_size)
                    accs.update(acc_f, n * cfg.batch_size)
                    self.loss_history.append(loss_f)
                    if self.rank == 0:
                        log.info("epoch %d step %d loss %.4f acc %.2f%%%s",
                                 epoch, seen, loss_f, acc_f,
                                 f" ({n}-step dispatch)" if n > 1 else "")
                dt = time.perf_counter() - t0
                if tracer.enabled:
                    tracer.record("train.step", kind="step", t0=m0,
                                  t1=time.monotonic(), step=self.step,
                                  n_steps=n, epoch=epoch)
                self.batch_meter.update(dt / n, n)
                batch_times.extend([dt / n] * n)
                self._record_comm(n)
                if clock is None:
                    self._record_step(dt / n, n, self.step,
                                      payload["metrics"], program)
                else:
                    self._drain_clock()
                if profiling and seen >= cfg.profile_steps:
                    self._profiler.stop(telemetry=self.telemetry)
                    profiling = False
                    self._restart_clock()
                if self._profile_window is not None:
                    self._drive_profile_window(before_dispatch=False)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            # a loss in the epoch's last exchange vacates here, before
            # the fit loop checkpoints the tainted epoch
            self._check_host_lost(epoch)
        finally:
            if profiling:   # an epoch shorter than profile_steps, a raise
                self._profiler.stop(telemetry=self.telemetry)
            if self._profile_window_started:
                # the truncated window is final: it does not reopen
                self._stop_profile_window()
        epoch_time = time.perf_counter() - t_epoch
        if clock is not None:
            self._drain_clock()
        if cfg.timing_csv_prefix and self.rank == 0:
            self._dump_timing_csvs(epoch, batch_times, epoch_time)
        steps = seen - start_batch
        row = {
            "train_loss": losses.avg if losses.count else math.nan,
            "train_acc": accs.avg if accs.count else math.nan,
            "epoch_time_s": epoch_time,
            "batch_time_s": epoch_time / max(steps, 1),
            "dispatch_time_s": self.batch_meter.avg,
            "steps": steps,
        }
        self.telemetry.epoch(
            epoch, metrics={"train_loss": row["train_loss"],
                            "train_acc": row["train_acc"]},
            epoch_time_s=round(epoch_time, 3), dispatches=dispatches)
        return row

    def _device_set(self, data, split: str):
        """``data``'s ``split`` ("train" or "test") images (float32) and
        labels (int64) on the device, uploaded once per dataset object (a
        weak reference tells a new dataset from the cached one)."""
        attr = f"_device_{split}"
        held = getattr(self, attr)
        if held is None or held[0]() is not data:
            images = getattr(data, f"{split}_images")
            labels = getattr(data, f"{split}_labels")
            held = (_dataset_ref(data),
                    *self._to_device(images, labels))
            setattr(self, attr, held)
        return held[1], held[2]

    def _train_epoch_device(self, data, epoch: int) -> Dict[str, float]:
        """The epoch over the dataset on the device (the JAX
        ``_train_epoch_device``): ``shard_indices``' first ``n_batches *
        batch_size`` rows as an ``(n_batches, batch_size)`` matrix,
        uploaded once; one gather; replays of the captured chunk
        (``make_train_epoch_fn``). One host sync, at the end; per-batch
        times are the epoch's amortized, the metrics the means over
        every step."""
        cfg = self.config
        if self.chaos.active:
            # one fault point an epoch: the epoch is one dispatch
            self.chaos.on_step(step=self.step, epoch=epoch)
        images_all, labels_all = self._device_set(data, "train")
        idx = shard_indices(len(data.train_labels), epoch=epoch,
                            seed=cfg.seed)
        n_batches = len(idx) // cfg.batch_size
        idx = np.asarray(idx[:n_batches * cfg.batch_size], np.int64)
        # each rank gathers its columns of the epoch's batches
        idx = torch.from_numpy(self._shard(
            idx.reshape(n_batches, cfg.batch_size), 1)).to(self.device)
        self.batch_meter.reset()
        clock = self._clock
        if clock is not None:
            clock.restart()
        t0 = time.perf_counter()
        token = clock.start() if clock is not None else None
        loss, acc, dispatches = self._get_epoch_fn()(
            self.model, self.optimizer, images_all, labels_all, idx)
        payload = {"n": n_batches, "step": self.step + n_batches,
                   "metrics": None, "program": "train_epoch"}
        if clock is not None:
            clock.stop(token, payload)
        loss_f, acc_f = torch.stack([loss, acc]).tolist()   # the one sync
        epoch_time = time.perf_counter() - t0
        self.step += n_batches
        # One dispatch = the whole epoch (JAX's): its step event has the
        # epoch's time amortized over its steps.
        payload["metrics"] = {"loss": loss_f, "accuracy": acc_f}
        if clock is None:
            self._record_step(epoch_time / max(n_batches, 1), n_batches,
                              self.step, payload["metrics"], "train_epoch")
        else:
            self._drain_clock()
        self._record_comm(n_batches)
        self.loss_history.append(loss_f)
        per_batch = epoch_time / max(n_batches, 1)
        self.batch_meter.update(per_batch, n_batches)
        if self.rank == 0:
            log.info("epoch %d on the device: %d steps in %d dispatches, "
                     "loss %.4f acc %.2f%% (%.3f ms/batch)", epoch,
                     n_batches, dispatches, loss_f, acc_f, per_batch * 1e3)
        if cfg.timing_csv_prefix and self.rank == 0:
            self._dump_timing_csvs(epoch, [per_batch] * n_batches,
                                   epoch_time)
        self.telemetry.epoch(
            epoch, metrics={"train_loss": loss_f, "train_acc": acc_f},
            epoch_time_s=round(epoch_time, 3), dispatches=dispatches)
        return {
            "train_loss": loss_f,
            "train_acc": acc_f,
            "epoch_time_s": epoch_time,
            "batch_time_s": per_batch,
            "dispatch_time_s": per_batch,
            "steps": n_batches,
            "dispatches": dispatches,
        }

    def evaluate(self, data,
                 batch_size: Optional[int] = None) -> Dict[str, float]:
        """``test_loss``, ``test_acc`` and ``test_acc_top5`` (percent) over
        ``data.test_images``, every row counted once; one host sync. In
        a data-parallel run rank 0 evaluates and broadcasts the result."""
        if self.world <= 1 or self.mp is not None:
            # TP / PP: the forward is collective, every rank evaluates
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
        if self.config.device_data:
            t = self._eval_device(data, bs)
        else:
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

    def _eval_device(self, data, bs: int) -> Dict[str, float]:
        """The test set on the device in ``bs``-row chunks, the last one
        padded and masked (``valid``); float32 totals, one host sync (the
        JAX ``_eval_device``)."""
        images_all, labels_all = self._device_set(data, "test")
        n = len(data.test_labels)
        n_chunks = max(-(-n // bs), 1)
        flat = np.zeros(n_chunks * bs, np.int64)
        flat[:n] = np.arange(n)
        valid = np.zeros(n_chunks * bs, bool)
        valid[:n] = True
        idx, valid = (torch.from_numpy(a.reshape(n_chunks, bs)).to(
            self.device) for a in (flat, valid))
        totals = self._eval_epoch_fn(self.model, images_all, labels_all,
                                     idx, valid)
        keys = list(totals)
        return dict(zip(keys, torch.stack([totals[k] for k in keys])
                        .tolist()))

    def fit(self, data, eval_every: int = 1) -> List[Dict[str, float]]:
        """``config.epochs`` epochs (after ``try_resume`` with ``resume``),
        each evaluated when ``eval_every`` divides its number (0: never),
        ``best_acc`` kept, checkpointed when ``checkpoint_dir`` is set and
        logged to ``results``. Returns one row per epoch run. Raises
        ``Preempted`` after a graceful stop. The run's telemetry is
        sealed at the end (``metrics`` and ``run_end`` events), after an
        ``error`` event on a crash."""
        return self._fit_loop(
            lambda epoch, start: self.train_epoch(data, epoch, start),
            lambda: self.evaluate(data), eval_every)

    def fit_stream(self, stream, eval_data=None,
                   eval_every: int = 1) -> List[Dict[str, float]]:
        """``fit`` over a streaming dataset (``data.open_imagenet_stream``;
        the JAX ``fit_stream``): each epoch's batches come from the
        stream's ``batches`` in ``batch_iterator``'s seeded order, so a
        stream and the same images in memory train alike; a data-parallel
        rank takes its rows of each. ``device_data`` does not apply (the
        stream does not fit). ``eval_data``: an in-memory dataset (the
        materialized val subset) to evaluate on; None: no eval, and so no
        best checkpoint."""
        cfg = self.config

        def train(epoch: int, start: int) -> Dict[str, float]:
            it = stream.batches(cfg.batch_size, epoch=epoch, seed=cfg.seed)
            return self.train_epoch(None, epoch, start, batches=it)

        return self._fit_loop(
            train, (lambda: self.evaluate(eval_data))
            if eval_data is not None else None, eval_every)

    def _fit_loop(self, train_fn, eval_fn, eval_every: int) -> list:
        history = []
        start_epoch, start_batch = (self.try_resume() if self.config.resume
                                    else (0, 0))
        tracer = self.telemetry.tracer
        epoch = start_epoch
        with contextlib.ExitStack() as stack:
            if self.config.handle_preemption:
                stack.enter_context(self.stop.install())
            try:
                for epoch in range(start_epoch, self.config.epochs):
                    row: Dict[str, float] = {"epoch": epoch}
                    row.update(train_fn(
                        epoch, start_batch if epoch == start_epoch else 0))
                    if eval_fn is not None and eval_every and (
                            (epoch + 1) % eval_every == 0):
                        eval_row = eval_fn()
                        row.update(eval_row)
                        self.telemetry.emit("eval", epoch=epoch, **eval_row)
                    history.append(row)
                    acc = row.get("test_acc", 0.0)
                    is_best = acc > self.best_acc
                    self.best_acc = max(self.best_acc, acc)
                    if self.config.checkpoint_dir:
                        self._check_host_lost(epoch)
                        with tracer.start("train.checkpoint",
                                          kind="checkpoint", epoch=epoch,
                                          best=is_best):
                            self.save_checkpoint(
                                self.config.checkpoint_dir, is_best=is_best,
                                epoch=epoch,
                                save_all=self.config.save_all_epochs,
                                extra_meta={k: v for k, v in row.items()
                                            if isinstance(v, float)})
                        self.telemetry.checkpoint(
                            epoch, self.config.checkpoint_dir, best=is_best)
                        if (self._checkpointer is not None
                                and not self.config.async_checkpoint):
                            self._checkpointer.wait()
                    if is_primary_host():   # a multihost rank 0 too
                        log.info("epoch %d done: %s", epoch,
                                 {k: round(v, 4) for k, v in row.items()
                                  if k != "epoch"})
                        self.results.add(**row)
                        if self.config.results_path:
                            self.results.save()
                    # The epoch's checkpoint is the resume point; a stop
                    # at the last epoch's boundary has nothing left to
                    # resume.
                    if (epoch < self.config.epochs - 1
                            and self._stop_boundary()):
                        self._graceful_stop(epoch, batches_done=None,
                                            write_checkpoint=False)
                if self._checkpointer is not None:
                    self._checkpointer.wait()
            except Preempted:
                # not a crash: the graceful_stop event is in the log
                self.telemetry.close(preempted=True, epochs=len(history))
                raise
            except Exception as e:
                self.telemetry.error(e, epoch=epoch)
                self.telemetry.close(crashed=True, epochs=len(history))
                raise
        self.telemetry.close(epochs=len(history))
        return history

    def _stop_boundary(self) -> bool:
        """The epoch-boundary stop decision: the local flag, or in a
        data-parallel run one all-reduce of every rank's flag (every rank
        calls it once an epoch), so that one rank's request stops all."""
        if self._mh is not None and self._mh["hosts"] > 1:
            # multihost: the agreement rides the host collective; a
            # transport failure means the world is dying: stop, and let
            # the lost latch vacate without a save
            try:
                flags = self.host_channel.allgather(
                    b"\x01" if self.stop.requested else b"\x00",
                    tag=_MH_STOP_TAG)
            except ConnectionError:
                return True
            if any(f == b"\x01" for f in flags):
                if not self.stop.requested:
                    self.stop.request("preemption on a peer host")
                return True
            return False
        if self.world <= 1:
            return self.stop.requested
        flag = torch.tensor([1.0 if self.stop.requested else 0.0],
                            device=self.device)
        if float(all_reduce_sum(flag, dist.group.WORLD)[0]) > 0:
            if not self.stop.requested:
                self.stop.request("preemption on a peer rank")
            return True
        return False

    def _graceful_stop(self, epoch: int, batches_done: Optional[int] = None,
                       write_checkpoint: bool = True) -> None:
        """Stop now: write a checkpoint whose meta holds the epoch in
        progress and the batches done in it (``batches_done`` None: an
        epoch-boundary stop, whose per-epoch checkpoint the fit loop
        wrote, ``write_checkpoint=False``), then raise ``Preempted``."""
        cfg = self.config
        if self._checkpointer is not None:
            self._checkpointer.wait()
        saved = not write_checkpoint and bool(cfg.checkpoint_dir)
        if write_checkpoint and cfg.checkpoint_dir:
            # a dying multihost world must not save (tainted state)
            self._check_host_lost(epoch)
            extra = {"preempted": True}
            if batches_done is not None:
                extra["epoch_in_progress"] = int(epoch)
                extra["batch_in_epoch"] = int(batches_done)
            # the meta's epoch is the last one completed (-1: none)
            with self.telemetry.tracer.start(
                    "train.checkpoint", kind="checkpoint", epoch=epoch,
                    preempted=True):
                self.save_checkpoint(
                    cfg.checkpoint_dir,
                    epoch=epoch - 1 if batches_done is not None else epoch,
                    extra_meta=extra)
                if self._checkpointer is not None:
                    self._checkpointer.wait()
            saved = True
        self.telemetry.registry.counter(
            "graceful_stops_total", "preemption-driven graceful stops"
        ).inc()
        self.telemetry.emit(
            "graceful_stop", epoch=int(epoch), step=self.step,
            batch_in_epoch=batches_done, checkpoint_saved=saved,
            reason=self.stop.reason)
        log.warning("graceful stop at epoch %d step %d (%s): %s", epoch,
                    self.step, self.stop.reason,
                    "mid-epoch checkpoint written" if saved
                    else "no checkpoint dir")
        raise Preempted(epoch, self.step, self.stop.reason or "")

    def _dump_timing_csvs(self, epoch: int, batch_times: List[float],
                          epoch_time: float) -> None:
        """Per-batch dispatch times and the epoch's time as CSVs, the two
        timing files of the reference's run (mnist-dist2.py:152-155)."""
        prefix = self.config.timing_csv_prefix
        mode = "w" if epoch == 0 else "a"
        with open(f"{prefix}_batch_time.csv", mode) as f:
            if epoch == 0:
                f.write("epoch,batch,seconds\n")
            for i, t in enumerate(batch_times):
                f.write(f"{epoch},{i},{t:.6f}\n")
        with open(f"{prefix}_epoch_time.csv", mode) as f:
            if epoch == 0:
                f.write("epoch,seconds\n")
            f.write(f"{epoch},{epoch_time:.6f}\n")

    # -- checkpoints -------------------------------------------------------

    def gather_rows(self, row: torch.Tensor) -> torch.Tensor:
        """``(workers, ...)``: every worker's ``row`` (one a host when
        hierarchical), JAX's layout of a worker-sharded state leaf;
        collective in a data-parallel run."""
        if self.host_channel is not None:
            from ..parallel.hostcomm import allgather_rows

            rows = allgather_rows(self.host_channel,
                                  row.detach().cpu().numpy(),
                                  tag=_MH_SYNC_TAG)
            return torch.from_numpy(rows)
        if not self.distributed:
            return row.detach()[None]
        local = self.hier_plan.local if self.hier_plan else 1
        return all_gather(row.detach(), dist.group.WORLD)[::local]

    def ef_rows(self, *, template: bool = False) -> Dict[str, torch.Tensor]:
        """The error feedback of every worker in JAX's layout, one row a
        worker (a host when hierarchical): ``{"ef_residual": (workers,
        padded), "ef_residual2": (workers, seg)}``; without ``sign_ef``
        empty, or zero-width rows under the compressed FSDP exchange (as
        JAX's ``FsdpCompressState`` keeps them). Collective in a
        data-parallel run; ``template=True`` gives meta tensors of those
        shapes and no collective."""
        tx = self.optimizer.comm_transform()
        if tx is None:
            return {}
        keys = ("ef_residual", "ef_residual2")
        workers = self.comm_plan.world
        if tx.mode != "sign_ef":
            if self.optimizer.fsdp_compress is None:
                return {}
            return {k: torch.empty((workers, 0), device="meta"
                                   if template else "cpu") for k in keys}
        rows = {k: getattr(tx, k) for k in keys}
        if template:
            return {k: torch.empty((workers, *v.shape), dtype=v.dtype,
                                   device="meta") for k, v in rows.items()}
        return {k: self.gather_rows(v) for k, v in rows.items()}

    def load_ef_rows(self, rows: Dict[str, Any]) -> None:
        """Take this worker's row of ``ef_rows``' layout."""
        tx = self.optimizer.comm_transform()
        if tx is None or tx.mode != "sign_ef":
            return
        from ..interop import _to_tensor

        tx.load_state_dict({k: _to_tensor(np.asarray(v)[self._ef_row])
                            for k, v in rows.items()})

    def _generators(self) -> Dict[str, torch.Generator]:
        """The model's train-time generators by their meta key: "ranks"
        (dropout masks, stochastic signs, and the crops) and, where the
        augmentation has its own (the GSPMD step's global draws),
        "augment_ranks"."""
        from .capture import train_generators

        return dict(zip(("ranks", "augment_ranks"),
                        train_generators(self.model, self.device)))

    def _rng_state(self) -> Optional[Dict[str, Any]]:
        """Every rank's train-time generator states (hex), collective in a
        data-parallel run; None for a model that draws nothing."""
        gens = self._generators()
        if not gens:
            return None
        out = {"device": self.device.type}
        for key, gen in gens.items():
            mine = gen.get_state().numpy().tobytes().hex()
            ranks = [mine]
            if self.world > 1:
                ranks = [None] * self.world
                dist.all_gather_object(ranks, mine)
            out[key] = ranks
        return out

    def _restore_rng(self, meta: Dict[str, Any]) -> None:
        """Set the train-time generator from the meta's ``torch_rng_state``
        when it is this run's device type and world; else keep the
        seed-derived one (a JAX checkpoint's ``rng_key`` is a JAX key)."""
        gens = self._generators()
        saved = meta.get(RNG_META_KEY)
        if not gens:
            return
        if (not saved or saved.get("device") != self.device.type
                or any(len(saved.get(k) or []) != self.world
                       for k in gens)):
            log.info("the checkpoint holds no %s generator state for %d "
                     "rank(s)%s; keeping the seed-derived generator",
                     self.device.type, self.world,
                     " (its rng_key is a JAX PRNG key)"
                     if meta.get("rng_key") else "")
            return
        for key, gen in gens.items():
            state = bytes.fromhex(saved[key][self.rank])
            gen.set_state(torch.frombuffer(bytearray(state),
                                           dtype=torch.uint8))

    def _saver(self) -> Callable:
        return (self._checkpointer.save if self._checkpointer is not None
                else save_checkpoint)

    def save_checkpoint(self, ckpt_dir: str, *, is_best: bool = False,
                        epoch: Optional[int] = None, save_all: bool = False,
                        extra_meta: Optional[Dict[str, Any]] = None) -> str:
        """Write the train state (``interop.train_state_to_jax``) under
        ``ckpt_dir`` as the JAX package does, with the meta's epoch
        (default ``self.epoch``), best accuracy, world size, model name
        and generator states; returns the latest path. In a
        data-parallel run every rank calls it and rank 0 writes."""
        from ..interop import train_state_to_jax

        meta = {"best_acc": self.best_acc,
                "world_size": (self._mh["hosts"] if self._mh
                               else self.world),
                "model": self.config.model}
        rng = self._rng_state()
        if rng is not None:
            meta[RNG_META_KEY] = rng
        meta.update(extra_meta or {})
        try:
            tree = train_state_to_jax(self)   # collective: gathers rows
        except ConnectionError:
            # the multihost world died in the rows' gather: no save
            self._check_host_lost(self.epoch)
            raise
        return self._saver()(
            tree, ckpt_dir, is_best=is_best,
            epoch=self.epoch if epoch is None else epoch, save_all=save_all,
            extra_meta=meta, keep_generations=self.config.checkpoint_keep,
            chaos=self.chaos)

    def _check_model(self, meta: Dict[str, Any], path: str) -> None:
        held = meta.get("model")
        if held is not None and held != self.config.model:
            raise CheckpointTemplateMismatch(
                f"{path} holds a {held!r}, not a {self.config.model!r}")

    def try_resume(self) -> tuple:
        """Restore the newest verified checkpoint generation under
        ``checkpoint_dir``, if any; returns ``(start_epoch,
        start_batch)``. A corrupt latest rolls back to the generation
        before it; when every generation is corrupt the run starts fresh
        (logged as an error). A checkpoint of another model or optimizer
        raises ``CheckpointTemplateMismatch``; one of another world
        ``CheckpointWorldMismatch``, unless ``elastic`` re-places its
        rows (``_remesh``)."""
        from ..interop import train_state_from_jax, train_state_to_jax

        if self._checkpointer is not None:
            self._checkpointer.wait()
        ckpt = self.config.checkpoint_dir
        if not ckpt or (not latest_exists(ckpt)
                        and not read_meta(ckpt).get("generations")):
            return 0, 0
        self._check_model(read_meta(ckpt), ckpt)
        telemetry, tracer = self.telemetry, self.telemetry.tracer
        m_restore = time.monotonic()
        template = train_state_to_jax(self, values=False)
        try:
            tree, info = load_checkpoint_resilient(
                template, ckpt, on_shape_mismatch=(
                    "return" if self.config.elastic else "raise"))
        except CheckpointCorruptionError as e:
            log.error("every checkpoint generation under %s is corrupt "
                      "(%s); starting from scratch", ckpt, e)
            telemetry.registry.counter(
                "rollbacks_total", "checkpoint generation rollbacks"
            ).inc(outcome="fresh_start")
            telemetry.emit("rollback", path=ckpt, file=None,
                           outcome="fresh_start", error=str(e)[:500])
            tracer.record("train.restore", kind="restore", t0=m_restore,
                          t1=time.monotonic(), status="fresh_start",
                          path=ckpt)
            return 0, 0
        remeshed = bool(info["shape_mismatches"])
        if remeshed:
            tree = self._remesh(template, tree, info["shape_mismatches"],
                                ckpt, info.get("meta") or {})
        train_state_from_jax(tree, self)
        self._drop_graphs()
        meta = info.get("meta") or {}
        self.best_acc = float(meta.get("best_acc") or 0.0)
        self._restore_rng(meta)
        if (meta.get("epoch_in_progress") is not None
                and meta.get("batch_in_epoch")):
            start = int(meta["epoch_in_progress"])
            start_batch = int(meta["batch_in_epoch"])
        else:
            epoch = meta.get("epoch")
            start = (int(epoch) if epoch is not None else -1) + 1
            start_batch = 0
        self.epoch = start
        if self.chaos.active:
            # the faults scripted at or before the restored position
            # fired in the process that wrote it (the fire ledger did
            # not survive it): without this, preempt@step=K refires
            self.chaos.mark_reached(step=meta.get("step"), epoch=start)
        if info["rolled_back"]:
            telemetry.registry.counter(
                "rollbacks_total", "checkpoint generation rollbacks"
            ).inc(outcome="generation")
            telemetry.emit(
                "rollback", path=ckpt, file=info.get("file"),
                outcome="generation", generation=meta.get("generation"),
                skipped="; ".join(info.get("errors") or [])[:500])
        telemetry.registry.counter(
            "resumes_total", "checkpoint restores before training").inc()
        telemetry.emit(
            "resume", epoch=start, batch_in_epoch=start_batch or None,
            step=meta.get("step"), path=ckpt, file=info.get("file"),
            digest_verified=info.get("digest_verified"),
            rolled_back=bool(info["rolled_back"]), world_size=self.world,
            checkpoint_world_size=meta.get("world_size"),
            remeshed=remeshed)
        tracer.record("train.restore", kind="restore", t0=m_restore,
                      t1=time.monotonic(), path=ckpt, epoch=start,
                      remeshed=remeshed,
                      rolled_back=bool(info["rolled_back"]))
        log.info("resumed from %s (%s%s) at epoch %d%s (step %d)", ckpt,
                 info["file"], ", rolled back" if info["rolled_back"] else "",
                 start, f" batch {start_batch}" if start_batch else "",
                 self.step)
        return start, start_batch

    def _remesh(self, template, tree, mismatches, ckpt: str,
                meta: Dict[str, Any]):
        """An elastic restore across a change of world (the JAX
        ``try_resume``): the checkpoint's ``(world, ...)`` rows of the
        1-bit exchange re-placed onto this run's world
        (``parallel.remesh``); any leaf still of another shape is a
        change of model or configuration and raises."""
        from ..parallel.remesh import remesh_compress_state

        if self.config.grad_compress == "none":
            raise CheckpointWorldMismatch(
                f"restored state under {ckpt} does not match this run's "
                "shapes and no compression state is active to re-place: "
                + "; ".join(mismatches[:3])
                + " (a change of model or configuration, not of world)")
        tree = dict(tree)
        tree["opt_state"], n = remesh_compress_state(tree["opt_state"],
                                                     self.comm_plan)
        leftover = shape_mismatches(template, tree)
        if leftover:
            raise CheckpointWorldMismatch(
                "shapes still mismatch after re-placing the compression "
                "state (a change of model or configuration, not of world): "
                + "; ".join(leftover[:3]))
        log.warning("elastic restore: re-placed %d compression-state "
                    "node(s) from checkpoint world %s onto world %d", n,
                    meta.get("world_size"), self.comm_plan.world)
        return tree

    # -- the multihost world (chaos host rules, loss fence) --------------------

    def _on_host_membership(self, event: str, *, hosts=None, step=None,
                            epoch=None) -> None:
        """Chaos ``host_lost`` / ``host_restore`` (the JAX trainer's): the
        rules fire on every rank at the same step. ``lost``: the ranks
        at or above the surviving count die by SIGKILL (no cleanup, no
        checkpoint); the survivors find the loss in the next exchange and
        vacate without saving (``_check_host_lost``). ``restored``: rank
        0 writes the regrow request to the store and every rank requests
        a graceful stop (at the epoch boundary, agreed over the channel),
        whose checkpoint the supervisor relaunches from."""
        mh = self._mh
        if mh is None:
            return
        if event == "lost":
            surviving = int(hosts) if hosts is not None else mh["hosts"]
            if mh["rank"] >= surviving:
                log.warning("chaos host_lost: rank %d >= surviving hosts "
                            "%d: SIGKILL (no cleanup, no checkpoint)",
                            mh["rank"], surviving)
                os.kill(os.getpid(), signal.SIGKILL)
            return
        if event == "restored":
            store = mh.get("store") or self.config.checkpoint_dir
            if store and mh["rank"] == 0:
                os.makedirs(store, exist_ok=True)
                req = os.path.join(store, "restore_request.json")
                with open(req + ".tmp", "w") as f:
                    json.dump({"hosts": int(hosts) if hosts else None,
                               "step": step, "epoch": epoch}, f)
                os.replace(req + ".tmp", req)   # the supervisor polls it
            self.stop.request(
                f"chaos host_restore (regrow to {hosts or 'full'} hosts)")

    def _check_host_lost(self, epoch: int) -> None:
        """The host-loss fence: once the channel latched ``lost``, the
        step that consumed the zeroed exchange is garbage, so vacate
        through ``Preempted`` without saving; the relaunch resumes from
        the last verified generation (bitwise a fresh resume)."""
        ch = self.host_channel
        if ch is None or not ch.lost:
            return
        mh = self._mh or {}
        reason = (ch.lost_reason or "peer failure")[:200]
        self.telemetry.registry.counter(
            "host_losses_total",
            "host-collective losses observed by a surviving rank").inc()
        self.telemetry.emit(
            "host_membership", event="lost", rank=mh.get("rank"),
            hosts=mh.get("hosts"), lost_ranks=list(ch.lost_ranks),
            reason=reason, step=int(self.step), epoch=int(epoch))
        log.warning("host collective lost (%s): vacating without a "
                    "checkpoint; the supervisor resumes the shrunken world "
                    "from the last verified generation", reason)
        raise Preempted(epoch, self.step, f"host lost: {reason}")

    def restore(self, ckpt_dir: str, *, best: bool = False) -> Dict[str, Any]:
        """Load the latest (``best``: the best) checkpoint under
        ``ckpt_dir`` into the model and the optimizer, without rollback;
        returns its meta. The optimizer must be the checkpoint's:
        another raises ``CheckpointTemplateMismatch``, as the JAX
        ``from_bytes`` does on a template mismatch."""
        from ..interop import train_state_from_jax, train_state_to_jax

        meta = read_meta(ckpt_dir)
        self._check_model(meta, ckpt_dir)
        template = train_state_to_jax(self, values=False)
        try:
            tree = _load_tree(template, ckpt_dir, best=best)
        except ValueError as e:
            raise CheckpointTemplateMismatch(
                f"the checkpoint under {ckpt_dir} does not fit this "
                f"trainer's state: {e}") from e
        bad = shape_mismatches(template, tree)
        if bad and not self.config.elastic:
            raise CheckpointWorldMismatch(
                f"the checkpoint under {ckpt_dir} differs in shape: "
                + "; ".join(bad[:3]) + " (a checkpoint of another world "
                "resumes with elastic=True)")
        if bad:
            tree = self._remesh(template, tree, bad, ckpt_dir, meta)
        train_state_from_jax(tree, self)
        self._drop_graphs()
        self.best_acc = float(meta.get("best_acc") or 0.0)
        if meta.get("epoch") is not None:
            self.epoch = int(meta["epoch"])
        self._restore_rng(meta)
        return meta


def load_checkpoint(ckpt_dir: str, *, best: bool = False,
                    model: Optional[str] = None) -> Dict[str, Any]:
    """The checkpoint under ``ckpt_dir`` (``best``: the best copy) as
    ``{"state": the flax train-state tree (numpy leaves), "meta": the
    meta}``, for tools that need no trainer (``cli export``); with
    ``model``, the meta must name that model when it names one."""
    from ..utils import msgpack
    from ..utils.checkpoint import BEST, LATEST

    meta = read_meta(ckpt_dir)
    held = meta.get("model")
    if model is not None and held is not None and held != model:
        raise ValueError(f"{ckpt_dir} holds a {held!r}, not a {model!r}")
    path = os.path.join(ckpt_dir, BEST if best else LATEST)
    with open(path, "rb") as f:
        return {"state": msgpack.from_bytes(f.read()), "meta": meta}
