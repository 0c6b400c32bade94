"""The train step's multi-step dispatch: ``n`` steps of the STE step
body as one CUDA graph, captured once and replayed (the trainer's
``scan_steps`` and ``device_data``; the JAX package's ``jax.jit`` of
``lax.scan``).

``TrainScan(chunk)`` runs ``chunk(model, optimizer, images, labels,
scalars) -> (losses, accs)``, the body over ``(n, B, ...)`` inputs and
``n`` rows of the optimizer's per-step scalars, returning the
``(n,)`` per-step losses and accuracies. ``run`` fills the rows from the
optimizer's host counters (``scalar_rows``) and advances them by ``n``
(``advance``): the host keeps every counter, the graph reads them from
the device.

On the CPU ``run`` calls ``chunk`` eagerly: the plain version. On a card
it keeps one graph, with its own memory pool, per ``(n, batch shape)``:

- **Capture.** The model's and optimizer's state and the model's train
  generator are saved; one step of the chunk runs on a side stream (it
  loads the kernels and sets up cuBLAS and autograd before capture);
  the state is put back; then the chunk is captured on its static
  inputs, ``zero_grad(set_to_none=True)`` inside, as PyTorch's
  whole-network recipe has it. The model's generator is registered with
  the graph (``register_generator_state``) when the warm-up step drew
  from it, so a replay draws what the eager steps would and advances the
  generator as they would; so is the augmentation's own generator where
  it has one (``augment_seed``: the GSPMD step's global crops).
- **Replay.** The inputs are copied into the static buffers (from pinned
  host memory or, for the device-resident epoch, from the device), the
  graph is replayed, and the counters advance on the host. Nothing
  syncs.
- **No fallback.** A failed capture or replay raises; on a card nothing
  runs the chunk eagerly.
- **Recapture** happens for a new ``(n, batch shape)``, and every
  graph is dropped for another model or optimizer or when a
  hyperparameter outside the scalar rows changes (a regime's momentum,
  betas, eps or weight decay: ``optimizer_key``). The trainer drops the
  whole ``TrainScan`` when it builds a new optimizer or restores a
  checkpoint (a restore replaces the optimizer's state tensors).
- **Telemetry.** Every capture is reported to the build counter of
  ``obs`` (``RecompileTracker``, ``kind="capture"``) and counted in
  ``captures``: a capture on every chunk, the port's retrace storm, is
  a counter that keeps growing. With the cost ledger armed
  (``obs.costs``), the captured chunk's flops and bytes are counted
  while it is captured and banked as ``train_scan_<n>`` with the
  graph's pool as its peak memory.
- **Kernel launches.** A kernel wrapper counts when its launch is
  recorded, at capture, not when a replay runs it: ``recorded`` sums
  what the captures counted, ``ran`` what the replays ran (a graph's
  recorded launches at each replay).
- **Data parallelism.** A data-parallel step's collectives (BatchNorm's
  global-batch all-reduce, the gradient all-reduce, the 1-bit
  exchange's all-to-alls and all-gathers, FSDP's gathers and
  reduce-scatters) are recorded into the graph and run at each replay.
  Only NCCL's can be: a capture over another backend raises
  (``check_capturable``) and nothing runs eagerly in its place. The
  capture is thread-local, since NCCL's watchdog thread keeps polling
  its events meanwhile. Every rank captures and replays the same graphs
  in the same order, so the collectives stay matched. The bytes the
  collectives move are counted when they are recorded, too: the
  capture's count is taken back out of ``wire`` (the warm-up step's as
  well) and each replay adds it, so ``wire`` holds what the replays
  moved. The tensor-parallel, pipelined and (data, model, pipe) steps
  are captured the same way: Megatron's all-reduces, the pipeline's
  sends and receives and the data group's gradient all-reduce go into
  the graph.
- **Refusals.** A step that cannot be recorded sets ``refuse`` (the
  multihost exchange over host sockets, a pipelined model that draws
  its step's dropout seed on the host): its capture raises that message,
  and nothing runs eagerly in its place.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..obs.costs import counting, get_ledger
from ..obs.recompile import get_tracker
from ..ops import _kernels


def optimizer_key(optimizer) -> tuple:
    """The optimizer's hyperparameters that a captured step holds as
    constants: every param group's but the learning rate, and the
    clipping threshold."""
    return (getattr(optimizer, "clip_grad_norm", None),) + tuple(
        (k, v) for group in optimizer.param_groups
        for k, v in sorted(group.items())
        if k not in ("params", "learning_rate"))


def _state_tensors(model, optimizer) -> List[torch.Tensor]:
    """Every tensor a step writes: parameters, buffers (running
    statistics), the optimizer's (its state, shards or segment, the
    exchange's error-feedback rows)."""
    return (list(model.parameters()) + list(model.buffers())
            + optimizer.state_tensors())


def check_capturable(groups) -> None:
    """Raise unless every process group in ``groups`` runs over NCCL,
    whose collectives a CUDA graph records; gloo's run on the host and
    cannot be captured."""
    for group in groups:
        backend = dist.get_backend(group)
        if backend != "nccl":
            raise RuntimeError(
                "a captured dispatch (scan_steps, device_data) records the "
                "step's collectives in a CUDA graph, which NCCL supports "
                f"and {backend!r} does not: run one NCCL rank a card, or "
                "set scan_steps=1 and device_data=False")


def train_generators(model, device) -> list:
    """The model's train generator (none for a model that draws nothing)
    and, where the augmentation has one of its own (``augment_seed``),
    that one too."""
    gen_fn = getattr(model, "train_generator", None)
    if gen_fn is None:
        return []
    gens = [gen_fn(device)]
    if getattr(model, "augment_seed", None) is not None:
        gens.append(model.augment_generator(device))
    return gens


class _Graph:
    """One captured chunk of ``n`` steps at one batch shape."""

    def __init__(self, images: torch.Tensor, labels: torch.Tensor,
                 width: int):
        device = images.device
        self.images = torch.empty_like(images)
        self.labels = torch.empty_like(labels)
        self.scalars = torch.zeros((images.shape[0], width),
                                   dtype=torch.float32, device=device)
        self.graph = torch.cuda.CUDAGraph()
        self.losses = self.accs = None
        self.captured: Dict[str, int] = {}   # launches recorded
        self.wire: Dict[tuple, int] = {}     # wire bytes recorded
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0


class TrainScan:
    """``n`` steps of ``chunk`` a dispatch: captured and replayed on a
    card, eager on the CPU."""

    def __init__(self, chunk: Callable, *, wire=None, groups=()):
        self.chunk = chunk
        self.wire = wire          # the step's WireBytes, if it has any
        self.groups = tuple(groups)   # the step's process groups
        self.graphs: Dict[tuple, _Graph] = {}
        self._held: tuple = ()    # the model, optimizer and constants
        self.recorded: Dict[str, int] = {}  # launches counted at captures
        self.ran: Dict[str, int] = {}       # launches run by replays
        self.captures = 0         # captures so far, recaptures included
        self.telemetry = None     # where cost rows go (obs.Telemetry)
        self.refuse: Optional[str] = None   # why the step cannot be
                                  # captured (a capture raises it)

    def run(self, model, optimizer, images: torch.Tensor,
            labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """``n = images.shape[0]`` steps on ``(n, B, ...)`` images and
        ``(n, B)`` labels (host tensors, pinned for a card, or tensors on
        the device); returns the ``(n,)`` losses and accuracies, on the
        device. On a card they are the graph's outputs: read them before
        the next dispatch."""
        device = next(model.parameters()).device
        rows = torch.from_numpy(optimizer.scalar_rows(images.shape[0]))
        if device.type != "cuda":
            out = self.chunk(model, optimizer, images, labels, rows)
            optimizer.advance(images.shape[0])
            return out
        g = self._graph(model, optimizer, images, labels, rows, device)
        g.images.copy_(images, non_blocking=True)
        g.labels.copy_(labels, non_blocking=True)
        g.scalars.copy_(rows.pin_memory(), non_blocking=True)
        g.graph.replay()
        g.replays += 1
        for k, v in g.captured.items():
            self.ran[k] = self.ran.get(k, 0) + v
        if self.wire is not None:
            self.wire.update(g.wire)
        optimizer.advance(images.shape[0])
        return g.losses, g.accs

    def __call__(self, model, optimizer, images, labels):
        """``run``, reduced to the chunk's mean loss and accuracy (new
        0-d tensors), as the JAX scan's ``jax.tree.map(jnp.mean, ...)``."""
        losses, accs = self.run(model, optimizer, images, labels)
        return losses.mean(), accs.mean()

    def _graph(self, model, optimizer, images, labels, rows,
               device) -> _Graph:
        held = (id(model), id(optimizer), optimizer_key(optimizer))
        if held != self._held:     # other state or constants: recapture
            self.graphs.clear()
            self._held = held
        key = (tuple(images.shape), images.dtype, tuple(labels.shape),
               labels.dtype)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(
                model, optimizer, images.to(device), labels.to(device),
                rows.to(device))
        return g

    def _capture(self, model, optimizer, images, labels, rows) -> _Graph:
        if self.refuse:
            raise RuntimeError(self.refuse)
        check_capturable(self.groups)
        t0 = time.perf_counter()
        wire_before = None if self.wire is None else dict(self.wire)
        device = images.device
        g = _Graph(images, labels, rows.shape[1])
        gens = train_generators(model, device)
        tensors = _state_tensors(model, optimizer)
        saved = [t.detach().clone() for t in tensors]
        saved_gens = [gen.get_state() for gen in gens]
        # Warm-up: one step on a side stream, then the state put back.
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self.chunk(model, optimizer, images[:1], labels[:1], rows[:1])
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)
        del saved
        if self.wire is not None:    # the warm-up step is not a step
            self.wire.clear()
            self.wire.update(wire_before)
        for gen, saved_gen in zip(gens, saved_gens):
            if torch.equal(gen.get_state(), saved_gen):
                continue
            # a step that draws (dropout, stochastic signs, crops): the
            # graph takes the generator over. One that never draws leaves
            # it alone (registering a CUDA generator that has never drawn
            # crashed the process on an H100, PyTorch 2.11)
            gen.set_state(saved_gen)
            g.graph.register_generator_state(gen)
        optimizer.zero_grad(set_to_none=True)
        torch.cuda.synchronize(device)
        before = dict(_kernels.LAUNCHES)
        ledger = get_ledger()
        # NCCL's watchdog thread polls its events while we capture; a
        # global capture mode would fail on its calls
        mode = "thread_local" if self.groups else "global"
        with torch.cuda.graph(g.graph, capture_error_mode=mode):
            # (entering emptied the allocator's cache: what is reserved
            # from here on is the graph's pool)
            reserved = torch.cuda.memory_reserved(device)
            with (counting() if ledger.enabled
                  else contextlib.nullcontext({})) as cost:
                g.losses, g.accs = self.chunk(model, optimizer, g.images,
                                              g.labels, g.scalars)
        torch.cuda.synchronize(device)
        g.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        if self.wire is not None:   # recorded, not run: replays count it
            for k in self.wire:
                g.wire[k] = self.wire[k] - wire_before.get(k, 0)
            self.wire.clear()
            self.wire.update(wire_before)
        g.captured = {k: v - before[k] for k, v in _kernels.LAUNCHES.items()
                      if v != before[k]}
        for k, v in g.captured.items():
            self.recorded[k] = self.recorded.get(k, 0) + v
        g.capture_s = time.perf_counter() - t0
        self.captures += 1
        get_tracker().record("capture", g.capture_s)
        if ledger.enabled:
            n = int(images.shape[0])
            ledger.record(f"train_scan_{n}",
                          {**cost, "hbm": {"peak_bytes": g.pool_bytes}},
                          telemetry=self.telemetry, n_steps=n,
                          batch=list(images.shape[1:2]))
        return g

    def stats(self) -> Dict[str, Any]:
        """Graphs, replays, capture seconds and the bytes each capture
        added to the reserved pool, for timing lines."""
        return {
            "graphs": [{"n": k[0][0], "batch": list(k[0][1:]),
                        "replays": g.replays, "capture_s": g.capture_s,
                        "pool_bytes": g.pool_bytes,
                        "captured_launches": g.captured}
                       for k, g in self.graphs.items()],
            "replays": sum(g.replays for g in self.graphs.values()),
        }


def pinned(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """``a`` as a host tensor of ``dtype``, in pinned memory when it is
    bound for a card."""
    t = torch.from_numpy(np.ascontiguousarray(a, dtype))
    return t.pin_memory() if device.type == "cuda" else t
