"""Pipeline parallelism: a GPipe schedule of microbatches over the 'pipe'
axis of a rank mesh (the JAX package's ``parallel/pipeline.py``).

The JAX package runs every stage as one SPMD program over a
``shard_map`` and hands activations to the next stage with
``lax.ppermute`` at each tick of ``n_micro + n_stages - 1``. Here each
stage is a rank (a process: one a card over NCCL, gloo ranks on the
CPU) and the ticks are point-to-point sends and receives: stage ``s``
takes microbatch ``m`` when it arrives from stage ``s - 1`` (stage 0
from the input), runs its stage function on it and sends the result on,
so its work at tick ``t`` is microbatch ``t - s`` and a tick where it
holds none is skipped. The last stage gathers the microbatches and
broadcasts the result over the pipe group: ``y`` is replicated on every
pipe rank, as the JAX function's ``psum`` makes it.

The backward is the forward's sends and receives reversed, written out
in ``_Pipeline.backward`` (a custom autograd function whose forward keeps
each microbatch's graph): the last stage takes its own cotangent of
``y`` (every pipe rank computes the same loss from the same ``y``, and
only the last stage's copy enters the pipeline, so the gradient is the
loss's and not ``n_stages`` times it), each stage runs the backward of
its microbatches in reverse order, receiving the cotangent of its output
from the next stage and sending that of its input to the previous one.
Stage 0 returns the input's gradient; the other stages return zeros for
it (the caller sums the gradients of anything upstream of the pipeline
over the pipe group, ``pipeline_model.PipelinedModel.sync_grads``).

Randomness: each (stage, microbatch) cell draws from a generator seeded
from the step's seed, the microbatch and the stage (``cell_seed``; under
DP x PP the data row first), so its draws do not depend on the schedule
that runs it; ``sequential_reference_rng`` derives the same. They cannot
equal JAX's ``fold_in`` stream: the contract is schedule invariance.
``stage_remat`` runs each cell under ``ops.remat.checkpoint`` (the
forward keeps only the stage's input; the recompute takes the taped
draws back).

On gloo, ``send`` and ``recv`` take host tensors only, so a CUDA
activation is staged through a pinned host buffer there (and only
there: NCCL sends device memory). ``wire`` counts the bytes each rank
sends.

Telemetry, as the JAX package's: building a pipeline sets the
``pipeline_stages``, ``pipeline_microbatches`` and
``pipeline_bubble_fraction`` gauges of ``obs.default_registry()`` (label
``axis``; the analytic bubble is the number a profile should confirm),
and every call counts in ``pipeline_calls_total`` and runs in a
``pipeline_dispatch`` region of the profiler.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..obs.registry import default_registry
from ..ops import remat
from ..ops.comm_compress import WireBytes, _count
from .mesh import Mesh, P, comm_span


def pipeline_bubble_fraction(n_stages: int, n_micro: int) -> float:
    """The GPipe bubble of the tick schedule: ``(S - 1) / (M + S - 1)``
    (fill and drain each idle S - 1 ticks of M work ticks, forward and
    mirrored backward)."""
    return (n_stages - 1) / (n_micro + n_stages - 1)


def cell_seed(seed: int, micro: int, stage: int,
              row: Optional[int] = None) -> int:
    """The seed of cell (``stage``, ``micro``) of a step seeded ``seed``
    (data row ``row`` first under DP x PP)."""
    entropy = [int(seed)] + ([] if row is None else [int(row)]) + [
        int(micro), int(stage)]
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


def cell_generator(seed: int, micro: int, stage: int, device,
                   row: Optional[int] = None) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        cell_seed(seed, micro, stage, row))


# -- pytrees of tensors ------------------------------------------------------


def _flatten(tree: Any) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """(leaves, rebuild) of nested dicts, lists and tuples (a
    ``PartitionSpec`` is a leaf)."""
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        return [tree], lambda leaves: leaves[0]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(new: List[Any]) -> Any:
        out, i = [], 0
        for (_, fn), n in zip(parts, sizes):
            out.append(fn(new[i:i + n]))
            i += n
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(out)

    return leaves, rebuild


def _map(fn: Callable, tree: Any) -> Any:
    leaves, rebuild = _flatten(tree)
    return rebuild([fn(leaf) for leaf in leaves])


# -- the transport ------------------------------------------------------------


class _Link:
    """Point-to-point and broadcast over the pipe group, counted in
    ``wire`` (level "pipe"); CUDA tensors go through pinned host memory
    on gloo."""

    def __init__(self, group, wire: Optional[WireBytes]):
        self.group = group
        self.wire = wire
        self.gloo = dist.get_backend(group) == "gloo"

    def _host(self, t: torch.Tensor) -> bool:
        return self.gloo and t.is_cuda

    def send(self, t: torch.Tensor, dst: int, phase: str) -> None:
        t = t.detach().contiguous()
        _count(self.wire, "pipe", phase, t.nbytes)
        if self._host(t):
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t)
            dist.send(buf, dst, group=self.group)
        else:
            with comm_span("pipe", t):
                dist.send(t, dst, group=self.group)

    def recv(self, like: torch.Tensor, src: int) -> torch.Tensor:
        out = torch.empty(like.shape, dtype=like.dtype, device=like.device)
        if self._host(out):
            buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            dist.recv(buf, src, group=self.group)
            out.copy_(buf, non_blocking=False)
        else:
            with comm_span("pipe", out):
                dist.recv(out, src, group=self.group)
        return out

    def broadcast(self, t: torch.Tensor, src: int, n: int) -> torch.Tensor:
        t = t.contiguous()
        if dist.get_rank() == src:
            _count(self.wire, "pipe", "bcast", (n - 1) * t.nbytes)
        with comm_span("pipe", t):
            dist.broadcast(t, src, group=self.group)
        return t


class Schedule:
    """One rank's place in the pipeline: the pipe group of ``mesh`` along
    ``axis``, its stage ``stage`` of ``n_stages``, its neighbours' global
    ranks, the data row (``batch_axis``) and ``n_micro``."""

    def __init__(self, mesh: Mesh, *, axis: str = "pipe", n_micro: int = 0,
                 batch_axis: Optional[str] = None,
                 wire: Optional[WireBytes] = None):
        self.mesh = mesh
        self.axis = axis
        self.n_stages = mesh.size(axis)
        self.stage = mesh.index(axis)
        self.n_micro = n_micro or self.n_stages
        self.row = mesh.index(batch_axis) if batch_axis else None
        self.group = mesh.group(axis)
        self.link = _Link(self.group, wire)
        s, n = self.stage, self.n_stages
        self.prev = mesh.rank_at(**{axis: s - 1}) if s > 0 else None
        self.next = mesh.rank_at(**{axis: s + 1}) if s < n - 1 else None
        self.last = mesh.rank_at(**{axis: n - 1})
        self.timer: Optional[List[Tuple[Any, Any]]] = None

    @property
    def is_last(self) -> bool:
        return self.next is None

    def micro(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % self.n_micro:
            raise ValueError(f"batch {b} not divisible by n_micro="
                             f"{self.n_micro}")
        return x.reshape(self.n_micro, b // self.n_micro, *x.shape[1:])

    @contextlib.contextmanager
    def timed(self, device):
        """Record the stage's compute between CUDA events in ``timer``
        when it is a list (the timing script's busy share)."""
        if self.timer is None or device.type != "cuda":
            yield
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.timer.append((start, end))


def _run_forward(sched: Schedule, run: Callable, x: torch.Tensor,
                 grad: bool, x_grad: bool):
    """The forward ticks of this rank: each microbatch received (or cut
    from ``x`` on stage 0), run, sent on. Returns the records ``(input,
    output)`` and the replicated output."""
    micro = sched.micro(x)
    records = []
    for m in range(sched.n_micro):
        if sched.stage == 0:
            inp = micro[m].detach().requires_grad_(grad and x_grad)
        else:
            inp = sched.link.recv(micro[m], sched.prev)
            inp.requires_grad_(grad)
        with torch.enable_grad() if grad else contextlib.nullcontext():
            with sched.timed(x.device):
                y = run(inp, m)
        if sched.next is not None:
            sched.link.send(y, sched.next, "fwd")
        records.append((inp, y))
    if sched.is_last:
        out = torch.cat([y.detach() for _, y in records])
    else:
        out = torch.empty_like(x)
    out = sched.link.broadcast(out, sched.last, sched.n_stages)
    return records, out


class _Pipeline(torch.autograd.Function):
    """The pipeline as one autograd node: ``forward(sched, run, x,
    *params)``, ``run(leaves, inp, m)`` computing the stage on
    microbatch ``m`` from ``leaves`` (detached copies of ``params`` that
    require grad). The backward is the reversed schedule."""

    @staticmethod
    def forward(ctx, sched: Schedule, run: Callable, x: torch.Tensor,
                *params: torch.Tensor):
        leaves = [p.detach().requires_grad_(p.requires_grad)
                  for p in params]
        records, out = _run_forward(
            sched, lambda inp, m: run(leaves, inp, m), x, True,
            x.requires_grad)
        ctx.sched, ctx.records, ctx.leaves = sched, records, leaves
        ctx.x_meta = (x.shape, x.dtype, x.device)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        sched, records, leaves = ctx.sched, ctx.records, ctx.leaves
        shape, dtype, device = ctx.x_meta
        gs = sched.micro(g) if sched.is_last else None
        gx = torch.zeros(shape, dtype=dtype, device=device)
        gx_micro = sched.micro(gx)
        for m in reversed(range(sched.n_micro)):
            inp, y = records[m]
            gy = (gs[m] if sched.is_last
                  else sched.link.recv(y, sched.next))
            with sched.timed(device):
                torch.autograd.backward(y, gy)
            gin = inp.grad if inp.grad is not None else torch.zeros_like(
                inp)
            if sched.prev is not None:
                sched.link.send(gin, sched.prev, "bwd")
            else:
                gx_micro[m].copy_(gin)
        ctx.records = None
        grads = [leaf.grad if leaf.grad is not None
                 else (torch.zeros_like(leaf) if leaf.requires_grad
                       else None) for leaf in leaves]
        return (None, None, gx, *grads)


def run_pipeline(sched: Schedule, run: Callable, x: torch.Tensor,
                 params: Sequence[torch.Tensor]) -> torch.Tensor:
    """``y`` of the stage chain on ``x`` (this rank's stage computed by
    ``run(leaves, inp, m)`` over ``params``), replicated on every pipe
    rank; differentiable when grad is enabled and ``x`` or a parameter
    requires it."""
    params = list(params)
    if torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in params)):
        return _Pipeline.apply(sched, run, x, *params)
    _, out = _run_forward(sched, lambda inp, m: run(params, inp, m), x,
                          False, False)
    return out


def make_pipeline_fn(mesh: Mesh, stage_fn: Callable[..., torch.Tensor], *,
                     axis: str = "pipe", n_micro: int = 4,
                     batch_axis: Optional[str] = None,
                     stage_takes_rng: bool = False,
                     stage_remat: bool = False, param_specs=None,
                     wire: Optional[WireBytes] = None) -> Callable:
    """``f(stage_params, x[, seed]) -> y``, the stage chain run as a
    GPipe pipeline over ``axis`` (the JAX ``make_pipeline_fn``).

    ``stage_params``: a pytree (dicts, lists) of tensors whose leading
    dim is the stage (``n_stages``, stage-major); this rank runs
    ``stage_fn`` on its slice (the gradients flow back into it). With
    ``param_specs`` (a matching tree of ``PartitionSpec``, dim 0 the
    stage axis) a leaf is also cut along every other dim named by a mesh
    axis, at this rank's index there: Megatron shards inside a stage
    (``tp_pipeline``), whose collectives ``stage_fn`` owns.
    ``stage_fn(params, x) -> x'`` is shape-preserving; with
    ``stage_takes_rng`` it is ``(params, x, generator)`` and ``f`` takes
    the step's ``seed``: each (stage, microbatch) cell gets
    ``cell_generator(seed, microbatch, stage)``. ``x``: (B, ...) with B
    divisible by ``n_micro``, the same on every pipe rank; ``y`` is
    replicated on every pipe rank. With ``batch_axis`` (DP x PP) ``x`` is
    this data row's rows, and the row index seeds the cells first; the
    gradient all-reduce over the data axis is the caller's, as in JAX.
    ``stage_remat``: each cell under ``ops.remat.checkpoint``. ``f.
    schedule`` is the rank's ``Schedule`` (its ``timer``, wire)."""
    sched = Schedule(mesh, axis=axis, n_micro=n_micro,
                     batch_axis=batch_axis, wire=wire)
    reg = default_registry()
    reg.gauge("pipeline_stages", "GPipe stage count").set(
        sched.n_stages, axis=axis)
    reg.gauge("pipeline_microbatches", "microbatches per step").set(
        sched.n_micro, axis=axis)
    reg.gauge(
        "pipeline_bubble_fraction", "analytic GPipe bubble fraction"
    ).set(pipeline_bubble_fraction(sched.n_stages, sched.n_micro),
          axis=axis)
    calls = reg.counter(
        "pipeline_calls_total",
        "pipeline invocations (dispatches, or traces under an outer jit)",
    )
    if param_specs is not None:
        for spec in _flatten(param_specs)[0]:
            if not spec or spec[0] != axis:
                raise ValueError(f"param_specs leaf {spec} must have the "
                                 f"stage axis {axis!r} at dim 0")

    def local(stage_params):
        leaves, rebuild = _flatten(stage_params)
        specs = (_flatten(param_specs)[0] if param_specs is not None
                 else [P(axis)] * len(leaves))
        out = []
        for leaf, spec in zip(leaves, specs):
            t = leaf[sched.stage]
            for dim, name in enumerate(spec[1:]):
                if name is not None:
                    k = t.shape[dim] // mesh.size(name)
                    t = t.narrow(dim, mesh.index(name) * k, k)
            out.append(t)
        return out, rebuild

    def f(stage_params, x: torch.Tensor,
          seed: Optional[int] = None) -> torch.Tensor:
        if stage_takes_rng and seed is None:
            raise ValueError("a pipeline whose stages take an rng needs "
                             "the step's seed")
        params, rebuild = local(stage_params)

        def cell(leaves, inp, m):
            p = rebuild(list(leaves))
            if not stage_takes_rng:
                return stage_fn(p, inp)
            gen = cell_generator(seed, m, sched.stage, inp.device,
                                 sched.row)
            return stage_fn(p, inp, gen)

        def run(leaves, inp, m):
            if stage_remat and torch.is_grad_enabled():
                return remat.checkpoint(lambda i: cell(leaves, i, m), inp)
            return cell(leaves, inp, m)

        calls.inc(axis=axis)
        with torch.profiler.record_function("pipeline_dispatch"):
            return run_pipeline(sched, run, x, params)

    f.schedule = sched
    return f


def sequential_reference(stage_params: Any, x: torch.Tensor,
                         stage_fn: Callable) -> torch.Tensor:
    """Oracle: the stage chain applied in turn in one process."""
    n_stages = _flatten(stage_params)[0][0].shape[0]
    for s in range(n_stages):
        x = stage_fn(_map(lambda p, s=s: p[s], stage_params), x)
    return x


def sequential_reference_rng(stage_params: Any, x: torch.Tensor,
                             stage_fn: Callable, seed: int, n_micro: int,
                             row: Optional[int] = None) -> torch.Tensor:
    """Oracle of the rng-plumbed pipeline in one process: every
    (stage, microbatch) cell with the generator the schedule gives it,
    so a pipelined run with dropout must match it exactly."""
    n_stages = _flatten(stage_params)[0][0].shape[0]
    b = x.shape[0]
    micro = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    outs = []
    for m in range(n_micro):
        h = micro[m]
        for s in range(n_stages):
            gen = cell_generator(seed, m, s, h.device, row)
            h = stage_fn(_map(lambda p, s=s: p[s], stage_params), h, gen)
        outs.append(h)
    return torch.cat(outs).reshape(b, *x.shape[1:])
