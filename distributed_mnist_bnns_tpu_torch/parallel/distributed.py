"""Processes, rendezvous and groups for data parallelism.

The torch counterpart of the JAX package's ``parallel/distributed.py``
and ``parallel/mesh.py::make_mesh``. The JAX package runs data
parallelism as one process over a device mesh; here each rank is a
process (the reference's DDP layout, ``mnist-dist2.py:83,93``):

  init_world(rank, world, backend=, init_file=)  join the process group
  spawn(fn, world, backend=, device=)            run ``fn`` in ``world``
                                                 ranks, return their results
                                                 (device None: the card)
  make_groups(hosts, local)                      the 'data' group and, for
                                                 the hierarchical exchange,
                                                 this rank's in-host and
                                                 inter-host groups

The backend is always the caller's: ``"nccl"`` on the card, one rank per
card (``spawn`` raises when ``world`` exceeds the cards, as ``make_mesh``
does with too few devices; NCCL refuses two ranks on one card);
``"gloo"`` on the CPU. Ranks that share a card run over gloo only when
the caller asks for it with ``backend="gloo", device="cuda"``.

The rendezvous is a ``file://`` in a fresh temporary directory, so
concurrent runs (parallel test workers) never meet on a port.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("nccl", "gloo")


def _rank_device(backend: str, device: str, rank: int) -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:rank`` under NCCL, the
    cards in turn under gloo on ``"cuda"``, else the CPU."""
    if device == "cpu":
        return torch.device("cpu")
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_world(world: int, *, backend: str, device: str) -> None:
    """Raise unless ``world`` ranks can run over ``backend`` on
    ``device``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (have: nccl, gloo)")
    if device not in ("cpu", "cuda"):
        raise ValueError(f"unknown device {device!r} (have: cpu, cuda)")
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for, but no CUDA device is "
                           "available (pass device='cpu' with gloo)")
    if backend == "nccl":
        if device != "cuda":
            raise ValueError("the nccl backend runs on device 'cuda'")
        have = torch.cuda.device_count()
        if world > have:
            raise ValueError(f"need {world} devices, have {have} (nccl runs "
                             "one rank per card; ranks sharing a card run "
                             "with backend='gloo', device='cuda')")


def init_world(rank: int, world: int, *, backend: str,
               init_file: str) -> None:
    """Join the default process group as ``rank`` of ``world`` over
    ``backend``, meeting at ``file://init_file``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (have: nccl, gloo)")
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world)


def _entry(rank: int, fn: Callable, world: int, backend: str, device: str,
           init_file: str, results, args: tuple) -> None:
    init_world(rank, world, backend=backend, init_file=init_file)
    try:
        dev = _rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        out = fn(rank, world, dev, *args)
    finally:
        dist.destroy_process_group()
    # by value: a tensor shared through a file descriptor would vanish
    # with this process
    results.put((rank, pickle.dumps(out)))


def spawn(fn: Callable, world: int, *, backend: str,
          device: Optional[str] = None, args: tuple = (),
          timeout_s: float = 1800.0) -> List[Any]:
    """Run ``fn(rank, world, device, *args)`` in ``world`` fresh processes
    joined in one process group; return their results in rank order.
    ``device`` None means ``"cuda"``, which raises without a card: the
    ranks run on the CPU only when the caller passes ``device="cpu"``.

    ``fn`` must be importable (it is pickled by name) and its result
    picklable (move tensors to the CPU). A rank that raises fails the
    call with its traceback, and the other ranks are stopped; so are all
    of them at ``timeout_s``."""
    device = "cuda" if device is None else device
    check_world(world, backend=backend, device=device)
    ctx = mp.get_context("spawn")
    results = ctx.SimpleQueue()
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        procs = mp.start_processes(
            _entry, args=(fn, world, backend, device,
                          os.path.join(tmp, "rendezvous"), results, args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                while not results.empty():
                    rank, out = results.get()
                    got[rank] = pickle.loads(out)
                if procs.join(timeout=0.05):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks still running after "
                                       f"{timeout_s} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.terminate()
                p.join(timeout=10)
        while not results.empty():
            rank, out = results.get()
            got[rank] = pickle.loads(out)
    missing = sorted(set(range(world)) - set(got))
    if missing:
        raise RuntimeError(f"ranks {missing} returned no result")
    return [got[r] for r in range(world)]


@dataclass
class Groups:
    """One rank's process groups. ``data`` holds every rank. In the
    hierarchical layout (``hosts`` x ``local``, rank = host * local +
    local index) ``local`` holds this rank's host and ``inter`` the
    ranks of this local index on every host; either is None where it
    would hold one rank. ``host`` is this rank's host."""

    data: Any
    local: Optional[Any] = None
    inter: Optional[Any] = None
    host: int = 0


def make_groups(hosts: Optional[int] = None,
                local: Optional[int] = None) -> Groups:
    """The groups of this rank (every rank must call it, in the same
    order). Without ``hosts`` the layout is flat."""
    world, rank = dist.get_world_size(), dist.get_rank()
    data = dist.group.WORLD
    if hosts is None:
        return Groups(data=data)
    local = world // hosts if local is None else local
    if hosts * local != world:
        raise ValueError(f"{hosts} hosts x {local} local != world {world}")
    host, local_rank = divmod(rank, local)
    mine_local = mine_inter = None
    for h in range(hosts):
        g = dist.new_group([h * local + i for i in range(local)])
        if h == host:
            mine_local = g
    for i in range(local):
        g = dist.new_group([h * local + i for h in range(hosts)])
        if i == local_rank:
            mine_inter = g
    return Groups(data=data,
                  local=mine_local if local > 1 else None,
                  inter=mine_inter if hosts > 1 else None, host=host)
