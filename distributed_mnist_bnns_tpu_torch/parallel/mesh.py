"""Rank meshes: the JAX package's ``parallel/mesh.py`` over processes.

The JAX package names its parallelism dimensions as the axes of a
``jax.sharding.Mesh`` of devices; here each rank is a process of the
default ``torch.distributed`` group (one a card over NCCL, gloo ranks on
the CPU), and a mesh is a grid of ranks with one process group per line
of each axis:

  make_mesh(data=None, model=1[, pipe=])
                      ``(data, model)`` or ``(data, model, pipe)``: rank
                      ``r`` sits at the row-major coordinates of ``r`` in
                      the grid, as JAX reshapes ``jax.devices()``
  make_hybrid_mesh({"data": 2, ...}, dcn_axis="replica")
                      ``(nodes, *ici_axes)``: the leading axis spans the
                      nodes of the multi-node launch (``spawn(coordinator
                      =...)`` numbers ranks node-major), the trailing ones
                      stay inside a node

``mesh.group(axis)`` is this rank's group along ``axis`` (the ranks that
differ from it in that coordinate only); ``mesh.index(axis)`` its
coordinate, ``mesh.size(axis)`` the axis's length. ``PartitionSpec``
(``P``) is the JAX placement of a leaf, a tuple of axis names or None per
dim, as ``model_parallel`` and ``tp_pipeline`` write it.

Every rank must build the same meshes in the same order: each axis line
is a ``dist.new_group``, which every rank of the world calls. The groups
of a shape are built once per default process group and reused (NCCL
sets up no new communicators for a second trainer in the same world).
``comm_span`` times the model and pipe groups' collectives with CUDA
events when a timing run asks for it (``COMM_EVENTS``).
"""

from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

#: kind ("model", "pipe") -> the (start, end) CUDA events of each of that
#: group's collectives, for the kinds a timing run switched on by
#: putting a list here (``scripts/torch_mp_timing.py``); empty: no events
COMM_EVENTS: Dict[str, List[Tuple[torch.cuda.Event, torch.cuda.Event]]] = {}


@contextlib.contextmanager
def comm_span(kind: str, t: torch.Tensor):
    """Record the collective inside between CUDA events in
    ``COMM_EVENTS[kind]`` when that list exists and ``t`` is on a card."""
    events = COMM_EVENTS.get(kind)
    if events is None or not t.is_cuda:
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    end.record()
    events.append((start, end))


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``: per dim, the mesh axis it is
    sharded over, or None (replicated along that dim). ``P()`` is fully
    replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A grid of the default group's ranks with axes ``axis_names`` of
    lengths ``shape``; ``ranks`` lists the grid row-major (default: 0 ..
    n - 1). Built by ``make_mesh``/``make_hybrid_mesh``."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 ranks: Optional[Sequence[int]] = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"{len(shape)} sizes for axes {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"repeated axis name in {axis_names}")
        self.axis_names = tuple(axis_names)
        self.sizes = tuple(int(s) for s in shape)
        n = 1
        for s in self.sizes:
            n *= s
        self.ranks = tuple(range(n) if ranks is None else ranks)
        if len(self.ranks) != n:
            raise ValueError(f"{len(self.ranks)} ranks for a grid of {n}")
        self.rank = dist.get_rank()
        if self.rank not in self.ranks:
            raise ValueError(f"rank {self.rank} is not in the mesh")
        self.coords = dict(zip(self.axis_names, self._coords_of(self.rank)))
        self._groups: Dict[str, object] = _groups_of(self)

    @property
    def shape(self) -> Dict[str, int]:
        """``{axis: size}``, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``
        (``jax.lax.axis_index``)."""
        return self.coords[axis]

    def group(self, axis: str):
        """This rank's process group along ``axis``."""
        return self._groups[axis]

    def _coords_of(self, rank: int) -> Tuple[int, ...]:
        flat = self.ranks.index(rank)
        out = []
        for s in reversed(self.sizes):
            flat, c = divmod(flat, s)
            out.append(c)
        return tuple(reversed(out))

    def rank_at(self, **coords: int) -> int:
        """The rank at this rank's coordinates with ``coords`` changed."""
        at = dict(self.coords, **coords)
        flat = 0
        for name, s in zip(self.axis_names, self.sizes):
            flat = flat * s + at[name]
        return self.ranks[flat]

    def line(self, axis: str, coords: Optional[Dict[str, int]] = None
             ) -> Tuple[int, ...]:
        """The ranks along ``axis`` through ``coords`` (default: this
        rank's), in axis order."""
        at = dict(self.coords, **(coords or {}))
        return tuple(self.rank_at(**dict(at, **{axis: i}))
                     for i in range(self.size(axis)))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


# (id of the default group, ranks, shape, names) -> {axis: group}; the
# entry keeps the default group alive, so its id is not reused
_GROUPS: Dict[tuple, tuple] = {}


def _groups_of(mesh: Mesh) -> Dict[str, object]:
    """Every axis line of the mesh as a process group (each rank calls
    ``new_group`` for every line, in the same order), built once per
    default group; this rank's group along each axis."""
    world = dist.group.WORLD
    key = (id(world), mesh.ranks, mesh.sizes, mesh.axis_names)
    held = _GROUPS.get(key)
    if held is not None and held[0] is world:
        return held[1]
    mine: Dict[str, object] = {}
    for axis in mesh.axis_names:
        others = [a for a in mesh.axis_names if a != axis]
        ranges = [range(mesh.size(a)) for a in others]
        for fixed in itertools.product(*ranges):
            line = mesh.line(axis, dict(zip(others, fixed)))
            g = dist.new_group(list(line))
            if mesh.rank in line:
                mine[axis] = g
    for stale in [k for k, v in _GROUPS.items() if v[0] is not world]:
        del _GROUPS[stale]   # meshes of a destroyed default group
    _GROUPS[key] = (world, mine)
    return mine


def make_mesh(data: Optional[int] = None, model: int = 1, *,
              pipe: Optional[int] = None,
              axis_names: Optional[Sequence[str]] = None) -> Mesh:
    """A ``(data, model)`` mesh over the default group's ranks, or with
    ``pipe`` a ``(data, model, pipe)`` one. ``data=None`` takes every
    remaining rank for data parallelism, as the JAX ``make_mesh`` takes
    every remaining device."""
    world = dist.get_world_size()
    inner = model * (pipe or 1)
    if data is None:
        if world % inner:
            raise ValueError(f"{world} devices not divisible by "
                             f"model={model}"
                             + (f" x pipe={pipe}" if pipe else ""))
        data = world // inner
    need = data * inner
    if need > world:
        raise ValueError(f"need {need} devices, have {world}")
    if pipe is None:
        names = tuple(axis_names or ("data", "model"))
        return Mesh((data, model), names, range(need))
    names = tuple(axis_names or ("data", "model", "pipe"))
    return Mesh((data, model, pipe), names, range(need))


def make_hybrid_mesh(ici_axes: Dict[str, int], *,
                     dcn_axis: str = "replica") -> Mesh:
    """An ``(n_nodes, *ici_shape)`` mesh: the leading axis ``dcn_axis``
    crosses the node boundary, the trailing ones (``ici_axes``, name ->
    size, in order) stay inside a node. The multi-node launch numbers
    ranks node-major, so a node's ranks are one contiguous block of the
    leading axis: put the bandwidth-hungry axes (tensor, pipeline)
    inside a node and the gradient all-reduce across nodes, the JAX
    ``make_hybrid_mesh``'s rule. ``n_nodes`` is the world over the
    product of ``ici_axes``."""
    world = dist.get_world_size()
    ici = 1
    for v in ici_axes.values():
        ici *= v
    if world % ici:
        raise ValueError(f"{world} devices not divisible by ICI shape "
                         f"{ici_axes}")
    return Mesh((world // ici, *ici_axes.values()),
                (dcn_axis, *ici_axes.keys()))
