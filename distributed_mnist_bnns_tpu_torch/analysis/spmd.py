"""Collective-schedule recording and lockstep checking over
``torch.distributed`` — the runtime half of the collective pack (JG012
and JG014 are the static half, in analysis/lint/rules.py). The JAX
package's ``analysis/spmd.py``, written for the port.

The bug class this guards: a group collective that some ranks issue and
others skip does not error, it **hangs the world** — every rank that
entered the collective blocks waiting for peers that never arrive.

How it works
------------
The recorder runs the program once per simulated rank, in this one
process, with the ``torch.distributed`` functions the port's exchanges
call replaced (for the duration of a ``with`` block) by stubs that log
``(op, axis, shape, dtype)`` and write a shape-correct local result in
place: a sum multiplies by the group's size, a reduce-scatter keeps this
rank's share of the scaled input, a gather repeats the input, an
all-to-all and a broadcast leave it as it is. Eager torch runs only the
branch each rank takes, so a rank-dependent branch records divergent
schedules: exactly the hang condition on real ranks. Values are only
world-plausible; the checker compares **schedules**, not numerics (the
exchanges' numerics are held to the JAX package by their own tests).

Groups are fake handles (``SimGroup``) that carry an axis name, the
axis's size and this rank's coordinate on it, so that a (hosts x local)
mesh resolves each collective's size from the group it runs over, as
``run_lockstep_mesh`` needs. ``sim_group(axis)`` hands a program the
group of the running simulation.

The simulation is process-wide (the stubs replace module attributes):
it refuses to start while a real process group is initialised, or while
another thread is inside one, and it puts every original back on exit,
an exception included.

Entry points
------------
``record_schedule(fn, *args, world=, pid=)`` → ``[CollectiveOp, ...]``
``check_lockstep(schedules)`` → raises :class:`LockstepError` with the
first divergent index when any two ranks' schedules differ.
``run_lockstep(build, world)`` — record every rank and check.
``verify_shipped(worlds=(2, 4, 8), device=None)`` — the port's exchanges
(the compressed-DP exchange, the compressed-FSDP exchange, the elastic
remesh fold/regrow, the hierarchical exchange) in lockstep at every
world and mesh. ``cli lint --spmd`` wraps it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import (
    Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple,
)

__all__ = [
    "CollectiveOp",
    "LockstepError",
    "SimGroup",
    "check_lockstep",
    "record_schedule",
    "run_lockstep",
    "run_lockstep_mesh",
    "sim_group",
    "verify_shipped",
]

# int worlds simulate one flat group; dict worlds ({axis_name: size})
# simulate a mesh — a collective then takes its size from the group it
# runs over, which is what the two-level hierarchical exchange needs: an
# all-reduce over 'local' must not scale by the 'data' axis's size.
World = Any   # int | Dict[str, int]
Pid = Any     # int | Dict[str, int]


@dataclasses.dataclass(frozen=True)
class CollectiveOp:
    """One recorded collective: position in the program's schedule plus
    the identity that must match across ranks for the op to pair."""

    index: int
    op: str
    axis: Optional[str]
    shape: Tuple[int, ...]
    dtype: str

    def key(self) -> Tuple:
        """What lockstep compares: everything except ``index`` (which
        is implied by position)."""
        return (self.op, self.axis, self.shape, self.dtype)

    def __str__(self) -> str:
        return (
            f"#{self.index} {self.op}(axis={self.axis!r}, "
            f"shape={self.shape}, {self.dtype})"
        )


class LockstepError(RuntimeError):
    """Two simulated ranks disagreed on the collective schedule.

    ``divergence_index`` is the first schedule position where any rank
    differs from rank 0 (a length mismatch diverges at the shorter
    schedule's end); ``schedules`` holds every rank's full recording for
    the report."""

    def __init__(
        self,
        message: str,
        *,
        divergence_index: int,
        schedules: Sequence[Sequence[CollectiveOp]],
    ) -> None:
        super().__init__(message)
        self.divergence_index = divergence_index
        self.schedules = [list(s) for s in schedules]


def _first_divergence(
    schedules: Sequence[Sequence[CollectiveOp]],
) -> Optional[int]:
    """Index of the first position where any rank differs from rank 0,
    or None when all schedules agree."""
    base = schedules[0]
    for other in schedules[1:]:
        upto = min(len(base), len(other))
        for i in range(upto):
            if base[i].key() != other[i].key():
                return i
        if len(base) != len(other):
            return upto
    return None


def _divergence_report(
    schedules: Sequence[Sequence[CollectiveOp]], idx: int
) -> str:
    lines = [
        f"collective schedules diverge at index {idx} "
        f"(world {len(schedules)}):"
    ]
    for pid, sched in enumerate(schedules):
        if idx < len(sched):
            entry = str(sched[idx])
        else:
            entry = f"<no collective — schedule ends at {len(sched)}>"
        lines.append(f"  process {pid}: {entry}")
    lo = max(0, idx - 2)
    ctx = schedules[0][lo:idx]
    if ctx:
        lines.append("  last agreed ops: " + "; ".join(str(c) for c in ctx))
    lines.append(
        "  on real ranks the processes still issuing collectives would "
        "hang waiting for the ones that stopped."
    )
    return "\n".join(lines)


def check_lockstep(schedules: Sequence[Sequence[CollectiveOp]]) -> None:
    """Hard-error with the first divergent index when any two ranks'
    schedules differ; no-op when they all agree."""
    if len(schedules) < 2:
        return
    idx = _first_divergence(schedules)
    if idx is not None:
        raise LockstepError(
            _divergence_report(schedules, idx),
            divergence_index=idx,
            schedules=schedules,
        )


# --------------------------------------------------------------------------
# The per-rank simulator
# --------------------------------------------------------------------------

#: the torch.distributed functions a simulation replaces
STUBBED = (
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "reduce_scatter_tensor", "all_to_all_single", "broadcast", "barrier",
    "get_rank", "get_world_size", "get_global_rank", "is_initialized",
)

_ACTIVE = threading.Lock()   # held while a simulation runs
_current: Optional["_Simulation"] = None


@dataclasses.dataclass(frozen=True)
class SimGroup:
    """A simulated process group: the ranks along ``axis`` (a tuple of
    axes: their row-major product; None: the whole world), ``size`` of
    them, this rank at coordinate ``rank``."""

    axis: Any
    size: int
    rank: int


class _Simulation:
    """One simulated rank ``pid`` of ``world``, recording into
    ``schedule``."""

    def __init__(self, schedule: List[CollectiveOp], world: World,
                 pid: Pid):
        self.schedule = schedule
        self.world = world
        self.pid = pid
        if isinstance(world, int):
            self.flat_world, self.flat_pid = world, pid
        else:
            axes = tuple(world)
            self.flat_world = self.axis_size(axes)
            self.flat_pid = self.axis_pid(axes)

    def axis_size(self, axis: Any) -> int:
        if isinstance(self.world, int):
            return self.world
        if axis is None:
            n = 1
            for v in self.world.values():
                n *= v
            return n
        if isinstance(axis, (tuple, list)):
            n = 1
            for a in axis:
                n *= self.axis_size(a)
            return n
        return self.world[axis]

    def axis_pid(self, axis: Any) -> int:
        if isinstance(self.pid, int):
            return self.pid
        if axis is None:
            return self.axis_pid(tuple(self.world))
        if isinstance(axis, (tuple, list)):
            # Row-major flattening over the named axes — the convention
            # a real mesh uses for a group over a tuple of axes.
            n = 0
            for a in axis:
                n = n * self.axis_size(a) + self.axis_pid(a)
            return n
        return self.pid[axis]

    def group(self, axis: Any = None) -> SimGroup:
        return SimGroup(axis, self.axis_size(axis), self.axis_pid(axis))

    def resolve(self, group: Optional[SimGroup]) -> SimGroup:
        if group is None:
            return self.group(None)
        if not isinstance(group, SimGroup):
            raise TypeError(
                f"a simulated collective got group {group!r}: the program "
                "must take its groups from spmd.sim_group")
        return group

    def record(self, op: str, group: SimGroup, tensor: Any) -> None:
        axis = group.axis
        self.schedule.append(
            CollectiveOp(
                index=len(self.schedule),
                op=op,
                axis=None if axis is None else str(axis),
                shape=tuple(getattr(tensor, "shape", ())),
                dtype=str(getattr(tensor, "dtype", "?")),
            )
        )

    def stubs(self) -> Dict[str, Callable]:
        import torch
        import torch.distributed as dist

        def all_reduce(tensor, op=dist.ReduceOp.SUM, group=None,
                       async_op=False):
            g = self.resolve(group)
            self.record("all_reduce", g, tensor)
            if op == dist.ReduceOp.SUM:
                tensor.mul_(g.size)

        def all_gather(tensor_list, tensor, group=None, async_op=False):
            g = self.resolve(group)
            self.record("all_gather", g, tensor)
            if len(tensor_list) != g.size:
                raise ValueError(f"all_gather into {len(tensor_list)} "
                                 f"tensors over a group of {g.size}")
            for t in tensor_list:
                t.copy_(tensor)

        def all_gather_into_tensor(output_tensor, input_tensor, group=None,
                                   async_op=False):
            g = self.resolve(group)
            self.record("all_gather_into_tensor", g, input_tensor)
            output_tensor.copy_(torch.cat([input_tensor] * g.size).reshape(
                output_tensor.shape))

        def reduce_scatter_tensor(output, input, op=dist.ReduceOp.SUM,
                                  group=None, async_op=False):
            g = self.resolve(group)
            self.record("reduce_scatter_tensor", g, input)
            scale = g.size if op == dist.ReduceOp.SUM else 1
            share = input.reshape(g.size, -1)[g.rank] * scale
            output.copy_(share.reshape(output.shape))

        def all_to_all_single(output, input, output_split_sizes=None,
                              input_split_sizes=None, group=None,
                              async_op=False):
            g = self.resolve(group)
            self.record("all_to_all_single", g, input)
            output.copy_(input)

        def broadcast(tensor, src=None, group=None, async_op=False,
                      group_src=None):
            g = self.resolve(group)
            self.record("broadcast", g, tensor)

        def barrier(group=None, async_op=False, device_ids=None):
            g = self.resolve(group)
            self.record("barrier", g, None)

        def get_rank(group=None):
            return self.resolve(group).rank if group is not None \
                else self.flat_pid

        def get_world_size(group=None):
            return self.resolve(group).size if group is not None \
                else self.flat_world

        def get_global_rank(group, group_rank):
            """The flat rank of the member at ``group_rank`` on the
            group's axis, this rank's other coordinates kept."""
            g = self.resolve(group)
            if isinstance(self.pid, int) or g.axis is None:
                return group_rank
            coords = dict(self.pid)
            axes = g.axis if isinstance(g.axis, (tuple, list)) else (g.axis,)
            rest = group_rank
            for a in reversed(axes):
                coords[a] = rest % self.world[a]
                rest //= self.world[a]
            n = 0
            for a in self.world:
                n = n * self.world[a] + coords[a]
            return n

        def is_initialized():
            return True

        return {
            "all_reduce": all_reduce, "all_gather": all_gather,
            "all_gather_into_tensor": all_gather_into_tensor,
            "reduce_scatter_tensor": reduce_scatter_tensor,
            "all_to_all_single": all_to_all_single, "broadcast": broadcast,
            "barrier": barrier, "get_rank": get_rank,
            "get_world_size": get_world_size,
            "get_global_rank": get_global_rank,
            "is_initialized": is_initialized,
        }


@contextlib.contextmanager
def _simulated_process(
    schedule: List[CollectiveOp], *, world: World, pid: Pid
) -> Iterator[_Simulation]:
    """Run the body as simulated rank ``pid`` of ``world``: the
    ``torch.distributed`` functions of ``STUBBED`` are recording,
    shape-correct local stubs until the block exits (an exception
    included).

    Meshes: pass ``world`` / ``pid`` as ``{axis_name: ...}`` dicts — each
    collective then scales/splits by the size of the group it runs over
    (``sim_group(axis)``), and ``get_rank(group)`` returns that axis's
    coordinate."""
    global _current
    import torch.distributed as dist

    if not _ACTIVE.acquire(blocking=False):
        raise RuntimeError(
            "another simulated process is running (in this or another "
            "thread): the stubs replace torch.distributed process-wide")
    try:
        if dist.is_available() and dist.is_initialized():
            raise RuntimeError(
                "a real process group is initialised in this process: "
                "the lockstep simulation would replace its collectives; "
                "run it in a process without one")
        sim = _Simulation(schedule, world, pid)
        saved = {name: getattr(dist, name) for name in STUBBED}
        try:
            for name, stub in sim.stubs().items():
                setattr(dist, name, stub)
            _current = sim
            yield sim
        finally:
            _current = None
            for name, original in saved.items():
                setattr(dist, name, original)
    finally:
        _ACTIVE.release()


def sim_group(axis: Any = None) -> SimGroup:
    """The process group over ``axis`` (None: the whole world) of the
    running simulation; raises outside one."""
    if _current is None:
        raise RuntimeError("sim_group() outside a simulated process "
                           "(record_schedule / run_lockstep)")
    return _current.group(axis)


def record_schedule(
    fn: Callable, *args: Any, world: World, pid: Pid, **kwargs: Any
) -> List[CollectiveOp]:
    """Run ``fn(*args, **kwargs)`` as simulated rank ``pid`` of
    ``world`` and return its ordered collective schedule."""
    schedule: List[CollectiveOp] = []
    with _simulated_process(schedule, world=world, pid=pid):
        fn(*args, **kwargs)
    return schedule


def _record_built(build: Callable, world: World, pid: Pid
                  ) -> List[CollectiveOp]:
    """``build(pid, world)`` inside the simulation (the port's exchanges
    read their rank from their group when they are made), then
    ``fn(*args)``; the schedule is ``fn``'s alone."""
    schedule: List[CollectiveOp] = []
    with _simulated_process(schedule, world=world, pid=pid):
        fn, args = build(pid, world)
        del schedule[:]
        fn(*args)
    return schedule


def run_lockstep(
    build: Callable[[int, int], Tuple[Callable, Tuple]],
    world: int,
) -> List[List[CollectiveOp]]:
    """Record every simulated rank's schedule and lockstep-check them.
    ``build(pid, world)`` returns ``(fn, args)``: it sets the rank up
    (its data, its state, its exchange over ``sim_group(...)``) and runs
    inside the simulation, as ``fn(*args)`` does after it; only ``fn``'s
    collectives are recorded. Returns the per-rank schedules; raises
    :class:`LockstepError` on the first divergence."""
    schedules = [_record_built(build, world, pid) for pid in range(world)]
    check_lockstep(schedules)
    return schedules


def run_lockstep_mesh(
    build: Callable[[Dict[str, int], Dict[str, int]], Tuple[Callable, Tuple]],
    axes: Dict[str, int],
) -> List[List[CollectiveOp]]:
    """Multi-axis :func:`run_lockstep`: record every coordinate of the
    named mesh (row-major over ``axes``) and lockstep-check the lot.
    ``build(pid, axes)`` receives the per-axis coordinate dict — e.g.
    ``{"data": 1, "local": 3}`` on a (data=2, local=4) mesh. Every rank
    takes part in every collective of the two-level exchange (the local
    all-reduce groups by host, the inter-host phases by local index), so
    all hosts*local schedules must agree."""
    names = tuple(axes)
    coords: List[Dict[str, int]] = [{}]
    for name in names:
        coords = [
            {**c, name: i} for c in coords for i in range(axes[name])
        ]
    schedules = [_record_built(build, dict(axes), pid) for pid in coords]
    check_lockstep(schedules)
    return schedules


# --------------------------------------------------------------------------
# The shipped collective programs (the JAX package's matrix, on the
# port's exchanges)
# --------------------------------------------------------------------------

_AXIS = "data"
_LOCAL_AXIS = "local"
_N_PARAMS = 1000     # two leaves, deliberately not bucket-aligned
_BUCKET = 64         # padded = world*nb*64 = 1024 at world 2/4/8
_CHUNKS = 2


class _DemoOrder:
    """The two-leaf demo parameters laid end to end in ravel_pytree's
    sorted order (``b`` (100,), then ``w`` (30, 30)): the interface of
    ``interop.JaxFlatOrder`` that the exchanges read."""

    def __init__(self, params: Dict[str, Any]):
        self.entries = [(name, params[name], False) for name in sorted(params)]
        self.n_params = sum(p.numel() for _, p, _ in self.entries)

    def flatten(self, tensors=None):
        import torch

        return torch.cat([
            (p.detach() if tensors is None else tensors[p]).reshape(-1)
            for _, p, _ in self.entries]).float()

    def unflatten(self, flat):
        out, start = {}, 0
        for _, p, _ in self.entries:
            out[p] = flat[start:start + p.numel()].reshape(p.shape)
            start += p.numel()
        return out


def _rng_tensor(seed: int, shape, device):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(device)


def _demo_params(device) -> Dict[str, Any]:
    import torch

    return {"w": torch.nn.Parameter(_rng_tensor(0, (30, 30), device)),
            "b": torch.nn.Parameter(_rng_tensor(1, (100,), device))}


def _demo_grads(pid: int, params: Dict[str, Any], device) -> None:
    """Rank ``pid``'s gradients, written into ``params``."""
    params["w"].grad = _rng_tensor(1234 + pid, (30, 30), device)
    params["b"].grad = _rng_tensor(4321 + pid, (100,), device)


def _dp_program(world: int, device):
    """The compressed-DP exchange: ``train.optim.SignCompress``
    (``sign_ef``: the two-phase 1-bit exchange with double error
    feedback) as each rank runs it in its optimizer step."""
    from ..train.optim import SignCompress

    def build(pid: int, w: int):
        params = _demo_params(device)
        _demo_grads(pid, params, device)
        tx = SignCompress(mode="sign_ef", order=_DemoOrder(params),
                          world=w, group=sim_group(_AXIS),
                          bucket_size=_BUCKET, chunks=_CHUNKS)
        ps = list(params.values())
        return tx, (ps, [p.grad for p in ps])

    return build


def _fsdp_optimizer(params: Dict[str, Any], world: int):
    """Adam on the segments of ``train.optim.SignCompressFsdp`` over the
    data group: the compressed reduce-scatter, the owner's update, the
    compressed all-gather of the delta."""
    from ..train.optim import SignCompressFsdp, make_optimizer

    tx = SignCompressFsdp(mode="sign_ef", order=_DemoOrder(params),
                          world=world, group=sim_group(_AXIS),
                          bucket_size=_BUCKET, chunks=_CHUNKS)
    return tx, make_optimizer("adam", list(params.values()), 1e-3,
                              fsdp_compress=tx)


def _fsdp_program(world: int, device):
    """The compressed-FSDP/ZeRO exchange with an Adam inner, one
    optimizer step."""

    def build(pid: int, w: int):
        params = _demo_params(device)
        _demo_grads(pid, params, device)
        _, opt = _fsdp_optimizer(params, w)
        return opt.step, ()

    return build


def _remesh_program(world: int, device):
    """The elastic remesh program: compressed-FSDP exchange state written
    at ANOTHER origin world (a checkpoint's flax-layout rows, random so
    that the fold is seen), re-placed onto ``world`` by
    ``parallel.remesh.remesh_compress_state`` (fold when shrinking,
    regrow when growing), each rank's rows loaded into its exchange and
    its Adam moments, then one step at the new world — the post-remesh
    step every elastic resize runs first."""
    import numpy as np
    import torch

    from ..ops.comm_compress import make_plan
    from ..parallel.remesh import remesh_compress_state

    origin = 8 if world in (2, 4) else 4
    old = make_plan(_N_PARAMS, world=origin, mode="sign_ef",
                    bucket_size=_BUCKET, chunks=_CHUNKS, layout="fsdp")
    plan = make_plan(_N_PARAMS, world=world, mode="sign_ef",
                     bucket_size=_BUCKET, chunks=_CHUNKS, layout="fsdp")
    rng = np.random.default_rng(7)

    def rows(width):
        return rng.standard_normal((origin, width)).astype(np.float32)

    origin_state = {"ef_residual": rows(old.padded),
                    "ef_residual2": rows(old.seg),
                    "inner": {"count": np.int32(3), "mu": rows(old.seg),
                              "nu": np.abs(rows(old.seg))}}
    remeshed, replaced = remesh_compress_state(origin_state, plan)
    if replaced == 0:
        raise RuntimeError(
            f"remesh {origin}->{world} replaced no state nodes — the "
            "lockstep program is not exercising the fold/regrow path"
        )

    def build(pid: int, w: int):
        params = _demo_params(device)
        _demo_grads(pid, params, device)
        tx, opt = _fsdp_optimizer(params, w)
        tx.load_state_dict({
            k: torch.from_numpy(np.ascontiguousarray(remeshed[k][pid]))
            for k in ("ef_residual", "ef_residual2")})
        state = opt.state[tx.segment]
        for k in ("mu", "nu"):
            state[k].copy_(torch.from_numpy(
                np.ascontiguousarray(remeshed["inner"][k][pid])))
        state["count"] = int(remeshed["inner"]["count"])
        return opt.step, ()

    return build


def _hier_program(hosts: int, local: int, device):
    """The two-level hierarchical exchange: the fp32 mean over 'local'
    (the in-host all-reduce), then ``SignCompress``'s 1-bit two-phase
    exchange over 'data' (the inter-host group), as each rank of the
    (hosts x local) mesh runs it (``parallel.data_parallel``'s
    hierarchical step)."""
    from ..train.optim import SignCompress

    def build(pid: Dict[str, int], axes: Dict[str, int]):
        params = _demo_params(device)
        flat = pid[_AXIS] * axes[_LOCAL_AXIS] + pid[_LOCAL_AXIS]
        _demo_grads(flat, params, device)
        tx = SignCompress(mode="sign_ef", order=_DemoOrder(params),
                          world=hosts, group=sim_group(_AXIS),
                          local_group=sim_group(_LOCAL_AXIS),
                          bucket_size=_BUCKET, chunks=_CHUNKS)
        ps = list(params.values())
        return tx, (ps, [p.grad for p in ps])

    return build


SHIPPED_PROGRAMS: Dict[str, Callable[[int, Any], Callable]] = {
    "dp_exchange": _dp_program,
    "fsdp_exchange": _fsdp_program,
    "remesh_fold_regrow": _remesh_program,
}

# Multi-axis programs run at (hosts x local) meshes instead of flat
# worlds: every host x local-rank coordinate is simulated and must agree
# on the full two-level schedule.
SHIPPED_MESH_PROGRAMS: Dict[str, Callable[[int, int, Any], Callable]] = {
    "hier_exchange": _hier_program,
}

MESH_WORLDS: Tuple[Tuple[int, int], ...] = ((2, 2), (2, 4), (4, 2))


def verify_shipped(
    worlds: Sequence[int] = (2, 4, 8),
    device: Optional[str] = None,
) -> List[Dict[str, Any]]:
    """Lockstep-check every shipped collective program at every world
    (and the mesh programs at every mesh of ``MESH_WORLDS``), with the
    programs' tensors on ``device`` (None is the card; pass ``"cpu"``
    to run there).

    Returns one report row per (program, world):
    ``{"program", "world", "n_collectives", "ok": True}``. Raises
    :class:`LockstepError` (with the offending program named in the
    message) on the first divergence."""
    import torch

    device = torch.device("cuda" if device is None else device)
    report: List[Dict[str, Any]] = []
    for name in list(SHIPPED_PROGRAMS) + list(SHIPPED_MESH_PROGRAMS):
        if name in SHIPPED_PROGRAMS:
            factory = SHIPPED_PROGRAMS[name]
            runs = [(world, lambda f=factory, w=world:
                     run_lockstep(f(w, device), w)) for world in worlds]
        else:
            factory = SHIPPED_MESH_PROGRAMS[name]
            runs = [(f"{hosts}x{local}",
                     lambda f=factory, h=hosts, n=local: run_lockstep_mesh(
                         f(h, n, device), {_AXIS: h, _LOCAL_AXIS: n}))
                    for hosts, local in MESH_WORLDS]
        for label, run in runs:
            try:
                schedules = run()
            except LockstepError as e:
                where = "world" if isinstance(label, int) else "mesh"
                raise LockstepError(
                    f"program {name!r} at {where} {label}:\n{e}",
                    divergence_index=e.divergence_index,
                    schedules=e.schedules,
                ) from None
            report.append(
                {
                    "program": name,
                    "world": label,
                    "n_collectives": len(schedules[0]),
                    "ok": True,
                }
            )
    return report
