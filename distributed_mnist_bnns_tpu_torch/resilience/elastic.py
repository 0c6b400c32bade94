"""Elastic data-parallel membership: chaos-driven shrink and regrow of
the world (the JAX package's ``resilience/elastic.py``).

Losing a worker mid-run should cost a remesh, not the job.
``run_elastic`` supervises a data-parallel run whose ranks are
processes (``parallel.spawn``) and turns a membership change into a
respawn of the ranks at the new world:

  1. detect: the seed-deterministic chaos kinds ``worker_lost`` /
     ``worker_restore`` (``resilience.chaos``) fire on every rank at the
     same step boundary and report the change to the hook wired here:
     it records the target world, banks a ``membership_change`` event
     and requests a graceful stop in lockstep (every rank stops at that
     step, where a signal's stop would wait for the epoch boundary);
  2. checkpoint-or-roll-back: the graceful stop writes a step-granular
     checkpoint; the next generation restores the newest digest-verified
     generation (``Trainer.try_resume``), rolling back past a corrupt
     one;
  3. remesh: the supervisor spawns the ranks again at the new world
     (``make_trainer(world)`` in each), and the restore re-places the
     1-bit exchange's ``(world, ...)`` rows on the new world
     (``parallel.remesh``; ``TrainConfig.elastic``). A ``remesh`` event,
     ``remesh_total{direction}`` and the ``world_size`` gauge record it;
     no ``restart`` event is emitted and the retry budget is untouched.

JAX rebuilds a mesh in its one process. Here a rank of a data-parallel
world is a process, and a regrown world needs processes that the
shrunken one no longer has, so each membership generation is a fresh
spawn of ``world`` ranks: its parameters are bitwise a fresh resume at
that world from the same checkpoint generation (the same code on the
same checkpoint).

Other failures keep ``policy.run_with_policy``'s semantics: transient
errors respawn at the current world after a jittered backoff, fatal
ones re-raise, plain preemptions resume within their budget. A stop
from a real signal (``Preempted.reason`` starting with ``"signal "``)
re-raises: the process must vacate (``cli train`` exits 75).
"""

from __future__ import annotations

import logging
import pickle
import time
import types
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, TypeVar

from .policy import (
    RetryPolicy,
    TrainingFailure,
    handle_failure,
    handle_preemption,
    trainer_topology,
)
from .preempt import Preempted

log = logging.getLogger(__name__)

T = TypeVar("T")

REMESH_TOTAL = "remesh_total"
WORLD_SIZE_GAUGE = "world_size"


@dataclass
class MembershipView:
    """The supervisor's view of data-parallel membership: ``full_world``
    is the launch world (``worker_restore`` without ``world=`` returns
    to it), ``world`` the current one, ``pending`` a requested change not
    yet applied."""

    full_world: int
    world: int
    pending: Optional[Dict[str, Any]] = None


def _registry(telemetry: Any):
    if telemetry is not None:
        return telemetry.registry
    from ..obs import default_registry

    return default_registry()


def _wire_membership(trainer: Any, view: MembershipView) -> None:
    """Attach the membership hook to the trainer's chaos controller:
    record the target world on ``view``, bank a ``membership_change``
    event and request a lockstep graceful stop at this step boundary."""

    def on_membership(event, world=None, step=None, epoch=None):
        target = int(world) if world else view.full_world
        if target == view.world:
            log.info("membership %s at step %s: already at world %d; no "
                     "remesh needed", event, step, target)
            return
        view.pending = {"event": event, "world": target, "step": step}
        trainer.telemetry.emit(
            "membership_change", event=event, world_from=view.world,
            world_to=target, step=step, epoch=epoch)
        trainer.stop.request(
            f"membership change: worker {event} -> world {target}",
            lockstep=True)

    trainer.chaos.on_membership = on_membership


def _picklable(e: BaseException) -> BaseException:
    try:
        pickle.loads(pickle.dumps(e))
        return e
    # jg: disable=JG005 -- not swallowed: the rank's exception travels on as a RuntimeError carrying its type and message; only the pickling error, which says nothing of the rank's failure, is dropped
    except Exception:
        return RuntimeError(f"{type(e).__name__}: {e}")


def _elastic_rank(rank: int, world: int, device, make_trainer: Callable,
                  run: Callable, target: Optional[int], full_world: int,
                  remesh_event: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    """One rank of a generation: build, wire, run; the outcome as a
    picklable dict (every rank returns one; the supervisor reads rank
    0's)."""
    view = MembershipView(full_world=full_world, world=world)
    if device.type == "cuda":   # a factory asking for "cuda" gets this card
        import torch

        torch.cuda.set_device(device)
    try:
        trainer = make_trainer(target)
        w, _ = trainer_topology(trainer)
        if w != world:
            raise TrainingFailure(
                f"make_trainer({target}) built a world-{w} trainer in a "
                f"world of {world} ranks: the elastic factory must honor "
                "the requested world")
        _wire_membership(trainer, view)
        if remesh_event is not None and rank == 0:
            trainer.telemetry.emit("remesh", **remesh_event)
    except BaseException as e:
        return {"kind": "failed", "error": _picklable(e), "pending": None}
    try:
        return {"kind": "done", "value": run(trainer)}
    except Preempted as e:
        return {"kind": "preempted", "epoch": e.epoch, "step": e.step,
                "reason": e.reason, "pending": view.pending}
    except BaseException as e:
        return {"kind": "failed", "error": _picklable(e),
                "pending": view.pending}


def run_elastic(make_trainer: Callable[[Optional[int]], Any],
                run: Callable[[Any], T], *, world: int,
                backend: str = "gloo", device: Optional[str] = None,
                policy: Optional[RetryPolicy] = None,
                telemetry: Any = None,
                sleep: Callable[[float], None] = time.sleep,
                timeout_s: float = 1800.0) -> T:
    """``run(make_trainer(None))`` in ``world`` ranks, under elastic
    membership; returns rank 0's result.

    ``make_trainer(w)`` runs in each rank of a ``parallel.spawn`` world
    (``backend``, ``device``: None is the card) and builds the trainer:
    ``None`` is the launch configuration (the caller's ``resume``); an
    int means "at world ``w``, resuming from the checkpoint directory"
    (``resume=True``, ``data_parallel=w``, ``elastic=True``). Both
    ``make_trainer`` and ``run`` must be picklable (module-level
    functions or partials of them), and ``run``'s result too.

    ``telemetry``: an ``obs.Telemetry`` for the supervisor's ``remesh``
    and ``restart`` events and its instruments; without one the remesh
    event rides rank 0's trainer log and the instruments the process's
    default registry."""
    from ..parallel import spawn

    policy = policy if policy is not None else RetryPolicy()
    failures = preemptions = 0
    view = MembershipView(full_world=int(world), world=int(world))
    target: Optional[int] = None
    remesh_event: Optional[Dict[str, Any]] = None
    remesh_t0: Optional[float] = None

    def consume(pend: Dict[str, Any]) -> None:
        nonlocal remesh_event, remesh_t0, target
        remesh_t0 = time.monotonic()
        old, new = view.world, int(pend["world"])
        direction = "shrink" if new < old else "grow"
        _registry(telemetry).counter(
            REMESH_TOTAL,
            "elastic mesh rebuilds (label: direction=shrink|grow)",
        ).inc(direction=direction)
        remesh_event = dict(direction=direction, world_from=old,
                            world_to=new, event=pend["event"],
                            step=pend.get("step"))
        log.warning("remesh (%s): world %d -> %d: respawning the ranks and "
                    "re-placing state from the newest verified checkpoint "
                    "generation (no job restart)", direction, old, new)
        view.world = target = new

    while True:
        _registry(telemetry).gauge(
            WORLD_SIZE_GAUGE,
            "current data-parallel world size (elastic membership)",
        ).set(view.world)
        event_for_rank = remesh_event
        if remesh_event is not None and telemetry is not None:
            telemetry.emit("remesh", **remesh_event)
            tr = getattr(telemetry, "tracer", None)
            if tr is not None and tr.enabled and remesh_t0 is not None:
                tr.record("train.remesh", kind="remesh", t0=remesh_t0,
                          t1=time.monotonic(), **remesh_event)
            event_for_rank = None
        remesh_event = remesh_t0 = None
        outs = spawn(_elastic_rank, view.world, backend=backend,
                     device=device, timeout_s=timeout_s,
                     args=(make_trainer, run, target, view.full_world,
                           event_for_rank))
        out = outs[0]
        failed_world = types.SimpleNamespace(
            distributed=True, mesh=None, world=view.world, _mh=None)
        if out["kind"] == "done":
            return out["value"]
        pending = out.get("pending")
        if out["kind"] == "preempted":
            reason = out.get("reason") or ""
            e = Preempted(out["epoch"], out["step"], reason)
            if reason.startswith("signal "):
                raise e      # a real signal: vacate (cli exit 75)
            if pending is not None:
                consume(pending)
                continue     # membership churn never burns the budget
            preemptions = handle_preemption(
                e, policy=policy, preemptions=preemptions,
                telemetry=telemetry, trainer=failed_world)
            target = view.world
            continue
        error = out["error"]
        try:
            raise error
        except BaseException as e:
            failures = handle_failure(
                e, policy=policy, failures=failures, telemetry=telemetry,
                trainer=failed_world, sleep=sleep,
                context=f" at world {view.world}")
        if pending is not None:
            # a transient fault raced the membership stop to the step
            # boundary: the fired rule will not request it again
            consume(pending)
        else:
            target = view.world
